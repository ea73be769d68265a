"""End-to-end ML-guided scheduling pipeline (paper §4.4, Fig. 9), port of
``repro.ml.pipeline``.

Training phase:
  (1) *Clustering*: k-means over behavioral features (summary statistics
      of the noisy time series, per §4.4.3) + static features.
  (2) *Classification*: a random forest from pre-submission features to
      the cluster label (dynamic features are unavailable at submit
      time).
  (3) *Prediction*: per-cluster ridge regressors from pre-submission
      features to target metrics (runtime s, avg per-node power W,
      energy J).

Inference phase: normalize statics -> predict cluster -> invoke that
cluster's regressor -> rank via S(X) (``repro_torch.ml.scoring``). The
score feeds the twin's ``ml`` policy (higher score = scheduled earlier);
``attach_basis`` stores the per-job scoring basis instead, so the alpha
trade-off rides ``Scenario.alpha``.

The pipeline runs on the host, once per workload before a rollout: the
forest's fit is numpy, k-means and inference are float32 torch on the
CPU, and the engine ranks on its own device. Features enter as float32,
as the reference's do (its ``jnp.asarray`` of float64 features with x64
off); the ridge fit is float64 numpy and its weights are stored as
float32. The regressors' products are the reference's ``einsum``
rounding, one fused multiply-add per feature in order
(``scoring.fma``), so a model carried over from the JAX package
(``MLSchedulerModel.from_arrays``) predicts, and bases, bit for bit.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.datasets.base import JobSet
from repro_torch.ml import kmeans
from repro_torch.ml import scoring
from repro_torch.ml.forest import RandomForest

TARGETS = ("wall", "avg_power", "energy")   # units: s, W, J


def _targets(js: JobSet) -> np.ndarray:
    """Ground-truth regression targets f64[N, 3]: runtime (s), average
    per-node power (W), job energy (J = W * nodes * s)."""
    avg_pw = js.power_prof.mean(1)
    energy = avg_pw * js.nodes * js.wall
    return np.stack([js.wall, avg_pw, energy], 1).astype(np.float64)


def _ridge(x: np.ndarray, y: np.ndarray, lam: float = 1e-2) -> np.ndarray:
    """Closed-form ridge with bias: x f64[N, D], y f64[N, T] ->
    weights f64[D+1, T] (last row is the bias)."""
    xb = np.concatenate([x, np.ones((len(x), 1))], 1)
    d = xb.shape[1]
    w = np.linalg.solve(xb.T @ xb + lam * np.eye(d), xb.T @ y)
    return w


def _f32(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a, np.float32))


@dataclass
class MLSchedulerModel:
    """Fitted cluster/classify/predict pipeline (paper Fig. 9).

    Shapes: k clusters, D pre-submission features, Db behavior features,
    T = len(TARGETS) predicted metrics, K_score scoring columns. Every
    tensor is on the CPU.
    """
    centers: torch.Tensor         # f32[k, Db] cluster centers (behavior space)
    clf: RandomForest             # presubmit features -> cluster
    reg_w: torch.Tensor           # f32[k, D+1, T] per-cluster ridge weights
    x_mean: torch.Tensor          # f32[D] presubmit standardization mean
    x_std: torch.Tensor           # f32[D] presubmit standardization std
    b_mean: torch.Tensor          # f32[Db] behavior standardization mean
    b_std: torch.Tensor           # f32[Db] behavior standardization std
    alpha: torch.Tensor           # f32[K_score] scoring coefficients

    # ------------------------------------------------------------------ fit
    @staticmethod
    def fit(train: JobSet, k: int = 5, n_trees: int = 12, depth: int = 6,
            alpha: np.ndarray | None = None, seed: int = 0
            ) -> "MLSchedulerModel":
        """Fit the three-stage pipeline on a historical ``JobSet``.

        Args:
          train: historical jobs with full (post-hoc) telemetry.
          k: number of k-means behavior clusters.
          n_trees, depth: random-forest classifier size.
          alpha: f32[K_score] scoring trade-off; defaults to the paper's
            hand-set ``scoring.DEFAULT_ALPHA``.
          seed: seed of the k-means init and the forest's bagging.
        """
        xs = train.presubmit_features()
        xb = train.behavior_features()
        xs_n, x_mean, x_std = kmeans.standardize(_f32(xs))
        xb_n, b_mean, b_std = kmeans.standardize(_f32(xb))

        centers, labels, _ = kmeans.fit(xb_n, k, seed=seed)
        labels_np = labels.numpy()
        xs_np = xs_n.numpy()

        clf = RandomForest.fit(xs_np, labels_np, k, n_trees=n_trees,
                               depth=depth, seed=seed)

        y = _targets(train)
        reg = np.zeros((k, xs.shape[1] + 1, y.shape[1]))
        for c in range(k):
            m = labels_np == c
            if m.sum() >= 4:
                reg[c] = _ridge(xs_np[m], y[m])
            else:
                reg[c] = _ridge(xs_np, y)

        if alpha is None:
            alpha = np.asarray(scoring.DEFAULT_ALPHA, np.float32)
        return MLSchedulerModel(centers, clf, _f32(reg), x_mean, x_std,
                                b_mean, b_std, _f32(alpha))

    @staticmethod
    def from_arrays(m: dict) -> "MLSchedulerModel":
        """A fitted model from its arrays by field name (numpy or
        array-likes): ``centers``, ``reg_w``, the four moments, ``alpha``,
        and ``clf`` as a mapping of the forest's ``feat``, ``thresh``,
        ``leaf``, ``depth`` and ``n_classes``. The JAX package's fitted
        ``MLSchedulerModel`` carries over as it is."""
        f = m["clf"]
        clf = RandomForest.from_arrays(f["feat"], f["thresh"], f["leaf"],
                                       f["depth"], f["n_classes"])
        return MLSchedulerModel(
            clf=clf, **{k: _f32(m[k]) for k in (
                "centers", "reg_w", "x_mean", "x_std", "b_mean", "b_std",
                "alpha")})

    # ------------------------------------------------------------- inference
    def predict_metrics(self, js: JobSet):
        """Predict per-job metrics from pre-submission features.

        Returns (cluster i64[N], predicted f32[N, T]) with T = runtime (s),
        avg per-node power (W), energy (J)."""
        xs_n = (_f32(js.presubmit_features()) - self.x_mean) / self.x_std
        cluster = self.clf.predict(xs_n)
        xb = torch.cat([xs_n, torch.ones((xs_n.shape[0], 1))], 1)
        w = self.reg_w[cluster]                     # [N, D+1, T]
        # einsum("nd,ndt->nt") as the reference rounds it
        pred = torch.zeros((xb.shape[0], w.shape[2]), dtype=torch.float32)
        for d in range(xb.shape[1]):
            pred = scoring.fma(xb[:, d, None], w[:, d, :], pred)
        return cluster, pred

    def score_features(self, js: JobSet) -> torch.Tensor:
        """f32[N, K_score] raw scoring features: predicted (runtime s,
        power W, energy J) columns + requested node count."""
        _, pred = self.predict_metrics(js)
        return torch.cat([pred, _f32(js.nodes)[:, None]], dim=1)

    def score_basis(self, js: JobSet) -> np.ndarray:
        """f32[N, K_score] scoring basis ``exp(1/sqrt(X+1))`` per job: the
        score under any coefficient vector is ``basis @ alpha``."""
        return scoring.basis(self.score_features(js)).numpy()

    def score(self, js: JobSet) -> np.ndarray:
        """f32[N] ranking score per job under the model's own alpha
        (higher = scheduled earlier)."""
        return scoring.score(self.score_features(js), self.alpha).numpy()


def attach_scores(js: JobSet, model: MLSchedulerModel) -> JobSet:
    """Bake the model's score (its own alpha) into ``js.score``: the
    table then ranks jobs statically."""
    js.score = model.score(js)
    return js


def attach_basis(js: JobSet, model: MLSchedulerModel) -> JobSet:
    """Store the scoring *basis* instead of a baked score.

    ``js.score`` is zeroed and ``js.ml_basis`` set, so the ``ml`` policy
    key becomes ``-(ml_basis @ Scenario.alpha)``. Under the default alpha,
    whose products are exact, ``Scenario.make("ml", alpha=model.alpha)``
    then ranks exactly as ``attach_scores`` does; under another alpha the
    key's fused sum may differ from the baked score by an ulp, as in the
    reference (``scoring``'s module docstring)."""
    js.score = np.zeros(len(js), np.float32)
    js.ml_basis = model.score_basis(js)
    return js
