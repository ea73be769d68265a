"""Random forest (paper §4.4.1 step 2: classify jobs into behavioral
clusters from pre-submission features), port of ``repro.ml.forest``.

The greedy CART fit is host work on numpy, copied from the reference
line for line (the same ``np.random.default_rng(seed)`` draws, so the
same inputs give the same trees). Trees are stored as flat arrays
(feature, threshold, leaf class distribution) and evaluated in torch:
every tree descends at once, in ``depth + 1`` gather steps, then the
class distributions are averaged over the trees in tree order and
scaled by ``1 / n_trees``, as the reference's ``mean`` rounds it.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


# ---------------------------------------------------------------------------
# Host-side CART fit (the reference's, unchanged).
# ---------------------------------------------------------------------------
def _gini(counts: np.ndarray) -> float:
    n = counts.sum()
    if n == 0:
        return 0.0
    p = counts / n
    return 1.0 - float((p * p).sum())


def _best_split(x: np.ndarray, y: np.ndarray, n_classes: int,
                feat_ids: np.ndarray, n_thresh: int = 16):
    best = (None, None, np.inf)
    n = len(y)
    for f in feat_ids:
        vals = x[:, f]
        qs = np.unique(np.quantile(vals, np.linspace(0.05, 0.95, n_thresh)))
        for t in qs:
            left = vals <= t
            nl = int(left.sum())
            if nl == 0 or nl == n:
                continue
            cl = np.bincount(y[left], minlength=n_classes)
            cr = np.bincount(y[~left], minlength=n_classes)
            score = (nl * _gini(cl) + (n - nl) * _gini(cr)) / n
            if score < best[2]:
                best = (int(f), float(t), score)
    return best


def _fit_tree(x, y, n_classes, depth, rng, max_features):
    """Returns flat arrays sized 2**(depth+1): feature(-1=leaf), thresh,
    leaf class distribution."""
    n_nodes = 2 ** (depth + 1)
    feat = np.full(n_nodes, -1, np.int32)
    thresh = np.zeros(n_nodes, np.float32)
    leaf = np.zeros((n_nodes, n_classes), np.float32)

    def build(node, idx, d):
        ys = y[idx]
        counts = np.bincount(ys, minlength=n_classes).astype(np.float64)
        leaf[node] = (counts / max(counts.sum(), 1)).astype(np.float32)
        if d >= depth or len(idx) < 4 or _gini(counts) < 1e-6:
            return
        feat_ids = rng.choice(x.shape[1], max_features, replace=False)
        f, t, score = _best_split(x[idx], ys, n_classes, feat_ids)
        if f is None:
            return
        feat[node] = f
        thresh[node] = t
        left = idx[x[idx, f] <= t]
        right = idx[x[idx, f] > t]
        if len(left) == 0 or len(right) == 0:
            feat[node] = -1
            return
        build(2 * node + 1, left, d + 1)
        build(2 * node + 2, right, d + 1)

    build(0, np.arange(len(y)), 0)
    return feat, thresh, leaf


@dataclass
class RandomForest:
    feat: torch.Tensor     # i32[T, M] feature per node (-1 = leaf)
    thresh: torch.Tensor   # f32[T, M]
    leaf: torch.Tensor     # f32[T, M, C] class distribution per node
    depth: int
    n_classes: int

    @staticmethod
    def fit(x: np.ndarray, y: np.ndarray, n_classes: int, n_trees: int = 16,
            depth: int = 6, seed: int = 0,
            max_features: int | None = None) -> "RandomForest":
        """Bagged CART fit (paper §4.4.1 step 2): x [N, D] standardized
        features, y i64[N] cluster labels. ``max_features`` defaults to
        sqrt(D) per split (the usual forest heuristic)."""
        rng = np.random.default_rng(seed)
        max_features = max_features or max(1, int(np.sqrt(x.shape[1])))
        feats, threshs, leafs = [], [], []
        n = len(y)
        for _ in range(n_trees):
            boot = rng.integers(0, n, n)  # bagging
            f, t, l = _fit_tree(x[boot], y[boot], n_classes, depth, rng,
                                max_features)
            feats.append(f)
            threshs.append(t)
            leafs.append(l)
        return RandomForest.from_arrays(np.stack(feats), np.stack(threshs),
                                        np.stack(leafs), depth, n_classes)

    @staticmethod
    def from_arrays(feat, thresh, leaf, depth: int,
                    n_classes: int) -> "RandomForest":
        """A forest from its flat arrays (numpy or array-likes): the JAX
        package's fitted ``RandomForest`` leaves carry over as they are."""
        return RandomForest(
            torch.tensor(np.asarray(feat, np.int32)),
            torch.tensor(np.asarray(thresh, np.float32)),
            torch.tensor(np.asarray(leaf, np.float32)),
            int(depth), int(n_classes))

    def predict_proba(self, x: torch.Tensor) -> torch.Tensor:
        """f32[N, D] -> f32[N, C] (mean over trees)."""
        T = self.feat.shape[0]
        feat, thresh = self.feat.long(), self.thresh
        rows = torch.arange(x.shape[0])[None, :]
        trees = torch.arange(T)[:, None]
        node = torch.zeros((T, x.shape[0]), dtype=torch.long)
        for _ in range(self.depth + 1):
            fid = feat[trees, node]                       # [T, N]
            go_left = x[rows, fid.clamp(min=0)] <= thresh[trees, node]
            nxt = torch.where(go_left, 2 * node + 1, 2 * node + 2)
            node = torch.where(fid < 0, node, nxt)        # a leaf stays put
        probs = self.leaf[trees, node]                    # [T, N, C]
        total = probs[0]
        for t in range(1, T):
            total = total + probs[t]
        return total * torch.tensor(1.0 / T, dtype=torch.float32)

    def predict(self, x: torch.Tensor) -> torch.Tensor:
        """f32[N, D] -> i64[N] majority-vote cluster labels."""
        return torch.argmax(self.predict_proba(x), dim=-1)
