"""The port's ML layer (``repro_torch.ml``: scoring, k-means, the forest,
the pipeline, ``load_alpha``) against the JAX package's, on the CPU.

Two questions, held apart:

* **The fit** crosses frameworks. Each stage is held to the reference
  on ``tests/test_ml.py``'s and ``tests/test_train.py``'s fixtures:
  the k-means seed points bit for bit (``jax.random.choice`` without
  replacement, at n = 1,625 and 1,626 and at seeds found by search where
  two sort keys tie); the moments of ``standardize`` bit for bit (the
  port sums in XLA's tree order); labels, the forest's ``feat`` and
  ``leaf`` and ``predict`` exactly; centers, moments, ``reg_w`` and the
  predictions at rtol 1e-5, the forest's thresholds at rtol 1e-6.
* **The ranking** runs on a model carried over from the reference
  (``MLSchedulerModel.from_arrays``): clusters, predictions, the basis
  and the scores bit for bit.

The rounding the port reproduces: features enter as float32, as
the reference's ``jnp.asarray`` of float64 features gives them (a
float64 ``standardize`` moves the forest's thresholds); XLA fuses
``sum(a * b)`` into fused multiply-adds and evaluates ``exp`` with the
Cephes polynomial, which the port computes step for step
(``scoring.fma``, ``scoring.exp_f32``).
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from conftest import make_jobs  # noqa: E402
from repro.datasets.synthetic import WorkloadSpec as JSpec  # noqa: E402
from repro.datasets.synthetic import generate as jgen  # noqa: E402
from repro.ml import forest as jforest  # noqa: E402
from repro.ml import kmeans as jkmeans  # noqa: E402
from repro.ml import pipeline as jpipe  # noqa: E402
from repro.ml import scoring as jscoring  # noqa: E402
from repro.ml import train as jtrain  # noqa: E402
from repro.systems.config import get_system  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch.datasets import synthetic as tsyn  # noqa: E402
from repro_torch.ml import forest as tforest  # noqa: E402
from repro_torch.ml import kmeans as tkmeans  # noqa: E402
from repro_torch.ml import pipeline as tpipe  # noqa: E402
from repro_torch.ml import scoring as tscoring  # noqa: E402
from repro_torch.ml import train as ttrain  # noqa: E402
from test_torch_common import (as_np, assert_exact,  # noqa: E402
                               assert_jobsets_equal, leaves, to_port)

FIT_RTOL = 1e-5      # centers, moments, reg_w, predictions
THRESH_RTOL = 1e-6   # the forest's split thresholds

FUGAKU = get_system("fugaku").scaled(128)       # tests/test_ml.py
MARCONI = get_system("marconi100").scaled(64)   # tests/test_train.py
# (system, WorkloadSpec fields, fit keywords) of the reference's fixtures
FIXTURES = {
    "test_ml-pipeline": (FUGAKU, dict(n_jobs=300, duration_s=86400.0,
                                      load=1.2, trace_len=8, n_accounts=16,
                                      seed=4),
                         dict(k=4, n_trees=6, depth=5)),
    "test_ml-spikes": (FUGAKU, dict(n_jobs=200, duration_s=4 * 3600.0,
                                    load=2.2, trace_len=8, n_accounts=8,
                                    seed=13, max_frac_nodes=0.4),
                       dict(k=3, n_trees=4, depth=4)),
    "test_train": (MARCONI, dict(n_jobs=90, duration_s=3600.0, load=1.6,
                                 trace_len=8, n_accounts=8,
                                 mean_wall_s=3600.0, seed=7),
                   dict(k=3, n_trees=4, depth=4, seed=0)),
}


def jobset_pair(name):
    """One fixture's training jobs made by both packages' dataset copies,
    checked equal field for field."""
    system, spec, _ = FIXTURES[name]
    want = jgen(system, JSpec(**spec))
    got = tsyn.generate(to_port(system), tsyn.WorkloadSpec(**spec))
    assert_jobsets_equal(want, got, name)
    return want, got


def assert_close(want, got, rtol, what):
    np.testing.assert_allclose(as_np(got), np.asarray(want), rtol=rtol,
                               atol=0.0, err_msg=what)


# ---------------------------------------------------------------------------
# k-means seed points: jax.random.choice(key, n, (k,), replace=False).
# ---------------------------------------------------------------------------
def tied_keys(seed, n):
    """Indices whose first-round sort keys tie, for ``seed`` and ``n``."""
    sub = prng.split(prng.seed_key(torch.tensor(seed)), 2)[1]
    bits = prng.random_bits(sub, (n,))
    vals, counts = torch.unique(bits, return_counts=True)
    return torch.nonzero(torch.isin(bits, vals[counts > 1])).flatten()


@pytest.mark.parametrize("seed,n", [(0, 1625), (0, 1626), (7, 4000),
                                    (1563, 1625), (3334, 1625), (5, 1),
                                    (1, 2)])
def test_kmeans_seed_points_match_jax(seed, n):
    """The whole permutation and the first k of it (the seed points), for
    one round of sorting (n <= 1,625), two (n >= 1,626), none (n = 1), and
    at the two seeds below 40,000 whose keys tie at n = 1,625 (found by
    search): the stable sort keeps the tied pair in index order."""
    if seed in (1563, 3334):
        assert len(tied_keys(seed, n)) == 2
    want = np.asarray(jax.random.permutation(jax.random.PRNGKey(seed), n))
    got = tkmeans.permutation(seed, n)
    assert_exact(want, got.to(torch.int32), f"permutation {seed} {n}")
    k = min(n, 5)
    want = jax.random.choice(jax.random.PRNGKey(seed), n, (k,),
                             replace=False)
    assert_exact(np.asarray(want), got[:k].to(torch.int32), "choice")


# ---------------------------------------------------------------------------
# standardize: the dtype at entry, and the sums over N.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n", [1, 33, 90, 300, 1203, 1500, 4000])
def test_standardize_matches_jax(n):
    """The moments of float32 features bit for bit at every depth of XLA's
    tree reduction (up to 32 rows, one level, two levels), and so the
    standardized features; stored moments reapply exactly."""
    rng = np.random.default_rng(n)
    x = (rng.normal(0.0, 1.0, (n, 7)) * [1, 1e3, 3, 2, 7, 1, 1e5]
         + [5, 3e3, 1, 2, 8, 0, 1e6])
    want = jkmeans.standardize(jnp.asarray(x))
    got = tkmeans.standardize(torch.tensor(x, dtype=torch.float32))
    for w, g, what in zip(want, got, ("x_std", "mean", "std")):
        assert_exact(np.asarray(w), g, f"{n} {what}")
    again = tkmeans.standardize(torch.tensor(x[:3], dtype=torch.float32),
                                got[1], got[2])[0]
    assert_exact(np.asarray(want[0])[:3], again, "stored moments")


def test_float64_standardize_would_move_the_thresholds():
    """The dtype at entry: the reference standardizes float32 features (its
    ``jnp.asarray`` with x64 off). The port does too, and its forest gets
    the reference's thresholds; a float64 standardize would not."""
    want, got = jobset_pair("test_ml-pipeline")
    xs = want.presubmit_features()
    assert xs.dtype == np.float64
    labels = np.asarray(jkmeans.fit(jkmeans.standardize(
        jnp.asarray(want.behavior_features()))[0], 4)[1])
    ref = jforest.RandomForest.fit(
        np.asarray(jkmeans.standardize(jnp.asarray(xs))[0]), labels, 4,
        n_trees=6, depth=5)
    xs_n = tkmeans.standardize(torch.from_numpy(got.presubmit_features()))[0]
    assert xs_n.dtype == torch.float32
    port = tforest.RandomForest.fit(xs_n.numpy(), labels, 4, n_trees=6,
                                    depth=5)
    assert_exact(np.asarray(ref.thresh), port.thresh, "float32 entry")
    wide = (xs - xs.mean(0)) / (xs.std(0) + 1e-6)
    moved = tforest.RandomForest.fit(wide, labels, 4, n_trees=6, depth=5)
    split = np.asarray(ref.feat) >= 0
    assert (moved.thresh.numpy()[split] != np.asarray(ref.thresh)[split]
            ).mean() > 0.5


# ---------------------------------------------------------------------------
# k-means.
# ---------------------------------------------------------------------------
def test_kmeans_separates_blobs():
    """tests/test_ml.py's blobs: the same labels, centers and inertia as
    the reference, and one cluster (almost) pure per blob."""
    rng = np.random.default_rng(0)
    a = rng.normal(0, 0.3, (100, 4))
    b = rng.normal(5, 0.3, (80, 4))
    x = np.vstack([a, b])
    want = jkmeans.fit(jnp.asarray(x), 2, seed=1)
    centers, labels, inertia = tkmeans.fit(
        torch.tensor(x, dtype=torch.float32), 2, seed=1)
    assert_exact(np.asarray(want[1]).astype(np.int64), labels, "labels")
    assert_close(want[0], centers, FIT_RTOL, "centers")
    assert_close(want[2], inertia, FIT_RTOL, "inertia")
    labels = labels.numpy()
    assert (labels[:100] == labels[0]).mean() > 0.95
    assert (labels[100:] == labels[100]).mean() > 0.95
    assert labels[0] != labels[100]
    assert_exact(np.asarray(jkmeans.predict(want[0], jnp.asarray(x))
                            ).astype(np.int64),
                 tkmeans.predict(torch.tensor(np.asarray(want[0])),
                                 torch.tensor(x, dtype=torch.float32)),
                 "predict from the reference's centers")


# ---------------------------------------------------------------------------
# The forest: the argmax of a float32 mean over trees.
# ---------------------------------------------------------------------------
def test_forest_beats_chance_on_separable_data():
    """tests/test_ml.py's separable data: the same trees (``feat`` and
    ``leaf`` exactly, thresholds at rtol 1e-6), the same class
    distributions and votes, and an accuracy above 0.85."""
    rng = np.random.default_rng(1)
    n = 400
    x = rng.normal(0, 1, (n, 5))
    y = (x[:, 0] + 0.5 * x[:, 2] > 0).astype(np.int64)
    want = jforest.RandomForest.fit(x[:300], y[:300], 2, n_trees=8, depth=5,
                                    seed=0)
    got = tforest.RandomForest.fit(x[:300], y[:300], 2, n_trees=8, depth=5,
                                   seed=0)
    assert_exact(np.asarray(want.feat), got.feat, "feat")
    assert_exact(np.asarray(want.leaf), got.leaf, "leaf")
    assert_close(want.thresh, got.thresh, THRESH_RTOL, "thresh")
    xt = x[300:].astype(np.float32)
    assert_exact(np.asarray(want.predict_proba(jnp.asarray(xt))),
                 got.predict_proba(torch.from_numpy(xt)), "predict_proba")
    pred = got.predict(torch.from_numpy(xt))
    assert_exact(np.asarray(want.predict(jnp.asarray(xt))).astype(np.int64),
                 pred, "predict")
    assert (pred.numpy() == y[300:]).mean() > 0.85


@pytest.mark.parametrize("n_trees", [2, 3, 6])
def test_forest_votes_break_ties_as_jax(n_trees):
    """A forest carried over (``from_arrays``) on inputs where the mean
    over trees ties between classes at many points, and on points that
    fall exactly on a threshold (``<=`` goes left): the same distributions
    and votes as the reference."""
    rng = np.random.default_rng(n_trees)
    x = rng.normal(0, 1, (60, 4))
    y = rng.integers(0, 3, 60)
    ref = jforest.RandomForest.fit(x, y, 3, n_trees=n_trees, depth=3,
                                   seed=2)
    port = tforest.RandomForest.from_arrays(
        np.asarray(ref.feat), np.asarray(ref.thresh), np.asarray(ref.leaf),
        ref.depth, ref.n_classes)
    xt = rng.normal(0, 1, (500, 4)).astype(np.float32)
    feat, thresh = np.asarray(ref.feat)[0], np.asarray(ref.thresh)[0]
    xt[:len(feat), 0] = np.where(feat == 0, thresh, xt[:len(feat), 0])
    proba = port.predict_proba(torch.from_numpy(xt)).numpy()
    assert_exact(np.asarray(ref.predict_proba(jnp.asarray(xt))), proba,
                 "predict_proba")
    assert_exact(np.asarray(ref.predict(jnp.asarray(xt))).astype(np.int64),
                 port.predict(torch.from_numpy(xt)), "predict")
    if n_trees == 2:
        top = np.sort(proba, axis=1)
        assert (top[:, -1] == top[:, -2]).any(), "no tie exercised"


# ---------------------------------------------------------------------------
# Scoring: the basis and the weighted sum the keys are made of.
# ---------------------------------------------------------------------------
def test_exp_and_basis_are_jax_bit_for_bit():
    """``exp_f32`` against XLA's CPU ``exp`` over the normal range, and
    the basis over features from 0 to 1e9 (zeros and negatives
    included), bit for bit."""
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.uniform(-87.0, 88.0, 100_000),
                        rng.uniform(0.0, 1.0, 100_000),
                        np.array([0.0, 1.0, -1.0, 88.7, -87.3])]
                       ).astype(np.float32)
    assert_exact(np.asarray(jnp.exp(jnp.asarray(x))),
                 tscoring.exp_f32(torch.from_numpy(x)), "exp")
    f = np.abs(rng.normal(100.0, 80.0, (20_000, tscoring.K_SCORE)))
    f[:200] = rng.uniform(0.0, 1e9, (200, tscoring.K_SCORE))
    f[200:300] = 0.0
    f[300:400] = -rng.uniform(0.0, 5.0, (100, tscoring.K_SCORE))
    f = f.astype(np.float32)
    assert_exact(np.asarray(jscoring.basis(jnp.asarray(f))),
                 tscoring.basis(torch.from_numpy(f)), "basis")


def test_fma_rounds_once():
    """``fma`` against exact rational arithmetic rounded once, on products
    and addends whose float64 sum is inexact (exponents far apart) and
    where it is exact, on both sides of zero."""
    from fractions import Fraction
    rng = np.random.default_rng(4)
    a = (rng.normal(size=400) * 2.0 ** rng.integers(-20, 20, 400))
    b = (rng.normal(size=400) * 2.0 ** rng.integers(-20, 20, 400))
    c = (rng.normal(size=400) * 2.0 ** rng.integers(-60, 60, 400))
    a, b, c = (v.astype(np.float32) for v in (a, b, c))
    got = tscoring.fma(torch.from_numpy(a), torch.from_numpy(b),
                       torch.from_numpy(c)).numpy()
    for i in range(len(a)):
        exact = Fraction(float(a[i])) * Fraction(float(b[i])) + \
            Fraction(float(c[i]))
        lo = np.float32(float(exact))
        cands = [np.nextafter(lo, np.float32(-np.inf)), lo,
                 np.nextafter(lo, np.float32(np.inf))]
        best = min(cands, key=lambda v: (abs(Fraction(float(v)) - exact),
                                         int(np.float32(v).view(np.int32))
                                         & 1))
        assert got[i] == best, (i, a[i], b[i], c[i], got[i], best)


def test_score_is_decreasing_in_features():
    """tests/test_ml.py: a bigger predicted impact scores lower."""
    alpha = torch.ones(3)
    lo = tscoring.score(torch.tensor([[1.0, 1.0, 1.0]]), alpha)
    hi = tscoring.score(torch.tensor([[100.0, 100.0, 100.0]]), alpha)
    assert float(lo[0]) > float(hi[0])


@pytest.mark.parametrize("alpha", [0.7, (1.0, 0.5, 2.0, 0.1)],
                         ids=["scalar", "vector"])
def test_weighted_sum_is_xla_s_fused_reduction(alpha):
    """``weighted_sum`` equals XLA's jitted ``sum(basis * alpha, -1)``
    (what the reference's ``ml_key`` computes) bit for bit."""
    rng = np.random.default_rng(2)
    b = np.array(jscoring.basis(jnp.asarray(np.abs(rng.normal(
        100.0, 80.0, (20_000, tscoring.K_SCORE))).astype(np.float32))))
    a = np.asarray(alpha, np.float32)
    want = jax.jit(lambda b, a: jnp.sum(b * a, axis=-1))(b, a)
    assert_exact(np.asarray(want), tscoring.weighted_sum(
        torch.from_numpy(b), torch.from_numpy(a)), "weighted_sum")


# ---------------------------------------------------------------------------
# The pipeline: the fit stage by stage, and the carried model.
# ---------------------------------------------------------------------------
def test_presubmit_and_behavior_features_match_jax():
    want, got = jobset_pair("test_ml-pipeline")
    assert_exact(want.presubmit_features(), got.presubmit_features(),
                 "presubmit")
    assert_exact(want.behavior_features(), got.behavior_features(),
                 "behavior")


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_pipeline_fit_matches_jax_stage_by_stage(name):
    """``MLSchedulerModel.fit`` on the reference's fixtures: the moments
    bit for bit, k-means' labels exactly and centers at rtol 1e-5, the
    forest's ``feat`` and ``leaf`` exactly and thresholds at rtol 1e-6,
    ``reg_w`` and the predictions at rtol 1e-5, the clusters exactly."""
    _, _, fit = FIXTURES[name]
    want_js, got_js = jobset_pair(name)
    want = jpipe.MLSchedulerModel.fit(want_js, **fit)
    got = tpipe.MLSchedulerModel.fit(got_js, **fit)
    for k in ("x_mean", "x_std", "b_mean", "b_std", "alpha"):
        assert_exact(np.asarray(getattr(want, k)), getattr(got, k), k)
    xb = jkmeans.standardize(jnp.asarray(want_js.behavior_features()),
                             want.b_mean, want.b_std)[0]
    assert_exact(np.asarray(jkmeans.predict(want.centers, xb)
                            ).astype(np.int64),
                 tkmeans.predict(got.centers, tkmeans.standardize(
                     torch.from_numpy(got_js.behavior_features()),
                     got.b_mean, got.b_std)[0]), "labels")
    assert_close(want.centers, got.centers, FIT_RTOL, "centers")
    assert_exact(np.asarray(want.clf.feat), got.clf.feat, "feat")
    assert_exact(np.asarray(want.clf.leaf), got.clf.leaf, "leaf")
    assert_close(want.clf.thresh, got.clf.thresh, THRESH_RTOL, "thresh")
    assert_close(want.reg_w, got.reg_w, FIT_RTOL, "reg_w")
    w_cluster, w_pred = want.predict_metrics(want_js)
    g_cluster, g_pred = got.predict_metrics(got_js)
    assert_exact(np.asarray(w_cluster).astype(np.int64), g_cluster,
                 "cluster")
    assert_close(w_pred, g_pred, FIT_RTOL, "predictions")


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_carried_model_predicts_and_bases_bit_for_bit(name):
    """The JAX-fitted model through ``from_arrays``: clusters,
    predictions, scoring features, the basis and the baked score of
    held-out jobs bit for bit."""
    system, spec, fit = FIXTURES[name]
    want_js, _ = jobset_pair(name)
    model = jpipe.MLSchedulerModel.fit(want_js, **fit)
    port = tpipe.MLSchedulerModel.from_arrays(leaves(model))
    test = dict(spec, seed=spec["seed"] + 5, n_jobs=120)
    jjs = jgen(system, JSpec(**test))
    tjs = tsyn.generate(to_port(system), tsyn.WorkloadSpec(**test))
    w_cluster, w_pred = model.predict_metrics(jjs)
    g_cluster, g_pred = port.predict_metrics(tjs)
    assert_exact(np.asarray(w_cluster).astype(np.int64), g_cluster,
                 "cluster")
    assert_exact(np.asarray(w_pred), g_pred, "predictions")
    assert_exact(np.asarray(model.score_features(jjs)),
                 port.score_features(tjs), "score_features")
    assert_exact(model.score_basis(jjs), port.score_basis(tjs), "basis")
    # the baked score, under the model's alpha and one whose products
    # round, and the reference's key (its jitted sum of basis * alpha)
    alpha = np.asarray([1.3, 0.4, 0.9, 1.1], np.float32)
    assert_exact(model.score(jjs), port.score(tjs), "score")
    assert_exact(np.asarray(jscoring.score(model.score_features(jjs),
                                           alpha)),
                 tscoring.score(port.score_features(tjs),
                                torch.from_numpy(alpha)), "score, alpha")
    key = jax.jit(lambda b, a: jnp.sum(b * a, axis=-1))(
        model.score_basis(jjs), alpha)
    assert_exact(np.asarray(key), tscoring.weighted_sum(torch.from_numpy(
        port.score_basis(tjs)), torch.from_numpy(alpha)), "key")
    got = tpipe.attach_basis(tjs, port)
    assert not got.score.any() and got.ml_basis.dtype == np.float32


def test_load_alpha_reads_a_checkpoint(tmp_path):
    path = tmp_path / "ck.json"
    path.write_text(json.dumps({"best_alpha": [1.2, 0.8, 1.1, 0.3],
                                "generation": 3}))
    assert_exact(jtrain.load_alpha(path), torch.from_numpy(
        ttrain.load_alpha(path)), "alpha")


def test_make_jobs_fixture_is_the_port_s():
    """``tests/test_train.py``'s ``make_jobs`` workload (conftest) is
    ``FIXTURES["test_train"]``'s, so the fit tests cover it."""
    want = make_jobs(MARCONI, seed=7, n_jobs=90, load=1.6, duration_s=3600.0,
                     mean_wall_s=3600.0, prepop=False)
    assert_jobsets_equal(want, jobset_pair("test_train")[1], "make_jobs")


def test_the_reference_bakes_scores_in_another_rounding():
    """The reference's eager ``scoring.score`` rounds each product before
    summing; its jitted ``ml_key`` fuses the sum into fused multiply-adds.
    With the default alpha every product is exact and the two agree; with
    another alpha they differ by an ulp on some jobs. The port's
    ``score`` is the eager rounding and its ``weighted_sum`` the key's,
    each bit for bit under every alpha."""
    rng = np.random.default_rng(6)
    f = np.abs(rng.normal(100.0, 80.0, (2_000, tscoring.K_SCORE))
               ).astype(np.float32)
    b = jscoring.basis(jnp.asarray(f))
    key = jax.jit(lambda b, a: jnp.sum(b * a, axis=-1))
    for alpha, agree in ((tscoring.DEFAULT_ALPHA, True),
                         ((1.0, 0.5, 2.0, 0.1), False)):
        a = np.asarray(alpha, np.float32)
        eager = np.asarray(jscoring.score(jnp.asarray(f), jnp.asarray(a)))
        want = np.asarray(key(b, a))
        assert np.array_equal(eager, want) == agree, alpha
        assert_exact(eager, tscoring.score(torch.from_numpy(f),
                                           torch.from_numpy(a)), "score")
        assert_exact(want, tscoring.weighted_sum(
            torch.from_numpy(np.array(b)), torch.from_numpy(a)), "key")


def test_torch_sqrt_misses_xla_where_sqrt_f32_does_not():
    """torch's float32 ``sqrt`` on the CPU is off by an ulp on some
    inputs, where XLA's is correctly rounded: ``basis`` takes
    ``sqrt_f32``, which matches XLA on every input."""
    x = (np.random.default_rng(9).uniform(0.0, 1e6, 200_000) + 1.0
         ).astype(np.float32)
    want = np.asarray(jnp.sqrt(jnp.asarray(x)))
    assert not np.array_equal(want, torch.sqrt(torch.from_numpy(x)).numpy())
    assert_exact(want, tscoring.sqrt_f32(torch.from_numpy(x)), "sqrt")


def test_select_carries_the_basis_as_jax():
    """``JobSet.select`` keeps each channel's rows, the scoring basis and
    the baked score included, as the reference's does (its CLI and fig10
    drop the jobs too large for a scaled machine this way)."""
    want, got = jobset_pair("test_train")
    basis = np.random.default_rng(8).uniform(1.0, np.e, (len(want), 4))
    for js in (want, got):
        js.ml_basis = basis.astype(np.float32)
        js.score = np.linspace(0.0, 1.0, len(js)).astype(np.float32)
    keep = np.asarray(want.nodes) <= 1
    assert 0 < keep.sum() < len(keep)
    assert_jobsets_equal(want.select(keep), got.select(keep), "select")
