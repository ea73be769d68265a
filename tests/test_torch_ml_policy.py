"""The ML policy in the port's engine against the JAX package's, on the
CPU.

The model is fitted by the reference and carried over
(``MLSchedulerModel.from_arrays``), so both packages rank on one basis,
bit for bit (``tests/test_torch_ml.py`` holds the fit itself). Then:

* the ``ml`` keys equal the JAX scheduler's bit for bit: under a scalar
  alpha, a vector alpha, the two stacked, and a baked score beside the
  basis (XLA fuses ``sum(ml_basis * alpha, -1)`` into fused
  multiply-adds, and a key one ulp off can swap two jobs);
* ``simulate_sweep`` of fig10's five policies (``benchmarks/fig10_ml.py``)
  on a small Fugaku, the ``ml`` row at the model's alpha, against JAX's:
  schedules exactly, floats at rtol 1e-4;
* the ports of ``tests/test_ml.py``'s policy tests and of
  ``tests/test_train.py``'s alpha tests, each also against the JAX run;
* the reference's identity, held bit for bit in the port: a baked score
  (``attach_scores`` + ``simulate_static``) runs as ``ml_basis`` with
  ``Scenario.alpha`` under the model's own alpha (whose products are
  exact, so the baked eager sum and the key's fused one agree), and a
  sweep's ``ml`` row as a solo run.
"""
import copy
import dataclasses

import jax
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from repro.core import engine as jeng  # noqa: E402
from repro.core import scheduler as jsched  # noqa: E402
from repro.core import types as JT  # noqa: E402
from repro.datasets.synthetic import WorkloadSpec as JSpec  # noqa: E402
from repro.datasets.synthetic import generate as jgen  # noqa: E402
from repro.ml import pipeline as jpipe  # noqa: E402
from repro.ml import scoring as jscoring  # noqa: E402
from repro.systems.config import get_system  # noqa: E402
from repro_torch.core import engine as teng  # noqa: E402
from repro_torch.core import scheduler as tsched  # noqa: E402
from repro_torch.core import types as TT  # noqa: E402
from repro_torch.datasets import synthetic as tsyn  # noqa: E402
from repro_torch.ml import pipeline as tpipe  # noqa: E402
from repro_torch.ml import scoring as tscoring  # noqa: E402
from test_torch_common import (as_np, assert_exact,  # noqa: E402
                               assert_runs_match, assert_states_equal,
                               ml_pair, to_port)

RTOL = 1e-4
FUGAKU = get_system("fugaku").scaled(128)         # tests/test_ml.py
MARCONI = get_system("marconi100").scaled(64)     # tests/test_train.py
# fig10's five policies under first-fit, the ml row at the model's alpha
POLICIES = ["fcfs", "sjf", "priority", "ljf", "ml"]


def fig10_pair(attach="basis"):
    """fig10's setup (``benchmarks/fig10_ml.py:43-59``) cut to a small
    Fugaku: a 14-day training history at load 0.8 (seed 30, k=5, 8 trees
    of depth 6) and a high-load test backlog (load 1.8, seed 31, jobs of
    at most 15 % of the machine)."""
    system = get_system("fugaku").scaled(256)
    return (system,) + ml_pair(
        system, dict(n_jobs=400, duration_s=14 * 86400.0, load=0.8,
                     trace_len=8, n_accounts=64, seed=30),
        dict(n_jobs=150, duration_s=6 * 3600.0, load=1.8, trace_len=8,
             n_accounts=64, seed=31, max_frac_nodes=0.15),
        attach=attach, k=5, n_trees=8, depth=6)


def fitted(attach):
    """tests/test_train.py's ``_fitted()`` workload in both packages, the
    JAX model carried over, its basis or score attached."""
    return ml_pair(MARCONI, dict(n_jobs=90, duration_s=3600.0, load=1.6,
                                 trace_len=8, n_accounts=8,
                                 mean_wall_s=3600.0, seed=7),
                   dict(n_jobs=90, duration_s=3600.0, load=1.6, trace_len=8,
                        n_accounts=8, mean_wall_s=3600.0, seed=7),
                   attach=attach, k=3, n_trees=4, depth=4, seed=0)


# ---------------------------------------------------------------------------
# The keys: the sum over K that a lexsort compares.
# ---------------------------------------------------------------------------
ALPHAS = {
    "scalar": [0.0, 0.5, 2.0],
    "vector": [(1.0, 1.0, 1.0, 0.5), (0.1, 3.0, 0.1, 3.0),
               (2.5, 0.0, 1.0, 0.25)],
    "mixed": [0.5, (1.0, 1.0, 1.0, 0.5)],
}


@pytest.mark.parametrize("baked", [False, True], ids=["basis", "both"])
@pytest.mark.parametrize("case", sorted(ALPHAS))
def test_ml_keys_are_jax_s_bit_for_bit(case, baked):
    """The port's ``policy_key`` against the JAX scheduler's, jitted and
    vmapped over the stacked scenarios as the engine runs it; ``both``
    also bakes a nonzero score beside the basis. The basis folded into
    the score once, as a run does, keys alike."""
    ttable, jtable, _, _ = fitted("basis")
    if baked:
        score = np.random.default_rng(1).uniform(
            0.0, 5.0, ttable.num_jobs).astype(np.float32)
        jtable = dataclasses.replace(jtable, score=jax.numpy.asarray(score))
        ttable = dataclasses.replace(ttable, score=torch.from_numpy(score))
    alphas = ALPHAS[case]
    jscen = JT.stack_scenarios([JT.Scenario.make("ml", alpha=a)
                                for a in alphas])
    tscen = TT.stack_scenarios([TT.Scenario.make("ml", alpha=a)
                                for a in alphas])
    acct = JT.AccountStats.zeros(8)
    want = jax.jit(jax.vmap(lambda s: jsched.policy_key(jtable, acct, s)))(
        jscen)
    tacct = TT.tree_map(lambda x: x.expand(len(alphas), -1),
                        TT.AccountStats.zeros(8))
    got = tsched.policy_key(ttable, tacct, tscen)
    assert_exact(np.asarray(want), got, f"{case} keys")
    # a run folds the basis into the score once: the same keys
    folded = tsched.fold_ml_basis(ttable, tscen)
    assert folded.ml_basis is None
    assert_exact(np.asarray(want), tsched.policy_key(folded, tacct, tscen),
                 f"{case} folded keys")
    assert len({tuple(k) for k in got.tolist()}) == len(alphas)


# ---------------------------------------------------------------------------
# fig10's sweep.
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def fig10():
    system, ttable, jtable, tmodel, jmodel = fig10_pair()
    alpha = np.asarray(jmodel.alpha)
    t1 = 3 * 3600.0
    want = jeng.simulate_sweep(
        system, jtable, [JT.Scenario.make(
            p, "first-fit", alpha=alpha if p == "ml" else 0.0)
            for p in POLICIES], 0.0, t1)
    scens = [TT.Scenario.make(p, "first-fit",
                              alpha=alpha if p == "ml" else 0.0)
             for p in POLICIES]
    got = teng.simulate_sweep(to_port(system), ttable, scens, 0.0, t1,
                              device="cpu")
    return dict(system=system, ttable=ttable, tmodel=tmodel, scens=scens,
                t1=t1, want=want, got=got)


def test_fig10_policies_sweep_matches_jax(fig10):
    """Schedules exactly, every telemetry row and float leaf at rtol 1e-4
    (``power_fan`` also within 1e-4 of the watt: the fans run near zero
    on a small machine); the ml row ranks its own way."""
    assert_runs_match(fig10["want"], fig10["got"], RTOL, "fig10",
                      atol={"power_fan": 1e-4})
    start = as_np(fig10["got"][0].start)
    ml = POLICIES.index("ml")
    for i in range(len(POLICIES)):
        if i != ml:
            assert not np.array_equal(start[i], start[ml]), POLICIES[i]
    assert (as_np(fig10["got"][0].jstate) == TT.DONE).sum(1).min() > 0


def test_fig10_ml_row_is_a_solo_run(fig10):
    """The sweep's ml row equals a solo ``simulate`` of its scenario bit
    for bit."""
    finals, hists = fig10["got"]
    ml = POLICIES.index("ml")
    solo = teng.simulate(to_port(fig10["system"]), fig10["ttable"],
                         fig10["scens"][ml], 0.0, fig10["t1"], device="cpu")
    assert_states_equal(solo[0], TT.row(finals, ml), "final ")
    assert_states_equal(solo[1], TT.row(hists, ml), "history ")


# ---------------------------------------------------------------------------
# tests/test_ml.py's policy tests.
# ---------------------------------------------------------------------------
def test_pipeline_end_to_end_and_policy():
    """The port's own fit on the port's workload, scores attached, the ml
    policy under first-fit for 4 h: the shapes, finite scores, and a rank
    correlation of score and start above -0.1; the run equals the JAX
    package's (its model fitted on its own workload) with schedules
    exact."""
    spec = dict(n_jobs=300, duration_s=86400.0, load=1.2, trace_len=8,
                n_accounts=16, seed=4)
    test = dict(n_jobs=120, duration_s=6 * 3600.0, load=1.5, trace_len=8,
                seed=9)
    tsys = to_port(FUGAKU)
    model = tpipe.MLSchedulerModel.fit(
        tsyn.generate(tsys, tsyn.WorkloadSpec(**spec)), k=4, n_trees=6,
        depth=5)
    test_js = tsyn.generate(tsys, tsyn.WorkloadSpec(**test))
    cluster, pred = model.predict_metrics(test_js)
    assert tuple(pred.shape) == (120, 3)
    assert int(cluster.max()) < 4
    tpipe.attach_scores(test_js, model)
    assert np.isfinite(test_js.score).all()
    got = teng.simulate(tsys, test_js.to_table(),
                        TT.Scenario.make("ml", "first-fit"), 0.0, 4 * 3600.0,
                        device="cpu")
    start = got[0].start.numpy()[:len(test_js)]
    started = np.isfinite(start)
    assert started.sum() > 10
    rank_score = np.argsort(np.argsort(-test_js.score[started]))
    rank_start = np.argsort(np.argsort(start[started]))
    assert np.corrcoef(rank_score, rank_start)[0, 1] > -0.1

    jmodel = jpipe.MLSchedulerModel.fit(jgen(FUGAKU, JSpec(**spec)), k=4,
                                        n_trees=6, depth=5)
    jjs = jgen(FUGAKU, JSpec(**test))
    jpipe.attach_scores(jjs, jmodel)
    want = jeng.simulate(FUGAKU, jjs.to_table(),
                         JT.Scenario.make("ml", "first-fit"), 0.0,
                         4 * 3600.0)
    assert_runs_match(want, got, RTOL, "end to end",
                      atol={"power_fan": 1e-4})


def test_ml_policy_reduces_power_spikes_under_load():
    """Paper Fig. 10a: under high load the ML policy lowers the power peak
    against LJF; each run against the JAX package's (the model fitted by
    each package on the same jobs)."""
    spec = dict(n_jobs=200, duration_s=4 * 3600.0, load=2.2, trace_len=8,
                n_accounts=8, seed=13, max_frac_nodes=0.4)
    tsys = to_port(FUGAKU)
    js = tsyn.generate(tsys, tsyn.WorkloadSpec(**spec))
    tpipe.attach_scores(js, tpipe.MLSchedulerModel.fit(js, k=3, n_trees=4,
                                                      depth=4))
    jjs = jgen(FUGAKU, JSpec(**spec))
    jpipe.attach_scores(jjs, jpipe.MLSchedulerModel.fit(jjs, k=3, n_trees=4,
                                                       depth=4))
    peaks = {}
    for policy in ("ml", "ljf"):
        got = teng.simulate(tsys, js.to_table(),
                            TT.Scenario.make(policy, "first-fit"), 0.0,
                            2 * 3600.0, device="cpu")
        want = jeng.simulate(FUGAKU, jjs.to_table(),
                             JT.Scenario.make(policy, "first-fit"), 0.0,
                             2 * 3600.0)
        assert_runs_match(want, got, RTOL, policy, atol={"power_fan": 1e-4})
        peaks[policy] = float(got[1].power_it.max())
    assert peaks["ml"] <= peaks["ljf"] * 1.05


# ---------------------------------------------------------------------------
# tests/test_train.py's alpha tests.
# ---------------------------------------------------------------------------
def test_score_is_linear_in_alpha():
    """S(a1 + a2) = S(a1) + S(a2) and S(a) = basis @ a at rtol 1e-5, as
    the reference holds it; and the port's score and key are the
    reference's eager score and jitted key bit for bit."""
    feats = np.abs(np.random.default_rng(0).normal(
        100.0, 50.0, (40, tscoring.K_SCORE))).astype(np.float32)
    a1 = np.asarray([1.0, 0.5, 2.0, 0.1], np.float32)
    a2 = np.asarray([0.2, 1.5, 0.0, 1.0], np.float32)
    f = torch.from_numpy(feats)
    s_sum = tscoring.score(f, torch.from_numpy(a1 + a2))
    s_parts = tscoring.score(f, torch.from_numpy(a1)) + \
        tscoring.score(f, torch.from_numpy(a2))
    np.testing.assert_allclose(s_sum.numpy(), s_parts.numpy(), rtol=1e-5)
    basis = tscoring.basis(f)
    np.testing.assert_allclose(tscoring.score(f, torch.from_numpy(a1)),
                               basis.numpy() @ a1, rtol=1e-5)
    assert_exact(np.asarray(jscoring.score(feats, a1)),
                 tscoring.score(f, torch.from_numpy(a1)), "score")
    key = jax.jit(lambda b, a: jax.numpy.sum(b * a, axis=-1))(
        jscoring.basis(feats), a1)
    assert_exact(np.asarray(key), tscoring.weighted_sum(
        basis, torch.from_numpy(a1)), "key")


def test_alpha_scenario_matches_baked_score_static_parity():
    """Scenario.alpha on a basis table equals attach_scores +
    simulate_static bit for bit in the port (the same keys, then the same
    run), and each run equals the JAX package's with schedules exact."""
    tbaked, jbaked, _, model = fitted("scores")
    tbasis, jbasis, _, _ = fitted("basis")
    alpha = np.asarray(model.alpha)
    t1 = 3600.0
    f_static, h_static = teng.simulate_static(
        to_port(MARCONI), tbaked, "ml", "first-fit", 0.0, t1, device="cpu")
    f_alpha, h_alpha = teng.simulate(
        to_port(MARCONI), tbasis,
        TT.Scenario.make("ml", "first-fit", alpha=alpha), 0.0, t1,
        device="cpu")
    acct = TT.tree_map(lambda x: x[None], TT.AccountStats.zeros(8))
    assert_exact(
        tsched.policy_key(tbaked, acct, TT.stack_scenarios(
            [TT.Scenario.make("ml")])).numpy(),
        tsched.policy_key(tbasis, acct, TT.stack_scenarios(
            [TT.Scenario.make("ml", alpha=alpha)])), "baked vs alpha keys")
    assert_states_equal(f_static, f_alpha, "final ")
    assert_states_equal(h_static, h_alpha, "history ")
    assert (f_alpha.jstate.numpy() == TT.DONE).any()
    assert_runs_match(jeng.simulate_static(MARCONI, jbaked, "ml",
                                           "first-fit", 0.0, t1),
                      (f_static, h_static), RTOL, "baked",
                      atol={"power_fan": 1e-4})
    assert_runs_match(jeng.simulate(MARCONI, jbasis,
                                    JT.Scenario.make("ml", "first-fit",
                                                     alpha=alpha), 0.0, t1),
                      (f_alpha, h_alpha), RTOL, "alpha",
                      atol={"power_fan": 1e-4})


def test_neutral_alpha_keeps_legacy_ranking():
    """alpha = 0 on a basis-carrying table leaves the non-ml policies
    alone (simulate equals simulate_static bit for bit, and JAX's), and
    leaves the ml key at the (zeroed) baked score."""
    tbasis, jbasis, _, _ = fitted("basis")
    f1, h1 = teng.simulate(to_port(MARCONI), tbasis,
                           TT.Scenario.make("fcfs", "first-fit"), 0.0,
                           3600.0, device="cpu")
    f2, h2 = teng.simulate_static(to_port(MARCONI), tbasis, "fcfs",
                                  "first-fit", 0.0, 3600.0, device="cpu")
    assert_states_equal(f1, f2, "final ")
    assert_states_equal(h1, h2, "history ")
    assert_runs_match(jeng.simulate(MARCONI, jbasis,
                                    JT.Scenario.make("fcfs", "first-fit"),
                                    0.0, 3600.0),
                      (f1, h1), RTOL, "neutral", atol={"power_fan": 1e-4})
    acct = TT.tree_map(lambda x: x[None], TT.AccountStats.zeros(8))
    key = tsched.policy_key(tbasis, acct, TT.stack_scenarios(
        [TT.Scenario.make("ml")]))[0]
    assert torch.equal(key, -tbasis.score)


def test_baked_score_with_copied_jobset_is_unchanged():
    """attach_scores and attach_basis write only their own fields: a deep
    copy of the jobs before each gives the same tables but for ``score``
    and ``ml_basis``."""
    system = to_port(MARCONI)
    js = tsyn.generate(system, tsyn.WorkloadSpec(
        n_jobs=90, duration_s=3600.0, load=1.6, trace_len=8, n_accounts=8,
        mean_wall_s=3600.0, seed=7))
    model = tpipe.MLSchedulerModel.fit(js, k=3, n_trees=4, depth=4)
    baked = tpipe.attach_scores(copy.deepcopy(js), model).to_table()
    basis = tpipe.attach_basis(copy.deepcopy(js), model).to_table()
    plain = js.to_table()
    for f in dataclasses.fields(plain):
        if f.name not in ("score", "ml_basis"):
            assert_exact(as_np(getattr(plain, f.name)),
                         getattr(baked, f.name), f.name)
            assert_exact(as_np(getattr(plain, f.name)),
                         getattr(basis, f.name), f.name)
    assert baked.ml_basis is None and not basis.score.any()
    assert_exact(tscoring.weighted_sum(basis.ml_basis, model.alpha).numpy(),
                 baked.score, "score = basis @ alpha")
