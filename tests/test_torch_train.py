"""ES training of the ML alpha (``repro_torch.ml.train``) against the JAX
package's ``repro.ml.train``, on the CPU.

* The ES arithmetic bit for bit on the same numpy inputs: ``Reward``'s
  parse, spec, refs and evaluate, ``antithetic_population``,
  ``centered_ranks`` (ties and all-equal rewards included) and
  ``es_update``.
* ``rollout_metrics`` from the port's sweep against the reference's from
  its own, on the same table and P + 2 alpha scenarios: ``wait``,
  ``turnaround``, ``unfinished`` and ``overheat`` exactly, the rest at
  rtol 1e-5 (the largest relative difference seen is 1.2e-7, in
  ``energy``: a float32 ulp or two of a facility energy total).
* ``train`` through both packages' ``main`` on ``SMOKE_CONFIG``, and resumed
  across packages from each other's checkpoints. Every generation's
  candidates, tie pattern and next mean are held bit for bit while the two
  packages' rewards (within 5e-6) rank alike; see ``hold_es`` for where
  they cannot.
* Ports of ``tests/test_train.py``'s ES tests, each also run against the
  JAX package where it runs a rollout (its three alpha tests have ports
  in ``tests/test_torch_ml_policy.py``).

The rewards come out of sweeps that agree across the two frameworks at
the reference's tolerances, not bit for bit, so two candidates whose
rewards are equal in one package can be a float32 ulp apart in the
other. On ``SMOKE_CONFIG`` that happens in generation 2: the reference
scores all eight candidates -2.044301013, though rows 1-3 place their
jobs otherwise than the rest; its float32 energy totals happen to round
alike. The port's rows 0 and 2-7 land one ulp (64 J) below that total
and its row 1 on it, so row 1 scores 2.1e-8 below the other seven
(``test_smoke_generation_2_tie_is_float32_accumulation``). From there
each package ranks by its own last bits.
"""
import contextlib
import dataclasses
import itertools
import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from conftest import make_jobs, make_signals  # noqa: E402
from repro.core import engine as jeng  # noqa: E402
from repro.cooling import weather as jwsig  # noqa: E402
from repro.core import types as JT  # noqa: E402
from repro.datasets import loaders as jloaders  # noqa: E402
from repro.ml import pipeline as jpipe  # noqa: E402
from repro.ml import train as jtrain  # noqa: E402
from repro.systems.config import get_system  # noqa: E402
from repro_torch.cooling import weather as twsig  # noqa: E402
from repro_torch.core import engine as teng  # noqa: E402
from repro_torch.core import types as TT  # noqa: E402
from repro_torch.datasets import loaders as tloaders  # noqa: E402
from repro_torch.datasets import synthetic as tsyn  # noqa: E402
from repro_torch.launch import simulate as tcli  # noqa: E402
from repro_torch.ml import pipeline as tpipe  # noqa: E402
from repro_torch.ml import scoring as tscoring  # noqa: E402
from repro_torch.ml import train as ttrain  # noqa: E402
from test_torch_common import (METRIC_RTOL, REWARD_TOL,  # noqa: E402
                               assert_checkpoints_match, assert_exact,
                               assert_histories_match, assert_runs_match,
                               assert_states_equal, leaves, port_signals,
                               to_port)

SYS = get_system("marconi100").scaled(64)      # tests/test_train.py
TSYS = to_port(SYS)
T1 = 3600.0
EXACT_METRICS = ("wait", "turnaround", "unfinished", "overheat")


# ---------------------------------------------------------------------------
# Helpers.
# ---------------------------------------------------------------------------
def fitted_pair(seed=7, n_jobs=90, load=1.6):
    """``tests/test_train.py``'s ``_fitted`` workload in both packages:
    the JAX pipeline fitted on it (k=3, 4 trees of depth 4) and carried
    into the port, the basis attached, unplaced. Returns (port table, JAX
    table), checked equal leaf for leaf."""
    spec = dict(n_jobs=n_jobs, duration_s=T1, load=load, trace_len=8,
                n_accounts=8, mean_wall_s=3600.0, seed=seed)
    jjs = make_jobs(SYS, seed=seed, n_jobs=n_jobs, load=load, duration_s=T1,
                    mean_wall_s=3600.0, prepop=False)
    jmodel = jpipe.MLSchedulerModel.fit(jjs, k=3, n_trees=4, depth=4, seed=0)
    jpipe.attach_basis(jjs, jmodel)
    tjs = tsyn.generate(TSYS, tsyn.WorkloadSpec(**spec))
    tpipe.attach_basis(tjs, tpipe.MLSchedulerModel.from_arrays(
        leaves(jmodel)))
    jtable, ttable = jjs.to_table(), tjs.to_table()
    for name, w in leaves(jtable).items():
        if w is not None:
            assert_exact(w, getattr(ttable, name), f"table {name}")
    return ttable, jtable


@contextlib.contextmanager
def es_steps(module):
    """Record every ES step ``module.train`` takes: ``es_update``'s
    inputs and result, one entry a generation, with the generation's
    sweep's final ``energy_total`` and per-step ``power_total`` by row."""
    steps, orig, orig_rollout = [], module.es_update, module._rollout
    sweep = {}

    def rollout(*args, **kw):
        finals, hists = orig_rollout(*args, **kw)
        sweep.update(energy=np.array(finals.energy_total),
                     power=np.array(hists.power_total))
        return finals, hists

    def spy(mu, candidates, rewards, sigma, lr):
        out = orig(mu, candidates, rewards, sigma, lr)
        steps.append(SimpleNamespace(
            mu=np.array(mu), cands=np.array(candidates),
            rewards=np.array(rewards), sigma=sigma, lr=lr, out=out,
            **sweep))
        return out

    module.es_update, module._rollout = spy, rollout
    try:
        yield steps
    finally:
        module.es_update, module._rollout = orig, orig_rollout


def order(r):
    """The sign of every pairwise difference: the ranks with their ties."""
    return np.sign(r[:, None] - r[None, :])


def hold_es(want, got, tol=REWARD_TOL):
    """Hold ``got``'s ES steps to ``want``'s, generation by generation:
    the mean, the candidates and the next mean bit for bit, the rewards
    within ``tol``, while the two reward vectors order the candidates
    alike, ties included.

    Returns the first generation where they order them otherwise, or
    None. There, every pair ordered otherwise must be a near tie (within
    ``tol`` in both reward vectors), and the port's ES step on ``want``'s
    rewards must give ``want``'s next mean bit for bit: what differs is
    the sweep's last bits, not the ES arithmetic. Later generations start
    from other means and are not compared."""
    assert len(want) == len(got)
    for g, (w, o) in enumerate(zip(want, got)):
        assert_exact(w.mu, o.mu, f"generation {g} mu")
        assert_exact(w.cands, o.cands, f"generation {g} candidates")
        np.testing.assert_allclose(o.rewards, w.rewards, rtol=0, atol=tol,
                                   err_msg=f"generation {g} rewards")
        if np.array_equal(order(w.rewards), order(o.rewards)):
            assert_exact(w.out, o.out, f"generation {g} next mu")
            continue
        for i, j in itertools.combinations(range(len(w.rewards)), 2):
            if np.sign(w.rewards[i] - w.rewards[j]) != \
                    np.sign(o.rewards[i] - o.rewards[j]):
                gaps = (abs(w.rewards[i] - w.rewards[j]),
                        abs(o.rewards[i] - o.rewards[j]))
                assert max(gaps) <= tol, \
                    f"generation {g}: candidates {i}, {j} swap {gaps}"
        assert_exact(w.out, ttrain.es_update(o.mu, o.cands, w.rewards,
                                             o.sigma, o.lr),
                     f"generation {g} ES step on the reference's rewards")
        return g
    return None


def assert_elites_match(want, got, steps, tol=REWARD_TOL):
    """The elites of two checkpoints: equal (returns False), or a near
    tie (returns True): ``got``'s elite is a candidate or mean it
    evaluated (``steps``) whose reward is within ``tol`` of ``want``'s
    elite, so the strict ``>`` that crowned one of them cannot be decided
    across the two packages' last bits."""
    if want["best_alpha"] == got["best_alpha"]:
        return False
    assert abs(want["best_reward"] - got["best_reward"]) <= tol
    evaluated = [row for s in steps for row in np.concatenate(
        [s.cands, s.mu[None].astype(np.float32)]).astype(np.float64).tolist()]
    assert got["best_alpha"] in evaluated
    return True


def port_metrics(table, stack, scen_kw=None, signals=None, weather=None):
    finals, hists = teng.simulate_sweep(
        TSYS, table, [TT.Scenario.make("ml", "first-fit", alpha=a,
                                       **(scen_kw or {})) for a in stack],
        0.0, T1, signals=signals, weather=weather, device="cpu")
    return (ttrain.rollout_metrics(
        TSYS, table, ttrain.to_host(finals), ttrain.to_host(hists),
        (scen_kw or {}).get("setpoint_delta_c", 0.0)), (finals, hists))


def jax_metrics(table, stack, scen_kw=None, signals=None, weather=None):
    finals, hists = jeng.simulate_sweep(
        SYS, table, [JT.Scenario.make("ml", "first-fit", alpha=a,
                                      **(scen_kw or {})) for a in stack],
        0.0, T1, signals=signals, weather=weather)
    return (jtrain.rollout_metrics(
        SYS, table, finals, hists,
        (scen_kw or {}).get("setpoint_delta_c", 0.0)), (finals, hists))


def heat_wave(wsig, system):
    """``simulate train --heat-wave-c 20``'s weather over ``T1``."""
    n_steps = int(round(T1 / system.dt))
    return wsig.heat_wave(wsig.synthetic_weather(n_steps, system.dt, seed=0),
                          system.dt, start_s=0.1 * T1, duration_s=0.6 * T1,
                          peak_amp_c=20.0)


def es_stack(population=4, seed=3):
    """P antithetic candidates around the default alpha, the mean and the
    baseline: one generation's P + 2 rows."""
    mu = np.asarray(tscoring.DEFAULT_ALPHA, np.float64)
    cands = ttrain.antithetic_population(mu, 0.3,
                                         np.random.default_rng(seed),
                                         population)
    return np.concatenate([cands, mu[None].astype(np.float32),
                           mu[None].astype(np.float32)], 0)


# ---------------------------------------------------------------------------
# The ES arithmetic, bit for bit.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("spec", [
    "wait=2, energy=0.5 ,pue", ttrain.DEFAULT_REWARD_SPEC,
    "carbon=3,cost=0.125,overheat=7,power_peak", ",wait=1e-3,,"])
def test_reward_parse_and_spec_match_the_reference(spec):
    t, j = ttrain.Reward.parse(spec), jtrain.Reward.parse(spec)
    assert t.weights == j.weights and t.spec == j.spec
    assert ttrain.Reward.parse(t.spec) == t


@pytest.mark.parametrize("spec", ["no_such_metric=1", "", " , ", "wait=1,x"])
def test_reward_parse_rejects_as_the_reference(spec):
    with pytest.raises(ValueError) as want:
        jtrain.Reward.parse(spec)
    with pytest.raises(ValueError) as got:
        ttrain.Reward.parse(spec)
    assert str(got.value) == str(want.value)


def test_metric_names_and_config_are_the_reference_s():
    assert ttrain.METRICS == jtrain.METRICS
    assert ttrain.DEFAULT_REWARD_SPEC == jtrain.DEFAULT_REWARD_SPEC
    assert ttrain.SMOKE_CONFIG == jtrain.SMOKE_CONFIG
    assert set(ttrain.SWEEP_CACHE_STATS) == set(jeng.SWEEP_CACHE_STATS)
    assert not any(ttrain.SWEEP_CACHE_STATS.values())


@pytest.mark.parametrize("zero", [None, "energy"])
def test_reward_refs_and_evaluate_bit_for_bit(zero):
    rng = np.random.default_rng(5)
    metrics = {n: np.abs(rng.normal(100.0, 40.0, 10)) for n in ttrain.METRICS}
    if zero:
        metrics[zero][-1] = 0.0          # a zero baseline: unnormalized
    spec = ttrain.DEFAULT_REWARD_SPEC + ",pue=0.3,power_peak=2"
    t, j = ttrain.Reward.parse(spec), jtrain.Reward.parse(spec)
    refs_t, refs_j = t.refs(metrics, 9), j.refs(metrics, 9)
    assert refs_t == refs_j
    assert_exact(j.evaluate(metrics, refs_j), t.evaluate(metrics, refs_t))
    assert_exact(j.evaluate(metrics, {}), t.evaluate(metrics, {}))


@pytest.mark.parametrize("population,k,seed", [(2, 4, 0), (8, 4, 33),
                                               (16, 3, 7)])
def test_antithetic_population_bit_for_bit(population, k, seed):
    mu = np.random.default_rng(seed + 100).normal(1.0, 0.5, k)
    want = jtrain.antithetic_population(mu, 0.35, np.random.default_rng(
        [seed, 2]), population)
    got = ttrain.antithetic_population(mu, 0.35, np.random.default_rng(
        [seed, 2]), population)
    assert_exact(want, got)
    with pytest.raises(AssertionError):
        ttrain.antithetic_population(mu, 0.35, np.random.default_rng(0), 3)


RANKED = {
    "distinct": np.random.default_rng(0).normal(0.0, 1.0, 16),
    "ties": np.asarray([-2.044301013, -2.044330543, -2.044301013,
                        -2.25, -2.044301013, -2.1, -2.25, -2.044301013]),
    "all_equal": np.full(8, -2.044301013114164),
    "pairs": np.repeat(np.asarray([3.0, -1.0, 7.0, 0.5]), 2),
    "one": np.asarray([1.5]),
    "two_equal": np.asarray([0.25, 0.25]),
}


@pytest.mark.parametrize("name", sorted(RANKED))
def test_centered_ranks_bit_for_bit(name):
    r = RANKED[name]
    assert_exact(jtrain.centered_ranks(r), ttrain.centered_ranks(r))


@pytest.mark.parametrize("name", ["distinct", "ties", "all_equal", "pairs"])
def test_es_update_bit_for_bit(name):
    r = RANKED[name]
    rng = np.random.default_rng(11)
    mu = rng.normal(1.0, 0.3, 4)
    cands = ttrain.antithetic_population(mu, 0.35, rng, len(r))
    assert_exact(jtrain.es_update(mu, cands, r, 0.35, 0.8),
                 ttrain.es_update(mu, cands, r, 0.35, 0.8))


# ---------------------------------------------------------------------------
# rollout_metrics.
# ---------------------------------------------------------------------------
CASES = ["plain", "signals", "heat_wave"]


@pytest.mark.parametrize("case", CASES)
def test_rollout_metrics_match_the_reference(case):
    """One generation's P + 2 rows through each package's sweep: the
    schedules exact, the wait, turnaround, unfinished and overheat
    metrics exact, the rest at rtol 1e-5. ``signals`` runs under
    time-varying carbon and price (carbon and cost), ``heat_wave`` under
    a 20 °C heat wave with the supply setpoint 5 °C lower, which the
    towers cannot hold (overheat)."""
    ttable, jtable = fitted_pair()
    stack = es_stack()
    n_steps = int(round(T1 / SYS.dt))
    jkw, tkw = {}, {}
    if case == "signals":
        # the cap lifted: a binding cap dilates runtimes by a factor the
        # port rounds down (a stated departure), so ends differ by an ulp
        jsig, tsig = make_signals(SYS, n_steps), port_signals(TSYS, n_steps)
        jkw["signals"] = dataclasses.replace(
            jsig, cap_w=np.full(n_steps, np.inf, np.float32))
        tkw["signals"] = dataclasses.replace(
            tsig, cap_w=torch.full((n_steps,), float("inf")))
    if case == "heat_wave":
        jkw["weather"] = heat_wave(jwsig, SYS)
        tkw["weather"] = heat_wave(twsig, TSYS)
        jkw["scen_kw"] = tkw["scen_kw"] = {"setpoint_delta_c": -5.0}
    want, jrun = jax_metrics(jtable, stack, **jkw)
    got, trun = port_metrics(ttable, stack, **tkw)
    assert_runs_match(jrun, trun, what=case)
    assert set(want) == set(got) == set(ttrain.METRICS)
    for name in ttrain.METRICS:
        assert got[name].dtype == np.float64 and got[name].shape == (6,)
        if name in EXACT_METRICS:
            assert_exact(want[name], got[name], name)
        else:
            np.testing.assert_allclose(got[name], want[name],
                                       rtol=METRIC_RTOL, err_msg=name)
    if case == "heat_wave":
        assert got["overheat"].min() > 0.0
    if case == "signals":
        assert (got["carbon"] > 0).all() and (got["cost"] > 0).all()


# ---------------------------------------------------------------------------
# train on SMOKE_CONFIG through both packages' main; resumed across them.
# ---------------------------------------------------------------------------
def run_cli(package, argv, ck):
    """``train --smoke`` through one package's ``train.main`` (what
    ``simulate train`` runs), its ES steps recorded; returns
    (TrainResult, steps, checkpoint dict)."""
    mod, extra = ((ttrain, ["--device", "cpu"]) if package == "port" else
                  (jtrain, []))
    with es_steps(mod) as steps:
        res = mod.main(["--smoke", "--quiet", "--checkpoint", str(ck)] +
                       extra + argv)
    return res, steps, json.loads(ck.read_text())


@pytest.fixture(scope="module")
def smoke(tmp_path_factory):
    """Both packages' uninterrupted 4-generation smoke runs."""
    tmp = tmp_path_factory.mktemp("smoke")
    return {p: run_cli(p, [], tmp / f"{p}.json") for p in ("jax", "port")}


def test_train_smoke_matches_the_reference(smoke):
    """Candidates, tie pattern, mu and the elite bit for bit, rewards
    within 5e-6, in every generation the two packages' rewards rank
    alike: generations 0 and 1, and generation 2's candidates. Generation
    2's all-equal reference rewards are a near tie in the port (see the
    module docstring)."""
    (jres, jsteps, jck), (tres, tsteps, tck) = smoke["jax"], smoke["port"]
    assert len(jsteps) == len(tsteps) == 4
    diverged = hold_es(jsteps, tsteps)
    assert diverged is None or diverged >= 2, diverged
    assert_exact(jres.alpha, tres.alpha, "elite alpha")
    assert tres.reward_default == jres.reward_default == -2.25
    assert abs(tres.reward_best - jres.reward_best) <= REWARD_TOL
    assert tres.reward_best > tres.reward_default
    assert tres.generations == jres.generations == 4
    assert_checkpoints_match(jck, tck, diverged)
    assert not assert_elites_match(jck, tck, tsteps)
    assert_histories_match(jres.history, tres.history, diverged)
    assert all(h["cache_hits"] == h["cache_misses"] == 0
               for h in tres.history)
    if diverged is None:
        assert_exact(jres.mu, tres.mu)


def test_smoke_generation_2_tie_is_float32_accumulation(smoke):
    """Why generation 2 ranks otherwise (module docstring). In both
    packages each row's energy total is, bit for bit, the float32 running
    sum E <- E + p * dt of its own per-step facility power. The
    reference's candidate rows differ in that power and in its float64
    sum, yet their float32 totals all tie; the port's, from powers within
    1e-6 of the reference's, land on two neighbouring float32 values."""
    dt = np.float32(TSYS.dt)

    def running_sum(power):
        e = np.float32(0.0)
        for p in power:
            e = np.float32(e + p * dt)
        return e
    for package in ("jax", "port"):
        step = smoke[package][1][2]
        assert [running_sum(p) for p in step.power] == step.energy.tolist()
    want, got = smoke["jax"][1][2], smoke["port"][1][2]
    n = len(want.rewards)
    assert len(np.unique(want.energy[:n])) == 1
    assert len(np.unique(want.power[:n], axis=0)) > 1
    assert len(np.unique(want.power[:n].astype(np.float64).sum(-1))) > 1
    ties = np.unique(got.energy[:n])
    assert len(ties) == 2 and ties[1] - ties[0] == np.spacing(ties[0])
    np.testing.assert_allclose(got.power, want.power, rtol=1e-6)


@pytest.mark.parametrize("first,then", [("jax", "port"), ("port", "jax")])
def test_checkpoint_resumes_across_packages(smoke, tmp_path, first, then):
    """One package's checkpoint of 2 generations, resumed by the other to
    4: candidates, ranks and mu bit for bit the resuming package's own
    uninterrupted run, and the other's wherever the two rank alike. The
    normalizers and the elite's reward carried over come from the other
    package's last bits: rewards move within 5e-6, and from the JAX
    checkpoint the port's generation-2 candidates, scoring 2.1e-8 above
    the JAX elite they tie in the JAX package, take the elite over (a near
    tie, ``assert_elites_match``)."""
    ck = tmp_path / "ck.json"
    run_cli(first, ["--generations", "2"], ck)
    res, steps, got = run_cli(then, ["--generations", "4", "--resume"], ck)
    assert len(steps) == 2 and res.generations == 4
    own_res, own_steps, own = smoke[then]
    assert hold_es(own_steps[2:], steps) is None
    assert_exact(own_res.mu, res.mu)
    assert_checkpoints_match(own, got, None)
    near = assert_elites_match(own, got, steps)
    assert near == (first == "jax")
    hold_es(smoke[first][1][2:], steps)     # near ties only
    # the checkpoint reloads in both packages to the elite it holds
    assert_exact(jtrain.load_alpha(ck), ttrain.load_alpha(ck))
    assert_exact(ttrain.load_alpha(ck), res.alpha)


# ---------------------------------------------------------------------------
# Ports of tests/test_train.py.
# ---------------------------------------------------------------------------
def test_es_generation_is_seeded_deterministic():
    """Same seed -> bit-identical candidates, rewards and updated mean;
    and the JAX package's generation, held as ``hold_es`` holds it."""
    ttable, jtable = fitted_pair()
    kw = dict(reward="wait=1", generations=1, population=4, sigma=0.3,
              lr=0.5, seed=123, checkpoint=None, log=None)
    runs = []
    for _ in range(2):
        with es_steps(ttrain) as steps:
            runs.append((ttrain.train(TSYS, ttable, 0.0, T1, device="cpu",
                                      **kw), steps))
    (a, sa), (b, sb) = runs
    np.testing.assert_array_equal(a.mu, b.mu)
    assert a.reward_best == b.reward_best
    assert a.history[0]["reward_mu"] == b.history[0]["reward_mu"]
    assert hold_es(sa, sb, tol=0.0) is None
    with es_steps(jtrain) as sj:
        want = jtrain.train(SYS, jtable, 0.0, T1, **kw)
    assert hold_es(sj, sa) is None
    assert_exact(want.mu, a.mu)


def test_antithetic_population_structure():
    rng = np.random.default_rng(0)
    mu = np.asarray([1.0, 1.0, 1.0, 0.5])
    pop = ttrain.antithetic_population(mu, 0.3, rng, 8)
    assert pop.shape == (8, 4) and pop.dtype == np.float32
    # antithetic pairing: row i and row i+4 mirror around mu
    np.testing.assert_allclose(pop[:4] + pop[4:],
                               np.broadcast_to(2 * mu, (4, 4)), atol=1e-6)


def test_centered_ranks_and_es_update_direction():
    """The ES step must move mu toward the better antithetic twin."""
    mu = np.zeros(2)
    eps = np.asarray([[1.0, 0.0]])
    cands = np.concatenate([mu + 0.5 * eps, mu - 0.5 * eps], 0)
    new = ttrain.es_update(mu, cands, np.asarray([1.0, 0.0]), 0.5, 1.0)
    assert new[0] > 0.0 and abs(new[1]) < 1e-12
    u = ttrain.centered_ranks(np.asarray([3.0, -1.0, 7.0]))
    assert u.min() == -0.5 and u.max() == 0.5 and abs(u.sum()) < 1e-12


def test_trained_alpha_beats_default_on_its_objective():
    """The elite is no worse than the hand-set default alpha on the
    training objective and, on this seeded workload, strictly better; the
    default's reward is exactly -sum(w). The same run in the JAX package,
    held as ``hold_es`` holds it."""
    tables = []
    for loaders, pipe, system in ((tloaders, tpipe, TSYS),
                                  (jloaders, jpipe, SYS)):
        js = loaders.load_marconi100(n_jobs=90, days=0.1, seed=0)
        js = js.select(np.asarray(js.nodes) <= system.n_nodes)
        model = pipe.MLSchedulerModel.fit(js, k=4, n_trees=6, depth=5,
                                          seed=0)
        pipe.attach_basis(js, model)
        js.assign_prepop_placement(0.0, system.n_nodes)
        tables.append(js.to_table())
    ttable, jtable = tables
    kw = dict(reward="wait=1,turnaround=0.5", generations=3, population=8,
              sigma=0.35, lr=0.8, seed=0, checkpoint=None, log=None)
    with es_steps(ttrain) as st:
        res = ttrain.train(TSYS, ttable, 0.0, 7200.0, device="cpu", **kw)
    assert res.reward_best >= res.reward_default
    assert res.reward_best > res.reward_default, \
        "ES failed to improve on the default alpha on the seeded workload"
    assert abs(res.reward_default - (-1.5)) < 1e-9
    with es_steps(jtrain) as sj:
        want = jtrain.train(SYS, jtable, 0.0, 7200.0, **kw)
    diverged = hold_es(sj, st)
    assert_histories_match(want.history, res.history, diverged)
    assert res.reward_default == want.reward_default


@pytest.mark.parametrize("sharded", [True, False])
def test_one_generation_is_one_batched_rollout(monkeypatch, sharded):
    """No Python loop over candidates: a generation with population P
    enters the engine exactly once (population + mean + baseline rows on
    the scenario axis of a single sweep), looked up on the engine at call
    time; the JAX package's train makes the same calls."""
    ttable, jtable = fitted_pair()
    kw = dict(reward="wait=1", generations=2, population=6, sigma=0.3,
              lr=0.5, seed=0, checkpoint=None, log=None, sharded=sharded)
    calls = {"port": [], "jax": []}

    def spying(eng, name):
        orig = eng.simulate_sweep

        def spy(system, table_, scens, *a, devices=None, **k):
            calls[name].append(len(scens))
            if devices is not None:      # the sharded form, one device
                (k["device"],) = devices
            if name == "port":
                assert k["device"] == "cpu"
            return orig(system, table_, scens, *a, **k)
        # the sharded form falls through to simulate_sweep on one device;
        # spy both
        monkeypatch.setattr(eng, "simulate_sweep", spy)
        monkeypatch.setattr(eng, "simulate_sweep_sharded", spy)

    spying(teng, "port")
    with es_steps(ttrain) as st:
        ttrain.train(TSYS, ttable, 0.0, T1, device="cpu", **kw)
    assert calls["port"] == [8, 8]   # one rollout a generation, P + 2 rows
    spying(jeng, "jax")
    with es_steps(jtrain) as sj:
        jtrain.train(SYS, jtable, 0.0, T1, **kw)
    assert calls["jax"] == calls["port"]
    assert hold_es(sj, st) is None


def test_checkpoint_resume_roundtrip(tmp_path):
    """A resumed run continues the trajectory exactly where it stopped;
    the uninterrupted run holds to the JAX package's."""
    ttable, jtable = fitted_pair()
    ck = tmp_path / "ck.json"
    kw = dict(reward="wait=1", population=4, sigma=0.3, lr=0.5, seed=5,
              log=None)
    with es_steps(ttrain) as full_steps:
        full = ttrain.train(TSYS, ttable, 0.0, T1, generations=3,
                            checkpoint=None, device="cpu", **kw)
    ttrain.train(TSYS, ttable, 0.0, T1, generations=2, checkpoint=ck,
                 device="cpu", **kw)
    resumed = ttrain.train(TSYS, ttable, 0.0, T1, generations=3,
                           checkpoint=ck, resume=True, device="cpu", **kw)
    assert_exact(full.mu, resumed.mu)
    assert resumed.reward_best == full.reward_best
    assert ttrain.load_alpha(ck).shape == (tscoring.K_SCORE,)
    assert resumed.history[:2] == json.loads(ck.read_text())["history"][:2]
    with es_steps(jtrain) as jsteps:
        want = jtrain.train(SYS, jtable, 0.0, T1, generations=3,
                            checkpoint=None, **kw)
    diverged = hold_es(jsteps, full_steps)
    assert_histories_match(want.history, full.history, diverged)


def test_reward_spec_parsing():
    r = ttrain.Reward.parse("wait=2, energy=0.5 ,pue")
    assert dict(r.weights) == {"wait": 2.0, "energy": 0.5, "pue": 1.0}
    with pytest.raises(ValueError):
        ttrain.Reward.parse("no_such_metric=1")
    with pytest.raises(ValueError):
        ttrain.Reward.parse("")


def test_train_cli_smoke_improves_reward(smoke):
    """``simulate train --smoke --device cpu`` end to end: it asserts
    internally that the trained reward improves on the default alpha and
    writes a checkpoint whose elite reloads to the alpha it returned."""
    res, _, ck = smoke["port"]
    assert res.reward_best > res.reward_default
    assert_exact(np.asarray(ck["best_alpha"], np.float32), res.alpha)


def test_sweep_population_rows_are_independent():
    """Batched rows match solo runs bit for bit: evaluating [a_default,
    a_other] in one sweep gives the same telemetry as two single
    simulations; and the JAX package's sweep at its tolerances."""
    ttable, jtable = fitted_pair()
    a0 = np.asarray(tscoring.DEFAULT_ALPHA, np.float32)
    a1 = np.asarray([2.0, 0.2, 0.4, 1.5], np.float32)
    scens = [TT.Scenario.make("ml", "first-fit", alpha=a) for a in (a0, a1)]
    finals, hists = teng.simulate_sweep(TSYS, ttable, scens, 0.0, T1,
                                        device="cpu")
    for i, s in enumerate(scens):
        f_solo, h_solo = teng.simulate(TSYS, ttable, s, 0.0, T1,
                                       device="cpu")
        assert_states_equal(h_solo, TT.row(hists, i), f"row {i} ")
        assert_states_equal(f_solo, TT.row(finals, i), f"row {i} ")
    jrun = jeng.simulate_sweep(SYS, jtable, [
        JT.Scenario.make("ml", "first-fit", alpha=a) for a in (a0, a1)],
        0.0, T1)
    assert_runs_match(jrun, (finals, hists))


# ---------------------------------------------------------------------------
# The device: the card unless the CPU is asked for, never a fallback.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("sharded", [True, False])
def test_train_without_device_runs_on_the_card_or_raises(sharded):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    ttable, _ = fitted_pair()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.train(TSYS, ttable, 0.0, 600.0, reward="wait=1",
                     generations=1, population=2, log=None, sharded=sharded)


def test_train_cli_without_device_raises_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(["train", "--smoke", "--quiet", "--generations", "1",
                   "--checkpoint", str(tmp_path / "ck.json")])
    assert not (tmp_path / "ck.json").exists()


def test_train_refuses_a_table_without_basis():
    js = tsyn.generate(TSYS, tsyn.WorkloadSpec(
        n_jobs=10, duration_s=600.0, load=1.0, trace_len=8, n_accounts=8,
        seed=1))
    with pytest.raises(ValueError, match="no ml_basis"):
        ttrain.train(TSYS, js.to_table(), 0.0, 600.0, log=None,
                     device="cpu")
