"""The grid path of the port against the JAX package: signals, DVFS cap
enforcement, the plant step on throttled group heat, grid accrual,
cap-aware admission and the grid policies, and the whole slice end to end.

Tolerances and why:

* signals, ``at_step``, ``throttle_power``, the grid policy keys and every
  schedule (``jstate``, ``start``, ``end``, ``node_job``): exact. They are
  the same IEEE operations on the same inputs, or integer decisions.
* ``enforce_cap``, ``accrue_grid`` and the plant step: rtol 1e-5, the
  reference's kernel tolerance. The port sums nodes, groups and accounts
  in another order (group totals and ledgers in float64, rounded once).
* the engine's telemetry and ledgers: rtol 1e-4, the reference's engine
  tolerance (tests/test_torch_engine.py). ``throttle_frac`` is ``1 - c``
  with ``c`` close to 1: it also gets atol 1e-6 (about 16 float32 ulps of
  ``c``), since a one-ulp difference in ``c`` is a large relative
  difference in ``1 - c``.

The engine parity fixture compiles the file's two JAX engine sweeps.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.cooling import model as jcool
from repro.core import accounts as jacct
from repro.core import engine as jeng
from repro.core import scheduler as jsched
from repro.core import stats as jstats
from repro.core import types as JT
from repro.datasets.base import JobSet
from repro.datasets.synthetic import WorkloadSpec, generate
from repro.grid import powercap as jcap
from repro.grid import signals as jsig
from repro.systems.config import get_system
from repro_torch.cooling import model as tcool
from repro_torch.core import accounts as tacct
from repro_torch.core import engine as teng
from repro_torch.core import scheduler as tsched
from repro_torch.core import stats as tstats
from repro_torch.core import types as TT
from repro_torch.grid import powercap as tcap
from repro_torch.grid import signals as tsig
from repro_torch.power import model as tpow

from test_torch_common import as_np, assert_exact, four_hall, leaves, \
    to_port
from test_torch_scheduler import _batch, _ledger, _tie_table

torch.set_num_threads(1)

BASE = get_system("marconi100").scaled(64)
# an aggressive DVFS floor, as benchmarks/fig_carbon.py sets it, so the
# throttle can reach every cap above the idle floor
SYSTEM = dataclasses.replace(BASE, grid=dataclasses.replace(BASE.grid,
                                                            c_min=0.05))
FLOOR_W = SYSTEM.n_nodes * SYSTEM.power.idle_node_w
PEAK_W = SYSTEM.n_nodes * SYSTEM.power.peak_node_w
T1 = 2 * 3600.0
RTOL = 1e-4


def _jsig_to_port(sig):
    return tsig.GridSignals.from_arrays(leaves(sig))


# ---------------------------------------------------------------------------
# Signals.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind,kw", [
    ("synthetic", dict(n_steps=500, dt=15.0)),
    ("synthetic", dict(n_steps=1440, dt=15.0, t0=14 * 3600.0, seed=11,
                       cap_base_w=2.7648e7, cap_peak_w=1.6896e7)),
    ("synthetic", dict(n_steps=97, dt=20.0, seed=3, cap_base_w=6e4)),
    ("constant", dict(n_steps=50, carbon_gkwh=420.0, price_kwh=0.3,
                      cap_w=5e4)),
    ("constant", dict(n_steps=0)),
    ("neutral", dict(n_steps=40)),
])
def test_signals_bitwise_equal(kind, kw):
    if kind == "synthetic":
        want = jsig.synthetic_signals(SYSTEM.grid, **kw)
        got = tsig.synthetic_signals(to_port(SYSTEM.grid), **kw)
    else:
        want = getattr(jsig, f"{kind}_signals" if kind == "constant"
                       else kind)(**kw)
        got = getattr(tsig, f"{kind}_signals" if kind == "constant"
                      else kind)(**kw)
    for f in dataclasses.fields(got):
        assert_exact(getattr(want, f.name), getattr(got, f.name), f.name)
    assert got.num_steps == want.num_steps


def test_at_step_clamps_and_from_arrays_round_trips():
    sig = jsig.synthetic_signals(SYSTEM.grid, 30, 20.0, seed=5, t0=61200.0,
                                 cap_base_w=7e4, cap_peak_w=4e4)
    moved = _jsig_to_port(sig).to("cpu")
    for f in dataclasses.fields(moved):
        assert_exact(getattr(sig, f.name), getattr(moved, f.name), f.name)
    steps = np.asarray([-4, 0, 7, 29, 30, 1000], np.int32)
    got = tsig.at_step(moved, torch.from_numpy(steps))
    for s, step in enumerate(steps):
        want = jsig.at_step(sig, jnp.int32(step))
        for name, w in want._asdict().items():
            assert_exact(w, getattr(got, name)[s], f"step {step} {name}")
    neutral = tsig.now_neutral(3)
    for name, w in jsig.now_neutral()._asdict().items():
        assert_exact(np.broadcast_to(np.asarray(w), (3,)),
                     getattr(neutral, name), name)


# ---------------------------------------------------------------------------
# Power cap, plant step, accrual.
# ---------------------------------------------------------------------------
def test_enforce_cap_matches_jax():
    """Five scenarios: uncapped, a cap below the idle floor (saturates at
    c_min), two binding caps and a generous one; some nodes draw below
    the idle floor."""
    rng = np.random.default_rng(0)
    N = SYSTEM.n_nodes
    node_pw = rng.uniform(100.0, 2200.0, (5, N)).astype(np.float32)
    floor = np.minimum(node_pw, SYSTEM.power.idle_node_w).sum(1)
    raw = node_pw.sum(1)
    cap = np.asarray([np.inf, 0.5 * floor[1],
                      floor[2] + 0.3 * (raw[2] - floor[2]),
                      floor[3] + 0.9 * (raw[3] - floor[3]), 2.0 * raw[4]],
                     np.float32)
    want = jax.vmap(lambda p, c: jcap.enforce_cap(SYSTEM, p, c))(
        jnp.asarray(node_pw), jnp.asarray(cap))
    got = tcap.enforce_cap(to_port(SYSTEM), torch.from_numpy(node_pw),
                           torch.from_numpy(cap))
    for name, w in want._asdict().items():
        g = getattr(got, name)
        assert g.dtype == torch.float32 and g.shape == w.shape, name
        np.testing.assert_allclose(as_np(g), np.asarray(w), rtol=1e-5,
                                   err_msg=name)
    c = as_np(got.c)
    assert c[0] == 1.0 and c[4] == 1.0 and c[1] == np.float32(0.05)
    assert 0.05 < c[2] < c[3] < 1.0
    assert np.isfinite(as_np(got.group_heat)).all()


def test_cap_holds_to_the_watt_at_frontier_scale():
    """Frontier's 9,600 nodes under 64 caps between the idle floor and the
    raw draw: the throttled total never exceeds a reachable cap (float32's
    ulp there is 1-2 W, so a cap factor rounded to nearest could overshoot
    the 1 W that the cap check allows)."""
    fr = dataclasses.replace(get_system("frontier"), grid=dataclasses.replace(
        get_system("frontier").grid, c_min=0.05))
    rng = np.random.default_rng(8)
    S = 64
    node_pw = rng.uniform(0.0, 3200.0, (S, fr.n_nodes)).astype(np.float32)
    floor = np.minimum(node_pw, fr.power.idle_node_w).sum(1, np.float64)
    raw = node_pw.sum(1, np.float64)
    cap = (floor + rng.uniform(0.06, 0.99, S) * (raw - floor)).astype(
        np.float32)
    got = tcap.enforce_cap(to_port(fr), torch.from_numpy(node_pw),
                           torch.from_numpy(cap))
    c = as_np(got.c)
    assert ((c > 0.05) & (c < 1.0)).all()
    assert (as_np(got.p_it) <= cap).all()
    np.testing.assert_allclose(as_np(got.p_it), cap, rtol=1e-6)


def test_throttle_power_exact():
    rng = np.random.default_rng(1)
    pw = rng.choice([0.0, 100.0, 240.0, 1000.0, 2150.5], (3, 17)).astype(
        np.float32)
    pw[1, :4] = [0.0, 100.0, 240.0, 1000.0]
    c = np.asarray([1.0, 0.5, 0.0731], np.float32)
    got = tcap.throttle_power(torch.from_numpy(pw), 240.0,
                              torch.from_numpy(c))
    for s in range(3):
        assert_exact(jcap.throttle_power(jnp.asarray(pw[s]), 240.0,
                                         jnp.float32(c[s])), got[s],
                     "throttle")
    # the idle floor is kept, the dynamic share scaled
    assert as_np(got)[1, :4].tolist() == [0.0, 100.0, 240.0, 620.0]


@pytest.mark.parametrize("halls", [1, 4])
def test_plant_step_on_group_heat_matches_jax(halls):
    """``cooling.step`` (the grid path's plant step) for 3 scenarios with
    their own setpoint offsets and maintenance, a few steps."""
    system = SYSTEM if halls == 1 else four_hall(SYSTEM)
    cfg, tcfg = system.cooling, to_port(system.cooling)
    S, G, H = 3, cfg.n_groups, cfg.n_halls
    deltas = np.asarray([0.0, -2.0, 1.5], np.float32)
    offline = np.zeros((S, H), np.float32)
    offline[1, 0] = 1.0
    rng = np.random.default_rng(halls)
    j_states = [jcool.init_state(cfg) for _ in range(S)]
    t_state = TT.tree_map(lambda x: _batch(x, S), tcool.init_state(tcfg))
    for step in range(5):
        heat = rng.uniform(1e4, 1.5e5, (S, G)).astype(np.float32)
        t_state, t_out = tcool.step(tcfg, t_state, torch.from_numpy(heat),
                                    system.dt, torch.from_numpy(deltas),
                                    torch.from_numpy(offline))
        for s in range(S):
            j_states[s], j_out = jcool.step(
                cfg, j_states[s], jnp.asarray(heat[s]), system.dt, None,
                deltas[s], jnp.asarray(offline[s]))
            for name, w in j_out._asdict().items():
                np.testing.assert_allclose(
                    as_np(getattr(t_out, name)[s]), np.asarray(w), rtol=1e-5,
                    err_msg=f"step {step} out {name}")
            for name, w in vars(j_states[s]).items():
                np.testing.assert_allclose(
                    as_np(getattr(t_state, name)[s]), np.asarray(w),
                    rtol=1e-5, err_msg=f"step {step} state {name}")


def test_accrue_grid_matches_and_is_batch_invariant():
    rng = np.random.default_rng(2)
    jt, tt, _ = _tie_table(seed=4)
    S, A = 3, 8
    ledger = _ledger(rng, A)
    e_step = np.where(rng.random((S, tt.num_jobs)) < 0.6,
                      rng.uniform(1e4, 5e7, (S, tt.num_jobs)),
                      0.0).astype(np.float32)
    carbon = np.asarray([50.0, 380.5, 910.0], np.float32)
    price = np.asarray([0.02, 0.125, 0.4], np.float32)
    tacc = TT.tree_map(lambda x: _batch(x, S), TT.AccountStats(
        **{k: torch.tensor(v) for k, v in leaves(ledger).items()}))
    args = [torch.from_numpy(a) for a in (e_step, carbon, price)]
    got = tacct.accrue_grid(tt, tacc, *args)
    for s in range(S):
        want = jax.jit(lambda *a: jacct.accrue_grid(jt, *a))(
            ledger, jnp.asarray(e_step[s]), jnp.float32(carbon[s]),
            jnp.float32(price[s]))
        for name, w in vars(want).items():
            np.testing.assert_allclose(as_np(getattr(got, name)[s]),
                                       np.asarray(w), rtol=1e-5,
                                       err_msg=name)
        one = tacct.accrue_grid(tt, TT.tree_map(lambda x: x[s:s + 1], tacc),
                                *(a[s:s + 1] for a in args))
        for name in ("carbon_kg", "cost"):
            assert torch.equal(getattr(one, name)[0], getattr(got, name)[s])


def test_system_it_power_is_batch_invariant():
    """The projected IT power is summed exactly: a scenario's value does
    not depend on the batch it is computed in."""
    rng = np.random.default_rng(3)
    node_pw = torch.from_numpy(
        rng.uniform(60.0, 3200.0, (5, 9600)).astype(np.float32))
    batch = tpow.system_it_power(node_pw)
    for s in range(5):
        assert torch.equal(tpow.system_it_power(node_pw[s:s + 1])[0],
                           batch[s])
    exact = node_pw.double().sum(-1).float()
    assert torch.equal(batch, exact)


# ---------------------------------------------------------------------------
# Scheduler.
# ---------------------------------------------------------------------------
def test_grid_policy_keys_exact():
    jt, tt, _ = _tie_table(seed=6)
    ledger = _ledger(np.random.default_rng(7))
    nows = [(600.0, 350.0, 0.21, 0.08, 5e4), (120.0, 300.0, 0.3, 0.09, 1e5),
            (350.0, 350.0, 0.05, 0.2, np.inf)]
    policies = ["carbon_aware", "price_aware", "fcfs"]
    weights = [(2.0, 0.5), (8.0, 4.0), (0.0, 1.0)]
    cases = [(p, w, n) for p in policies for w in weights for n in nows]
    S = len(cases)
    tscen = TT.stack_scenarios([TT.Scenario.make(p, carbon_weight=cw,
                                                 price_weight=pw)
                                for p, (cw, pw), _ in cases])
    grid = tsig.GridNow(*(torch.tensor([n[i] for _, _, n in cases],
                                       dtype=torch.float32)
                          for i in range(5)))
    taccts = TT.tree_map(lambda x: _batch(x, S), TT.AccountStats(
        **{k: torch.tensor(v) for k, v in leaves(ledger).items()}))
    got = tsched.policy_key(tt, taccts, tscen, grid=grid)
    for i, (p, (cw, pw), n) in enumerate(cases):
        jgrid = jsig.GridNow(*(jnp.float32(v) for v in n))
        want = jsched.policy_key(jt, ledger, JT.Scenario.make(
            p, carbon_weight=cw, price_weight=pw), jgrid)
        assert_exact(want, got[i], f"{p} {cw} {pw} {n}")
    # the carbon signal above its mean defers node-heavy jobs
    assert not torch.equal(got[0], got[2 * len(nows) * len(weights)])


def _cap_table(prof, nodes, wall, limit=None):
    J = len(nodes)
    submit = np.zeros(J)
    js = JobSet(submit=submit, limit=np.asarray(wall if limit is None
                                                else limit, float),
                wall=np.asarray(wall, float),
                nodes=np.asarray(nodes, np.int64), priority=np.zeros(J),
                account=np.zeros(J, np.int64), rec_start=submit,
                power_prof=np.asarray(prof, np.float32),
                util_prof=np.full((J, 1), 0.9, np.float32))
    return js.to_table(J + 2)


# the cases of tests/test_grid.py: one job wanting half the machine whose
# added draw breaches the cap (:179); an EASY head blocked by the cap alone
# with light jobs behind it, under the low cap and after it rises (:204)
IDLE = SYSTEM.power.idle_node_w
HEAD_ADD = 32 * (2000.0 - IDLE)
CAP_CASES = {
    "breach": dict(table=([[2000.0]], [32], [1800.0], [3600.0]),
                   scens=[("fcfs", "first-fit", FLOOR_W + 0.5 * HEAD_ADD),
                          ("fcfs", "easy", FLOOR_W + 0.5 * HEAD_ADD),
                          ("fcfs", "none", FLOOR_W + 2.0 * HEAD_ADD)]),
    "easy_head": dict(table=([[2000.0]] + [[500.0]] * 5, [32] + [4] * 5,
                             [1800.0] + [600.0] * 5, None),
                      scens=[("fcfs", "easy", FLOOR_W + 0.5 * HEAD_ADD),
                             ("fcfs", "first-fit", FLOOR_W + 0.5 * HEAD_ADD),
                             ("fcfs", "none", FLOOR_W + 0.5 * HEAD_ADD),
                             ("fcfs", "easy", FLOOR_W + 2.0 * HEAD_ADD)]),
}


@pytest.mark.parametrize("case", list(CAP_CASES))
def test_cap_aware_schedule_step_exact(case):
    spec = CAP_CASES[case]
    jt = _cap_table(*spec["table"])
    jst = jeng.init_state(SYSTEM, jt, 0.0, T1, num_accounts=8)
    jth = jcool.thermal_now(SYSTEM.cooling, jst.cooling, 0.0)
    caps = np.asarray([c for _, _, c in spec["scens"]], np.float32)
    # the scenarios' caps through cap_scale against one base cap, as a
    # sweep sets them
    scales = (caps / caps[0]).astype(np.float32)
    base = jsig.GridNow(jnp.float32(300.0), jnp.float32(300.0),
                        jnp.float32(0.1), jnp.float32(0.1),
                        jnp.float32(caps[0]))
    proj = np.float32(FLOOR_W)        # every node idle at t = 0
    scens = [JT.Scenario.make(p, b, cap_scale=s)
             for (p, b, _), s in zip(spec["scens"], scales)]
    run = jax.jit(jax.vmap(lambda sc: jsched.schedule_step(
        SYSTEM, jt, jst, sc, base, proj_pw=jnp.float32(proj), thermal=jth)))
    want = run(JT.stack_scenarios(scens))

    S = len(scens)
    tsys, tt = to_port(SYSTEM), TT.JobTable.from_arrays(leaves(jt))
    tst = TT.tree_map(lambda x: x.expand(S, *x.shape[1:]).clone(),
                      TT.SimState.from_arrays(leaves(jst)))
    tscen = TT.stack_scenarios([TT.Scenario.make(p, b, cap_scale=s)
                                for (p, b, _), s in zip(spec["scens"],
                                                        scales)])
    grid = tsig.GridNow(*(torch.full((S,), float(v), dtype=torch.float32)
                          for v in base))
    tth = tcool.thermal_now(tsys.cooling, tst.cooling, tscen.setpoint_delta_c)
    got = tsched.schedule_step(tsys, tt, tst, tscen, thermal=tth,
                               grid=grid,
                               proj_pw=torch.full((S,), float(proj)))
    for name in ("jstate", "start", "end", "node_job", "free_count"):
        assert_exact(getattr(want, name), getattr(got, name), name)
    running = as_np(got.jstate) == TT.RUNNING
    if case == "breach":
        # the breaching job stays queued with free nodes; a cap with room
        # admits it
        assert running[:, 0].tolist() == [False, False, True]
    else:
        # EASY and no-backfill halt behind the cap-blocked head; first-fit
        # stays greedy; the raised cap admits the head first
        assert not running[0].any() and not running[2].any()
        assert not running[1, 0] and running[1, 1:6].all()
        assert running[3, 0]


# ---------------------------------------------------------------------------
# The slice end to end.
# ---------------------------------------------------------------------------
SCENS = [("fcfs", "easy", dict(cap_scale=0.7)),
         ("carbon_aware", "first-fit", dict(carbon_weight=4.0,
                                            cap_scale=0.85)),
         ("price_aware", "none", dict(price_weight=4.0))]


def _small_table(system):
    js = generate(system, WorkloadSpec(
        n_jobs=80, duration_s=4 * 3600.0, load=1.0, trace_len=8,
        n_accounts=8, mean_wall_s=1800.0, seed=7))
    js.assign_prepop_placement(0.0, system.n_nodes)
    return js.to_table(96)


def _signals(system, t1):
    """The signal clock at 16:00, so the evening cap dip covers the second
    hour; a base cap of 0.6 and a dip to 0.4 of peak IT power."""
    return jsig.synthetic_signals(
        system.grid, int(t1 / system.dt), system.dt, t0=16 * 3600.0, seed=3,
        cap_base_w=0.6 * PEAK_W, cap_peak_w=0.4 * PEAK_W)


@pytest.fixture(scope="module", params=["flat", "4halls"])
def sweeps(request):
    system = SYSTEM if request.param == "flat" else four_hall(SYSTEM)
    jtable = _small_table(system)
    sig = _signals(system, T1)
    want = jeng.simulate_sweep(
        system, jtable, [JT.Scenario.make(p, b, **kw) for p, b, kw in SCENS],
        0.0, T1, num_accounts=8, signals=sig)
    tsys, ttable = to_port(system), TT.JobTable.from_arrays(leaves(jtable))
    tsg = _jsig_to_port(sig)
    got = teng.simulate_sweep(
        tsys, ttable, [TT.Scenario.make(p, b, **kw) for p, b, kw in SCENS],
        0.0, T1, num_accounts=8, signals=tsg, device="cpu")
    return dict(system=system, jtable=jtable, tsys=tsys, ttable=ttable,
                signals=tsg, want=want, got=got)


def test_grid_schedules_match_exactly(sweeps):
    (wf, wh), (gf, _) = sweeps["want"], sweeps["got"]
    for name in ("jstate", "start", "end", "node_job", "free_count",
                 "step"):
        assert_exact(getattr(wf, name), getattr(gf, name), name)
    # the caps bound: scenario 0 throttled and dilated runtimes, and the
    # runs did real scheduling work
    assert np.asarray(wh.throttle_frac)[0].max() > 0.1
    js = np.asarray(wf.jstate)
    assert (js == JT.DONE).sum(1).min() > 0 and (js == JT.QUEUED).any()


def test_grid_telemetry_and_ledgers_match(sweeps):
    (wf, wh), (gf, gh) = sweeps["want"], sweeps["got"]
    for f in dataclasses.fields(gh):
        w, g = np.asarray(getattr(wh, f.name)), as_np(getattr(gh, f.name))
        assert w.shape == g.shape and w.dtype == g.dtype, f.name
        atol = 1e-6 if f.name == "throttle_frac" else 0.0
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=atol,
                                   err_msg=f.name)
    for name, w in leaves(wf).items():
        if isinstance(w, dict):
            for k, x in w.items():
                np.testing.assert_allclose(
                    as_np(getattr(getattr(gf, name), k)), x, rtol=RTOL,
                    err_msg=f"{name}.{k}")
        elif w is not None and np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(as_np(getattr(gf, name)), w,
                                       rtol=RTOL, err_msg=name)
    assert (as_np(gf.accounts.carbon_kg).sum(1) > 0).all()
    for i in range(len(SCENS)):
        ws = jstats.summarize(sweeps["system"], sweeps["jtable"],
                              jax.tree_util.tree_map(lambda x: x[i], wf),
                              jax.tree_util.tree_map(lambda x: x[i], wh))
        gs = tstats.summarize(sweeps["tsys"], sweeps["ttable"],
                              TT.row(gf, i), TT.row(gh, i))
        assert ws.keys() == gs.keys()
        for k in ws:
            atol = 1e-6 if k == "avg_throttle_frac" else 0.0
            np.testing.assert_allclose(gs[k], ws[k], rtol=RTOL, atol=atol,
                                       err_msg=k)
        assert gs["emissions_kg"] > 0 and gs["energy_cost_usd"] > 0


def test_grid_sweep_row_is_bit_identical_to_a_solo_run(sweeps):
    p, b, kw = SCENS[1]
    solo_f, solo_h = teng.simulate(
        sweeps["tsys"], sweeps["ttable"], TT.Scenario.make(p, b, **kw), 0.0,
        T1, num_accounts=8, signals=sweeps["signals"], device="cpu")
    final, hist = sweeps["got"]
    for f in dataclasses.fields(hist):
        assert torch.equal(getattr(solo_h, f.name),
                           getattr(hist, f.name)[1]), f.name
    for name in ("jstate", "start", "end", "node_job", "energy_total",
                 "jenergy", "emissions_kg", "energy_cost"):
        assert torch.equal(getattr(solo_f, name), getattr(final, name)[1])
    assert torch.equal(solo_f.accounts.carbon_kg, final.accounts.carbon_kg[1])


def test_neutral_signals_are_inert():
    """Port against port, as tests/test_grid.py holds the reference: a run
    under neutral signals schedules exactly as the no-grid path, with
    zero emissions, cost and throttle."""
    tsys = to_port(SYSTEM)
    ttable = TT.JobTable.from_arrays(leaves(_small_table(SYSTEM)))
    t1 = 3600.0
    scens = [TT.Scenario.make("sjf", "easy"),
             TT.Scenario.make("carbon_aware", "first-fit", carbon_weight=8.0)]
    f0, h0 = teng.simulate_sweep(tsys, ttable, scens, 0.0, t1,
                                 num_accounts=8, device="cpu")
    f1, h1 = teng.simulate_sweep(tsys, ttable, scens, 0.0, t1,
                                 num_accounts=8, device="cpu",
                                 signals=tsig.neutral(int(t1 / tsys.dt)))
    for name in ("jstate", "start", "end", "node_job"):
        assert torch.equal(getattr(f0, name), getattr(f1, name)), name
    torch.testing.assert_close(h1.power_it, h0.power_it, rtol=1e-6, atol=0.0)
    assert float(f1.emissions_kg.abs().max()) == 0.0
    assert float(h1.throttle_frac.max()) == 0.0
    assert torch.isinf(h1.cap_w).all()


def test_easy_head_capped_is_not_starved_in_a_run():
    """The port's engine under the cap schedule of tests/test_grid.py:204:
    the cap-blocked EASY head starts when the cap rises and no light job
    jumps it; first-fit starts the lights at once; the cap holds."""
    tsys = to_port(SYSTEM)
    t1 = 2 * 3600.0
    n = int(t1 / tsys.dt)
    ttable = TT.JobTable.from_arrays(leaves(_cap_table(
        *CAP_CASES["easy_head"]["table"])))
    cap = np.where(np.arange(n) * tsys.dt < 3600.0,
                   FLOOR_W + 0.5 * HEAD_ADD,
                   FLOOR_W + 2.0 * HEAD_ADD).astype(np.float32)
    sig = dataclasses.replace(tsig.constant_signals(n),
                              cap_w=torch.from_numpy(cap))
    final, hist = teng.simulate_sweep(
        tsys, ttable, [TT.Scenario.make("fcfs", "easy"),
                       TT.Scenario.make("fcfs", "first-fit")], 0.0, t1,
        num_accounts=8, signals=sig, device="cpu")
    start = as_np(final.start)
    assert abs(start[0, 0] - 3600.0) <= 2 * tsys.dt
    assert (start[0, 1:6] >= start[0, 0] - 1e-3).all()
    assert start[1, 1:6].min() < 3600.0
    assert (as_np(hist.power_it) <= as_np(hist.cap_w) + 1.0).all()


# ---------------------------------------------------------------------------
# A cap threshold straddled to the float32 ulp.
# ---------------------------------------------------------------------------
# two jobs with draws that are not whole watts; the first, on 32 nodes,
# adds EST0 (W) to the idle floor when it starts
STRADDLE = ([[2000.37], [900.13]], [32, 8], [1800.0, 1200.0])
EST0 = np.float32(np.float32(2000.37) - np.float32(IDLE)) * np.float32(32)
STRADDLE_CAP = np.float32(np.float32(FLOOR_W) + EST0)   # proj + est_add
# cap_scale on the cap: exactly on it, one ulp under, one ulp over
STRADDLE_SCALES = (np.float32(1.0),
                   np.nextafter(np.float32(1.0), np.float32(0.0)),
                   np.nextafter(np.float32(1.0), np.float32(2.0)))


def test_cap_threshold_straddle_matches_jax():
    """The grid engine of both packages on a cap that the first job's
    projected power meets exactly (admitted: the test is ``<=``), misses
    by one float32 ulp (refused: the second job starts instead, and the
    first never does) and clears by one ulp. At t = 0 every node idles,
    so both project the same whole-watt floor and form ``proj + est_add``
    with the same float32 operations; after the start the cap binds to
    within an ulp of the running draw, where the port's float64 group
    totals and rounded-down cap factor depart from the reference's
    float32 ones (ROADMAP queue 3). Schedules must match exactly, floats
    at the engine tolerances."""
    table = _cap_table(*STRADDLE)
    t1 = 3600.0
    n = int(t1 / SYSTEM.dt)
    sig = jsig.constant_signals(n, carbon_gkwh=400.0, price_kwh=0.1,
                                cap_w=float(STRADDLE_CAP))
    caps = [np.float32(STRADDLE_CAP * s) for s in STRADDLE_SCALES]
    assert caps[0] == STRADDLE_CAP
    assert caps[1] == np.nextafter(STRADDLE_CAP, np.float32(0.0))
    assert caps[2] > STRADDLE_CAP
    kw = [dict(cap_scale=float(s)) for s in STRADDLE_SCALES]
    wf, wh = jeng.simulate_sweep(
        SYSTEM, table, [JT.Scenario.make("fcfs", "first-fit", **k)
                        for k in kw], 0.0, t1, num_accounts=8, signals=sig)
    gf, gh = teng.simulate_sweep(
        to_port(SYSTEM), TT.JobTable.from_arrays(leaves(table)),
        [TT.Scenario.make("fcfs", "first-fit", **k) for k in kw], 0.0, t1,
        num_accounts=8, signals=_jsig_to_port(sig), device="cpu")
    for name in ("jstate", "start", "end", "node_job", "free_count"):
        assert_exact(getattr(wf, name), getattr(gf, name), name)
    for f in dataclasses.fields(gh):
        atol = 1e-6 if f.name == "throttle_frac" else 0.0
        np.testing.assert_allclose(as_np(getattr(gh, f.name)),
                                   np.asarray(getattr(wh, f.name)),
                                   rtol=RTOL, atol=atol, err_msg=f.name)
    start = as_np(gf.start)
    assert start[0, 0] == 0.0 and start[2, 0] == 0.0
    assert start[1, 1] == 0.0 and not np.isfinite(start[1, 0])
    # on the cap the running draw is throttled by an ulp or two of c
    assert 0.0 < as_np(gh.throttle_frac)[0].max() < 1e-6
    assert (as_np(gh.power_it) <= as_np(gh.cap_w) + 1.0).all()
