"""The failure and demand-response layer (``repro_torch.events``) against
the JAX package's (``repro.events``), on ``small_system`` (marconi100
scaled to 64 nodes) and ``small_table``, 120 steps of 20 s.

Against JAX: scenario sweeps with node, correlated CDU-group and
tower-cell failures (requeue and dismiss), and a demand-response sweep
under neutral grid signals and a weather trace, match the JAX engine:
the schedule exactly, telemetry and the final state at rtol 1e-4, the
reference's engine tolerance. The availability masks of
``realize_masks`` equal JAX's exactly.

The port against itself (the reference's own identities and oracles,
``tests/test_events.py`` and ``tests/test_events_properties.py``): zero
rates with DR off equal events off bit for bit (flat and 4-hall, with
and without grid signals); energy conservation; requeue/dismiss
accounting; the DR notice window; seeded determinism; a sweep row equal
to its solo run bit for bit; masks monotone in the rates and the repair
time, with no resurrection.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.cooling import weather as jwx
from repro.core import engine as jeng
from repro.core import stats as jstats
from repro.core import types as JT
from repro.events import EventConfig as JEventConfig
from repro.events import realize_masks as j_realize_masks
from repro.grid import signals as jgsig
from repro.systems.config import get_system
from repro_torch.cooling import weather as twx
from repro_torch.core import engine as teng
from repro_torch.core import resource_manager as trm
from repro_torch.core import stats as tstats
from repro_torch.core import types as TT
from repro_torch.events import EventConfig, process as tev
from repro_torch.grid import signals as tgsig
from repro_torch.launch import simulate as tcli

from test_torch_common import (as_np, assert_exact, assert_runs_match,
                               assert_threefry_partitionable, four_hall,
                               leaves, to_port)

torch.set_num_threads(1)

HORIZON = 120
RTOL = 1e-4
OUTAGE = dict(failure_seed=3.0, node_fail_rate=5e-5, cdu_fail_rate=2e-5,
              failure_corr=0.5, repair_s=900.0)
LANE = dict(failure_seed=5.0, node_fail_rate=8e-5, cdu_fail_rate=2e-5,
            failure_corr=0.5, repair_s=1200.0)
CELLS = dict(failure_seed=6.0, node_fail_rate=8e-5, cdu_fail_rate=3e-4,
             cell_fail_rate=2e-3, repair_s=900.0)
SWEEP = [("fcfs", "easy", OUTAGE), ("fcfs", "easy", LANE),
         ("sjf", "first-fit", CELLS), ("fcfs", "easy", {})]
MSYS = get_system("marconi100").scaled(32)   # the mask oracle's machine
STEPS = 48                                    # the mask oracle's horizon


@pytest.fixture(scope="module", autouse=True)
def partitionable():
    assert_threefry_partitionable()


def t1_of(system):
    return HORIZON * system.dt


def port_of(system, jtable):
    return to_port(system), TT.JobTable.from_arrays(leaves(jtable))


def scen_pair(specs):
    return ([JT.Scenario.make(p, b, **kw) for p, b, kw in specs],
            [TT.Scenario.make(p, b, **kw) for p, b, kw in specs])


def dr_knobs(system):
    """The reference test's event: announced at a quarter of the run,
    a quarter's notice, 40 % long, a cap far below any job's draw."""
    t1 = t1_of(system)
    floor = system.n_nodes * system.power.idle_node_w
    return dict(dr_announce_s=0.25 * t1, dr_notice_s=0.25 * t1,
                dr_duration_s=0.4 * t1, dr_cap_w=0.01 * floor)


@pytest.fixture(scope="module")
def outage(small_system, small_table):
    """The SWEEP scenarios with the event layer on, in both engines."""
    jscens, tscens = scen_pair(SWEEP)
    tsys, ttable = port_of(small_system, small_table)
    t1 = t1_of(small_system)
    want = jeng.simulate_sweep(small_system, small_table, jscens, 0.0, t1,
                               num_accounts=8, events=JEventConfig())
    got = teng.simulate_sweep(tsys, ttable, tscens, 0.0, t1, num_accounts=8,
                              events=EventConfig(), device="cpu")
    return dict(want=want, got=got, tsys=tsys, ttable=ttable)


@pytest.fixture(scope="module")
def dr_run(small_system, small_table):
    """A DR event alone and with failures, under neutral grid signals and
    a shared synthetic weather trace, in both engines."""
    specs = [("fcfs", "easy", dr_knobs(small_system)),
             ("sjf", "first-fit", dict(dr_knobs(small_system), **OUTAGE))]
    jscens, tscens = scen_pair(specs)
    tsys, ttable = port_of(small_system, small_table)
    t1 = t1_of(small_system)
    jw = jwx.synthetic_weather(HORIZON, small_system.dt, seed=2)
    tw = twx.synthetic_weather(HORIZON, small_system.dt, seed=2)
    want = jeng.simulate_sweep(small_system, small_table, jscens, 0.0, t1,
                               num_accounts=8,
                               signals=jgsig.neutral(HORIZON), weather=jw,
                               events=JEventConfig())
    got = teng.simulate_sweep(tsys, ttable, tscens, 0.0, t1, num_accounts=8,
                              signals=tgsig.neutral(HORIZON), weather=tw,
                              events=EventConfig(), device="cpu")
    return dict(want=want, got=got, specs=specs, tsys=tsys, ttable=ttable)


# ---------------------------------------------------------------------------
# Against the JAX engine.
# ---------------------------------------------------------------------------
def test_outage_sweep_matches_jax(small_system, small_table, outage):
    assert_runs_match(outage["want"], outage["got"], RTOL, "outage sweep")
    wf, _ = outage["want"]
    killed = np.asarray(wf.events.jobs_killed)
    assert (killed[:3] > 0).all() and killed[3] == 0, killed
    # some CDU group and some tower cell went down in the run
    gf, gh = outage["got"]
    assert (gf.events.group_down_until[2] > 0).any()
    assert (gf.events.cell_down_until[2] > 0).any()
    assert (gh.nodes_down[:3] > 0).any(1).all()


def test_outage_summaries_match_jax(small_system, small_table, outage):
    (wf, wh), (gf, gh) = outage["want"], outage["got"]
    for i in range(len(SWEEP)):
        row = lambda x, i=i: x[i]
        ws = jstats.summarize(small_system, small_table,
                              jax.tree_util.tree_map(row, wf),
                              jax.tree_util.tree_map(row, wh))
        gs = tstats.summarize(outage["tsys"], outage["ttable"],
                              TT.row(gf, i), TT.row(gh, i))
        assert ws.keys() == gs.keys() and "ride_jobs_killed" in gs
        for k in ws:
            np.testing.assert_allclose(gs[k], ws[k], rtol=RTOL, err_msg=k)


def test_dismissed_kills_match_jax(small_system, small_table):
    """``requeue=False``: the killed jobs are dismissed, in both engines."""
    tsys, ttable = port_of(small_system, small_table)
    t1 = t1_of(small_system)
    want = jeng.simulate(small_system, small_table,
                         JT.Scenario.make("fcfs", "easy", **OUTAGE), 0.0, t1,
                         num_accounts=8,
                         events=JEventConfig(requeue=False))
    got = teng.simulate(tsys, ttable, TT.Scenario.make("fcfs", "easy",
                                                       **OUTAGE), 0.0, t1,
                        num_accounts=8, events=EventConfig(requeue=False),
                        device="cpu")
    assert_runs_match(want, got, RTOL, "dismissed")
    final = got[0]
    assert float(final.events.jobs_killed) > 0
    assert float(final.events.jobs_requeued) == 0.0


def test_dr_and_weather_sweep_matches_jax(dr_run):
    assert_runs_match(dr_run["want"], dr_run["got"], RTOL, "DR sweep")
    _, gh = dr_run["got"]
    # the cap is in force during the event only (inf outside it)
    assert torch.isinf(gh.cap_w).any() and torch.isfinite(gh.cap_w).any()


@pytest.mark.parametrize("seed,rate,corr,repair", [
    (0, 5e-5, 0.5, 1500.0), (3, 2e-4, 0.5, 1500.0), (12345, 1e-3, 1.0, 600.0),
    (7, 3e-4, 0.0, 5000.0)])
def test_realize_masks_equal_jax_exactly(seed, rate, corr, repair):
    kw = dict(failure_seed=float(seed), node_fail_rate=rate,
              cdu_fail_rate=0.5 * rate, cell_fail_rate=rate,
              failure_corr=corr, repair_s=repair)
    want = j_realize_masks(MSYS, JT.Scenario.make("fcfs", "easy", **kw),
                           STEPS)
    got = tev.realize_masks(to_port(MSYS), TT.Scenario.make("fcfs", "easy",
                                                            **kw), STEPS,
                            device="cpu")
    assert want.keys() == got.keys()
    for k in want:
        w, g = np.asarray(want[k]), got[k]
        diff = np.nonzero((w != g).reshape(STEPS, -1).any(1))[0]
        assert diff.size == 0, f"{k}: first differing step {diff[0]}"
        assert_exact(w, g, k)
    assert got["nodes_down"].max() > 0


# ---------------------------------------------------------------------------
# The reference's identities, port against port.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("grid", [False, True])
@pytest.mark.parametrize("halls", [1, 4])
def test_zero_rates_equal_events_off(small_system, small_table, halls, grid):
    """Events on with every rate at zero and DR off: the run equals one
    without the event layer bit for bit (the reference's own bound is
    1e-5; the port holds equality)."""
    system = small_system if halls == 1 else four_hall(small_system)
    tsys, ttable = port_of(system, small_table)
    t1 = t1_of(system)
    signals = tgsig.neutral(HORIZON) if grid else None
    scens = [TT.Scenario.make("fcfs", "easy"),
             TT.Scenario.make("sjf", "first-fit", failure_seed=9.0)]
    kw = dict(num_accounts=8, signals=signals, device="cpu")
    f_off, h_off = teng.simulate_sweep(tsys, ttable, scens, 0.0, t1, **kw)
    f_on, h_on = teng.simulate_sweep(tsys, ttable, scens, 0.0, t1,
                                     events=EventConfig(), **kw)
    assert f_off.events is None and f_on.events is not None
    assert float(f_on.events.jobs_killed.sum()) == 0.0
    assert float(f_on.events.node_downtime_s.sum()) == 0.0
    for f in dataclasses.fields(h_on):
        assert torch.equal(getattr(h_on, f.name), getattr(h_off, f.name)), \
            f.name
    for f in dataclasses.fields(f_on):
        if f.name not in ("events", "accounts", "cooling"):
            assert torch.equal(getattr(f_on, f.name),
                               getattr(f_off, f.name)), f.name
    for sub in ("accounts", "cooling"):
        for k, v in vars(getattr(f_on, sub)).items():
            assert torch.equal(v, getattr(getattr(f_off, sub), k)), k


def test_energy_conservation_under_cdu_outages(small_system, outage):
    final, hist = (TT.row(x, 0) for x in outage["got"])
    dt = small_system.dt
    np.testing.assert_allclose(
        float(final.energy_total),
        float(as_np(hist.power_total).astype(np.float64).sum() * dt),
        rtol=1e-4)
    # killed jobs hand their accrued energy to the not-served ledger:
    # surviving job energy + lost energy stays within the IT integral
    energy_it = float(final.energy_it)
    jobs_j = float(final.jenergy.double().sum())
    lost_j = float(final.events.energy_lost_j)
    assert lost_j > 0.0
    assert jobs_j + lost_j <= energy_it * (1.0 + 1e-5)
    np.testing.assert_allclose(float(hist.n_killed.double().sum()),
                               float(final.events.jobs_killed), rtol=1e-6)
    np.testing.assert_allclose(float(hist.nodes_down.double().sum() * dt),
                               float(final.events.node_downtime_s),
                               rtol=1e-5)


def test_requeue_and_dismiss_accounting(small_system, small_table, outage):
    tsys, ttable = outage["tsys"], outage["ttable"]
    valid = as_np(ttable.valid)
    final = TT.row(outage["got"][0], 0)
    js = as_np(final.jstate)[valid]
    counts = {s: int((js == s).sum()) for s in
              (TT.PENDING, TT.QUEUED, TT.RUNNING, TT.DONE, TT.DISMISSED)}
    assert sum(counts.values()) == int(valid.sum())
    assert float(final.events.jobs_requeued) == \
        float(final.events.jobs_killed) > 0
    f2, _ = teng.simulate(tsys, ttable,
                          TT.Scenario.make("fcfs", "easy", **OUTAGE), 0.0,
                          t1_of(small_system), num_accounts=8,
                          events=EventConfig(requeue=False), device="cpu")
    assert float(f2.events.jobs_killed) > 0
    assert float(f2.events.jobs_requeued) == 0.0
    assert int((as_np(f2.jstate)[valid] == TT.DISMISSED).sum()) > \
        counts[TT.DISMISSED]


def test_dr_cap_step_honors_notice_window(small_system, dr_run):
    """No job admitted during the notice window runs into the event, no
    job starts while the cap is in force, and the IT power sheds."""
    knobs = dr_run["specs"][0][2]
    announce = knobs["dr_announce_s"]
    start_s = announce + knobs["dr_notice_s"]
    end_s = start_s + knobs["dr_duration_s"]
    ttable = dr_run["ttable"]
    valid = as_np(ttable.valid)
    limit = as_np(ttable.limit)[valid]
    finals, hists = dr_run["got"]
    for row in range(2):
        start = as_np(finals.start[row])[valid]
        started = np.isfinite(start)
        in_notice = started & (start >= announce) & (start < start_s)
        assert not np.any(in_notice & (start + limit > start_s)), row
        assert not np.any(started & (start >= start_s) & (start < end_s))
    start = as_np(finals.start[0])[valid]
    assert np.any(np.isfinite(start) & (start < announce))
    assert np.any(np.isfinite(start) & (start >= end_s))
    dt = small_system.dt
    p_it = as_np(hists.power_it[0]).astype(np.float64)
    pre = p_it[:int(announce / dt)]
    act = p_it[int(start_s / dt) + 1:int(end_s / dt)]
    assert act.mean() < pre.mean()
    cap = as_np(hists.cap_w[0])
    assert np.isinf(cap[:int(start_s / dt)]).all()
    assert (cap[int(start_s / dt) + 1:int(end_s / dt)] ==
            np.float32(knobs["dr_cap_w"])).all()


def test_seeded_determinism_and_sweep_lane_parity(small_system, outage):
    """A rerun replays the same universe, and every sweep row equals its
    solo run bit for bit."""
    tsys, ttable = outage["tsys"], outage["ttable"]
    finals, hists = outage["got"]
    for i in (0, 1):
        p, b, kw = SWEEP[i]
        solo_f, solo_h = teng.simulate(tsys, ttable,
                                       TT.Scenario.make(p, b, **kw), 0.0,
                                       t1_of(small_system), num_accounts=8,
                                       events=EventConfig(), device="cpu")
        for f in dataclasses.fields(solo_h):
            assert torch.equal(getattr(solo_h, f.name),
                               getattr(hists, f.name)[i]), f.name
        for name in ("jstate", "start", "end", "node_job", "jenergy",
                     "energy_total"):
            assert torch.equal(getattr(solo_f, name),
                               getattr(finals, name)[i]), name
        for k, v in vars(solo_f.events).items():
            assert torch.equal(v, getattr(finals.events, k)[i]), k
    again_f, again_h = teng.simulate_sweep(
        tsys, ttable, [TT.Scenario.make(p, b, **kw) for p, b, kw in SWEEP],
        0.0, t1_of(small_system), num_accounts=8, events=EventConfig(),
        device="cpu")
    for f in dataclasses.fields(again_h):
        assert torch.equal(getattr(again_h, f.name),
                           getattr(hists, f.name)), f.name


def _mask_scen(seed, rate, repair_s=1500.0, corr=0.5, cell_rate=0.0):
    return TT.Scenario.make("fcfs", "easy", failure_seed=float(seed),
                            node_fail_rate=rate, cdu_fail_rate=0.5 * rate,
                            cell_fail_rate=cell_rate, failure_corr=corr,
                            repair_s=repair_s)


@pytest.mark.parametrize("seed", [0, 3, 12345])
def test_masks_are_monotone_in_rates_and_repair(seed):
    system = to_port(MSYS)
    real = lambda sc: tev.realize_masks(system, sc, STEPS, device="cpu")
    for lo, hi in ((0.0, 5e-5), (5e-5, 2e-4), (2e-4, 1e-3)):
        a, b = real(_mask_scen(seed, lo)), real(_mask_scen(seed, hi))
        assert np.all(b["node_avail"] <= a["node_avail"])
        assert np.all(a["group_down"] <= b["group_down"])
        assert np.all(b["nodes_down"] >= a["nodes_down"])
    a = real(_mask_scen(seed, 2e-4, repair_s=600.0))
    b = real(_mask_scen(seed, 2e-4, repair_s=3000.0))
    assert np.all(b["node_avail"] <= a["node_avail"])
    assert b["nodes_down"].sum() >= a["nodes_down"].sum() > 0


@pytest.mark.parametrize("seed", [1, 8])
def test_no_resurrection_before_repair(seed):
    """``down_until`` never shrinks, and the availability mask is exactly
    ``t < node_down_until`` or the node's group down."""
    system = to_port(MSYS)
    scen = TT.stack_scenarios([_mask_scen(seed, 4e-4, cell_rate=4e-4)])
    ev = TT.tree_map(lambda x: x[None], tev.init_event_state(system))
    gid, _, _ = tev._maps(system)
    t = torch.zeros(1)
    step = torch.zeros(1, dtype=torch.int32)
    for _ in range(STEPS):
        (nu, gu, cu), (unavail, gdown, cdown) = tev._advance_masks(
            system, ev, scen, t, step)
        for old, new in ((ev.node_down_until, nu), (ev.group_down_until, gu),
                         (ev.cell_down_until, cu)):
            assert torch.all(new >= old)
        want = (t[:, None] < nu) | (t[:, None] < gu)[:, gid]
        assert torch.equal(unavail, want)
        assert torch.equal(cdown, t[:, None] < cu)
        ev = dataclasses.replace(ev, node_down_until=nu,
                                 group_down_until=gu, cell_down_until=cu)
        t, step = t + system.dt, step + 1
    assert torch.isfinite(ev.node_down_until).any()


# ---------------------------------------------------------------------------
# The layer's inputs and the node map.
# ---------------------------------------------------------------------------
def test_from_arrays_takes_the_failure_and_dr_knobs_and_events(small_system,
                                                               small_table):
    kw = dict(OUTAGE, cell_fail_rate=1e-4, **dr_knobs(small_system))
    got = TT.Scenario.from_arrays(leaves(JT.Scenario.make("sjf", "easy",
                                                          **kw)))
    want = TT.Scenario.make("sjf", "easy", **kw)
    for k, v in vars(want).items():
        assert torch.equal(getattr(got, k), v), k
    # the ML weights ride along with the event knobs, scalar or vector
    for alpha in (0.5, (0.5, 1.0, 1.5, 2.0)):
        got = TT.Scenario.from_arrays(leaves(JT.Scenario.make(
            "ml", "easy", alpha=alpha, **kw)))
        want = TT.Scenario.make("ml", "easy", alpha=alpha, **kw)
        for k, v in vars(want).items():
            assert torch.equal(getattr(got, k), v), (alpha, k)
    jst = jeng.init_state(small_system, small_table, 0.0, 3600.0,
                          num_accounts=8, events=JEventConfig())
    st = TT.SimState.from_arrays(leaves(jst))
    tsys, ttable = port_of(small_system, small_table)
    want_ev = tev.init_event_state(tsys)
    for k, v in vars(st.events).items():
        assert_exact(as_np(getattr(want_ev, k))[None], v, k)
    assert TT.SimState.from_arrays(leaves(jeng.init_state(
        small_system, small_table, 0.0, 3600.0))).events is None


def test_down_nodes_are_neither_placed_nor_released():
    node_job = torch.tensor([[0, -2, -1, 1, -2, -1, -1]], dtype=torch.int32)
    done = torch.tensor([[True, False]])
    released = trm.release_done(node_job, done)
    assert released.tolist() == [[-1, -2, -1, 1, -2, -1, -1]]
    sel = trm.firstfree_mask(released, torch.tensor([3]))
    assert sel.tolist() == [[True, False, True, False, False, True, False]]
    order = torch.arange(7)[None].flip(1)
    sel = trm.firstfree_mask_ordered(released, torch.tensor([2]), order)
    assert sel.tolist() == [[False, False, False, False, False, True, True]]


def test_cli_failures_and_dr_on_the_cpu(capsys):
    tcli.main(["--system", "marconi100", "--scale", "64", "--jobs", "40",
               "-t", "30m", "--device", "cpu", "--policy", "fcfs",
               "--backfill", "easy", "--failure-rate", "20",
               "--cdu-failure-rate", "5", "--failure-corr", "0.5",
               "--failure-seed", "3", "--repair", "15m",
               "--dr-announce", "5m", "--dr-notice", "5m",
               "--dr-duration", "10m", "--dr-cap-mw", "0.01"])
    out = capsys.readouterr().out
    assert "ride_jobs_killed" in out and "policy=fcfs backfill=easy" in out
