"""Segment resume in the port (``simulate_segment``,
``simulate_segment_sweep``, ``simulate(carry=)``) against itself and
against the JAX package.

The port against itself, bit for bit (the reference's own contract,
``tests/test_serve_checkpoint.py``): a trajectory advanced in 8-step
segments, its carry encoded and decoded between every pair of segments,
equals one uninterrupted ``simulate``, on a flat and a 4-hall plant
under time-varying grid signals and weather, and with the event layer
on at nonzero rates (kills and requeues across segment boundaries, a
demand-response window straddling one). Row i of a segment sweep equals
branch i advanced alone, with the branches at different absolute steps
and under different backfill rules.

Against JAX: the port's segment chain against JAX ``simulate_segment``
chains, the schedule exactly and floats at rtol 1e-4 (``assert_runs_match``).

The workloads are the reference's serve-test cases (``conftest.make_case``
on marconi100 scaled to 64 nodes), rebuilt from the port's dataset copy.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import concat_hists, make_signals
from repro.cooling import weather as jwx
from repro.core import engine as jeng
from repro.core import types as JT
from repro.events import EventConfig as JEventConfig
from repro.launch.simulate import build_system as jbuild
from repro_torch.cooling import weather as twx
from repro_torch.core import engine as teng
from repro_torch.core import types as TT
from repro_torch.events import EventConfig
from repro_torch.serve import snapshot as snap

from test_torch_common import (assert_exact, assert_runs_match,
                               assert_states_equal,
                               assert_threefry_partitionable, cat_hists,
                               leaves, port_signals, to_port, workload_pair)

torch.set_num_threads(1)

INTERVAL = 8
N_INTERVALS = 6
HORIZON = INTERVAL * N_INTERVALS
RTOL = 1e-4
# failures that kill jobs within the 48-step horizon at 64 nodes, in
# five of its six segments
FAILURES = dict(node_fail_rate=1e-3, cdu_fail_rate=2e-4, failure_corr=0.5,
                failure_seed=7.0, repair_s=300.0)


def dr_knobs(system, start_step):
    """A DR event in force from ``start_step`` for 10 steps, announced two
    steps before, at a cap below the running draw."""
    return dict(dr_announce_s=(start_step - 2) * system.dt,
                dr_notice_s=2 * system.dt, dr_duration_s=10 * system.dt,
                dr_cap_w=1.2 * system.n_nodes * system.power.idle_node_w)


CASES = {
    # (system, knobs, events on) as in tests/test_serve_checkpoint.py,
    # plus the event layer with a DR window over the 3rd segment boundary
    "flat": (dict(), ("fcfs", "easy", dict(setpoint_delta_c=1.0)), False),
    "halls": (dict(halls=4), ("thermal_aware", "firstfit",
                              dict(cells_offline=(1.0, 0.0, 0.0, 0.0))),
              False),
    "events": (dict(), ("sjf", "easy", FAILURES), True),
}


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    sys_kw, (p, b, kw), with_events = CASES[request.param]
    jsystem = jbuild("marconi100", scale=64, **sys_kw)
    system = to_port(jsystem)
    if with_events:
        assert_threefry_partitionable()
        kw = dict(kw, **dr_knobs(system, 3 * INTERVAL - 3))
    table, jtable = workload_pair(jsystem, 80, n_jobs=64, load=1.2, seed=3)
    signals = port_signals(system, HORIZON)
    jsignals = make_signals(jsystem, HORIZON)
    for name, w in leaves(jsignals).items():
        assert_exact(w, getattr(signals, name), f"signals {name}")
    weather = twx.synthetic_weather(HORIZON, system.dt, seed=5)
    jweather = jwx.synthetic_weather(HORIZON, system.dt, seed=5)
    return dict(
        name=request.param, system=system, table=table, jsystem=jsystem,
        jtable=jtable, scen=TT.Scenario.make(p, b, **kw),
        jscen=JT.Scenario.make(p, b, **kw), signals=signals,
        jsignals=jsignals, weather=weather, jweather=jweather,
        events=EventConfig() if with_events else None,
        jevents=JEventConfig() if with_events else None)


def port_chain(c, codec=True):
    """The port's trajectory in INTERVAL-step segments from init_state,
    the carry through the snapshot codec before each segment (base64
    JSON and the binary dialect in turn)."""
    system = c["system"]
    carry = teng.init_state(system, c["table"], 0.0, HORIZON * system.dt,
                            num_accounts=8, events=c["events"])
    hists = []
    for k in range(N_INTERVALS):
        if codec:
            binary = k % 2 == 1
            payload = snap.encode_carry(carry, binary=binary)
            if not binary:
                payload = json.loads(json.dumps(payload))
            carry = snap.decode_carry(payload, carry)
        carry, hist = teng.simulate_segment(
            system, c["table"], carry, c["scen"], INTERVAL, c["signals"],
            c["weather"], c["events"], device="cpu")
        hists.append(hist)
    return carry, cat_hists(hists)


def test_resume_equals_one_scan(case):
    """Segments with the codec between them are bit for bit one scan."""
    system = case["system"]
    want = teng.simulate(system, case["table"], case["scen"], 0.0,
                         HORIZON * system.dt, num_accounts=8,
                         signals=case["signals"], weather=case["weather"],
                         events=case["events"], device="cpu")
    got = port_chain(case)
    assert_states_equal(want[1], got[1], "telemetry ")
    assert_states_equal(want[0], got[0], "final carry ")
    hist = got[1]
    assert float(hist.n_running.max()) > 0
    if case["events"] is not None:
        ev = got[0].events
        # kills and requeues happened, some of them after a boundary,
        # and the DR cap was in force across the third one
        assert float(ev.jobs_killed) > 0
        assert float(ev.jobs_requeued) == float(ev.jobs_killed)
        assert float(hist.n_killed[INTERVAL:].sum()) > 0
        dr = case["scen"].dr_cap_w
        held = hist.cap_w == dr
        assert bool(held[3 * INTERVAL - 1]) and bool(held[3 * INTERVAL])


def test_segments_match_jax(case):
    """The port's segment chain against JAX's, at the engine tolerance."""
    jsys, jtable = case["jsystem"], case["jtable"]
    carry = jeng.init_state(jsys, jtable, 0.0, HORIZON * jsys.dt,
                            num_accounts=8, events=case["jevents"])
    hists = []
    for _ in range(N_INTERVALS):
        carry, hist = jeng.simulate_segment(
            jsys, jtable, carry, case["jscen"], INTERVAL, case["jsignals"],
            case["jweather"], case["jevents"])
        hists.append(hist)
    want = (jax.tree_util.tree_map(np.asarray, carry), concat_hists(hists))
    assert_runs_match(want, port_chain(case, codec=False), RTOL,
                      f"{case['name']} segments")


@pytest.mark.parametrize("with_signals", [True, False],
                         ids=["group_power", "fused_cooling"])
def test_segment_sweep_rows_equal_solo_runs(case, with_signals):
    """Branches at steps 8, 24 and 0, under first-fit, EASY and no
    backfill (a DR event in force around step 24 on the second), batched
    into one segment sweep: each row is its branch advanced alone."""
    system, table = case["system"], case["table"]
    signals = case["signals"] if with_signals else None
    kw = dict(signals=signals, weather=case["weather"],
              events=case["events"], device="cpu")
    fail = FAILURES if case["events"] is not None else {}
    dr = (dr_knobs(system, 2 * INTERVAL + 6)
          if case["events"] is not None and with_signals else {})
    scens = [TT.Scenario.make("fcfs", "first-fit", **fail),
             TT.Scenario.make("sjf", "easy", **fail, **dr),
             TT.Scenario.make("acct_edp", "none", setpoint_delta_c=2.0)]
    if case["name"] == "halls":
        scens[2] = TT.Scenario.make("thermal_aware", "none",
                                    cells_offline=(0.0, 1.0, 0.0, 0.0))
    init = teng.init_state(system, table, 0.0, HORIZON * system.dt,
                           num_accounts=8, events=case["events"])
    carries = [teng.simulate_segment(system, table, init, s, n, **kw)[0]
               for s, n in zip(scens[:2], (INTERVAL, 3 * INTERVAL))]
    carries.append(init)
    finals, hists = teng.simulate_segment_sweep(system, table, carries,
                                                scens, INTERVAL, **kw)
    for i, (carry, scen) in enumerate(zip(carries, scens)):
        solo = teng.simulate_segment(system, table, carry, scen, INTERVAL,
                                     **kw)
        assert_states_equal(solo[1], TT.row(hists, i), f"row {i} ")
        assert_states_equal(solo[0], TT.row(finals, i), f"row {i} carry ")
    assert finals.step.tolist() == [2 * INTERVAL, 4 * INTERVAL, INTERVAL]


def test_simulate_carry_equals_the_segment_path(case):
    """``simulate(carry=)`` and ``simulate_static(carry=)`` run
    ``round((t1 - t0) / dt)`` steps from the carry's clock: the segment
    path, and the tail of one scan."""
    system, table = case["system"], case["table"]
    dt, mid, end = system.dt, 2 * INTERVAL, HORIZON
    kw = dict(num_accounts=8, signals=case["signals"],
              weather=case["weather"], events=case["events"], device="cpu")
    full = teng.simulate(system, table, case["scen"], 0.0, end * dt, **kw)
    # the head's carry comes from the whole window's init_state: a
    # window's initial state dismisses the jobs submitted after it
    init = teng.init_state(system, table, 0.0, end * dt, num_accounts=8,
                           events=case["events"])
    head, _ = teng.simulate_segment(system, table, init, case["scen"], mid,
                                    case["signals"], case["weather"],
                                    case["events"], device="cpu")
    tail = teng.simulate(system, table, case["scen"], mid * dt, end * dt,
                         carry=head, **kw)
    assert_states_equal(full[0], tail[0], "final carry ")
    assert_states_equal(TT.tree_map(lambda x: x[mid:], full[1]), tail[1],
                        "tail ")
    seg = teng.simulate_segment(system, table, head, case["scen"],
                                end - mid, case["signals"], case["weather"],
                                case["events"], device="cpu")
    assert_states_equal(seg[0], tail[0], "segment carry ")
    static = teng.simulate_static(system, table, "sjf", "none", mid * dt,
                                  end * dt, carry=head, **kw)
    seg = teng.simulate_segment(system, table, head,
                                TT.Scenario.make("sjf", "none"), end - mid,
                                case["signals"], case["weather"],
                                case["events"], device="cpu")
    assert_states_equal(seg[1], static[1], "static ")
    assert_states_equal(seg[0], static[0], "static carry ")


@pytest.fixture(scope="module")
def small():
    jsystem = jbuild("marconi100", scale=64)
    table, _ = workload_pair(jsystem, 24, n_jobs=16, seed=3)
    system = to_port(jsystem)
    init = teng.init_state(system, table, 0.0, 64 * system.dt,
                           num_accounts=8)
    with_ev = teng.init_state(system, table, 0.0, 64 * system.dt,
                              num_accounts=8, events=EventConfig())
    return system, table, init, with_ev


ERRORS = {
    "events given, carry without": (lambda i, e: ([i], EventConfig()),
                                    "event state"),
    "carry with events, none given": (lambda i, e: ([e], None),
                                      "event state"),
    "mixed event states": (lambda i, e: ([i, e], EventConfig()),
                           "some carries"),
    "carries on two devices": (
        lambda i, e: ([i, TT.tree_map(lambda x: x.to("meta"), i)], None),
        "different devices"),
    "batched carry": (lambda i, e: ([TT.stack([i, i])], None), "unbatched"),
}


@pytest.mark.parametrize("name", list(ERRORS))
def test_segment_sweep_rejects(small, name):
    system, table, init, with_ev = small
    make, match = ERRORS[name]
    carries, events = make(init, with_ev)
    scens = [TT.Scenario.make("fcfs")] * len(carries)
    with pytest.raises(ValueError, match=match):
        teng.simulate_segment_sweep(system, table, carries, scens, 2,
                                    events=events, device="cpu")


def test_segment_rejects_counts(small):
    system, table, init, _ = small
    fcfs = TT.Scenario.make("fcfs")
    with pytest.raises(ValueError, match="one carry per scenario"):
        teng.simulate_segment_sweep(system, table, [init, init], [fcfs], 2,
                                    device="cpu")
    with pytest.raises(ValueError, match="at least one carry"):
        teng.simulate_segment_sweep(system, table, [], [], 2, device="cpu")
    with pytest.raises(ValueError, match="at least one step"):
        teng.simulate_segment(system, table, init, fcfs, 0, device="cpu")
    # a carry handed to a segment is not modified
    before = snap.encode_carry(init)
    teng.simulate_segment(system, table, init, fcfs, 3, device="cpu")
    assert snap.encode_carry(init) == before
