"""The port's twin session (``repro_torch.serve.session.TwinSession``)
against itself and against the JAX package's.

The port against itself, bit for bit (the reference's own contract,
``tests/test_serve_checkpoint.py`` and ``tests/test_serve_soak.py``): a
neutral fork is its parent, in rows and in the snapshot digest at every
checkpoint; a divergent fork shares the prefix and then diverges; a
fork from an earlier checkpoint replays the parent's rows; checkpoints
are host numpy copies that nothing writes into; advancing a fork tree
coalesced (one batched segment a tick) equals advancing it branch by
branch, in the reference soak test's tree and in one whose branches sit
at different steps under different backfill rules with failure and
demand-response forks; a failure fork leaves its nominal parent
untouched; bad requests raise ``SessionError`` and corrupt nothing.

Against JAX: one fork tree in both sessions, every telemetry row at
rtol 1e-4 and the schedule leaves of every checkpoint exactly. The
``obs`` copies are held equal to the reference's.

The workloads are the reference's serve-test cases (``conftest``'s
``small_table`` and ``make_case``, marconi100 scaled to 64 nodes),
rebuilt from the port's dataset copy.
"""
import dataclasses
import inspect
import math

import numpy as np
import pytest
import torch

from conftest import make_signals
from repro.cooling import weather as jwx
from repro.core import types as JT
from repro.launch.simulate import build_system as jbuild
from repro.obs import schema as jschema
from repro.obs import sink as jsink
from repro.serve import session as jsession
from repro_torch.cooling import weather as twx
from repro_torch.core import types as TT
from repro_torch.events import EventConfig
from repro_torch.grid import signals as tgsig
from repro_torch.obs import schema as tschema
from repro_torch.obs import sink as tsink
from repro_torch.serve import SessionError, TwinSession
from repro_torch.serve import snapshot as snap

from test_torch_common import (assert_exact, ml_pair, port_signals,
                               to_port, workload_pair)

torch.set_num_threads(1)

INTERVAL = 8
N_INTERVALS = 6
HORIZON = INTERVAL * N_INTERVALS
HORIZON_S = 2 * 3600.0     # the soak tests' session window
RTOL = 1e-4
SCHEDULE = ("jstate", "start", "end", "node_job", "free_count", "step")


@pytest.fixture(scope="module", params=["flat", "halls"])
def topo(request):
    """tests/test_serve_checkpoint.py's cases: (system, table, scenario,
    signals, weather) for both plant shapes, in both packages."""
    if request.param == "flat":
        jsystem = jbuild("marconi100", scale=64)
        knobs = ("fcfs", "easy", dict(setpoint_delta_c=1.0))
    else:
        jsystem = jbuild("marconi100", scale=64, halls=4)
        knobs = ("thermal_aware", "firstfit",
                 dict(cells_offline=(1.0, 0.0, 0.0, 0.0)))
    system = to_port(jsystem)
    table, jtable = workload_pair(jsystem, 80, n_jobs=64, load=1.2, seed=3)
    p, b, kw = knobs
    return dict(
        name=request.param, system=system, table=table,
        scen=TT.Scenario.make(p, b, **kw),
        signals=port_signals(system, HORIZON),
        weather=twx.synthetic_weather(HORIZON, system.dt, seed=5),
        jsystem=jsystem, jtable=jtable, jscen=JT.Scenario.make(p, b, **kw),
        jsignals=make_signals(jsystem, HORIZON),
        jweather=jwx.synthetic_weather(HORIZON, system.dt, seed=5))


def topo_session(c, **kw):
    return TwinSession(c["system"], c["table"], c["scen"], 0.0,
                       HORIZON * c["system"].dt, interval_steps=INTERVAL,
                       signals=c["signals"], weather=c["weather"],
                       num_accounts=8, device="cpu", **kw)


@pytest.fixture(scope="module")
def small():
    """conftest's ``small_system`` and ``small_table``."""
    jsystem = jbuild("marconi100", scale=64)
    table, _ = workload_pair(jsystem, 96, n_jobs=80, load=1.0, seed=7)
    return to_port(jsystem), table


def small_session(small, scen=None, **kw):
    system, table = small
    return TwinSession(system, table, scen or TT.Scenario.make("fcfs", "easy"),
                       0.0, HORIZON_S, interval_steps=INTERVAL,
                       num_accounts=8, device="cpu", **kw)


def rows_by_step(sess, b):
    return {r["step"]: r for r in sess.fetch(b)["rows"]}


# ---------------------------------------------------------------------------
# Forks (tests/test_serve_checkpoint.py).
# ---------------------------------------------------------------------------
def test_neutral_fork_equals_parent(topo):
    sess = topo_session(topo)
    sess.advance_many({0: 2})
    child = sess.fork(0, {})
    sess.advance_many({0: N_INTERVALS - 2,
                       child.branch_id: N_INTERVALS - 2})
    assert sess.counters["coalesced_batches"] == N_INTERVALS - 2
    parent = rows_by_step(sess, 0)
    child_rows = sess.fetch(child.branch_id)["rows"]
    assert len(child_rows) == HORIZON - child.born_step
    for row in child_rows:
        assert row == parent[row["step"]], f"step {row['step']}"
    for step in sess.branches[child.branch_id].checkpoints:
        assert (sess.snapshot(0, at_step=step)["digest"]
                == sess.snapshot(child.branch_id, at_step=step)["digest"])


def test_divergent_fork_shares_prefix_and_diverges(topo):
    sess = topo_session(topo)
    sess.advance_many({0: 3})
    child = sess.fork(0, {"setpoint_delta_c": 4.0})
    sess.advance_many({0: 3, child.branch_id: 3})
    parent = rows_by_step(sess, 0)
    child_rows = sess.fetch(child.branch_id)["rows"]
    assert any(row != parent[row["step"]] for row in child_rows), \
        "setpoint_delta_c=4.0 produced bit-identical telemetry"
    assert (sess.snapshot(0, at_step=child.born_step)["digest"]
            == sess.snapshot(child.branch_id,
                             at_step=child.born_step)["digest"])


def test_fork_from_earlier_checkpoint(topo):
    sess = topo_session(topo)
    sess.advance_many({0: N_INTERVALS})
    child = sess.fork(0, {}, at_step=INTERVAL)
    assert child.step == INTERVAL
    sess.advance_many({child.branch_id: 2})
    parent = rows_by_step(sess, 0)
    rows = sess.fetch(child.branch_id)["rows"]
    assert [r["step"] for r in rows] == list(range(INTERVAL, 3 * INTERVAL))
    for row in rows:
        assert row == parent[row["step"]], f"step {row['step']}"


def test_checkpoints_are_host_copies(small):
    """Checkpoints are numpy arrays that share no memory with a live
    carry (on the CPU ``Tensor.cpu()`` would return the carry itself),
    and two forks from one checkpoint, advanced, leave it unchanged."""
    sess = small_session(small)
    sess.advance_many({0: 2})
    ck_step = sess.branches[0].step
    before = snap.carry_digest(snap.encode_carry(
        sess.branches[0].checkpoints[ck_step]))
    template = snap.carry_digest(snap.encode_carry(sess.carry_template))
    a = sess.fork(0, {"setpoint_delta_c": 2.0})
    b = sess.fork(0, {"cap_scale": 0.5, "policy": "sjf"})
    assert (sess.branches[a.branch_id].checkpoints[ck_step]
            is sess.branches[0].checkpoints[ck_step])
    sess.advance_many({a.branch_id: 2, b.branch_id: 1})
    sess.advance_many({0: 1})
    assert snap.carry_digest(snap.encode_carry(
        sess.branches[0].checkpoints[ck_step])) == before
    assert snap.carry_digest(snap.encode_carry(sess.carry_template)) \
        == template
    for br in sess.branches.values():
        assert len(br.checkpoints) >= 2
        live = [x for _, x in snap._flatten(br.carry)]
        for step, ck in br.checkpoints.items():
            for path, leaf in snap._flatten(ck):
                assert isinstance(leaf, np.ndarray), (br.branch_id, path)
                assert not any(np.shares_memory(leaf, x.numpy())
                               for x in live), (br.branch_id, step, path)
        for h in br.history:
            assert all(isinstance(x, np.ndarray)
                       for _, x in snap._flatten(h))


@pytest.mark.parametrize("bad", ["partial interval", "zero interval",
                                 "batched weather"])
def test_session_rejects_bad_construction(small, bad):
    system, table = small
    scen = TT.Scenario.make("fcfs")
    kw = dict(t1=HORIZON_S, interval_steps=INTERVAL, weather=None)
    if bad == "partial interval":
        kw["t1"], match = HORIZON_S + system.dt, "multiple of interval_steps"
    elif bad == "zero interval":
        kw["interval_steps"], match = 0, "interval_steps must be >= 1"
    else:
        w = twx.synthetic_weather(360, system.dt, seed=1)
        kw["weather"], match = twx.stack_weather([w, w]), "one weather trace"
    with pytest.raises(ValueError, match=match):
        TwinSession(system, table, scen, 0.0, kw["t1"], kw["interval_steps"],
                    weather=kw["weather"], device="cpu")


# ---------------------------------------------------------------------------
# Coalescing (tests/test_serve_soak.py).
# ---------------------------------------------------------------------------
def soak_tree(small, coalesce):
    """The reference soak test's tree, exactly."""
    sess = small_session(small)
    sess.advance_many({0: 2})
    for d in ({}, {"setpoint_delta_c": 2.0}, {"cap_scale": 0.85},
              {"cells_offline": 1.0}):
        sess.fork(0, d)
    ids = list(sess.branches)
    if coalesce:
        sess.advance_many({b: 3 for b in ids})
    else:
        for b in ids:
            sess.advance_many({b: 3})
    return sess


def mixed_tree(small, coalesce):
    """A first-fit root under grid signals with the event layer at zero
    rates; an EASY fork, a neutral fork from an earlier checkpoint (so one
    tick batches steps 8 and 24), a demand-response fork announced at the
    fork point and a failure fork."""
    system, _ = small
    n = int(round(HORIZON_S / system.dt))
    sess = small_session(small, TT.Scenario.make("fcfs", "first-fit"),
                         signals=port_signals(system, n),
                         events=EventConfig())
    sess.advance_many({0: 3})
    t = 3 * INTERVAL * system.dt
    sess.fork(0, {"backfill": "easy"})
    sess.fork(0, {}, at_step=INTERVAL)
    sess.fork(0, {"dr_announce_s": t, "dr_notice_s": 2 * system.dt,
                  "dr_duration_s": 10 * system.dt,
                  "dr_cap_w": 1.2 * system.n_nodes *
                  system.power.idle_node_w})
    sess.fork(0, {"node_fail_rate": 1e-3, "cdu_fail_rate": 2e-4,
                  "failure_corr": 0.5, "failure_seed": 7.0,
                  "repair_s": 300.0})
    ids = list(sess.branches)
    if coalesce:
        sess.advance_many({b: 3 for b in ids})
    else:
        for b in ids:
            sess.advance_many({b: 3})
    return sess


@pytest.mark.parametrize("tree", [soak_tree, mixed_tree],
                         ids=["soak", "mixed"])
def test_coalesced_advance_is_bitwise_identical_to_serial(small, tree):
    """Batching is unobservable: the tree advanced coalesced and one
    branch at a time gives identical rows and snapshot digests."""
    batched, serial = tree(small, True), tree(small, False)
    assert batched.counters["coalesced_batches"] >= 3
    assert serial.counters["coalesced_batches"] == 0
    for b in batched.branches:
        assert batched.fetch(b)["rows"] == serial.fetch(b)["rows"], \
            f"branch {b} diverged under batching"
        assert (batched.snapshot(b)["digest"]
                == serial.snapshot(b)["digest"]), f"branch {b} carry"
    if tree is mixed_tree:
        steps = {b: br.step for b, br in batched.branches.items()}
        assert steps == {0: 48, 1: 48, 2: 32, 3: 48, 4: 48}
        dr = batched.fetch(3)["rows"]
        assert any(r["cap_w"] < rows_by_step(batched, 0)[r["step"]]["cap_w"]
                   for r in dr)
        assert sum(r["n_killed"] for r in batched.fetch(4)["rows"]) > 0


def test_failure_fork_leaves_the_nominal_branch_untouched(small):
    """tests/test_serve_soak.py's fault soak: a session with the event
    layer at zero rates, forked into a failure branch by delta alone; the
    nominal branch stays byte for byte a session that never forked, and
    its rows those of a session without the event layer."""
    soaked = small_session(small, events=EventConfig())
    soaked.advance_many({0: 2})
    soaked.fork(0, {"node_fail_rate": 2e-4, "cdu_fail_rate": 5e-5,
                    "failure_corr": 0.5, "failure_seed": 7.0,
                    "repair_s": 600.0})
    fault = max(soaked.branches)
    soaked.advance_many({0: 3, fault: 3})
    pristine = small_session(small, events=EventConfig())
    pristine.advance_many({0: 5})
    assert soaked.fetch(0)["rows"] == pristine.fetch(0)["rows"], \
        "failure fork leaked into the nominal branch"
    assert soaked.snapshot(0)["digest"] == pristine.snapshot(0)["digest"]
    rows = soaked.fetch(fault)["rows"]
    assert sum(r["nodes_down"] for r in rows) > 0
    assert rows != soaked.fetch(0)["rows"]
    plain = small_session(small)
    plain.advance_many({0: 5})
    assert plain.fetch(0)["rows"] == pristine.fetch(0)["rows"]


def test_dr_fork_holds_its_cap(small):
    """A demand-response fork announced at the fork point: the recorded
    cap is min(signal cap, DR cap) inside the window, and the IT draw
    never exceeds it (with the DVFS floor low enough to reach it, as on
    frontier-grid-6h)."""
    system, table = small
    system = dataclasses.replace(system, grid=dataclasses.replace(
        system.grid, c_min=0.05))
    n = int(round(HORIZON_S / system.dt))
    sess = small_session((system, table), signals=tgsig.neutral(n),
                         events=EventConfig())
    sess.advance_many({0: 3})
    t = 3 * INTERVAL * system.dt
    cap = 1.5 * system.n_nodes * system.power.idle_node_w
    dr = sess.fork(0, {"dr_announce_s": t, "dr_notice_s": 2 * system.dt,
                       "dr_duration_s": 10 * system.dt, "dr_cap_w": cap})
    sess.advance_many({0: 3, dr.branch_id: 3})
    cols = sess.fetch(dr.branch_id, binary=True)["cols"]
    t_row = cols["t"]
    start = t + 2 * system.dt
    active = (t_row >= start) & (t_row < start + 10 * system.dt)
    want = np.where(active, np.float32(cap), np.inf)
    assert np.array_equal(cols["cap_w"], want)
    assert active.sum() == 10
    assert (cols["power_it"] <= cols["cap_w"]).all()
    # the cap binds: the parent draws more inside the window
    parent = sess.fetch(0, start=dr.born_step, binary=True)["cols"]
    assert (parent["power_it"][active] > cap).any()
    assert (cols["throttle_frac"][active] > 0).any()


def test_session_error_taxonomy(small):
    sess = small_session(small)
    sess.advance_many({0: 1})
    with pytest.raises(SessionError, match="unknown branch"):
        sess.advance_many({42: 1})
    with pytest.raises(SessionError, match="no checkpoint"):
        sess.fork(0, {}, at_step=3)
    with pytest.raises(SessionError, match="unknown scenario knob"):
        sess.fork(0, {"flux_capacitor": 1.21})
    with pytest.raises(SessionError, match="no checkpoint"):
        sess.snapshot(0, at_step=999)
    with pytest.raises(SessionError, match="scalar in this session"):
        sess.fork(0, {"cells_offline": [1.0, 0.0]})
    with pytest.raises(SessionError, match="alpha.*scalar in this session"):
        sess.fork(0, {"alpha": [1.0, 1.0, 1.0, 0.5]})
    with pytest.raises(SessionError, match=">= 0"):
        sess.advance_many({0: -1})
    assert sess.advance_many({0: 1})[0]["advanced_steps"] == INTERVAL
    assert len(sess.branches) == 1
    assert sess.counters["errors"] == 6
    # the horizon clamps an advance instead of failing it
    out = sess.advance_many({0: 10 ** 6})[0]
    assert out["step"] == int(round(HORIZON_S / small[0].dt))


def test_fetch_columns_and_describe(small):
    sess = small_session(small)
    sess.advance_many({0: 2})
    child = sess.fork(0, {"cap_scale": 0.9})
    sess.advance_many({child.branch_id: 1})
    rows = sess.fetch(0, start=4, stop=12)
    cols = sess.fetch(0, start=4, stop=12, binary=True)
    assert (rows["start"], rows["stop"]) == (cols["start"], cols["stop"])
    assert list(cols["cols"]) == rows["fields"]
    for i, row in enumerate(rows["rows"]):
        assert row == {k: (int(v[i]) if k == "step" else float(v[i]))
                       for k, v in cols["cols"].items()}
    empty = sess.fetch(child.branch_id, stop=INTERVAL, binary=True)
    assert all(v.shape == (0,) for v in empty["cols"].values())
    desc = sess.describe()
    assert [(b["branch"], b["parent"], b["step"], b["born_step"])
            for b in desc["branches"]] == [(0, None, 16, 0), (1, 0, 24, 16)]
    assert desc["branches"][1]["delta"] == {"cap_scale": 0.9}
    assert desc["counters"]["forks"] == 1


# ---------------------------------------------------------------------------
# Against the JAX session.
# ---------------------------------------------------------------------------
def grow(sess, fork):
    """One fork tree: the root, a divergent and an EASY fork, then a fork
    of a fork from an earlier checkpoint; every branch to the horizon."""
    sess.advance_many({0: 2})
    a = fork(sess, 0, {"setpoint_delta_c": 2.0})
    fork(sess, 0, {"backfill": "easy", "cap_scale": 0.8})
    sess.advance_many({b: 2 for b in sess.branches})
    fork(sess, a, {"policy": "sjf"}, 3 * INTERVAL)
    sess.advance_many({b: N_INTERVALS for b in sess.branches})


def test_session_matches_jax(topo):
    port = topo_session(topo)
    ref = jsession.TwinSession(
        topo["jsystem"], topo["jtable"], topo["jscen"], 0.0,
        HORIZON * topo["system"].dt, interval_steps=INTERVAL,
        signals=topo["jsignals"], weather=topo["jweather"], num_accounts=8)
    grow(port, lambda s, p, d, at=None: s.fork(p, d, at).branch_id)
    grow(ref, lambda s, p, d, at=None: s.fork(p, d, at).branch_id)
    assert sorted(port.branches) == sorted(ref.branches) == [0, 1, 2, 3]
    assert_sessions_match(port, ref)


def test_alpha_fork_matches_jax():
    """Forks that change ``alpha`` (the ML scoring weights, a vector and
    a scalar broadcast over it) on a table carrying the scoring basis of
    the JAX-fitted model: every row and checkpoint as the JAX session's,
    and each fork ranks its own way (its schedule leaves its parent's)."""
    jsystem = jbuild("marconi100", scale=64)
    ttable, jtable, _, jmodel = ml_pair(
        jsystem, dict(n_jobs=200, duration_s=86400.0, load=1.0, trace_len=8,
                      n_accounts=8, seed=4),
        dict(n_jobs=80, duration_s=1800.0, load=3.0, trace_len=8,
             n_accounts=8, mean_wall_s=600.0, seed=7),
        pad=96, k=3, n_trees=4, depth=4)
    alpha = tuple(float(a) for a in np.asarray(jmodel.alpha))
    port = TwinSession(to_port(jsystem), ttable,
                       TT.Scenario.make("ml", "first-fit", alpha=alpha), 0.0,
                       HORIZON_S, interval_steps=INTERVAL, num_accounts=8,
                       device="cpu")
    ref = jsession.TwinSession(
        jsystem, jtable, JT.Scenario.make("ml", "first-fit", alpha=alpha),
        0.0, HORIZON_S, interval_steps=INTERVAL, num_accounts=8)
    for sess in (port, ref):
        sess.advance_many({0: 2})
        sess.fork(0, {"alpha": [0.1, 3.0, 0.1, 3.0]})
        sess.fork(0, {"alpha": 0.5})
        sess.advance_many({0: 10, 1: 10, 2: 10})
    assert_sessions_match(port, ref)
    last = max(port.branches[0].checkpoints)
    start = {b: port.branches[b].checkpoints[last].start
             for b in port.branches}
    assert not np.array_equal(start[0], start[1])
    assert not np.array_equal(start[0], start[2])


def assert_sessions_match(port, ref):
    """Every branch of two sessions grown alike: rows at rtol 1e-4, and
    the schedule leaves of every checkpoint exactly (floats at 1e-4)."""
    for b in port.branches:
        got, want = port.fetch(b, binary=True), ref.fetch(b, binary=True)
        assert got["fields"] == want["fields"]
        for k, w in want["cols"].items():
            np.testing.assert_allclose(got["cols"][k], w, rtol=RTOL,
                                       atol=1e-6 if k == "throttle_frac"
                                       else 0.0, err_msg=f"branch {b} {k}")
        assert sorted(port.branches[b].checkpoints) == \
            sorted(ref.branches[b].checkpoints)
        for step, ck in port.branches[b].checkpoints.items():
            mine = dict(snap._flatten(ck))
            theirs = {p: snap.decode_array(v) for p, v in
                      ref.snapshot(b, at_step=step,
                                   binary=True)["snapshot"]["leaves"].items()}
            assert mine.keys() == theirs.keys()
            for path, w in theirs.items():
                if path in SCHEDULE:
                    assert_exact(w, mine[path], f"branch {b} {step} {path}")
                else:
                    np.testing.assert_allclose(
                        mine[path], w, rtol=RTOL,
                        err_msg=f"branch {b} step {step} {path}")


# ---------------------------------------------------------------------------
# The obs copies.
# ---------------------------------------------------------------------------
def test_schema_is_a_copy():
    """The port's ``obs/schema.py`` is the reference's below the module
    docstring, and builds and validates the same frames."""
    def body(mod):
        src = inspect.getsource(mod)
        return src[src.index("from __future__"):]
    assert body(tschema) == body(jschema)
    values = {"a": np.float32(np.nan), "b": [np.inf, -1.5, np.int64(3)],
              "c": np.arange(3.0), "d": {"e": (True, None, "x")}}
    assert tschema.jsonable(values) == jschema.jsonable(values)
    for make in ("event_frame", "metrics_frame", "summary_frame"):
        args = {"event_frame": ("run", 3, 1.5, "tick"),
                "metrics_frame": ("run", 4, 20.0, values),
                "summary_frame": ("run", values)}[make]
        assert getattr(tschema, make)(*args) == getattr(jschema, make)(*args)
    for bad in (3, {"v": 2}, {"v": 1, "kind": "x"},
                {"v": 1, "kind": "event"}):
        with pytest.raises(tschema.SchemaError) as mine:
            tschema.validate_frame(bad)
        with pytest.raises(jschema.SchemaError) as theirs:
            jschema.validate_frame(bad)
        assert str(mine.value) == str(theirs.value)


def test_sink_fields_and_frames_are_the_reference_s(small):
    assert tsink.SCALAR_FIELDS == jsink.SCALAR_FIELDS
    assert tsink.HALL_FIELDS == jsink.HALL_FIELDS
    sess = small_session(small)
    sess.advance_many({0: 1})
    hist = sess.branches[0].history[0]
    mine = list(tsink.history_frames("run", hist, label="fcfs:easy", seq0=5))
    theirs = list(jsink.history_frames("run", hist, label="fcfs:easy",
                                       seq0=5))
    assert len(mine) == INTERVAL and mine == theirs
    assert mine[0]["data"]["cap_w"] is None         # +inf: uncapped
    assert math.isfinite(mine[0]["data"]["power_it"])
    assert dataclasses.is_dataclass(hist)
