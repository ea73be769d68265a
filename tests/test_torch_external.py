"""Parity of the port's external-scheduler coupling with the JAX package.

``repro_torch.core.engine.external_step``, plugin mode (FastSim-like and
ScheduleFlow-like peers), sequential mode, the bridge's conformance
cases and the CLI's external flags, each run on the same inputs through
the JAX package and the port (on the CPU). Schedules (``jstate``,
``start``, ``end``, ``node_job``, ``free_count``) must agree exactly,
float telemetry at rtol 1e-4. ``power_fan`` also gets an absolute
tolerance of 1e-4 of its peak (at least 1e-4 W): on these small machines
the fans run near zero, where the staging fraction is the difference of
two large heat terms and its cube amplifies a float32 rounding.
"""
import dataclasses
import json
import pathlib
import sys
import time
import types

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from conftest import make_signals  # noqa: E402
from repro.core import engine as jeng  # noqa: E402
from repro.core import external as jext  # noqa: E402
from repro.core import types as JT  # noqa: E402
from repro.datasets import synthetic as jsyn  # noqa: E402
from repro.launch import simulate as jcli  # noqa: E402
from repro.systems.config import get_system  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.core import engine as teng  # noqa: E402
from repro_torch.core import external as text  # noqa: E402
from repro_torch.core import types as TT  # noqa: E402
from repro_torch.datasets import synthetic as tsyn  # noqa: E402
from repro_torch.launch import simulate as tcli  # noqa: E402
from test_torch_common import (as_np, assert_exact,  # noqa: E402
                               assert_jobsets_equal, assert_runs_match,
                               assert_states_equal, four_hall, leaves,
                               port_signals, to_port)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PEER_CMD = f"{sys.executable} {ROOT / 'tools' / 'reference_peer.py'}"
SYS = get_system("frontier").scaled(64)
TSYS = to_port(SYS)
RTOL = 1e-4
N_JOBS = 40
K = 64                       # the reference's padded placement width
SCHEDULE = ("jstate", "start", "end", "node_job", "free_count")


def jobs_pair(seed, n=N_JOBS, system=SYS):
    """One synthetic workload from both packages' generators, checked
    equal field for field: (port JobSet, JAX JobSet)."""
    spec = dict(n_jobs=n, duration_s=2 * 3600.0, load=1.2, trace_len=4,
                seed=seed)
    jjs = jsyn.generate(system, jsyn.WorkloadSpec(**spec))
    tjs = tsyn.generate(to_port(system), tsyn.WorkloadSpec(**spec))
    assert_jobsets_equal(jjs, tjs, "jobs")
    return tjs, jjs


def fan_atol(fan):
    """The absolute tolerance on ``power_fan``: 1e-4 of the reference's
    peak, at least 1e-4 W."""
    return {"power_fan": 1e-4 * max(float(np.abs(np.asarray(fan)).max()),
                                    1.0)}


def assert_plugin_match(want, got, what=""):
    """A JAX plugin-mode run (final, history dict) against the port's:
    the same history keys, the schedule exact, floats at ``RTOL``."""
    (wf, wh), (gf, gh) = want, got
    assert set(wh) == set(gh), what
    for k in wh:
        assert np.asarray(wh[k]).shape == gh[k].shape, k
        assert np.asarray(wh[k]).dtype == gh[k].dtype, k
    assert_runs_match(
        (wf, types.SimpleNamespace(**wh)),
        (gf, TT.StepRecord(**{k: torch.from_numpy(v) for k, v in gh.items()})),
        RTOL, what, atol=fan_atol(wh["power_fan"]))


# ---------------------------------------------------------------------------
# external_step, one step at a time from the same state.
# ---------------------------------------------------------------------------
def place_list(jst, jtable, rng):
    """The ids an external scheduler might send at this step: every job
    that is (or becomes) queued, largest first so that the last ones no
    longer fit, plus a running job and a job not yet submitted (neither
    queued), shuffled -1 slots between them, padded to ``K``."""
    js = np.asarray(jst.jstate)
    t = float(jst.t)
    submit = np.asarray(jtable.submit)
    nodes = np.asarray(jtable.nodes)
    queued = np.nonzero((js == JT.QUEUED) |
                        ((js == JT.PENDING) & (submit <= t)))[0]
    ids = sorted(queued.tolist(), key=lambda j: (-int(nodes[j]), j))
    running = np.nonzero(js == JT.RUNNING)[0]
    later = np.nonzero((js == JT.PENDING) & (submit > t))[0]
    if running.size:
        ids.insert(1, int(running[0]))
    if later.size:
        ids.insert(0, int(later[0]))
    out = []
    for j in ids:
        out.extend([-1] * int(rng.integers(0, 2)) + [j])
    out = out[:K]
    return np.asarray(out + [-1] * (K - len(out)), np.int32)


def step_both(jsys, jtable, ttable, jst, place, **kw):
    """One ``external_step`` from the JAX state ``jst`` in both packages:
    the port's from the same state (moved over leaf by leaf), padded and
    unpadded, which must agree bit for bit. Returns (JAX state, JAX row,
    port state, port row)."""
    jkw = {k[1:]: v for k, v in kw.items() if k.startswith("j")}
    tkw = {k[1:]: v for k, v in kw.items() if k.startswith("t")}
    jout, jrec = jeng.external_step(jsys, jtable, jst, jnp.asarray(place),
                                    **jkw)
    tst = TT.SimState.from_arrays(leaves(jst))
    tsys = to_port(jsys)
    tout, trow = teng.external_step(tsys, ttable, tst, place, **tkw)
    real = [int(j) for j in place if j >= 0]
    tout2, trow2 = teng.external_step(tsys, ttable, tst,
                                      torch.tensor(real, dtype=torch.int32),
                                      **tkw)
    assert_states_equal(tout, tout2, "padded vs unpadded ")
    for k in trow:
        assert_exact(as_np(trow[k]), trow2[k], f"padded vs unpadded {k}")
    return jout, jrec, tout, trow


def assert_step_match(jout, jrec, tout, trow, what):
    got = TT.row(tout, 0)
    for name in SCHEDULE:
        assert_exact(np.asarray(getattr(jout, name)), getattr(got, name),
                     f"{what} {name}")
    for name, w in leaves(jout).items():
        g = getattr(got, name)
        if isinstance(w, dict):
            for k, x in w.items():
                np.testing.assert_allclose(as_np(getattr(g, k)), x,
                                           rtol=RTOL, err_msg=f"{what} {k}")
        elif w is not None and np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(as_np(g), w, rtol=RTOL,
                                       err_msg=f"{what} {name}")
    for k, g in trow.items():
        w = np.asarray(getattr(jrec, k))
        g = as_np(g)[0]
        assert w.shape == g.shape and w.dtype == g.dtype, (what, k)
        atol = dict(fan_atol(w), throttle_frac=1e-6).get(k, 0.0)
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=atol,
                                   err_msg=f"{what} {k}")
    assert set(trow) | {"emissions_kg", "energy_cost", "cap_w",
                        "throttle_frac"} == set(vars(jrec))


def drive_steps(jsys, n, seed, scen=None, signals=None, hot_group=None):
    """``n`` external steps in both packages from a fresh state, each
    from the JAX state of the step before. Returns per-step facts: the
    ids sent, the JAX state before and after, the JAX row. ``hot_group``
    starts that CDU group's supply 5 °C past the overheat threshold."""
    tjs, jjs = jobs_pair(seed, system=jsys)
    # jobs 8x wider (at most 3/4 of the machine), from half an hour in:
    # the backlog's largest-first ids overflow the free nodes
    for js in (tjs, jjs):
        js.nodes = np.minimum(js.nodes * 8, 48)
    jtable, ttable = jjs.to_table(), tjs.to_table()
    jst = jeng.init_state(jsys, jtable, 1800.0, 2 * 3600.0)
    if hot_group is not None:
        cool = jsys.cooling
        hot = cool.t_supply_setpoint_c + cool.t_supply_margin_c + 5.0
        jst = dataclasses.replace(jst, cooling=dataclasses.replace(
            jst.cooling, t_supply=jst.cooling.t_supply.at[hot_group].set(hot)))
    rng = np.random.default_rng(seed)
    kw = {}
    if scen is not None:
        kw.update(jscen=JT.Scenario.make("replay", **scen),
                  tscen=TT.Scenario.make("replay", **scen))
    if signals is not None:
        kw.update(jsignals=make_signals(jsys, n),
                  tsignals=port_signals(to_port(jsys), n))
    facts = []
    for i in range(n):
        place = place_list(jst, jtable, rng)
        jout, jrec, tout, trow = step_both(jsys, jtable, ttable, jst, place,
                                           **kw)
        assert_step_match(jout, jrec, tout, trow, f"step {i}")
        facts.append((place, jst, jout, jrec))
        jst = jout
    return facts, jtable


def test_external_step_flat_plant_gates_match_jax():
    facts, jtable = drive_steps(SYS, 12, seed=3)
    nodes = np.asarray(jtable.nodes)
    placed = refused_fit = skipped = 0
    for place, before, after, _ in facts:
        js0, js1 = np.asarray(before.jstate), np.asarray(after.jstate)
        sub = np.asarray(jtable.submit) <= float(before.t)
        for j in place[place >= 0]:
            if js1[j] == JT.RUNNING and js0[j] != JT.RUNNING:
                placed += 1
            elif js0[j] in (JT.QUEUED, JT.PENDING) and sub[j]:
                refused_fit += int(nodes[j] > 0)
            else:
                skipped += 1            # running already, or not submitted
    # the pass placed jobs, refused some that no longer fit, and skipped
    # ids that were not queued
    assert placed > 0 and refused_fit > 0 and skipped > 0


def test_external_step_binding_thermal_gate_matches_jax():
    facts, _ = drive_steps(SYS, 3, seed=5,
                           scen=dict(setpoint_delta_c=-15.0))
    for place, before, after, rec in facts:
        assert float(rec.thermal_throttled) == 1.0
        js0, js1 = np.asarray(before.jstate), np.asarray(after.jstate)
        assert not ((js1 == JT.RUNNING) & (js0 != JT.RUNNING)).any()


def test_external_step_four_halls_with_cells_offline_matches_jax():
    jsys = four_hall(SYS)
    facts, _ = drive_steps(jsys, 12, seed=7,
                           scen=dict(cells_offline=(1.0, 0.0, 0.0, 0.0)),
                           hot_group=0)
    hot = [np.asarray(rec.overheat_hall) for *_, rec in facts]
    # the per-hall gate bound at some step: some halls lost their
    # setpoint while others held it
    assert any(0 < h.sum() < h.size for h in hot)
    started = [((np.asarray(b.jstate) != JT.RUNNING) &
                (np.asarray(a.jstate) == JT.RUNNING)).sum()
               for _, b, a, _ in facts]
    assert sum(started) > 0
    cells = np.asarray(facts[-1][3].cells_online)
    assert cells[0] == 0.0 and (cells[1:] > 0).all()


def test_external_step_grid_branch_under_binding_cap_matches_jax():
    facts, _ = drive_steps(SYS, 12, seed=9, scen=dict(cap_scale=0.4),
                           signals=True)
    thr = np.asarray([float(rec.throttle_frac) for *_, rec in facts])
    assert (thr > 0).any()


# ---------------------------------------------------------------------------
# The coupling modes.
# ---------------------------------------------------------------------------
def test_plugin_mode_fastsim_matches_jax():
    tjs, jjs = jobs_pair(3)
    jsched = jext.FastSimLike(policy="sjf", backfill="firstfit")
    tsched = text.FastSimLike(policy="sjf", backfill="firstfit")
    jf, jh, _ = jext.run_plugin_mode(SYS, jjs, jsched, 0.0, 3600.0)
    tf, th, wall = text.run_plugin_mode(TSYS, tjs, tsched, 0.0, 3600.0,
                                        device="cpu")
    assert_exact(jsched.start, tsched.start, "FastSimLike.start")
    assert_plugin_match((jf, jh), (tf, th), "plugin fastsim")
    assert wall > 0 and th["power_it"].shape == (240,)
    # the twin ran the jobs the external scheduler started
    got = set(np.nonzero(as_np(tf.jstate) >= TT.RUNNING)[0].tolist())
    assert set(np.nonzero(tsched.start <= 3600.0 - SYS.dt)[0].tolist()) \
        <= got


def test_plugin_mode_scheduleflow_recomputes_every_poll():
    tjs, jjs = jobs_pair(7, n=20)
    jsched, tsched = jext.ScheduleFlowLike(), text.ScheduleFlowLike()
    jf, jh, _ = jext.run_plugin_mode(SYS, jjs, jsched, 0.0, 1800.0)
    tf, th, _ = text.run_plugin_mode(TSYS, tjs, tsched, 0.0, 1800.0,
                                     device="cpu")
    n_steps = int(1800.0 / SYS.dt)
    assert jsched.recompute_count == tsched.recompute_count == n_steps
    assert_plugin_match((jf, jh), (tf, th), "plugin scheduleflow")


def test_sequential_mode_fastsim_matches_jax():
    tjs, jjs = jobs_pair(5)
    jjs.assign_prepop_placement(0.0, SYS.n_nodes)
    tjs.assign_prepop_placement(0.0, TSYS.n_nodes)
    want = jext.run_sequential_mode(
        SYS, jjs, jext.FastSimLike(policy="fcfs", backfill="firstfit"),
        0.0, 3600.0)
    got = text.run_sequential_mode(
        TSYS, tjs, text.FastSimLike(policy="fcfs", backfill="firstfit"),
        0.0, 3600.0, device="cpu")
    assert_runs_match(want, got, RTOL, "sequential",
                      atol=fan_atol(want[1].power_fan))
    assert float(got[0].completed) > 0


def test_sequential_mode_keeps_the_facility_knobs():
    """``scen``'s setpoint reaches the replay; its policy does not."""
    tjs, jjs = jobs_pair(5)
    kw = dict(setpoint_delta_c=2.0)
    want = jext.run_sequential_mode(
        SYS, jjs, jext.FastSimLike(), 0.0, 1800.0,
        scen=JT.Scenario.make("sjf", "easy", **kw))
    got = text.run_sequential_mode(
        TSYS, tjs, text.FastSimLike(), 0.0, 1800.0,
        scen=TT.Scenario.make("sjf", "easy", **kw), device="cpu")
    assert_runs_match(want, got, RTOL, "sequential +2 C",
                      atol=fan_atol(want[1].power_fan))
    plain = text.run_sequential_mode(TSYS, tjs, text.FastSimLike(), 0.0,
                                     1800.0, device="cpu")
    for name in SCHEDULE:
        assert_exact(as_np(getattr(plain[0], name)),
                     getattr(got[0], name), name)
    assert not torch.equal(plain[1].t_supply_max, got[1].t_supply_max)


def test_history_keys_equal_the_references():
    tjs, jjs = jobs_pair(11, n=10)
    _, jh, _ = jext.run_plugin_mode(SYS, jjs, jext.FastSimLike(), 0.0,
                                    2 * SYS.dt)
    _, th, _ = text.run_plugin_mode(TSYS, tjs, text.FastSimLike(), 0.0,
                                    2 * SYS.dt, device="cpu")
    assert set(jh) == set(th) == {f.name for f in
                                  dataclasses.fields(TT.StepRecord)}
    assert all(isinstance(v, np.ndarray) for v in th.values())


# ---------------------------------------------------------------------------
# Bridge conformance (both packages on the same peers).
# ---------------------------------------------------------------------------
def malformed_answers(n_jobs, version):
    return [
        {"version": 99, "kind": "running_set", "job_ids": [0]},
        {"version": version, "kind": "plan", "job_ids": [0]},
        {"version": version, "kind": "running_set", "job_ids": [0.5]},
        {"version": version, "kind": "running_set", "job_ids": [0, 0]},
        {"version": version, "kind": "running_set",
         "job_ids": [n_jobs + 5]},
        [0, 1, 2],
    ]


class MalformedPeer:
    def __init__(self, answer):
        self.answer = answer
        self.polls = 0

    def reset(self, system, jobs, t0):
        pass

    def poll_wire(self, t):
        self.polls += 1
        return self.answer


class DeadPeer:
    def reset(self, system, jobs, t0):
        pass

    def running_at(self, t):
        raise ConnectionError("peer went away")


# (module, system, extra keyword arguments of the coupling modes)
PAIRS = [(jext, SYS, {}), (text, TSYS, {"device": "cpu"})]


@pytest.mark.parametrize("which", [0, 1], ids=["jax", "port"])
@pytest.mark.parametrize("case", range(6))
def test_malformed_envelopes_raise_protocol_error_not_retried(which, case):
    mod, system, kw = PAIRS[which]
    tjs, jjs = jobs_pair(9, n=10)
    js = jjs if which == 0 else tjs
    peer = MalformedPeer(malformed_answers(len(js), mod.WIRE_VERSION)[case])
    with pytest.raises(mod.ProtocolError):
        mod.run_plugin_mode(system, js, peer, 0.0, 2 * SYS.dt, **kw)
    assert peer.polls == 1          # malformed speech is not retried


@pytest.mark.parametrize("which", [0, 1], ids=["jax", "port"])
def test_dead_peer_raises_bridge_timeout(which):
    mod, system, kw = PAIRS[which]
    tjs, jjs = jobs_pair(13, n=10)
    bridge = mod.SchedulerBridge(DeadPeer())
    with pytest.raises(mod.BridgeTimeout):
        mod.run_plugin_mode(system, jjs if which == 0 else tjs, bridge,
                            0.0, 2 * SYS.dt, **kw)
    assert bridge.poll_failures == mod.BridgeConfig().max_retries + 1
    assert bridge.reconnects == mod.BridgeConfig().max_retries


def test_slow_peer_reconnects_once_then_recovers():
    """A peer that blows the per-call budget once (a 0.5 s sleep against
    a 0.2 s budget) is reconnected and the poll retried; the run then
    completes, in both packages, with the same telemetry."""
    tjs, jjs = jobs_pair(11, n=10)
    out = []
    for mod, system, js, kw in ((jext, SYS, jjs, {}),
                                (text, TSYS, tjs, {"device": "cpu"})):
        class SlowOncePeer(mod.FastSimLike):
            slow_polls: int = 0

            def poll_wire(self, t):
                if self.slow_polls == 0:
                    self.slow_polls += 1
                    time.sleep(0.5)
                return super().poll_wire(t)

        bridge = mod.SchedulerBridge(
            SlowOncePeer(policy="fcfs", backfill="firstfit"),
            mod.BridgeConfig(timeout_s=0.2, max_retries=2))
        final, hist, _ = mod.run_plugin_mode(system, js, bridge, 0.0, 1800.0,
                                             **kw)
        assert bridge.reconnects == 1 and bridge.budget_exceeded == 1
        assert bridge.polls == 120
        assert (np.asarray(hist["power_it"]) > 0).all()
        out.append((final, hist))
    assert_plugin_match(out[0], out[1], "slow peer")


def test_bridge_stats_and_events():
    tjs, _ = jobs_pair(11, n=10)
    seen = []
    bridge = text.SchedulerBridge(
        DeadPeer(), on_event=lambda e, f: seen.append((e, f)))
    bridge.reset(TSYS, tjs, 0.0)
    with pytest.raises(text.BridgeTimeout):
        bridge.poll(0.0)
    assert seen == [("bridge_reconnect", {"reconnects": 1})]
    st = bridge.stats()
    assert st["poll_failures"] == 2 and st["polls"] == 0
    assert st["poll_latency"]["count"] == 0
    with pytest.raises(text.BridgeTimeout, match="before reset"):
        text.SchedulerBridge(DeadPeer())._reconnect()
    fs = text.SchedulerBridge(text.FastSimLike())
    fs.reset(TSYS, tjs, 0.0)
    ts = [0.0, 600.0, 1200.0]
    many = fs.poll_many(ts)
    assert [m.tolist() for m in many] == [fs.poll(t).tolist() for t in ts]
    assert fs.stats()["polls"] == 1 + len(ts)   # one batch, then singles


# ---------------------------------------------------------------------------
# The CLI's external flags, both CLIs on the same argv.
# ---------------------------------------------------------------------------
CLI_BASE = ["--system", "marconi100", "--scale", "64", "--jobs", "40",
            "-t", "1h", "--quiet", "--json"]
CLI_CASES = {
    "fastsim": ["--scheduler", "fastsim"],
    "scheduleflow": ["--scheduler", "scheduleflow"],
    "peer-plugin": ["--external-cmd", PEER_CMD, "--external-mode", "plugin"],
    "peer-sequential": ["--external-cmd", PEER_CMD,
                        "--external-mode", "sequential"],
}


@pytest.mark.parametrize("case", sorted(CLI_CASES))
def test_cli_external_summaries_match_jax(case, capsys):
    argv = CLI_BASE + CLI_CASES[case]
    jcli.main(argv)
    want = json.loads(capsys.readouterr().out)
    tcli.main(argv + ["--device", "cpu"])
    got = json.loads(capsys.readouterr().out)
    assert want.keys() == got.keys()
    for label, ws in want.items():
        gs = got[label]
        if label == "bridge":
            for k in ("polls", "poll_failures", "budget_exceeded",
                      "reconnects"):
                assert gs[k] == ws[k], k
            assert gs["poll_latency"]["count"] == ws["poll_latency"]["count"]
            assert gs.get("peer") == ws.get("peer")
            continue
        assert ws.keys() == gs.keys(), label
        assert gs["jobs_completed"] == ws["jobs_completed"]
        for k in ws:
            np.testing.assert_allclose(gs[k], ws[k], rtol=RTOL,
                                       err_msg=f"{case} {k}")
    jobs = [v for k, v in got.items() if k != "bridge"][0]["jobs_completed"]
    assert jobs > 0
    assert ("bridge" in got) == (case in ("scheduleflow", "peer-plugin"))


def test_cli_refuses_weather_trace_with_external_coupling():
    weather = str(ROOT / "tests" / "data" / "weather_week.csv")
    for extra in (["--scheduler", "fastsim"], ["--scheduler", "scheduleflow"],
                  ["--external-cmd", PEER_CMD]):
        argv = CLI_BASE + extra + ["--weather-trace", weather]
        with pytest.raises(SystemExit) as want:
            jcli.main(argv)
        with pytest.raises(SystemExit) as got:
            tcli.main(argv + ["--device", "cpu"])
        assert str(got.value) == str(want.value)
        assert "not supported with external" in str(got.value)


def test_cli_manifest_carries_the_bridge_counters(tmp_path, capsys):
    manifest = tmp_path / "run.json"
    tcli.main(CLI_BASE + ["--scheduler", "scheduleflow", "--device", "cpu",
                          "--manifest", str(manifest)])
    doc = json.loads(capsys.readouterr().out)
    m = obs.load_manifest(manifest)
    bridge = m["counters"]["bridge"]
    n_steps = int(round(3600.0 / tcli.build_system("marconi100", 64).dt))
    assert bridge["polls"] == n_steps and bridge["reconnects"] == 0
    assert bridge == doc["bridge"]
    assert m["scenario"]["scheduler"] == "scheduleflow"
    assert m["scenario"]["backfill"] == "none"


def test_coupling_modes_without_device_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    tjs, _ = jobs_pair(3, n=10)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        text.run_plugin_mode(TSYS, tjs, text.FastSimLike(), 0.0, SYS.dt)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        text.run_sequential_mode(TSYS, tjs, text.FastSimLike(), 0.0, SYS.dt)
