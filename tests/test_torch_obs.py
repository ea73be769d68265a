"""The port's flight recorder (``repro_torch.obs``) and the engine's phase
spans, against the reference's (``tests/test_obs.py`` and
``tests/test_obs_properties.py``).

Manifests validate against the port's unedited copy of the schema (its
``versions.jax`` is None), carry digests equal to the reference's and are
deterministic; the recorder writes the manifest and the event log and
survives a missing ``finalize``; the metrics sink gives one frame per
step, to a file and over a socket, equal to the reference's frames of the
same history; the span timer and the latency histogram behave as the
reference's; the CLI's flight recorder is deterministic across two CPU
runs; an observed run equals an unobserved one bit for bit and
dispatches the same aten operations; ``timing.py``, ``reporter.py`` and
``launch/env.py`` are held equal to the originals.
"""
import inspect
import io
import json
import logging
import math
import re
import socket
import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st
from torch.utils._python_dispatch import TorchDispatchMode

from repro.core import transport as jtr
from repro.datasets import loaders as jloaders
from repro.datasets import synthetic as jsyn
from repro.launch import env as jenv
from repro.launch.simulate import build_system as jbuild
from repro.obs import recorder as jrecorder
from repro.obs import reporter as jreporter
from repro.obs import sink as jsink
from repro.obs import timing as jtiming
from repro_torch import obs
from repro_torch.core import engine as teng
from repro_torch.core import transport as tr
from repro_torch.core import types as TT
from repro_torch.datasets import synthetic as tsyn
from repro_torch.events import EventConfig
from repro_torch.launch import env as tenv
from repro_torch.launch import simulate as tcli
from repro_torch.obs import recorder as trecorder
from repro_torch.obs import reporter as treporter
from repro_torch.obs import schema, timing

from test_torch_common import assert_states_equal, to_port, workload_pair

torch.set_num_threads(1)

SPEC = dict(n_jobs=80, duration_s=4 * 3600.0, load=1.0, trace_len=8,
            n_accounts=8, mean_wall_s=1800.0, seed=7)


@pytest.fixture(scope="module")
def case():
    """conftest's ``small_system`` and ``small_jobs`` in both packages,
    with the port's table."""
    jsystem = jbuild("marconi100", scale=64)
    system = to_port(jsystem)
    jobs = tsyn.generate(system, tsyn.WorkloadSpec(**SPEC))
    jjobs = jsyn.generate(jsystem, jsyn.WorkloadSpec(**SPEC))
    table, _ = workload_pair(jsystem, 96, **{k: v for k, v in SPEC.items()})
    return dict(system=system, jsystem=jsystem, jobs=jobs, jjobs=jjobs,
                table=table)


def run(case, n_steps=8, **kw):
    return teng.simulate(case["system"], case["table"],
                         TT.Scenario.make("fcfs", "first-fit"), 0.0,
                         n_steps * case["system"].dt, device="cpu", **kw)


# ---------------------------------------------------------------------------
# Manifests.
# ---------------------------------------------------------------------------
def test_manifest_valid_and_digest_deterministic(case):
    kw = dict(command="simulate", argv=["-t", "1h"],
              scenario={"policy": "fcfs"}, seed=7, jobs=case["jobs"])
    m1 = obs.build_manifest(case["system"], **kw)
    m2 = obs.build_manifest(case["system"], **kw)
    assert m1["system"]["digest"] == m2["system"]["digest"]
    assert m1["jobs"]["digest"] == m2["jobs"]["digest"]
    assert m1["system"]["n_nodes"] == case["system"].n_nodes
    assert m1["jobs"]["n_jobs"] == len(case["jobs"])
    v = m1["versions"]
    assert v["jax"] is None and v["torch"] == torch.__version__
    assert v["backend"] == ("cuda" if torch.cuda.is_available() else "cpu")
    assert {"python", "numpy", "cuda", "device"} <= v.keys()
    assert m1["run_id"] != m2["run_id"]
    assert schema.validate_manifest(m1) is m1


def test_manifest_equals_the_reference_s_but_for_versions(case):
    """Pinned run id, sha and clock: the same manifest as the reference's
    for the same system and jobs (the digests included), apart from the
    runtime versions, the one part the port rewrites."""
    kw = dict(command="serve", argv=["unix:/x"], scenario={"k": [1, 2.5]},
              seed=3, run_id="r", git_sha=None, created_unix=1.5,
              extra={"env_preset": {"preset": "throughput"}})
    mine = obs.build_manifest(case["system"], jobs=case["jobs"], **kw)
    theirs = jrecorder.build_manifest(case["jsystem"], jobs=case["jjobs"],
                                      **kw)
    assert mine.pop("versions").keys() >= theirs.pop("versions").keys()
    assert mine == theirs


def test_manifest_validation_names_missing_fields(case):
    m = obs.build_manifest(case["system"], command="simulate", argv=[],
                           scenario={})
    del m["seed"]
    m["argv"] = "not-a-list"
    with pytest.raises(schema.SchemaError) as e:
        schema.validate_manifest(m)
    assert "seed" in str(e.value) and "argv" in str(e.value)


def test_recorder_writes_manifest_and_events(tmp_path, case):
    mpath, epath = tmp_path / "run.json", tmp_path / "events.ndjson"
    clock = iter(float(i) for i in range(100))
    with obs.RunRecorder(manifest_path=mpath, events_path=epath,
                         clock=lambda: next(clock)) as rec:
        rec.begin(case["system"], command="simulate", argv=["-t", "1h"],
                  scenario={"policy": "fcfs"}, seed=0)
        rec.event("run_start")
        rec.event("checkpoint", path="ck.json", generation=2)
        rec.finalize(spans={"spans": {}, "counters": {}}, wall_s=1.25)
    m = obs.load_manifest(mpath)
    assert m["n_events"] == 2 and m["wall_s"] == 1.25
    frames = obs.read_frames(epath)
    assert [f["event"] for f in frames] == ["run_start", "checkpoint"]
    assert frames[1]["generation"] == 2
    assert all(f["run_id"] == m["run_id"] for f in frames)
    assert [f["seq"] for f in frames] == [0, 1]
    assert [f["t_wall"] for f in frames] == [0.0, 1.0]


def test_recorder_survives_missing_finalize(tmp_path, case):
    epath = tmp_path / "events.ndjson"
    rec = obs.RunRecorder(events_path=epath)
    rec.begin(case["system"], command="simulate", argv=[], scenario={})
    rec.event("run_start")
    rec.close()  # a crash: no finalize
    assert [f["event"] for f in obs.read_frames(epath)] == ["run_start"]


# ---------------------------------------------------------------------------
# The metrics sink.
# ---------------------------------------------------------------------------
def test_metrics_sink_file_one_frame_per_step(tmp_path, case):
    final, hist = run(case)
    path = tmp_path / "metrics.ndjson"
    with obs.MetricsSink(str(path)) as sink:
        n = obs.stream_history(sink, "run-1", case["system"], case["table"],
                               final, hist, label="fcfs:first-fit")
    assert n == 8 + 1 == sink.n_frames
    frames = obs.read_frames(path)
    metrics = [f for f in frames if f["kind"] == schema.KIND_METRICS]
    assert [f["seq"] for f in metrics] == list(range(8))
    for f in metrics:
        assert f["label"] == "fcfs:first-fit" and f["data"]["pue"] >= 1.0
        assert len(f["data"]["t_basin_hall"]) == \
            case["system"].cooling.n_halls
    assert frames[-1]["kind"] == schema.KIND_SUMMARY
    assert frames[-1]["data"]["jobs_completed"] >= 0.0
    # the frames are the reference's frames of the same host history
    host = {k: getattr(hist, k).numpy() for k in
            ("t",) + obs.SCALAR_FIELDS + obs.HALL_FIELDS}
    want = list(jsink.history_frames("run-1", SimpleNamespace(**host),
                                     label="fcfs:first-fit"))
    assert metrics == want


@pytest.mark.parametrize("family", ["tcp", "unix"])
def test_metrics_sink_socket_roundtrip(tmp_path, case, family):
    final, hist = run(case, n_steps=4)
    if family == "tcp":
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.bind(("127.0.0.1", 0))
        target = f"tcp:127.0.0.1:{srv.getsockname()[1]}"
    else:
        srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        srv.bind(str(tmp_path / "m.sock"))
        target = f"unix:{tmp_path / 'm.sock'}"
    srv.listen(1)
    srv.settimeout(30.0)
    got = []

    def serve():
        conn, _ = srv.accept()
        with conn, conn.makefile("rb") as rf:
            while True:
                try:
                    got.append(tr.read_frame(rf))
                except ConnectionError:
                    break

    th = threading.Thread(target=serve, daemon=True)
    th.start()
    with obs.MetricsSink(target) as sink:
        obs.stream_history(sink, "run-s", case["system"], case["table"],
                           final, hist)
    th.join(timeout=30.0)
    srv.close()
    assert not th.is_alive()
    assert len(got) == 4 + 1
    assert got[0]["kind"] == schema.KIND_METRICS
    assert got[-1]["kind"] == schema.KIND_SUMMARY


def test_metrics_sink_rejects_bad_tcp_target():
    with pytest.raises(ValueError):
        obs.MetricsSink("tcp:no-port-here")


# ---------------------------------------------------------------------------
# Span timer and latency histogram.
# ---------------------------------------------------------------------------
def test_span_timer_deterministic_clock_and_listener():
    events = []
    clock = iter([0.0, 1.5, 2.0, 2.25]).__next__
    timer = obs.SpanTimer(clock=clock,
                          listener=lambda what, f: events.append((what, f)))
    with timer.span("engine.compile", system="x"):
        pass
    with timer.span("engine.scan"):
        pass
    timer.count("hit", 2)
    s = timer.summary()
    assert s["spans"]["engine.compile"]["total_s"] == 1.5
    assert s["spans"]["engine.scan"]["total_s"] == 0.25
    assert s["counters"] == {"hit": 2}
    assert [e[0] for e in events] == ["span_start", "span_end"] * 2
    assert events[1][1] == {"span": "engine.compile", "dur_s": 1.5,
                            "system": "x"}


def test_span_is_recorded_when_the_body_raises():
    timer = obs.SpanTimer()
    with pytest.raises(KeyError):
        with obs.use(timer), obs.maybe_span("x"):
            raise KeyError("boom")
    assert timer.summary()["spans"]["x"]["count"] == 1
    assert timing.current() is None
    with obs.maybe_span("y") as sp:
        assert sp is None                       # no timer: a no-op


def test_timer_registry_is_per_thread():
    timer, seen = obs.SpanTimer(), []
    with obs.use(timer):
        th = threading.Thread(target=lambda: seen.append(timing.current()))
        th.start()
        th.join(timeout=10.0)
        assert timing.current() is timer
    assert seen == [None] and timing.current() is None


def test_latency_histogram_buckets():
    h = obs.LatencyHistogram()
    for d in (5e-4, 0.02, 0.02, 250.0):
        h.record(d)
    s = h.summary()
    assert s["count"] == 4 and s["max_s"] == 250.0
    assert s["buckets"]["le_0.001s"] == 1
    assert s["buckets"]["le_0.1s"] == 2
    assert s["buckets"]["overflow"] == 1
    assert obs.LatencyHistogram().summary()["min_s"] == 0.0


# ---------------------------------------------------------------------------
# Observed runs: the same result, the same operations.
# ---------------------------------------------------------------------------
class CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def entry_points(case):
    """Each engine entry point once, on the CPU, events on."""
    system, table = case["system"], case["table"]
    scen = TT.Scenario.make("sjf", "easy", node_fail_rate=2e-4,
                            failure_seed=3.0)
    t1 = 6 * system.dt
    ev = EventConfig()
    out = [teng.simulate(system, table, scen, 0.0, t1, events=ev,
                         device="cpu"),
           teng.simulate_static(system, table, "fcfs", "easy", 0.0, t1,
                                device="cpu"),
           teng.simulate_sweep(system, table,
                               [scen, TT.Scenario.make("fcfs", "none")],
                               0.0, t1, events=ev, device="cpu")]
    carry = out[0][0]
    out.append(teng.simulate_segment(system, table, carry, scen, 3,
                                     events=ev, device="cpu"))
    out.append(teng.simulate_segment_sweep(system, table, [carry, carry],
                                           [scen, scen], 3, events=ev,
                                           device="cpu"))
    return out


def test_observed_run_equals_unobserved(case, monkeypatch):
    syncs = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a, **k: syncs.append(a))
    entry_points(case)      # once unobserved first: one-time set-up ops
    plain_ops, observed_ops = CountOps(), CountOps()
    with plain_ops:
        plain = entry_points(case)
    timer = obs.SpanTimer()
    with obs.use(timer), observed_ops:
        observed = entry_points(case)
    for (f0, h0), (f1, h1) in zip(plain, observed):
        assert_states_equal(f0, f1, "final ")
        assert_states_equal(h0, h1, "history ")
    assert plain_ops.n == observed_ops.n > 0
    assert syncs == []                          # the CPU never synchronises
    spans = timer.summary()["spans"]
    assert list(spans) == ["engine.scan"] and spans["engine.scan"]["count"] \
        == len(plain)
    assert [sp.meta["n_steps"] for sp in timer.spans] == [6, 6, 6, 3, 3]
    assert [sp.meta["n_scenarios"] for sp in timer.spans] == [1, 1, 2, 1, 2]
    assert timing.current() is None


# ---------------------------------------------------------------------------
# The CLI's flight recorder.
# ---------------------------------------------------------------------------
def cli_args(tmp_path, i, *extra):
    return ["--system", "marconi100", "--scale", "64", "--jobs", "20",
            "-t", "10m", "--policy", "fcfs", "--device", "cpu",
            "--manifest", str(tmp_path / f"run{i}.json"),
            "--metrics", str(tmp_path / f"metrics{i}.ndjson"),
            "--events", str(tmp_path / f"events{i}.ndjson"), *extra]


def test_simulate_cli_flight_recorder_deterministic(tmp_path, capsys):
    outs = []
    for i in (1, 2):
        tcli.main(cli_args(tmp_path, i, "--quiet", "--json"))
        doc = json.loads(capsys.readouterr().out)
        outs.append((obs.load_manifest(tmp_path / f"run{i}.json"),
                     obs.read_frames(tmp_path / f"metrics{i}.ndjson"),
                     obs.read_frames(tmp_path / f"events{i}.ndjson"), doc))
    (m1, fr1, ev1, doc1), (m2, fr2, _, doc2) = outs
    assert m1["system"]["digest"] == m2["system"]["digest"]
    assert m1["jobs"]["digest"] == m2["jobs"]["digest"]
    assert m1["run_id"] != m2["run_id"]
    n_steps = int(round(600.0 / m1["system"]["dt"]))
    metrics1 = [f for f in fr1 if f["kind"] == schema.KIND_METRICS]
    assert len(metrics1) == n_steps
    strip = lambda fs: [{k: v for k, v in f.items() if k != "run_id"}
                        for f in fs]
    assert strip(fr1) == strip(fr2)
    assert m1["counters"]["metrics_frames"] == len(fr1)
    assert m1["spans"]["spans"]["engine.scan"]["count"] == 1
    assert [f["event"] for f in ev1] == ["run_start", "span_start",
                                         "span_end", "run_end"]
    assert m1["summaries"] == m2["summaries"] == doc1 == doc2
    assert m1["versions"]["jax"] is None
    # the digests are the JAX CLI's for the same loader and seed
    jsystem = jbuild("marconi100", scale=64)
    js = jloaders.load("marconi100", n_jobs=20, days=0.5, seed=0)
    assert m1["system"]["digest"] == jtr.system_digest(jsystem)
    assert m1["jobs"]["digest"] == jtr.job_digest(js)


def test_simulate_cli_profile_writes_a_chrome_trace(tmp_path, capsys):
    tcli.main(["--system", "marconi100", "--scale", "64", "--jobs", "10",
               "-t", "2m", "--device", "cpu", "--quiet",
               "--profile", str(tmp_path / "prof")])
    assert "policy=replay" in capsys.readouterr().out
    trace = json.loads((tmp_path / "prof" / "trace.json").read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert any(n and n.startswith("aten::") for n in names)


@pytest.mark.parametrize("sub", ["train", "calibrate"])
def test_simulate_cli_refuses_unported_subcommands(sub):
    with pytest.raises(SystemExit, match="not ported"):
        tcli.main([sub, "--smoke"])


# ---------------------------------------------------------------------------
# Frames on the wire (tests/test_obs_properties.py).
# ---------------------------------------------------------------------------
any_float = st.floats(allow_nan=True, allow_infinity=True, width=64)
telemetry = st.dictionaries(
    st.text(alphabet="abcdefghijklmnopqrstuvwxyz_", min_size=1, max_size=24),
    st.one_of(any_float, st.lists(any_float, min_size=1, max_size=64),
              st.integers(-2**40, 2**40)),
    max_size=24)


@given(telemetry, st.integers(0, 2**31), any_float)
@settings(max_examples=100, deadline=None)
def test_metrics_frame_roundtrips_and_is_strict_json(data, seq, t_sim):
    t_sim = t_sim if math.isfinite(t_sim) else 0.0
    frame = schema.metrics_frame("run-prop", seq, t_sim, data, label="x")
    buf = io.BytesIO()
    tr.write_frame(buf, schema.validate_frame(frame))
    raw = buf.getvalue()
    assert b"NaN" not in raw and b"Infinity" not in raw
    buf.seek(0)
    assert tr.read_frame(buf) == frame


# ---------------------------------------------------------------------------
# The copies.
# ---------------------------------------------------------------------------
def body(mod):
    src = inspect.getsource(mod)
    return src[src.index("from __future__"):]


def test_copies_are_the_reference_s():
    """``timing.py`` and ``launch/env.py`` are the reference's below the
    module docstring; ``reporter.py`` too, on the ``repro_torch`` logger;
    ``recorder.py`` too but for ``runtime_versions``."""
    assert body(timing) == body(jtiming)
    assert body(tenv) == body(jenv)
    assert body(treporter) == re.sub(r"\brepro\b", "repro_torch",
                                     body(jreporter))
    versions = re.compile(r"def runtime_versions.*?\n\n\n", re.S)
    mine = versions.sub("", body(trecorder))
    theirs = versions.sub("", re.sub(r"\brepro\.", "repro_torch.",
                                     body(jrecorder)))
    assert mine == theirs
    assert tenv.report("throughput") == jenv.report("throughput")


def test_reporter_splits_results_from_progress():
    out, progress = io.StringIO(), io.StringIO()
    rep = obs.Reporter(json_mode=True, stream=out)
    handler = logging.StreamHandler(progress)
    rep.logger.addHandler(handler)
    try:
        rep.info("progress %s", 1)
    finally:
        rep.logger.removeHandler(handler)
    rep.result("text", key="a", value=np.float32(1.5))
    rep.result_json("b", [np.inf])
    rep.flush_json()
    assert json.loads(out.getvalue()) == {"a": 1.5, "b": [None]}
    assert progress.getvalue() == "progress 1\n"
    assert rep.logger.name == "repro_torch" and not rep.logger.propagate
