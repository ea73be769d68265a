"""The port's twin service on the wire (``repro_torch.serve.server``,
``protocol`` and ``cli``), driven by the reference's own stdlib client
(``tools/twin_client.py``), against itself and against the JAX server.

The reference's contract (``src/repro/serve/server.py``,
``tests/test_serve_soak.py``, ``tests/test_binary_wire.py``):

* coalescing is throughput only: a fork tree advanced over the wire by
  concurrent clients, in whatever batches the executor forms, equals the
  same tree advanced serially in process, bit for bit, in rows and in the
  ``raw_digest`` at every checkpoint. The tests read the batches from the
  session's counters and assume no count;
* broken speech gets a ``protocol`` error and a closed connection; a
  well-formed but invalid request a ``session`` error on a connection
  that stays up, the session untouched; no client kills the server;
* the zero-zombie ledger: after ``close()`` no connection is open and no
  handler thread is alive.

Against JAX: one scripted conversation with the JAX ``TwinServer`` and
the port's on the same 64-node case and seed gives the same frames: the
same kinds and keys, equal system and job digests, exact integers, equal
error envelopes, floats within 1e-4.

Every subprocess has a timeout of its own and the servers reap hung
clients after a short ``client_timeout_s``.
"""
import inspect
import json
import pathlib
import re
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from repro.core import types as JT
from repro.datasets import synthetic as jsyn
from repro.launch.simulate import build_system as jbuild
from repro.serve import cli as jcli
from repro.serve import protocol as jprotocol
from repro.serve import server as jserver
from repro.serve import session as jsession
from repro_torch.core import transport as tr
from repro_torch.core import types as TT
from repro_torch.datasets import synthetic as tsyn
from repro_torch.events import EventConfig
from repro_torch.obs import read_frames
from repro_torch.serve import SessionError, TwinServer, TwinSession
from repro_torch.serve import cli as tcli
from repro_torch.serve import protocol as tprotocol
from repro_torch.serve import server as tserver
from repro_torch.serve import snapshot as snap
from tools.twin_client import TwinClient, TwinError

from test_torch_common import to_port

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
INTERVAL = 8
HORIZON_S = 2 * 3600.0
RTOL = 1e-4
SPEC = dict(n_jobs=80, duration_s=4 * 3600.0, load=1.0, trace_len=8,
            n_accounts=8, mean_wall_s=1800.0, seed=7)
# the reference soak test's fork tree, with a failure fork for its
# event layer (sessions below run with events=EventConfig(), zero rates)
DELTAS = [{}, {"setpoint_delta_c": 2.0}, {"cap_scale": 0.85},
          {"node_fail_rate": 2e-4, "cdu_fail_rate": 5e-5,
           "failure_corr": 0.5, "failure_seed": 7.0, "repair_s": 600.0}]


@pytest.fixture(scope="module")
def case():
    """conftest's ``small_system``/``small_jobs``/``small_table`` in both
    packages (marconi100 at 64 nodes, 80 jobs padded to 96)."""
    jsystem = jbuild("marconi100", scale=64)
    system = to_port(jsystem)
    jobs = tsyn.generate(system, tsyn.WorkloadSpec(**SPEC))
    jjobs = jsyn.generate(jsystem, jsyn.WorkloadSpec(**SPEC))
    for js in (jobs, jjobs):
        js.assign_prepop_placement(0.0, system.n_nodes)
    return dict(system=system, jobs=jobs, table=jobs.to_table(96),
                jsystem=jsystem, jjobs=jjobs, jtable=jjobs.to_table(96))


def session(case, **kw):
    return TwinSession(case["system"], case["table"],
                       TT.Scenario.make("fcfs", "easy"), 0.0, HORIZON_S,
                       interval_steps=INTERVAL, num_accounts=8,
                       device="cpu", **kw)


def spawn_client(addr, script=None, fault=None, timeout=30.0):
    cmd = [sys.executable, "-m", "tools.twin_client", "--connect", addr,
           "--timeout", str(timeout)]
    if script is not None:
        cmd += ["--script", script]
    if fault is not None:
        cmd += ["--fault", fault]
    return subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def drain(procs, deadline_s=120.0):
    """wait() every spawned client; return (rc, stdout lines, stderr) per
    process. A client past the deadline is killed and the test fails."""
    out = []
    t_end = time.monotonic() + deadline_s
    try:
        for p in procs:
            stdout, stderr = p.communicate(
                timeout=max(1.0, t_end - time.monotonic()))
            out.append((p.returncode, stdout.splitlines(), stderr))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        raise
    return out


def assert_reaped(procs, stats, server):
    """Zero zombies: every client waited for, every connection closed,
    no handler thread alive."""
    for p in procs:
        assert p.poll() is not None, f"client pid {p.pid} not reaped"
    assert stats["n_open"] == 0, stats["clients"]
    assert not any(c.thread.is_alive() for c in server.clients)
    assert not server._accept_thread.is_alive()
    assert not server._exec_thread.is_alive()


# ---------------------------------------------------------------------------
# Clients, faults and the ledger (tests/test_serve_soak.py).
# ---------------------------------------------------------------------------
def test_concurrent_clients_fork_and_advance(case, tmp_path):
    """Four client processes, one session: each forks its own what-if and
    drives it to a different depth; all exit 0, the fork count is exact,
    and the flight recorder saw the traffic."""
    addr = f"unix:{tmp_path}/twin.sock"
    n_clients = 4
    srv = TwinServer(session(case), addr, jobs=case["jobs"],
                     batch_window_s=0.05, obs_dir=tmp_path,
                     client_timeout_s=10.0)
    with srv:
        procs = [spawn_client(addr, script=(
            f"advance 0 1; fork 0 setpoint_delta_c={0.5 * (i + 1)}; "
            f"advance last {1 + i % 3}; fetch last; snapshot last; bye"))
            for i in range(n_clients)]
        results = drain(procs)
        stats = srv.stats()
    final = srv.close()
    for rc, lines, stderr in results:
        assert rc == 0, stderr
        kinds = [json.loads(line)["kind"] for line in lines]
        assert kinds[0] == "hello" and kinds[-1] == "bye_ok"
        assert "error" not in kinds, lines
    assert stats["session"]["forks"] == n_clients
    assert final["n_clients"] == n_clients
    assert_reaped(procs, final, srv)
    manifest = json.loads((tmp_path / "serve_manifest.json").read_text())
    assert manifest["command"] == "serve"
    assert manifest["versions"]["jax"] is None
    assert manifest["counters"]["session"]["forks"] == n_clients
    assert manifest["jobs"]["digest"] == tr.job_digest(case["jobs"])
    what = [f["event"] for f in read_frames(tmp_path /
                                            "serve_events.ndjson")]
    assert what.count("client_connect") == n_clients
    assert what.count("client_disconnect") == n_clients
    assert "advance_batch" in what and "fork" in what
    assert what[0] == "server_start" and what[-1] == "server_stop"


def test_fault_injection_never_kills_the_server(case, tmp_path):
    """Every documented misbehaviour at once: the faults get their
    envelopes, the session survives, a late client gets full service,
    and the healthy client's rows are those of the same requests made
    with no fault around."""
    addr = f"unix:{tmp_path}/twin.sock"
    healthy = "advance 0 1; fork 0 cap_scale=0.9; advance last 2; " \
              "fetch last; bye"
    sess = session(case)
    srv = TwinServer(sess, addr, jobs=case["jobs"], batch_window_s=0.02,
                     client_timeout_s=2.0)
    with srv:
        procs = [
            spawn_client(addr, script=healthy),
            spawn_client(addr, fault="die:2",
                         script="advance 0 1; state; state; state"),
            spawn_client(addr, fault="garbage"),
            spawn_client(addr, fault="badbranch"),
            spawn_client(addr, fault="hang", timeout=10.0),
        ]
        results = drain(procs)
        late = spawn_client(addr, script="advance 999999 1; "
                                         "fork 0 cells_offline=1,2; "
                                         "state; advance 0 1; bye")
        late_rc, late_lines, late_err = drain([late])[0]
        final_state = sess.describe()
    stats = srv.close()

    healthy_rc, healthy_lines, healthy_err = results[0]
    assert healthy_rc == 0, healthy_err
    assert "error" not in [json.loads(l)["kind"] for l in healthy_lines]
    assert results[1][0] == 1                   # os._exit(1) mid-stream
    garbage = json.loads(results[2][1][-1])
    assert garbage["kind"] == "error" and garbage["error"] == "protocol"
    bad = json.loads(results[3][1][-1])
    assert bad == {"version": 1, "kind": "error", "error": "session",
                   "id": 0, "message": bad["message"]}
    assert "unknown branch" in bad["message"]
    assert results[4][0] == 0                   # the hanger, reaped
    assert late_rc == 0, late_err
    assert [json.loads(l)["kind"] for l in late_lines] == \
        ["hello", "error", "error", "state_ok", "advance_ok", "bye_ok"]
    assert "scalar in this session" in json.loads(late_lines[2])["message"]

    branches = {b["branch"]: b for b in final_state["branches"]}
    assert len(branches) == 2                   # root + the healthy fork
    fork = branches[max(branches)]
    assert fork["delta"] == {"cap_scale": 0.9}
    assert fork["step"] == fork["born_step"] + 2 * INTERVAL
    assert stats["session"]["errors"] >= 2
    assert_reaped(procs + [late], stats, srv)
    reasons = sorted(c["reason"] for c in stats["clients"])
    assert reasons.count("bye") == 3 and "protocol-error" in reasons

    # the healthy client's rows, as the same requests give them in
    # process on a session no faulty client touched (its fork point
    # depends on the dying client's advance of the root, so it is read
    # from the reply)
    fetched = [json.loads(l) for l in healthy_lines
               if json.loads(l)["kind"] == "fetch_ok"][0]
    clean = session(case)
    clean.advance_many({0: fetched["start"] // INTERVAL})
    child = clean.fork(0, {"cap_scale": 0.9}).branch_id
    clean.advance_many({child: 2})
    assert fetched["rows"] == json.loads(json.dumps(
        clean.fetch(child)["rows"]))


def test_close_reaps_idle_connections(case, tmp_path):
    """Clients still connected at ``close()``: every handler is joined,
    every connection closed, the ledger keeps one row per connection."""
    srv = TwinServer(session(case), f"unix:{tmp_path}/twin.sock")
    clients = [TwinClient(srv.address, timeout_s=10.0) for _ in range(3)]
    clients[0].state()
    deadline = time.monotonic() + 10.0
    while srv.stats()["n_clients"] < 3 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert srv.stats()["n_open"] == 3
    stats = srv.close()
    assert stats["n_clients"] == 3 and stats["n_open"] == 0
    assert not any(c.thread.is_alive() for c in srv.clients)
    for c in clients:
        with pytest.raises((ConnectionError, OSError)):
            c.state()
        c.close(polite=False)


def test_executor_survives_unexpected_dispatch_failure(case, tmp_path,
                                                       monkeypatch):
    """A batch whose dispatch raises something other than a
    ``SessionError`` gets an error envelope and the executor keeps
    serving; nothing is retried elsewhere."""
    sess = session(case)
    with TwinServer(sess, f"unix:{tmp_path}/twin.sock") as srv:
        real = sess.advance_many
        monkeypatch.setattr(sess, "advance_many", lambda requests: (
            _ for _ in ()).throw(RuntimeError("synthetic dispatch error")))
        with pytest.raises(SessionError, match="synthetic dispatch error"):
            srv._advance(0, 1)
        assert srv._exec_thread.is_alive()
        with TwinClient(srv.address, timeout_s=10.0) as c:
            with pytest.raises(TwinError) as e:
                c.advance(0, 1)
            assert e.value.error == "session"
            monkeypatch.setattr(sess, "advance_many", real)
            assert c.advance(0, 1)["advanced_steps"] == INTERVAL
    assert sess.counters["errors"] == 2
    assert sess.branches[0].step == INTERVAL


def test_advance_racing_shutdown_fails_fast(case, tmp_path):
    srv = TwinServer(session(case), f"unix:{tmp_path}/twin.sock")
    srv.close()
    t = time.perf_counter()
    with pytest.raises(SessionError, match="shutting down"):
        srv._advance(0, 1)
    assert time.perf_counter() - t < 1.0


# ---------------------------------------------------------------------------
# Coalescing over the wire is unobservable.
# ---------------------------------------------------------------------------
def serial_tree(case, advances):
    """The tree in process, one branch at a time."""
    sess = session(case, events=EventConfig())
    sess.advance_many({0: 2})
    ids = [sess.fork(0, d).branch_id for d in DELTAS]
    for b in [0] + ids:
        sess.advance_many({b: advances})
    return sess


@pytest.mark.parametrize("window", [0.0, 0.2])
def test_wire_tree_equals_serial_in_process(case, tmp_path, window):
    """Five client threads advance their own branch of one fork tree at
    once, in steps of one interval; whatever batches the executor forms
    (read from the counters), every row and every checkpoint's digest
    equals the tree advanced serially in process."""
    advances = 3
    sess = session(case, events=EventConfig())
    srv = TwinServer(sess, f"unix:{tmp_path}/twin.sock", jobs=case["jobs"],
                     batch_window_s=window, client_timeout_s=30.0)
    with srv:
        with TwinClient(srv.address, timeout_s=60.0) as c:
            c.advance(0, 2)
            ids = [c.fork(0, d)["branch"] for d in DELTAS]
        branches = [0] + ids
        barrier, errors = threading.Barrier(len(branches)), []

        def drive(b):
            try:
                with TwinClient(srv.address, timeout_s=60.0) as c:
                    barrier.wait(timeout=30.0)
                    for _ in range(advances):
                        c.advance(b, 1)
            except Exception as e:   # noqa: BLE001 - reported below
                errors.append((b, e))

        threads = [threading.Thread(target=drive, args=(b,))
                   for b in branches]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120.0)
        assert not any(th.is_alive() for th in threads) and not errors
        with TwinClient(srv.address, timeout_s=60.0) as c:
            wire = {b: (c.fetch(b)["rows"],
                        {s: c.snapshot(b, at_step=s)["raw_digest"]
                         for s in sess.branches[b].checkpoints})
                    for b in branches}
    counters = srv.close()["session"]
    # every branch-interval ran once, in batches the executor chose
    assert counters["segments"] == 2 + len(branches) * advances
    assert counters["batched_branches"] <= len(branches) * advances
    assert counters["batched_branches"] >= 2 * counters["coalesced_batches"]
    serial = serial_tree(case, advances)
    assert serial.counters["coalesced_batches"] == 0
    for b in branches:
        rows, digests = wire[b]
        assert rows == json.loads(json.dumps(serial.fetch(b)["rows"])), \
            f"branch {b} rows"
        assert sorted(digests) == sorted(serial.branches[b].checkpoints)
        for step, d in digests.items():
            assert d == serial.snapshot(b, at_step=step)["raw_digest"], \
                f"branch {b} step {step}"
    assert sum(r["nodes_down"] for r in wire[ids[3]][0]) > 0


def request(sock_file, msg):
    """One request over the port's own framing; the reply as arrays."""
    rfile, wfile = sock_file
    tr.write_frame(wfile, dict({"version": 1}, **msg))
    return tr.read_any_frame(rfile)


def test_binary_snapshot_and_fetch_equal_json_over_live_server(case,
                                                               tmp_path):
    sess = session(case)
    with TwinServer(sess, f"unix:{tmp_path}/twin.sock") as srv:
        with TwinClient(srv.address, timeout_s=30.0) as c:
            c.advance(0, 2)
            sj, sb = c.snapshot(0), c.snapshot(0, binary=True)
            fj, fb = c.fetch(0), c.fetch(0, binary=True)
        family, addr = tr.parse_address(srv.address)
        with socket.socket(family, socket.SOCK_STREAM) as s:
            s.settimeout(30.0)
            s.connect(addr)
            files = (s.makefile("rb"), s.makefile("wb"))
            assert tr.read_any_frame(files[0])["kind"] == "hello"
            raw = request(files, {"kind": "snapshot", "branch": 0,
                                  "bin": True})
            cols = request(files, {"kind": "fetch", "branch": 0,
                                   "bin": True})["cols"]
            for f in files:
                f.close()
    assert sj["raw_digest"] == sb["raw_digest"] == raw["raw_digest"]
    assert "digest" in sj and "digest" not in sb
    assert set(sb["snapshot"]["leaves"]) == set(sj["snapshot"]["leaves"])
    assert snap.carry_digest(raw["snapshot"]) == sj["raw_digest"]
    from_json = snap.decode_carry(sj["snapshot"], sess.carry_template)
    from_bin = snap.decode_carry(raw["snapshot"], sess.carry_template)
    assert snap.carry_digest(snap.encode_carry(from_json, binary=True)) == \
        snap.carry_digest(snap.encode_carry(from_bin, binary=True))
    # the client's binary columns, the port's arrays and the JSON rows
    assert "cols" in fb and "rows" not in fb
    rows = fj["rows"]
    assert len(rows) == 2 * INTERVAL == cols["step"].shape[0]
    for k, col in fb["cols"].items():
        assert col["values"] == cols[k].tolist()
        assert col["values"] == [r[k] for r in rows], k


def test_serve_subcommand_on_cpu(tmp_path):
    """``python -m repro_torch.launch.simulate serve --device cpu``: the
    startup line, a scripted client, the final ``served`` line."""
    addr = f"unix:{tmp_path}/twin.sock"
    cmd = [sys.executable, "-m", "repro_torch.launch.simulate", "serve",
           "--device", "cpu", "--listen", addr, "--system", "marconi100",
           "--scale", "64", "--jobs", "40", "-t", "50m",
           "--interval-steps", "8", "--max-seconds", "90",
           "--obs-dir", str(tmp_path)]
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
           "HOME": str(tmp_path)}
    proc = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env)
    try:
        start = json.loads(proc.stdout.readline())
        assert start["serving"] == addr and start["n_nodes"] == 64
        # 50 min of 20 s steps is 150, rounded down to whole intervals
        assert start["horizon_steps"] == 144
        client = drain([spawn_client(addr, script="advance 0 2; fetch 0; "
                                     "state; shutdown")])[0]
        out, err = proc.communicate(timeout=60.0)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err
    assert client[0] == 0, client[2]
    replies = [json.loads(l) for l in client[1]]
    assert [r["kind"] for r in replies] == ["hello", "advance_ok",
                                            "fetch_ok", "state_ok",
                                            "shutdown_ok"]
    assert replies[0]["system"]["n_nodes"] == 64
    assert len(replies[2]["rows"]) == 2 * 8
    served = json.loads(out.splitlines()[-1])
    assert served["served"] == 1
    assert served["session"]["segments"] == 2
    assert (tmp_path / "serve_manifest.json").exists()


# ---------------------------------------------------------------------------
# Against the JAX server: one conversation, the same frames.
# ---------------------------------------------------------------------------
def conversation(address):
    """hello, advance, a fork with a setpoint delta, both advanced, fetch
    in both dialects, snapshot, state, a session error, bye; then on a
    second connection a protocol error, after which the twin hangs up."""
    frames = []
    c = TwinClient(address, timeout_s=120.0)
    frames.append(c.hello)
    frames.append(c.advance(0, 2))
    frames.append(c.fork(0, {"setpoint_delta_c": 2.0}))
    frames.append(c.advance(0, 1))
    frames.append(c.advance(1, 1))
    frames.append(c.fetch(1))
    frames.append(c.fetch(0, binary=True))
    frames.append(c.snapshot(1))
    frames.append(c.state())
    with pytest.raises(TwinError) as e:
        c.advance(999, 1)
    frames.append(e.value.frame)
    frames.append(c.request("bye"))
    c.close(polite=False)
    c = TwinClient(address, timeout_s=120.0)
    frames.append(c.hello)
    c._write({"version": 1, "kind": "advance", "branch": "zero", "id": 7})
    frames.append(c._read())
    with pytest.raises(ConnectionError):
        c._read()
    c.close(polite=False)
    return frames


def assert_frames_match(mine, theirs, path="frame"):
    """Same structure, same keys; integers, strings and digests exact;
    floats within RTOL (a snapshot's leaves are decoded first)."""
    if isinstance(theirs, dict):
        assert mine.keys() == theirs.keys(), path
        if "dtype" in theirs and "values" in theirs:   # client bin columns
            assert mine["dtype"] == theirs["dtype"], path
            assert mine["shape"] == theirs["shape"], path
            assert_frames_match(mine["values"], theirs["values"], path)
            return
        for k in theirs:
            if k == "leaves":
                assert_leaves_match(mine[k], theirs[k], path)
            elif k in ("digest", "raw_digest") and path.endswith("snapshot_ok"):
                continue      # carries of two frameworks: floats differ
            else:
                assert_frames_match(mine[k], theirs[k], f"{path}.{k}")
    elif isinstance(theirs, list):
        assert len(mine) == len(theirs), path
        for i, (a, b) in enumerate(zip(mine, theirs)):
            assert_frames_match(a, b, f"{path}[{i}]")
    elif isinstance(theirs, float):
        assert isinstance(mine, float), path
        np.testing.assert_allclose(mine, theirs, rtol=RTOL, err_msg=path)
    else:
        assert type(mine) is type(theirs) and mine == theirs, path


def assert_leaves_match(mine, theirs, path):
    assert mine.keys() == theirs.keys(), path
    for k in theirs:
        a, b = snap.decode_array(mine[k]), snap.decode_array(theirs[k])
        assert a.dtype == b.dtype and a.shape == b.shape, f"{path} {k}"
        if np.issubdtype(b.dtype, np.floating):
            np.testing.assert_allclose(a, b, rtol=RTOL, err_msg=f"{path} {k}")
        else:
            assert np.array_equal(a, b), f"{path} {k}"


def test_conversation_matches_the_jax_server(case, tmp_path):
    port = TwinServer(session(case), f"unix:{tmp_path}/port.sock",
                      jobs=case["jobs"], client_timeout_s=120.0)
    ref = jserver.TwinServer(
        jsession.TwinSession(case["jsystem"], case["jtable"],
                             JT.Scenario.make("fcfs", "easy"), 0.0,
                             HORIZON_S, interval_steps=INTERVAL,
                             num_accounts=8),
        f"unix:{tmp_path}/ref.sock", jobs=case["jjobs"],
        client_timeout_s=120.0)
    try:
        mine, theirs = conversation(port.address), conversation(ref.address)
    finally:
        pstats, rstats = port.close(), ref.close()
    assert [f["kind"] for f in mine] == [f["kind"] for f in theirs] == [
        "hello", "advance_ok", "fork_ok", "advance_ok", "advance_ok",
        "fetch_ok", "fetch_ok", "snapshot_ok", "state_ok", "error",
        "bye_ok", "hello", "error"]
    assert mine[0] == theirs[0]                 # digests, window, caps
    assert mine[0]["jobs"]["digest"] == tr.job_digest(case["jobs"])
    for i, (a, b) in enumerate(zip(mine, theirs)):
        assert_frames_match(a, b, f"frame {i} {b['kind']}")
    assert mine[9] == theirs[9]                 # the session error, exact
    assert mine[12] == theirs[12]               # the protocol error
    assert mine[9]["error"] == "session" and mine[12]["error"] == "protocol"
    assert pstats["session"] == rstats["session"]
    assert pstats["n_open"] == rstats["n_open"] == 0
    assert [c["reason"] for c in pstats["clients"]] == \
        [c["reason"] for c in rstats["clients"]] == ["bye", "protocol-error"]


# ---------------------------------------------------------------------------
# The copies.
# ---------------------------------------------------------------------------
def body(mod):
    src = inspect.getsource(mod)
    return re.sub(r"\brepro\.", "repro_torch.",
                  src[src.index("from __future__"):])


def test_protocol_server_and_cli_are_the_reference_s():
    """Below the module docstring, ``protocol.py`` and ``server.py`` are
    the reference's; ``cli.py`` too, but for its named departures:
    ``--device`` and its use, and one help string's doc link."""
    assert body(tprotocol) == body(jprotocol)
    assert body(tserver) == body(jserver)
    theirs = body(jcli).replace(
        '"event log under DIR (docs/observability.md)")',
        '"event log under DIR")')
    mine = body(tcli).replace(
        '''    ap.add_argument("--device", default="cuda",
                    help="torch device of the session (default cuda; cpu "
                         "only on request)")
''', "").replace(''',
                          device=args.device)''', ")")
    assert mine == theirs
    assert tprotocol.REQUEST_KINDS == jprotocol.REQUEST_KINDS
    assert tprotocol.SERVE_VERSION == jprotocol.SERVE_VERSION
