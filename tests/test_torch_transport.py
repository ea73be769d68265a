"""The port's out-of-process scheduler peers (``repro_torch.core.transport``
``SocketPeer`` / ``SubprocessPeer``) against the stdlib reference peer
``tools/reference_peer.py``, run unmodified as a subprocess and with
``--listen``.

The conformance half holds the process boundary invisible: plugin-mode
telemetry is bit for bit the same with the in-process ``FastSimLike``
and with the peer over each wire dialect, and equals the JAX package's
run at rtol 1e-4. The fault half drives every ``--fault`` mode of the
peer through both packages' bridges: each ends in ``ProtocolError`` or
``BridgeTimeout``, or heals, within its deadline, and no peer process is
left unreaped. pytest-timeout is not enforced here, so every subprocess,
socket and thread join below carries a deadline of its own.
"""
import importlib.util
import pathlib
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from repro.core import external as jext  # noqa: E402
from repro.core import transport as jtr  # noqa: E402
from repro.datasets import synthetic as jsyn  # noqa: E402
from repro.systems.config import get_system  # noqa: E402
from repro_torch.core import external as text  # noqa: E402
from repro_torch.core import transport as ttr  # noqa: E402
from repro_torch.datasets import synthetic as tsyn  # noqa: E402
from test_torch_common import assert_jobsets_equal, to_port  # noqa: E402
from test_torch_external import assert_plugin_match  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
PEER = [sys.executable, str(ROOT / "tools" / "reference_peer.py")]
SYS = get_system("frontier").scaled(64)
TSYS = to_port(SYS)
HANDSHAKE_S = 30.0           # spawn + hello + reset_ack budget
# (module, transport, system, extra keyword arguments of the coupling
# modes, index of the job set in jobs_pair's pair)
PKGS = {"jax": (jext, jtr, SYS, {}, 1),
        "port": (text, ttr, TSYS, {"device": "cpu"}, 0)}


def jobs_pair(seed, n=30):
    spec = dict(n_jobs=n, duration_s=2 * 3600.0, load=1.2, trace_len=4,
                seed=seed)
    jjs = jsyn.generate(SYS, jsyn.WorkloadSpec(**spec))
    tjs = tsyn.generate(TSYS, tsyn.WorkloadSpec(**spec))
    assert_jobsets_equal(jjs, tjs, "jobs")
    return tjs, jjs


def make_peer(tr, *fault, **kw):
    cmd = PEER + (["--fault", fault[0]] if fault else [])
    kw.setdefault("handshake_timeout_s", HANDSHAKE_S)
    return tr.SubprocessPeer(cmd=cmd, **kw)


def assert_reaped(peer):
    """Every process the peer ever spawned has been wait()ed."""
    assert peer._proc is None, "peer process still attached after close"
    assert peer.spawned, "no peer process was ever spawned"
    for p in peer.spawned:
        assert p.returncode is not None, f"pid {p.pid} never reaped"


def load_peer_module():
    spec = importlib.util.spec_from_file_location(
        "reference_peer", ROOT / "tools" / "reference_peer.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------------------
# Conformance: the process boundary is invisible.
# ---------------------------------------------------------------------------
def test_plugin_telemetry_bit_equal_across_transports_and_matches_jax():
    tjs, jjs = jobs_pair(31)
    t1 = 1800.0
    _, h_ref, _ = text.run_plugin_mode(
        TSYS, tjs, text.FastSimLike(policy="fcfs", backfill="firstfit"),
        0.0, t1, device="cpu")
    runs = {}
    for wire, expect in (("ndjson", "ndjson"), ("auto", "binary"),
                         ("binary", "binary")):
        peer = make_peer(ttr, wire=wire)
        try:
            runs[wire] = text.run_plugin_mode(TSYS, tjs, peer, 0.0, t1,
                                              device="cpu")
            assert peer.stats()["wire"] == expect
        finally:
            peer.close()
        assert_reaped(peer)
        h = runs[wire][1]
        assert set(h) == set(h_ref)
        for k in h_ref:
            assert np.array_equal(h_ref[k], h[k]), \
                f"channel {k!r} diverged over wire={wire}"
    want = jext.run_plugin_mode(SYS, jjs, jext.FastSimLike(), 0.0, t1)
    assert_plugin_match(want[:2], runs["auto"][:2], "binary peer vs JAX")


@pytest.mark.parametrize("wire", ["ndjson", "auto", "binary"])
def test_schedule_fetch_equals_event_schedule(wire):
    tjs, _ = jobs_pair(34, n=40)
    peer = make_peer(ttr, policy="sjf", wire=wire)
    try:
        peer.reset(TSYS, tjs, 0.0)
        got = np.asarray(peer.start, np.float64)
    finally:
        peer.close()
    assert_reaped(peer)
    want = tsyn.event_schedule(tjs.submit, tjs.limit, tjs.wall, tjs.nodes,
                               TSYS.n_nodes, TSYS.dt, policy="sjf",
                               backfill="firstfit", priority=tjs.priority)
    fin = np.isfinite(want)
    assert np.array_equal(fin, np.isfinite(got))
    assert np.array_equal(want[fin], got[fin])


@pytest.mark.parametrize("fault", [(), ("legacy",)], ids=["batch", "legacy"])
def test_poll_many_equals_single_polls(fault):
    tjs, _ = jobs_pair(33)
    ts = [float(k * SYS.dt) for k in range(12)]
    peer = make_peer(ttr, *fault)
    try:
        bridge = text.SchedulerBridge(peer)
        bridge.reset(TSYS, tjs, 0.0)
        assert peer.batch_capable is (not fault)
        batched = bridge.poll_many(ts)
        single = [text.decode_running(peer.poll_wire(t), len(tjs))
                  for t in ts]
        # the batched path is one exchange, the fallback one poll a stamp
        assert bridge.polls == (1 if not fault else len(ts))
    finally:
        peer.close()
    assert_reaped(peer)
    inproc = text.FastSimLike()
    inproc.reset(TSYS, tjs, 0.0)
    for t, b, s in zip(ts, batched, single):
        assert np.array_equal(np.sort(b), np.sort(s))
        assert np.array_equal(np.sort(b), np.sort(inproc.running_at(t)))


def test_handshake_hello_and_digests():
    tjs, jjs = jobs_pair(24, n=8)
    peer = make_peer(ttr)
    try:
        peer.reset(TSYS, tjs, 0.0)
        assert peer.peer_hello["name"] == "reference-peer"
        assert peer.peer_hello["version"] == text.WIRE_VERSION
        mod = load_peer_module()
        assert ttr.job_digest(tjs) == mod.job_digest(
            tjs.submit, tjs.limit, tjs.wall, tjs.nodes, tjs.account) \
            == jtr.job_digest(jjs)
        assert ttr.system_digest(TSYS) == \
            mod.system_digest(TSYS.n_nodes, TSYS.dt) == jtr.system_digest(SYS)
        assert peer.stats()["dials"] == 1
    finally:
        peer.close()
    assert_reaped(peer)


def fake_peer(path, ack, stop):
    """A one-session peer on ``path`` that answers the reset with ``ack``
    (a function of the reset envelope); every wait has a deadline."""
    srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    srv.bind(path)
    srv.listen(1)
    srv.settimeout(10.0)

    def serve():
        try:
            conn, _ = srv.accept()
        except OSError:
            return
        finally:
            srv.close()
        conn.settimeout(10.0)
        with conn, conn.makefile("rb") as r, conn.makefile("wb") as w:
            ttr.write_frame(w, {"version": 1, "kind": "hello",
                                "name": "fake", "caps": []})
            try:
                reset = ttr.read_frame(r)
                ttr.write_frame(w, ack(reset))
                stop.wait(10.0)
            except (OSError, ConnectionError, text.ProtocolError):
                pass

    th = threading.Thread(target=serve, daemon=True)
    th.start()
    return th


@pytest.mark.parametrize("spoil", ["job_digest", "system_digest", "n_jobs"])
def test_handshake_digest_mismatch_is_refused(tmp_path, spoil):
    """A peer whose view of (system, jobs) diverged is refused with
    ``ProtocolError`` before any poll, and the connection is dropped."""
    tjs, _ = jobs_pair(25, n=8)

    def ack(reset):
        out = {"version": 1, "kind": "reset_ack", "n_jobs": len(tjs),
               "system_digest": reset["system_digest"],
               "job_digest": reset["job_digest"]}
        out[spoil] = 7 if spoil == "n_jobs" else "0" * 64
        return out

    stop = threading.Event()
    th = fake_peer(str(tmp_path / "p.sock"), ack, stop)
    peer = ttr.SocketPeer(address=f"unix:{tmp_path / 'p.sock'}",
                          handshake_timeout_s=10.0)
    try:
        with pytest.raises(text.ProtocolError):
            peer.reset(TSYS, tjs, 0.0)
        assert peer._sock is None
    finally:
        stop.set()
        peer.close()
        th.join(timeout=15.0)
    assert not th.is_alive()


def test_sequential_mode_over_subprocess_peer():
    tjs, _ = jobs_pair(23)
    peer = make_peer(ttr)
    try:
        final, hist = text.run_sequential_mode(TSYS, tjs, peer, 0.0, 1800.0,
                                               device="cpu")
    finally:
        peer.close()
    assert_reaped(peer)
    f_ref, h_ref = text.run_sequential_mode(TSYS, tjs, text.FastSimLike(),
                                            0.0, 1800.0, device="cpu")
    assert torch.equal(h_ref.power_it, hist.power_it)
    assert torch.equal(f_ref.start, final.start)


def test_listen_mode_socket_peer_roundtrip(tmp_path):
    """``--listen`` serving and ``SocketPeer`` dialing (the
    --external-socket path); the server outlives one session."""
    addr = f"unix:{tmp_path / 'peer.sock'}"
    server = subprocess.Popen(PEER + ["--listen", addr],
                              stdin=subprocess.DEVNULL,
                              stdout=subprocess.DEVNULL,
                              stderr=subprocess.DEVNULL)
    try:
        tjs, _ = jobs_pair(26, n=10)
        inproc = text.FastSimLike()
        inproc.reset(TSYS, tjs, 0.0)
        deadline = time.monotonic() + 20.0
        peer = ttr.SocketPeer(address=addr, handshake_timeout_s=10.0,
                              timeout_s=10.0)
        while True:                      # wait for the server to bind
            try:
                peer.reset(TSYS, tjs, 0.0)
                break
            except OSError:
                if time.monotonic() > deadline:
                    raise
                time.sleep(0.05)
        for t in (0.0, 900.0, 3600.0):
            assert sorted(peer.running_at(t).tolist()) == \
                sorted(inproc.running_at(t).tolist())
        peer.close()
        peer2 = ttr.SocketPeer(address=addr, handshake_timeout_s=10.0,
                               timeout_s=10.0)
        peer2.reset(TSYS, tjs, 0.0)
        _, hist, _ = text.run_plugin_mode(TSYS, tjs, peer2, 0.0, 4 * SYS.dt,
                                          device="cpu")
        peer2.close()
        assert hist["power_it"].shape == (4,)
        assert peer2.dials == 2          # run_plugin_mode's reset dials anew
    finally:
        server.terminate()
        server.wait(timeout=10.0)
    assert server.returncode is not None


# ---------------------------------------------------------------------------
# Faults, in both packages' bridges: each surfaces, nothing hangs, nothing
# is left unreaped.
# ---------------------------------------------------------------------------
def run_fault(pkg, fault, n_steps=4, bridge_kw=None, **peer_kw):
    """Plugin mode over a faulty peer; returns (peer, bridge, error)."""
    ext, tr, system, kw, which = PKGS[pkg]
    js = jobs_pair(30 + len(fault), n=8)[which]
    peer = make_peer(tr, fault, **peer_kw)
    bridge = ext.SchedulerBridge(peer, ext.BridgeConfig(**(bridge_kw or {})))
    err = None
    try:
        ext.run_plugin_mode(system, js, bridge, 0.0, n_steps * SYS.dt, **kw)
    except (ext.ProtocolError, ext.BridgeTimeout) as e:
        err = e
    finally:
        peer.close()
    assert_reaped(peer)
    return peer, bridge, err


@pytest.mark.parametrize("pkg", list(PKGS))
def test_peer_dying_immediately_raises_bridge_timeout(pkg):
    ext = PKGS[pkg][0]
    peer, _, err = run_fault(pkg, "die:0")
    assert isinstance(err, ext.BridgeTimeout)
    # one spawn per attempt, no pointless respawn after the last failure
    assert len(peer.spawned) == ext.BridgeConfig().max_retries + 1


@pytest.mark.parametrize("pkg", list(PKGS))
def test_peer_dying_mid_stream_heals_via_respawn(pkg):
    peer, bridge, err = run_fault(pkg, "die:3", n_steps=10)
    assert err is None
    assert bridge.reconnects >= 2
    assert len(peer.spawned) == bridge.reconnects + 1
    assert bridge.stats()["peer"]["respawns"] == bridge.reconnects


@pytest.mark.parametrize("pkg", list(PKGS))
def test_hanging_peer_times_out_not_deadlocks(pkg):
    ext = PKGS[pkg][0]
    t_wall = time.monotonic()
    _, bridge, err = run_fault(pkg, "hang", timeout_s=0.5,
                               bridge_kw=dict(timeout_s=0.5, max_retries=1))
    assert isinstance(err, ext.BridgeTimeout)
    assert time.monotonic() - t_wall < 60.0, "bridge deadlocked on a hang"
    assert bridge.poll_failures == 2


@pytest.mark.parametrize("pkg", list(PKGS))
@pytest.mark.parametrize("fault", ["garbage", "truncate"])
def test_broken_frames_raise_protocol_error_not_retried(pkg, fault):
    ext = PKGS[pkg][0]
    peer, bridge, err = run_fault(pkg, fault)
    assert isinstance(err, ext.ProtocolError)
    assert len(peer.spawned) == 1, "broken speech must not be retried"
    assert bridge.reconnects == 0


@pytest.mark.parametrize("pkg", list(PKGS))
def test_wrong_wire_version_refused_at_handshake(pkg):
    ext = PKGS[pkg][0]
    peer, bridge, err = run_fault(pkg, "version")
    assert isinstance(err, ext.ProtocolError) and "version" in str(err)
    assert len(peer.spawned) == 1 and bridge.polls == 0


@pytest.mark.parametrize("pkg", list(PKGS))
def test_legacy_peer_falls_back_to_ndjson_and_binary_demand_fails(pkg):
    ext, tr, system, _, which = PKGS[pkg]
    js = jobs_pair(32, n=10)[which]
    peer = make_peer(tr, "legacy")
    try:
        peer.reset(system, js, 0.0)
        assert peer.stats()["wire"] == "ndjson"
        assert peer.batch_capable is False
    finally:
        peer.close()
    assert_reaped(peer)
    strict = make_peer(tr, "legacy", wire="binary")
    try:
        with pytest.raises(ext.ProtocolError, match="wire=binary"):
            strict.reset(system, js, 0.0)
    finally:
        strict.close()
    assert_reaped(strict)


@pytest.mark.parametrize("pkg", list(PKGS))
def test_silent_peer_command_times_out_cleanly(pkg):
    ext, tr, system, kw, which = PKGS[pkg]
    js = jobs_pair(36, n=8)[which]
    peer = tr.SubprocessPeer(
        cmd=[sys.executable, "-c", "import time; time.sleep(60)"],
        handshake_timeout_s=1.0)
    try:
        with pytest.raises(ext.BridgeTimeout):
            ext.run_plugin_mode(system, js, peer, 0.0, 2 * SYS.dt, **kw)
    finally:
        peer.close()
    assert_reaped(peer)
    assert len(peer.spawned) == ext.BridgeConfig().max_retries + 1


@pytest.mark.parametrize("pkg", list(PKGS))
def test_nonexistent_peer_command_fails_cleanly(pkg):
    """Popen itself failing leaks neither the listener nor the tmpdir."""
    ext, tr, system, kw, which = PKGS[pkg]
    js = jobs_pair(37, n=8)[which]
    peer = tr.SubprocessPeer(cmd=["/nonexistent/peer-binary"])
    try:
        with pytest.raises(ext.BridgeTimeout):
            ext.run_plugin_mode(system, js, peer, 0.0, 2 * SYS.dt, **kw)
    finally:
        peer.close()
    assert peer.spawned == []
    assert peer._tmpdir is None and peer._proc is None
    with pytest.raises(ValueError, match="needs a peer command"):
        tr.SubprocessPeer(cmd="").reset(system, js, 0.0)


@pytest.mark.parametrize("pkg", list(PKGS))
def test_unsupported_policy_surfaces_the_peers_error(pkg):
    ext, tr, system, _, which = PKGS[pkg]
    js = jobs_pair(38, n=8)[which]
    peer = make_peer(tr, policy="not-a-policy")
    try:
        with pytest.raises(ext.ProtocolError, match="rejected"):
            peer.reset(system, js, 0.0)
    finally:
        peer.close()
    assert_reaped(peer)


def test_socket_peer_needs_an_address_and_a_connection():
    tjs, _ = jobs_pair(39, n=4)
    with pytest.raises(ValueError, match="address"):
        ttr.SocketPeer().reset(TSYS, tjs, 0.0)
    with pytest.raises(ConnectionError, match="not connected"):
        ttr.SocketPeer(address="unix:/nonexistent").poll_wire(0.0)
    with pytest.raises(ValueError, match="wire must be"):
        ttr.SocketPeer(wire="morse")._negotiate_wire({"caps": []})
