"""The persistent twin server: sockets in, coalesced batches out (a copy
of ``repro.serve.server``).

``TwinServer`` listens on a Unix-domain or TCP socket
(``core.transport.parse_address`` syntax), greets every accepted client
with a ``hello`` frame (``repro_torch.serve.protocol``) and serves
requests against one shared ``TwinSession``.

Concurrency shape:

* one **accept thread** takes connections and starts a handler thread
  per client;
* handler threads parse and validate requests and answer the cheap ones
  (fork, snapshot, fetch, state) inline under the session lock, from the
  session's host copies;
* **advance** requests are enqueued to a single **executor thread** that
  waits ``batch_window_s`` for stragglers, then drains the queue and
  advances ALL pending branches as one ``engine.simulate_segment_sweep``
  batch per interval tick (``TwinSession.advance_many``). The executor
  thread runs all of the session's device work, on the default stream;
  a batched step is one launch of the engine's kernel whatever the
  batch, and its rows are bit for bit each branch advanced alone.

Failure model: a client that dies mid-stream surfaces as
``ConnectionError`` and only its handler exits; a client speaking
garbage gets a ``protocol`` error envelope and its connection closed; a
well-formed but invalid request (unknown branch, bad knob) gets a
``session`` error envelope and the connection stays. A dispatch failure
fails its batch with a ``session`` envelope and the executor keeps
serving; nothing retries on another device. The server never crashes on
client behaviour.

Zero-zombie ledger: every accepted connection is appended to ``clients``
and never removed; ``close()`` joins every handler and asserts nothing is
left running.

Observability: with ``obs_dir`` set, the server writes a per-session run
manifest and NDJSON event log (``repro_torch.obs.recorder``): client
connects and disconnects, advance batches, forks and errors land in the
event log, and ``finalize`` embeds the wire and session counters.
"""
from __future__ import annotations

import pathlib
import socket
import threading
import time
from dataclasses import dataclass, field
from typing import IO, List, Optional

from repro_torch.core import transport as tr
from repro_torch.core.external import ProtocolError
from repro_torch.launch import env as launch_env
from repro_torch.serve import protocol as proto
from repro_torch.serve.session import SessionError, TwinSession


@dataclass
class _Client:
    """Ledger row for one accepted connection (never removed)."""
    client_id: int
    sock: socket.socket
    thread: Optional[threading.Thread] = None
    counters: tr.WireCounters = field(default_factory=tr.WireCounters)
    open: bool = True
    reason: str = ""          # why the connection ended ("bye", "eof", ...)


@dataclass
class _Pending:
    """One queued advance request awaiting the coalescing executor."""
    branch: int
    intervals: int
    done: threading.Event = field(default_factory=threading.Event)
    result: Optional[dict] = None
    error: Optional[Exception] = None


class TwinServer:
    """Serve one ``TwinSession`` to many clients over NDJSON frames."""

    def __init__(self, session: TwinSession, address: str, jobs=None,
                 batch_window_s: float = 0.01, obs_dir=None,
                 accept_timeout_s: float = 0.2,
                 client_timeout_s: float = 60.0):
        self.session = session
        self.jobs = jobs
        self.batch_window_s = float(batch_window_s)
        self.client_timeout_s = float(client_timeout_s)
        self.clients: List[_Client] = []
        self._clients_lock = threading.Lock()
        self._queue: List[_Pending] = []
        self._queue_cv = threading.Condition()
        self._shutdown = threading.Event()
        self.recorder = None
        if obs_dir is not None:
            from repro_torch.obs.recorder import RunRecorder
            d = pathlib.Path(obs_dir)
            self.recorder = RunRecorder(
                manifest_path=d / "serve_manifest.json",
                events_path=d / "serve_events.ndjson")
            self.recorder.begin(
                session.system, command="serve", argv=[str(address)],
                scenario={"interval_steps": session.interval_steps,
                          "horizon_steps": session.horizon_steps},
                jobs=jobs,
                extra={"env_preset": launch_env.report("throughput")})

        family, sockaddr = tr.parse_address(str(address))
        self._listener = socket.socket(family, socket.SOCK_STREAM)
        if family == socket.AF_INET:
            self._listener.setsockopt(socket.SOL_SOCKET,
                                      socket.SO_REUSEADDR, 1)
        self._listener.bind(sockaddr)
        self._listener.listen(64)
        self._listener.settimeout(accept_timeout_s)
        self.address = tr.format_address(family,
                                         self._listener.getsockname())
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="twin-accept", daemon=True)
        self._exec_thread = threading.Thread(
            target=self._executor_loop, name="twin-executor", daemon=True)
        self._accept_thread.start()
        self._exec_thread.start()
        self._event("server_start", address=self.address)

    # -- observability -------------------------------------------------------
    def _event(self, what: str, **fields) -> None:
        if self.recorder is not None:
            self.recorder.event(what, **fields)

    # -- accept + per-client loops -------------------------------------------
    def _accept_loop(self) -> None:
        while not self._shutdown.is_set():
            try:
                conn, _ = self._listener.accept()
            except socket.timeout:
                continue
            except OSError:      # listener closed under us during shutdown
                break
            with self._clients_lock:
                client = _Client(client_id=len(self.clients), sock=conn)
                self.clients.append(client)
            client.thread = threading.Thread(
                target=self._client_loop, args=(client,),
                name=f"twin-client-{client.client_id}", daemon=True)
            client.thread.start()
            self._event("client_connect", client=client.client_id)

    def _client_loop(self, client: _Client) -> None:
        conn = client.sock
        conn.settimeout(self.client_timeout_s)
        rfile: IO[bytes] = conn.makefile("rb")
        wfile: IO[bytes] = conn.makefile("wb")
        try:
            tr.write_frame(wfile, proto.hello_frame(self.session,
                                                    self.jobs),
                           client.counters)
            while not self._shutdown.is_set():
                try:
                    msg = proto.validate_request(
                        tr.read_frame(rfile, client.counters))
                except ProtocolError as e:
                    # broken speech: answer, then hang up on this client
                    self._event("client_protocol_error",
                                client=client.client_id, message=str(e))
                    self._safe_write(wfile, client,
                                     proto.error_frame(None, e))
                    client.reason = "protocol-error"
                    return
                kind, msg_id = msg["kind"], msg.get("id")
                if kind == "bye":
                    self._safe_write(wfile, client,
                                     proto.ok_frame("bye", msg_id, {}))
                    client.reason = "bye"
                    return
                if kind == "shutdown":
                    self._safe_write(wfile, client,
                                     proto.ok_frame("shutdown", msg_id, {}))
                    client.reason = "shutdown"
                    self._shutdown.set()
                    with self._queue_cv:
                        self._queue_cv.notify_all()
                    return
                try:
                    if kind == "advance":
                        reply = proto.ok_frame(
                            "advance", msg_id,
                            self._advance(msg["branch"],
                                          msg.get("intervals", 1)))
                    else:
                        reply = proto.handle_inline(self.session, msg)
                        if kind == "fork":
                            self._event("fork", client=client.client_id,
                                        parent=msg["branch"],
                                        branch=reply["branch"])
                except SessionError as e:
                    # well-formed but invalid: envelope, keep serving
                    self._event("client_session_error",
                                client=client.client_id, message=str(e))
                    reply = proto.error_frame(msg_id, e)
                if msg.get("bin") and reply.get("kind") != "error":
                    # raw-array reply dialect, on request only: the
                    # client asked with "bin": true, so it can read
                    # RBW1 frames (requests themselves stay NDJSON)
                    tr.write_bin_frame(wfile, reply, client.counters)
                else:
                    tr.write_frame(wfile, reply, client.counters)
        except (ConnectionError, TimeoutError, OSError, BrokenPipeError):
            client.reason = client.reason or "eof"
        finally:
            client.reason = client.reason or "closed"
            for f in (wfile, rfile):
                try:
                    f.close()
                except OSError:
                    pass
            conn.close()
            client.open = False
            self._event("client_disconnect", client=client.client_id,
                        reason=client.reason)

    @staticmethod
    def _safe_write(wfile, client: _Client, frame: dict) -> None:
        """Best-effort write (the client may already be gone)."""
        try:
            tr.write_frame(wfile, frame, client.counters)
        except (ProtocolError, OSError):
            pass

    # -- coalescing executor -------------------------------------------------
    def _advance(self, branch: int, intervals: int) -> dict:
        """Enqueue an advance and block until the executor answers it.

        The shutdown check happens under the queue condition — the same
        lock the executor's exit check holds — so a request can never be
        enqueued after the executor decided to exit (which would strand
        this handler on ``done.wait`` forever). The executor-liveness
        poll is the backstop for the executor dying some way the
        dispatch guard did not foresee."""
        pending = _Pending(branch=int(branch), intervals=int(intervals))
        with self._queue_cv:
            if self._shutdown.is_set():
                raise SessionError("server is shutting down")
            self._queue.append(pending)
            self._queue_cv.notify()
        while not pending.done.wait(timeout=1.0):
            if not self._exec_thread.is_alive():
                raise SessionError("server executor is gone")
        if pending.error is not None:
            raise pending.error
        return pending.result

    def _executor_loop(self) -> None:
        while True:
            with self._queue_cv:
                while not self._queue and not self._shutdown.is_set():
                    self._queue_cv.wait(timeout=0.5)
                if self._shutdown.is_set() and not self._queue:
                    return
            # wait a beat so concurrent clients land in the same batch
            time.sleep(self.batch_window_s)
            with self._queue_cv:
                batch, self._queue = self._queue, []
            # an unknown branch id fails ONLY its own requester — it must
            # not poison the coalesced batch for well-behaved clients
            unknown, known_ids = self.session.unknown_branches(
                {p.branch for p in batch})
            known = []
            for p in batch:
                if p.branch in unknown:
                    p.error = SessionError(
                        f"unknown branch id {p.branch!r} (known: "
                        f"{known_ids})")
                    p.done.set()
                else:
                    known.append(p)
            merged: dict = {}
            for p in known:
                merged[p.branch] = merged.get(p.branch, 0) + p.intervals
            try:
                results = self.session.advance_many(merged) if merged \
                    else {}
                err = None
            except SessionError as e:   # defense in depth (races)
                results, err = {}, e
            except Exception as e:      # noqa: BLE001
                # a dispatch blowing up (e.g. a shape error that slipped
                # past fork-time validation) must fail THIS batch, not
                # kill the executor — a dead executor strands every
                # later advance on done.wait and breaks the "server
                # never dies on client behavior" guarantee
                results, err = {}, SessionError(f"advance failed: {e!r}")
                self.session.count_error()
                self._event("advance_batch_error", message=repr(e))
            self._event("advance_batch", branches=sorted(merged),
                        requests=len(batch),
                        coalesced=len(merged) > 1)
            for p in known:
                if err is not None or p.branch not in results:
                    p.error = err or SessionError(
                        f"unknown branch id {p.branch!r}")
                else:
                    p.result = results[p.branch]
                p.done.set()

    # -- lifecycle -----------------------------------------------------------
    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until a client requests shutdown (CI smoke mode)."""
        return self._shutdown.wait(timeout)

    def stats(self) -> dict:
        """Aggregated wire + session counters and the client ledger."""
        with self._clients_lock:
            wire = tr.WireCounters()
            for c in self.clients:
                for k, v in c.counters.as_dict().items():
                    setattr(wire, k, getattr(wire, k) + v)
            ledger = [{"client": c.client_id, "open": c.open,
                       "reason": c.reason} for c in self.clients]
        return {"address": self.address, "wire": wire.as_dict(),
                "session": dict(self.session.counters),
                "clients": ledger,
                "n_clients": len(ledger),
                "n_open": sum(1 for c in ledger if c["open"])}

    def close(self) -> dict:
        """Stop accepting, drain the executor, join every handler.

        Returns final ``stats()``. Asserts the ledger is fully closed —
        the zero-zombie guarantee the soak test leans on."""
        self._shutdown.set()
        with self._queue_cv:
            self._queue_cv.notify_all()
        try:
            self._listener.close()
        except OSError:
            pass
        self._accept_thread.join(timeout=5.0)
        self._exec_thread.join(timeout=5.0)
        with self._clients_lock:
            handlers = [c for c in self.clients if c.thread is not None]
        for c in handlers:
            try:
                c.sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            c.sock.close()
            c.thread.join(timeout=5.0)
        stats = self.stats()
        self._event("server_stop", **{k: stats[k]
                                      for k in ("n_clients", "n_open")})
        if self.recorder is not None:
            self.recorder.finalize(counters={"wire": stats["wire"],
                                             "session": stats["session"]},
                                   clients=stats["clients"])
            self.recorder = None
        leaked = [c.client_id for c in self.clients
                  if c.thread is not None and c.thread.is_alive()]
        assert not leaked, f"client handler threads leaked: {leaked}"
        return stats

    def __enter__(self) -> "TwinServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
