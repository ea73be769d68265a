"""Request protocol for the twin service (a copy of
``repro.serve.protocol``).

Rides the wire's NDJSON framing unchanged (``core.transport.write_frame``
/ ``read_frame``, the same ``MAX_FRAME_BYTES`` cap): every frame is one
JSON object per line carrying ``version == WIRE_VERSION`` and ``kind``.
The serve dialect adds its own ``SERVE_VERSION`` to the greeting so that
protocol and service can version independently.

Frame reference (full prose: docs/serving.md)
---------------------------------------------
==============  =========  ===============================================
kind            direction  payload
==============  =========  ===============================================
``hello``       twin→client  sent once on accept: ``serve_version``,
                             ``snapshot_version``, ``caps``, ``system``
                             (name, n_nodes, dt, n_halls, digest),
                             ``jobs`` (n_jobs, digest), window (``t0``/
                             ``t1``/``interval_steps``/``horizon_steps``)
``advance``     client→twin  ``branch``, ``intervals``: queue the branch
                             for coalesced advancement
``fork``        client→twin  ``branch``, optional ``at_step`` and
                             ``delta`` (sparse Scenario knobs)
``snapshot``    client→twin  ``branch``, optional ``at_step``: download
                             the checkpointed carry (serve.snapshot);
                             optional ``bin: true`` asks for the raw-array
                             dialect over an RBW1 binary frame
``fetch``       client→twin  ``branch``, optional ``start``/``stop``:
                             scalar telemetry rows; ``bin: true`` returns
                             columnar arrays over a binary frame
``state``       client→twin  session and branch-tree summary
``shutdown``    client→twin  stop the whole server
``bye``         client→twin  close this connection only
``*_ok``        twin→client  reply; echoes the request ``id`` when given
``error``       twin→client  ``error`` ("protocol" | "session"),
                             ``message``; echoes ``id``
==============  =========  ===============================================

Failure model: malformed speech (bad JSON, wrong version, unknown kind,
wrong field types) is a ``ProtocolError``, answered with an ``error``
envelope after which the twin closes that connection; a semantically
invalid request on a well-formed frame (unknown branch id, fork point
with no checkpoint, bad knob name) is a ``SessionError``, answered with
an ``error`` envelope on a connection that stays up, the session
untouched. The server process never dies on either.

``hello_frame`` digests the system and the ``JobSet`` with the port's
copies of the wire's digests, which equal the reference's for the same
loader and seed.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.core import transport as tr
from repro_torch.core.external import WIRE_VERSION, ProtocolError
from repro_torch.serve.session import SessionError, TwinSession
from repro_torch.serve.snapshot import SNAPSHOT_VERSION

SERVE_VERSION = 1

# request kinds a client may send (everything else is broken speech)
REQUEST_KINDS = ("advance", "fork", "snapshot", "fetch", "state",
                 "shutdown", "bye")


def hello_frame(session: TwinSession, jobs=None) -> dict:
    """The twin's greeting, sent once per accepted connection."""
    sysc = session.system
    return {
        "version": WIRE_VERSION, "kind": "hello",
        "serve_version": SERVE_VERSION,
        "snapshot_version": SNAPSHOT_VERSION,
        # clients may request raw-array replies ("bin": true) on
        # snapshot/fetch; the greeting advertises the capability
        "caps": [tr.CAP_BINARY],
        "system": {"name": sysc.name, "n_nodes": int(sysc.n_nodes),
                   "dt": float(sysc.dt),
                   "n_halls": int(sysc.cooling.n_halls),
                   "digest": tr.system_digest(sysc)},
        "jobs": {"n_jobs": (len(jobs) if jobs is not None
                            else int(session.table.num_jobs)),
                 "digest": (tr.job_digest(jobs) if jobs is not None
                            else None)},
        "t0": session.t0, "t1": session.t1,
        "interval_steps": session.interval_steps,
        "horizon_steps": session.horizon_steps,
    }


def ok_frame(kind: str, msg_id, body: dict) -> dict:
    """Success reply for request ``kind`` (echoes the request id)."""
    out = {"version": WIRE_VERSION, "kind": f"{kind}_ok"}
    if msg_id is not None:
        out["id"] = msg_id
    out.update(body)
    return out


def error_frame(msg_id, exc: Exception) -> dict:
    """Error envelope; ``error`` field carries the failure class."""
    klass = "session" if isinstance(exc, SessionError) else "protocol"
    out = {"version": WIRE_VERSION, "kind": "error", "error": klass,
           "message": str(exc)}
    if msg_id is not None:
        out["id"] = msg_id
    return out


def _require_int(msg: dict, key: str, default=None,
                 minimum: Optional[int] = None):
    """Field must be an integer (or absent, when a default exists)."""
    if key not in msg:
        if default is not None or key in ("at_step", "start", "stop"):
            return default
        raise ProtocolError(f"{msg.get('kind')} request missing {key!r}")
    v = msg[key]
    if not isinstance(v, int) or isinstance(v, bool):
        raise ProtocolError(f"{key!r} must be an integer, got "
                            f"{type(v).__name__}")
    if minimum is not None and v < minimum:
        raise ProtocolError(f"{key!r} must be >= {minimum}, got {v}")
    return v


def validate_request(msg: dict) -> dict:
    """Well-formedness check; raises ``ProtocolError`` on broken speech.

    Returns the message unchanged so dispatchers can chain it. Semantic
    checks (does the branch exist?) belong to the session, not here.
    """
    if msg.get("version") != WIRE_VERSION:
        raise ProtocolError(f"wire version mismatch: client speaks "
                            f"{msg.get('version')!r}, twin speaks "
                            f"{WIRE_VERSION}")
    kind = msg.get("kind")
    if kind not in REQUEST_KINDS:
        raise ProtocolError(f"unknown request kind {kind!r} (valid: "
                            f"{', '.join(REQUEST_KINDS)})")
    if "id" in msg and not isinstance(msg["id"], (str, int)):
        raise ProtocolError("request id must be a string or integer")
    if kind == "advance":
        _require_int(msg, "branch", minimum=0)
        _require_int(msg, "intervals", default=1, minimum=0)
    elif kind in ("fork", "snapshot"):
        _require_int(msg, "branch", minimum=0)
        _require_int(msg, "at_step", minimum=0)
        if kind == "fork" and "delta" in msg and \
                not isinstance(msg["delta"], dict):
            raise ProtocolError(f"fork delta must be an object, got "
                                f"{type(msg['delta']).__name__}")
    elif kind == "fetch":
        _require_int(msg, "branch", minimum=0)
        _require_int(msg, "start", minimum=0)
        _require_int(msg, "stop", minimum=0)
    if kind in ("snapshot", "fetch") and "bin" in msg and \
            not isinstance(msg["bin"], bool):
        raise ProtocolError(f"'bin' must be a boolean, got "
                            f"{type(msg['bin']).__name__}")
    return msg


def handle_inline(session: TwinSession, msg: dict):
    """Dispatch every request kind except ``advance`` (which the server
    routes through its coalescing executor) and the connection-lifecycle
    kinds. Returns the reply frame; raises ``SessionError`` /
    ``ProtocolError`` for the server loop to envelope."""
    kind = msg["kind"]
    msg_id = msg.get("id")
    if kind == "fork":
        br = session.fork(msg["branch"], msg.get("delta"),
                          msg.get("at_step"))
        return ok_frame(kind, msg_id, {
            "branch": br.branch_id, "parent": br.parent,
            "step": br.step, "born_step": br.born_step,
            "delta": br.delta})
    if kind == "snapshot":
        return ok_frame(kind, msg_id,
                        session.snapshot(msg["branch"], msg.get("at_step"),
                                         binary=bool(msg.get("bin"))))
    if kind == "fetch":
        return ok_frame(kind, msg_id,
                        session.fetch(msg["branch"], msg.get("start"),
                                      msg.get("stop"),
                                      binary=bool(msg.get("bin"))))
    if kind == "state":
        return ok_frame(kind, msg_id, session.describe())
    raise ProtocolError(f"request kind {kind!r} has no inline handler")
