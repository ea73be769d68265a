"""The wire's framing and the external scheduler's peers (port of
``repro.core.transport``).

Newline-delimited JSON frames (one envelope per line, UTF-8) and the
length-prefixed RBW1 binary dialect, over any byte stream: a Unix-domain
or TCP socket, a file, a pipe. Every object carries ``version`` (must
equal ``WIRE_VERSION``) and ``kind``; the envelopes, the capability
tokens and the failure classification are the reference's
(docs/external-scheduling.md, docs/serving.md), and the port's frames are
byte for byte the reference's.

Failure model: framing and parse problems (garbage, a truncated line or
binary body, an over-long frame) raise ``ProtocolError``, broken speech
that is not retried; EOF before a frame raises ``ConnectionError`` and a
socket timeout ``TimeoutError``, transport failures.

The handshake digests (``system_digest``, ``job_digest``), NDJSON
framing with ``WireCounters``, the RBW1 codec
(``encode_bin_frame``/``decode_bin_frame``/``write_bin_frame``) and the
dialect-agnostic ``read_any_frame``, ``decode_schedule``,
``parse_address`` and ``format_address`` are the reference's. One
departure: ``_bin_restore`` reads exactly each array's bytes (the
reference reads to the end of the payload, which numpy refuses for some
leaf orders).

The external scheduler's peers: ``SocketPeer`` dials a peer that is
listening (``hello`` with version and caps, then a digest-checked
``reset`` / ``reset_ack``, then the per-poll timeout; ``auto``,
``ndjson`` or ``binary`` frames; ``start`` fetches a whole schedule with
``schedule_req``), and ``SubprocessPeer`` owns its peer process: it
listens on a fresh socket, spawns the command with ``--connect``
appended, and kills, reaps and respawns it on every ``reset``. Every
process it ever spawned stays in ``spawned``, and ``close()`` reaps them
all. ``tools/reference_peer.py`` is the stdlib-only peer.
"""
from __future__ import annotations

import hashlib
import json
import os
import shlex
import shutil
import socket
import struct
import subprocess
import tempfile
from dataclasses import dataclass, field
from typing import IO

import numpy as np

from repro_torch.core.external import (WIRE_VERSION, ProtocolError,
                                       decode_running)
from repro_torch.datasets.base import JobSet
from repro_torch.systems.config import SystemConfig

# Sized for the biggest legitimate frame: a reset envelope carries six
# full job columns (~100 bytes/job of JSON), so ~1e6 jobs fits with
# headroom. Anything past this is a confused peer, not a big answer —
# and write_frame enforces the same cap outbound, so an oversized twin
# payload fails loudly here instead of as a peer-side parse error.
MAX_FRAME_BYTES = 256 << 20

# Binary frame dialect (negotiated — see read_any_frame/write_bin_frame):
#   magic[4] ("RBW1") | u32 LE header bytes | u32 LE payload bytes |
#   UTF-8 JSON header | concatenated raw little-endian array bytes.
# The header is the envelope with every ndarray leaf replaced by a
# placeholder {"__bin__": index, "dtype": "<f8", "shape": [...]}; the
# payload carries the arrays' raw bytes in placeholder-index order. A
# binary frame can never be mistaken for NDJSON (frames there start with
# "{") and vice versa, so one reader speaks both dialects.
BIN_MAGIC = b"RBW1"
_BIN_LENS = struct.Struct("<II")
# capability tokens a peer may advertise in its hello frame
CAP_BINARY = "bin1"    # understands RBW1 binary frames
CAP_BATCH = "batch1"   # understands poll_batch / running_sets envelopes

# dtypes allowed on the binary wire: fixed-width little-endian numerics
# plus bool. Everything the job tables / schedules / running sets use.
_BIN_DTYPES = frozenset(["<f4", "<f8", "<i4", "<i8", "<u4", "<u8", "|b1"])


# ---------------------------------------------------------------------------
# Canonical digests (handshake).
# ---------------------------------------------------------------------------
def _digest(obj) -> str:
    """sha256 over the canonical (sorted-keys, no-spaces) JSON of ``obj``."""
    blob = json.dumps(obj, separators=(",", ":"), sort_keys=True)
    return hashlib.sha256(blob.encode("utf-8")).hexdigest()


def system_digest(system: SystemConfig) -> str:
    """Digest of the system parameters a peer's schedule depends on."""
    return _digest({"v": WIRE_VERSION, "n_nodes": int(system.n_nodes),
                    "dt": float(system.dt)})


def job_digest(jobs: JobSet) -> str:
    """Digest of the SWF-preserved job columns, whole-second rounded.

    Only the columns the SWF roundtrip guarantees (submit / limit / wall /
    nodes / account — ``datasets/swf.py``) participate, rounded to whole
    seconds with banker's rounding (what both ``round`` and the SWF
    writer's ``:.0f`` do), so a peer that loaded the same trace from an
    SWF file computes the same digest as one fed over the wire.
    """
    def whole(col):  # np.round is half-even, same as round() peer-side
        return np.round(np.asarray(col)).astype(np.int64).tolist()

    return _digest({"v": WIRE_VERSION, "jobs": {
        "submit": whole(jobs.submit),
        "limit": whole(jobs.limit),
        "wall": whole(jobs.wall),
        "nodes": np.asarray(jobs.nodes).astype(np.int64).tolist(),
        "account": np.asarray(jobs.account).astype(np.int64).tolist(),
    }})


# ---------------------------------------------------------------------------
# NDJSON framing.
# ---------------------------------------------------------------------------
@dataclass
class WireCounters:
    """Monotonic per-connection framing counters (flight-recorder food).

    Counted at the framing layer so every peer kind (socket, subprocess,
    metrics sink) shares one definition of a frame/byte. ``bytes_in``
    counts delivered frames only — a rejected over-long or truncated line
    bumps ``frames_rejected`` instead, so in/out byte counts stay
    comparable across the twin and a compliant peer.
    """
    frames_out: int = 0
    bytes_out: int = 0
    frames_in: int = 0
    bytes_in: int = 0
    frames_rejected: int = 0

    def as_dict(self) -> dict:
        return {"frames_out": self.frames_out, "bytes_out": self.bytes_out,
                "frames_in": self.frames_in, "bytes_in": self.bytes_in,
                "frames_rejected": self.frames_rejected}


def write_frame(wfile: IO[bytes], msg: dict,
                counters: WireCounters | None = None) -> None:
    """Write one envelope as a newline-terminated JSON frame and flush.

    Enforces ``MAX_FRAME_BYTES`` outbound too: a compliant peer would
    reject an over-long line anyway, so failing here turns a confusing
    remote parse error into a local, diagnosable one. The size check runs
    on the JSON *text* before it is encoded and the newline is written
    separately, so an oversize envelope (a ~1e6-job reset gone wrong)
    fails fast after one materialization instead of three: UTF-8 output
    is never shorter than its str, so ``len(text) > cap`` alone proves
    the frame is over-long."""
    text = json.dumps(msg, separators=(",", ":"))
    if len(text) + 1 > MAX_FRAME_BYTES:
        if counters is not None:
            counters.frames_rejected += 1
        raise ProtocolError(
            f"outbound {msg.get('kind')!r} frame is >= {len(text) + 1} "
            f"bytes, over the {MAX_FRAME_BYTES}-byte protocol cap")
    line = text.encode("utf-8")
    n = len(line) + 1
    if n > MAX_FRAME_BYTES:  # pragma: no cover - non-ASCII heavy payload
        if counters is not None:
            counters.frames_rejected += 1
        raise ProtocolError(
            f"outbound {msg.get('kind')!r} frame is {n} bytes, "
            f"over the {MAX_FRAME_BYTES}-byte protocol cap")
    wfile.write(line)
    wfile.write(b"\n")
    wfile.flush()
    if counters is not None:
        counters.frames_out += 1
        counters.bytes_out += n


def read_frame(rfile: IO[bytes],
               counters: WireCounters | None = None) -> dict:
    """Read one envelope; classify every way a peer can get it wrong.

    EOF (peer died) raises ``ConnectionError`` — a transport failure the
    bridge may heal by reconnecting. A frame that *arrives* but is
    over-long, truncated (no newline before EOF), non-JSON, or not an
    object raises ``ProtocolError`` — broken speech is not retried.
    Socket timeouts propagate as ``TimeoutError`` from the underlying
    file object.
    """
    line = rfile.readline(MAX_FRAME_BYTES + 1)
    if not line:
        raise ConnectionError("peer closed the connection (EOF)")
    if len(line) > MAX_FRAME_BYTES:
        if counters is not None:
            counters.frames_rejected += 1
        raise ProtocolError(f"frame exceeds {MAX_FRAME_BYTES} bytes")
    try:
        if not line.endswith(b"\n"):
            raise ProtocolError("truncated frame: EOF before newline")
        try:
            msg = json.loads(line)
        except (json.JSONDecodeError, UnicodeDecodeError) as e:
            raise ProtocolError(f"frame is not JSON: {e}") from e
        if not isinstance(msg, dict):
            raise ProtocolError(f"frame must be a JSON object, got "
                                f"{type(msg).__name__}")
    except ProtocolError:
        if counters is not None:
            counters.frames_rejected += 1
        raise
    if counters is not None:
        counters.frames_in += 1
        counters.bytes_in += len(line)
    return msg


# ---------------------------------------------------------------------------
# Binary framing (the RBW1 fast path).
# ---------------------------------------------------------------------------
def _bin_hoist(obj, arrays: list):
    """Replace every ndarray leaf with a placeholder, collecting raw bytes.

    Returns the placeholder-bearing copy of ``obj``; ``arrays`` receives
    the little-endian raw bytes in placeholder-index order."""
    if isinstance(obj, np.ndarray):
        a = obj
        if a.dtype.byteorder == ">":  # pragma: no cover - big-endian host
            a = a.astype(a.dtype.newbyteorder("<"))
        dt = np.dtype(a.dtype.str)  # normalize '=' to explicit order
        if dt.str not in _BIN_DTYPES:
            raise ProtocolError(f"dtype {dt.str!r} is not a binary-wire "
                                f"dtype (allowed: {sorted(_BIN_DTYPES)})")
        arrays.append(np.ascontiguousarray(a).tobytes())
        return {"__bin__": len(arrays) - 1, "dtype": dt.str,
                "shape": list(a.shape)}
    if isinstance(obj, dict):
        if "__bin__" in obj:
            raise ProtocolError("'__bin__' is a reserved header key")
        return {k: _bin_hoist(v, arrays) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_bin_hoist(v, arrays) for v in obj]
    return obj


def _bin_restore(obj, payload: bytes, offsets: list, as_arrays: bool):
    """Inverse of ``_bin_hoist``: placeholders -> arrays (or lists)."""
    if isinstance(obj, dict):
        if "__bin__" in obj:
            try:
                idx = int(obj["__bin__"])
                dtype = np.dtype(obj["dtype"])
                shape = tuple(int(s) for s in obj["shape"])
                off, nbytes = offsets[idx]
            except (KeyError, TypeError, ValueError, IndexError) as e:
                raise ProtocolError(f"malformed binary placeholder: "
                                    f"{e}") from e
            # departure from the reference, which reads count=-1 from
            # ``off`` and slices after: numpy refuses when the bytes from
            # ``off`` to the end of the whole payload are not a multiple
            # of this leaf's itemsize (an 8-byte leaf before an odd
            # number of 4-byte elements). Read exactly this leaf's bytes.
            a = np.frombuffer(payload, dtype, count=nbytes // dtype.itemsize,
                              offset=off)
            a = a.reshape(shape)
            return a.copy() if as_arrays else a.tolist()
        return {k: _bin_restore(v, payload, offsets, as_arrays)
                for k, v in obj.items()}
    if isinstance(obj, list):
        return [_bin_restore(v, payload, offsets, as_arrays) for v in obj]
    return obj


def encode_bin_frame(msg: dict) -> tuple[bytes, bytes, list[bytes]]:
    """Encode one envelope as (prefix, header, payload chunks).

    The prefix is magic + both u32 lengths; the payload is returned as
    the per-array chunks so callers can write without concatenating a
    256 MB blob. Raises ``ProtocolError`` when the total frame would
    exceed ``MAX_FRAME_BYTES`` — checked from the chunk sizes *before*
    any large buffer is joined."""
    arrays: list[bytes] = []
    header_obj = _bin_hoist(msg, arrays)
    header = json.dumps(header_obj, separators=(",", ":")).encode("utf-8")
    payload_len = sum(len(c) for c in arrays)
    total = len(BIN_MAGIC) + _BIN_LENS.size + len(header) + payload_len
    if total > MAX_FRAME_BYTES:
        raise ProtocolError(
            f"outbound {msg.get('kind')!r} binary frame is {total} bytes, "
            f"over the {MAX_FRAME_BYTES}-byte protocol cap")
    prefix = BIN_MAGIC + _BIN_LENS.pack(len(header), payload_len)
    return prefix, header, arrays


def decode_bin_frame(header: bytes, payload: bytes,
                     as_arrays: bool = True) -> dict:
    """Decode an RBW1 (header, payload) pair back into an envelope.

    ``as_arrays=False`` materializes every array placeholder as nested
    Python lists — byte-for-byte the values the NDJSON dialect would have
    produced (float64/int64 JSON round-trips are exact), which is what
    the cross-dialect equivalence tests assert on."""
    try:
        obj = json.loads(header)
    except (json.JSONDecodeError, UnicodeDecodeError) as e:
        raise ProtocolError(f"binary frame header is not JSON: {e}") from e
    if not isinstance(obj, dict):
        raise ProtocolError(f"binary frame header must be a JSON object, "
                            f"got {type(obj).__name__}")
    # lay the arrays out: placeholder index -> (offset, nbytes)
    sizes: dict[int, int] = {}

    def walk(o):
        if isinstance(o, dict):
            if "__bin__" in o:
                try:
                    idx = int(o["__bin__"])
                    dtype = np.dtype(o["dtype"])
                    if dtype.str not in _BIN_DTYPES:
                        raise ProtocolError(
                            f"dtype {dtype.str!r} is not a binary-wire "
                            f"dtype")
                    shape = tuple(int(s) for s in o["shape"])
                    if any(s < 0 for s in shape):
                        raise ProtocolError("negative array dimension")
                except ProtocolError:
                    raise
                except (KeyError, TypeError, ValueError) as e:
                    raise ProtocolError(f"malformed binary placeholder: "
                                        f"{e}") from e
                n = dtype.itemsize * int(np.prod(shape, dtype=np.int64)) \
                    if shape else dtype.itemsize
                if idx in sizes:
                    raise ProtocolError(f"duplicate array index {idx}")
                sizes[idx] = n
                return
            for v in o.values():
                walk(v)
        elif isinstance(o, list):
            for v in o:
                walk(v)

    walk(obj)
    if sorted(sizes) != list(range(len(sizes))):
        raise ProtocolError(f"array indices must be 0..{len(sizes) - 1}, "
                            f"got {sorted(sizes)}")
    offsets, off = [], 0
    for i in range(len(sizes)):
        offsets.append((off, sizes[i]))
        off += sizes[i]
    if off != len(payload):
        raise ProtocolError(f"binary payload carries {len(payload)} bytes, "
                            f"header implies {off}")
    return _bin_restore(obj, payload, offsets, as_arrays)


def write_bin_frame(wfile: IO[bytes], msg: dict,
                    counters: WireCounters | None = None) -> None:
    """Write one envelope as an RBW1 binary frame and flush."""
    try:
        prefix, header, chunks = encode_bin_frame(msg)
    except ProtocolError:
        if counters is not None:
            counters.frames_rejected += 1
        raise
    wfile.write(prefix)
    wfile.write(header)
    for c in chunks:
        wfile.write(c)
    wfile.flush()
    if counters is not None:
        counters.frames_out += 1
        counters.bytes_out += len(prefix) + len(header) \
            + sum(len(c) for c in chunks)


def _read_exact(rfile: IO[bytes], n: int) -> bytes:
    """Read exactly ``n`` bytes; EOF mid-frame is broken speech."""
    buf = rfile.read(n)
    if buf is None or len(buf) < n:  # pragma: no branch
        raise ProtocolError(f"truncated binary frame: EOF after "
                            f"{0 if buf is None else len(buf)}/{n} bytes")
    return buf


def read_any_frame(rfile: IO[bytes],
                   counters: WireCounters | None = None,
                   as_arrays: bool = True) -> dict:
    """Read one frame of either dialect (NDJSON line or RBW1 binary).

    The first byte selects the dialect deterministically: NDJSON frames
    always start with ``{`` (json.dumps of an object), binary frames
    with the magic. Failure classification matches ``read_frame``: EOF
    before any byte is ``ConnectionError``; a frame that arrives broken
    (bad magic continuation, truncated binary body, over-long, non-JSON)
    is ``ProtocolError``."""
    first = rfile.read(1)
    if not first:
        raise ConnectionError("peer closed the connection (EOF)")
    if first == BIN_MAGIC[:1]:
        try:
            rest = _read_exact(rfile, len(BIN_MAGIC) - 1)
            if first + rest != BIN_MAGIC:
                raise ProtocolError(f"bad binary frame magic "
                                    f"{(first + rest)!r}")
            header_len, payload_len = _BIN_LENS.unpack(
                _read_exact(rfile, _BIN_LENS.size))
            total = len(BIN_MAGIC) + _BIN_LENS.size + header_len \
                + payload_len
            if total > MAX_FRAME_BYTES:
                raise ProtocolError(f"frame exceeds {MAX_FRAME_BYTES} "
                                    f"bytes")
            header = _read_exact(rfile, header_len)
            payload = _read_exact(rfile, payload_len)
            msg = decode_bin_frame(header, payload, as_arrays)
        except ProtocolError:
            if counters is not None:
                counters.frames_rejected += 1
            raise
        if counters is not None:
            counters.frames_in += 1
            counters.bytes_in += total
        return msg
    # NDJSON: the byte we took is the start of the line
    line = first + rfile.readline(MAX_FRAME_BYTES + 1)
    if len(line) > MAX_FRAME_BYTES:
        if counters is not None:
            counters.frames_rejected += 1
        raise ProtocolError(f"frame exceeds {MAX_FRAME_BYTES} bytes")
    try:
        if not line.endswith(b"\n"):
            raise ProtocolError("truncated frame: EOF before newline")
        try:
            msg = json.loads(line)
        except (json.JSONDecodeError, UnicodeDecodeError) as e:
            raise ProtocolError(f"frame is not JSON: {e}") from e
        if not isinstance(msg, dict):
            raise ProtocolError(f"frame must be a JSON object, got "
                                f"{type(msg).__name__}")
    except ProtocolError:
        if counters is not None:
            counters.frames_rejected += 1
        raise
    if counters is not None:
        counters.frames_in += 1
        counters.bytes_in += len(line)
    return msg


def decode_schedule(msg: dict, n_jobs: int) -> np.ndarray:
    """Validate a ``schedule`` envelope; return start times (inf = never).

    Two spellings, one meaning: the NDJSON dialect lists numbers with
    ``null`` for never-started; the binary dialect ships a float array
    where ``+inf`` is never-started (null has no fixed-width encoding).
    NaN / ``-inf`` are rejected in both."""
    if msg.get("version") != WIRE_VERSION:
        raise ProtocolError(f"wire version mismatch: peer speaks "
                            f"{msg.get('version')!r}")
    if msg.get("kind") != "schedule":
        raise ProtocolError(f"unexpected message kind {msg.get('kind')!r}")
    start = msg.get("start")
    if isinstance(start, np.ndarray):
        if start.ndim != 1 or start.shape[0] != n_jobs:
            raise ProtocolError(f"schedule must carry {n_jobs} start times, "
                                f"got shape {start.shape}")
        if not np.issubdtype(start.dtype, np.floating):
            raise ProtocolError(f"binary schedule must be float, got "
                                f"dtype={start.dtype}")
        out = start.astype(np.float64)
        bad = np.isnan(out) | (out == -np.inf)
        if bad.any():
            j = int(np.argmax(bad))
            raise ProtocolError(f"schedule start[{j}] must be finite or "
                                f"+inf, got {out[j]!r}")
        return out
    if not isinstance(start, list) or len(start) != n_jobs:
        raise ProtocolError(f"schedule must list {n_jobs} start times, got "
                            f"{type(start).__name__}"
                            f"{'' if not isinstance(start, list) else f'[{len(start)}]'}")
    out = np.full((n_jobs,), np.inf, np.float64)
    for j, s in enumerate(start):
        if s is None:
            continue
        if not isinstance(s, (int, float)) or isinstance(s, bool):
            raise ProtocolError(f"schedule start[{j}] must be a number or "
                                f"null, got {type(s).__name__}")
        try:
            val = float(s)
        except OverflowError as e:  # arbitrary-precision JSON integer
            raise ProtocolError(f"schedule start[{j}] out of float "
                                f"range") from e
        if not np.isfinite(val):
            # json.loads accepts non-standard NaN/Infinity tokens; a
            # never-started job is spelled null, so a non-finite number
            # is a confused peer, not a big start time
            raise ProtocolError(f"schedule start[{j}] must be finite or "
                                f"null, got {s!r}")
        out[j] = val
    return out


def parse_address(addr: str) -> tuple[int, str | tuple[str, int]]:
    """``unix:/path`` or a bare path → AF_UNIX; ``host:port`` → TCP."""
    if addr.startswith("unix:"):
        return socket.AF_UNIX, addr[len("unix:"):]
    if addr.startswith("tcp:"):
        addr = addr[len("tcp:"):]
    if "/" in addr:
        return socket.AF_UNIX, addr
    host, _, port = addr.rpartition(":")
    if not host or not port.isdigit():
        raise ValueError(f"address must be unix:/path or host:port, "
                         f"got {addr!r}")
    return socket.AF_INET, (host, int(port))


def format_address(family: int, sockaddr) -> str:
    if family == getattr(socket, "AF_UNIX", -1):
        return f"unix:{sockaddr}"
    host, port = sockaddr
    return f"{host}:{port}"


# ---------------------------------------------------------------------------
# Client side: ExternalScheduler over a socket.
# ---------------------------------------------------------------------------
@dataclass
class SocketPeer:
    """``ExternalScheduler`` whose brain lives across a socket.

    ``reset`` (re)establishes the session from scratch — dial, ``hello``
    handshake, digest-checked ``reset`` exchange — which is exactly the
    resync ``SchedulerBridge`` needs its reconnect path to perform, so a
    mid-stream death or hang heals transparently. Plugs into
    ``run_plugin_mode`` / ``run_sequential_mode`` unchanged (the process
    boundary is behaviorally invisible).
    """
    address: str | None = None
    policy: str = "fcfs"
    backfill: str = "firstfit"
    wire: str = "auto"                 # "auto" | "ndjson" | "binary"
    timeout_s: float = 30.0            # per-reply socket budget
    handshake_timeout_s: float = 20.0  # connect + hello + reset_ack budget
    peer_hello: dict | None = None
    counters: WireCounters = field(default_factory=WireCounters)
    dials: int = 0                     # connection (re)establishments
    _sock: socket.socket | None = None
    _rfile: IO[bytes] | None = None
    _wfile: IO[bytes] | None = None
    _n_jobs: int = 0
    _binary: bool = False              # negotiated per connection

    # -- connection lifecycle ----------------------------------------------
    def _dial(self) -> socket.socket:
        if self.address is None:
            raise ValueError("SocketPeer needs an address")
        family, sockaddr = parse_address(self.address)
        sock = socket.socket(family, socket.SOCK_STREAM)
        sock.settimeout(self.handshake_timeout_s)
        sock.connect(sockaddr)
        self.dials += 1
        return sock

    def _attach(self, sock: socket.socket) -> None:
        """Adopt a connected socket: buffered files + hello validation."""
        self._sock = sock
        self._rfile = sock.makefile("rb")
        self._wfile = sock.makefile("wb")
        hello = read_frame(self._rfile, self.counters)
        if hello.get("kind") != "hello":
            raise ProtocolError(f"expected hello, got "
                                f"{hello.get('kind')!r}")
        if hello.get("version") != WIRE_VERSION:
            raise ProtocolError(
                f"wire version mismatch: peer speaks "
                f"{hello.get('version')!r}, bridge speaks {WIRE_VERSION}")
        self.peer_hello = hello
        self._binary = self._negotiate_wire(hello)

    def _negotiate_wire(self, hello: dict) -> bool:
        """Pick the frame dialect from our policy + the peer's caps.

        ``auto`` upgrades to binary whenever the peer advertises
        ``CAP_BINARY`` and falls back to NDJSON otherwise (legacy peers
        send no ``caps`` at all); ``binary`` demands the capability and
        treats its absence as broken speech; ``ndjson`` pins the legacy
        dialect regardless of what the peer could do."""
        caps = hello.get("caps") or []
        if not isinstance(caps, list):
            raise ProtocolError(f"hello caps must be a list, got "
                                f"{type(caps).__name__}")
        if self.wire == "ndjson":
            return False
        if self.wire == "binary":
            if CAP_BINARY not in caps:
                raise ProtocolError(
                    f"wire=binary requested but peer "
                    f"{hello.get('name')!r} does not advertise "
                    f"{CAP_BINARY!r} (caps={caps!r})")
            return True
        if self.wire != "auto":
            raise ValueError(f"wire must be auto|ndjson|binary, "
                             f"got {self.wire!r}")
        return CAP_BINARY in caps

    @property
    def batch_capable(self) -> bool:
        """Whether the connected peer advertised batched polls."""
        caps = (self.peer_hello or {}).get("caps") or []
        return CAP_BATCH in caps

    def _teardown_connection(self) -> None:
        for f in (self._wfile, self._rfile, self._sock):
            if f is not None:
                try:
                    f.close()
                except OSError:
                    pass
        self._sock = self._rfile = self._wfile = None

    def _establish(self) -> None:
        self._attach(self._dial())

    # -- ExternalScheduler protocol ----------------------------------------
    def reset(self, system: SystemConfig, jobs: JobSet, t0: float) -> None:
        """Fresh session: (re)connect, handshake, digest-checked resync."""
        self._teardown_connection()
        try:
            self._establish()
            self._n_jobs = len(jobs)
            sys_d, job_d = system_digest(system), job_digest(jobs)
            # the binary dialect ships the columns as raw little-endian
            # arrays (same values — the digests don't change); NDJSON
            # spells them as JSON lists via .tolist(), which yields
            # native floats/ints losslessly without numpy-scalar boxing
            cols = {
                "submit": np.asarray(jobs.submit, np.float64),
                "limit": np.asarray(jobs.limit, np.float64),
                "wall": np.asarray(jobs.wall, np.float64),
                "nodes": np.asarray(jobs.nodes, np.int64),
                "priority": np.asarray(jobs.priority, np.float64),
                "account": np.asarray(jobs.account, np.int64),
            }
            if not self._binary:
                cols = {k: v.tolist() for k, v in cols.items()}
            self._send({
                "version": WIRE_VERSION, "kind": "reset", "t0": float(t0),
                "policy": self.policy, "backfill": self.backfill,
                "system": {"n_nodes": int(system.n_nodes),
                           "dt": float(system.dt), "name": system.name},
                "system_digest": sys_d, "job_digest": job_d,
                "jobs": cols,
            })
            ack = self._recv()
            if ack.get("kind") == "error":
                raise ProtocolError(f"peer rejected reset: "
                                    f"{ack.get('message')!r}")
            if ack.get("kind") != "reset_ack":
                raise ProtocolError(f"expected reset_ack, got "
                                    f"{ack.get('kind')!r}")
            if ack.get("version") != WIRE_VERSION:
                raise ProtocolError(f"wire version mismatch in reset_ack: "
                                    f"{ack.get('version')!r}")
            if ack.get("n_jobs") != len(jobs):
                raise ProtocolError(f"peer deserialized {ack.get('n_jobs')!r}"
                                    f" jobs, sent {len(jobs)}")
            if ack.get("system_digest") != sys_d or \
                    ack.get("job_digest") != job_d:
                raise ProtocolError(
                    "handshake digest mismatch: the peer's view of the "
                    "(system, jobs) state diverged from the twin's — "
                    f"system {ack.get('system_digest')!r} vs {sys_d!r}, "
                    f"jobs {ack.get('job_digest')!r} vs {job_d!r}")
            # handshake (hello + digest-checked reset_ack, which may
            # include the peer computing its whole schedule) ran under
            # handshake_timeout_s; polls get the tighter per-call budget
            self._sock.settimeout(self.timeout_s)
        except ProtocolError:
            # broken speech is terminal for the session: don't leak the
            # half-open connection (or, in SubprocessPeer, the process)
            self._teardown_connection()
            raise

    def poll_wire(self, t: float) -> dict:
        """One poll round-trip; returns the raw envelope for the bridge."""
        self._send({"version": WIRE_VERSION, "kind": "poll", "t": float(t)})
        reply = self._recv()
        if reply.get("kind") == "error":
            raise ProtocolError(f"peer error: {reply.get('message')!r}")
        return reply

    def poll_wire_batch(self, ts) -> dict:
        """One exchange answering many timestamps (``CAP_BATCH`` peers).

        ``SchedulerBridge.poll_many`` only calls this when
        ``batch_capable`` is true, and validates the reply with
        ``decode_running_sets``."""
        self._send({"version": WIRE_VERSION, "kind": "poll_batch",
                    "ts": [float(t) for t in ts]})
        reply = self._recv()
        if reply.get("kind") == "error":
            raise ProtocolError(f"peer error: {reply.get('message')!r}")
        return reply

    def running_at(self, t: float) -> np.ndarray:
        return decode_running(self.poll_wire(t), self._n_jobs or (1 << 31))

    @property
    def start(self) -> np.ndarray:
        """Full schedule (sequential mode): fetched over the wire."""
        self._send({"version": WIRE_VERSION, "kind": "schedule_req"})
        reply = self._recv()
        if reply.get("kind") == "error":
            raise ProtocolError(f"peer error: {reply.get('message')!r}")
        return decode_schedule(reply, self._n_jobs)

    # -- plumbing -----------------------------------------------------------
    def _send(self, msg: dict) -> None:
        if self._wfile is None:
            raise ConnectionError("not connected (reset first)")
        if self._binary:
            write_bin_frame(self._wfile, msg, self.counters)
        else:
            write_frame(self._wfile, msg, self.counters)

    def _recv(self) -> dict:
        if self._rfile is None:
            raise ConnectionError("not connected (reset first)")
        return read_any_frame(self._rfile, self.counters)

    def stats(self) -> dict:
        """Monotonic transport counters for the flight recorder."""
        return {"kind": type(self).__name__, "dials": self.dials,
                "wire": "binary" if self._binary else "ndjson",
                **self.counters.as_dict()}

    def close(self) -> None:
        """Best-effort ``bye``, then drop the connection."""
        if self._wfile is not None:
            try:
                self._send({"version": WIRE_VERSION, "kind": "bye"})
            except (OSError, ConnectionError):
                pass
        self._teardown_connection()

    def __enter__(self) -> "SocketPeer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


@dataclass
class SubprocessPeer(SocketPeer):
    """``SocketPeer`` that owns its peer process.

    The twin listens on a fresh Unix-domain socket (TCP loopback where
    AF_UNIX is unavailable), spawns ``cmd`` with ``--connect <address>``
    appended, and accepts the peer's dial-in within
    ``handshake_timeout_s`` — no bind race. Bridge-driven ``reset``
    kills, *reaps* and respawns the process (full resync); ``close()``
    tears everything down and asserts nothing is left unreaped. Every
    ``Popen`` ever spawned stays in ``spawned`` so tests can verify no
    zombies survive any fault path.
    """
    cmd: str | list[str] = ""
    cwd: str | None = None
    spawned: list = field(default_factory=list)
    _proc: subprocess.Popen | None = None
    _tmpdir: str | None = None

    def _spawn_cmd(self) -> list[str]:
        argv = shlex.split(self.cmd) if isinstance(self.cmd, str) \
            else list(self.cmd)
        if not argv:
            raise ValueError("SubprocessPeer needs a peer command")
        return argv

    def _establish(self) -> None:
        argv = self._spawn_cmd()  # validate before binding anything
        self._tmpdir = tempfile.mkdtemp(prefix="repro-peer-")
        if hasattr(socket, "AF_UNIX"):
            listener = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            listener.bind(os.path.join(self._tmpdir, "peer.sock"))
            address = f"unix:{os.path.join(self._tmpdir, 'peer.sock')}"
        else:  # pragma: no cover - non-POSIX fallback
            listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            listener.bind(("127.0.0.1", 0))
            address = "127.0.0.1:%d" % listener.getsockname()[1]
        listener.listen(1)
        listener.settimeout(self.handshake_timeout_s)
        log = open(os.path.join(self._tmpdir, "peer.log"), "ab")
        try:
            self._proc = subprocess.Popen(
                argv + ["--connect", address],
                stdin=subprocess.DEVNULL, stdout=log, stderr=log,
                cwd=self.cwd)
        except OSError:
            # spawn itself failed (bad command): nothing to accept, and
            # the retry must not leak this attempt's listener or tmpdir
            listener.close()
            self._reap()
            raise
        finally:
            log.close()
        self.spawned.append(self._proc)
        try:
            conn, _ = listener.accept()
        except (socket.timeout, TimeoutError) as e:
            self._reap()
            raise TimeoutError(
                f"peer {argv!r} did not connect within "
                f"{self.handshake_timeout_s}s") from e
        finally:
            listener.close()
        conn.settimeout(self.handshake_timeout_s)
        self.dials += 1
        self._attach(conn)

    def stats(self) -> dict:
        """Transport counters + process lifecycle (spawns/respawns)."""
        out = super().stats()
        out["spawns"] = len(self.spawned)
        out["respawns"] = max(len(self.spawned) - 1, 0)
        return out

    def _reap(self) -> None:
        """Terminate (escalating to kill) and wait() the child, if any;
        always drops this attempt's tmpdir, spawned or not."""
        proc = self._proc
        self._proc = None
        if proc is not None:
            if proc.poll() is None:
                proc.terminate()
                try:
                    proc.wait(timeout=5.0)
                except subprocess.TimeoutExpired:  # pragma: no cover
                    proc.kill()
                    proc.wait()
            else:
                proc.wait()  # already dead: collect the exit status
        if self._tmpdir is not None:
            shutil.rmtree(self._tmpdir, ignore_errors=True)
            self._tmpdir = None

    def _teardown_connection(self) -> None:
        super()._teardown_connection()
        self._reap()

    def __del__(self) -> None:  # safety net; close() is the contract
        try:
            self._teardown_connection()
        except Exception:
            pass
