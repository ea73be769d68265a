"""Byte-faithful snapshot codec for the scan carry (port of
``repro.serve.snapshot``).

A *snapshot* is the serialized form of one branch's carry: the whole
unbatched ``SimState`` (job lifecycle, node occupancy, account ledgers,
the plant's ``CoolingState``, the event state when the layer runs, the
accumulators and the absolute step cursor). Resuming from a decoded
snapshot is bit for bit the same as never having stopped
(``engine.simulate_segment``).

Encoding: every leaf becomes ``{"dtype": "<f4", "shape": [...],
"data": "<base64 raw bytes>"}`` keyed by its dotted field path
(``"accounts.energy"``), walking the dataclasses in field order; a layer
that is off (``events`` None) contributes no leaf. Raw bytes, not JSON
numbers, because a float32 round trip through JSON text is not
bit-faithful. The paths, dtypes and shapes are the JAX package's, so the
payload of a carry built from a JAX carry (``SimState.from_arrays``) is
byte for byte JAX's payload of it, with the same digests, and a snapshot
written by either package resumes in the other.

The scenario codec is the wire form of ``types.Scenario``: plain numbers
per knob, so a fork can carry a sparse delta (``{"setpoint_delta_c":
2.0}``) that ``apply_scenario_delta`` merges over the parent's knobs.
"""
from __future__ import annotations

import base64
import dataclasses
import hashlib
import json

import numpy as np
import torch

from repro_torch.core import types as T

SNAPSHOT_VERSION = 1

# Scenario knobs a fork delta may touch (every field of the port's
# Scenario; policy and backfill accept the names of POLICY_NAMES and
# BACKFILL_NAMES)
SCENARIO_FIELDS = tuple(f.name for f in dataclasses.fields(T.Scenario))


class SnapshotError(ValueError):
    """A snapshot payload is malformed or does not match the template."""


# ---------------------------------------------------------------------------
# Field paths.
# ---------------------------------------------------------------------------
def _flatten(obj, prefix: str = "") -> list:
    """(dotted path, leaf) pairs in field order; None layers are skipped."""
    out = []
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if v is None:
            continue
        if dataclasses.is_dataclass(v):
            out += _flatten(v, f"{prefix}{f.name}.")
        else:
            out.append((prefix + f.name, v))
    return out


def _unflatten(template, values: dict, prefix: str = ""):
    """A dataclass shaped like ``template`` with the leaves of ``values``
    (keyed by dotted path)."""
    kw = {}
    for f in dataclasses.fields(template):
        v = getattr(template, f.name)
        if dataclasses.is_dataclass(v):
            v = _unflatten(v, values, f"{prefix}{f.name}.")
        elif v is not None:
            v = values[prefix + f.name]
        kw[f.name] = v
    return type(template)(**kw)


def _spec(x):
    """(numpy dtype, shape) of a tensor or host-array leaf."""
    if isinstance(x, torch.Tensor):
        return torch.empty((), dtype=x.dtype).numpy().dtype, tuple(x.shape)
    a = np.asarray(x)
    return a.dtype, a.shape


def _host(x) -> np.ndarray:
    """A leaf as a host array (a tensor on the card is copied over)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


# ---------------------------------------------------------------------------
# Array leaf codec (raw little-endian bytes, base64).
# ---------------------------------------------------------------------------
def encode_array(x, binary: bool = False):
    """One leaf (tensor or host array) -> ``{"dtype", "shape", "data"}``
    with base64 raw bytes.

    ``binary=True`` returns a host ndarray instead, for a transport that
    ships raw bytes (the same values without the base64 and JSON
    expansion). It is a copy: writing into it never reaches the carry."""
    # NOT ascontiguousarray: that promotes 0-d arrays to 1-d, and
    # tobytes() below makes its own C-order copy anyway
    a = _host(x)
    if a.dtype.byteorder == ">":  # pragma: no cover - big-endian host
        a = a.astype(a.dtype.newbyteorder("<"))
    if binary:
        return a.copy()
    return {"dtype": a.dtype.str, "shape": list(a.shape),
            "data": base64.b64encode(a.tobytes()).decode("ascii")}


def decode_array(payload) -> np.ndarray:
    """Inverse of ``encode_array``; validates dtype, shape and size.

    Accepts both spellings: the base64 dict, and a bare ndarray (a
    binary-dialect leaf)."""
    if isinstance(payload, np.ndarray):
        return payload
    if not isinstance(payload, dict):
        raise SnapshotError(f"leaf must be an object, got "
                            f"{type(payload).__name__}")
    try:
        dtype = np.dtype(payload["dtype"])
        shape = tuple(int(s) for s in payload["shape"])
        raw = base64.b64decode(payload["data"], validate=True)
        want = dtype.itemsize * int(np.prod(shape, dtype=np.int64))
    except (KeyError, TypeError, ValueError, OverflowError) as e:
        raise SnapshotError(f"malformed array leaf: {e}") from e
    if len(raw) != want:
        raise SnapshotError(f"array leaf carries {len(raw)} bytes, "
                            f"dtype/shape imply {want}")
    try:
        return np.frombuffer(raw, dtype=dtype).reshape(shape).copy()
    except ValueError as e:       # an object dtype, two negative dimensions
        raise SnapshotError(f"malformed array leaf: {e}") from e


# ---------------------------------------------------------------------------
# Carry codec.
# ---------------------------------------------------------------------------
def encode_carry(carry: T.SimState, binary: bool = False) -> dict:
    """Serialize an unbatched carry (tensors on any device, or a host
    checkpoint of numpy arrays) to a strict-JSON payload.

    The payload describes itself (``v``, per-leaf dtype and shape), but
    decoding needs a *template* (any carry of the same (system, table)
    lineage: ``engine.init_state`` builds one), since the structure
    itself is not serialized. ``binary=True`` gives the raw-array
    dialect; ``carry_digest`` is the digest both dialects share.
    """
    return {"v": SNAPSHOT_VERSION,
            "leaves": {path: encode_array(leaf, binary=binary)
                       for path, leaf in _flatten(carry)}}


def decode_carry(payload: dict, template: T.SimState) -> T.SimState:
    """Rebuild a carry from ``encode_carry`` output, byte-faithfully, as
    CPU tensors (the entry points move it to their device).

    ``template`` (tensors or host arrays) gives the structure; every
    leaf's dtype and shape must match the template's, so a snapshot of
    another system or job-table shape fails loudly instead of resuming
    wrongly. Each tensor is a copy, never a view of the payload.
    """
    if not isinstance(payload, dict):
        raise SnapshotError(f"snapshot must be an object, got "
                            f"{type(payload).__name__}")
    if payload.get("v") != SNAPSHOT_VERSION:
        raise SnapshotError(f"snapshot version mismatch: "
                            f"{payload.get('v')!r} != {SNAPSHOT_VERSION}")
    leaves = payload.get("leaves")
    if not isinstance(leaves, dict):
        raise SnapshotError("snapshot missing 'leaves' object")
    t_leaves = _flatten(template)
    paths = {p for p, _ in t_leaves}
    missing = [p for p, _ in t_leaves if p not in leaves]
    extra = [p for p in leaves if p not in paths]
    if missing or extra:
        raise SnapshotError(
            f"snapshot leaves do not match the template: "
            f"missing {missing or '[]'}, unknown {extra or '[]'}")
    out = {}
    for path, ref in t_leaves:
        a = decode_array(leaves[path])
        dtype, shape = _spec(ref)
        if a.dtype != dtype or a.shape != shape:
            raise SnapshotError(
                f"leaf {path!r}: snapshot is {a.dtype}{list(a.shape)}, "
                f"template needs {dtype}{list(shape)}")
        out[path] = torch.tensor(a)
    return _unflatten(template, out)


def snapshot_digest(payload: dict) -> str:
    """sha256 over the canonical JSON of a snapshot payload (sorted keys,
    no whitespace): two encodes of one carry digest alike on any host.
    Defined for the base64 dialect only; ``carry_digest`` holds across
    dialects."""
    blob = json.dumps(payload, separators=(",", ":"), sort_keys=True)
    return hashlib.sha256(blob.encode("utf-8")).hexdigest()


def carry_digest(payload: dict) -> str:
    """Dialect-independent sha256 over a snapshot's content: (path,
    dtype, shape, raw little-endian bytes) per leaf in sorted path order,
    so one carry digests alike whether it was encoded as base64 JSON or
    as raw arrays."""
    leaves = payload.get("leaves") if isinstance(payload, dict) else None
    if not isinstance(leaves, dict):
        raise SnapshotError("snapshot missing 'leaves' object")
    h = hashlib.sha256()
    h.update(b"carry-digest-v%d" % SNAPSHOT_VERSION)
    for path in sorted(leaves):
        a = decode_array(leaves[path])
        if a.dtype.byteorder == ">":  # pragma: no cover - big-endian host
            a = a.astype(a.dtype.newbyteorder("<"))
        h.update(path.encode("utf-8"))
        h.update(a.dtype.str.encode("ascii"))
        h.update(json.dumps(list(a.shape)).encode("ascii"))
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


# ---------------------------------------------------------------------------
# Scenario wire codec.
# ---------------------------------------------------------------------------
def encode_scenario(scen: T.Scenario) -> dict:
    """Scenario -> plain ints, floats and lists (the fork-request form)."""
    out = {}
    for name in SCENARIO_FIELDS:
        a = _host(getattr(scen, name))
        if name in ("policy", "backfill"):
            out[name] = int(a)
        else:
            out[name] = a.tolist() if a.ndim else float(a)
    return out


def apply_scenario_delta(parent: T.Scenario, delta: dict) -> T.Scenario:
    """Merge a sparse knob delta over a parent branch's scenario.

    ``delta`` keys must be Scenario fields; ``policy``/``backfill``
    accept wire names ("fcfs", "easy") or raw ids, every other knob a
    number or list (``cells_offline`` per hall, ``alpha`` per scoring
    column). An empty delta
    gives a scenario equal to the parent: the *neutral fork*, whose
    branch stays bit for bit its parent.

    Every merged knob keeps the **parent's shape**, since a coalesced
    batch stacks the branches' scenarios knob by knob: a delta that
    would reshape one is refused here, at fork time, and a scalar on a
    vector knob is broadcast.
    """
    if not isinstance(delta, dict):
        raise SnapshotError(f"scenario delta must be an object, got "
                            f"{type(delta).__name__}")
    unknown = sorted(set(delta) - set(SCENARIO_FIELDS))
    if unknown:
        raise SnapshotError(f"unknown scenario knob(s): "
                            f"{', '.join(unknown)}; valid: "
                            f"{', '.join(SCENARIO_FIELDS)}")
    merged = encode_scenario(parent)
    for k, v in delta.items():
        if k in ("policy", "backfill"):
            names = T.POLICY_NAMES if k == "policy" else T.BACKFILL_NAMES
            if isinstance(v, str):
                if v not in names:
                    raise SnapshotError(f"unknown {k} {v!r}")
                v = names[v]
            elif not isinstance(v, int) or isinstance(v, bool) or \
                    v not in names.values():
                raise SnapshotError(f"{k} must be a name or known id, "
                                    f"got {v!r}")
            merged[k] = int(v)
        else:
            ok_num = isinstance(v, (int, float)) and not isinstance(v, bool)
            ok_vec = (isinstance(v, list) and v and
                      all(isinstance(x, (int, float)) and
                          not isinstance(x, bool) for x in v))
            if not (ok_num or ok_vec):
                raise SnapshotError(f"scenario knob {k!r} must be a "
                                    f"number or list of numbers, got {v!r}")
            ref_shape = tuple(getattr(parent, k).shape)
            if ok_vec:
                if not ref_shape:
                    raise SnapshotError(
                        f"scenario knob {k!r} is a scalar in this "
                        f"session; a {len(v)}-element vector would "
                        f"change its shape")
                if len(v) != ref_shape[0]:
                    raise SnapshotError(
                        f"scenario knob {k!r} must have length "
                        f"{ref_shape[0]} in this session, got {len(v)}")
                merged[k] = [float(x) for x in v]
            elif ref_shape:
                # scalar onto a vector knob: broadcast explicitly so the
                # child's knob keeps the parent's shape
                merged[k] = [float(v)] * ref_shape[0]
            else:
                merged[k] = v
    return T.Scenario(
        policy=torch.tensor(merged["policy"], dtype=torch.int32),
        backfill=torch.tensor(merged["backfill"], dtype=torch.int32),
        **{k: torch.tensor(np.asarray(merged[k], np.float32))
           for k in SCENARIO_FIELDS if k not in ("policy", "backfill")})
