"""The external-scheduler wire's host part (port of the envelope half
of ``repro.core.external``).

The twin speaks a *versioned* wire format: every envelope carries
``version == WIRE_VERSION`` and a ``kind``. A poll answer is ``{"version":
WIRE_VERSION, "kind": "running_set", "job_ids": [...]}``
(``encode_running`` / ``decode_running``), validated before it could
touch engine state: version mismatches, non-integer ids, out-of-range
ids and duplicates raise ``ProtocolError``. ``core.transport`` and the
twin service (``repro_torch.serve``) build on these definitions.

This module is the host-only part of the reference (which imports JAX
and the engine). ``SchedulerBridge``, the FastSim and ScheduleFlow
peers, the plugin and sequential coupling modes and the engine's
``external_step`` are not ported yet (ROADMAP item 14).
"""
from __future__ import annotations

from typing import Iterable

import numpy as np

WIRE_VERSION = 1
WIRE_KIND_RUNNING = "running_set"
WIRE_KIND_RUNNING_SETS = "running_sets"  # batched poll_batch answer


class ProtocolError(RuntimeError):
    """The peer answered with a malformed / wrong-version wire message."""


class BridgeTimeout(RuntimeError):
    """The peer kept exceeding the per-call budget after reconnects."""


# ---------------------------------------------------------------------------
# Wire format.
# ---------------------------------------------------------------------------
def encode_running(job_ids: Iterable[int]) -> dict:
    """Wrap a running-set answer in the versioned wire envelope."""
    return {"version": WIRE_VERSION, "kind": WIRE_KIND_RUNNING,
            "job_ids": [int(j) for j in job_ids]}


def decode_running(msg, n_jobs: int) -> np.ndarray:
    """Validate a wire envelope and return the running-set ids (i64[K]).

    Raises ``ProtocolError`` on anything a confused or wrong-version peer
    could send: not a dict, missing/mismatched version, wrong kind,
    non-integer ids, ids outside ``[0, n_jobs)``, duplicates.
    """
    if not isinstance(msg, dict):
        raise ProtocolError(f"wire message must be a dict envelope, "
                            f"got {type(msg).__name__}")
    ver = msg.get("version")
    if ver != WIRE_VERSION:
        raise ProtocolError(f"wire version mismatch: peer speaks {ver!r}, "
                            f"bridge speaks {WIRE_VERSION}")
    if msg.get("kind") != WIRE_KIND_RUNNING:
        raise ProtocolError(f"unexpected message kind {msg.get('kind')!r}")
    ids = msg.get("job_ids")
    if isinstance(ids, (list, tuple)) and \
            any(isinstance(x, bool) for x in ids):
        # JSON true/false would silently cast to 1/0 through np.asarray
        raise ProtocolError("job_ids must be integers, got booleans")
    try:
        arr = np.asarray(ids)
    except Exception as e:  # ragged / object payloads
        raise ProtocolError(f"job_ids not array-like: {e}") from e
    if arr.ndim != 1:
        # ndim before the empty-fastpath: a nested-but-empty payload like
        # [[]] has size 0 and must still be rejected, not silently passed
        raise ProtocolError(f"job_ids must be a flat integer list, got "
                            f"ndim={arr.ndim}")
    if arr.size == 0:
        return np.zeros((0,), np.int64)
    if not np.issubdtype(arr.dtype, np.integer):
        raise ProtocolError(f"job_ids must be a flat integer list, got "
                            f"dtype={arr.dtype}")
    arr = arr.astype(np.int64)
    if arr.min() < 0 or arr.max() >= n_jobs:
        raise ProtocolError(f"job id out of range [0, {n_jobs}): "
                            f"[{arr.min()}, {arr.max()}]")
    if np.unique(arr).size != arr.size:
        raise ProtocolError("duplicate job ids in running set")
    return arr


def encode_running_sets(sets: Iterable[Iterable[int]]) -> dict:
    """Wrap a batched running-set answer (one set per polled timestamp)."""
    return {"version": WIRE_VERSION, "kind": WIRE_KIND_RUNNING_SETS,
            "sets": [[int(j) for j in ids] for ids in sets]}


def decode_running_sets(msg, n_jobs: int, n_expected: int) -> list[np.ndarray]:
    """Validate a batched envelope; returns one id array per timestamp.

    Each inner set goes through the exact ``decode_running`` validation
    (version handled once at the envelope level), so a batched peer
    cannot sneak anything past the bridge that a per-poll peer could not.
    """
    if not isinstance(msg, dict):
        raise ProtocolError(f"wire message must be a dict envelope, "
                            f"got {type(msg).__name__}")
    ver = msg.get("version")
    if ver != WIRE_VERSION:
        raise ProtocolError(f"wire version mismatch: peer speaks {ver!r}, "
                            f"bridge speaks {WIRE_VERSION}")
    if msg.get("kind") != WIRE_KIND_RUNNING_SETS:
        raise ProtocolError(f"unexpected message kind {msg.get('kind')!r}")
    sets = msg.get("sets")
    if not isinstance(sets, (list, tuple)):
        raise ProtocolError(f"'sets' must be a list, got "
                            f"{type(sets).__name__}")
    if len(sets) != n_expected:
        raise ProtocolError(f"batched poll answered {len(sets)} sets for "
                            f"{n_expected} timestamps")
    return [decode_running({"version": WIRE_VERSION,
                            "kind": WIRE_KIND_RUNNING, "job_ids": ids},
                           n_jobs) for ids in sets]


# transport-style failures the bridge may heal by reconnecting; anything
# else raised by a peer is a peer bug and must surface with its own
# traceback (a reconnect would mask it and replay side effects)
TRANSPORT_ERRORS = (ConnectionError, OSError, TimeoutError)
