"""Flight-recorder wire schema: run manifests and NDJSON frame envelopes
(a copy of ``repro.obs.schema``; it imports numpy only).

Everything the observability layer writes is schema-versioned, so a
dashboard can evolve independently of the twin. Two artifact shapes:

* **Run manifest**: one JSON document per ``simulate``/``sweep``/
  ``train`` invocation: what ran (system/topology and job digests,
  scenario knobs, seed), on what (framework and backend versions, git
  sha), and how (timing spans, counters). ``validate_manifest`` is the
  contract a consumer can rely on.
* **NDJSON frames**: the event log and the metrics stream are
  newline-delimited JSON frames in the scheduler wire's framing.

Every frame carries ``v`` (== ``SCHEMA_VERSION``) and ``kind`` (one of
``FRAME_KINDS``). Non-finite floats are not JSON: ``jsonable`` maps
NaN/±inf to ``null`` so frames always survive a strict JSON parser.
"""
from __future__ import annotations

import math
from typing import Iterable

import numpy as np

SCHEMA_VERSION = 1

KIND_MANIFEST = "run_manifest"
KIND_EVENT = "event"
KIND_METRICS = "metrics"
KIND_SUMMARY = "summary"
FRAME_KINDS = (KIND_EVENT, KIND_METRICS, KIND_SUMMARY)

# manifest fields a consumer may rely on (name -> required type(s))
MANIFEST_REQUIRED = {
    "schema_version": int,
    "kind": str,
    "run_id": str,
    "command": str,           # "simulate" | "sweep" | "train" | ...
    "argv": list,
    "created_unix": (int, float),
    "system": dict,           # name, n_nodes, dt, n_halls, digest
    "jobs": dict,             # n_jobs, digest (digest may be None)
    "scenario": dict,         # the what-if knobs of the run
    "seed": (int, type(None)),
    "versions": dict,         # python, jax, numpy, backend, device
    "git_sha": (str, type(None)),
}
SYSTEM_REQUIRED = ("name", "n_nodes", "dt", "n_halls", "digest")
VERSIONS_REQUIRED = ("python", "jax", "numpy", "backend")


class SchemaError(ValueError):
    """A manifest or frame violates the flight-recorder schema."""


def jsonable(x):
    """Recursively convert ``x`` to strict-JSON-safe python values.

    numpy scalars/arrays become native lists, non-finite floats become
    ``None`` (strict JSON has no NaN/Infinity — and the engine's
    telemetry legitimately contains +inf, e.g. the uncapped ``cap_w``).
    """
    if isinstance(x, (np.floating, float)):
        f = float(x)
        return f if math.isfinite(f) else None
    if isinstance(x, (np.integer, int)) and not isinstance(x, bool):
        return int(x)
    if isinstance(x, np.ndarray):
        return [jsonable(v) for v in x.tolist()]
    if isinstance(x, dict):
        return {str(k): jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [jsonable(v) for v in x]
    return x


# ---------------------------------------------------------------------------
# Frame constructors.
# ---------------------------------------------------------------------------
def event_frame(run_id: str, seq: int, t_wall: float, event: str,
                **fields) -> dict:
    """One lifecycle-event NDJSON frame (compile start/end, checkpoint,
    respawn, ...). ``t_wall`` is host wall-clock seconds (epoch)."""
    return {"v": SCHEMA_VERSION, "kind": KIND_EVENT, "run_id": run_id,
            "seq": int(seq), "t_wall": float(t_wall), "event": str(event),
            **jsonable(fields)}


def metrics_frame(run_id: str, seq: int, t_sim: float, data: dict,
                  label: str | None = None) -> dict:
    """One per-interval metrics NDJSON frame.

    ``t_sim`` is simulated seconds; ``data`` carries the StepRecord
    telemetry for that interval (scalars and per-hall lists); ``label``
    tags the scenario in a sweep (e.g. ``"fcfs:easy"``)."""
    frame = {"v": SCHEMA_VERSION, "kind": KIND_METRICS, "run_id": run_id,
             "seq": int(seq), "t_sim": float(t_sim),
             "data": jsonable(data)}
    if label is not None:
        frame["label"] = str(label)
    return frame


def summary_frame(run_id: str, data: dict, label: str | None = None) -> dict:
    """End-of-run summary frame (the ``stats.summarize`` reductions)."""
    frame = {"v": SCHEMA_VERSION, "kind": KIND_SUMMARY, "run_id": run_id,
             "data": jsonable(data)}
    if label is not None:
        frame["label"] = str(label)
    return frame


# ---------------------------------------------------------------------------
# Validation.
# ---------------------------------------------------------------------------
def validate_frame(frame: dict) -> dict:
    """Check the envelope of an NDJSON frame; returns it unchanged."""
    if not isinstance(frame, dict):
        raise SchemaError(f"frame must be a JSON object, got "
                          f"{type(frame).__name__}")
    if frame.get("v") != SCHEMA_VERSION:
        raise SchemaError(f"frame schema version mismatch: "
                          f"{frame.get('v')!r} != {SCHEMA_VERSION}")
    if frame.get("kind") not in FRAME_KINDS:
        raise SchemaError(f"unknown frame kind {frame.get('kind')!r}; "
                          f"valid: {', '.join(FRAME_KINDS)}")
    if not isinstance(frame.get("run_id"), str):
        raise SchemaError("frame missing run_id")
    return frame


def _check_fields(obj: dict, required: Iterable[str], where: str) -> None:
    missing = [k for k in required if k not in obj]
    if missing:
        raise SchemaError(f"{where} missing field(s): "
                          f"{', '.join(sorted(missing))}")


def validate_manifest(manifest: dict) -> dict:
    """Check a run manifest against the schema; returns it unchanged.

    Raises ``SchemaError`` naming every missing/ill-typed field, so a
    consumer failure points at the producer bug, not a KeyError."""
    if not isinstance(manifest, dict):
        raise SchemaError(f"manifest must be a JSON object, got "
                          f"{type(manifest).__name__}")
    errors = []
    for name, types in MANIFEST_REQUIRED.items():
        if name not in manifest:
            errors.append(f"missing field {name!r}")
        elif not isinstance(manifest[name], types):
            errors.append(f"field {name!r} has type "
                          f"{type(manifest[name]).__name__}")
    if errors:
        raise SchemaError("invalid manifest: " + "; ".join(errors))
    if manifest["schema_version"] != SCHEMA_VERSION:
        raise SchemaError(f"manifest schema version mismatch: "
                          f"{manifest['schema_version']} != "
                          f"{SCHEMA_VERSION}")
    if manifest["kind"] != KIND_MANIFEST:
        raise SchemaError(f"manifest kind must be {KIND_MANIFEST!r}, got "
                          f"{manifest['kind']!r}")
    _check_fields(manifest["system"], SYSTEM_REQUIRED, "manifest.system")
    _check_fields(manifest["versions"], VERSIONS_REQUIRED,
                  "manifest.versions")
    _check_fields(manifest["jobs"], ("n_jobs", "digest"), "manifest.jobs")
    return manifest
