"""Run manifests and the NDJSON event log (the flight recorder proper;
port of ``repro.obs.recorder``).

``RunRecorder`` is the per-invocation recorder: it mints a run id,
appends lifecycle events (scan start and end, server connects, advance
batches, ...) to an NDJSON event log as they happen, and writes the
schema-versioned run manifest (``repro_torch.obs.schema``) when the run
finalizes, so a crash mid-run still leaves the event log behind.

The manifest's identity fields are the wire's digests
(``core.transport.system_digest`` / ``job_digest``): two runs of the
same (system, jobs) produce byte-identical digests, in either package.
The copy departs from the reference only in ``runtime_versions``, which
records torch, its CUDA build and the device instead of JAX's backend.

Typical CLI wiring (``launch/simulate.py --manifest run.json --events
run.ndjson``)::

    rec = RunRecorder(manifest_path="run.json", events_path="run.ndjson")
    rec.begin(command="simulate", argv=argv, system=sys_, jobs=js,
              scenario={"policy": "fcfs"}, seed=0)
    rec.event("run_start")
    ... run, with obs.timing spans mirrored via SpanTimer(listener=...) ...
    rec.finalize(spans=timer.summary(), counters={...}, wall_s=wall)
"""
from __future__ import annotations

import json
import pathlib
import platform
import secrets
import subprocess
import time
from typing import IO, Optional

from repro_torch.obs import schema


def _git_sha() -> Optional[str]:
    """Best-effort HEAD sha of the working tree; None outside a repo."""
    try:
        out = subprocess.run(
            ["git", "rev-parse", "HEAD"],
            cwd=pathlib.Path(__file__).resolve().parent,
            capture_output=True, text=True, timeout=5.0)
    except (OSError, subprocess.SubprocessError):
        return None
    sha = out.stdout.strip()
    return sha if out.returncode == 0 and len(sha) == 40 else None


def runtime_versions() -> dict:
    """python/torch/numpy versions, the CUDA toolkit torch was built
    with, and the backend (``cuda`` when a card is visible, else
    ``cpu``) with its device name. The copied schema requires a ``jax``
    key; the port never imports JAX, so it is None, as the reference
    records it where JAX is absent."""
    import numpy as np
    import torch
    cuda = torch.cuda.is_available()
    return {"python": platform.python_version(),
            "numpy": np.__version__,
            "torch": torch.__version__,
            "cuda": torch.version.cuda,
            "jax": None,
            "backend": "cuda" if cuda else "cpu",
            "device": (torch.cuda.get_device_name(0) if cuda
                       else platform.processor() or "cpu")}


def build_manifest(system, command: str, argv: list, scenario: dict,
                   seed: Optional[int] = None, jobs=None,
                   run_id: Optional[str] = None,
                   git_sha: Optional[str] = "auto",
                   created_unix: Optional[float] = None,
                   extra: Optional[dict] = None) -> dict:
    """Assemble a schema-valid run manifest (no I/O besides git).

    Args:
      system: ``SystemConfig`` — digested via ``transport.system_digest``.
      command: invocation kind ("simulate" | "sweep" | "train" | ...).
      argv: the CLI argument list, verbatim.
      scenario: what-if knobs of the run (policies, offsets, ...).
      seed: RNG seed, when the run has one.
      jobs: optional ``JobSet`` — digested via ``transport.job_digest``.
      run_id: externally minted id (default: fresh 16-hex token).
      git_sha: "auto" resolves HEAD; pass None/str to skip/pin.
      created_unix: epoch seconds (default: now; injectable for tests).
      extra: optional JSON-able dict merged in at the top level (e.g.
        ``{"env_preset": launch.env.report()}``); the schema only pins
        required fields, so extra keys validate and round-trip.
    """
    from repro_torch.core import transport as tr

    manifest = {
        "schema_version": schema.SCHEMA_VERSION,
        "kind": schema.KIND_MANIFEST,
        "run_id": run_id or secrets.token_hex(8),
        "command": str(command),
        "argv": [str(a) for a in argv],
        "created_unix": float(time.time() if created_unix is None
                              else created_unix),
        "system": {
            "name": system.name,
            "n_nodes": int(system.n_nodes),
            "dt": float(system.dt),
            "n_halls": int(system.cooling.n_halls),
            "digest": tr.system_digest(system),
        },
        "jobs": {"n_jobs": (len(jobs) if jobs is not None else 0),
                 "digest": (tr.job_digest(jobs) if jobs is not None
                            else None)},
        "scenario": schema.jsonable(scenario),
        "seed": None if seed is None else int(seed),
        "versions": runtime_versions(),
        "git_sha": _git_sha() if git_sha == "auto" else git_sha,
    }
    if extra:
        manifest.update(schema.jsonable(extra))
    return schema.validate_manifest(manifest)


class RunRecorder:
    """Per-run flight recorder: event log now, manifest at finalize."""

    def __init__(self, manifest_path=None, events_path=None,
                 run_id: Optional[str] = None,
                 clock=time.time):
        self.manifest_path = manifest_path
        self.events_path = events_path
        self.run_id = run_id or secrets.token_hex(8)
        self.clock = clock
        self.manifest: Optional[dict] = None
        self.n_events = 0
        self._efile: Optional[IO[bytes]] = None

    # -- lifecycle ----------------------------------------------------------
    def begin(self, system, command: str, argv: list, scenario: dict,
              seed: Optional[int] = None, jobs=None,
              extra: Optional[dict] = None) -> dict:
        """Build the base manifest up front (identity is known at start;
        spans/counters arrive at ``finalize``)."""
        self.manifest = build_manifest(
            system, command=command, argv=argv, scenario=scenario,
            seed=seed, jobs=jobs, run_id=self.run_id, extra=extra)
        return self.manifest

    def event(self, event: str, **fields) -> dict:
        """Append one lifecycle event to the NDJSON log (flushed line by
        line, so a killed run keeps everything recorded so far)."""
        frame = schema.event_frame(self.run_id, self.n_events,
                                   self.clock(), event, **fields)
        self.n_events += 1
        if self.events_path is not None:
            from repro_torch.core.transport import write_frame
            if self._efile is None:
                pathlib.Path(self.events_path).parent.mkdir(
                    parents=True, exist_ok=True)
                self._efile = open(self.events_path, "wb")
            write_frame(self._efile, frame)
        return frame

    def span_listener(self, what: str, fields: dict) -> None:
        """Adapter for ``SpanTimer(listener=...)``: mirrors every span
        start/end into the event log (compile start/end, scan start/end
        arrive this way)."""
        self.event(what, **fields)

    def finalize(self, spans: Optional[dict] = None,
                 counters: Optional[dict] = None, **extra) -> Optional[dict]:
        """Attach spans/counters + extras, write the manifest, close."""
        if self.manifest is not None:
            if spans is not None:
                self.manifest["spans"] = schema.jsonable(spans)
            if counters is not None:
                self.manifest["counters"] = schema.jsonable(counters)
            self.manifest["n_events"] = self.n_events
            for k, v in extra.items():
                self.manifest[k] = schema.jsonable(v)
            if self.manifest_path is not None:
                p = pathlib.Path(self.manifest_path)
                p.parent.mkdir(parents=True, exist_ok=True)
                p.write_text(json.dumps(self.manifest, indent=1,
                                        sort_keys=True) + "\n")
        self.close()
        return self.manifest

    def close(self) -> None:
        if self._efile is not None:
            self._efile.close()
            self._efile = None

    def __enter__(self) -> "RunRecorder":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def load_manifest(path) -> dict:
    """Read + schema-validate a manifest JSON from disk."""
    manifest = json.loads(pathlib.Path(path).read_text())
    return schema.validate_manifest(manifest)
