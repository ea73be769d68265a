"""RAPS-style telemetry ingestion: ``joblive`` + ``jobprofile`` -> NPZ (the
port's copy of ``repro.traces.telemetry``: the same digests and the same
``_CACHE_VERSION``, so each package reads the other's cache; reading an
NPZ needs only numpy).

Site telemetry dumps arrive as two directory trees of CSV shards
(``joblive/date=YYYY-MM-DD/*.csv`` with one scheduler row per job, and
``jobprofile/date=YYYY-MM-DD/*.csv`` with timestamped per-node power
samples keyed by job id). ``load_telemetry`` folds both into one
``JobSet`` whose ``power_profile`` channel the engine replays verbatim
(``to_table(replay_power=True)``), and caches the parsed result as a
single NPZ, content-addressed by a digest of the source bytes — the
RAPS workflow ("once the data has been processed, it will be saved as
an NPZ file, which can be more quickly started in subsequent
simulations"). A cache hit reproduces the cold parse bit-for-bit; a
stale cache (edited sources) is simply a different digest, so it can
never be read by mistake.

Expected columns — ``joblive``: job_id, time_submission, time_start,
time_end, time_limit (s), node_count, user. ``jobprofile``: timestamp,
job_id, node_power_w (mean per-node watts at that instant). Timestamps
may be numeric seconds or parseable datetimes. Any malformed row, or a
profile sample whose job id never appears in joblive, raises
``TraceError``.
"""
from __future__ import annotations

import hashlib
import pathlib

import numpy as np

from repro_torch.datasets.base import JobSet
from repro_torch.traces.errors import TraceError
from repro_torch.traces.jobtable import (TraceSchema, _seconds, _whole_seconds,
                                   jobset_from_frame)

# joblive carries its walltime limit in seconds (scheduler export),
# unlike the minutes convention of published job tables.
JOBLIVE_SCHEMA = TraceSchema(
    job_id="job_id", submit_time="time_submission", start_time="time_start",
    end_time="time_end", run_time=None, nodes="node_count",
    time_limit="time_limit", user="user", priority=None, limit_unit="s")

_CACHE_VERSION = 1   # bump to invalidate every cached NPZ


def _iter_files(root: pathlib.Path) -> list[pathlib.Path]:
    if root.is_file():
        return [root]
    files = sorted(q for q in root.rglob("*") if q.is_file())
    if not files:
        raise TraceError(f"no telemetry files under {root}")
    return files


def source_digest(*roots: str | pathlib.Path) -> str:
    """Content digest of a telemetry source (files or directory trees):
    sha256 over (relative name, bytes) of every file, in sorted order.
    Names the NPZ cache entry, and lands in run manifests so an
    experiment records exactly which trace bytes produced it."""
    h = hashlib.sha256()
    for root in roots:
        root = pathlib.Path(root)
        if not root.exists():
            raise TraceError(f"telemetry source {root} does not exist")
        for q in _iter_files(root):
            rel = q.name if root.is_file() else q.relative_to(root).as_posix()
            h.update(rel.encode())
            h.update(b"\0")
            h.update(q.read_bytes())
            h.update(b"\0")
    return h.hexdigest()


def _read_csv_tree(root: pathlib.Path):
    """Concatenate every CSV shard under ``root`` (sorted for
    determinism) into one dataframe."""
    import pandas as pd
    shards = [q for q in _iter_files(root) if q.suffix == ".csv"]
    if not shards:
        raise TraceError(f"no CSV shards under {root}")
    frames = []
    for q in shards:
        try:
            frames.append(pd.read_csv(q))
        except Exception as e:
            raise TraceError(f"cannot read telemetry shard {q}: {e}") from e
    return pd.concat(frames, ignore_index=True)


def _resample_locf(t: np.ndarray, v: np.ndarray,
                   grid: np.ndarray) -> np.ndarray:
    """Last-observation-carried-forward onto ``grid`` (the engine's
    profile-index semantics); grid points before the first sample take
    the first sample."""
    idx = np.searchsorted(t, grid, side="right") - 1
    return v[np.clip(idx, 0, len(v) - 1)]


def jobset_to_npz(js: JobSet, path: str | pathlib.Path,
                  digest: str = "") -> None:
    """Serialize a ``JobSet`` (all channels) to one NPZ."""
    arrays = dict(submit=js.submit, limit=js.limit, wall=js.wall,
                  nodes=js.nodes, priority=js.priority, account=js.account,
                  rec_start=js.rec_start, power_prof=js.power_prof,
                  util_prof=js.util_prof,
                  name=np.array(js.name), digest=np.array(digest),
                  version=np.array(_CACHE_VERSION))
    for opt in ("first_node", "score", "ml_basis", "power_profile"):
        v = getattr(js, opt)
        if v is not None:
            arrays[opt] = v
    tmp = pathlib.Path(path).with_suffix(".tmp")
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    tmp.replace(path)


def jobset_from_npz(path: str | pathlib.Path) -> JobSet:
    """Load a ``jobset_to_npz`` archive back, bit-for-bit."""
    try:
        z = np.load(path, allow_pickle=False)
    except Exception as e:
        raise TraceError(f"cannot read trace NPZ {path}: {e}") from e
    if "version" not in z or int(z["version"]) != _CACHE_VERSION:
        raise TraceError(f"{path}: unknown trace-NPZ version "
                         f"(want {_CACHE_VERSION})")

    def opt(k):
        return z[k] if k in z.files else None
    return JobSet(submit=z["submit"], limit=z["limit"], wall=z["wall"],
                  nodes=z["nodes"], priority=z["priority"],
                  account=z["account"], rec_start=z["rec_start"],
                  power_prof=z["power_prof"], util_prof=z["util_prof"],
                  first_node=opt("first_node"), score=opt("score"),
                  ml_basis=opt("ml_basis"),
                  power_profile=opt("power_profile"),
                  name=str(z["name"]))


def load_telemetry(joblive: str | pathlib.Path,
                   jobprofile: str | pathlib.Path | None = None,
                   prof_dt: float = 20.0,
                   cache_dir: str | pathlib.Path | None = None,
                   node_power_w: float = 500.0,
                   util: float = 0.7) -> JobSet:
    """Load a telemetry trace into a replay-capable ``JobSet``.

    Args:
      joblive: the ``joblive`` directory (CSV shards) — or a previously
        cached ``.npz``, which short-circuits everything else.
      jobprofile: the matching ``jobprofile`` directory; ``None`` means
        scheduler rows only (no measured power channel).
      prof_dt: grid spacing (s) the measured samples are resampled onto —
        pass ``SystemConfig.prof_dt`` so replay indexing lines up.
      cache_dir: directory for the content-addressed NPZ cache
        (``trace-<digest16>.npz``); ``None`` disables caching.
      node_power_w / util: model fallback for profile-less jobs.

    Returns:
      ``JobSet`` where ``power_prof`` holds each profiled job's measured
      mean (the model view) and ``power_profile`` the full measured
      series on the ``prof_dt`` grid, ``-1`` rows marking profile-less
      jobs.
    """
    joblive = pathlib.Path(joblive)
    if joblive.suffix == ".npz":
        return jobset_from_npz(joblive)

    sources = [joblive] + ([pathlib.Path(jobprofile)] if jobprofile else [])
    digest = source_digest(*sources)
    cache = None
    if cache_dir is not None:
        cache_dir = pathlib.Path(cache_dir)
        cache_dir.mkdir(parents=True, exist_ok=True)
        cache = cache_dir / f"trace-{digest[:16]}.npz"
        if cache.exists():
            return jobset_from_npz(cache)

    live = _read_csv_tree(joblive)
    js = jobset_from_frame(live, JOBLIVE_SCHEMA, node_power_w=node_power_w,
                           util=util, origin_s=None,
                           name=f"telemetry-{digest[:8]}")
    # jobset_from_frame sorts by submit; recover the job_id of each row
    # so profile samples can be joined back on
    raw_submit = _seconds(live[JOBLIVE_SCHEMA.submit_time].to_numpy(),
                          "submit")
    order = np.argsort(_whole_seconds(raw_submit - np.min(raw_submit)),
                       kind="stable")
    job_ids = live[JOBLIVE_SCHEMA.job_id].to_numpy()[order]
    if len(np.unique(job_ids)) != len(job_ids):
        raise TraceError(f"{joblive}: duplicate job ids in joblive")
    origin_s = float(np.min(raw_submit))

    if jobprofile is not None:
        prof = _read_csv_tree(pathlib.Path(jobprofile))
        for col in ("timestamp", "job_id", "node_power_w"):
            if col not in prof.columns:
                raise TraceError(f"jobprofile is missing column {col!r} "
                                 f"(have: {list(prof.columns)})")
        pt = _seconds(prof["timestamp"].to_numpy(), "timestamp") - origin_s
        pw = prof["node_power_w"].to_numpy().astype(np.float64)
        pj = prof["job_id"].to_numpy()
        if not np.isfinite(pt).all():
            raise TraceError("jobprofile: non-finite timestamp")
        if (~np.isfinite(pw) | (pw < 0)).any():
            raise TraceError("jobprofile: non-finite or negative power")
        row_of = {j: i for i, j in enumerate(job_ids)}
        unknown = [j for j in np.unique(pj) if j not in row_of]
        if unknown:
            raise TraceError(f"jobprofile references job ids absent from "
                             f"joblive: {unknown[:5]}")
        rows = np.array([row_of[j] for j in pj])

        Q = max(1, int(np.ceil(float(np.max(js.wall)) / prof_dt)))
        profile = np.full((len(js), Q), -1.0, np.float32)
        mean_w = np.array(js.power_prof[:, 0], np.float64)
        grid = np.arange(Q) * prof_dt
        for r in np.unique(rows):
            sel = rows == r
            t, v = pt[sel], pw[sel]
            srt = np.argsort(t, kind="stable")
            t, v = t[srt], v[srt]
            # samples are timestamped in trace time; replay indexes by
            # elapsed work-time, so rebase onto the job's recorded start
            elapsed = t - (js.rec_start[r] if np.isfinite(js.rec_start[r])
                           else t[0])
            profile[r] = _resample_locf(elapsed, v, grid)
            mean_w[r] = v.mean()
        js.power_profile = profile
        js.power_prof = mean_w[:, None].astype(np.float32)

    if cache is not None:
        jobset_to_npz(js, cache, digest=digest)
        return jobset_from_npz(cache)   # serve the cached bytes everywhere
    return js
