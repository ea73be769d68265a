"""Parquet/CSV job-table ingestion (PM100 / Marconi100-style): the port's
copy of ``repro.traces.jobtable``. ``pandas`` is imported inside the
functions that read or write a table, so importing this module needs
only numpy.

A *job table* is one row per job with submit/start/end (or runtime),
node count, walltime limit and user columns — what the PM100 dataset
publishes for Marconi100 and what RAPS ingests with ``--system
marconi100 -f job_table.parquet``. Column names vary per site, so the
mapping is a ``TraceSchema`` dict the caller can override; the shipped
``PM100_SCHEMA`` covers the PM100 column names.

Rounding contract: all time columns are rounded to *whole seconds with
banker's rounding* on ingest — the same rule ``datasets/swf.py`` applies
on export (``:.0f``) and ``core.transport.job_digest`` applies when
canonicalizing, so a parquet → ``JobSet`` → SWF → ``JobSet`` roundtrip
keeps the job digest invariant (tests/test_traces.py).

Validation is strict: a row with a NaN time, a negative duration, a
non-positive node count or an end before its start raises ``TraceError``
naming the row — rows are never silently dropped (the hypothesis battery
in tests/test_traces_properties.py leans on this).
"""
from __future__ import annotations

import pathlib
from dataclasses import dataclass, field

import numpy as np

from repro_torch.datasets.base import JobSet
from repro_torch.traces.errors import TraceError


@dataclass(frozen=True)
class TraceSchema:
    """Column mapping from a site's job table to the ``JobSet`` fields.

    Every value is the *source* column name; optional channels map to
    ``None`` when the site does not publish them. Exactly one of
    ``end_time`` / ``run_time`` must resolve (end wins when both exist in
    the file). Times may be numeric seconds or anything
    ``pandas.to_datetime`` parses; they are re-based to the trace origin
    (min submit) unless ``origin_s`` pins one.
    """
    job_id: str = "job_id"
    submit_time: str = "submit_time"
    start_time: str = "start_time"
    end_time: str | None = "end_time"
    run_time: str | None = "run_time"
    nodes: str = "num_nodes"
    time_limit: str = "time_limit"          # minutes unless limit_unit="s"
    user: str = "user_id"
    priority: str | None = "priority"
    mean_node_power: str | None = None      # optional scalar power column (W)
    limit_unit: str = "min"                 # "min" (Slurm) or "s"
    extra: dict = field(default_factory=dict)


# PM100 (Marconi100 job table, Antici et al.) column names.
PM100_SCHEMA = TraceSchema()

_MAX_ACCOUNTS = 64   # SWF export writes account+1 and re-imports mod 64


def _col(df, name: str, what: str) -> np.ndarray:
    if name not in df.columns:
        raise TraceError(f"job table is missing the {what} column "
                         f"{name!r} (have: {list(df.columns)})")
    return df[name].to_numpy()


def _seconds(raw: np.ndarray, what: str) -> np.ndarray:
    """Column -> float64 epoch/relative seconds (datetimes parsed)."""
    if np.issubdtype(raw.dtype, np.number):
        return raw.astype(np.float64)
    import pandas as pd
    try:
        ts = pd.to_datetime(raw, utc=True)
    except (ValueError, TypeError) as e:
        raise TraceError(f"{what} column is neither numeric seconds nor "
                         f"parseable timestamps: {e}") from e
    out = np.asarray(ts.astype("int64"), np.float64) / 1e9
    # NaT becomes INT64_MIN: map back to NaN so validation names the row
    out[np.asarray(pd.isna(ts))] = np.nan
    return out


def _whole_seconds(x: np.ndarray) -> np.ndarray:
    """Banker's whole-second rounding — the SWF / job_digest rule."""
    return np.round(np.asarray(x, np.float64))


def read_job_table(path: str | pathlib.Path,
                   schema: TraceSchema = PM100_SCHEMA,
                   node_power_w: float = 500.0,
                   util: float = 0.7,
                   origin_s: float | None = None) -> JobSet:
    """Ingest a parquet/CSV job table into a ``JobSet``.

    Args:
      path: ``.parquet`` or ``.csv`` file.
      schema: source-column mapping (default: PM100 names).
      node_power_w / util: scalar power/utilization profile for jobs with
        no power channel (job tables carry scheduling columns; measured
        power arrives via ``repro_torch.traces.telemetry``), or the fallback
        when ``schema.mean_node_power`` is unset.
      origin_s: pin the time origin (absolute seconds). Default: the
        earliest submit, so trace times start near zero.
    Returns:
      ``JobSet`` with whole-second times, ready for ``to_table``.
    Raises:
      TraceError: unreadable file, missing columns, or any malformed row
        (NaN/negative times, non-positive nodes, end before start).
    """
    import pandas as pd
    p = pathlib.Path(path)
    try:
        if p.suffix == ".parquet":
            df = pd.read_parquet(p)
        elif p.suffix == ".csv":
            df = pd.read_csv(p)
        else:
            raise TraceError(f"unsupported job-table format {p.suffix!r} "
                             f"(want .parquet or .csv)")
    except TraceError:
        raise
    except Exception as e:  # pandas/pyarrow parse failures
        raise TraceError(f"cannot read job table {p}: {e}") from e
    return jobset_from_frame(df, schema, node_power_w=node_power_w,
                             util=util, origin_s=origin_s, name=p.stem)


def jobset_from_frame(df, schema: TraceSchema = PM100_SCHEMA,
                      node_power_w: float = 500.0, util: float = 0.7,
                      origin_s: float | None = None,
                      name: str = "trace") -> JobSet:
    """Validate + canonicalize an in-memory dataframe (the shared back
    half of ``read_job_table``; ``repro_torch.traces.telemetry`` feeds the
    concatenated ``joblive`` tables through here)."""
    if len(df) == 0:
        raise TraceError(f"job table {name!r} holds no rows")

    submit = _seconds(_col(df, schema.submit_time, "submit"), "submit")
    start = _seconds(_col(df, schema.start_time, "start"), "start")
    wall = None
    if schema.end_time and schema.end_time in df.columns:
        end = _seconds(_col(df, schema.end_time, "end"), "end")
        wall = end - start
    if schema.run_time and schema.run_time in df.columns:
        run = _col(df, schema.run_time, "run_time").astype(np.float64)
        # end wins where both resolve; run_time covers never-started jobs
        # (NaN start/end but a recorded duration — the write_job_table
        # export shape, and SWF's wait = -1 convention)
        wall = run if wall is None else np.where(np.isfinite(wall),
                                                 wall, run)
    if wall is None:
        raise TraceError(f"job table needs {schema.end_time!r} or "
                         f"{schema.run_time!r}; has {list(df.columns)}")
    nodes = _col(df, schema.nodes, "nodes")
    limit = _col(df, schema.time_limit, "time_limit").astype(np.float64)
    if schema.limit_unit == "min":
        limit = limit * 60.0
    user = _col(df, schema.user, "user")

    # --- strict row validation (never a silent drop) -----------------------
    def bad(mask: np.ndarray, why: str) -> None:
        if mask.any():
            rows = np.nonzero(mask)[0][:5].tolist()
            raise TraceError(f"{name}: {int(mask.sum())} row(s) with "
                             f"{why} (first at rows {rows})")

    bad(~np.isfinite(submit), "non-finite submit time")
    bad(~np.isfinite(wall) | (wall <= 0), "missing or non-positive duration")
    nodes_f = np.asarray(nodes, np.float64)
    bad(~np.isfinite(nodes_f) | (nodes_f < 1) |
        (nodes_f != np.round(nodes_f)), "non-integral or < 1 node count")
    # a never-started job (NaN/inf start) is legal — SWF wait = -1 — but a
    # started job must start at or after submission
    started = np.isfinite(start)
    bad(started & (start < submit), "start before submit")
    bad(np.isfinite(limit) & (limit <= 0), "non-positive time limit")

    # --- canonicalize ------------------------------------------------------
    if origin_s is None:
        origin_s = float(np.min(submit))
    submit = _whole_seconds(submit - origin_s)
    wall = np.maximum(_whole_seconds(wall), 1.0)
    rec_start = np.where(started, _whole_seconds(start - origin_s), np.inf)
    limit = np.where(np.isfinite(limit), _whole_seconds(limit), wall * 2)
    limit = np.maximum(limit, wall)
    nodes = nodes_f.astype(np.int64)

    order = np.argsort(submit, kind="stable")

    # users -> dense account ids in first-seen (submit-sorted) order,
    # folded into the SWF range. First-seen numbering is a fixed point
    # under re-export: a written table stores the dense id and
    # re-densifying maps it back to itself, so the digest survives
    # parquet/CSV/SWF roundtrips. (Sorted-unique numbering is not:
    # "10" < "2" lexicographically, which permutes relabeled accounts.)
    uniq, first, inverse = np.unique(np.asarray(user).astype(str)[order],
                                     return_index=True, return_inverse=True)
    rank = np.empty(len(uniq), np.int64)
    rank[np.argsort(first, kind="stable")] = np.arange(len(uniq))
    account = rank[inverse] % _MAX_ACCOUNTS

    if schema.priority and schema.priority in df.columns:
        priority = _col(df, schema.priority, "priority").astype(np.float64)
        bad(~np.isfinite(priority), "non-finite priority")
    else:
        priority = np.log2(nodes + 1.0)

    J = len(df)
    if schema.mean_node_power and schema.mean_node_power in df.columns:
        pw = _col(df, schema.mean_node_power, "power").astype(np.float64)
        bad(~np.isfinite(pw) | (pw < 0), "non-finite or negative power")
        power = pw[:, None].astype(np.float32)
    else:
        power = np.full((J, 1), node_power_w, np.float32)
    return JobSet(submit=submit[order], limit=limit[order],
                  wall=wall[order], nodes=nodes[order],
                  priority=priority[order], account=account,
                  rec_start=rec_start[order], power_prof=power[order],
                  util_prof=np.full((J, 1), util, np.float32),
                  name=name)


def write_job_table(js: JobSet, path: str | pathlib.Path,
                    schema: TraceSchema = PM100_SCHEMA) -> None:
    """Export a ``JobSet`` as a parquet/CSV job table (roundtrip partner
    of ``read_job_table``; used to build golden fixtures and by the
    property battery). Never-started jobs get a NaN start; the limit is
    written back in the schema's unit."""
    import pandas as pd
    p = pathlib.Path(path)
    limit = np.asarray(js.limit, np.float64)
    if schema.limit_unit == "min":
        limit = limit / 60.0
    df = pd.DataFrame({
        schema.job_id: np.arange(len(js)),
        schema.submit_time: np.asarray(js.submit, np.float64),
        schema.start_time: np.where(np.isfinite(js.rec_start),
                                    js.rec_start, np.nan),
        schema.end_time or "end_time": np.where(
            np.isfinite(js.rec_start), js.rec_start + js.wall, np.nan),
        schema.run_time or "run_time": np.asarray(js.wall, np.float64),
        schema.nodes: np.asarray(js.nodes, np.int64),
        schema.time_limit: limit,
        schema.user: np.asarray(js.account, np.int64),
        schema.priority or "priority": np.asarray(js.priority, np.float64),
    })
    if p.suffix == ".parquet":
        df.to_parquet(p, index=False)
    elif p.suffix == ".csv":
        df.to_csv(p, index=False)
    else:
        raise TraceError(f"unsupported job-table format {p.suffix!r}")
