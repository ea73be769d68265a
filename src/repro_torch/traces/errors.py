"""Typed failure for trace ingestion (repro_torch.traces, a copy of ``repro.traces.errors``).

One exception class for the whole package so callers (CLI, tests,
hypothesis batteries) can assert "malformed input fails loudly" without
caring which loader tripped: a NaN submit time, a negative duration, a
non-monotone weather timestamp and a truncated parquet all surface as
``TraceError`` — never as a silently dropped row.
"""
from __future__ import annotations


class TraceError(ValueError):
    """A trace file or row violates the ingestion contract."""
