"""Phase timing spans and latency histograms (a copy of
``repro.obs.timing``; it imports the standard library only).

A ``SpanTimer`` records named wall-clock spans (``with timer.span(
"engine.scan"): ...``) with arbitrary metadata and aggregates them into a
JSON-able summary for the run manifest (``repro_torch.obs.recorder``).
The engine consults the *active* timer (``current()``): when one is
installed via ``use(timer)``, every entry point of
``repro_torch.core.engine`` times its scan as an ``engine.scan`` span,
synchronising the card inside the span so that it measures the device's
work. The port runs eagerly and compiles nothing, so it has no
``engine.lower`` or ``engine.compile`` span. With no active timer the
hot paths are untouched.

The registry is thread-local: a timer installed on one thread is not seen
by another (a server's executor thread runs unobserved), as in the
reference.

``LatencyHistogram`` is the fixed-bucket (log-spaced) histogram the
external bridge (``repro_torch.core.external.SchedulerBridge``) keeps per
poll.

All durations in seconds.
"""
from __future__ import annotations

import contextlib
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional


@dataclass
class Span:
    """One completed (or in-flight) timed phase."""
    name: str
    t_start: float                 # clock() at entry (s)
    dur_s: float = 0.0             # filled at exit
    meta: dict = field(default_factory=dict)

    def as_dict(self) -> dict:
        d = {"name": self.name, "t_start": self.t_start,
             "dur_s": self.dur_s}
        if self.meta:
            d["meta"] = dict(self.meta)
        return d


class SpanTimer:
    """Collects named wall-clock spans and event counters.

    ``clock`` is injectable for deterministic tests/doctests (any
    zero-arg callable returning seconds). ``listener`` (optional) is
    called with an event dict at every span start/end — the hook the run
    recorder uses to mirror phase boundaries into the NDJSON event log.
    """

    def __init__(self, clock: Callable[[], float] = time.perf_counter,
                 listener: Optional[Callable[[str, dict], None]] = None):
        self.clock = clock
        self.listener = listener
        self.spans: List[Span] = []
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def span(self, name: str, **meta):
        """Time a phase; the span is recorded even if the body raises."""
        sp = Span(name=name, t_start=self.clock(), meta=meta)
        if self.listener is not None:
            self.listener("span_start", {"span": name, **meta})
        try:
            yield sp
        finally:
            sp.dur_s = self.clock() - sp.t_start
            self.spans.append(sp)
            if self.listener is not None:
                self.listener("span_end",
                              {"span": name, "dur_s": sp.dur_s, **meta})

    def count(self, name: str, n: int = 1) -> None:
        """Bump a named event counter (e.g. a cache hit)."""
        self.counts[name] = self.counts.get(name, 0) + n

    def summary(self) -> dict:
        """Aggregate spans by name: {name: {count, total_s, max_s}} plus
        the raw event counters — the shape the manifest embeds."""
        agg: Dict[str, dict] = {}
        for sp in self.spans:
            a = agg.setdefault(sp.name,
                               {"count": 0, "total_s": 0.0, "max_s": 0.0})
            a["count"] += 1
            a["total_s"] += sp.dur_s
            a["max_s"] = max(a["max_s"], sp.dur_s)
        return {"spans": agg, "counters": dict(self.counts)}


# ---------------------------------------------------------------------------
# Active-timer registry (what the engine consults).
# ---------------------------------------------------------------------------
_local = threading.local()


def current() -> Optional[SpanTimer]:
    """The timer installed by the innermost ``use()`` block, or None."""
    return getattr(_local, "timer", None)


@contextlib.contextmanager
def use(timer: SpanTimer):
    """Install ``timer`` as the active span timer for this thread."""
    prev = current()
    _local.timer = timer
    try:
        yield timer
    finally:
        _local.timer = prev


@contextlib.contextmanager
def maybe_span(name: str, **meta):
    """Span on the active timer if one is installed; no-op otherwise."""
    t = current()
    if t is None:
        yield None
    else:
        with t.span(name, **meta) as sp:
            yield sp


# ---------------------------------------------------------------------------
# Latency histogram (bridge poll counters).
# ---------------------------------------------------------------------------
class LatencyHistogram:
    """Fixed log-spaced latency histogram: 100 µs .. 100 s + overflow.

    Monotonic counters only (record / merge); ``summary()`` is JSON-able
    so the external bridge can surface its per-poll latency distribution
    in the run manifest and in ``fig7_external`` rows.
    """

    EDGES = (1e-4, 1e-3, 1e-2, 1e-1, 1.0, 10.0, 100.0)  # upper edges (s)

    def __init__(self):
        self.counts = [0] * (len(self.EDGES) + 1)  # last = overflow
        self.n = 0
        self.total_s = 0.0
        self.min_s = float("inf")
        self.max_s = 0.0

    def record(self, dur_s: float) -> None:
        self.n += 1
        self.total_s += dur_s
        self.min_s = min(self.min_s, dur_s)
        self.max_s = max(self.max_s, dur_s)
        for i, edge in enumerate(self.EDGES):
            if dur_s <= edge:
                self.counts[i] += 1
                return
        self.counts[-1] += 1

    def summary(self) -> dict:
        buckets = {f"le_{e:g}s": c for e, c in zip(self.EDGES, self.counts)}
        buckets["overflow"] = self.counts[-1]
        return {"count": self.n, "total_s": self.total_s,
                "min_s": self.min_s if self.n else 0.0,
                "max_s": self.max_s, "buckets": buckets}
