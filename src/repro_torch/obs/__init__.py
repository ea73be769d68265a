"""Observability layer (the flight recorder; port of ``repro.obs``).

Opt-in pieces, no cost when unused:

* ``obs.schema``: schema-versioned manifest and NDJSON frame formats;
* ``obs.recorder``: per-run manifest writer and lifecycle event log;
* ``obs.sink``: StepRecord telemetry to an NDJSON metrics stream (file
  or socket, in the wire's framing);
* ``obs.timing``: the span timer the engine consults (one
  ``engine.scan`` span per scan, the card synchronised inside it), and
  the latency histogram;
* ``obs.reporter``: logging-based CLI output (progress to stderr,
  results to stdout, ``--quiet`` / ``--json``).
"""
from repro_torch.obs import schema, timing            # noqa: F401
from repro_torch.obs.recorder import RunRecorder, build_manifest, load_manifest  # noqa: F401
from repro_torch.obs.reporter import Reporter, add_output_flags, get_logger  # noqa: F401
from repro_torch.obs.sink import (HALL_FIELDS, SCALAR_FIELDS, MetricsSink,  # noqa: F401
                                  history_frames, read_frames, stream_history)
from repro_torch.obs.timing import LatencyHistogram, SpanTimer, current, maybe_span, use  # noqa: F401
