"""Streaming metrics sink: StepRecord telemetry to NDJSON frames (port
of ``repro.obs.sink``).

Converts the engine's per-step ``StepRecord`` history into
``obs.schema.metrics_frame`` NDJSON frames (power, PUE, utilization,
queue depth, per-hall basin temperatures) and writes them to a file or a
listening socket in the wire's framing (``core.transport.write_frame``,
the same ``MAX_FRAME_BYTES`` cap and versioned envelopes): a consumer
reads lines of JSON and needs neither package.

Target syntax (``--metrics`` on the CLI):

* ``out.ndjson`` (any plain path): a truncating file write;
* ``tcp:host:port``: dial a TCP listener and stream frames to it;
* ``unix:/path/sock``: the same over a Unix-domain socket.

``transport.parse_address`` is not reused to classify a target: it
treats any string containing "/" as AF_UNIX, which would take relative
file paths. Here a ``tcp:``/``unix:`` prefix means a socket and anything
else a file.
"""
from __future__ import annotations

import pathlib
import socket
from types import SimpleNamespace
from typing import IO, Iterator, Optional

import numpy as np

from repro_torch.obs import schema

# StepRecord scalar fields streamed per interval (field name -> frame key)
SCALAR_FIELDS = (
    "power_it", "power_loss", "power_cooling", "power_total", "pue",
    "util", "n_queued", "n_running", "throttle_frac", "cap_w",
    "t_tower_return", "t_basin", "t_supply_max", "t_wetbulb",
    "emissions_kg", "energy_cost", "nodes_down", "n_killed",
)
# per-hall vector fields (f32[H] per step)
HALL_FIELDS = ("power_it_hall", "t_basin_hall", "t_supply_max_hall",
               "cells_online")


class MetricsSink:
    """Writes schema-versioned NDJSON frames to a file or socket.

    One sink per run; ``emit`` takes an already-built frame dict so the
    recorder/CLI can interleave metrics and summary frames on the same
    wire. Frames are validated on the way out — a producer bug fails
    loudly at the twin, not as a consumer parse error.
    """

    def __init__(self, target: str, connect_timeout_s: float = 10.0):
        self.target = str(target)
        self.n_frames = 0
        self._sock: Optional[socket.socket] = None
        if self.target.startswith(("tcp:", "unix:")):
            if self.target.startswith("unix:"):
                family, sockaddr = socket.AF_UNIX, self.target[len("unix:"):]
            else:
                rest = self.target[len("tcp:"):]
                host, _, port = rest.rpartition(":")
                if not host or not port.isdigit():
                    raise ValueError(f"metrics target must be tcp:host:port,"
                                     f" got {self.target!r}")
                family, sockaddr = socket.AF_INET, (host, int(port))
            self._sock = socket.socket(family, socket.SOCK_STREAM)
            self._sock.settimeout(connect_timeout_s)
            self._sock.connect(sockaddr)
            self._file: IO[bytes] = self._sock.makefile("wb")
        else:
            p = pathlib.Path(self.target)
            if p.parent != pathlib.Path(""):
                p.parent.mkdir(parents=True, exist_ok=True)
            self._file = open(p, "wb")

    def emit(self, frame: dict) -> None:
        from repro_torch.core.transport import write_frame
        write_frame(self._file, schema.validate_frame(frame))
        self.n_frames += 1

    def close(self) -> None:
        if self._file is not None:
            try:
                self._file.close()
            finally:
                self._file = None  # type: ignore[assignment]
        if self._sock is not None:
            self._sock.close()
            self._sock = None

    def __enter__(self) -> "MetricsSink":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def history_frames(run_id: str, hist, label: Optional[str] = None,
                   seq0: int = 0) -> Iterator[dict]:
    """Yield one metrics frame per simulated step of ``hist``.

    ``hist`` is an unbatched ``StepRecord`` on the host (numpy arrays or
    CPU tensors, as a session's history is) with a leading time axis;
    each frame carries the scalar telemetry plus the per-hall vectors for
    that step. Non-finite values (e.g. the uncapped ``cap_w = +inf``)
    arrive as ``null``.
    """
    t = np.asarray(hist.t, np.float64)
    scalars = {k: np.asarray(getattr(hist, k), np.float64)
               for k in SCALAR_FIELDS}
    halls = {k: np.asarray(getattr(hist, k), np.float64)
             for k in HALL_FIELDS}
    for i in range(t.shape[0]):
        data = {k: float(v[i]) for k, v in scalars.items()}
        data.update({k: v[i].tolist() for k, v in halls.items()})
        yield schema.metrics_frame(run_id, seq0 + i, float(t[i]), data,
                                   label=label)


def stream_history(sink: MetricsSink, run_id: str, system, table, final,
                   hist, label: Optional[str] = None,
                   summary: Optional[dict] = None) -> int:
    """Stream a whole run: per-step frames and one summary frame.

    ``hist`` is one scenario's ``StepRecord`` of tensors, on any device:
    its streamed fields move to the host once, before the first frame.
    ``summary`` defaults to ``stats.summarize`` over the run (the
    reductions the CLI prints), so a dashboard tailing the stream gets
    the final scorecard on the same wire. Returns the frame count.
    """
    host = {k: _host(getattr(hist, k))
            for k in ("t",) + SCALAR_FIELDS + HALL_FIELDS}
    n = 0
    for frame in history_frames(run_id, SimpleNamespace(**host), label=label):
        sink.emit(frame)
        n += 1
    if summary is None:
        from repro_torch.core import stats as stats_mod
        summary = stats_mod.summarize(system, table, final, hist)
    sink.emit(schema.summary_frame(run_id, summary, label=label))
    return n + 1


def read_frames(path) -> list[dict]:
    """Load and validate every NDJSON frame from a file (test/consumer
    convenience; the stream itself needs no repro_torch code to parse)."""
    from repro_torch.core.transport import read_frame
    frames = []
    with open(path, "rb") as f:
        while True:
            try:
                frames.append(schema.validate_frame(read_frame(f)))
            except ConnectionError:   # clean EOF
                break
    return frames


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if hasattr(x, "detach") \
        else np.asarray(x)
