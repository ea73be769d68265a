"""Telemetry fields and per-interval metrics frames (the part of
``repro.obs.sink`` that needs no wire).

``SCALAR_FIELDS`` and ``HALL_FIELDS`` name the ``StepRecord`` rows a
metrics stream carries, and ``history_frames`` turns a history into one
``obs.schema.metrics_frame`` per step. The sink that writes frames to a
file or socket (``MetricsSink``, ``stream_history``, ``read_frames``)
rides the scheduler wire's framing and comes with the port of that wire.
"""
from __future__ import annotations

from typing import Iterator, Optional

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
