"""Standard Workload Format (SWF) import/export (Chapin et al. [13], as the
paper cites for the dataloader contract): the port's copy of
``repro.datasets.swf``, numpy only, so the card's trace format needs no
pandas. Both packages write the same bytes and read the same ``JobSet``.

SWF fields used (1-indexed per the spec):
  1 job id, 2 submit, 3 wait, 4 runtime, 5 allocated procs, 8 requested
  procs, 9 requested time (limit), 12 user id, 13 group id
Power channels are not part of SWF; on import jobs get a configurable
constant per-node power (SWF workloads still drive scheduling studies).
"""
from __future__ import annotations

import numpy as np

from repro_torch.datasets.base import JobSet


def write_swf(js: JobSet, path: str) -> None:
    """Export a ``JobSet`` as SWF rows (times in whole seconds; the wait
    column is derived from the recorded start). Power/utilization channels
    are dropped — SWF has no slot for them. Jobs that never started
    (non-finite ``rec_start``) get the SWF missing-value wait of ``-1``
    instead of a non-numeric ``inf`` token."""
    with open(path, "w") as f:
        f.write("; SWF export from repro (S-RAPS JAX twin)\n")
        for i in range(len(js)):
            wait = max(js.rec_start[i] - js.submit[i], 0.0) \
                if np.isfinite(js.rec_start[i]) else -1.0
            f.write(f"{i + 1} {js.submit[i]:.0f} {wait:.0f} "
                    f"{js.wall[i]:.0f} {js.nodes[i]} 0 0 {js.nodes[i]} "
                    f"{js.limit[i]:.0f} 0 1 {js.account[i] + 1} "
                    f"{js.account[i] + 1} 0 0 0 0 0\n")


def read_swf(path: str, node_power_w: float = 500.0,
             util: float = 0.7) -> JobSet:
    """Import an SWF trace into a ``JobSet`` (times s, counts i64).

    SWF carries no power telemetry, so every job gets a scalar profile of
    ``node_power_w`` watts per node at ``util`` utilization — enough to
    drive scheduling studies; swap in measured profiles for power work.
    """
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith(";"):
                continue
            parts = line.split()
            if len(parts) < 13:
                continue
            rows.append([float(parts[1]), float(parts[3]), float(parts[2]),
                         float(parts[7]) if float(parts[7]) > 0
                         else float(parts[4]),
                         float(parts[8]), float(parts[11])])
    a = np.asarray(rows)
    submit = a[:, 0]
    wall = np.maximum(a[:, 1], 1.0)
    # SWF marks an unknown/never-happened wait as -1: those jobs never
    # started, which the JobSet contract spells rec_start = inf
    wait = np.where(a[:, 2] >= 0, a[:, 2], np.inf)
    nodes = np.maximum(a[:, 3], 1).astype(np.int64)
    limit = np.where(a[:, 4] > 0, a[:, 4], wall * 2)
    account = (a[:, 5].astype(np.int64) - 1) % 64
    J = len(a)
    power = np.full((J, 1), node_power_w, np.float32)
    up = np.full((J, 1), util, np.float32)
    return JobSet(submit=submit, limit=limit, wall=wall, nodes=nodes,
                  priority=np.log2(nodes + 1.0), account=account,
                  rec_start=submit + wait, power_prof=power, util_prof=up,
                  name="swf")
