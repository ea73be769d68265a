"""Synthetic workload generation calibrated to the paper's Table 1 systems.

The port's own copy of ``repro.datasets.synthetic`` (plain numpy): the
same spec and seed give the same ``JobSet`` in both packages.

The Zenodo/LFS datasets the paper uses are unreachable offline, so each
dataloader (frontier.py, marconi100.py, ...) draws from this generator with
system-specific calibration (arrival intensity, size mix, power levels,
trace vs scalar telemetry). The generator also *records* a ground-truth
schedule by running the event-driven reference scheduler below — giving every
job a ``rec_start`` exactly like production telemetry, so replay/reschedule
semantics (paper §3.2.2, Fig. 3) are exercised faithfully.

``EventScheduler`` is intentionally a standalone, *event-based* simulator in
plain numpy: it doubles as the paper's "external scheduler" (a FastSim-like
fast Slurm emulation) in §4.2 integrations.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass

import numpy as np

from repro_torch.datasets.base import JobSet
from repro_torch.systems.config import SystemConfig


# ---------------------------------------------------------------------------
# Event-driven reference scheduler (capacity-based, grid-aligned).
# ---------------------------------------------------------------------------
def event_schedule(submit: np.ndarray, limit: np.ndarray, wall: np.ndarray,
                   nodes: np.ndarray, n_nodes: int, dt: float,
                   policy: str = "fcfs", backfill: str = "firstfit",
                   priority: np.ndarray | None = None) -> np.ndarray:
    """Event-driven schedule: returns start times (grid-aligned).

    Capacity-based admission with the same deterministic semantics as the
    compiled engine (completions release nodes before placements at the same
    instant). Policies: fcfs / sjf / ljf / priority; backfill: none/firstfit.
    """
    J = len(submit)
    submit_g = np.ceil(submit / dt) * dt
    start = np.full(J, np.inf)
    free = n_nodes
    queue: list[int] = []
    # event heap: (time, kind, jid); kind 0=release first, 1=submit
    ev = [(float(submit_g[j]), 1, j) for j in range(J)]
    heapq.heapify(ev)

    if policy == "fcfs":
        key = submit_g
    elif policy == "sjf":
        key = limit
    elif policy == "ljf":
        key = -nodes.astype(np.float64)
    elif policy == "priority":
        assert priority is not None
        key = -priority.astype(np.float64)
    else:
        raise ValueError(policy)

    while ev:
        t, kind, j = heapq.heappop(ev)
        if kind == 0:
            free += int(nodes[j])
        else:
            queue.append(j)
        # drain simultaneous events before scheduling
        if ev and ev[0][0] == t:
            continue
        # admission pass
        queue.sort(key=lambda q: (key[q], submit_g[q], q))
        placed = []
        for q in queue:
            need = int(nodes[q])
            if need <= free:
                free -= need
                start[q] = t
                heapq.heappush(ev, (t + float(wall[q]), 0, q))
                placed.append(q)
            elif backfill == "none":
                break
        for q in placed:
            queue.remove(q)
    return start


# ---------------------------------------------------------------------------
# Workload synthesis.
# ---------------------------------------------------------------------------
@dataclass
class WorkloadSpec:
    """Knobs of the calibrated generator (one spec per paper Table 1
    system — see docs/architecture.md, "Datasets and synthetic
    calibration"). Times in seconds; ``load`` is offered node-seconds
    over capacity node-seconds (dimensionless)."""
    n_jobs: int = 512
    duration_s: float = 24 * 3600.0
    load: float = 0.85              # target offered load (node-seconds ratio)
    n_accounts: int = 16
    mean_wall_s: float = 3600.0
    max_frac_nodes: float = 0.25    # cap on single-job size
    full_system_jobs: int = 0       # paper Fig. 6: occasional 100% runs
    trace_len: int = 64             # P; 1 for scalar-summary datasets
    diurnal: float = 0.3            # arrival-rate modulation amplitude
    seed: int = 0


def generate(system: SystemConfig, spec: WorkloadSpec) -> JobSet:
    """Draw a ``JobSet`` from the calibrated generator: diurnal Poisson
    arrivals (s), log2-mix node counts, lognormal walltimes scaled to hit
    ``spec.load``, correlated per-node power traces (W) at
    ``system.prof_dt``, and a recorded ground-truth schedule
    (``rec_start``) from the event-driven reference scheduler (paper
    §3.2.2 replay semantics)."""
    rng = np.random.default_rng(spec.seed)
    J = spec.n_jobs
    dt = system.dt

    # --- arrivals: Poisson with diurnal modulation -------------------------
    base = rng.exponential(spec.duration_s / J, J)
    submit = np.cumsum(base)
    submit *= spec.duration_s / submit[-1]
    day_phase = 2 * np.pi * submit / 86400.0
    submit = submit + spec.diurnal * spec.mean_wall_s * np.sin(day_phase)
    submit = np.clip(np.sort(submit), 0.0, spec.duration_s)

    # --- sizes: log2-ish mix, a few large, optional full-system runs -------
    max_nodes = max(int(system.n_nodes * spec.max_frac_nodes), 1)
    raw = 2 ** rng.uniform(0, np.log2(max(max_nodes, 2)), J)
    nodes = np.maximum(raw.astype(np.int64), 1)
    if spec.full_system_jobs:
        idx = rng.choice(J // 2, spec.full_system_jobs, replace=False) + J // 4
        nodes[idx] = system.n_nodes

    # --- walltimes: lognormal, grid-aligned; limits overestimate -----------
    wall = rng.lognormal(np.log(spec.mean_wall_s), 0.8, J)
    wall = np.maximum(np.round(wall / dt), 1.0) * dt
    limit = wall * rng.uniform(1.1, 3.0, J)
    limit = np.ceil(limit / dt) * dt

    # rescale sizes to hit the target offered load
    offered = float((nodes * wall).sum())
    capacity = system.n_nodes * spec.duration_s
    scale = spec.load * capacity / offered
    if scale < 1.0:
        nodes = np.maximum((nodes * scale).astype(np.int64), 1)

    # --- accounts: zipf-ish popularity; per-account power temperament ------
    acct_prob = 1.0 / np.arange(1, spec.n_accounts + 1)
    acct_prob /= acct_prob.sum()
    account = rng.choice(spec.n_accounts, J, p=acct_prob)
    # temperament in [0,1]: 0 = frugal codes, 1 = power-hungry codes
    temperament = rng.beta(2, 2, spec.n_accounts)[account]

    # --- priority: bigger jobs boosted (Frontier-style), small noise -------
    priority = np.log2(nodes + 1) + rng.uniform(0, 1, J)

    # --- per-node power / utilization profiles -----------------------------
    P = spec.trace_len
    idle, peak = system.power.idle_node_w, system.power.peak_node_w
    base_util = np.clip(0.35 + 0.55 * temperament +
                        rng.normal(0, 0.1, J), 0.05, 1.0)
    if P == 1:
        util_prof = base_util[:, None].astype(np.float32)
    else:
        walk = rng.normal(0, 0.05, (J, P)).cumsum(1)
        util_prof = np.clip(base_util[:, None] + walk, 0.02, 1.0)
        util_prof = util_prof.astype(np.float32)
    power_prof = (idle + (peak - idle) * util_prof).astype(np.float32)

    # --- ground-truth recorded schedule (event-driven reference) -----------
    rec_start = event_schedule(submit, limit, wall, nodes, system.n_nodes,
                               dt, policy="fcfs", backfill="firstfit",
                               priority=priority)
    # jobs that never started in the recorded horizon: treat as started at
    # the end (they will be dismissed by windows that end earlier)
    never = ~np.isfinite(rec_start)
    rec_start[never] = spec.duration_s * 2

    js = JobSet(submit=submit, limit=limit, wall=wall, nodes=nodes,
                priority=priority, account=account, rec_start=rec_start,
                power_prof=power_prof, util_prof=util_prof,
                name=system.name)
    return js
