"""Utilization -> electrical power (paper §3.1), port of ``repro.power.model``.

Per-node IT power comes from the job's recorded per-node power trace
(trace datasets: Frontier, Marconi100) with last-observation-carried-
forward for missing samples, or from a scalar per-job average (summary
datasets: Fugaku, Lassen, Adastra). Idle nodes draw ``idle_node_w``.
Batched over scenarios: per-job tensors are [S, J], per-node [S, N].

Telemetry replay (``repro_torch.traces``): when the table carries a
measured ``power_profile`` channel, jobs with a measurement play it back
verbatim (the recorded sample at the job's work-time index) instead of
the ``power_prof`` model, while profile-less jobs (negative sentinel
rows) keep the model bit for bit. ``power_profile is None`` skips the
gather.
"""
from __future__ import annotations

import torch

from repro_torch.core import types as T
from repro_torch.core.types import JobTable
from repro_torch.systems.config import SystemConfig


def job_node_power_elapsed(table: JobTable, jstate: torch.Tensor,
                           elapsed: torch.Tensor,
                           prof_dt: float) -> torch.Tensor:
    """Per-node power (W) of each job ``elapsed`` work-seconds into its run
    -> f32[S, J].

    LOCF semantics (paper §3.2.2): the profile index is clamped into
    [0, P-1]. The index truncates toward zero like the reference's
    ``astype(int32)``.

    Replay: a measured ``table.power_profile`` sample (the same work-time
    index, clamped into its own width [0, Q-1]) overrides the model
    wherever it is >= 0; the -1 sentinel marks "no measurement".
    """
    S, J = jstate.shape
    step = (elapsed / prof_dt).to(torch.int32)

    def at(prof):                     # f32[J, W] -> f32[S, J] at ``step``
        idx = torch.clamp(step, 0, prof.shape[1] - 1)
        return torch.gather(prof.expand(S, J, prof.shape[1]), 2,
                            idx.long().unsqueeze(-1)).squeeze(-1)

    p = at(table.power_prof)
    if table.power_profile is not None:
        m = at(table.power_profile)
        p = torch.where(m >= 0.0, m, p)
    return torch.where(jstate == T.RUNNING, p, 0.0)


def node_power(system: SystemConfig, table: JobTable, node_job: torch.Tensor,
               job_pw: torch.Tensor) -> torch.Tensor:
    """Map per-job power f32[S, J] onto the node axis -> f32[S, N] (W).

    ``node_job[s, n]`` is the occupying job id (or -1). Free nodes draw
    idle power.
    """
    p = torch.gather(job_pw, 1, node_job.clamp(min=0).long())
    return torch.where(node_job >= 0, p, system.power.idle_node_w)


def sum_exact(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis, accumulated in float64 and rounded once to
    ``x``'s type. For the engine's float32 powers, heats and flows the
    float64 sum is exact (a few tens of integer bits plus float32's
    fraction bits fit in 53), so the result does not depend on the
    reduction order, which on the card changes with the batch size: a
    sweep row then equals a solo run."""
    return x.sum(-1, dtype=torch.float64).to(x.dtype)


def system_it_power(node_pw: torch.Tensor) -> torch.Tensor:
    """Total IT power per scenario (W): f32[S, N] -> f32[S], summed
    exactly (``sum_exact``): the cap-aware admission compares it with the
    cap, so a row's decision must not depend on the batch size."""
    return sum_exact(node_pw)
