"""DVFS power-cap enforcement per engine step (port of
``repro.grid.powercap``), batched over scenarios.

When the projected IT power exceeds the active cap, every running node is
throttled by a common cap factor ``c`` in ``[c_min, 1]``. DVFS only buys
back *dynamic* power: each node keeps its idle floor and scales the draw
above it,

    p_throttled = min(p, idle) + c * max(p - idle, 0)

so the solvable cap range is ``[floor_total, raw_total]`` and

    c = clip((cap - floor_total) / dyn_total, c_min, 1).

The per-group floor and dynamic sums come from one pass over the nodes
(``kernels.power_topo.group_power_split``: the Hopper kernel on the card),
and the throttled per-CDU heat loads that feed the cooling plant fall out
of them.

The totals and the cap factor are computed in float64, in the reference's
order of operations: the group totals are exact there, so a scenario's
cap factor does not depend on the batch it runs in. ``c`` is then rounded
down to float32 and the throttled total rounded once, so a reachable cap
holds to the watt. In float32 throughout, as the reference computes it,
the throttled total can overshoot the cap by one ulp: 2 W at Frontier's
27 MW, over the 1 W that the cap check allows.

The runtime cost of throttling is proportional slowdown: the engine
stretches every affected job's remaining runtime for the throttled step
(``repro_torch.core.engine._tick``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels.power_topo import ops as topo_ops
from repro_torch.systems.config import SystemConfig


class CapResult(NamedTuple):
    c: torch.Tensor           # f32[S]    cap factor in [c_min, 1]
    p_it: torch.Tensor        # f32[S]    throttled total IT power (W)
    group_heat: torch.Tensor  # f32[S, G] throttled per-CDU-group heat (W)
    p_it_raw: torch.Tensor    # f32[S]    unthrottled IT power (W)


def throttle_power(pw: torch.Tensor, idle_w: float,
                   c: torch.Tensor) -> torch.Tensor:
    """Scale the dynamic (above-idle) share of a power array by ``c``.

    Args:
      pw: f32[S, ...] power draws (W).
      idle_w: per-node idle floor (W), not DVFS-addressable.
      c: f32[S] cap factor per scenario, in [c_min, 1].
    Returns:
      f32[S, ...] throttled powers (W): ``min(pw, idle) + c·max(pw−idle, 0)``.
    """
    floor = torch.clamp(pw, max=idle_w)
    c = c.reshape(c.shape + (1,) * (pw.ndim - c.ndim))
    return floor + c * (pw - floor)


def enforce_cap(system: SystemConfig, node_pw: torch.Tensor,
                cap_w: torch.Tensor) -> CapResult:
    """Compute each scenario's cap factor for this step and the throttled
    aggregates.

    Args:
      node_pw: f32[S, N] per-node power draws (W).
      cap_w: f32[S] active facility IT power cap (W); ``inf`` = uncapped
        -> c = 1. A cap below the idle floor saturates at ``c_min``: the
        idle draw is not DVFS-addressable.
    Returns:
      ``CapResult``: cap factor c, throttled total IT power (W), throttled
      per-CDU-group heat (W) and the unthrottled total (W).
    """
    floor_g, dyn_g = topo_ops.group_power_split(
        node_pw, system.power.idle_node_w, system.cooling.n_groups)
    f64 = torch.float64
    floor_tot = floor_g.sum(-1, dtype=f64)      # exact: tens of float32s
    dyn_tot = dyn_g.sum(-1, dtype=f64)

    c_raw = (cap_w.to(f64) - floor_tot) / torch.clamp(dyn_tot, min=1.0)
    c = c_raw.to(torch.float32)
    c = torch.where(c.to(f64) > c_raw,        # round down, never up
                    torch.nextafter(c, torch.full_like(c, -torch.inf)), c)
    c = torch.clamp(c, system.grid.c_min, 1.0)
    c = torch.where(torch.isfinite(cap_w), c, 1.0)

    group_heat = floor_g + c[:, None] * dyn_g
    f32 = lambda x: x.to(torch.float32)
    return CapResult(c=c, p_it=f32(floor_tot + c.to(f64) * dyn_tot),
                     group_heat=group_heat, p_it_raw=f32(floor_tot + dyn_tot))
