"""Wrappers for the power-topology kernels: what the engine calls.

A CUDA tensor goes through the Hopper kernel (``power_topo``); a CPU
tensor goes through the plain version (``ref``). The choice follows the
tensor's device and nothing else: there is no fallback from one to the
other.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels.power_topo import power_topo
from repro_torch.kernels.power_topo.ref import (CduParams, fused_cooling_ref,
                                                fused_cooling_hier_ref,
                                                group_power_ref,
                                                group_power_split_ref,
                                                hall_power_ref)


def group_power(node_pw: torch.Tensor, n_groups: int) -> torch.Tensor:
    """Segment sum of per-node power over contiguous CDU-group spans:
    f32[S, N] -> f32[S, G] (W)."""
    if node_pw.is_cpu:
        return group_power_ref(node_pw, n_groups)
    return power_topo.group_power_cuda(node_pw, n_groups)


def group_power_split(node_pw: torch.Tensor, idle_w: float,
                      n_groups: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-group idle floor and dynamic power in one pass over the nodes:
    f32[S, N] -> (floor_g, dyn_g), each f32[S, G] (W), the sums of
    ``min(p, idle_w)`` and of ``p - min(p, idle_w)``. On the card one
    launch reads ``node_pw`` once for both sums."""
    if node_pw.is_cpu:
        return group_power_split_ref(node_pw, idle_w, n_groups)
    return power_topo.group_power_cuda(node_pw, n_groups, idle_w=idle_w)


def fused_cooling(node_pw: torch.Tensor, t_supply: torch.Tensor,
                  mdot: torch.Tensor, t_basin: torch.Tensor,
                  t_set: torch.Tensor, n_groups: int, params: CduParams):
    """Fused per-step cooling update: per-CDU heat + loop state in one pass.

    Args:
      node_pw: f32[S, N] per-node power (W).
      t_supply, mdot: f32[S, G] CDU supply temps (°C), flows (kg/s).
      t_basin, t_set: basin temp and effective setpoint (°C), f32[S] (one
        value per scenario, shared by its groups) or f32[S, G].
      n_groups: number of CDU groups G.
      params: static CduParams scalars.
    Returns:
      (q, t_return, t_supply_new, mdot_new), each f32[S, G].
    """
    if node_pw.is_cpu:
        return fused_cooling_ref(node_pw, t_supply, mdot, t_basin, t_set,
                                 n_groups, params)
    return power_topo.fused_cooling_cuda(node_pw, t_supply, mdot, t_basin,
                                         t_set, n_groups, params)


def hall_power(group_q: torch.Tensor, hall_of_group,
               n_halls: int) -> torch.Tensor:
    """f32[S, G] -> f32[S, H]: the hall level of the node -> CDU -> hall
    reduction. G and H are both tiny (tens), so it stays a one-hot
    product, as the JAX package leaves it to XLA."""
    return hall_power_ref(group_q, hall_of_group, n_halls)


@functools.lru_cache(maxsize=32)
def _halls(hall_of_group: tuple, n_halls: int, device: torch.device):
    """(the halls as a tuple of ints, the same as i32[G] on ``device``),
    checked below H."""
    hog = tuple(int(h) for h in hall_of_group)
    if not all(0 <= h < n_halls for h in hog):
        raise ValueError(f"fused_cooling_hier: hall_of_group {hog} names a "
                         f"hall outside [0, {n_halls})")
    return hog, torch.tensor(hog, dtype=torch.int32, device=device)


def fused_cooling_hier(node_pw: torch.Tensor, t_supply: torch.Tensor,
                       mdot: torch.Tensor, t_basin_hall: torch.Tensor,
                       t_set: torch.Tensor, hall_of_group, n_groups: int,
                       params: CduParams):
    """Hierarchical fused cooling update: node -> CDU -> hall reduction +
    per-CDU loop update against each group's hall basin.

    Args:
      node_pw: f32[S, N] per-node power (W).
      t_supply, mdot: f32[S, G] CDU loop state.
      t_basin_hall: f32[S, H] per-hall basin temperatures (°C).
      t_set: f32[S] effective supply setpoint (°C).
      hall_of_group: static hall index per CDU group (length G).
    Returns:
      (q, t_return, t_supply_new, mdot_new, q_hall): per-group pieces
      f32[S, G] plus per-hall heat sums f32[S, H].
    """
    n_halls = t_basin_hall.shape[-1]
    hog, hall = _halls(tuple(hall_of_group), n_halls, node_pw.device)
    if node_pw.is_cpu:
        return fused_cooling_hier_ref(node_pw, t_supply, mdot, t_basin_hall,
                                      t_set, hog, n_groups, params)
    # the kernel reads each group's hall basin itself: no gather launch
    q, t_ret, t_sup, md = power_topo.fused_cooling_cuda(
        node_pw, t_supply, mdot, t_basin_hall, t_set, n_groups, params,
        hall=hall)
    return q, t_ret, t_sup, md, hall_power(q, hog, n_halls)
