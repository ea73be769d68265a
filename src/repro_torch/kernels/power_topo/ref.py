"""Plain PyTorch versions of the power-topology kernels (a transcription of
``repro.kernels.power_topo.ref``).

Node n belongs to CDU group ``min(n // span, G - 1)`` with
``span = ceil(N / G)`` (contiguous spans, mirroring how cabinets map to
CDUs). Inputs carry a leading scenario axis. These are the CPU path of
``ops`` and the functions the CUDA kernel is held against on the card.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch


class CduParams(NamedTuple):
    """Static scalars of the CDU loop update (units: SI, °C)."""
    cp_j_kg_k: float      # water specific heat (J/(kg·K))
    ua_w_k: float         # facility HX conductance per group (W/K)
    #   (ua_w_k, tau_hx_s and tau_valve_s may be 0-dim float32 tensors in
    #    the plain version: calibration candidates; the kernels take floats)
    dt: float             # engine step (s)
    tau_hx_s: float       # supply-loop relaxation time constant (s)
    tau_valve_s: float    # valve/flow slew time constant (s)
    delta_t_design_c: float  # design water ΔT across a CDU (°C)
    mdot_min_kg_s: float  # valve floor (kg/s)
    mdot_max_kg_s: float  # full-open flow (kg/s)


def group_ids(n_nodes: int, n_groups: int) -> np.ndarray:
    """i32[N] CDU group of each node, as host numpy (the assignment is
    static)."""
    span = -(-n_nodes // n_groups)  # ceil: groups are equal spans, last ragged
    idx = np.arange(n_nodes, dtype=np.int32)
    return np.minimum(idx // span, n_groups - 1)


@functools.lru_cache(maxsize=32)
def _group_one_hot(n_nodes: int, n_groups: int, dtype: torch.dtype,
                   device: torch.device) -> torch.Tensor:
    gid = torch.from_numpy(group_ids(n_nodes, n_groups).astype(np.int64))
    return (gid[:, None] == torch.arange(n_groups)[None, :]).to(
        device=device, dtype=dtype)


def group_power_ref(node_pw: torch.Tensor, n_groups: int) -> torch.Tensor:
    """f32[..., N] -> f32[..., G] segment sum over contiguous node spans,
    as the reference's one-hot product."""
    return node_pw @ _group_one_hot(node_pw.shape[-1], n_groups,
                                    node_pw.dtype, node_pw.device)


def group_power_split_ref(node_pw: torch.Tensor, idle_w: float,
                          n_groups: int) -> tuple[torch.Tensor, torch.Tensor]:
    """f32[..., N] -> (floor_g, dyn_g), each f32[..., G]: the group sums of
    each node's idle floor ``min(p, idle)`` and of its dynamic share
    ``p - floor``, as the reference's ``powercap.enforce_cap`` forms them
    (two ``group_power_ref`` calls)."""
    floor = torch.clamp(node_pw, max=idle_w)
    return (group_power_ref(floor, n_groups),
            group_power_ref(node_pw - floor, n_groups))


@functools.lru_cache(maxsize=32)
def _hall_matrix(hall_of_group: tuple, n_halls: int, dtype: torch.dtype,
                 device: torch.device) -> torch.Tensor:
    hog = torch.tensor(hall_of_group, dtype=torch.int64)
    return (hog[:, None] == torch.arange(n_halls)[None, :]).to(
        device=device, dtype=dtype)


def hall_matrix(hall_of_group, n_halls: int, dtype=torch.float32,
                device="cpu") -> torch.Tensor:
    """One-hot group->hall matrix [G, H]: ``x @ hall_matrix(...)`` is the
    per-hall segment sum of a per-group quantity. Cached per device, so a
    step never copies it from the host again."""
    return _hall_matrix(tuple(int(h) for h in hall_of_group), n_halls, dtype,
                        torch.device(device))


def hall_power_ref(group_q: torch.Tensor, hall_of_group,
                   n_halls: int) -> torch.Tensor:
    """f32[..., G] -> f32[..., H] segment sum of per-group heat per hall.

    Accumulated in float64 and rounded once: a hall sums a few tens of
    float32 values, which float64 holds exactly, so the result does not
    depend on the order the BLAS kernel picks (which on the card changes
    with the batch size). A sweep row then equals a solo run.
    """
    hm = hall_matrix(hall_of_group, n_halls, torch.float64, group_q.device)
    return (group_q.to(torch.float64) @ hm).to(group_q.dtype)


def hall_max_ref(group_x: torch.Tensor, hall_of_group,
                 n_halls: int) -> torch.Tensor:
    """f32[..., G] -> f32[..., H] per-hall max of a per-group quantity."""
    mask = hall_matrix(hall_of_group, n_halls, torch.bool, group_x.device)
    masked = torch.where(mask, group_x[..., :, None], -torch.inf)
    return masked.amax(-2)


def _per_group(x, q: torch.Tensor) -> torch.Tensor:
    """Align a basin/setpoint operand with the per-group heat ``q``:
    already per-group -> as is; one rank lower (one value per scenario)
    -> broadcast over the trailing G axis."""
    x = torch.as_tensor(x, dtype=q.dtype, device=q.device)
    return x if x.ndim == q.ndim else x[..., None]


def slew_factors(p: CduParams) -> tuple:
    """(a_valve, a_hx): the per-step slew factors, clipped at 1 so a coarse
    engine dt snaps to the target instead of overshooting it.

    The engine's time constants are Python floats: each factor is then a
    Python float formed in float64, as the kernels take it. A time constant
    that is a 0-dim float32 tensor (a calibration candidate,
    ``repro_torch.traces.calibrate``) gives a float32 tensor, formed as the
    reference's traced ``jnp.minimum(dt / tau, 1.0)`` forms it."""
    def slew(tau):
        if isinstance(tau, torch.Tensor):
            return torch.clamp(p.dt / tau, max=1.0)
        return min(p.dt / tau, 1.0)
    return slew(p.tau_valve_s), slew(p.tau_hx_s)


def cdu_update_ref(q: torch.Tensor, t_supply: torch.Tensor,
                   mdot: torch.Tensor, t_basin, t_set, p: CduParams):
    """Per-CDU loop update for one engine step (elementwise in G).

    Args:
      q: f32[..., G] heat load per CDU group (W).
      t_supply: f32[..., G] current supply water temperature (°C).
      mdot: f32[..., G] current water mass flow (kg/s).
      t_basin: basin temperature feeding each CDU (°C), f32[...] or
        f32[..., G].
      t_set: effective supply setpoint (°C), f32[...] or f32[..., G].
      p: static scalars (CduParams).
    Returns:
      (q, t_return, t_supply_new, mdot_new), each f32[..., G].
    """
    a_valve, a_hx = slew_factors(p)
    dem = torch.clamp(q / (p.cp_j_kg_k * p.delta_t_design_c),
                      p.mdot_min_kg_s, p.mdot_max_kg_s)
    mdot_new = mdot + (dem - mdot) * a_valve
    # heat pickup across the cold plates at the new flow
    t_return = t_supply + q / (mdot_new * p.cp_j_kg_k)
    # supply relaxes toward what the facility HX can deliver: never below
    # basin temperature + HX penalty, never below the setpoint
    tgt = torch.maximum(_per_group(t_set, q), _per_group(t_basin, q)
                        + q / p.ua_w_k)
    t_supply_new = t_supply + (tgt - t_supply) * a_hx
    return q, t_return, t_supply_new, mdot_new


def fused_cooling_ref(node_pw: torch.Tensor, t_supply: torch.Tensor,
                      mdot: torch.Tensor, t_basin, t_set, n_groups: int,
                      p: CduParams):
    """Segment-reduce heat per CDU group + CDU loop update.

    f32[S, N] node power -> (q, t_return, t_supply_new, mdot_new), each
    f32[S, G]. The plain version of the CUDA kernel.
    """
    q = group_power_ref(node_pw, n_groups)
    return cdu_update_ref(q, t_supply, mdot, t_basin, t_set, p)


def fused_cooling_hier_ref(node_pw: torch.Tensor, t_supply: torch.Tensor,
                           mdot: torch.Tensor, t_basin_hall: torch.Tensor,
                           t_set, hall_of_group, n_groups: int,
                           p: CduParams):
    """Hierarchical fused update: node -> CDU -> hall segment reduction +
    per-CDU loop update against each group's *hall* basin.

    Returns (q, t_return, t_supply_new, mdot_new, q_hall): f32[S, G]
    pieces plus per-hall heat sums f32[S, H].
    """
    hog = torch.tensor(list(hall_of_group), dtype=torch.int64,
                       device=node_pw.device)
    n_halls = t_basin_hall.shape[-1]
    t_basin_g = t_basin_hall[..., hog]           # gather: group -> its hall
    q, t_ret, t_sup, md = fused_cooling_ref(node_pw, t_supply, mdot,
                                            t_basin_g, t_set, n_groups, p)
    return q, t_ret, t_sup, md, hall_power_ref(q, hall_of_group, n_halls)
