"""Transient thermo-fluid cooling twin, hierarchical: halls -> CDU groups ->
nodes (port of ``repro.cooling.model``, batched over scenarios).

Per engine step ``dt`` (units: W, kg/s, °C, s), per scenario:

CDU loop, per group g (``kernels.power_topo``: the Hopper kernel fuses it
with the node->group reduction on the card): the valve slews the flow
toward q/(cp·ΔT_design), the return water picks up q, and the supply
relaxes toward max(setpoint, T_basin[hall(g)] + q/UA).

Heat reuse, per hall: when the hall's flow-weighted return temp is hot
enough, up to ``reuse_frac`` of its heat (capped at its share of
``reuse_max_w``) is exported before the tower.

Tower + basin, per hall: fan staging slews toward the rejection the
tower-bound heat needs (``cells_offline`` shrinks the ceiling), the
evaporative rejection is floored at the wet-bulb, and the basin
integrates heat in minus heat rejected.

Parasitic power: staged cube-law fans per hall, cube-law pumps with a
20% base. PUE = (P_IT + P_loss + P_cool) / P_IT.

Every state tensor carries the leading scenario axis S; per-group
quantities are [S, G], per-hall [S, H]. ``step_from_node_power`` is the
no-grid path (the fused kernel); ``step`` takes per-group heat, the
throttled IT power of the grid path. Both take this step's ambient
wet-bulb from a weather trace (``repro_torch.cooling.weather``; the
config's static value without one) and the event layer's failed tower
cells (``repro_torch.events``), which also lose their passive windage.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch.core.types import CoolingState
from repro_torch.kernels.power_topo import ops as topo_ops
from repro_torch.kernels.power_topo.ref import (CduParams, cdu_update_ref,
                                                hall_max_ref, hall_power_ref)
from repro_torch.power.model import sum_exact
from repro_torch.systems.config import CoolingConfig


class CoolingOut(NamedTuple):
    """Per-step cooling telemetry. Unsuffixed fields are facility
    aggregates f32[S] (max / flow-weighted mix / sum over halls);
    ``*_hall`` fields carry the per-hall view f32[S, H]."""
    p_cooling: torch.Tensor      # total cooling parasitics, fans + pumps (W)
    p_fan: torch.Tensor          # tower fan power (W)
    p_pump: torch.Tensor         # CDU pump power (W)
    t_tower_return: torch.Tensor  # flow-weighted water temp at the towers (°C)
    t_basin: torch.Tensor        # hottest basin temperature after the step (°C)
    t_supply_max: torch.Tensor   # hottest CDU supply temperature (°C)
    t_return_max: torch.Tensor   # hottest CDU return temperature (°C)
    q_reuse_w: torch.Tensor      # heat exported for reuse this step (W)
    q_reject_w: torch.Tensor     # heat rejected by the towers this step (W)
    q_hall_w: torch.Tensor           # heat landing in each hall (W)
    t_basin_hall: torch.Tensor       # basin temperature per hall (°C)
    t_supply_max_hall: torch.Tensor  # hottest CDU supply per hall (°C)
    t_return_max_hall: torch.Tensor  # hottest CDU return per hall (°C)
    q_reject_hall_w: torch.Tensor    # tower rejection per hall (W)
    fan_w_hall: torch.Tensor         # fan power per hall (W)
    cells_online: torch.Tensor       # tower cells available per hall
    t_wetbulb_hall: torch.Tensor     # ambient wet-bulb per hall (°C)


class ThermalNow(NamedTuple):
    """Cooling-pressure signals for the scheduler. Scalars f32[S] / bool[S]
    aggregate over halls (max / any); ``*_hall`` are [S, H]."""
    excess: torch.Tensor       # soft-band excess of the hottest return temp
    overheat: torch.Tensor     # supply setpoint lost in SOME hall
    t_return_max: torch.Tensor  # hottest CDU return temperature (°C)
    t_supply_max: torch.Tensor  # hottest CDU supply temperature (°C)
    excess_hall: torch.Tensor   # per-hall soft-band excess
    overheat_hall: torch.Tensor  # per-hall setpoint-lost flag


def cdu_params(cfg: CoolingConfig, dt: float) -> CduParams:
    """Static kernel scalars for the per-CDU loop update."""
    return CduParams(
        cp_j_kg_k=cfg.cp_j_kg_k, ua_w_k=cfg.ua_w_k, dt=dt,
        tau_hx_s=cfg.tau_hx_s, tau_valve_s=cfg.tau_valve_s,
        delta_t_design_c=cfg.delta_t_design_c,
        mdot_min_kg_s=cfg.mdot_min_frac * cfg.mdot_kg_s,
        mdot_max_kg_s=cfg.mdot_kg_s)


class _Halls(NamedTuple):
    """Static per-hall constants on one device (f32[H] / [G, H])."""
    hog: tuple              # hall of each CDU group (host ints)
    hog_idx: torch.Tensor   # i64[G] the same, on the device
    cells: torch.Tensor     # f32[H] installed tower cells
    mcp: torch.Tensor       # f32[H] basin thermal mass x cp (J/K)
    passive_ua: torch.Tensor  # f32[H] fans-off ambient coupling (W/K)
    reuse_max: torch.Tensor  # f32[H] heat-export capacity share (W)


@functools.lru_cache(maxsize=32)
def halls(cfg: CoolingConfig, device: torch.device) -> _Halls:
    """Resolve the static topology into per-hall constants on ``device``
    (cached: a step never copies them from the host again)."""
    hog = tuple(int(h) for h in cfg.hall_of_group())
    f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=device)
    cells = f32(cfg.cells_per_hall())
    return _Halls(
        hog=hog,
        hog_idx=torch.tensor(hog, dtype=torch.int64, device=device),
        cells=cells,
        mcp=f32(cfg.basin_mcp_per_hall()),
        passive_ua=cfg.passive_ua_frac * cells * cfg.cell_ua(),
        reuse_max=cfg.reuse_max_w * f32(cfg.hall_weights()))


def init_state(cfg: CoolingConfig, device="cpu") -> CoolingState:
    """Idle-plant initial condition (unbatched: [G] / [H]): supply at
    setpoint, valves at the floor, every hall's basin at wet-bulb +
    approach, fans off."""
    g = torch.full((cfg.n_groups,), cfg.t_supply_setpoint_c,
                   dtype=torch.float32, device=device)
    H = cfg.n_halls
    return CoolingState(
        t_supply=g,
        t_return=g + 5.0,
        mdot=torch.full((cfg.n_groups,), cfg.mdot_min_frac * cfg.mdot_kg_s,
                        dtype=torch.float32, device=device),
        t_basin=torch.full((H,), cfg.t_wetbulb_c + cfg.tower_approach_c,
                           dtype=torch.float32, device=device),
        fan_stages=torch.zeros((H,), dtype=torch.float32, device=device))


def _effective(cfg: CoolingConfig, state: CoolingState, t_wetbulb_c,
               setpoint_delta_c):
    """(per-hall ambient wet-bulb f32[S, H], effective supply setpoint
    f32[S]) for this step (°C). The wet-bulb is ``t_wetbulb_c`` (f32[S],
    one per scenario for every hall, or f32[S, H]), the config's static
    value when None; the setpoint is shifted by
    ``Scenario.setpoint_delta_c`` (f32[S] or a number)."""
    if t_wetbulb_c is None:
        t_wb = torch.full_like(state.t_basin, cfg.t_wetbulb_c)
    else:
        t_wb = t_wetbulb_c if t_wetbulb_c.ndim == 2 else t_wetbulb_c[:, None]
        t_wb = t_wb.expand(state.t_basin.shape)
    delta = torch.as_tensor(setpoint_delta_c, dtype=torch.float32,
                            device=state.t_basin.device)
    t_set = cfg.t_supply_setpoint_c + delta.expand(state.t_basin.shape[0])
    return t_wb, t_set


def _cube(x: torch.Tensor) -> torch.Tensor:
    # x*x*x, not pow: the reference's integer power is two multiplies
    return x * x * x


def _finish_step(cfg: CoolingConfig, state: CoolingState, dt: float,
                 t_wb, t_set, q, t_return, t_supply, mdot,
                 cells_offline=0.0, cells_failed=None, q_hall=None
                 ) -> tuple[CoolingState, CoolingOut]:
    """Tower-side half of the step, vectorized over scenarios and halls:
    reuse split, fan staging, basin mass, parasitic power. ``q``/
    ``t_return``/``t_supply``/``mdot`` ([S, G]) come from the CDU update;
    ``t_wb`` is [S, H]; ``t_set`` [S]; ``cells_offline`` a number, f32[S]
    or f32[S, H]; ``cells_failed`` the event layer's failed cells f32[S,
    H] (None without it): they stack on maintenance and, unlike it, also
    derate the passive windage path in proportion; ``q_hall`` [S, H]
    when the caller already reduced it."""
    hs = halls(cfg, q.device)
    H = cfg.n_halls
    if q_hall is None:
        q_hall = hall_power_ref(q, hs.hog, H)

    # water temperature arriving at each hall's towers = the hall's
    # flow-weighted return temp; the facility scalar mixes all groups
    mdot_hall = hall_power_ref(mdot, hs.hog, H)
    t_ret_mix_hall = hall_power_ref(mdot * t_return, hs.hog, H) / \
        torch.clamp(mdot_hall, min=1e-6)
    t_ret_mix = sum_exact(mdot * t_return) / torch.clamp(sum_exact(mdot),
                                                         min=1e-6)

    # heat reuse, per hall, at each hall's static export-capacity share
    q_reuse_h = torch.where(t_ret_mix_hall >= cfg.reuse_t_min_c,
                            torch.minimum(cfg.reuse_frac * q_hall,
                                          hs.reuse_max), 0.0)
    q_tower_h = q_hall - q_reuse_h

    # fan staging, per hall: reject the tower-bound heat (minus what the
    # passive path already carries) at the current driving ΔT, plus a
    # proportional correction that steers the basin to its target.
    # Offline cells cap the staging ceiling.
    cell_ua = cfg.cell_ua()
    off = torch.as_tensor(cells_offline, dtype=torch.float32, device=q.device)
    if off.ndim == 1:
        off = off[:, None]            # one count per scenario, every hall
    passive_ua = hs.passive_ua
    if cells_failed is not None:
        cf = torch.minimum(torch.clamp(cells_failed, min=0.0), hs.cells)
        off = off + cf
        passive_ua = hs.passive_ua * (1.0 - cf / hs.cells)
    cells_on = torch.minimum(torch.clamp(hs.cells - off, min=0.0), hs.cells)
    q_passive = passive_ua * (state.t_basin - t_wb)
    t_b_tgt = torch.maximum(t_wb + cfg.tower_approach_c,
                            (t_set - cfg.basin_margin_c)[:, None])
    drive = torch.clamp(state.t_basin - t_wb, min=0.5)
    q_need = q_tower_h - q_passive + \
        hs.mcp * (state.t_basin - t_b_tgt) / cfg.tower_tau_s
    s_tgt = torch.minimum(torch.clamp(q_need / (cell_ua * drive), min=0.0),
                          cells_on)
    a_fan = min(max(dt / cfg.tau_fan_s, 0.0), 1.0)
    fan = state.fan_stages + (s_tgt - state.fan_stages) * a_fan
    # a cell pulled offline mid-run also drops out of the current staging
    fan = torch.minimum(fan, cells_on)

    # basin thermal mass, per hall: heat in from the HX minus tower
    # rejection (the passive path is bidirectional)
    q_rej = torch.clamp(fan * cell_ua * (state.t_basin - t_wb), min=0.0) + \
        q_passive
    t_basin = state.t_basin + (q_tower_h - q_rej) * dt / hs.mcp

    # parasitics: staged cube-law fans per hall + cube-law pumps
    k = torch.floor(fan)
    r = fan - k
    fan_w_h = cfg.fan_rated_w * (k + _cube(r))
    fan_w = sum_exact(fan_w_h)
    frac = mdot / cfg.mdot_kg_s
    pump_w = sum_exact(cfg.pump_w_per_group * (0.2 + 0.8 * _cube(frac)))

    new = CoolingState(t_supply=t_supply, t_return=t_return, mdot=mdot,
                       t_basin=t_basin, fan_stages=fan)
    out = CoolingOut(
        p_cooling=fan_w + pump_w, p_fan=fan_w, p_pump=pump_w,
        t_tower_return=t_ret_mix, t_basin=t_basin.amax(-1),
        t_supply_max=t_supply.amax(-1), t_return_max=t_return.amax(-1),
        q_reuse_w=sum_exact(q_reuse_h), q_reject_w=sum_exact(q_rej),
        q_hall_w=q_hall, t_basin_hall=t_basin,
        t_supply_max_hall=hall_max_ref(t_supply, hs.hog, cfg.n_halls),
        t_return_max_hall=hall_max_ref(t_return, hs.hog, cfg.n_halls),
        q_reject_hall_w=q_rej, fan_w_hall=fan_w_h, cells_online=cells_on,
        t_wetbulb_hall=t_wb)
    return new, out


def step(cfg: CoolingConfig, state: CoolingState, group_heat_w: torch.Tensor,
         dt: float, setpoint_delta_c=0.0, cells_offline=0.0,
         t_wetbulb_c: torch.Tensor | None = None,
         cells_failed: torch.Tensor | None = None
         ) -> tuple[CoolingState, CoolingOut]:
    """Advance the plant by ``dt`` seconds from per-group heat (the grid
    path: the heat is the throttled IT power per CDU group).

    Args:
      group_heat_w: f32[S, G] heat load per CDU group (W).
      setpoint_delta_c: offset on the supply setpoint (°C), f32[S] or a
        number (``Scenario.setpoint_delta_c``).
      cells_offline: tower cells out for maintenance, a number, f32[S] or
        f32[S, H] (``Scenario.cells_offline``).
      t_wetbulb_c: ambient wet-bulb (°C) from a weather trace, f32[S] or
        f32[S, H] per hall; None takes the config's static value.
      cells_failed: tower cells down from the event layer, f32[S, H];
        None without it.
    Returns:
      (new_state, CoolingOut); the hall heat sums are formed from
      ``group_heat_w`` inside ``_finish_step``.
    """
    t_wb, t_set = _effective(cfg, state, t_wetbulb_c, setpoint_delta_c)
    hs = halls(cfg, group_heat_w.device)
    t_basin_g = state.t_basin[:, hs.hog_idx]   # each group sees its hall's basin
    q, t_return, t_supply, mdot = cdu_update_ref(
        group_heat_w, state.t_supply, state.mdot, t_basin_g, t_set,
        cdu_params(cfg, dt))
    return _finish_step(cfg, state, dt, t_wb, t_set, q, t_return, t_supply,
                        mdot, cells_offline, cells_failed)


def step_from_node_power(cfg: CoolingConfig, state: CoolingState,
                         node_pw: torch.Tensor, dt: float,
                         setpoint_delta_c=0.0, cells_offline=0.0,
                         t_wetbulb_c: torch.Tensor | None = None,
                         cells_failed: torch.Tensor | None = None
                         ) -> tuple[CoolingState, CoolingOut, torch.Tensor]:
    """Advance the plant by ``dt`` seconds from per-node power f32[S, N]
    (W): the node->CDU->hall reduction and the CDU loop update run as one
    fused pass (``kernels.power_topo.fused_cooling_hier``: the Hopper
    kernel on the card), and total IT power falls out of the hall sums.
    The other arguments are ``step``'s.

    Returns:
      (new_state, CoolingOut, p_it) with ``p_it`` = f32[S] total IT power (W).
    """
    t_wb, t_set = _effective(cfg, state, t_wetbulb_c, setpoint_delta_c)
    q, t_return, t_supply, mdot, q_hall = topo_ops.fused_cooling_hier(
        node_pw, state.t_supply, state.mdot, state.t_basin, t_set,
        cfg.hall_of_group(), cfg.n_groups, cdu_params(cfg, dt))
    new, out = _finish_step(cfg, state, dt, t_wb, t_set, q, t_return,
                            t_supply, mdot, cells_offline, cells_failed,
                            q_hall=q_hall)
    return new, out, sum_exact(q_hall)


def thermal_now(cfg: CoolingConfig, state: CoolingState,
                setpoint_delta_c=0.0) -> ThermalNow:
    """Cooling-pressure signals for the scheduler, from the current state.

    ``excess`` ramps 0 -> 1 across the soft band
    [t_return_limit_c - thermal_margin_c, t_return_limit_c]; ``overheat``
    trips when a hall's hottest CDU supply exceeds the (effective)
    setpoint by ``t_supply_margin_c``.
    """
    hs = halls(cfg, state.t_return.device)
    t_ret_h = hall_max_ref(state.t_return, hs.hog, cfg.n_halls)
    t_sup_h = hall_max_ref(state.t_supply, hs.hog, cfg.n_halls)
    soft = cfg.t_return_limit_c - cfg.thermal_margin_c
    excess_h = torch.clamp(t_ret_h - soft, min=0.0) / cfg.thermal_margin_c
    _, t_set = _effective(cfg, state, None, setpoint_delta_c)
    overheat_h = t_sup_h > (t_set + cfg.t_supply_margin_c)[:, None]
    return ThermalNow(excess=excess_h.amax(-1),
                      overheat=overheat_h.any(-1),
                      t_return_max=t_ret_h.amax(-1),
                      t_supply_max=t_sup_h.amax(-1),
                      excess_hall=excess_h, overheat_hall=overheat_h)


def thermal_neutral(n_scen: int, n_halls: int = 1, device="cpu") -> ThermalNow:
    """Signals that make every cooling-aware term a no-op."""
    z = torch.zeros((n_scen,), dtype=torch.float32, device=device)
    return ThermalNow(excess=z, overheat=torch.zeros_like(z, dtype=torch.bool),
                      t_return_max=z, t_supply_max=z,
                      excess_hall=torch.zeros((n_scen, n_halls),
                                              dtype=torch.float32,
                                              device=device),
                      overheat_hall=torch.zeros((n_scen, n_halls),
                                                dtype=torch.bool,
                                                device=device))


def pue(p_it: torch.Tensor, p_loss: torch.Tensor,
        p_cooling: torch.Tensor) -> torch.Tensor:
    """Power usage effectiveness: facility input power over IT power (W/W)."""
    return (p_it + p_loss + p_cooling) / torch.clamp(p_it, min=1.0)
