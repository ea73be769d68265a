"""HPC system configurations (paper Table 1).

The port's own copy of ``repro.systems.config``: ``repro_torch`` imports
nothing from the JAX package, so the static machine descriptions live
here too and must be kept in step with the reference by hand.

A ``SystemConfig`` is *static* (hashable) — it parameterizes the compiled
engine. Numbers are taken from the paper where stated and from the cited
public documentation otherwise; they are calibration targets for the
synthetic dataset generators, not claims about the real machines. The
power/cooling parasitics are sized so the simulated PUE lands near the
paper's note that Frontier's actual PUE averages ~1.06.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Dict, Tuple


@dataclass(frozen=True)
class PowerConfig:
    """util -> electrical power model for one node (repro_torch.power.model)."""
    idle_node_w: float = 200.0       # node power at zero utilization
    peak_node_w: float = 1000.0      # node power at full utilization
    # rectifier efficiency eta(load) = c0 + c1*load + c2*load^2 (clipped)
    rect_c: Tuple[float, float, float] = (0.95, 0.05, -0.025)
    # secondary (sivoc / board VR) efficiency, same polynomial form
    sivoc_c: Tuple[float, float, float] = (0.97, 0.02, -0.01)
    rated_rack_kw: float = 300.0     # rectifier rated load per rack
    nodes_per_rack: int = 64
    ref_node_w: float = 800.0        # reference per-node power for Fugaku pts


@dataclass(frozen=True)
class FacilityTopology:
    """Hierarchical facility layout: halls -> CDU groups -> nodes.

    A *hall* is one machine room served by its own tower loop (basin +
    fan cells). CDU groups are assigned to halls by contiguous spans, and
    nodes map to CDU groups by contiguous spans (``kernels.power_topo.ref
    .group_ids``) — so the node->hall assignment is fully determined by
    this static description. The default (one hall, even splits) is the
    pre-hierarchy flat plant and reproduces its behavior exactly.

    ``groups_per_hall`` / ``cells_per_hall`` may be ``None`` (even split
    of ``CoolingConfig.n_groups`` / ``n_tower_cells``, first halls take
    the remainder) or explicit per-hall tuples summing to the config
    totals — ragged halls are allowed.
    """
    n_halls: int = 1
    groups_per_hall: Tuple[int, ...] | None = None
    cells_per_hall: Tuple[int, ...] | None = None

    def _split(self, total: int, explicit: Tuple[int, ...] | None,
               what: str) -> Tuple[int, ...]:
        if self.n_halls < 1:
            raise ValueError(f"n_halls must be >= 1, got {self.n_halls}")
        if explicit is not None:
            if len(explicit) != self.n_halls:
                raise ValueError(f"{what}: {len(explicit)} entries for "
                                 f"{self.n_halls} halls")
            if sum(explicit) != total:
                raise ValueError(f"{what}: sum {sum(explicit)} != {total}")
            if min(explicit) < 1:
                raise ValueError(f"{what}: every hall needs >= 1, "
                                 f"got {explicit}")
            return tuple(int(g) for g in explicit)
        base, rem = divmod(total, self.n_halls)
        if base < 1:
            raise ValueError(f"{what}: {total} cannot cover "
                             f"{self.n_halls} halls")
        return tuple(base + (1 if h < rem else 0)
                     for h in range(self.n_halls))

    def resolve_groups(self, n_groups: int) -> Tuple[int, ...]:
        """Per-hall CDU group counts (sums to ``n_groups``)."""
        return self._split(n_groups, self.groups_per_hall, "groups_per_hall")

    def resolve_cells(self, n_cells: int) -> Tuple[int, ...]:
        """Per-hall installed tower-cell counts (sums to ``n_cells``)."""
        return self._split(n_cells, self.cells_per_hall, "cells_per_hall")

    def hall_of_group(self, n_groups: int) -> Tuple[int, ...]:
        """Hall index of each CDU group (len ``n_groups``)."""
        out = []
        for h, g in enumerate(self.resolve_groups(n_groups)):
            out.extend([h] * g)
        return tuple(out)


@dataclass(frozen=True)
class CoolingConfig:
    """Transient CDU + cooling-tower loop parameters (repro_torch.cooling.model).

    Units: temperatures °C, heat/power W, flow kg/s, conductance W/K,
    time constants s. Derived quantities (tower-cell conductance, basin
    thermal mass) default to ``None`` and are computed from the rated
    numbers — see ``cell_ua()`` / ``basin_mcp()`` — so per-system configs
    stay consistent when only the rated capacity is overridden.
    """
    n_groups: int = 8                # CDU groups (segment-reduce targets)
    mdot_kg_s: float = 40.0          # max water mass flow per CDU (kg/s)
    cp_j_kg_k: float = 4186.0        # specific heat of water (J/(kg·K))
    t_supply_setpoint_c: float = 25.0
    ua_w_k: float = 4.0e5            # facility HX conductance per group (W/K)
    tower_tau_s: float = 600.0       # basin/tower thermal time constant (s)
    t_wetbulb_c: float = 18.0        # default ambient wet-bulb (no weather)
    tower_approach_c: float = 4.0    # tower approach at design (°C above wb)
    n_tower_cells: int = 4
    cell_rated_heat_w: float = 2.5e6  # heat rejection per tower cell (W)
    fan_rated_w: float = 4.0e4       # tower fan rated power per cell (W)
    pump_w_per_group: float = 1.0e4  # CDU pump rated power (W, at full flow)
    # --- CDU valve/pump dynamics -------------------------------------------
    delta_t_design_c: float = 8.0    # design water ΔT across a CDU
    mdot_min_frac: float = 0.2       # valve floor as a fraction of mdot_kg_s
    tau_valve_s: float = 60.0        # flow slew time constant
    tau_hx_s: float = 120.0          # facility HX / supply-loop time constant
    # --- tower fan staging --------------------------------------------------
    tau_fan_s: float = 120.0         # fan staging slew time constant
    cell_ua_w_k: float | None = None  # tower-cell conductance at full fan
    basin_mcp_j_k: float | None = None  # basin thermal mass × cp (J/K)
    basin_margin_c: float = 3.0      # basin target sits this far below setpoint
    # fans-off ambient coupling (natural draft + windage), as a fraction of
    # the full-fan tower conductance; bidirectional — a heat wave warms an
    # idle basin toward the ambient wet-bulb through this path
    passive_ua_frac: float = 0.15
    # --- heat reuse / export (district-heating side stream) -----------------
    reuse_frac: float = 0.0          # fraction of return heat divertible
    reuse_max_w: float = 0.0         # export capacity cap (W)
    reuse_t_min_c: float = 30.0      # minimum return temp for useful export
    # --- thermal-aware scheduling limits ------------------------------------
    t_return_limit_c: float = 45.0   # hard limit on CDU return water temp
    thermal_margin_c: float = 5.0    # soft band below the limit (policy ramp)
    # supply excess (above setpoint) that halts admission: a last-resort
    # brake, sized to trip only after the thermal_aware deferral band —
    # ambient alone can push supply a few °C over setpoint in a heat wave
    t_supply_margin_c: float = 10.0
    # --- facility hierarchy (halls -> CDU groups -> nodes) ------------------
    topology: FacilityTopology = field(default_factory=FacilityTopology)

    @property
    def n_halls(self) -> int:
        return self.topology.n_halls

    def groups_per_hall(self) -> Tuple[int, ...]:
        return self.topology.resolve_groups(self.n_groups)

    def cells_per_hall(self) -> Tuple[int, ...]:
        return self.topology.resolve_cells(self.n_tower_cells)

    def hall_of_group(self) -> Tuple[int, ...]:
        return self.topology.hall_of_group(self.n_groups)

    def hall_weights(self) -> Tuple[float, ...]:
        """Fraction of the CDU fleet (and thus of the nominal heat load)
        served by each hall; splits hall-agnostic capacity knobs such as
        ``reuse_max_w``."""
        return tuple(g / self.n_groups for g in self.groups_per_hall())

    def cell_ua(self) -> float:
        """Tower-cell conductance (W/K) at full fan speed; rated heat over a
        6 °C basin-to-wet-bulb driving ΔT unless set explicitly."""
        return self.cell_ua_w_k if self.cell_ua_w_k is not None \
            else self.cell_rated_heat_w / 6.0

    def basin_mcp(self) -> float:
        """Facility-total basin thermal mass × cp (J/K): sized so the
        open-loop tower time constant is ``tower_tau_s`` at full-fan
        conductance."""
        return self.basin_mcp_j_k if self.basin_mcp_j_k is not None \
            else self.tower_tau_s * self.n_tower_cells * self.cell_ua()

    def basin_mcp_per_hall(self) -> Tuple[float, ...]:
        """Per-hall basin thermal mass × cp (J/K): each hall's basin scales
        with its installed cell count, so the per-hall open-loop time
        constant stays ``tower_tau_s``. Sums to ``basin_mcp()``."""
        total = self.basin_mcp()
        return tuple(total * c / self.n_tower_cells
                     for c in self.cells_per_hall())


@dataclass(frozen=True)
class GridConfig:
    """Grid-signal generators + DVFS power-capping limits (repro.grid).

    The *signals* themselves (carbon intensity, price, cap schedule) are
    precomputed arrays sampled at engine ``dt`` — see
    ``repro.grid.signals.synthetic_signals``; this config holds the static
    generator parameters and the throttle floor the cap-enforcement pass may
    not go below.
    """
    c_min: float = 0.5               # lowest DVFS cap factor (1 = no throttle)
    carbon_mean_gkwh: float = 350.0  # diurnal carbon intensity mean (g/kWh)
    carbon_amp_gkwh: float = 120.0   # diurnal swing amplitude
    price_mean_kwh: float = 0.08     # electricity price mean ($/kWh)
    price_amp_kwh: float = 0.04      # diurnal swing amplitude
    noise_frac: float = 0.05         # multiplicative AR(1) noise level
    ref_window_s: float = 6 * 3600.0  # rolling-mean window for "above average"
    peak_hours: Tuple[float, float] = (17.0, 21.0)  # evening price/cap peak


@dataclass(frozen=True)
class SystemConfig:
    name: str
    n_nodes: int
    prof_dt: float                   # telemetry sample period (s)
    scheduler: str                   # production scheduler (documentation)
    has_traces: bool                 # per-job time series vs scalar summary
    power: PowerConfig = field(default_factory=PowerConfig)
    cooling: CoolingConfig = field(default_factory=CoolingConfig)
    grid: GridConfig = field(default_factory=GridConfig)
    # engine defaults
    dt: float = 15.0                 # engine step (s)
    sched_budget: int = 32           # placement attempts per engine step

    def scaled(self, n_nodes: int) -> "SystemConfig":
        """A reduced-size variant for CPU tests: the cooling plant and rack
        fleet scale with the node count so PUE / loss fractions stay
        realistic. Per-group parameters are unchanged (each CDU still serves
        a similar node span)."""
        ratio = n_nodes / self.n_nodes
        # keep tower capacity proportional: resize cell count and rating so
        # cells * rating ~= ratio * original capacity; fan rating and the
        # heat-export cap follow so parasitic *fractions* stay realistic
        cells = max(int(round(self.cooling.n_tower_cells * ratio)), 1)
        cap = self.cooling.n_tower_cells * self.cooling.cell_rated_heat_w * ratio
        groups = max(int(round(self.cooling.n_groups * ratio)), 2)
        # explicit per-hall splits no longer sum to the scaled totals:
        # keep the hall count, fall back to even splits (clamped so every
        # hall keeps at least one group and one cell)
        halls = min(self.cooling.n_halls, groups, cells)
        cool = replace(
            self.cooling,
            n_groups=groups,
            n_tower_cells=cells,
            cell_rated_heat_w=cap / cells,
            fan_rated_w=self.cooling.fan_rated_w *
            (cap / cells) / self.cooling.cell_rated_heat_w,
            reuse_max_w=self.cooling.reuse_max_w * ratio,
            topology=FacilityTopology(n_halls=halls),
        )
        return replace(self, name=f"{self.name}-scaled{n_nodes}",
                       n_nodes=n_nodes, cooling=cool)


# --- Table 1 ---------------------------------------------------------------
FRONTIER = SystemConfig(
    name="frontier", n_nodes=9600, prof_dt=15.0, scheduler="slurm",
    has_traces=True, dt=15.0,
    power=PowerConfig(idle_node_w=700.0, peak_node_w=3200.0,
                      rect_c=(0.955, 0.045, -0.02), sivoc_c=(0.975, 0.02, -0.01),
                      rated_rack_kw=400.0, nodes_per_rack=128,
                      ref_node_w=2500.0),
    cooling=CoolingConfig(n_groups=25, mdot_kg_s=60.0, t_supply_setpoint_c=32.0,
                          t_wetbulb_c=20.0, ua_w_k=1.2e6, n_tower_cells=16,
                          reuse_frac=0.15, reuse_max_w=4.0e6,
                          reuse_t_min_c=34.0),
)

MARCONI100 = SystemConfig(
    name="marconi100", n_nodes=980, prof_dt=20.0, scheduler="slurm",
    has_traces=True, dt=20.0,
    power=PowerConfig(idle_node_w=240.0, peak_node_w=2200.0, ref_node_w=1600.0),
    cooling=CoolingConfig(n_groups=10, n_tower_cells=2, cell_rated_heat_w=1.5e6,
                          fan_rated_w=2.4e4, reuse_frac=0.2,
                          reuse_max_w=3.0e5, reuse_t_min_c=32.0),
)

FUGAKU = SystemConfig(
    name="fugaku", n_nodes=158976, prof_dt=60.0, scheduler="tcs",
    has_traces=False, dt=60.0,
    power=PowerConfig(idle_node_w=60.0, peak_node_w=180.0,
                      rect_c=(0.955, 0.04, -0.02), nodes_per_rack=384,
                      rated_rack_kw=70.0, ref_node_w=140.0),
    cooling=CoolingConfig(n_groups=32, mdot_kg_s=80.0, ua_w_k=1.5e6,
                          n_tower_cells=15),
)

LASSEN = SystemConfig(
    name="lassen", n_nodes=792, prof_dt=60.0, scheduler="lsf",
    has_traces=False, dt=30.0,
    power=PowerConfig(idle_node_w=260.0, peak_node_w=2400.0, ref_node_w=1800.0),
    cooling=CoolingConfig(n_groups=8, n_tower_cells=1, cell_rated_heat_w=2.5e6),
)

ADASTRA = SystemConfig(
    name="adastraMI250", n_nodes=356, prof_dt=30.0, scheduler="slurm",
    has_traces=False, dt=30.0,
    power=PowerConfig(idle_node_w=450.0, peak_node_w=2800.0, ref_node_w=2000.0),
    cooling=CoolingConfig(n_groups=4, t_supply_setpoint_c=30.0,
                          n_tower_cells=1, cell_rated_heat_w=1.5e6,
                          fan_rated_w=2.4e4),
)

SYSTEMS: Dict[str, SystemConfig] = {
    s.name: s for s in (FRONTIER, MARCONI100, FUGAKU, LASSEN, ADASTRA)
}
# aliases matching the paper's CLI
SYSTEMS["adastra"] = ADASTRA
SYSTEMS["marconi"] = MARCONI100


def get_system(name: str) -> SystemConfig:
    try:
        return SYSTEMS[name]
    except KeyError:
        raise KeyError(f"unknown system '{name}'; known: {sorted(SYSTEMS)}")
