"""Tensor state classes for the S-RAPS engine (port of ``repro.core.types``).

The JAX package keeps one unbatched pytree per run and batches a sweep
with ``vmap``. Here every engine-facing class is a dataclass of
tensors, and the state and scenario carry an explicit leading scenario
axis ``S`` (``SimState.t`` is f32[S], ``SimState.jstate`` i32[S, J], ...).
The job table is shared by every scenario and has no ``S`` axis. Layouts,
dtypes and units follow the JAX leaves field for field (f32 seconds, W,
°C; node axis last), so the two packages compare like with like.

``from_arrays`` builds each class from the JAX package's leaves given
as numpy arrays keyed by field name: both packages then compute from the
same state, and a segment (``engine.simulate_segment``) can resume from
a JAX carry.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Mapping

import numpy as np
import torch

# ---------------------------------------------------------------------------
# Job lifecycle states (values matter: they are stored in int32 tensors).
# ---------------------------------------------------------------------------
PENDING = 0     # known to the dataloader, not yet submitted (sim time < submit)
QUEUED = 1      # submitted, waiting for placement
RUNNING = 2     # placed on nodes
DONE = 3        # completed
DISMISSED = 4   # outside the simulation window (paper §3.2.2)

# Scheduling policies (paper §3.2.5 + §4.3 + §4.4), per-scenario integers.
POLICY_REPLAY = 0
POLICY_FCFS = 1
POLICY_SJF = 2
POLICY_LJF = 3
POLICY_PRIORITY = 4
POLICY_ACCT_AVG_POWER = 5       # descending average account power
POLICY_ACCT_LOW_AVG_POWER = 6   # ascending average account power
POLICY_ACCT_EDP = 7             # ascending accumulated EDP
POLICY_ACCT_ED2P = 8            # ascending accumulated ED^2P
POLICY_ACCT_FUGAKU_PTS = 9      # descending Fugaku points (Solorzano et al.)
POLICY_ML = 10                  # ML-guided score S(X_i) (paper §4.4)
POLICY_CARBON = 11              # grid-aware: defer energy-heavy jobs while
                                # carbon intensity is above its rolling mean
POLICY_PRICE = 12               # analogous on the electricity-price signal
POLICY_THERMAL = 13             # cooling-aware: defer heat-dense jobs while
                                # the tower return temp approaches its limit

POLICY_NAMES = {
    "replay": POLICY_REPLAY,
    "fcfs": POLICY_FCFS,
    "sjf": POLICY_SJF,
    "ljf": POLICY_LJF,
    "priority": POLICY_PRIORITY,
    "acct_avg_power": POLICY_ACCT_AVG_POWER,
    "acct_low_avg_power": POLICY_ACCT_LOW_AVG_POWER,
    "acct_edp": POLICY_ACCT_EDP,
    "acct_ed2p": POLICY_ACCT_ED2P,
    "acct_fugaku_pts": POLICY_ACCT_FUGAKU_PTS,
    "ml": POLICY_ML,
    "carbon_aware": POLICY_CARBON,
    "price_aware": POLICY_PRICE,
    "thermal_aware": POLICY_THERMAL,
}

# Backfill modes (paper §3.2.5).
BF_NONE = 0       # strict in-order admission: first blocked job stalls the queue
BF_FIRSTFIT = 1   # skip blocked jobs, keep admitting anything that fits
BF_EASY = 2       # EASY: reservation for the head job, conservative backfill

BACKFILL_NAMES = {"none": BF_NONE, "first-fit": BF_FIRSTFIT, "firstfit": BF_FIRSTFIT,
                  "easy": BF_EASY}


def tree_map(fn: Callable, obj):
    """Apply ``fn`` to every leaf of a (nested) dataclass of tensors, or of
    host arrays (a session's checkpoints); a None layer stays None."""
    kw = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            v = tree_map(fn, v)
        elif v is not None:
            v = fn(v)
        kw[f.name] = v
    return type(obj)(**kw)


def row(obj, i: int):
    """Scenario ``i`` of a batched dataclass (drops the leading axis)."""
    return tree_map(lambda x: x[i], obj)


def _join(objs: list, fn: Callable):
    kw = {}
    for f in dataclasses.fields(objs[0]):
        vs = [getattr(o, f.name) for o in objs]
        if vs[0] is None:
            v = None
        elif dataclasses.is_dataclass(vs[0]):
            v = _join(vs, fn)
        else:
            v = fn(vs)
        kw[f.name] = v
    return type(objs[0])(**kw)


def stack(objs: list):
    """Stack unbatched dataclasses of one structure on a new leading
    scenario axis (the inverse of ``row``). A field that is None in the
    first must be None in all of them."""
    return _join(objs, torch.stack)


def cat(objs: list):
    """Concatenate batched dataclasses of one structure, on one device,
    along the scenario axis."""
    return _join(objs, torch.cat)


def _tensor(a, device) -> torch.Tensor:
    # copy: JAX leaves arrive as read-only numpy views
    return torch.tensor(np.array(a), device=device)


def _from_arrays(cls, m: Mapping, device, batch: bool):
    kw = {}
    for f in dataclasses.fields(cls):
        optional = f.default is not dataclasses.MISSING
        v = m.get(f.name) if optional else m[f.name]
        if v is None:                 # an optional layer that is off
            pass
        elif isinstance(v, Mapping):
            v = _from_arrays(_NESTED[f.name], v, device, batch)
        else:
            v = _tensor(v, device)
            if batch:
                v = v.unsqueeze(0)
        kw[f.name] = v
    return cls(**kw)


# ---------------------------------------------------------------------------
# Static job table (inputs to the simulation; never mutated by the engine).
# ---------------------------------------------------------------------------
@dataclass
class JobTable:
    """Fixed-size (padded) job table, shared by every scenario. Shapes [J].

    Times are absolute seconds relative to the dataset origin: float32,
    or int32 in a compact table (``JobSet.to_table(compact_time=True)``:
    whole seconds below 2^24, a 2^30 sentinel for +inf), which the engine
    meets with float32 only in that exact range.
    ``power_prof``/``util_prof`` are per-node traces sampled at
    ``SystemConfig.prof_dt`` (P == 1 for scalar-only datasets); missing
    samples are last-observation-carried-forward by clamping the profile
    index (paper §3.2.2). ``power_profile`` is the measured-power replay
    channel (``repro_torch.traces``): recorded per-node watts on the same
    grid, played back in place of the model wherever a sample is >= 0;
    None turns replay off. ``ml_basis`` is the ML scoring basis
    (``repro_torch.ml.scoring.basis`` of each job's predicted features):
    the ``ml`` key is ``-(score + ml_basis @ Scenario.alpha)``, so one
    table ranks under a different alpha in every scenario; None ranks on
    ``score`` alone.
    """
    submit: torch.Tensor       # f32[J] submit time
    limit: torch.Tensor        # f32[J] requested walltime (s)
    wall: torch.Tensor         # f32[J] actual runtime (s) -- ground truth
    nodes: torch.Tensor        # i32[J] requested node count
    priority: torch.Tensor     # f32[J] dataset-provided priority (higher = better)
    account: torch.Tensor      # i32[J] issuing account id
    rec_start: torch.Tensor    # f32[J] recorded start time (replay mode)
    first_node: torch.Tensor   # i32[J] recorded first node of contiguous placement
    score: torch.Tensor        # f32[J] ML / external score (higher = better);
                               # f32[S, J] once a run folds ml_basis in
    power_prof: torch.Tensor   # f32[J, P] per-node power trace (W)
    util_prof: torch.Tensor    # f32[J, P] utilization trace in [0, 1]
    valid: torch.Tensor        # bool[J] padding mask
    ml_basis: torch.Tensor | None = None       # f32[J, K] basis, or None
    power_profile: torch.Tensor | None = None  # f32[J, Q] measured W, or None

    @property
    def num_jobs(self) -> int:
        return self.submit.shape[0]

    @property
    def prof_len(self) -> int:
        return self.power_prof.shape[1]

    def to(self, device) -> "JobTable":
        return tree_map(lambda x: x.to(device), self)

    @staticmethod
    def from_arrays(m: Mapping, device="cpu") -> "JobTable":
        """Build from the JAX ``JobTable``'s leaves (numpy, by field name)."""
        return _from_arrays(JobTable, m, device, batch=False)


# ---------------------------------------------------------------------------
# Ledgers updated by the engine.
# ---------------------------------------------------------------------------
@dataclass
class AccountStats:
    """Per-account accumulators (paper §3.2.6 + §4.3). Shapes [S, A]
    inside the engine, [A] for a warm-start ledger handed to it."""
    jobs_done: torch.Tensor     # f32
    node_hours: torch.Tensor    # f32
    energy: torch.Tensor        # f32 Joules
    edp: torch.Tensor           # f32 sum of E_job * turnaround
    ed2p: torch.Tensor          # f32 sum of E_job * turnaround^2
    wait_sum: torch.Tensor      # f32
    turnaround_sum: torch.Tensor  # f32
    power_sum: torch.Tensor     # f32 sum over jobs of avg per-node power
    fugaku_pts: torch.Tensor    # f32
    carbon_kg: torch.Tensor     # f32 grid-signal-weighted emissions (kg CO2)
    cost: torch.Tensor          # f32 electricity cost at the grid price ($)

    @staticmethod
    def zeros(num_accounts: int, device="cpu") -> "AccountStats":
        n = len(dataclasses.fields(AccountStats))
        return AccountStats(*(torch.zeros((num_accounts,), dtype=torch.float32,
                                          device=device) for _ in range(n)))


@dataclass
class CoolingState:
    """Transient thermo-fluid state of the cooling plant, per scenario:
    halls -> CDU groups -> nodes. G = CDU groups, H = halls. Temperatures
    °C, flow kg/s, fan staging in active cells per hall."""
    t_supply: torch.Tensor    # f32[S, G] CDU supply water temperature (°C)
    t_return: torch.Tensor    # f32[S, G] CDU return water temperature (°C)
    mdot: torch.Tensor        # f32[S, G] CDU water mass flow (kg/s)
    t_basin: torch.Tensor     # f32[S, H] per-hall tower basin temperature (°C)
    fan_stages: torch.Tensor  # f32[S, H] active tower cells per hall


@dataclass
class EventState:
    """Stochastic failure-process state (``repro_torch.events``), per
    scenario: present only when the event layer runs (``events=`` on the
    entry points). ``*_down_until`` hold the sim time (s) each entity's
    repair completes: it is down while ``t < down_until``, and since
    ``down_until`` never shrinks it cannot come back before its repair.
    N = nodes, G = CDU groups, C = installed tower cells."""
    node_down_until: torch.Tensor   # f32[S, N] repair-complete time per node
    group_down_until: torch.Tensor  # f32[S, G] per CDU group
    cell_down_until: torch.Tensor   # f32[S, C] per tower cell
    jobs_killed: torch.Tensor       # f32[S] jobs killed by failures
    jobs_requeued: torch.Tensor     # f32[S] killed jobs returned to the queue
    energy_lost_j: torch.Tensor     # f32[S] energy of killed jobs (not served)
    node_downtime_s: torch.Tensor   # f32[S] integral of down nodes x dt


@dataclass
class SimState:
    """Full engine state, batched over scenarios (leading axis S).

    ``init_state`` returns it without the S axis, as the JAX package
    does; the runners repeat it once per scenario. ``events`` is None
    unless the event layer runs.
    """
    t: torch.Tensor          # f32[S] current simulation time (s)
    step: torch.Tensor       # i32[S] engine step index
    jstate: torch.Tensor     # i32[S, J] job lifecycle state
    start: torch.Tensor      # f32[S, J] realized start time (or +inf)
    end: torch.Tensor        # f32[S, J] realized end time (or +inf)
    progress: torch.Tensor   # f32[S, J] work-time since start (s)
    jenergy: torch.Tensor    # f32[S, J] accumulated job energy (J)
    node_job: torch.Tensor   # i32[S, N] job id on each node, -1 free, -2 down
    free_count: torch.Tensor  # i32[S] number of free nodes
    accounts: AccountStats
    cooling: CoolingState
    energy_total: torch.Tensor   # f32[S] integral of facility input power (J)
    energy_it: torch.Tensor      # f32[S] integral of IT power (J)
    energy_loss: torch.Tensor    # f32[S] integral of conversion losses (J)
    completed: torch.Tensor      # f32[S] jobs completed inside the window
    emissions_kg: torch.Tensor   # f32[S] grid layer: stays 0 without signals
    energy_cost: torch.Tensor    # f32[S] grid layer: stays 0 without signals
    energy_cooling: torch.Tensor  # f32[S] integral of cooling parasitics (J)
    heat_reuse_j: torch.Tensor   # f32[S] integral of exported (reused) heat (J)
    events: EventState | None = None  # the event layer's state, when on

    @staticmethod
    def from_arrays(m: Mapping, device="cpu") -> "SimState":
        """Build from the JAX ``SimState``'s leaves (numpy, by field name;
        ``accounts``, ``cooling`` and ``events`` as nested mappings,
        ``events`` None when the layer is off). An unbatched JAX state
        (``t`` of rank 0) gains a scenario axis of size 1."""
        return _from_arrays(SimState, m, device,
                            batch=np.ndim(m["t"]) == 0)


_NESTED = {"accounts": AccountStats, "cooling": CoolingState,
           "events": EventState}


@dataclass
class StepRecord:
    """One telemetry row per engine step. In a finished run each field is
    f32[S, T] (f32[S, T, H] for the ``*_hall`` rows and ``cells_online``);
    ``simulate``/``simulate_static`` drop the S axis."""
    t: torch.Tensor
    power_it: torch.Tensor       # IT power (W)
    power_loss: torch.Tensor     # rectifier+sivoc losses (W)
    power_cooling: torch.Tensor  # cooling (tower fan + pumps) power (W)
    power_total: torch.Tensor    # facility input power (W)
    pue: torch.Tensor
    t_tower_return: torch.Tensor  # water temp arriving at cooling towers (°C)
    util: torch.Tensor           # busy nodes / total nodes
    n_queued: torch.Tensor
    n_running: torch.Tensor
    emissions_kg: torch.Tensor   # grid layer: 0 without signals
    energy_cost: torch.Tensor    # grid layer: 0 without signals
    cap_w: torch.Tensor          # grid layer: +inf (uncapped) without signals
    throttle_frac: torch.Tensor  # grid layer: 0 without signals
    power_fan: torch.Tensor      # tower fan power (W)
    power_pump: torch.Tensor     # CDU pump power (W)
    q_reuse_w: torch.Tensor      # heat exported for reuse (W)
    t_basin: torch.Tensor        # tower basin temperature (°C)
    t_supply_max: torch.Tensor   # hottest CDU supply temperature (°C)
    t_wetbulb: torch.Tensor      # ambient wet-bulb driving the tower (°C)
    thermal_throttled: torch.Tensor  # 1 when supply-temp admission gate on
    power_it_hall: torch.Tensor      # [H] IT power landing in each hall (W)
    t_basin_hall: torch.Tensor       # [H] per-hall basin temperature (°C)
    t_supply_max_hall: torch.Tensor  # [H] hottest CDU supply per hall (°C)
    t_wetbulb_hall: torch.Tensor     # [H] per-hall ambient wet-bulb (°C)
    cells_online: torch.Tensor       # [H] tower cells available per hall
    nodes_down: torch.Tensor         # nodes unavailable (0 without events)
    n_killed: torch.Tensor           # jobs killed by failures (0 without)
    overheat_hall: torch.Tensor      # [H] per-hall setpoint-lost flag


# ---------------------------------------------------------------------------
# Per-run scenario parameters (a batch of them rides the S axis).
# ---------------------------------------------------------------------------
@dataclass
class Scenario:
    """What-if knobs of one scenario (0-d tensors) or of a batch (leading
    axis S, see ``stack_scenarios``). Every knob after policy/backfill has
    a neutral default. The failure knobs act only when the engine runs
    with ``events=EventConfig(...)``: hazards in 1/s (0 = never fails),
    mean repair ``repair_s``; the demand-response event is off while
    ``dr_announce_s < 0`` or ``dr_cap_w <= 0``. ``alpha`` weighs the
    columns of ``JobTable.ml_basis`` in the ``ml`` key (a scalar weighs
    every column alike); the neutral 0 ranks on ``JobTable.score``
    alone."""
    policy: torch.Tensor            # i32 POLICY_*
    backfill: torch.Tensor          # i32 BF_*
    acct_weight: torch.Tensor       # f32 weight on account-derived keys
    carbon_weight: torch.Tensor     # f32 POLICY_CARBON deferral strength
    price_weight: torch.Tensor      # f32 POLICY_PRICE deferral strength
    cap_scale: torch.Tensor         # f32 scales GridSignals.cap_w
    thermal_weight: torch.Tensor    # f32 POLICY_THERMAL strength
    setpoint_delta_c: torch.Tensor  # f32 offset on the supply setpoint (°C)
    cells_offline: torch.Tensor     # f32 (or f32[H]) tower cells offline
    alpha: torch.Tensor             # f32 (or f32[K]) ML scoring weights
    failure_seed: torch.Tensor      # f32 seed of the failure draws
    node_fail_rate: torch.Tensor    # f32 per-node failure hazard (1/s)
    cdu_fail_rate: torch.Tensor     # f32 per-CDU-group hazard (1/s)
    cell_fail_rate: torch.Tensor    # f32 per-tower-cell hazard (1/s)
    failure_corr: torch.Tensor      # f32 hall-wide CDU outage scale in [0, 1]
    repair_s: torch.Tensor          # f32 mean repair time (s)
    dr_announce_s: torch.Tensor     # f32 DR announcement time (s; < 0 off)
    dr_notice_s: torch.Tensor       # f32 notice window before the cap (s)
    dr_duration_s: torch.Tensor     # f32 how long the DR cap holds (s)
    dr_cap_w: torch.Tensor          # f32 DR cap level (W; <= 0 off)

    @staticmethod
    def make(policy: str | int, backfill: str | int = "none",
             acct_weight: float = 1.0, carbon_weight: float = 1.0,
             price_weight: float = 1.0, cap_scale: float = 1.0,
             thermal_weight: float = 1.0, setpoint_delta_c: float = 0.0,
             cells_offline=0.0, alpha=0.0, failure_seed: float = 0.0,
             node_fail_rate: float = 0.0, cdu_fail_rate: float = 0.0,
             cell_fail_rate: float = 0.0, failure_corr: float = 0.0,
             repair_s: float = 3600.0, dr_announce_s: float = -1.0,
             dr_notice_s: float = 0.0, dr_duration_s: float = 0.0,
             dr_cap_w: float = 0.0) -> "Scenario":
        p = POLICY_NAMES[policy] if isinstance(policy, str) else policy
        b = BACKFILL_NAMES[backfill] if isinstance(backfill, str) else backfill
        f32 = lambda x: torch.tensor(np.asarray(x, np.float32))
        return Scenario(
            policy=torch.tensor(p, dtype=torch.int32),
            backfill=torch.tensor(b, dtype=torch.int32),
            acct_weight=f32(acct_weight), carbon_weight=f32(carbon_weight),
            price_weight=f32(price_weight), cap_scale=f32(cap_scale),
            thermal_weight=f32(thermal_weight),
            setpoint_delta_c=f32(setpoint_delta_c),
            cells_offline=f32(cells_offline), alpha=f32(alpha),
            failure_seed=f32(failure_seed), node_fail_rate=f32(node_fail_rate),
            cdu_fail_rate=f32(cdu_fail_rate),
            cell_fail_rate=f32(cell_fail_rate),
            failure_corr=f32(failure_corr), repair_s=f32(repair_s),
            dr_announce_s=f32(dr_announce_s), dr_notice_s=f32(dr_notice_s),
            dr_duration_s=f32(dr_duration_s), dr_cap_w=f32(dr_cap_w))

    @staticmethod
    def from_arrays(m: Mapping, device="cpu") -> "Scenario":
        """Build from the JAX ``Scenario``'s leaves (numpy, by field name),
        one scenario or a stacked batch."""
        return _from_arrays(Scenario, m, device, batch=False)


def stack_scenarios(scens: list) -> Scenario:
    """Stack scenarios on a leading S axis. Leaves are broadcast to a
    common shape first, so a scalar ``cells_offline`` (or ``alpha``)
    stacks against a per-hall (per-column) vector."""
    kw = {}
    for f in dataclasses.fields(Scenario):
        xs = [getattr(s, f.name) for s in scens]
        shape = torch.broadcast_shapes(*(x.shape for x in xs))
        kw[f.name] = torch.stack([x.expand(shape) for x in xs])
    return Scenario(**kw)
