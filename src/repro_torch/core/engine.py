"""The S-RAPS simulation engine (paper §3.2.3), port of ``repro.core.engine``.

Main loop per step (the paper's four steps), batched over scenarios:
  (1) prepare     -- clear completed jobs, free their nodes, fold accounting;
  (2) arrivals    -- move submitted jobs into the queue;
  (2b) failures   -- with the event layer: draw failures and repairs, kill
                     the jobs on unavailable nodes, evaluate the
                     demand-response event;
  (3) schedule    -- policy sort + bounded admission (``scheduler``),
                     cap-aware when grid signals are given and thermally
                     throttled when cooling loses its setpoint;
  (4) tick        -- power model -> without signals, the fused
                     node->CDU->hall cooling step (a Hopper kernel on the
                     card); with signals, DVFS cap enforcement (the
                     group-power Hopper kernel) -> the plant step on the
                     throttled group heat -> grid accrual and runtime
                     dilation; then conversion losses -> the rest of the
                     plant -> telemetry row; advance time.

The JAX engine scans one step function with ``lax.scan`` and batches
scenarios with ``vmap``. Here every tensor of the state carries the
scenario axis S and the scan is a Python loop over steps. Grid signals
(``repro_torch.grid.signals.GridSignals``) and weather traces
(``repro_torch.cooling.weather.WeatherSignals``) are shared by every
scenario, or for weather stacked one trace per scenario, and gathered at
each scenario's step. The event layer (``repro_torch.events``) carries
its state in ``SimState.events`` and draws each scenario's failures from
that scenario's seed; demand response needs grid signals (neutral ones
serve when there is no grid trace).

Segments (``simulate_segment``, ``simulate_segment_sweep``) resume from
any returned state: chained, they equal one uninterrupted scan bit for
bit, and a batch of branches at different steps equals each branch run
alone (``repro_torch.serve`` builds its sessions on them). The port runs
eagerly, so there is no compiled runner to cache.

Phase spans: when a ``repro_torch.obs.timing`` timer is installed on the
calling thread (``obs.use(timer)``), every entry point times its scan as
one ``engine.scan`` span, synchronising the card inside it. The port
compiles nothing, so it has none of the reference's ``engine.lower`` and
``engine.compile`` spans nor its static-cache counters. With no timer
the scan runs exactly as without the observability layer: no span, no
synchronisation.

``external_step`` is the paper's §4.2 plugin mode: an event-based
external scheduler decides the placements between steps
(``repro_torch.core.external`` drives it).

Entry points (``simulate``, ``simulate_static``, ``simulate_sweep`` and
the segment functions) run on ``device="cuda"`` unless the caller passes
``device="cpu"``; without a card a CUDA request raises.
``simulate_sweep_sharded`` splits a sweep's rows across ``devices``
(every visible card by default), one ``simulate_sweep`` a chunk.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from repro_torch import resolve_device
from repro_torch.cooling import model as cooling
from repro_torch.cooling import weather as wsig
from repro_torch.core import accounts as acct_mod
from repro_torch.core import resource_manager as rm
from repro_torch.core import scheduler as sched
from repro_torch.core import types as T
from repro_torch.events import process as ev_mod
from repro_torch.grid import powercap
from repro_torch.grid import signals as gsig
from repro_torch.obs import timing as obs_timing
from repro_torch.power import losses as plosses
from repro_torch.power import model as pmodel
from repro_torch.systems.config import SystemConfig


# ---------------------------------------------------------------------------
# Initialization (paper §3.2.1 / §3.2.3 prepopulation + dismissal).
# ---------------------------------------------------------------------------
def init_state(system: SystemConfig, table: T.JobTable, t0: float,
               t1: float, accounts: T.AccountStats | None = None,
               num_accounts: int = 64,
               events: ev_mod.EventConfig | None = None) -> T.SimState:
    """Initial engine state for the window ``[t0, t1]`` (seconds), on the
    table's device and without the scenario axis (as the reference's).

    Dismisses jobs entirely outside the window, prepopulates jobs already
    running at ``t0`` per the telemetry, queues jobs submitted but not yet
    started, and starts the cooling loop from its idle-plant condition.
    With ``events`` the state carries an all-healthy ``EventState``.
    """
    dev = table.submit.device
    J = table.num_jobs
    # int32 in a compact table, as in the reference (sentinel + wall stays
    # far past any window); every compare and ``where`` below meets the
    # float32 window in float32, where whole seconds below 2^24 are exact
    rec_end = table.rec_start + table.wall
    jstate = torch.full((J,), T.PENDING, dtype=torch.int32, device=dev)

    # dismiss jobs entirely outside the window (paper Fig. 3 discussion)
    dismissed = (~table.valid) | (rec_end <= t0) | (table.submit >= t1)
    jstate = torch.where(dismissed, T.DISMISSED, jstate)
    # prepopulate jobs running at t0 per the telemetry
    running0 = (~dismissed) & (table.rec_start <= t0) & (rec_end > t0) & \
        (table.first_node >= 0)
    jstate = torch.where(running0, T.RUNNING, jstate)
    # jobs already submitted but not yet started at t0 join the queue
    queued0 = (~dismissed) & (~running0) & (table.submit <= t0)
    jstate = torch.where(queued0, T.QUEUED, jstate)

    start = torch.where(running0, table.rec_start, torch.inf)
    end = torch.where(running0, rec_end, torch.inf)
    node_job = rm.prepopulate(system.n_nodes, table.first_node, table.nodes,
                              running0)
    free_count = torch.sum(node_job == -1, dtype=torch.int32)
    if accounts is None:
        accounts = T.AccountStats.zeros(num_accounts, dev)
    else:
        accounts = T.tree_map(lambda x: x.to(dev, copy=True), accounts)
    # prepopulated jobs ran unthrottled before the window: work-time
    # progress equals their wall-clock elapsed at t0
    progress = torch.where(running0,
                           torch.clamp(t0 - table.rec_start, min=0.0), 0.0)
    f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)
    return T.SimState(
        t=f32(t0), step=torch.tensor(0, dtype=torch.int32, device=dev),
        jstate=jstate, start=start, end=end, progress=progress,
        jenergy=torch.zeros((J,), dtype=torch.float32, device=dev),
        node_job=node_job, free_count=free_count, accounts=accounts,
        cooling=cooling.init_state(system.cooling, dev),
        energy_total=f32(0.0), energy_it=f32(0.0), energy_loss=f32(0.0),
        completed=f32(0.0), emissions_kg=f32(0.0), energy_cost=f32(0.0),
        energy_cooling=f32(0.0), heat_reuse_j=f32(0.0),
        events=(None if events is None
                else ev_mod.init_event_state(system, dev)))


# ---------------------------------------------------------------------------
# Engine phases (every tensor batched over scenarios).
# ---------------------------------------------------------------------------
def _prepare_and_arrivals(system: SystemConfig, table: T.JobTable,
                          st: T.SimState) -> T.SimState:
    """Phases (1)+(2): completions, node release, accounting, arrivals."""
    t = st.t[:, None]
    done_now = (st.jstate == T.RUNNING) & (t >= st.end)
    node_job = rm.release_done(st.node_job, done_now)
    freed = torch.sum(torch.where(done_now, table.nodes, 0), 1,
                      dtype=torch.int32)
    jstate = torch.where(done_now, T.DONE, st.jstate)
    accounts = acct_mod.fold_completions(system, table, st.accounts, done_now,
                                         st.start, st.end, st.jenergy)
    jstate = torch.where((jstate == T.PENDING) & (table.submit <= t),
                         T.QUEUED, jstate)
    return dataclasses.replace(
        st, jstate=jstate, node_job=node_job,
        free_count=st.free_count + freed, accounts=accounts,
        completed=st.completed + torch.sum(done_now, 1))


def _tick(system: SystemConfig, table: T.JobTable, st: T.SimState,
          thermal: cooling.ThermalNow, setpoint_delta_c, cells_offline,
          grid: gsig.GridNow | None = None,
          cap_active: torch.Tensor | None = None,
          wx: wsig.WeatherNow | None = None,
          ev_now: ev_mod.EventsNow | None = None
          ) -> Tuple[T.SimState, dict]:
    """Phase (4): cap enforcement + physics + accounting + telemetry.

    With grid signals (``grid``, f32[S] each), when the IT draw exceeds
    ``cap_active`` (f32[S]) the DVFS pass (``grid.powercap``) throttles
    every running node's dynamic power by a common factor c, and the
    affected jobs' remaining runtime dilates for this step: capping trades
    completion latency for peak power. ``grid is None`` is "no grid
    layer": no accrual, no dilation, and the node->CDU segment reduction
    fuses with the cooling-loop update (``cooling.step_from_node_power``).
    ``wx`` is this step's weather (None: the config's static wet-bulb);
    ``ev_now`` the failure pass's telemetry (None without the event
    layer), whose failed tower cells degrade the plant. Returns the new
    state and this step's telemetry (``_history`` adds the grid rows that
    are constant without signals).
    """
    dt = system.dt
    t_wb = None if wx is None else wx.t_wetbulb_c
    cells_failed = None if ev_now is None else ev_now.cells_failed_hall
    # profiles are indexed by work-time progress, so a throttled job's
    # trace plays at its dilated tempo instead of wall-clock time
    job_pw = pmodel.job_node_power_elapsed(table, st.jstate, st.progress,
                                           system.prof_dt)
    node_pw = pmodel.node_power(system, table, st.node_job, job_pw)
    running = st.jstate == T.RUNNING
    if grid is not None:
        idle = system.power.idle_node_w
        cap = powercap.enforce_cap(system, node_pw, cap_active)
        p_it = cap.p_it
        # DVFS only slows jobs with dynamic (above-idle) draw; a job at or
        # below the idle floor keeps full speed
        c_job = torch.where(running & (job_pw > idle), cap.c[:, None], 1.0)
        job_pw = powercap.throttle_power(job_pw, idle, cap.c)
        cool_state, cool = cooling.step(system.cooling, st.cooling,
                                        cap.group_heat, dt, setpoint_delta_c,
                                        cells_offline, t_wb, cells_failed)
    else:
        cool_state, cool, p_it = cooling.step_from_node_power(
            system.cooling, st.cooling, node_pw, dt, setpoint_delta_c,
            cells_offline, t_wb, cells_failed)
    n_racks = max(system.n_nodes // system.power.nodes_per_rack, 1)
    p_in, p_loss = plosses.conversion(system.power, p_it, float(n_racks))
    p_cool = cool.p_cooling
    p_total = p_in + p_cool

    job_e_step = torch.where(running,
                             job_pw * table.nodes.to(torch.float32) * dt, 0.0)
    grid_rows = {}        # the grid telemetry rows (constant without it)
    if grid is not None:
        accounts = acct_mod.accrue_grid(table, st.accounts, job_e_step,
                                        grid.carbon, grid.price)
        # runtime dilation: a throttled step advances a job's work-time by
        # only c*dt, so its projected end recedes by the shortfall
        # dt*(1 - c); t >= end  <=>  progress >= wall
        end = torch.where(running & torch.isfinite(st.end),
                          st.end + dt * (1.0 - c_job), st.end)
        progress = st.progress + torch.where(running, c_job * dt, 0.0)
        emissions = p_total * dt * grid.carbon / 3.6e6 * 1e-3  # g/kWh -> kg
        cost = p_total * dt * grid.price / 3.6e6               # $/kWh
        grid_rows = dict(emissions_kg=emissions, energy_cost=cost,
                         cap_w=cap_active, throttle_frac=1.0 - cap.c)
        advanced = dict(accounts=accounts, end=end, progress=progress,
                        emissions_kg=st.emissions_kg + emissions,
                        energy_cost=st.energy_cost + cost)
    else:
        advanced = dict(progress=st.progress + torch.where(running, dt, 0.0))
    busy = float(system.n_nodes) - st.free_count.to(torch.float32)
    zero = torch.zeros_like(st.t)
    if ev_now is not None:
        # down free nodes are parked at -2, outside the free pool:
        # utilization counts work, not outages
        busy = busy - ev_now.nodes_down
    if wx is None:
        t_wetbulb = torch.full_like(st.t, system.cooling.t_wetbulb_c)
    elif t_wb.ndim == 2:              # per-hall traces: their mean
        t_wetbulb = (t_wb.sum(-1, dtype=torch.float64) /
                     t_wb.shape[-1]).to(torch.float32)
    else:
        t_wetbulb = t_wb
    rec = dict(
        t=st.t, power_it=p_it, power_loss=p_loss, power_cooling=p_cool,
        power_total=p_total, pue=cooling.pue(p_it, p_loss, p_cool),
        t_tower_return=cool.t_tower_return,
        util=busy / system.n_nodes,
        n_queued=torch.sum(st.jstate == T.QUEUED, 1).to(torch.float32),
        n_running=torch.sum(running, 1).to(torch.float32),
        power_fan=cool.p_fan, power_pump=cool.p_pump,
        q_reuse_w=cool.q_reuse_w, t_basin=cool.t_basin,
        t_supply_max=cool.t_supply_max,
        thermal_throttled=thermal.overheat.to(torch.float32),
        # the hall heat sums ARE the per-hall IT power
        power_it_hall=cool.q_hall_w, t_basin_hall=cool.t_basin_hall,
        t_supply_max_hall=cool.t_supply_max_hall,
        t_wetbulb_hall=cool.t_wetbulb_hall, cells_online=cool.cells_online,
        overheat_hall=thermal.overheat_hall.to(torch.float32),
        t_wetbulb=t_wetbulb,
        nodes_down=zero if ev_now is None else ev_now.nodes_down,
        n_killed=zero if ev_now is None else ev_now.n_killed, **grid_rows)
    new = dataclasses.replace(
        st, t=st.t + dt, step=st.step + 1, **advanced,
        jenergy=st.jenergy + job_e_step, cooling=cool_state,
        energy_total=st.energy_total + p_total * dt,
        energy_it=st.energy_it + p_it * dt,
        energy_loss=st.energy_loss + p_loss * dt,
        energy_cooling=st.energy_cooling + p_cool * dt,
        heat_reuse_j=st.heat_reuse_j + cool.q_reuse_w * dt)
    return new, rec


def engine_step(system: SystemConfig, table: T.JobTable, st: T.SimState,
                scen: T.Scenario, backfills: tuple[int, ...] | None = None,
                signals: gsig.GridSignals | None = None,
                weather: wsig.WeatherSignals | None = None,
                events: ev_mod.EventConfig | None = None
                ) -> Tuple[T.SimState, dict]:
    """One engine step, phases (1)-(4), for a batch of scenarios.
    ``signals`` (on the state's device) enables the grid layer,
    ``weather`` drives the towers' ambient wet-bulb, ``events`` enables
    the failure and demand-response layer (the state must carry an
    ``EventState``); ``backfills``: see ``scheduler.schedule_step``."""
    st = _prepare_and_arrivals(system, table, st)
    ev_now = dr = None
    if events is not None:
        # phase (2b): failures and repairs, kills, the availability map;
        # the DR event is evaluated at the same instant
        st, ev_now = ev_mod.apply_failures(events, system, table, st, scen)
        dr = ev_mod.dr_now(scen, st.t)
    wx = None if weather is None else wsig.at_step(weather, st.step)
    # cooling-pressure signals for the thermal_aware policy + admission gate
    thermal = cooling.thermal_now(system.cooling, st.cooling,
                                  scen.setpoint_delta_c)
    if signals is None:
        # no grid layer: no admission power pass, no cap machinery (and
        # so no demand response)
        st = sched.schedule_step(system, table, st, scen, thermal=thermal,
                                 backfills=backfills)
        return _tick(system, table, st, thermal, scen.setpoint_delta_c,
                     scen.cells_offline, wx=wx, ev_now=ev_now)
    grid = gsig.at_step(signals, st.step)
    cap_active = grid.cap_w * scen.cap_scale
    if dr is not None:
        # an active demand-response event caps below the schedule
        cap_active = torch.minimum(cap_active, dr.cap_now_w)
    # raw IT draw after completions: the cap-aware admission baseline
    job_pw = pmodel.job_node_power_elapsed(table, st.jstate, st.progress,
                                           system.prof_dt)
    node_pw = pmodel.node_power(system, table, st.node_job, job_pw)
    st = sched.schedule_step(system, table, st, scen, thermal=thermal,
                             backfills=backfills, grid=grid,
                             proj_pw=pmodel.system_it_power(node_pw), dr=dr)
    return _tick(system, table, st, thermal, scen.setpoint_delta_c,
                 scen.cells_offline, grid, cap_active, wx, ev_now)


# ---------------------------------------------------------------------------
# Plugin mode for external event-based schedulers (paper §4.2).
# ---------------------------------------------------------------------------
def external_step(system: SystemConfig, table: T.JobTable, st: T.SimState,
                  place_ids, signals: gsig.GridSignals | None = None,
                  weather: wsig.WeatherSignals | None = None,
                  scen: T.Scenario | None = None
                  ) -> Tuple[T.SimState, dict]:
    """One engine step where placement decisions come from outside.

    ``st`` is a batched state on the table's device (S = 1 as ``_fresh``
    builds it, or any S: every scenario gets the same placements).
    ``place_ids``: the job ids the external scheduler wants started now,
    on the host (a sequence, numpy array or CPU tensor), optionally
    padded with -1. A -1 slot is a no-op wherever it stands, as in the
    reference, so only the real ids are visited: each costs a handful of
    launches, and the reference's K = 64 padded slots would cost ~500 a
    step. S-RAPS "interprets the information returned from the scheduler
    ... and triggers the resource manager" (paper §3.2.4). A job starts
    only if it is queued, fits the free nodes and passes the thermal gate
    (on a multi-hall plant: fits the free nodes of halls holding their
    setpoint, placed coolest hall first); the cap schedule (``signals``)
    still applies: an external scheduler cannot opt out of facility power
    or thermal management.

    ``scen`` routes the facility knobs the external scheduler has no say
    over: ``cap_scale`` (scales the cap schedule), ``setpoint_delta_c``
    and ``cells_offline``; None keeps every knob neutral. Its policy and
    backfill are ignored: the external peer is the policy. Without
    ``signals`` the tick runs the fused node->CDU cooling step
    (``fused_cooling`` on the card); with them, cap enforcement
    (``group_power``).

    Returns the new state and this step's telemetry row (a dict of
    f32[S] / f32[S, H]; ``_history`` stacks rows into a ``StepRecord``).
    """
    dev = st.t.device
    ids = [int(j) for j in torch.as_tensor(place_ids).reshape(-1).tolist()
           if j >= 0]
    if scen is None:
        # neutral knobs; the maintenance count as f32[S], so that the
        # per-hall telemetry keeps its scenario axis
        setpoint_delta, cap_scale = 0.0, 1.0
        cells_offline = torch.zeros_like(st.t)
    else:
        if scen.policy.ndim == 0:          # one scenario for every row
            scen = T.stack_scenarios([scen] * st.t.shape[0])
        setpoint_delta, cells_offline, cap_scale = (
            x.to(dev) for x in (scen.setpoint_delta_c, scen.cells_offline,
                                scen.cap_scale))
    grid = None if signals is None else gsig.at_step(signals.to(dev), st.step)
    wx = None if weather is None else wsig.at_step(weather.to(dev), st.step)
    st = _prepare_and_arrivals(system, table, st)
    thermal = cooling.thermal_now(system.cooling, st.cooling, setpoint_delta)
    if ids:
        st = _place_external(system, table, st, thermal, ids)
    return _tick(system, table, st, thermal, setpoint_delta, cells_offline,
                 grid, None if grid is None else grid.cap_w * cap_scale, wx)


def _place_external(system: SystemConfig, table: T.JobTable, st: T.SimState,
                    thermal: cooling.ThermalNow, ids: list[int]) -> T.SimState:
    """The reference's placement pass over the real ids, in their order,
    batched over scenarios."""
    S = st.t.shape[0]
    hall_aware = system.cooling.n_halls > 1
    if hall_aware:
        order_nodes, node_ok, free_ok = sched.hall_placement_plan(
            system, st, thermal,
            torch.zeros((S,), dtype=torch.bool, device=st.t.device))
    thermal_ok = ~thermal.overheat
    node_job, free_count = st.node_job, st.free_count
    jstate, start, end = st.jstate.clone(), st.start.clone(), st.end.clone()
    for j in ids:
        need = table.nodes[j].expand(S)
        th_ok = (need <= free_ok) if hall_aware else thermal_ok
        can = (jstate[:, j] == T.QUEUED) & (need <= free_count) & th_ok
        if hall_aware:
            sel = rm.firstfree_mask_ordered(node_job, need, order_nodes)
        else:
            sel = rm.firstfree_mask(node_job, need)
        node_job = rm.place(node_job, sel, torch.full_like(need, j), can)
        free_count = free_count - torch.where(can, need, 0)
        if hall_aware:
            free_ok = free_ok - torch.sum(sel & node_ok & can[:, None], 1,
                                          dtype=torch.int32)
        jstate[:, j] = torch.where(can, T.RUNNING, jstate[:, j])
        start[:, j] = torch.where(can, st.t, start[:, j])
        end[:, j] = torch.where(can, st.t + table.wall[j], end[:, j])
    return dataclasses.replace(st, jstate=jstate, start=start, end=end,
                               node_job=node_job, free_count=free_count)


# ---------------------------------------------------------------------------
# Full simulation.
# ---------------------------------------------------------------------------
def _history(rows: list[dict]) -> T.StepRecord:
    """Stack per-step rows into f32[S, T] (f32[S, T, H]) telemetry, adding
    the grid rows, constant when the run had no signals."""
    cols = {k: torch.stack([r[k] for r in rows], 1) for k in rows[0]}
    if "cap_w" not in cols:
        z = torch.zeros_like(cols["t"])
        cols.update(emissions_kg=z, energy_cost=z.clone(),
                    cap_w=torch.full_like(z, torch.inf),
                    throttle_frac=z.clone())
    return T.StepRecord(**cols)


def _scan(system: SystemConfig, table: T.JobTable, scen: T.Scenario,
          st: T.SimState, n_steps: int, signals, weather, events,
          dev: torch.device) -> Tuple[T.SimState, T.StepRecord]:
    """Scan the batched engine step ``n_steps`` times from the batched
    state ``st`` (on ``dev``). The backfill modes are read off this
    batch's scenarios, so a batch without EASY skips the reservation
    machinery. Inputs already on ``dev`` (a session's table and signals)
    are not copied again."""
    if n_steps < 1:
        raise ValueError(f"need at least one step, got {n_steps}")
    if (st.events is None) != (events is None):
        raise ValueError("the carry's event state must be present exactly "
                         "when events= is given: the carry "
                         f"{'lacks' if st.events is None else 'has'} one, "
                         f"events={events!r}")
    backfills = tuple(sorted(set(scen.backfill.tolist())))
    scen = T.tree_map(lambda x: x.to(dev), scen)
    table = sched.fold_ml_basis(table.to(dev), scen)
    S = scen.policy.shape[0]
    if signals is not None:
        signals = signals.to(dev)
    if weather is not None:
        weather = weather.to(dev)
        if weather.batched and weather.t_wetbulb_c.shape[0] != S:
            raise ValueError(f"need one weather trace per scenario: "
                             f"{weather.t_wetbulb_c.shape[0]} != {S}")
    timer = obs_timing.current()
    if timer is None:
        return _steps(system, table, st, scen, backfills, n_steps, signals,
                      weather, events)
    # observed run: one span around the scan, the card synchronised
    # inside it so that the span times the device's work, not the enqueue
    with timer.span("engine.scan", system=system.name, n_steps=n_steps,
                    n_scenarios=S):
        out = _steps(system, table, st, scen, backfills, n_steps, signals,
                     weather, events)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    return out


def _steps(system, table, st, scen, backfills, n_steps, signals, weather,
           events) -> Tuple[T.SimState, T.StepRecord]:
    rows = []
    for _ in range(n_steps):
        st, rec = engine_step(system, table, st, scen, backfills, signals,
                              weather, events)
        rows.append(rec)
    return st, _history(rows)


def _fresh(system: SystemConfig, table: T.JobTable, n_scen: int, t0: float,
           t1: float, accounts, num_accounts: int, events,
           dev: torch.device) -> T.SimState:
    """``init_state`` on ``dev``, repeated once per scenario."""
    st0 = init_state(system, table.to(dev), t0, t1, accounts, num_accounts,
                     events)
    return T.stack([st0] * n_scen)


def _stack_carries(carries: list, dev: torch.device) -> T.SimState:
    """Unbatched carries stacked on the scenario axis, on ``dev``."""
    if any(c.t.ndim != 0 for c in carries):
        raise ValueError("a carry must be unbatched, as simulate and "
                         "simulate_segment return it")
    devices = {c.t.device for c in carries}
    if len(devices) > 1:
        raise ValueError(f"the carries lie on different devices: "
                         f"{sorted(map(str, devices))}")
    if len({c.events is None for c in carries}) > 1:
        raise ValueError("some carries have an event state and some not")
    return T.tree_map(lambda x: x.to(dev), T.stack(list(carries)))


def _n_steps(system: SystemConfig, t0: float, t1: float) -> int:
    return int(round((t1 - t0) / system.dt))


def simulate(system: SystemConfig, table: T.JobTable, scen: T.Scenario,
             t0: float, t1: float, accounts: T.AccountStats | None = None,
             num_accounts: int = 64, signals: gsig.GridSignals | None = None,
             weather: wsig.WeatherSignals | None = None,
             carry: T.SimState | None = None,
             events: ev_mod.EventConfig | None = None,
             device="cuda") -> Tuple[T.SimState, T.StepRecord]:
    """Run the twin for one scenario from ``t0`` to ``t1`` (seconds).

    Args:
      system: static machine description.
      table: padded job table (times s, power W).
      scen: one scenario's knobs (``Scenario.make``).
      t0, t1: simulation window (s); ``round((t1 - t0) / dt)`` steps run.
      accounts: optional warm-start per-account ledgers ([A]).
      num_accounts: ledger size when ``accounts`` is None.
      signals: per-step grid signals (g CO2/kWh, $/kWh, cap W), which
        enable the grid layer; None runs without it.
      weather: per-step ambient conditions (°C) driving the towers; None
        takes the config's static wet-bulb.
      carry: start from this unbatched state instead of ``init_state``
        (resume from a checkpoint, see ``simulate_segment``): ``t0`` and
        ``t1`` still size the window, and its steps run from the carry's
        own clock.
      events: an ``EventConfig`` enabling the failure and demand-response
        layer, whose rates, seed and DR event are the scenario's knobs;
        None runs without it. A ``carry`` must hold an event state
        exactly when ``events`` is given.
      device: where to run; ``"cpu"`` only when asked for.
    Returns:
      (final SimState, StepRecord history f32[T] per field), without the
      scenario axis.
    """
    n_steps = _n_steps(system, t0, t1)
    if carry is not None:
        return simulate_segment(system, table, carry, scen, n_steps, signals,
                                weather, events, device)
    dev = resolve_device(device)
    final, hist = _scan(system, table, T.stack_scenarios([scen]),
                        _fresh(system, table, 1, t0, t1, accounts,
                               num_accounts, events, dev),
                        n_steps, signals, weather, events, dev)
    return T.row(final, 0), T.row(hist, 0)


def simulate_static(system: SystemConfig, table: T.JobTable, policy: str,
                    backfill: str, t0: float, t1: float,
                    accounts: T.AccountStats | None = None,
                    num_accounts: int = 64,
                    signals: gsig.GridSignals | None = None,
                    weather: wsig.WeatherSignals | None = None,
                    carry: T.SimState | None = None,
                    events: ev_mod.EventConfig | None = None, device="cuda"):
    """Single scenario named by policy and backfill, every other knob at
    its neutral default (so ``events`` draws no failure). A batch of one
    runs the sweep's arithmetic row for row, and a batch without EASY
    skips the reservation machinery, as the reference's static fast path
    does. ``carry`` resumes from a checkpoint (see ``simulate``)."""
    return simulate(system, table, T.Scenario.make(policy, backfill), t0, t1,
                    accounts, num_accounts, signals, weather, carry, events,
                    device)


def simulate_sweep(system: SystemConfig, table: T.JobTable,
                   scens: list[T.Scenario], t0: float, t1: float,
                   accounts: T.AccountStats | None = None,
                   num_accounts: int = 64,
                   signals: gsig.GridSignals | None = None,
                   weather=None, events: ev_mod.EventConfig | None = None,
                   device="cuda") -> Tuple[T.SimState, T.StepRecord]:
    """What-if sweep: S scenarios advance together, one batched step at a
    time (no Python loop over scenarios). The job table, initial state and
    grid signals are shared; the scenario knobs ride the S axis, so a
    (policy x cap-level x carbon-weight) sweep reads one signal set and
    scales the cap by ``Scenario.cap_scale``.

    ``weather`` is one ``WeatherSignals`` shared by every scenario or a
    list with one trace per scenario (stacked on the S axis). ``events``
    turns the failure layer on for the whole sweep; each row draws its
    own failures from its ``failure_seed`` and rates.

    Returns (final SimState [S, ...], StepRecord [S, T, ...]).
    """
    if isinstance(weather, (list, tuple)):
        if len(weather) != len(scens):
            raise ValueError(f"need one weather trace per scenario: "
                             f"{len(weather)} != {len(scens)}")
        weather = wsig.stack_weather(weather)
    dev = resolve_device(device)
    return _scan(system, table, T.stack_scenarios(list(scens)),
                 _fresh(system, table, len(scens), t0, t1, accounts,
                        num_accounts, events, dev),
                 _n_steps(system, t0, t1), signals, weather, events, dev)


def simulate_sweep_sharded(system: SystemConfig, table: T.JobTable,
                           scens: list[T.Scenario], t0: float, t1: float,
                           accounts: T.AccountStats | None = None,
                           num_accounts: int = 64,
                           signals: gsig.GridSignals | None = None,
                           weather=None,
                           events: ev_mod.EventConfig | None = None,
                           devices=None) -> Tuple[T.SimState, T.StepRecord]:
    """``simulate_sweep`` with the scenario rows split across devices.

    ``devices`` lists where to run (default: every visible card). The
    rows are cut into contiguous chunks, one a device in order (a device
    gets none when there are fewer scenarios than devices), and each
    chunk is a ``simulate_sweep`` on its device with its own copy of the
    job table, the initial state (a warm ledger included) and the grid
    signals; per-scenario weather (a list) is split with the scenarios.
    The chunks run one after another from this thread. The engine is
    bound by the host's dispatch, so a split issues the same launches
    per row and gains no speed on one host; what it spreads is the rows'
    device memory. Rows never communicate and a row equals the row run
    alone, so any split equals one batch bit for bit. The histories and
    final states are concatenated on the first device. One device is
    exactly ``simulate_sweep`` there. A device that is missing raises:
    the split never falls back to fewer devices or to the CPU.
    """
    if devices is None:
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())] \
            or ["cuda"]
    devs = [resolve_device(d) for d in devices]
    if not devs:
        raise ValueError("need at least one device")
    if len(devs) == 1:
        return simulate_sweep(system, table, scens, t0, t1, accounts,
                              num_accounts, signals, weather, events,
                              devs[0])
    per_row = isinstance(weather, (list, tuple))
    if per_row and len(weather) != len(scens):
        raise ValueError(f"need one weather trace per scenario: "
                         f"{len(weather)} != {len(scens)}")
    S, n = len(scens), len(devs)
    cuts = [i * (S // n) + min(i, S % n) for i in range(n + 1)]
    parts = [simulate_sweep(system, table, scens[lo:hi], t0, t1, accounts,
                            num_accounts, signals,
                            weather[lo:hi] if per_row else weather, events,
                            dev)
             for dev, lo, hi in zip(devs, cuts[:-1], cuts[1:]) if lo < hi]
    on_first = lambda x: x.to(devs[0])
    return (T.cat([T.tree_map(on_first, f) for f, _ in parts]),
            T.cat([T.tree_map(on_first, h) for _, h in parts]))


# ---------------------------------------------------------------------------
# Segment simulation (resume from a checkpoint; repro_torch.serve).
# ---------------------------------------------------------------------------
def simulate_segment(system: SystemConfig, table: T.JobTable,
                     carry: T.SimState, scen: T.Scenario, n_steps: int,
                     signals: gsig.GridSignals | None = None,
                     weather: wsig.WeatherSignals | None = None,
                     events: ev_mod.EventConfig | None = None,
                     device="cuda") -> Tuple[T.SimState, T.StepRecord]:
    """Advance the twin ``n_steps`` from an unbatched carry.

    The carry is the whole simulation state (job lifecycle, node
    occupancy, ledgers, the plant, the event state and the step cursor),
    and grid signals, weather, the demand-response window and the
    failure draws are all taken at the carry's own ``step`` and ``t``, so
    a chain of segments over the same full-horizon inputs is bit for bit
    one uninterrupted ``simulate``. This is what a session checkpoints,
    resumes and forks (``repro_torch.serve``).

    Args:
      carry: the state to start from: ``init_state(...)`` for a fresh
        trajectory, or any returned carry (or a decoded snapshot). It is
        not modified.
      scen: this segment's knobs (a fork changes them mid-trajectory).
      n_steps: engine steps to advance.
      signals / weather: full-horizon per-step inputs, indexed by the
        carry's absolute step (the last row carried forward past the end).
      events: must match the carry: an event state is present exactly
        when an ``EventConfig`` is given.
      device: where to run; ``"cpu"`` only when asked for. The carry is
        moved there.
    Returns:
      (carry after ``n_steps``, StepRecord of the segment, f32[T] per
      field), without the scenario axis.
    """
    final, hist = simulate_segment_sweep(system, table, [carry], [scen],
                                         n_steps, signals, weather, events,
                                         device)
    return T.row(final, 0), T.row(hist, 0)


def simulate_segment_sweep(system: SystemConfig, table: T.JobTable,
                           carries: list, scens: list, n_steps: int,
                           signals: gsig.GridSignals | None = None,
                           weather: wsig.WeatherSignals | None = None,
                           events: ev_mod.EventConfig | None = None,
                           device="cuda") -> Tuple[T.SimState, T.StepRecord]:
    """Batched ``simulate_segment``: B branches that may already have
    diverged (other fork points, other histories, other absolute steps)
    advance together, their carries and scenarios stacked on the S axis.
    Every gather is per row, at the row's own step, so row i is bit for
    bit branch i advanced alone.

    Args:
      carries: one unbatched ``SimState`` per branch, all of the same
        (system, table) lineage and on one device.
      scens: one ``Scenario`` per branch.
      n_steps: segment length shared by the batch.
    Returns:
      (carries after ``n_steps`` [B, ...], StepRecord [B, T, ...]).
    """
    if len(carries) != len(scens):
        raise ValueError(f"need one carry per scenario: "
                         f"{len(carries)} != {len(scens)}")
    if not carries:
        raise ValueError("need at least one carry")
    dev = resolve_device(device)
    return _scan(system, table, T.stack_scenarios(list(scens)),
                 _stack_carries(carries, dev), int(n_steps), signals,
                 weather, events, dev)
