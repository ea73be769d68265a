"""Built-in scheduler (paper §3.2.4-§3.2.5), port of ``repro.core.scheduler``:
policy priority keys + the bounded admission loop with no-backfill /
first-fit / EASY semantics, batched over scenarios.

* Policy and backfill mode are per-scenario integers (``Scenario``), so
  one batch sweeps scheduling configurations.
* The admission loop walks the first ``sched_budget`` entries of the
  key-sorted queue, as the reference's ``fori_loop`` does. Here it is a
  Python loop of batched tensor operations: every quantity stays a tensor
  and no step reads a value back to the host, so a step can later be
  captured as a CUDA graph. It is the slice's pace-setter on the card.
* EASY (Mu'alem & Feitelson): when the queue head cannot start, it gets a
  reservation at the *shadow time* (earliest time enough nodes free up,
  from the running jobs' requested limits); later jobs may backfill iff
  they fit now and either finish before the shadow time or use no more
  than the ``extra`` nodes spare at it.

* Cap-aware admission (grid path): with a ``GridNow`` the loop carries
  each scenario's projected IT power and starts a job only if its
  estimated added draw keeps the projection under the active cap.
  ``grid is None`` (no signals) skips that machinery entirely. A
  demand-response event (``repro_torch.events.DrNow``) lowers the cap
  while in force, and during its notice window a job that would run into
  it must also fit under the announced cap.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from repro_torch.cooling import model as cmodel
from repro_torch.core import resource_manager as rm
from repro_torch.core import types as T
from repro_torch.grid import signals as gsig
from repro_torch.kernels.power_topo.ref import group_ids
from repro_torch.ml.scoring import weighted_sum
from repro_torch.systems.config import SystemConfig

# ---------------------------------------------------------------------------
# Priority keys (smaller key = scheduled earlier).
# ---------------------------------------------------------------------------
def ml_score(table: T.JobTable, scen: T.Scenario) -> torch.Tensor:
    """The ML key's score, f32[S, J] (higher = earlier): the static part
    (``table.score``, baked at attach time) plus ``ml_basis @ alpha``
    with each scenario's alpha (f32[S], one weight for every column, or
    f32[S, K]), summed as the reference's jitted key
    (``scoring.weighted_sum``)."""
    S = scen.policy.shape[0]
    s = table.score.expand(S, -1)
    if table.ml_basis is not None:
        alpha = scen.alpha.reshape(S, 1, -1)        # [S, 1, K or 1]
        s = s + weighted_sum(table.ml_basis[None], alpha)
    return s


def fold_ml_basis(table: T.JobTable, scen: T.Scenario) -> T.JobTable:
    """``table`` with ``ml_score`` in place of its score (f32[S, J]) and
    no basis. The basis and the alphas are fixed over a run, so a runner
    folds them once instead of summing them again every step; the keys
    stay bit for bit the same."""
    if table.ml_basis is None:
        return table
    return dataclasses.replace(table, score=ml_score(table, scen),
                               ml_basis=None)


def policy_key(table: T.JobTable, accounts: T.AccountStats,
               scen: T.Scenario,
               thermal: cmodel.ThermalNow | None = None,
               grid: gsig.GridNow | None = None) -> torch.Tensor:
    """f32[S, J] primary sort key of each scenario's policy (smaller =
    earlier).

    Args:
      table: static job table (times s, power W).
      accounts: [S, A] per-account ledgers feeding the incentive policies.
      scen: batched scenario knobs (policy id, deferral weights).
      thermal: cooling-pressure signals at this step; neutral when None.
      grid: grid-signal values at this step, f32[S] each (g CO2/kWh,
        $/kWh, W); neutral when None.
    """
    S = scen.policy.shape[0]
    if thermal is None:
        thermal = cmodel.thermal_neutral(S, device=table.submit.device)
    if grid is None:
        grid = gsig.now_neutral(S, device=table.submit.device)
    # an id past a short ledger reads its last entry, as JAX clamps an
    # out-of-range gather
    acct = table.account.long().clamp(max=accounts.jobs_done.shape[-1] - 1)
    submit = table.submit.expand(S, -1)

    def per_acct(x):                  # [S, A] ledger -> [S, J] per job
        return x[:, acct]

    def avg_pw():
        return per_acct(accounts.power_sum) / torch.clamp(
            per_acct(accounts.jobs_done), min=1.0)

    # grid-aware deferral (carbon_aware / price_aware): FCFS order plus a
    # penalty on energy-heavy jobs (node-seconds as the energy proxy) while
    # the signal sits above its rolling mean. Weight 0 is pure FCFS.
    defer_cost = table.nodes.to(torch.float32) * table.limit

    def grid_key(now, ref, weight):                # [S] each
        excess = torch.clamp(now - ref, min=0.0) / torch.clamp(ref, min=1e-6)
        return submit + (weight * excess)[:, None] * defer_cost

    # cooling-aware deferral: FCFS order plus a penalty on heat-dense jobs
    # (W x node·s, in kW·node·s) ramping in with the return temperature
    defer_heat = defer_cost * table.power_prof[:, 0] * 1e-3

    def thermal_key():
        return submit + scen.thermal_weight[:, None] * \
            thermal.excess[:, None] * defer_heat

    # ML-guided key (paper §4.4.2): higher score = earlier
    ml_key = lambda: -ml_score(table, scen)

    builders = [
        lambda: table.rec_start.expand(S, -1),     # REPLAY: recorded order
        lambda: submit,                            # FCFS
        lambda: table.limit.expand(S, -1),         # SJF
        lambda: (-table.nodes.to(torch.float32)).expand(S, -1),  # LJF
        lambda: (-table.priority).expand(S, -1),   # PRIORITY (higher first)
        lambda: -avg_pw(),                         # ACCT_AVG_POWER (descending)
        avg_pw,                                    # ACCT_LOW_AVG_POWER
        lambda: per_acct(accounts.edp),            # ACCT_EDP (lower first)
        lambda: per_acct(accounts.ed2p),           # ACCT_ED2P
        lambda: -per_acct(accounts.fugaku_pts),    # ACCT_FUGAKU_PTS
        ml_key,                                    # ML score (higher first)
        lambda: grid_key(grid.carbon, grid.carbon_ref,
                         scen.carbon_weight),      # CARBON_AWARE
        lambda: grid_key(grid.price, grid.price_ref,
                         scen.price_weight),       # PRICE_AWARE
        thermal_key,                               # THERMAL_AWARE
    ]
    keys = torch.stack([b() for b in builders])            # [P, S, J]
    pol = scen.policy.long()
    k = torch.gather(keys, 0, pol[None, :, None].expand(1, S, keys.shape[-1]))[0]
    # account-derived keys mix with the scenario weight
    is_acct = (scen.policy >= T.POLICY_ACCT_AVG_POWER) & \
              (scen.policy <= T.POLICY_ACCT_FUGAKU_PTS)
    return torch.where(is_acct[:, None], k * scen.acct_weight[:, None], k)


def queue_order(table: T.JobTable, st: T.SimState, accounts: T.AccountStats,
                scen: T.Scenario, thermal: cmodel.ThermalNow | None = None,
                grid: gsig.GridNow | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Sorted queue per scenario: eligible jobs first by (key, submit), ties
    in index order. Returns (order i64[S, J], eligible bool[S, J]).

    torch has no lexsort: a stable sort by the submit tie-break, then a
    stable sort by the key, gives the reference's ``lexsort((tie, key))``
    order, ineligible jobs (key and tie both +inf) last in index order.
    """
    queued = st.jstate == T.QUEUED
    replay_gate = torch.where((scen.policy == T.POLICY_REPLAY)[:, None],
                              table.rec_start <= st.t[:, None], True)
    elig = queued & replay_gate & table.valid
    key = torch.where(elig, policy_key(table, accounts, scen, thermal, grid),
                      torch.inf)
    tie = torch.where(elig, table.submit, torch.inf)
    by_tie = torch.sort(tie, dim=1, stable=True).indices
    by_key = torch.sort(torch.gather(key, 1, by_tie), dim=1,
                        stable=True).indices
    return torch.gather(by_tie, 1, by_key), elig


# ---------------------------------------------------------------------------
# EASY shadow-time machinery.
# ---------------------------------------------------------------------------
def release_profile(table: T.JobTable, st: T.SimState):
    """Sorted *estimated* end times of running jobs (start + requested
    limit, as faithful EASY uses) and the cumulative nodes they release.

    Returns (end_sorted f32[S, J], cum_nodes i32[S, J]).
    """
    running = st.jstate == T.RUNNING
    est_end = torch.where(running, st.start + table.limit, torch.inf)
    end_sorted, order = torch.sort(est_end, dim=1, stable=True)
    released = torch.gather(torch.where(running, table.nodes, 0), 1, order)
    return end_sorted, torch.cumsum(released, 1, dtype=torch.int32)


def shadow_for(end_sorted: torch.Tensor, cum_nodes: torch.Tensor,
               free_now: torch.Tensor, need: torch.Tensor):
    """Earliest time ``need`` nodes are simultaneously free, and the surplus
    ("extra") nodes available then; all per scenario ([S])."""
    deficit = torch.clamp(need - free_now, min=0)
    k = torch.searchsorted(cum_nodes, deficit[:, None], right=False)
    k = torch.clamp(k, 0, cum_nodes.shape[1] - 1)
    shadow_t = torch.where(deficit == 0, 0.0,
                           torch.gather(end_sorted, 1, k)[:, 0])
    extra = free_now + torch.gather(cum_nodes, 1, k)[:, 0] - need
    return shadow_t, torch.clamp(extra, min=0)


# ---------------------------------------------------------------------------
# Hall-aware placement (FacilityTopology).
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=16)
def _hall_spans(system: SystemConfig, device: torch.device):
    """(node_hall i64[N], sizes i32[H], first-node i32[H]) of the
    contiguous per-hall node spans, on ``device``."""
    gid = group_ids(system.n_nodes, system.cooling.n_groups)
    node_hall = np.asarray(system.cooling.hall_of_group(), np.int64)[gid]
    sizes = np.bincount(node_hall, minlength=system.cooling.n_halls)
    first = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    put = lambda a, dt: torch.from_numpy(np.ascontiguousarray(a)).to(
        device=device, dtype=dt)
    return (put(node_hall, torch.int64), put(sizes, torch.int32),
            put(first, torch.int32))


def hall_placement_plan(system: SystemConfig, st: T.SimState,
                        thermal: cmodel.ThermalNow, is_replay: torch.Tensor):
    """Node preference order + per-hall admission inputs for one pass.

    Nodes are ordered by their hall's cooling pressure (soft-band
    ``excess_hall``, overheated halls last), index-stable within a hall,
    so first-free placement drains into the coolest hall first. Replay
    keeps the identity order. Built from an H-element sort plus an O(N)
    scatter per scenario.

    Returns (order i64[S, N], node_ok bool[S, N], free_ok i32[S]).
    """
    node_hall, sizes, first = _hall_spans(system, st.node_job.device)
    S = st.node_job.shape[0]
    node_ok = ~thermal.overheat_hall[:, node_hall]
    penalty_h = thermal.excess_hall + \
        1e3 * thermal.overheat_hall.to(torch.float32)
    penalty_h = penalty_h * torch.where(is_replay, 0.0, 1.0)[:, None]
    # stable H-sort of halls by pressure, then concatenate their spans
    hall_order = torch.sort(penalty_h, dim=1, stable=True).indices
    sz_sorted = sizes[hall_order]
    starts_sorted = torch.cumsum(sz_sorted, 1, dtype=torch.int32) - sz_sorted
    out_start = torch.zeros_like(starts_sorted).scatter_(1, hall_order,
                                                         starts_sorted)
    idx = torch.arange(system.n_nodes, dtype=torch.int32,
                       device=st.node_job.device)
    pos = out_start[:, node_hall] + (idx - first[node_hall])
    order = torch.zeros((S, system.n_nodes), dtype=torch.int64,
                        device=idx.device).scatter_(
        1, pos.long(), idx.long().expand(S, -1))
    free_ok = torch.sum((st.node_job == -1) & node_ok, 1, dtype=torch.int32)
    return order, node_ok, free_ok


# ---------------------------------------------------------------------------
# The scheduling pass.
# ---------------------------------------------------------------------------
def schedule_step(system: SystemConfig, table: T.JobTable, st: T.SimState,
                  scen: T.Scenario, thermal: cmodel.ThermalNow | None = None,
                  backfills: tuple[int, ...] | None = None,
                  grid: gsig.GridNow | None = None,
                  proj_pw: torch.Tensor | None = None,
                  dr=None) -> T.SimState:
    """One call of ``schedule`` (paper Algorithm step 3): reorder each
    scenario's queue by its policy and admit jobs under its backfill rule.

    Cap-aware admission: with grid signals (``grid``, f32[S] each) a job
    starts only if the projected IT power (``proj_pw`` f32[S], given with
    ``grid``: the raw draw after completions, plus the estimated draw
    added by jobs placed earlier in this pass) stays under
    ``grid.cap_w * scen.cap_scale``. A head blocked by the cap alone
    halts admission under BF_NONE and BF_EASY (backfill would eat the
    headroom it waits for); first-fit stays greedy. ``grid is None``
    skips the cap machinery entirely.

    Demand response (``dr``, a ``repro_torch.events.DrNow`` of f32[S]
    fields, grid path only): an event in force lowers the cap to
    ``dr.cap_now_w``; during the notice window a job whose requested
    limit runs past ``dr.start_s`` is admitted only if the projection
    also fits under the announced ``dr.cap_w``, so the scheduler
    pre-positions for the cap instead of running into it.

    Thermal admission throttling: when a hall's cooling loop has lost the
    supply setpoint by more than ``CoolingConfig.t_supply_margin_c``,
    admission into that hall is deferred for this step. On a multi-hall
    plant placement is hall-aware (``hall_placement_plan``); a flat plant
    keeps the all-or-nothing gate and identity placement order. Replay is
    exempt.

    ``backfills`` names the BF_* modes present in ``scen`` when the caller
    knows them (the runners read them off the scenario list once per run);
    a batch without EASY then skips the reservation machinery, as the
    reference's static path does. None means any mode may be present.
    """
    is_replay = scen.policy == T.POLICY_REPLAY
    hall_aware = thermal is not None and system.cooling.n_halls > 1
    if hall_aware:
        order_nodes, node_ok, free_ok = hall_placement_plan(
            system, st, thermal, is_replay)
    else:
        order_nodes = node_ok = None
        free_ok = st.free_count
    thermal_ok = (torch.ones_like(is_replay) if thermal is None
                  else ~thermal.overheat)
    order, _ = queue_order(table, st, st.accounts, scen, thermal, grid)
    easy = backfills is None or T.BF_EASY in backfills
    if easy:
        end_sorted, cum_nodes = release_profile(table, st)
    else:
        end_sorted = cum_nodes = None

    # Per-pass, in queue order. Job ``order[s, i]`` is touched only by
    # iteration i, so its lifecycle state at iteration i is the state at
    # the top of the pass: validity, size and times are read once here.
    K = min(system.sched_budget, table.num_jobs)
    order_k = order[:, :K]
    t = st.t[:, None]
    replay_ok = torch.where(is_replay[:, None], table.rec_start[order_k] <= t,
                            True)
    valid_k = (torch.gather(st.jstate, 1, order_k) == T.QUEUED) & replay_ok
    need_k = table.nodes[order_k]
    if grid is None:
        cap = None
    else:
        # estimated power a job adds on start: its first profile sample
        # above the idle floor its nodes already draw
        est_add_pw = torch.clamp(
            table.power_prof[:, 0] - system.power.idle_node_w, min=0.0) * \
            table.nodes.to(torch.float32)
        cap_active = grid.cap_w * scen.cap_scale
        runs_into = dr_cap = None
        if dr is not None:
            cap_active = torch.minimum(cap_active, dr.cap_now_w)
            runs_into = dr.in_notice[:, None] & \
                (t + table.limit[order_k] > dr.start_s[:, None])
            dr_cap = dr.cap_w
        cap = (proj_pw, est_add_pw[order_k], cap_active, runs_into, dr_cap)
    placed, node_job, free_count = _admit(
        st.node_job, st.free_count, free_ok, order_k, valid_k, need_k,
        t + table.limit[order_k], scen.backfill, is_replay, thermal_ok,
        easy, end_sorted, cum_nodes, order_nodes, node_ok, cap)

    # commit: each job in order_k appears once, so the scatters are exact
    jstate = st.jstate.scatter(1, order_k, torch.where(
        placed, T.RUNNING, torch.gather(st.jstate, 1, order_k)))
    start = st.start.scatter(1, order_k, torch.where(
        placed, t, torch.gather(st.start, 1, order_k)))
    end = st.end.scatter(1, order_k, torch.where(
        placed, t + table.wall[order_k], torch.gather(st.end, 1, order_k)))
    return dataclasses.replace(st, jstate=jstate, start=start, end=end,
                               node_job=node_job, free_count=free_count)


def _admit(node_job, free_count, free_ok, order_k, valid_k, need_k,
           limit_end_k, backfill, is_replay, thermal_ok, easy, end_sorted,
           cum_nodes, order_nodes, node_ok, cap=None):
    """The admission loop: K sequential placement attempts, each batched
    over scenarios. Returns (placed bool[S, K], node_job, free_count).

    ``limit_end_k`` is t + the requested limit of each queued job (the
    EASY finish-before-shadow test); ``order_nodes``/``node_ok`` are None
    on a flat plant (index-order placement, all-or-nothing thermal gate).
    ``cap`` is None without grid signals, else (projected IT power f32[S],
    estimated added power of each queued job f32[S, K], active cap f32[S],
    and with a demand-response event the jobs that would run into it
    bool[S, K] and its announced cap f32[S], else None and None).
    """
    S, K = valid_k.shape
    hall_aware = order_nodes is not None
    is_none = backfill == T.BF_NONE
    is_ff = backfill == T.BF_FIRSTFIT
    no = torch.zeros_like(is_replay)
    blocked_any, head_blocked, head_capped = no, no, no
    shadow_t = torch.full((S,), torch.inf, device=node_job.device)
    shadow_extra = torch.zeros_like(free_count)
    order_k32 = order_k.to(torch.int32)
    placed = torch.zeros_like(valid_k)
    if cap is not None:
        proj, est_add_k, cap_active, runs_into, dr_cap = cap
    for i in range(K):
        need, valid = need_k[:, i], valid_k[:, i]
        # deterministic first-free placement (coolest hall first on a
        # multi-hall plant)
        if hall_aware:
            sel = rm.firstfree_mask_ordered(node_job, need, order_nodes)
        else:
            sel = rm.firstfree_mask(node_job, need)
        fits = need <= free_count
        if easy:
            # EASY reservation for the first blocked (head) job
            first_block = valid & ~fits & ~head_blocked
            sh_t, sh_extra = shadow_for(end_sorted, cum_nodes, free_count,
                                        need)
            shadow_t = torch.where(first_block, sh_t, shadow_t)
            shadow_extra = torch.where(first_block, sh_extra, shadow_extra)
            easy_ok = ((limit_end_k[:, i] <= shadow_t) |
                       (need <= shadow_extra)) & ~head_capped
            can_bf = torch.where(is_none, ~blocked_any,
                                 is_ff | ~(head_blocked | head_capped) |
                                 easy_ok)
        else:
            can_bf = ~is_none | ~blocked_any
        # thermal admission: a flat plant gates all-or-nothing, a
        # multi-hall one admits what fits inside the halls holding setpoint
        th_ok = need <= free_ok if hall_aware else thermal_ok
        # cap-aware admission: starting this job must not breach the cap.
        # Like the thermal gate it is a non-node resource: a head blocked
        # by either feeds blocked_any/head_capped below.
        if cap is None:
            ok = th_ok
        else:
            after = proj + est_add_k[:, i]
            cap_ok = after <= cap_active
            if runs_into is not None:
                # notice window: a job still running when the announced
                # cap engages must fit under that cap too
                cap_ok = cap_ok & (~runs_into[:, i] | (after <= dr_cap))
            ok = cap_ok & th_ok
        # replay ignores backfill, the cap and the thermal gate
        place = valid & fits & (is_replay | (can_bf & ok))

        node_job = rm.place(node_job, sel, order_k32[:, i], place)
        free_count = free_count - torch.where(place, need, 0)
        if hall_aware:
            free_ok = free_ok - torch.sum(sel & node_ok & place[:, None], 1,
                                          dtype=torch.int32)
        if cap is not None:
            proj = proj + torch.where(place, est_add_k[:, i], 0.0)
        placed[:, i] = place
        blocked_any = blocked_any | (valid & ~(fits & ok))
        head_blocked = head_blocked | (valid & ~fits)
        head_capped = head_capped | (valid & fits & ~ok)
    return placed, node_job, free_count
