"""Seeded stochastic failure processes and demand-response events (port of
``repro.events.process``), batched over scenarios.

Every engine step draws fresh failures from the stateless key
``fold_in(PRNGKey(failure_seed), step)`` of each scenario, bit for bit
the JAX package's draws (``repro_torch.prng``): the same seed replays the
same failure universe in a solo run and in any row of a sweep.

Three entity classes fail independently per step with hazard rates from
the ``Scenario`` knobs (probability ``1 - exp(-rate * dt)``), plus one
common-cause draw per hall that takes down every CDU group in the hall
together (``failure_corr`` scales its probability relative to the
single-group hazard). Repair times are exponential with mean
``repair_s``. An entity is down while ``t < down_until``; ``down_until``
only grows, so a failed entity never comes back before its repair, and
for a fixed seed the realized downtime grows with the rates (the fail
sets nest) and with ``repair_s`` (durations scale).

A node is unavailable while it or its CDU group is down. Running jobs
on an unavailable node are killed: requeued (``EventConfig.requeue``) or
dismissed, their accrued energy moved to the energy-not-served ledger.
Down free nodes are parked at ``-2`` in ``node_job``, outside the ``-1``
free pool that placement takes from; repair returns them to ``-1``.

Demand-response events are deterministic cap steps on the grid path:
announced at ``dr_announce_s``, the cap ``dr_cap_w`` engages
``dr_notice_s`` later and holds for ``dr_duration_s``; during the notice
window the scheduler already refuses jobs that would run into the event
unless they fit under the announced cap (``core.scheduler``).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import prng, resolve_device
from repro_torch.core import types as T
from repro_torch.kernels.power_topo.ref import group_ids
from repro_torch.power.model import sum_exact
from repro_torch.systems.config import SystemConfig

# the seven draws of a step, in the order of split(key, 7): uniforms for
# node, CDU-group, hall and cell failures, exponentials for node, group
# and cell repair times
N_DRAWS = 7


@dataclasses.dataclass(frozen=True)
class EventConfig:
    """Switches of the event layer; passing one to an entry point turns
    the failure process on. ``requeue``: killed jobs return to the queue;
    False dismisses them (the job is lost with its energy)."""
    requeue: bool = True


class EventsNow(NamedTuple):
    """Per-step failure telemetry, per scenario, handed from the failure
    pass to the cooling plant and the telemetry row."""
    cells_failed_hall: torch.Tensor  # f32[S, H] failed tower cells per hall
    nodes_down: torch.Tensor         # f32[S] nodes unavailable this step
    n_killed: torch.Tensor           # f32[S] jobs killed this step
    groups_down: torch.Tensor        # f32[S] CDU groups down this step


class DrNow(NamedTuple):
    """The demand-response event at one instant, per scenario."""
    start_s: torch.Tensor    # f32[S] when the cap engages (announce + notice)
    cap_w: torch.Tensor      # f32[S] announced cap level (inf when no event)
    cap_now_w: torch.Tensor  # f32[S] cap in force now (inf outside the event)
    in_notice: torch.Tensor  # bool[S] inside the announced notice window


def dr_now(scen: T.Scenario, t: torch.Tensor) -> DrNow:
    """The demand-response event at time ``t`` (f32[S], s). Disabled
    (``dr_announce_s < 0`` or ``dr_cap_w <= 0``): every field is neutral
    (inf caps, never in notice)."""
    enabled = (scen.dr_announce_s >= 0.0) & (scen.dr_cap_w > 0.0)
    start = scen.dr_announce_s + torch.clamp(scen.dr_notice_s, min=0.0)
    end = start + torch.clamp(scen.dr_duration_s, min=0.0)
    active = enabled & (t >= start) & (t < end)
    in_notice = enabled & (t >= scen.dr_announce_s) & (t < start)
    return DrNow(start_s=start,
                 cap_w=torch.where(enabled, scen.dr_cap_w, torch.inf),
                 cap_now_w=torch.where(active, scen.dr_cap_w, torch.inf),
                 in_notice=in_notice)


def init_event_state(system: SystemConfig, device="cpu") -> T.EventState:
    """Everything healthy, without the scenario axis (as ``init_state``):
    every repair-complete time in the far past."""
    full = lambda n: torch.full((n,), -torch.inf, dtype=torch.float32,
                                device=device)
    zero = lambda: torch.zeros((), dtype=torch.float32, device=device)
    return T.EventState(
        node_down_until=full(system.n_nodes),
        group_down_until=full(system.cooling.n_groups),
        cell_down_until=full(system.cooling.n_tower_cells),
        jobs_killed=zero(), jobs_requeued=zero(), energy_lost_j=zero(),
        node_downtime_s=zero())


def _maps(system: SystemConfig):
    """Static topology maps as host numpy: node -> CDU group, CDU group
    -> hall, tower cell -> hall."""
    gid = group_ids(system.n_nodes, system.cooling.n_groups).astype(np.int64)
    hog = np.asarray(system.cooling.hall_of_group(), np.int64)
    cell_hall = np.repeat(np.arange(system.cooling.n_halls, dtype=np.int64),
                          system.cooling.cells_per_hall())
    return gid, hog, cell_hall


@functools.lru_cache(maxsize=16)
def _device_maps(system: SystemConfig, device: torch.device):
    """``_maps`` as i64 index tensors on ``device`` (cached: a step never
    copies them from the host again)."""
    return tuple(torch.from_numpy(m).to(device) for m in _maps(system))


def _advance_masks(system: SystemConfig, ev: T.EventState, scen: T.Scenario,
                   t: torch.Tensor, step: torch.Tensor):
    """One step of the availability-mask process for every scenario
    (shared by ``apply_failures`` and the ``realize_masks`` oracle).

    Returns ``((node_until, group_until, cell_until), (unavail bool[S, N],
    group_down bool[S, G], cell_down bool[S, C]))``.
    """
    dt = system.dt
    gid, hog, _ = _device_maps(system, t.device)
    N, G = system.n_nodes, system.cooling.n_groups
    C, H = system.cooling.n_tower_cells, system.cooling.n_halls
    # torch.round rounds half to even, as jnp.round does
    seed = torch.round(scen.failure_seed.to(torch.float32)).to(torch.int32)
    keys = prng.split(prng.fold_in(prng.seed_key(seed), step), N_DRAWS)
    bits = prng.random_bits_many(keys, (N, G, H, C, N, G, C))
    u_node, u_grp, u_hall, u_cell = (prng.bits_to_uniform(b)
                                     for b in bits[:4])
    e_node, e_grp, e_cell = (prng.uniform_to_exponential(
        prng.bits_to_uniform(b)) for b in bits[4:])

    def p_of(rate):                   # f32[S] -> f32[S, 1]
        r = torch.clamp(rate.to(torch.float32), min=0.0)
        return torch.clamp(-torch.expm1(-r * dt), 0.0, 1.0)[:, None]

    # independent per-entity draws: the fail sets nest as a rate grows
    # (same uniforms, larger threshold)
    fail_n = u_node < p_of(scen.node_fail_rate)
    p_grp = p_of(scen.cdu_fail_rate)
    fail_g = u_grp < p_grp
    # common cause: one draw per hall takes all of the hall's groups down
    p_hall = torch.clamp(scen.failure_corr.to(torch.float32), 0.0,
                         1.0)[:, None] * p_grp
    fail_g = fail_g | (u_hall < p_hall)[:, hog]
    fail_c = u_cell < p_of(scen.cell_fail_rate)

    rep = torch.clamp(scen.repair_s.to(torch.float32), min=0.0)[:, None]
    now = t[:, None]

    def until(old, fail, e):
        # max(old, ...): a failure during repair extends the outage, and
        # down_until never shrinks
        return torch.where(fail, torch.maximum(old, now + rep * e), old)

    node_until = until(ev.node_down_until, fail_n, e_node)
    grp_until = until(ev.group_down_until, fail_g, e_grp)
    cell_until = until(ev.cell_down_until, fail_c, e_cell)

    grp_down = now < grp_until
    cell_down = now < cell_until
    unavail = (now < node_until) | grp_down[:, gid]
    return (node_until, grp_until, cell_until), (unavail, grp_down,
                                                 cell_down)


def apply_failures(cfg: EventConfig, system: SystemConfig,
                   table: T.JobTable, st: T.SimState, scen: T.Scenario
                   ) -> tuple[T.SimState, EventsNow]:
    """Engine phase (2b), for every scenario: draw this step's failures
    and repairs, kill the running jobs on unavailable nodes, and update
    the node map (``-2`` parks a down free node, repair returns it to
    ``-1``). Sums over jobs, nodes and cells are order-free
    (``sum_exact``), so a sweep row equals a solo run."""
    ev = st.events
    (nu, gu, cu), (unavail, grp_down, cell_down) = _advance_masks(
        system, ev, scen, st.t, st.step)
    S, H = st.t.shape[0], system.cooling.n_halls
    _, _, cell_hall = _device_maps(system, st.t.device)

    # kill every RUNNING job with at least one node unavailable: a
    # scatter-max of the hit flags over the job axis
    occupied = st.node_job >= 0
    owner = st.node_job.clamp(min=0).long()
    hit = torch.zeros_like(st.jstate).scatter_reduce(
        1, owner, (unavail & occupied).to(st.jstate.dtype), "amax") > 0
    kill = hit & (st.jstate == T.RUNNING)
    n_kill = sum_exact(kill.to(torch.float32))

    # release every node of a killed job, then flip availability
    node_job = torch.where(occupied & torch.gather(kill, 1, owner), -1,
                           st.node_job)
    node_job = torch.where(unavail & (node_job == -1), -2, node_job)
    node_job = torch.where(~unavail & (node_job == -2), -1, node_job)
    free_count = torch.sum(node_job == -1, 1, dtype=torch.int32)

    jstate = torch.where(kill, T.QUEUED if cfg.requeue else T.DISMISSED,
                         st.jstate)
    lost = sum_exact(torch.where(kill, st.jenergy, 0.0))
    nodes_down = sum_exact(unavail.to(torch.float32))
    new_ev = T.EventState(
        node_down_until=nu, group_down_until=gu, cell_down_until=cu,
        jobs_killed=ev.jobs_killed + n_kill,
        jobs_requeued=ev.jobs_requeued + (n_kill if cfg.requeue else 0.0),
        energy_lost_j=ev.energy_lost_j + lost,
        node_downtime_s=ev.node_downtime_s + nodes_down * system.dt)
    st = dataclasses.replace(
        st, jstate=jstate, start=torch.where(kill, torch.inf, st.start),
        end=torch.where(kill, torch.inf, st.end),
        progress=torch.where(kill, 0.0, st.progress),
        jenergy=torch.where(kill, 0.0, st.jenergy), node_job=node_job,
        free_count=free_count, events=new_ev)
    # cell counts per hall: whole numbers, exact in any order
    cells_failed_hall = torch.zeros((S, H), dtype=torch.float64,
                                    device=st.t.device).index_add_(
        1, cell_hall, cell_down.to(torch.float64)).to(torch.float32)
    return st, EventsNow(cells_failed_hall=cells_failed_hall,
                         nodes_down=nodes_down, n_killed=n_kill,
                         groups_down=sum_exact(grp_down.to(torch.float32)))


def realize_masks(system: SystemConfig, scen: T.Scenario, n_steps: int,
                  t0: float = 0.0, device="cuda") -> dict:
    """Host-facing oracle: the availability masks of one scenario over
    ``n_steps`` engine steps without the engine (no jobs, no plant),
    from the draw core the engine uses; on ``device`` (the CPU only when
    asked for).

    Returns numpy arrays: ``node_avail`` bool[T, N], ``group_down``
    bool[T, G], ``cell_down`` bool[T, C], ``nodes_down`` f32[T].
    """
    dev = resolve_device(device)
    scen = T.tree_map(lambda x: x.to(dev), T.stack_scenarios([scen]))
    ev = T.tree_map(lambda x: x[None], init_event_state(system, dev))
    t = torch.full((1,), t0, dtype=torch.float32, device=dev)
    step = torch.zeros((1,), dtype=torch.int32, device=dev)
    out = {"node_avail": [], "group_down": [], "cell_down": [],
           "nodes_down": []}
    for _ in range(int(n_steps)):
        (nu, gu, cu), (unavail, grp_down, cell_down) = _advance_masks(
            system, ev, scen, t, step)
        ev = dataclasses.replace(ev, node_down_until=nu,
                                 group_down_until=gu, cell_down_until=cu)
        for k, v in (("node_avail", ~unavail), ("group_down", grp_down),
                     ("cell_down", cell_down),
                     ("nodes_down", sum_exact(unavail.to(torch.float32)))):
            out[k].append(v[0])
        t, step = t + system.dt, step + 1
    return {k: torch.stack(v).cpu().numpy() for k, v in out.items()}
