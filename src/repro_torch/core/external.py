"""External-scheduler integration (paper §3.2.4-§3.2.5, §4.2), port of
``repro.core.external``.

Two coupling modes, as the paper describes them for ScheduleFlow and
FastSim:

* **plugin mode** (``run_plugin_mode``): the external (event-based)
  scheduler keeps its own copy of the system state; S-RAPS polls it each
  step for the set of jobs that should be running, diffs that against its
  own state and asks the resource manager to place the new ones
  (``engine.external_step``). The twin reads the job states back to the
  host once a step: it keeps its own copy of the state (paper §4.2.2).
* **sequential mode** (``run_sequential_mode``): the external simulator
  runs to completion first, its schedule becomes the recorded start
  times, and the twin replays it (paper §4.2.2: "we found it was faster
  to run FastSim and RAPS sequentially").

``FastSimLike`` wraps the numpy event-driven scheduler (the whole
schedule at reset, O(J) a query); ``ScheduleFlowLike`` mimics an
on-the-fly scheduler that recomputes its plan on every poll.

Wire protocol: each poll answer is a versioned envelope ``{"version":
WIRE_VERSION, "kind": "running_set", "job_ids": [...]}``
(``encode_running`` / ``decode_running``), validated before it could
touch engine state: version mismatches, non-integer ids, out-of-range ids
and duplicates raise ``ProtocolError``. ``SchedulerBridge`` owns the
per-call timeout and reconnect: a poll that exceeds
``BridgeConfig.timeout_s`` (wall time, enforced after the fact for an
in-process peer) or raises a transport error reconnects (``peer.reset``
replayed) and retries a bounded number of times; persistent failure
raises ``BridgeTimeout``. Out-of-process peers (``core.transport``'s
``SocketPeer`` and ``SubprocessPeer``) carry the same envelopes across a
process boundary; ``tools/reference_peer.py`` is the stdlib-only peer.
Protocol reference: docs/external-scheduling.md.

The coupling modes run on ``device="cuda"`` unless the caller passes
``device="cpu"``. Without grid signals a plugin step runs the fused
cooling kernel once; ``external_step`` with signals runs the group-power
kernel once.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field, replace
from typing import Iterable, Protocol

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import engine as eng
from repro_torch.core import types as T
from repro_torch.datasets.base import JobSet
from repro_torch.datasets.synthetic import event_schedule
from repro_torch.obs.timing import LatencyHistogram
from repro_torch.systems.config import SystemConfig

WIRE_VERSION = 1
WIRE_KIND_RUNNING = "running_set"
WIRE_KIND_RUNNING_SETS = "running_sets"  # batched poll_batch answer


class ProtocolError(RuntimeError):
    """The peer answered with a malformed / wrong-version wire message."""


class BridgeTimeout(RuntimeError):
    """The peer kept exceeding the per-call budget after reconnects."""


class ExternalScheduler(Protocol):
    """What S-RAPS needs from an external scheduling simulator."""

    def reset(self, system: SystemConfig, jobs: JobSet, t0: float) -> None: ...

    def running_at(self, t: float) -> np.ndarray:
        """Process events up to ``t``; return ids of jobs that should be
        running (FastSim plugin-mode contract: 'responds with a list of
        running jobs indexed by job ID')."""
        ...


# ---------------------------------------------------------------------------
# Wire format.
# ---------------------------------------------------------------------------
def encode_running(job_ids: Iterable[int]) -> dict:
    """Wrap a running-set answer in the versioned wire envelope."""
    return {"version": WIRE_VERSION, "kind": WIRE_KIND_RUNNING,
            "job_ids": [int(j) for j in job_ids]}


def decode_running(msg, n_jobs: int) -> np.ndarray:
    """Validate a wire envelope and return the running-set ids (i64[K]).

    Raises ``ProtocolError`` on anything a confused or wrong-version peer
    could send: not a dict, missing/mismatched version, wrong kind,
    non-integer ids, ids outside ``[0, n_jobs)``, duplicates.
    """
    if not isinstance(msg, dict):
        raise ProtocolError(f"wire message must be a dict envelope, "
                            f"got {type(msg).__name__}")
    ver = msg.get("version")
    if ver != WIRE_VERSION:
        raise ProtocolError(f"wire version mismatch: peer speaks {ver!r}, "
                            f"bridge speaks {WIRE_VERSION}")
    if msg.get("kind") != WIRE_KIND_RUNNING:
        raise ProtocolError(f"unexpected message kind {msg.get('kind')!r}")
    ids = msg.get("job_ids")
    if isinstance(ids, (list, tuple)) and \
            any(isinstance(x, bool) for x in ids):
        # JSON true/false would silently cast to 1/0 through np.asarray
        raise ProtocolError("job_ids must be integers, got booleans")
    try:
        arr = np.asarray(ids)
    except Exception as e:  # ragged / object payloads
        raise ProtocolError(f"job_ids not array-like: {e}") from e
    if arr.ndim != 1:
        # ndim before the empty-fastpath: a nested-but-empty payload like
        # [[]] has size 0 and must still be rejected, not silently passed
        raise ProtocolError(f"job_ids must be a flat integer list, got "
                            f"ndim={arr.ndim}")
    if arr.size == 0:
        return np.zeros((0,), np.int64)
    if not np.issubdtype(arr.dtype, np.integer):
        raise ProtocolError(f"job_ids must be a flat integer list, got "
                            f"dtype={arr.dtype}")
    arr = arr.astype(np.int64)
    if arr.min() < 0 or arr.max() >= n_jobs:
        raise ProtocolError(f"job id out of range [0, {n_jobs}): "
                            f"[{arr.min()}, {arr.max()}]")
    if np.unique(arr).size != arr.size:
        raise ProtocolError("duplicate job ids in running set")
    return arr


def encode_running_sets(sets: Iterable[Iterable[int]]) -> dict:
    """Wrap a batched running-set answer (one set per polled timestamp)."""
    return {"version": WIRE_VERSION, "kind": WIRE_KIND_RUNNING_SETS,
            "sets": [[int(j) for j in ids] for ids in sets]}


def decode_running_sets(msg, n_jobs: int, n_expected: int) -> list[np.ndarray]:
    """Validate a batched envelope; returns one id array per timestamp.

    Each inner set goes through the exact ``decode_running`` validation
    (version handled once at the envelope level), so a batched peer
    cannot sneak anything past the bridge that a per-poll peer could not.
    """
    if not isinstance(msg, dict):
        raise ProtocolError(f"wire message must be a dict envelope, "
                            f"got {type(msg).__name__}")
    ver = msg.get("version")
    if ver != WIRE_VERSION:
        raise ProtocolError(f"wire version mismatch: peer speaks {ver!r}, "
                            f"bridge speaks {WIRE_VERSION}")
    if msg.get("kind") != WIRE_KIND_RUNNING_SETS:
        raise ProtocolError(f"unexpected message kind {msg.get('kind')!r}")
    sets = msg.get("sets")
    if not isinstance(sets, (list, tuple)):
        raise ProtocolError(f"'sets' must be a list, got "
                            f"{type(sets).__name__}")
    if len(sets) != n_expected:
        raise ProtocolError(f"batched poll answered {len(sets)} sets for "
                            f"{n_expected} timestamps")
    return [decode_running({"version": WIRE_VERSION,
                            "kind": WIRE_KIND_RUNNING, "job_ids": ids},
                           n_jobs) for ids in sets]


# transport-style failures the bridge may heal by reconnecting; anything
# else raised by a peer is a peer bug and must surface with its own
# traceback (a reconnect would mask it and replay side effects)
TRANSPORT_ERRORS = (ConnectionError, OSError, TimeoutError)


@dataclass(frozen=True)
class BridgeConfig:
    """Per-call budget + retry policy for the external coupling.

    The default budget is deliberately generous: in-process peers cannot
    be preempted (the budget is enforced post-hoc) and a slow-but-correct
    peer — ScheduleFlowLike recomputes its whole plan per poll — must
    complete, not flap through reset/retry cycles. Tighten it for real
    out-of-process transports."""
    timeout_s: float = 30.0  # wall budget per poll (post-hoc for in-process)
    max_retries: int = 1     # reconnect+retry attempts after a failure


@dataclass
class SchedulerBridge:
    """Hardened coupling to an external scheduler.

    Validates every answer against the versioned wire format and owns the
    timeout/reconnect path: a poll that raises (transport-style failure)
    or blows its wall budget is discarded, the peer is *reconnected* — a
    fresh ``reset`` replaying (system, jobs, t0), the only resync an
    event-based peer supports — and the poll retried up to
    ``BridgeConfig.max_retries`` times; persistent failure raises
    ``BridgeTimeout``. ``ProtocolError`` is never retried: a peer that
    speaks the wrong dialect will keep speaking it.
    """
    peer: "ExternalScheduler"
    config: BridgeConfig = field(default_factory=BridgeConfig)
    reconnects: int = 0
    # flight-recorder counters (monotonic; surfaced via stats())
    polls: int = 0               # poll() calls answered successfully
    poll_failures: int = 0       # transport-style failures across attempts
    budget_exceeded: int = 0     # over-budget answers discarded post-hoc
    poll_latency: LatencyHistogram = field(default_factory=LatencyHistogram)
    on_event: object = None      # optional callable(event: str, fields: dict)
    _args: tuple | None = None

    def _emit(self, event: str, **fields) -> None:
        if self.on_event is not None:
            self.on_event(event, fields)

    def stats(self) -> dict:
        """Monotonic bridge counters + the peer's transport counters (when
        it exposes ``stats()`` — Socket/SubprocessPeer do), manifest- and
        ``fig7_external``-ready."""
        out = {"polls": self.polls, "poll_failures": self.poll_failures,
               "budget_exceeded": self.budget_exceeded,
               "reconnects": self.reconnects,
               "poll_latency": self.poll_latency.summary()}
        peer_stats = getattr(self.peer, "stats", None)
        if callable(peer_stats):
            out["peer"] = peer_stats()
        return out

    def reset(self, system: SystemConfig, jobs: JobSet, t0: float) -> None:
        """Resync the peer, retrying transport failures.

        An out-of-process peer can fail to *come up* (spawn or dial
        fails, handshake times out) exactly like it can fail mid-poll,
        so reset gets the same bounded-retry treatment. ``ProtocolError``
        (wrong version in hello, digest mismatch) is terminal — the peer
        will keep speaking the wrong dialect."""
        self._args = (system, jobs, t0)
        last: BaseException | None = None
        for attempt in range(self.config.max_retries + 1):
            try:
                self.peer.reset(system, jobs, t0)
                return
            except ProtocolError:
                raise
            except TRANSPORT_ERRORS as e:
                last = e
                if attempt < self.config.max_retries:
                    self.reconnects += 1
        raise BridgeTimeout(f"peer reset failed after "
                            f"{self.config.max_retries + 1} attempts: "
                            f"{last!r}")

    def _reconnect(self) -> str | None:
        """One reconnect attempt; returns an error note instead of letting
        a transport failure during the *resync itself* (e.g. a respawned
        subprocess that fails to dial) escape unwrapped — the poll retry
        loop owns the budget and converts persistent failure to
        ``BridgeTimeout``."""
        if self._args is None:
            raise BridgeTimeout("cannot reconnect before reset()")
        self.reconnects += 1
        self._emit("bridge_reconnect", reconnects=self.reconnects)
        try:
            self.peer.reset(*self._args)
            return None
        except TRANSPORT_ERRORS as e:
            return f"reconnect failed: {e!r}"

    def poll(self, t: float) -> np.ndarray:
        """Running-set ids at ``t``, validated; reconnects on failure."""
        n_jobs = len(self._args[1]) if self._args else 1 << 31
        last = "never polled"
        for attempt in range(self.config.max_retries + 1):
            retryable = attempt < self.config.max_retries
            t_call = time.perf_counter()
            try:
                if hasattr(self.peer, "poll_wire"):
                    ids = decode_running(self.peer.poll_wire(t), n_jobs)
                else:  # legacy peer: bare array, validated the same way
                    ids = decode_running(
                        encode_running(self.peer.running_at(t)), n_jobs)
            except ProtocolError:
                raise                       # malformed speech: not retryable
            except TRANSPORT_ERRORS as e:   # connection-style failure
                self.poll_failures += 1
                last = f"poll raised {e!r}"
                if retryable:               # no pointless trailing respawn
                    last = self._reconnect() or last
                continue
            took = time.perf_counter() - t_call
            self.poll_latency.record(took)
            if took > self.config.timeout_s:
                # in-process peers cannot be preempted: the budget is
                # enforced post-hoc and the stale answer discarded
                self.budget_exceeded += 1
                last = f"poll took {took:.3f}s > {self.config.timeout_s}s"
                if retryable:
                    last = self._reconnect() or last
                continue
            self.polls += 1
            return ids
        raise BridgeTimeout(f"peer unusable after "
                            f"{self.config.max_retries + 1} attempts: {last}")

    def poll_many(self, ts) -> list[np.ndarray]:
        """Running-set ids for several timestamps in one exchange.

        Uses the peer's ``poll_wire_batch`` when it both exists and the
        transport negotiated the batch capability (``batch_capable``);
        otherwise falls back to one ``poll`` per timestamp so callers
        never need to care which dialect the peer speaks. The batched
        path shares the per-call budget/retry machinery: the whole batch
        counts as one poll against ``timeout_s``.
        """
        ts = [float(t) for t in ts]
        if not ts:
            return []
        batch = getattr(self.peer, "poll_wire_batch", None)
        if batch is None or not getattr(self.peer, "batch_capable", True):
            return [self.poll(t) for t in ts]
        n_jobs = len(self._args[1]) if self._args else 1 << 31
        last = "never polled"
        for attempt in range(self.config.max_retries + 1):
            retryable = attempt < self.config.max_retries
            t_call = time.perf_counter()
            try:
                sets = decode_running_sets(batch(ts), n_jobs, len(ts))
            except ProtocolError:
                raise                       # malformed speech: not retryable
            except TRANSPORT_ERRORS as e:
                self.poll_failures += 1
                last = f"batched poll raised {e!r}"
                if retryable:
                    last = self._reconnect() or last
                continue
            took = time.perf_counter() - t_call
            self.poll_latency.record(took)
            if took > self.config.timeout_s:
                self.budget_exceeded += 1
                last = f"batched poll took {took:.3f}s > " \
                       f"{self.config.timeout_s}s"
                if retryable:
                    last = self._reconnect() or last
                continue
            self.polls += 1
            return sets
        raise BridgeTimeout(f"peer unusable after "
                            f"{self.config.max_retries + 1} attempts: {last}")


# ---------------------------------------------------------------------------
@dataclass
class FastSimLike:
    """Fast event-based Slurm-like emulator (Wilkinson et al. [41] stand-in).

    Precomputes the entire schedule on reset (event-driven, no time stepping)
    and answers ``running_at`` queries in O(log J) — the source of its
    hundreds-x real-time speedup.
    """
    policy: str = "fcfs"
    backfill: str = "firstfit"
    start: np.ndarray | None = None
    _jobs: JobSet | None = None

    def reset(self, system: SystemConfig, jobs: JobSet, t0: float) -> None:
        self._jobs = jobs
        self.start = event_schedule(jobs.submit, jobs.limit, jobs.wall,
                                    jobs.nodes, system.n_nodes, system.dt,
                                    policy=self.policy,
                                    backfill=self.backfill,
                                    priority=jobs.priority)

    def running_at(self, t: float) -> np.ndarray:
        s = self.start
        return np.nonzero((s <= t) & (s + self._jobs.wall > t))[0]

    def poll_wire(self, t: float) -> dict:
        """Versioned wire endpoint (bridge conformance)."""
        return encode_running(self.running_at(t))

    def poll_wire_batch(self, ts) -> dict:
        """Batched wire endpoint: one envelope for many timestamps."""
        return encode_running_sets(self.running_at(t) for t in ts)


@dataclass
class ScheduleFlowLike:
    """On-the-fly event scheduler (Gainaru et al. [18] stand-in): maintains an
    internal queue/system state and *recomputes the plan on every poll* —
    reproducing the overhead the paper reports for the ScheduleFlow coupling.
    """
    recompute_count: int = 0
    _state: dict | None = None

    def reset(self, system: SystemConfig, jobs: JobSet, t0: float) -> None:
        self._state = dict(system=system, jobs=jobs, t=t0,
                           free=system.n_nodes,
                           queue=[], started={}, finished=set(), cursor=0)

    def running_at(self, t: float) -> np.ndarray:
        st = self._state
        jobs: JobSet = st["jobs"]
        # ingest submissions up to t (events)
        order = np.argsort(jobs.submit, kind="stable")
        while st["cursor"] < len(jobs) and \
                jobs.submit[order[st["cursor"]]] <= t:
            st["queue"].append(int(order[st["cursor"]]))
            st["cursor"] += 1
        # completions
        for j, s in list(st["started"].items()):
            if s + jobs.wall[j] <= t:
                st["free"] += int(jobs.nodes[j])
                st["finished"].add(j)
                del st["started"][j]
        # full plan recomputation (the expensive part)
        self.recompute_count += 1
        st["queue"].sort(key=lambda q: (jobs.submit[q], q))
        placed = []
        for q in st["queue"]:
            need = int(jobs.nodes[q])
            if need <= st["free"]:
                st["free"] -= need
                st["started"][q] = t
                placed.append(q)
        for q in placed:
            st["queue"].remove(q)
        st["t"] = t
        return np.asarray(sorted(st["started"].keys()), dtype=np.int64)


# ---------------------------------------------------------------------------
# Coupling modes.
# ---------------------------------------------------------------------------
def _host_running(st: T.SimState) -> set[int]:
    """The ids the twin's own state has running (row 0), read back to
    the host: the one synchronisation of a plugin step."""
    return set(np.nonzero(st.jstate[0].cpu().numpy() == T.RUNNING)[0]
               .tolist())


def run_plugin_mode(system: SystemConfig, jobs: JobSet,
                    scheduler: ExternalScheduler, t0: float, t1: float,
                    pad_to: int | None = None, max_place: int = 64,
                    bridge_config: BridgeConfig | None = None,
                    scen: T.Scenario | None = None, device="cuda"):
    """Plugin mode: poll the external scheduler between engine steps.

    The peer is wrapped in a ``SchedulerBridge`` (versioned wire format,
    per-call timeout and reconnect) unless it already is one. Each step
    places at most ``max_place`` of the newly running jobs, in id order.
    ``scen`` routes the facility what-if knobs (cap scale, setpoint
    offset, cells offline) the external peer has no say over. Runs on
    ``device`` (``"cpu"`` only when asked for).

    Returns (final state, history, wall seconds): the state without the
    scenario axis, as ``engine.simulate`` returns it, and the history as
    the reference's: a dict of numpy arrays ([T] or [T, H]) keyed by the
    ``StepRecord`` fields, the grid rows constant.
    """
    dev = resolve_device(device)
    table = jobs.to_table(pad_to).to(dev)
    st = eng._fresh(system, table, 1, t0, t1, None, 64, None, dev)
    if scen is not None:
        scen = T.tree_map(lambda x: x.to(dev), T.stack_scenarios([scen]))
    bridge = scheduler if isinstance(scheduler, SchedulerBridge) else \
        SchedulerBridge(scheduler, bridge_config or BridgeConfig())
    bridge.reset(system, jobs, t0)
    n_steps = int(round((t1 - t0) / system.dt))
    rows = []
    wall0 = time.perf_counter()
    running_prev = _host_running(st)
    for i in range(n_steps):
        t = t0 + i * system.dt
        want = set(bridge.poll(t).tolist())
        new = sorted(want - running_prev)[:max_place]
        st, rec = eng.external_step(system, table, st, new, scen=scen)
        # S-RAPS keeps its own copy of the system state (paper §4.2.2)
        running_prev = _host_running(st)
        rows.append(rec)
    wall = time.perf_counter() - wall0
    hist = eng._history(rows)
    return T.row(st, 0), {k: v[0].cpu().numpy()
                          for k, v in vars(hist).items()}, wall


def run_sequential_mode(system: SystemConfig, jobs: JobSet,
                        scheduler: ExternalScheduler, t0: float, t1: float,
                        pad_to: int | None = None,
                        scen: T.Scenario | None = None, device="cuda"):
    """Sequential mode: external scheduler first, the twin's replay second.

    The peer's schedule becomes the recorded start times (never-started
    jobs at 2 * t1, past the window); the measured-power and ML channels
    are not carried over. ``scen`` routes the facility what-if knobs
    (cap scale, setpoint offset, cells offline) into the replay, as in
    plugin mode; its policy and backfill are overridden to replay (the
    external schedule is the policy). Returns ``engine.simulate``'s
    (final state, StepRecord history)."""
    scheduler.reset(system, jobs, t0)
    sched_start = np.asarray(scheduler.start, dtype=np.float64)
    rescheduled = JobSet(
        submit=jobs.submit, limit=jobs.limit, wall=jobs.wall,
        nodes=jobs.nodes, priority=jobs.priority, account=jobs.account,
        rec_start=np.where(np.isfinite(sched_start), sched_start, t1 * 2),
        power_prof=jobs.power_prof, util_prof=jobs.util_prof,
        first_node=jobs.first_node, score=jobs.score,
        name=jobs.name + "+external")
    table = rescheduled.to_table(pad_to)
    scen = T.Scenario.make("replay") if scen is None else replace(
        scen, policy=torch.tensor(T.POLICY_REPLAY, dtype=torch.int32),
        backfill=torch.tensor(T.BF_NONE, dtype=torch.int32))
    return eng.simulate(system, table, scen, t0, t1, device=device)
