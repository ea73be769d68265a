"""Branch and session manager for the persistent twin (port of
``repro.serve.session``).

A ``TwinSession`` owns one (system, job table, horizon) and a tree of
**branches**. Branch 0 is the root trajectory; any branch can be forked
at any of its interval checkpoints into a child with a changed
``Scenario``. The child starts from the parent's carry at the fork point,
so its prefix is never simulated again.

Time is discrete: the horizon is split into *intervals* of
``interval_steps`` engine steps, every advance lands on an interval
boundary, and the full carry is checkpointed there. A branch's state at
step k does not depend on the segmentation that produced it: a chain of
``engine.simulate_segment`` calls is bit for bit one scan.

Coalescing: ``advance_many`` moves any set of branches forward tick by
tick, and every tick dispatches all branches that still need work as
ONE ``engine.simulate_segment_sweep`` batch. Branches at different
absolute steps batch fine, since grid signals, weather, the
demand-response window and the failure draws are taken at each row's
own step. Every sum across nodes, groups and halls is exact
(``power.model.sum_exact``), so a batched row is bit for bit the branch
advanced alone: coalescing is throughput, never a change of result.

Checkpoints and history live on the host as numpy copies; only each
branch's live carry stays on the session's device (the card unless
``device="cpu"``). The table, grid signals and weather are moved to the
device once, when the session is built.

Thread-safety: one re-entrant lock around every entry point. The
network server that funnels clients into a session comes with the port
of the scheduler wire.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import engine
from repro_torch.core import types as T
from repro_torch.obs import sink as obs_sink
from repro_torch.serve import snapshot as snap


class SessionError(RuntimeError):
    """A semantically invalid request (unknown branch, bad fork point or
    knob). The session is never corrupted by one."""


@dataclass
class Branch:
    """One trajectory in the fork tree."""
    branch_id: int
    parent: Optional[int]          # parent branch id (None for the root)
    scenario: T.Scenario           # knobs this branch simulates under
    delta: dict                    # sparse knob delta vs the parent
    carry: T.SimState              # live carry at ``step``, on the device
    step: int                      # absolute engine step of ``carry``
    born_step: int                 # fork point (0 for the root)
    # carry at every interval boundary visited since birth (the birth
    # checkpoint included): each is a legal fork or snapshot point. Host
    # numpy copies, shared with forks and never written to
    checkpoints: Dict[int, T.SimState] = field(default_factory=dict)
    # StepRecord history per advanced segment (host numpy, in step order)
    history: List[T.StepRecord] = field(default_factory=list)

    def __post_init__(self):
        if self.step not in self.checkpoints:
            self.checkpoints[self.step] = _to_host(self.carry)


class TwinSession:
    """A persistent simulation session: one system, a tree of branches."""

    def __init__(self, system, table, scen: T.Scenario, t0: float,
                 t1: float, interval_steps: int,
                 signals=None, weather=None, num_accounts: int = 64,
                 events=None, device="cuda"):
        if interval_steps < 1:
            raise ValueError(f"interval_steps must be >= 1, got "
                             f"{interval_steps}")
        if weather is not None and weather.batched:
            raise ValueError("a session's branches share one weather trace")
        self.system = system
        self.device = resolve_device(device)
        self.t0 = float(t0)
        self.t1 = float(t1)
        self.interval_steps = int(interval_steps)
        self.horizon_steps = int(round((t1 - t0) / system.dt))
        if self.horizon_steps % self.interval_steps:
            # advances always land on interval boundaries, so a trailing
            # partial interval could never be simulated: refuse it
            # instead of silently stopping short of t1
            raise ValueError(
                f"horizon ({self.horizon_steps} steps) must be a "
                f"multiple of interval_steps ({self.interval_steps}): "
                f"the {self.horizon_steps % self.interval_steps}-step "
                f"tail would be unreachable")
        # on the device once: a segment never copies them again
        self.table = table.to(self.device)
        self.signals = None if signals is None else signals.to(self.device)
        self.weather = None if weather is None else weather.to(self.device)
        # the EventConfig shared by every branch: the failure and DR knobs
        # are per-branch Scenario fields, so a fork injects failures by
        # delta alone, and a session built with events=EventConfig() and
        # zero rates stays nominal
        self.events = events
        self._lock = threading.RLock()
        self.counters = {"advances": 0, "segments": 0, "forks": 0,
                         "snapshots": 0, "fetches": 0, "errors": 0,
                         "coalesced_batches": 0, "batched_branches": 0}
        root_carry = engine.init_state(system, self.table, t0, t1,
                                       num_accounts=num_accounts,
                                       events=events)
        root = Branch(branch_id=0, parent=None, scenario=scen, delta={},
                      carry=root_carry, step=0, born_step=0)
        # the decode template for snapshots of any branch (same (system,
        # table) lineage, so the same leaves)
        self.carry_template = root.checkpoints[0]
        self._next_id = 1
        self.branches: Dict[int, Branch] = {0: root}

    # -- lookup --------------------------------------------------------------
    def _branch(self, branch_id) -> Branch:
        try:
            br = self.branches[int(branch_id)]
        except (KeyError, TypeError, ValueError):
            self.counters["errors"] += 1
            raise SessionError(
                f"unknown branch id {branch_id!r} (known: "
                f"{sorted(self.branches)})") from None
        return br

    def _checkpoint_step(self, br: Branch, at_step) -> int:
        step = br.step if at_step is None else int(at_step)
        if step not in br.checkpoints:
            self.counters["errors"] += 1
            raise SessionError(
                f"branch {br.branch_id} has no checkpoint at step "
                f"{step} (available: {sorted(br.checkpoints)})")
        return step

    # -- advance (the hot path) ----------------------------------------------
    def advance_many(self, requests: Dict[int, int]) -> Dict[int, dict]:
        """Advance several branches, coalescing per interval tick.

        Args:
          requests: branch id -> number of intervals to advance. Branches
            stop at the horizon (advancing a finished branch is a no-op,
            not an error).
        Returns:
          branch id -> {"step", "t", "advanced_steps"} after the advance.
        """
        with self._lock:
            remaining = {self._branch(b).branch_id: int(n)
                         for b, n in requests.items()}
            if any(n < 0 for n in remaining.values()):
                raise SessionError("advance count must be >= 0")
            advanced = {b: 0 for b in remaining}
            while True:
                live = [b for b, n in remaining.items() if n > 0 and
                        self.branches[b].step + self.interval_steps
                        <= self.horizon_steps]
                if not live:
                    break
                self._tick(live)
                for b in live:
                    remaining[b] -= 1
                    advanced[b] += self.interval_steps
            self.counters["advances"] += 1
            return {b: {"step": self.branches[b].step,
                        "t": self.t0 + self.branches[b].step
                        * float(self.system.dt),
                        "advanced_steps": advanced[b]}
                    for b in remaining}

    def _tick(self, branch_ids: List[int]) -> None:
        """One interval for every listed branch: one dispatch in all."""
        n = self.interval_steps
        brs = [self.branches[b] for b in branch_ids]
        if len(brs) == 1:
            carry, hist = engine.simulate_segment(
                self.system, self.table, brs[0].carry, brs[0].scenario, n,
                self.signals, self.weather, self.events, self.device)
            self._commit(brs[0], carry, hist)
        else:
            carries, hists = engine.simulate_segment_sweep(
                self.system, self.table, [b.carry for b in brs],
                [b.scenario for b in brs], n, self.signals, self.weather,
                self.events, self.device)
            self.counters["coalesced_batches"] += 1
            self.counters["batched_branches"] += len(brs)
            for i, br in enumerate(brs):
                # a copy, so that one branch's live carry does not keep
                # the whole batch alive
                self._commit(br, T.tree_map(lambda x: x[i].clone(), carries),
                             T.row(hists, i))
        self.counters["segments"] += len(brs)

    def _commit(self, br: Branch, carry, hist) -> None:
        br.carry = carry
        br.step += self.interval_steps
        br.checkpoints[br.step] = _to_host(carry)
        br.history.append(_to_host(hist))

    # -- fork ----------------------------------------------------------------
    def fork(self, parent_id, delta: Optional[dict] = None,
             at_step: Optional[int] = None) -> Branch:
        """Branch ``parent_id`` at one of its checkpoints.

        Args:
          parent_id: branch to fork from.
          delta: sparse Scenario knob delta (``{}``/None: a neutral fork,
            bit for bit the parent from the fork point on).
          at_step: fork point; an interval checkpoint the parent has
            visited (default: its current step).
        Returns:
          the new ``Branch`` (its id is ``branch_id``).
        """
        with self._lock:
            parent = self._branch(parent_id)
            step = self._checkpoint_step(parent, at_step)
            try:
                scen = snap.apply_scenario_delta(parent.scenario,
                                                 delta or {})
            except snap.SnapshotError as e:
                self.counters["errors"] += 1
                raise SessionError(str(e)) from e
            ck = parent.checkpoints[step]
            child = Branch(branch_id=self._next_id, parent=parent.branch_id,
                           scenario=scen, delta=dict(delta or {}),
                           carry=_to_device(ck, self.device),
                           step=step, born_step=step,
                           checkpoints={step: ck})
            self._next_id += 1
            self.branches[child.branch_id] = child
            self.counters["forks"] += 1
            return child

    # -- snapshot / fetch / state -------------------------------------------
    def snapshot(self, branch_id, at_step: Optional[int] = None,
                 binary: bool = False) -> dict:
        """Encode a branch checkpoint (see ``serve.snapshot``).

        ``binary=True`` gives the raw-array dialect (leaves are host
        ndarrays); the reply then has only the dialect-independent
        ``raw_digest`` (``carry_digest``), not the canonical-JSON
        ``digest``."""
        with self._lock:
            br = self._branch(branch_id)
            step = self._checkpoint_step(br, at_step)
            payload = snap.encode_carry(br.checkpoints[step], binary=binary)
            self.counters["snapshots"] += 1
            out = {"branch": br.branch_id, "step": step,
                   "snapshot": payload,
                   "raw_digest": snap.carry_digest(payload)}
            if not binary:
                out["digest"] = snap.snapshot_digest(payload)
            return out

    def fetch(self, branch_id, start: Optional[int] = None,
              stop: Optional[int] = None, binary: bool = False) -> dict:
        """Scalar telemetry rows of a branch (since its fork point).

        ``start``/``stop`` are absolute step bounds (default: all the
        branch has simulated itself; a child's history starts at its
        ``born_step``, the prefix lives on its ancestors).

        ``binary=True`` returns the same telemetry columnar: one float64
        array per field under ``"cols"`` instead of per-row dicts.
        """
        with self._lock:
            br = self._branch(branch_id)
            lo = br.born_step if start is None else int(start)
            hi = br.step if stop is None else int(stop)
            lo = max(lo, br.born_step)
            hi = min(hi, br.step)
            fields = ["step", "t", *obs_sink.SCALAR_FIELDS]
            rows, cols = [], None
            if br.history and hi > lo:
                cat = {k: np.concatenate(
                    [np.asarray(getattr(h, k), np.float64)
                     for h in br.history])
                    for k in ("t",) + obs_sink.SCALAR_FIELDS}
                a, b = lo - br.born_step, hi - br.born_step
                if binary:
                    cols = {"step": np.arange(lo, hi, dtype=np.int64)}
                    cols.update({k: v[a:b].copy() for k, v in cat.items()})
                else:
                    for i in range(a, b):
                        row = {"step": br.born_step + i}
                        row.update({k: float(v[i])
                                    for k, v in cat.items()})
                        rows.append(row)
            elif binary:
                cols = {"step": np.zeros((0,), np.int64),
                        **{k: np.zeros((0,), np.float64)
                           for k in ("t",) + obs_sink.SCALAR_FIELDS}}
            self.counters["fetches"] += 1
            out = {"branch": br.branch_id, "start": lo, "stop": hi,
                   "fields": fields}
            if binary:
                out["cols"] = cols
            else:
                out["rows"] = rows
            return out

    def describe(self) -> dict:
        """Session and branch-tree summary."""
        with self._lock:
            return {
                "system": self.system.name,
                "n_nodes": int(self.system.n_nodes),
                "dt": float(self.system.dt),
                "t0": self.t0, "t1": self.t1,
                "interval_steps": self.interval_steps,
                "horizon_steps": self.horizon_steps,
                "branches": [
                    {"branch": b.branch_id, "parent": b.parent,
                     "step": b.step, "born_step": b.born_step,
                     "delta": b.delta,
                     "checkpoints": sorted(b.checkpoints)}
                    for b in sorted(self.branches.values(),
                                    key=lambda b: b.branch_id)],
                "counters": dict(self.counters),
            }


def _to_host(obj):
    """A carry or history as host numpy arrays, always copies:
    ``Tensor.cpu()`` on a CPU tensor returns the tensor itself, and a
    checkpoint must never alias a live carry."""
    return T.tree_map(lambda x: x.detach().to("cpu", copy=True).numpy(), obj)


def _to_device(obj, device: torch.device):
    """A host checkpoint back on ``device`` as fresh tensors (the
    byte-exact inverse of ``_to_host``)."""
    return T.tree_map(lambda a: torch.tensor(a, device=device), obj)
