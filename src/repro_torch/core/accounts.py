"""Systems accounting (paper §3.2.6), port of ``repro.core.accounts``:
per-account ledgers folded in as jobs complete, feeding the incentive
policies (paper §4.3) and fairness metrics.

The folds are segment sums over the job axis keyed by account id. The
``acct_*`` policy keys read these sums, so they must not depend on run
order: ``index_add_``/``scatter_add_`` on CUDA add in atomic order, which
changes between runs. Here the reduction is sort-based: the jobs are
grouped by account once per table (a padded [A, M] index of each
account's jobs), the values are gathered into that layout and summed in
float64 along M, then rounded to float32. The result is the same on
every run and for every batch size, and within float32 rounding of the
reference's ``segment_sum``.

A ledger shorter than the backlog's account ids behaves as the
reference's: the folds drop the jobs of ids past its end (as
``segment_sum`` drops out-of-range segments), and the policy keys read
its last entry for them (as JAX clamps an out-of-range gather).

Ledgers persist as the reference's JSON (``save_json``/``load_json``:
one list of floats a field), so a ledger collected by either package
warm-starts the other's run (the paper's ``--accounts`` /
``--accounts-json``: collect in one run, redeem in the next).
"""
from __future__ import annotations

import dataclasses
import functools
import json

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.incentives import fugaku_points
from repro_torch.core.types import AccountStats, JobTable
from repro_torch.systems.config import SystemConfig


@functools.lru_cache(maxsize=16)
def _account_index(account: torch.Tensor, num_accounts: int) -> torch.Tensor:
    """i64[A, M]: the job ids of each account, padded with J (a zero
    column appended to the values). Cached per account tensor (the cache
    keeps it alive, so its identity cannot be reused): the table is
    read-only for the whole run, and a step never goes back to the host."""
    acct = account.cpu().numpy()
    J = acct.shape[0]
    order = np.argsort(acct, kind="stable")
    counts = np.bincount(acct, minlength=num_accounts)[:num_accounts]
    M = max(int(counts.max(initial=0)), 1)
    idx = np.full((num_accounts, M), J, np.int64)
    first = np.concatenate([[0], np.cumsum(counts)[:-1]])
    for a in range(num_accounts):
        idx[a, :counts[a]] = order[first[a]:first[a] + counts[a]]
    return torch.from_numpy(idx).to(account.device)


def segment_sum(values: torch.Tensor, account: torch.Tensor,
                num_accounts: int) -> torch.Tensor:
    """f32[..., J] -> f32[..., A]: per-account sums, deterministic."""
    idx = _account_index(account, num_accounts)
    padded = torch.cat([values, torch.zeros_like(values[..., :1])], -1)
    return padded[..., idx].sum(-1, dtype=torch.float64).to(torch.float32)


def fold_completions(system: SystemConfig, table: JobTable,
                     accounts: AccountStats, done_now: torch.Tensor,
                     start: torch.Tensor, end: torch.Tensor,
                     jenergy: torch.Tensor) -> AccountStats:
    """Accumulate statistics of jobs that completed this step.

    Args:
      done_now: bool[S, J] jobs finishing at this engine step.
      start, end: f32[S, J] realized start/end times (s).
      jenergy: f32[S, J] accumulated per-job IT energy (J).
    Returns:
      Updated [S, A] ledgers: node-hours, energy (J), EDP (J·s), ED²P
      (J·s²), wait/turnaround sums (s), average per-node power (W),
      Fugaku points. The carbon/cost columns accrue per step
      (``accrue_grid``).
    """
    A = accounts.energy.shape[-1]
    nodes_f = table.nodes.to(torch.float32)
    wall = torch.clamp(end - start, min=1.0)
    wait = torch.clamp(start - table.submit, min=0.0)
    turn = torch.clamp(end - table.submit, min=0.0)
    node_hours = nodes_f * wall / 3600.0
    # average per-node power over the job's life
    avg_pnode = jenergy / torch.clamp(nodes_f * wall, min=1.0)
    pts = fugaku_points(system, node_hours, avg_pnode)
    vals = torch.stack([torch.ones_like(jenergy), node_hours, jenergy,
                        jenergy * turn, jenergy * turn * turn, wait, turn,
                        avg_pnode, pts])
    # a select, not a multiply by the mask: jobs that never ran have
    # inf - inf = nan terms, which the reference's compiled ``vals * mask``
    # also drops (XLA rewrites it to a select)
    sums = segment_sum(torch.where(done_now, vals, 0.0), table.account, A)
    return AccountStats(
        jobs_done=accounts.jobs_done + sums[0],
        node_hours=accounts.node_hours + sums[1],
        energy=accounts.energy + sums[2],
        edp=accounts.edp + sums[3],
        ed2p=accounts.ed2p + sums[4],
        wait_sum=accounts.wait_sum + sums[5],
        turnaround_sum=accounts.turnaround_sum + sums[6],
        power_sum=accounts.power_sum + sums[7],
        fugaku_pts=accounts.fugaku_pts + sums[8],
        carbon_kg=accounts.carbon_kg,
        cost=accounts.cost,
    )


def accrue_grid(table: JobTable, accounts: AccountStats,
                job_energy_step: torch.Tensor, carbon_gkwh: torch.Tensor,
                price_kwh: torch.Tensor) -> AccountStats:
    """Per-step grid accrual: attribute each job's IT energy this step to
    its account at the current carbon intensity and price, so accounts
    that shift load into clean or cheap windows accumulate less.

    Args:
      job_energy_step: f32[S, J] IT energy each job consumed this step (J).
      carbon_gkwh: f32[S] carbon intensity now (g CO2 / kWh).
      price_kwh: f32[S] electricity price now ($ / kWh).
    Returns:
      [S, A] ledgers with ``carbon_kg`` (kg CO2) and ``cost`` ($) advanced.
    """
    A = accounts.energy.shape[-1]
    kwh = segment_sum(job_energy_step, table.account, A) / 3.6e6
    return dataclasses.replace(
        accounts,
        carbon_kg=accounts.carbon_kg + kwh * carbon_gkwh[:, None] * 1e-3,
        cost=accounts.cost + kwh * price_kwh[:, None])


# --- persistence (the paper's "--accounts / --accounts-json": collect in one
# run, redeem in the next) ---------------------------------------------------
def to_json_dict(accounts: AccountStats) -> dict:
    """One [A] ledger as {field: list of floats}, the reference's JSON."""
    return {f.name: getattr(accounts, f.name).detach().cpu().numpy().tolist()
            for f in dataclasses.fields(AccountStats)}


def from_json_dict(d: dict, device="cuda") -> AccountStats:
    """An [A] float32 ledger on ``device``; the fields of a ledger saved
    before the grid fields existed (``carbon_kg``, ``cost``) are zeros."""
    dev = resolve_device(device)
    n = len(next(iter(d.values())))
    zeros = [0.0] * n
    return AccountStats(**{
        f.name: torch.tensor(d.get(f.name, zeros), dtype=torch.float32,
                             device=dev)
        for f in dataclasses.fields(AccountStats)})


def save_json(accounts: AccountStats, path) -> None:
    with open(path, "w") as f:
        json.dump(to_json_dict(accounts), f)


def load_json(path, device="cuda") -> AccountStats:
    with open(path) as f:
        return from_json_dict(json.load(f), device)
