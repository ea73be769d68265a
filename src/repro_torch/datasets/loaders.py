"""Per-system synthetic dataloaders (paper §2.2 / Table 1, CLI ``--system``).

The port's copy of the synthetic loaders of ``repro.datasets.loaders``:
the same arguments give the same ``JobSet`` in both packages. PM100 and
Frontier carry per-job power *traces* (20 s / 15 s); F-Data, LAST and
Cirou's Adastra set carry scalar summaries only (trace_len == 1). Real
trace ingestion belongs to a later slice of the port.
"""
from __future__ import annotations

from repro_torch.datasets.base import JobSet
from repro_torch.datasets.synthetic import WorkloadSpec, generate
from repro_torch.systems.config import get_system

DAY = 86400.0


def load_frontier(n_jobs: int = 1238, days: float = 1.0, seed: int = 1,
                  full_system_jobs: int = 3) -> JobSet:
    """Frontier excerpt: 15 s traces, priority FIFO boosted by node count,
    includes the Fig. 6 pattern of full-system (9,600-node) runs."""
    sys = get_system("frontier")
    spec = WorkloadSpec(n_jobs=n_jobs, duration_s=days * DAY, load=0.92,
                        n_accounts=48, mean_wall_s=5400.0,
                        max_frac_nodes=0.30,
                        full_system_jobs=full_system_jobs,
                        trace_len=96, seed=seed)
    return generate(sys, spec)


def load_marconi100(n_jobs: int = 2000, days: float = 1.0,
                    seed: int = 2) -> JobSet:
    """PM100: 20 s traces; shared-node jobs are filtered upstream (paper),
    so utilization does not reflect full production load; queues fill."""
    sys = get_system("marconi100")
    spec = WorkloadSpec(n_jobs=n_jobs, duration_s=days * DAY, load=1.15,
                        n_accounts=32, mean_wall_s=2700.0,
                        max_frac_nodes=0.20, trace_len=64, seed=seed)
    return generate(sys, spec)


def load_fugaku(n_jobs: int = 4000, days: float = 1.0, seed: int = 3,
                load: float = 0.75) -> JobSet:
    """F-Data: job summaries, node-level power only (scalar profiles)."""
    sys = get_system("fugaku")
    spec = WorkloadSpec(n_jobs=n_jobs, duration_s=days * DAY, load=load,
                        n_accounts=64, mean_wall_s=4500.0,
                        max_frac_nodes=0.10, trace_len=1, seed=seed)
    return generate(sys, spec)


def load_lassen(n_jobs: int = 3000, days: float = 1.0, seed: int = 4) -> JobSet:
    """LAST: job summaries with accumulated energy (scalar profiles)."""
    sys = get_system("lassen")
    spec = WorkloadSpec(n_jobs=n_jobs, duration_s=days * DAY, load=0.8,
                        n_accounts=40, mean_wall_s=7200.0,
                        max_frac_nodes=0.25, trace_len=1, seed=seed)
    return generate(sys, spec)


def load_adastra(n_jobs: int = 1000, days: float = 15.0, seed: int = 5) -> JobSet:
    """Cirou's 15-day Adastra set: scalar component power, *low* system load
    (paper Fig. 5: queues do not fill; policy choice makes little difference)."""
    sys = get_system("adastraMI250")
    spec = WorkloadSpec(n_jobs=n_jobs, duration_s=days * DAY, load=0.55,
                        n_accounts=24, mean_wall_s=10800.0,
                        max_frac_nodes=0.35, trace_len=1, seed=seed)
    return generate(sys, spec)


LOADERS = {
    "frontier": load_frontier,
    "marconi100": load_marconi100,
    "marconi": load_marconi100,
    "fugaku": load_fugaku,
    "lassen": load_lassen,
    "adastraMI250": load_adastra,
    "adastra": load_adastra,
}


def load(system_name: str, **kw) -> JobSet:
    """Dispatch to the per-system loader (CLI ``--system``); ``kw`` is
    forwarded (commonly ``n_jobs``, ``days``, ``seed``)."""
    return LOADERS[system_name](**kw)
