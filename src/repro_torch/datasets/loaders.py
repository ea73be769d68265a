"""Per-system synthetic dataloaders (paper §2.2 / Table 1, CLI ``--system``).

The port's copy of ``repro.datasets.loaders``: the same arguments give
the same ``JobSet`` in both packages. PM100 and Frontier carry per-job
power *traces* (20 s / 15 s); F-Data, LAST and Cirou's Adastra set carry
scalar summaries only (trace_len == 1). ``load_trace`` ingests a real
trace (``repro_torch.traces``) behind the same interface.
"""
from __future__ import annotations

import pathlib

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


def load_trace(paths, prof_dt: float = 20.0,
               cache_dir: str | None = None) -> JobSet:
    """Ingest a *real* trace (CLI ``--trace``) behind the same ``JobSet``
    interface the synthetic loaders produce (repro_torch.traces).

    ``paths`` is one or two paths, RAPS-style:
      - ``[job_table.parquet|.csv]`` — a published job table (PM100
        column mapping by default; needs pandas);
      - ``[trace.npz]`` — a previously cached parse (fast restart; numpy
        only);
      - ``[joblive_dir]`` or ``[joblive_dir, jobprofile_dir]`` — raw
        scheduler + power telemetry dumps; with a jobprofile the jobs
        carry measured power for ``to_table(replay_power=True)``.
    """
    from repro_torch import traces
    if not 1 <= len(paths) <= 2:
        raise traces.TraceError(f"--trace wants 1 or 2 paths, got "
                                f"{len(paths)}")
    first = pathlib.Path(paths[0])
    if len(paths) == 2:
        return traces.load_telemetry(first, paths[1], prof_dt=prof_dt,
                                     cache_dir=cache_dir)
    if first.suffix in (".parquet", ".csv") and first.is_file():
        return traces.read_job_table(first)
    if first.suffix == ".npz":
        return traces.jobset_from_npz(first)
    if first.is_dir():
        return traces.load_telemetry(first, None, prof_dt=prof_dt,
                                     cache_dir=cache_dir)
    raise traces.TraceError(f"cannot ingest trace {first}: want a "
                            f".parquet/.csv job table, a cached .npz, or "
                            f"a joblive directory")
