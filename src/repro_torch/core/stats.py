"""Run-level statistics (paper §3.2.6), port of ``repro.core.stats``:
scheduler metrics, fairness / packing-efficiency metrics (AWRT,
priority-weighted specific response time after Goponenko et al. [21]),
job-size histogram, and energy summaries. Computed on the host in numpy
from one scenario's final state and history.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.core import types as T
from repro_torch.systems.config import SystemConfig

# job-size classes by node count (paper: "histogram of job size scheduled
# (small, medium, large, by node count)")
SIZE_EDGES = (1, 8, 128)  # small <8, medium <128, large >=128


def _np(x: torch.Tensor, dtype=None) -> np.ndarray:
    """Host numpy copy of a tensor (one scenario's row)."""
    return np.asarray(x.detach().cpu().numpy(), dtype)


def summarize(system: SystemConfig, table: T.JobTable, final: T.SimState,
              hist: T.StepRecord) -> Dict[str, float]:
    """Reduce a run to its scalar summary metrics (paper §3.2.6).

    Args:
      system: the machine the run simulated (for dt / node counts).
      table: the job table the run consumed.
      final: one scenario's final engine state (accumulators in J, kg, $).
      hist: its per-step telemetry (powers in W, temperatures in °C).
    Returns:
      Flat dict of floats — scheduler metrics (s), energy (MWh), power
      (MW), PUE, emissions (kg), cost ($), cooling-loop telemetry
      (°C / MWh), and with the event layer the ride-through scores (jobs
      killed and requeued, energy not served in MWh, node downtime in h,
      recovery time in s).
    """
    done = _np(final.jstate == T.DONE)
    start = _np(final.start)
    end = _np(final.end)
    # float32 whatever the column's type: an int32 (compact) column would
    # promote the wait and turnaround to float64 in numpy, and a compact
    # run's summary then differ from the float32 run's
    submit = _np(table.submit, np.float32)
    nodes = _np(table.nodes).astype(np.float64)
    prio = _np(table.priority).astype(np.float64)
    jenergy = _np(final.jenergy).astype(np.float64)

    done = done & np.isfinite(start) & np.isfinite(end)
    startz = np.where(done, start, 0.0)
    endz = np.where(done, end, 0.0)
    wall = np.where(done, endz - startz, 0.0)
    wait = np.where(done, np.maximum(startz - submit, 0.0), 0.0)
    turn = np.where(done, np.maximum(endz - submit, 0.0), 0.0)
    nh = nodes * wall / 3600.0
    n_done = max(int(done.sum()), 1)

    area = nh.sum() or 1.0
    awrt = float((turn * nh).sum() / area)
    pw = prio * nh
    psrt = float((turn * pw).sum() / (pw.sum() or 1.0))

    edp = float((jenergy * turn)[done].sum())
    ed2p = float((jenergy * turn * turn)[done].sum())

    sizes = nodes[done]
    hist_small = int((sizes < SIZE_EDGES[1]).sum())
    hist_medium = int(((sizes >= SIZE_EDGES[1]) & (sizes < SIZE_EDGES[2])).sum())
    hist_large = int((sizes >= SIZE_EDGES[2]).sum())

    p = _np(hist.power_total, np.float64)
    it = _np(hist.power_it, np.float64)
    sim_seconds = float(p.shape[-1] * system.dt)
    out = {
        "jobs_completed": float(done.sum()),
        "throughput_per_hour": float(done.sum()) / (sim_seconds / 3600.0),
        "avg_wait_s": float(wait[done].mean()) if done.any() else 0.0,
        "avg_turnaround_s": float(turn[done].mean()) if done.any() else 0.0,
        "awrt_s": awrt,
        "psrt_s": psrt,
        "avg_job_nodes": float(sizes.mean()) if done.any() else 0.0,
        "avg_job_energy_j": float(jenergy[done].mean()) if done.any() else 0.0,
        "avg_job_power_w": float((jenergy[done] / np.maximum(wall[done], 1.0)).mean()) if done.any() else 0.0,
        "edp": edp / max(n_done, 1),
        "ed2p": ed2p / max(n_done, 1),
        "hist_small": hist_small,
        "hist_medium": hist_medium,
        "hist_large": hist_large,
        "avg_system_power_mw": float(p.mean() / 1e6),
        "avg_it_power_mw": float(it.mean() / 1e6),
        "avg_util": float(_np(hist.util, np.float64).mean()),
        "max_power_mw": float(p.max() / 1e6),
        "power_swing_mw": float((p.max() - p.min()) / 1e6),
        "avg_pue": float(_np(hist.pue, np.float64).mean()),
        "total_energy_mwh": float(_np(final.energy_total) / 3.6e9),
        "loss_energy_mwh": float(_np(final.energy_loss) / 3.6e9),
        "power_efficiency": float(_np(final.energy_it) /
                                  max(float(_np(final.energy_total)), 1.0)),
        "carbon_kg_est": float(_np(final.energy_total) / 3.6e9 * 370.0),
        # grid-aware accounting (signal-weighted; zero under neutral signals)
        "emissions_kg": float(_np(final.emissions_kg)),
        "energy_cost_usd": float(_np(final.energy_cost)),
        "avg_throttle_frac": float(
            _np(hist.throttle_frac, np.float64).mean()),
        "throttled_steps": float(
            (_np(hist.throttle_frac, np.float64) > 1e-6).sum()),
        # cooling-loop telemetry: tower temps in °C,
        # parasitic/exported energies in MWh
        "t_tower_return_avg_c": float(
            _np(hist.t_tower_return, np.float64).mean()),
        "t_tower_return_max_c": float(
            _np(hist.t_tower_return, np.float64).max()),
        "t_supply_max_c": float(
            _np(hist.t_supply_max, np.float64).max()),
        "t_basin_max_c": float(_np(hist.t_basin, np.float64).max()),
        "avg_wetbulb_c": float(_np(hist.t_wetbulb, np.float64).mean()),
        "cooling_energy_mwh": float(_np(final.energy_cooling) / 3.6e9),
        "fan_energy_mwh": float(
            _np(hist.power_fan, np.float64).sum() * system.dt / 3.6e9),
        "pump_energy_mwh": float(
            _np(hist.power_pump, np.float64).sum() * system.dt / 3.6e9),
        "heat_reuse_mwh": float(_np(final.heat_reuse_j) / 3.6e9),
        "thermal_throttled_steps": float(
            (_np(hist.thermal_throttled, np.float64) > 0.5).sum()),
    }
    # ride-through scoring, when the event layer ran
    ev = final.events
    if ev is not None:
        out["ride_jobs_killed"] = float(_np(ev.jobs_killed))
        out["ride_jobs_requeued"] = float(_np(ev.jobs_requeued))
        out["ride_energy_unserved_mwh"] = float(_np(ev.energy_lost_j) / 3.6e9)
        out["ride_node_downtime_h"] = float(_np(ev.node_downtime_s) / 3600.0)
        # recovery time: from the last step with nodes down to the first
        # later step where the queue has drained back to its depth when
        # the first failure hit (cut at the horizon; 0 = no failures)
        nd = _np(hist.nodes_down, np.float64)
        nq = _np(hist.n_queued, np.float64)
        downs = np.nonzero(nd > 0.0)[0]
        if downs.size == 0:
            out["ride_recovery_s"] = 0.0
        else:
            first, last = int(downs[0]), int(downs[-1])
            later = np.nonzero(nq[last:] <= nq[first])[0]
            rec = int(later[0]) if later.size else nd.shape[-1] - last
            out["ride_recovery_s"] = float(rec * system.dt)
    # per-hall rows (FacilityTopology): IT-load share, basin peak, cells.
    # A flat plant contributes one hall with share 1.0.
    p_hall = _np(hist.power_it_hall, np.float64)
    tb_hall = _np(hist.t_basin_hall, np.float64)
    cells = _np(hist.cells_online, np.float64)
    total = max(p_hall.sum(), 1.0)
    oh_hall = hist.overheat_hall
    for h in range(p_hall.shape[-1]):
        out[f"hall{h}_it_share"] = float(p_hall[..., h].sum() / total)
        out[f"hall{h}_basin_max_c"] = float(tb_hall[..., h].max())
        out[f"hall{h}_cells_online_min"] = float(cells[..., h].min())
        # per-hall overheat exposure: seconds the hall spent with its
        # supply setpoint lost
        out[f"hall{h}_overheat_s"] = float(
            (_np(oh_hall, np.float64)[..., h] > 0.5).sum() * system.dt)
    return out


def format_stats(stats: Dict[str, float]) -> str:
    return "\n".join(f"{k:>24s} : {v:,.3f}" for k, v in stats.items())
