"""Time-varying grid signals for sustainability what-ifs (port of
``repro.grid.signals``).

A ``GridSignals`` bundle holds three per-step arrays sampled at the engine
``dt``: carbon intensity (g CO2 / kWh), electricity price ($ / kWh) and a
facility IT power-cap schedule (W, ``inf`` = uncapped), plus trailing
rolling means of carbon and price, so "is the signal above its recent
average?" is one gather per step.

Signals are precomputed on the host with numpy (bit for bit the JAX
package's arrays for the same arguments and seed) and moved to the
engine's device once. One signal set is shared by every scenario of a
sweep; ``at_step`` gathers it at each scenario's step index (``SimState.step``
is i32[S]), so every ``GridNow`` field is f32[S]. Per-scenario cap levels
are the ``Scenario.cap_scale`` multiplier.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Mapping, NamedTuple

import numpy as np
import torch

from repro_torch.systems.config import GridConfig


@dataclass
class GridSignals:
    """Per-step grid signals. Shapes: f32[T] (T = engine steps)."""
    carbon_gkwh: torch.Tensor   # carbon intensity (g CO2 / kWh)
    price_kwh: torch.Tensor     # electricity price ($ / kWh)
    cap_w: torch.Tensor         # facility IT power cap (W); +inf = uncapped
    carbon_ref: torch.Tensor    # trailing rolling mean of carbon_gkwh
    price_ref: torch.Tensor     # trailing rolling mean of price_kwh

    @property
    def num_steps(self) -> int:
        return self.carbon_gkwh.shape[0]

    def to(self, device) -> "GridSignals":
        return GridSignals(**{f.name: getattr(self, f.name).to(device)
                              for f in dataclasses.fields(self)})

    @staticmethod
    def from_arrays(m: Mapping, device="cpu") -> "GridSignals":
        """Build from the JAX ``GridSignals``' leaves (numpy, by field
        name), as float32."""
        return GridSignals(**{
            f.name: torch.tensor(np.asarray(m[f.name], np.float32),
                                 device=device)
            for f in dataclasses.fields(GridSignals)})


class GridNow(NamedTuple):
    """The signal values active at one engine step, per scenario (f32[S])."""
    carbon: torch.Tensor      # g CO2 / kWh
    carbon_ref: torch.Tensor  # rolling mean
    price: torch.Tensor       # $ / kWh
    price_ref: torch.Tensor   # rolling mean
    cap_w: torch.Tensor       # base cap (W, before Scenario.cap_scale)


def at_step(signals: GridSignals, step: torch.Tensor) -> GridNow:
    """Gather the signal row active at each scenario's ``step`` (clamped
    into range, last observation carried forward like job profiles,
    paper §3.2.2).

    Args:
      signals: per-step arrays sampled at the engine ``dt``, on the
        engine's device.
      step: i32[S] engine step index (``SimState.step``).
    Returns:
      f32[S] carbon (g CO2/kWh), price ($/kWh), their rolling means, and
      the base cap (W, before ``Scenario.cap_scale``).
    """
    i = torch.clamp(step, 0, signals.num_steps - 1).long()
    return GridNow(carbon=signals.carbon_gkwh[i],
                   carbon_ref=signals.carbon_ref[i],
                   price=signals.price_kwh[i],
                   price_ref=signals.price_ref[i],
                   cap_w=signals.cap_w[i])


def now_neutral(n_scen: int, device="cpu") -> GridNow:
    """Signal values that make every grid-aware term a no-op (f32[S])."""
    full = lambda v: torch.full((n_scen,), v, dtype=torch.float32,
                                device=device)
    return GridNow(carbon=full(0.0), carbon_ref=full(1.0), price=full(0.0),
                   price_ref=full(1.0), cap_w=full(float("inf")))


def _rolling_mean(x: np.ndarray, window: int) -> np.ndarray:
    """Trailing mean over the last ``window`` samples (partial at the start)."""
    w = max(int(window), 1)
    c = np.concatenate([[0.0], np.cumsum(x, dtype=np.float64)])
    i = np.arange(1, len(x) + 1)
    lo = np.maximum(i - w, 0)
    return ((c[i] - c[lo]) / (i - lo)).astype(np.float32)


def _f32(x) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x, np.float32))


def constant_signals(n_steps: int, carbon_gkwh: float = 0.0,
                     price_kwh: float = 0.0,
                     cap_w: float = float("inf")) -> GridSignals:
    """Flat signals; refs equal the signal so the deferral excess is zero.

    Args:
      n_steps: number of engine steps to cover.
      carbon_gkwh: constant carbon intensity (g CO2 / kWh).
      price_kwh: constant electricity price ($ / kWh).
      cap_w: constant facility IT power cap (W); ``inf`` = uncapped.
    """
    full = lambda v: torch.full((max(n_steps, 1),), v, dtype=torch.float32)
    return GridSignals(carbon_gkwh=full(carbon_gkwh),
                       price_kwh=full(price_kwh), cap_w=full(cap_w),
                       carbon_ref=full(max(carbon_gkwh, 1.0)),
                       price_ref=full(max(price_kwh, 1e-6)))


def neutral(n_steps: int) -> GridSignals:
    """Default signals: zero carbon/price, uncapped: the grid layer inert."""
    return constant_signals(n_steps)


def synthetic_signals(cfg: GridConfig, n_steps: int, dt: float,
                      t0: float = 0.0, cap_base_w: float = float("inf"),
                      cap_peak_w: float | None = None,
                      seed: int = 0) -> GridSignals:
    """Diurnal + AR(1)-noise generators for carbon, price and the cap.

    Carbon troughs at midnight and peaks mid-afternoon (fossil marginal
    mix); price peaks in the evening window ``cfg.peak_hours``, during
    which the cap schedule drops from ``cap_base_w`` to ``cap_peak_w``
    (when given): the "cap the machine during the price peak" what-if.
    ``t0`` (s) places step 0 on the signal clock.
    """
    rng = np.random.default_rng(seed)
    t = t0 + dt * np.arange(n_steps, dtype=np.float64)
    hours = (t / 3600.0) % 24.0
    day = 2 * np.pi * t / 86400.0

    def ar1_noise(frac):
        e = rng.normal(0.0, frac, n_steps)
        out = np.empty(n_steps)
        acc = 0.0
        rho = 0.95
        for i in range(n_steps):
            acc = rho * acc + np.sqrt(1 - rho * rho) * e[i]
            out[i] = acc
        return out

    carbon = cfg.carbon_mean_gkwh + cfg.carbon_amp_gkwh * np.sin(
        day - np.pi / 2)
    carbon = np.maximum(carbon * (1.0 + ar1_noise(cfg.noise_frac)), 1.0)

    peak_lo, peak_hi = cfg.peak_hours
    evening = np.exp(-0.5 * ((hours - (peak_lo + peak_hi) / 2) / 2.0) ** 2)
    price = cfg.price_mean_kwh + cfg.price_amp_kwh * (
        0.6 * np.sin(day - np.pi / 2) + 1.4 * evening)
    price = np.maximum(price * (1.0 + ar1_noise(cfg.noise_frac)), 1e-4)

    cap = np.full(n_steps, cap_base_w, np.float64)
    if cap_peak_w is not None:
        in_peak = (hours >= peak_lo) & (hours < peak_hi)
        cap = np.where(in_peak, cap_peak_w, cap)

    w = int(round(cfg.ref_window_s / dt))
    return GridSignals(
        carbon_gkwh=_f32(carbon), price_kwh=_f32(price), cap_w=_f32(cap),
        carbon_ref=_f32(_rolling_mean(carbon, w)),
        price_ref=_f32(_rolling_mean(price, w)))
