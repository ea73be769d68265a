"""Weather traces for cooling what-ifs: per-step ambient conditions (port
of ``repro.cooling.weather``).

The cooling plant (``repro_torch.cooling.model``) is driven by the
ambient wet-bulb temperature, the floor an evaporative tower can cool
against. Like the grid signals, weather is precomputed on the host into
per-step arrays sampled at the engine ``dt`` (numpy, bit for bit the JAX
package's arrays for the same arguments and seed), moved to the engine's
device once, and gathered at each scenario's step (clamped: the last row
carries forward).

A trace is f32[T] (site-wide) or f32[T, H] (one trace per hall,
``stack_halls``). One trace is shared by every scenario of a sweep; a
sweep over weather scenarios stacks one trace per scenario on a leading
S axis (``stack_weather``, which marks the set ``batched``), and
``at_step`` then gathers each row at its own scenario's step.

Units: all temperatures are °C; times are seconds.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import NamedTuple, Sequence

import numpy as np
import torch


@dataclass
class WeatherSignals:
    """Per-step ambient conditions: f32[T] or f32[T, H], with a leading
    scenario axis S when ``batched`` (``stack_weather``)."""
    t_wetbulb_c: torch.Tensor   # ambient wet-bulb temperature (°C)
    t_drybulb_c: torch.Tensor   # ambient dry-bulb temperature (°C)
    batched: bool = False       # leading axis is the scenario axis S

    @property
    def num_steps(self) -> int:
        return self.t_wetbulb_c.shape[1 if self.batched else 0]

    def to(self, device) -> "WeatherSignals":
        return dataclasses.replace(self,
                                   t_wetbulb_c=self.t_wetbulb_c.to(device),
                                   t_drybulb_c=self.t_drybulb_c.to(device))


class WeatherNow(NamedTuple):
    """The ambient conditions at one engine step, per scenario: f32[S]
    for a site-wide trace, f32[S, H] for per-hall traces."""
    t_wetbulb_c: torch.Tensor   # °C
    t_drybulb_c: torch.Tensor   # °C


def at_step(weather: WeatherSignals, step: torch.Tensor) -> WeatherNow:
    """Gather the weather row active at each scenario's ``step`` (i32[S],
    ``SimState.step``), the index clamped into range (last observation
    carried forward, paper §3.2.2)."""
    i = torch.clamp(step, 0, weather.num_steps - 1).long()
    if weather.batched:
        rows = torch.arange(i.shape[0], device=i.device)
        pick = lambda x: x[rows, i]
    else:
        pick = lambda x: x[i]
    return WeatherNow(t_wetbulb_c=pick(weather.t_wetbulb_c),
                      t_drybulb_c=pick(weather.t_drybulb_c))


def _f32(x) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x, np.float32))


def constant_weather(n_steps: int, t_wetbulb_c: float,
                     t_drybulb_c: float | None = None) -> WeatherSignals:
    """Flat ambient conditions. ``t_drybulb_c`` defaults to wet-bulb +
    8 °C depression."""
    if t_drybulb_c is None:
        t_drybulb_c = t_wetbulb_c + 8.0
    full = lambda v: torch.full((max(n_steps, 1),), v, dtype=torch.float32)
    return WeatherSignals(t_wetbulb_c=full(t_wetbulb_c),
                          t_drybulb_c=full(t_drybulb_c))


def from_arrays(t_wetbulb_c: np.ndarray,
                t_drybulb_c: np.ndarray | None = None) -> WeatherSignals:
    """Wrap measured per-step temperature arrays (°C) sampled at the
    engine ``dt``. Dry-bulb defaults to wet-bulb + 8 °C."""
    wb = np.asarray(t_wetbulb_c, np.float32)
    db = (wb + 8.0 if t_drybulb_c is None
          else np.asarray(t_drybulb_c, np.float32))
    if db.shape != wb.shape:
        raise ValueError(f"shape mismatch: {wb.shape} vs {db.shape}")
    return WeatherSignals(t_wetbulb_c=_f32(wb), t_drybulb_c=_f32(db))


def synthetic_weather(n_steps: int, dt: float, t0: float = 0.0,
                      t_wb_mean_c: float = 18.0,
                      diurnal_amp_c: float = 4.0,
                      seasonal_amp_c: float = 6.0,
                      day_of_year: float = 172.0,
                      depression_c: float = 8.0,
                      noise_c: float = 0.5,
                      seed: int = 0) -> WeatherSignals:
    """Synthetic diurnal + seasonal wet-bulb/dry-bulb generator.

    Wet-bulb = annual mean + seasonal sinusoid (peaking at midsummer;
    ``day_of_year`` places the window in the year) + diurnal sinusoid
    (trough ~05:00, peak ~15:00) + AR(1) noise of deviation ``noise_c``
    from ``np.random.default_rng(seed)``. Dry-bulb adds a depression of
    ``depression_c`` that widens in the afternoon. Formed in float64 and
    cast to float32 once. ``t0`` (s) sets the diurnal phase.
    """
    rng = np.random.default_rng(seed)
    t = t0 + dt * np.arange(n_steps, dtype=np.float64)
    day = 2 * np.pi * t / 86400.0
    season = 2 * np.pi * (day_of_year + t / 86400.0) / 365.0

    e = rng.normal(0.0, noise_c, n_steps)
    noise = np.empty(n_steps)
    acc, rho = 0.0, 0.995
    for i in range(n_steps):
        acc = rho * acc + np.sqrt(1 - rho * rho) * e[i]
        noise[i] = acc

    diurnal = np.sin(day - 2 * np.pi * 10.0 / 24.0)
    seasonal = np.cos(season - 2 * np.pi * 172.0 / 365.0)
    wb = t_wb_mean_c + seasonal_amp_c * seasonal + diurnal_amp_c * diurnal \
        + noise
    db = wb + depression_c * (1.0 + 0.35 * diurnal)
    return WeatherSignals(t_wetbulb_c=_f32(wb), t_drybulb_c=_f32(db))


def heat_wave(base: WeatherSignals, dt: float, start_s: float,
              duration_s: float, peak_amp_c: float = 8.0) -> WeatherSignals:
    """Add a heat wave to a site-wide trace: a plateau of ``peak_amp_c``
    °C on wet-bulb and dry-bulb from ``start_s`` for ``duration_s``, with
    cosine ramps over its first and last 20 %."""
    n = base.num_steps
    t = dt * np.arange(n, dtype=np.float64)
    x = (t - start_s) / max(duration_s, 1.0)
    ramp = 0.2
    up = 0.5 * (1 - np.cos(np.pi * np.clip(x / ramp, 0.0, 1.0)))
    down = 0.5 * (1 - np.cos(np.pi * np.clip((1.0 - x) / ramp, 0.0, 1.0)))
    bump = _f32(np.where((x >= 0.0) & (x <= 1.0),
                         peak_amp_c * np.minimum(up, down), 0.0))
    bump = bump.to(base.t_wetbulb_c.device)
    return WeatherSignals(t_wetbulb_c=base.t_wetbulb_c + bump,
                          t_drybulb_c=base.t_drybulb_c + bump)


def stack_weather(traces: Sequence[WeatherSignals]) -> WeatherSignals:
    """One trace per scenario, stacked on a leading S axis."""
    return WeatherSignals(
        t_wetbulb_c=torch.stack([w.t_wetbulb_c for w in traces]),
        t_drybulb_c=torch.stack([w.t_drybulb_c for w in traces]),
        batched=True)


def stack_halls(traces: Sequence[WeatherSignals]) -> WeatherSignals:
    """One trace per hall, stacked on a trailing axis: f32[T] ->
    f32[T, H]; each hall's tower then sees its own wet-bulb. Build each
    scenario's per-hall set first, then ``stack_weather`` them."""
    return WeatherSignals(
        t_wetbulb_c=torch.stack([w.t_wetbulb_c for w in traces], -1),
        t_drybulb_c=torch.stack([w.t_drybulb_c for w in traces], -1))
