"""Measured weather traces -> per-step ``WeatherSignals`` (the port's copy
of ``repro.traces.weather``; an NPZ trace needs only numpy, a CSV one
pandas).

Meteorological records (hourly METAR/ERA5-style rows) arrive as a CSV
(``timestamp, t_drybulb_c, rh_pct`` — or a ready ``t_wetbulb_c`` column)
or an NPZ with the same keys. ``load_weather`` validates them, derives
wet-bulb from dry-bulb + relative humidity where needed (Stull 2011),
linearly resamples onto the engine's step grid (``t0 + k*dt``, clamped
at the record's edges — the LOCF convention every other per-step signal
uses at its boundaries) and hands the arrays to
``cooling.weather.from_arrays``.

Validation: timestamps must be strictly increasing, temperatures and
humidities finite, RH inside [0, 100]; the derived wet-bulb is checked
finite and never above dry-bulb. Violations raise ``TraceError``.
"""
from __future__ import annotations

import pathlib

import numpy as np

from repro_torch.cooling import weather as W
from repro_torch.traces.errors import TraceError
from repro_torch.traces.jobtable import _seconds


def wet_bulb_stull(t_drybulb_c: np.ndarray,
                   rh_pct: np.ndarray) -> np.ndarray:
    """Wet-bulb temperature from dry-bulb (°C) and relative humidity (%)
    via Stull's (2011) empirical fit — accurate to ~0.3 °C over the
    meteorological range, which is ample for a cooling-tower floor."""
    t = np.asarray(t_drybulb_c, np.float64)
    rh = np.asarray(rh_pct, np.float64)
    wb = (t * np.arctan(0.151977 * np.sqrt(rh + 8.313659))
          + np.arctan(t + rh) - np.arctan(rh - 1.676331)
          + 0.00391838 * rh ** 1.5 * np.arctan(0.023101 * rh)
          - 4.686035)
    # the fit can overshoot dry-bulb by a hair at saturation; clamp so the
    # physical invariant (wet-bulb <= dry-bulb) holds exactly
    return np.minimum(wb, t)


def _read_columns(path: pathlib.Path) -> dict[str, np.ndarray]:
    if path.suffix == ".npz":
        try:
            z = np.load(path, allow_pickle=False)
        except Exception as e:
            raise TraceError(f"cannot read weather NPZ {path}: {e}") from e
        return {k: z[k] for k in z.files}
    if path.suffix == ".csv":
        import pandas as pd
        try:
            df = pd.read_csv(path)
        except Exception as e:
            raise TraceError(f"cannot read weather CSV {path}: {e}") from e
        return {k: df[k].to_numpy() for k in df.columns}
    raise TraceError(f"unsupported weather format {path.suffix!r} "
                     f"(want .csv or .npz)")


def load_weather(path: str | pathlib.Path, n_steps: int, dt: float,
                 t0: float = 0.0,
                 origin_s: float | None = None) -> W.WeatherSignals:
    """Load a measured weather trace resampled to the engine grid.

    Args:
      path: ``.csv`` or ``.npz`` with a ``timestamp`` column (numeric
        seconds or datetimes) plus either ``t_wetbulb_c`` or
        ``t_drybulb_c`` + ``rh_pct`` (wet-bulb is then derived via
        ``wet_bulb_stull``).
      n_steps / dt / t0: the engine grid — row ``k`` is the condition at
        simulation time ``t0 + k*dt``.
      origin_s: absolute time the simulation's ``t=0`` corresponds to in
        the record's clock (default: the record's first timestamp, i.e.
        the trace starts when the simulation starts).

    Returns:
      ``WeatherSignals`` (f32[n_steps] wet-bulb and dry-bulb).
    Raises:
      TraceError: unreadable file, missing columns, non-monotone
        timestamps, or any non-finite/out-of-range sample.
    """
    p = pathlib.Path(path)
    cols = _read_columns(p)
    if "timestamp" not in cols:
        raise TraceError(f"{p.name}: missing 'timestamp' column "
                         f"(have: {sorted(cols)})")
    ts = _seconds(np.asarray(cols["timestamp"]), "timestamp")
    if not np.isfinite(ts).all():
        raise TraceError(f"{p.name}: non-finite timestamp")
    if len(ts) < 2:
        raise TraceError(f"{p.name}: need at least 2 weather rows")
    if not (np.diff(ts) > 0).all():
        raise TraceError(f"{p.name}: timestamps must be strictly "
                         f"increasing")

    def finite(name):
        v = np.asarray(cols[name], np.float64)
        if not np.isfinite(v).all():
            raise TraceError(f"{p.name}: non-finite {name}")
        return v

    if "t_wetbulb_c" in cols:
        wb = finite("t_wetbulb_c")
        db = finite("t_drybulb_c") if "t_drybulb_c" in cols else wb + 8.0
    elif "t_drybulb_c" in cols and "rh_pct" in cols:
        db = finite("t_drybulb_c")
        rh = finite("rh_pct")
        if ((rh < 0) | (rh > 100)).any():
            raise TraceError(f"{p.name}: rh_pct outside [0, 100]")
        wb = wet_bulb_stull(db, rh)
    else:
        raise TraceError(f"{p.name}: need 't_wetbulb_c' or 't_drybulb_c' + "
                         f"'rh_pct' (have: {sorted(cols)})")
    if (wb > db).any() or not np.isfinite(wb).all():
        raise TraceError(f"{p.name}: derived wet-bulb is non-physical")

    if origin_s is None:
        origin_s = float(ts[0])
    grid = origin_s + t0 + dt * np.arange(max(n_steps, 1), dtype=np.float64)
    # np.interp clamps at both edges — boundary behavior matches the
    # engine's clamped per-step gathers
    wb_s = np.interp(grid, ts, wb)
    db_s = np.interp(grid, ts, db)
    return W.from_arrays(wb_s, db_s)
