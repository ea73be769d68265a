"""Calibrate the transient cooling plant against recorded telemetry (the
port of ``repro.traces.calibrate``).

The cooling twin (``repro_torch.cooling.model``) has a handful of lumped
parameters nobody measures directly: HX conductance ``ua_w_k``, loop
time constants ``tau_hx_s`` / ``tower_tau_s``, the fan-staging threshold
``basin_margin_c``. This module fits them: drive the plant with a
*replayed* power trace (measured IT heat per step) and the recorded
ambient wet-bulb, and least-squares the simulated facility observables
(basin, supply and return temperatures, PUE) against the recorded ones
over full rollouts.

The forward model is a Python loop of ``cooling.step`` over the trace on
the caller's device, one scenario wide. A candidate's parameters enter
as 0-dim float32 tensors through ``dataclasses.replace`` on the frozen
``CoolingConfig``, as the reference's traced scalars do: every fitted
field is used only in tensor arithmetic, and the slew factors take their
float32 form (``kernels.power_topo.ref.slew_factors``). The plant step
is the plain PyTorch ``cdu_update_ref``, as in the reference: no Pallas
kernel runs on this path there either. Total IT power for the PUE is the
per-group heat summed exactly (``power.model.sum_exact``, float64 rounded
once), where the reference sums in float32.

The result is a ``FittedParams`` JSON: the fitted values plus a
*residual envelope* (per-channel RMSE on the calibration window), which
``check_envelope`` and ``main --check`` hold a later rollout to.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.cooling import model as cooling
from repro_torch.core import types as T
from repro_torch.core.types import CoolingState
from repro_torch.power.model import sum_exact
from repro_torch.systems.config import CoolingConfig
from repro_torch.traces.errors import TraceError

# Fittable CoolingConfig fields and their search bounds (physical, wide).
FIT_BOUNDS: dict[str, tuple[float, float]] = {
    "ua_w_k": (1e4, 1e7),
    "tau_hx_s": (10.0, 2000.0),
    "tau_valve_s": (5.0, 600.0),
    "basin_margin_c": (0.5, 10.0),
    "tower_tau_s": (60.0, 3600.0),
}
DEFAULT_FIT = ("ua_w_k", "tau_hx_s", "basin_margin_c")

# Residual scales: one unit of weighted residual ~ "equally bad" across
# channels (1 °C of water-temperature error vs 0.01 of PUE error).
# Supply/return observe ``ua_w_k`` / ``tau_hx_s`` (the HX sits between
# basin and supply), basin + PUE the tower-side parameters.
_SCALES = {"t_basin_c": 1.0, "t_supply_c": 1.0, "t_return_c": 1.0,
           "pue": 0.01}


@dataclasses.dataclass
class FittedParams:
    """A calibration result: fitted values + its regression envelope."""
    params: dict          # fitted CoolingConfig fields -> value
    envelope: dict        # channel -> RMSE on the calibration window
    cost: float           # final least-squares cost (0.5 * sum r^2)
    meta: dict            # n_steps / dt / discard / channels / digests

    def save(self, path: str | pathlib.Path) -> None:
        blob = dataclasses.asdict(self)
        pathlib.Path(path).write_text(json.dumps(blob, indent=2,
                                                 sort_keys=True) + "\n")

    @classmethod
    def load(cls, path: str | pathlib.Path) -> "FittedParams":
        try:
            blob = json.loads(pathlib.Path(path).read_text())
            return cls(params=blob["params"], envelope=blob["envelope"],
                       cost=float(blob["cost"]), meta=blob["meta"])
        except (OSError, KeyError, ValueError) as e:
            raise TraceError(f"cannot read fitted-params JSON "
                             f"{path}: {e}") from e


def _as_group_heat(heat_w, n_groups: int) -> np.ndarray:
    """f32[S] total IT power or f32[S, G] per-group heat -> f32[S, G]."""
    h = np.asarray(heat_w, np.float32)
    if h.ndim == 1:
        h = np.repeat(h[:, None] / n_groups, n_groups, axis=1)
    if h.ndim != 2 or h.shape[1] != n_groups:
        raise TraceError(f"heat trace must be [S] or [S, {n_groups}], "
                         f"got {h.shape}")
    if not np.isfinite(h).all() or (h < 0).any():
        raise TraceError("heat trace has non-finite or negative samples")
    return h


def _copy_into(dst: CoolingState, src: CoolingState) -> None:
    """Copy every leaf of ``src`` into ``dst``'s tensors, in place."""
    for f in dataclasses.fields(dst):
        getattr(dst, f.name).copy_(getattr(src, f.name))


class _Rollout:
    """The plant rolled over one heat + weather trace on one device, one
    scenario wide: ``eager`` runs the Python loop of ``cooling.step``,
    ``graphed`` the same step captured once as a CUDA graph."""

    def __init__(self, cfg: CoolingConfig, names: tuple[str, ...],
                 group_heat_w: np.ndarray, dt: float,
                 t_wetbulb_c: np.ndarray, dev: torch.device):
        self.cfg, self.names, self.dt, self.dev = cfg, names, dt, dev
        self.heat = torch.from_numpy(
            np.asarray(group_heat_w, np.float32)).to(dev)
        self.wb = torch.from_numpy(np.asarray(t_wetbulb_c, np.float32)).to(dev)
        self.steps = torch.arange(self.heat.shape[0], device=dev)
        # the neutral setpoint offset and maintenance count, on the device
        # so that a step copies nothing from the host
        self.zero = torch.zeros(1, dtype=torch.float32, device=dev)
        self.state0 = T.stack([cooling.init_state(cfg, dev)])

    @staticmethod
    def theta_f32(theta) -> torch.Tensor:
        # the reference's jnp.asarray(theta, jnp.float32)
        return torch.from_numpy(np.asarray(theta, np.float32).reshape(-1))

    def candidate(self, th: torch.Tensor) -> CoolingConfig:
        return dataclasses.replace(self.cfg, **{
            n: th[i] for i, n in enumerate(self.names)})

    def advance(self, c: CoolingConfig, state: CoolingState,
                k: torch.Tensor):
        """One plant step at step index ``k`` (i64[1]) -> (state,
        f32[4, 1] observables)."""
        q = self.heat.index_select(0, k)
        w = self.wb.index_select(0, k)
        state, out = cooling.step(c, state, q, self.dt, self.zero,
                                  self.zero, w)
        return state, torch.stack([
            out.t_basin, out.t_supply_max, out.t_tower_return,
            cooling.pue(sum_exact(q), 0.0, out.p_cooling)])

    @staticmethod
    def as_obs(obs: torch.Tensor) -> dict:
        obs = obs.cpu().numpy()
        return {"t_basin_c": obs[0], "t_supply_c": obs[1],
                "t_return_c": obs[2], "pue": obs[3]}

    def eager(self, theta) -> dict:
        """A candidate of fresh tensors each call: ``cooling.halls``
        caches per config, so a new config resolves its basin mass anew."""
        c = self.candidate(self.theta_f32(theta).to(self.dev))
        state, rows = self.state0, []
        for k in range(self.steps.shape[0]):
            state, row = self.advance(c, state, self.steps[k:k + 1])
            rows.append(row)
        return self.as_obs(torch.cat(rows, 1))

    def graphed(self):
        """Capture one step (the candidate read from a device buffer, the
        step's inputs gathered at a device counter, the state and the
        observables written back in place) and return the forward that
        replays it once a step."""
        dev = self.dev
        th = self.theta_f32([float(getattr(self.cfg, n))
                             for n in self.names]).to(dev)
        k = torch.zeros(1, dtype=torch.int64, device=dev)
        obs = torch.zeros((4, self.steps.shape[0]), dtype=torch.float32,
                          device=dev)
        state = T.tree_map(torch.clone, self.state0)
        c = self.candidate(th)

        def body():
            new, row = self.advance(c, state, k)
            obs.index_copy_(1, k, row)
            _copy_into(state, new)
            k.add_(1)

        # warm up on a side stream (the config's cached constants are
        # built here, outside the capture), then capture one step
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            body()
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            body()

        def forward(theta) -> dict:
            th.copy_(self.theta_f32(theta))
            k.zero_()
            _copy_into(state, self.state0)
            for _ in range(obs.shape[1]):
                graph.replay()
            return self.as_obs(obs)
        return forward


def make_forward(cfg: CoolingConfig, names: tuple[str, ...],
                 group_heat_w: np.ndarray, dt: float,
                 t_wetbulb_c: np.ndarray, device="cuda"):
    """Build the rollout: theta f64[len(names)] -> per-step observables
    {t_basin_c, t_supply_c, t_return_c, pue: f32[S]} as numpy arrays.
    The traces move to ``device`` once; each call rolls the plant over
    every step there and reads the observables back once.

    On the card the step is captured once as a CUDA graph and each
    rollout replays it: the same kernels as the eager loop, without a
    host launch per operation. A fit of ``tower_tau_s`` keeps the eager
    loop: that field reaches the basin mass, which ``cooling.halls``
    resolves once per config, outside any graph."""
    for n in names:
        if n not in FIT_BOUNDS:
            raise TraceError(f"unknown fittable parameter {n!r} "
                             f"(know: {sorted(FIT_BOUNDS)})")
    dev = resolve_device(device)
    roll = _Rollout(cfg, tuple(names), group_heat_w, dt, t_wetbulb_c, dev)
    if dev.type == "cuda" and "tower_tau_s" not in names:
        return roll.graphed()
    return roll.eager


def simulate_plant(cfg: CoolingConfig, heat_w: np.ndarray, dt: float,
                   t_wetbulb_c: np.ndarray, overrides: dict | None = None,
                   device="cuda") -> dict:
    """Roll the cooling plant over a heat + weather trace -> observables
    as numpy arrays. ``overrides`` replaces fittable CoolingConfig
    fields: used both to generate synthetic calibration truth and to
    evaluate a fit's residuals."""
    overrides = overrides or {}
    names = tuple(overrides)
    heat = _as_group_heat(heat_w, cfg.n_groups)
    if len(t_wetbulb_c) != heat.shape[0]:
        raise TraceError(f"weather ({len(t_wetbulb_c)}) and heat "
                         f"({heat.shape[0]}) traces disagree on steps")
    fwd = make_forward(cfg, names, heat, dt, t_wetbulb_c, device)
    return fwd(np.array([float(overrides[n]) for n in names]))


def _residuals(sim: dict, obs: dict, discard: int) -> np.ndarray:
    rs = []
    for ch, scale in _SCALES.items():
        if ch in obs:
            r = (np.asarray(sim[ch], np.float64)[discard:]
                 - np.asarray(obs[ch], np.float64)[discard:]) / scale
            rs.append(r)
    if not rs:
        raise TraceError(f"telemetry carries none of the calibration "
                         f"channels {sorted(_SCALES)}")
    return np.concatenate(rs)


def _envelope(sim: dict, obs: dict, discard: int) -> dict:
    env = {}
    for ch in _SCALES:
        if ch in obs:
            r = (np.asarray(sim[ch], np.float64)[discard:]
                 - np.asarray(obs[ch], np.float64)[discard:])
            env[f"{ch}_rmse"] = float(np.sqrt(np.mean(r * r)))
    return env


def calibrate(cfg: CoolingConfig, heat_w: np.ndarray, dt: float,
              t_wetbulb_c: np.ndarray, obs: dict,
              fit: tuple[str, ...] = DEFAULT_FIT,
              discard_frac: float = 0.1,
              meta: dict | None = None, device="cuda") -> FittedParams:
    """Fit ``fit`` CoolingConfig fields to recorded facility telemetry.

    Args:
      cfg: the plant, holding the initial guess in its current values.
      heat_w: replayed IT heat, f32[S] total or f32[S, G] per group (W).
      dt: step (s): both traces and the plant advance on this grid.
      t_wetbulb_c: recorded ambient wet-bulb, f32[S] (°C).
      obs: recorded observables: any of ``t_basin_c``, ``t_supply_c``,
        ``t_return_c`` (f32[S], °C) and ``pue`` (f32[S]); at least one.
      fit: which fields to fit (subset of ``FIT_BOUNDS``).
      discard_frac: leading fraction of the window excluded from the
        residual (plant spin-up from the idle initial condition).
      meta: extra provenance (trace digests, system name) stored in the
        result.
      device: where the rollouts run; ``"cpu"`` only when asked for.

    Returns:
      ``FittedParams``: fitted values, residual envelope (per-channel
      RMSE), final cost and provenance; ``meta["nfev"]`` counts the
      rollouts scipy asked for.
    """
    from scipy.optimize import least_squares
    heat = _as_group_heat(heat_w, cfg.n_groups)
    S = heat.shape[0]
    if len(t_wetbulb_c) != S:
        raise TraceError(f"weather ({len(t_wetbulb_c)}) and heat ({S}) "
                         f"traces disagree on steps")
    for ch in obs:
        if ch in _SCALES and len(obs[ch]) != S:
            raise TraceError(f"telemetry channel {ch!r} has "
                             f"{len(obs[ch])} steps, heat has {S}")
    discard = int(S * discard_frac)
    fwd = make_forward(cfg, tuple(fit), heat, dt, t_wetbulb_c, device)

    x0 = np.array([float(getattr(cfg, n)) for n in fit])
    lo = np.array([FIT_BOUNDS[n][0] for n in fit])
    hi = np.array([FIT_BOUNDS[n][1] for n in fit])
    rollouts = [0]

    def f(theta):
        rollouts[0] += 1
        return _residuals(fwd(theta), obs, discard)

    # diff_step must clear the f32 forward's quantization noise: the
    # default (~sqrt(eps) relative) gives an identically-zero numeric
    # Jacobian and the fit never leaves x0
    res = least_squares(f, np.clip(x0, lo, hi), bounds=(lo, hi),
                        x_scale=np.maximum(np.abs(x0), 1.0),
                        diff_step=1e-3, method="trf")
    params = {n: float(v) for n, v in zip(fit, res.x)}
    sim = fwd(res.x)
    return FittedParams(
        params=params,
        envelope=_envelope(sim, obs, discard),
        cost=float(res.cost),
        meta={"n_steps": int(S), "dt": float(dt), "discard": discard,
              "fit": list(fit), "channels": sorted(set(obs) & set(_SCALES)),
              "nfev": int(res.nfev), "rollouts": rollouts[0] + 1,
              **(meta or {})})


def check_envelope(fitted: FittedParams, cfg: CoolingConfig,
                   heat_w: np.ndarray, dt: float,
                   t_wetbulb_c: np.ndarray, obs: dict,
                   slack: float = 1.05, device="cuda") -> dict:
    """The regression gate: re-simulate with the fitted params and
    compare fresh residuals against the stored envelope.

    Returns the fresh per-channel RMSEs; raises ``TraceError`` if any
    channel widened beyond ``envelope * slack`` (the documented 5%
    numerical slack: toolchain noise, not physics drift)."""
    sim = simulate_plant(cfg, heat_w, dt, t_wetbulb_c,
                         overrides=fitted.params, device=device)
    fresh = _envelope(sim, obs, int(fitted.meta.get("discard", 0)))
    for ch, committed in fitted.envelope.items():
        got = fresh.get(ch)
        if got is None:
            raise TraceError(f"regression telemetry lost channel {ch!r}")
        if got > committed * slack + 1e-12:
            raise TraceError(
                f"calibration envelope widened: {ch} = {got:.6g} > "
                f"{committed:.6g} * {slack} — the cooling physics no "
                f"longer reproduces the committed calibration")
    return fresh


def _load_telemetry_npz(path: pathlib.Path) -> dict:
    try:
        z = np.load(path, allow_pickle=False)
    except Exception as e:
        raise TraceError(f"cannot read telemetry NPZ {path}: {e}") from e
    return {k: z[k] for k in z.files}


def main(argv: list[str] | None = None) -> int:
    """CLI: ``simulate calibrate``: fit or check a plant calibration.

    The facility telemetry NPZ carries ``dt`` (s), a heat trace
    (``p_it_w`` f32[S] or ``group_heat_w`` f32[S, G]), the recorded
    observables (``t_basin_c`` / ``t_supply_c`` / ``t_return_c`` /
    ``pue``) and, unless ``--weather-trace`` overrides it, the recorded
    ``t_wetbulb_c``. Runs on the card unless ``--device cpu`` is given.
    """
    import argparse
    from repro_torch.systems import config as SC
    ap = argparse.ArgumentParser(
        prog="simulate calibrate",
        description="fit cooling-plant parameters to recorded telemetry")
    ap.add_argument("--telemetry", required=True,
                    help="facility telemetry NPZ (see --help)")
    ap.add_argument("--system", default="frontier",
                    choices=sorted(SC.SYSTEMS))
    ap.add_argument("--weather-trace", default=None,
                    help="measured weather CSV/NPZ "
                         "(repro_torch.traces.weather); default: the "
                         "NPZ's t_wetbulb_c channel")
    ap.add_argument("--fit", default=",".join(DEFAULT_FIT),
                    help=f"comma list from {sorted(FIT_BOUNDS)}")
    ap.add_argument("--out", default=None,
                    help="write fitted-params JSON here")
    ap.add_argument("--check", default=None,
                    help="fitted-params JSON to verify instead of fitting "
                         "(the regression gate; exits 1 on a widened "
                         "envelope)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu only on request)")
    args = ap.parse_args(argv)

    tel = _load_telemetry_npz(pathlib.Path(args.telemetry))
    if "dt" not in tel:
        raise TraceError(f"{args.telemetry}: missing 'dt'")
    dt = float(tel["dt"])
    heat = tel.get("group_heat_w", tel.get("p_it_w"))
    if heat is None:
        raise TraceError(f"{args.telemetry}: missing 'p_it_w' or "
                         f"'group_heat_w'")
    obs = {ch: tel[ch] for ch in _SCALES if ch in tel}
    cfg = SC.SYSTEMS[args.system].cooling
    if args.weather_trace:
        from repro_torch.traces.weather import load_weather
        S = np.asarray(heat).shape[0]
        wb = load_weather(args.weather_trace, S, dt).t_wetbulb_c.numpy()
    elif "t_wetbulb_c" in tel:
        wb = np.asarray(tel["t_wetbulb_c"], np.float64)
    else:
        raise TraceError("no weather: pass --weather-trace or include "
                         "t_wetbulb_c in the telemetry NPZ")

    if args.check:
        fitted = FittedParams.load(args.check)
        try:
            fresh = check_envelope(fitted, cfg, heat, dt, wb, obs,
                                   device=args.device)
        except TraceError as e:
            print(f"FAIL {e}")
            return 1
        print("calibration envelope holds:")
        for ch, v in sorted(fresh.items()):
            print(f"  {ch}: {v:.6g} (committed "
                  f"{fitted.envelope[ch]:.6g})")
        return 0

    fit = tuple(s for s in args.fit.split(",") if s)
    fitted = calibrate(cfg, heat, dt, wb, obs, fit=fit,
                       meta={"system": args.system,
                             "telemetry": str(args.telemetry)},
                       device=args.device)
    for n, v in sorted(fitted.params.items()):
        print(f"  {n}: {v:.6g}  (initial {float(getattr(cfg, n)):.6g})")
    for ch, v in sorted(fitted.envelope.items()):
        print(f"  {ch}: {v:.6g}")
    print(f"  rollouts: {fitted.meta['rollouts']} "
          f"(nfev {fitted.meta['nfev']})")
    if args.out:
        fitted.save(args.out)
        print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
