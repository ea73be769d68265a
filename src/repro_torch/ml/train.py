"""Policy training over batched twin rollouts (paper contribution (5),
§4.4; port of ``repro.ml.train``).

The whole digital twin is the fitness function. A candidate policy is an
alpha vector for the ranking score S(X) = basis(X) @ alpha
(``repro_torch.ml.scoring``); its fitness is a ``Reward``: a weighted sum
of telemetry the twin already emits (mean wait, turnaround, facility
energy, PUE, carbon and cost from the grid ledgers, per-hall overheat).
The score is linear in alpha, so the per-job basis lives in the shared
``JobTable.ml_basis`` while alpha rides ``Scenario.alpha``: one ES
generation with population P runs as ONE batched ``simulate_sweep`` /
``simulate_sweep_sharded`` call, the population being one more scenario
axis.

Optimizer: OpenAI-style evolution strategies with antithetic
perturbations and centered-rank fitness shaping. An elite (the best
candidate ever evaluated) is tracked beside the search mean, so the
returned policy is no worse than the hand-set ``scoring.DEFAULT_ALPHA``
baseline, which rides in every generation's sweep.

Where the work runs. The rollouts run on the card unless ``device="cpu"``
is asked for; nothing falls back to the CPU. Each generation's final
states and histories come to the host once, as numpy, and everything
after the sweep (the metrics, the reward, the ranks, the ES step, the
next generation's draw) is the reference's numpy arithmetic in float64:
the candidates come from ``np.random.default_rng([seed, gen])`` and the
ranks from ``np.argsort`` with its default kind. A generation whose
rewards hold the reference's ties and order therefore moves ``mu``
exactly as the reference does, and a checkpoint either package writes
resumes in the other.

The port compiles nothing, so it has none of the reference's sweep-runner
cache. The ``cache_hits``/``cache_misses`` keys of each ``history`` row,
the ``generation`` events' copies and the manifest's ``sweep_cache``
counters are kept, so the JSON reads as the reference's, and are 0.

CLI (``python -m repro_torch.launch.simulate train ...``):

  train --smoke --device cpu          # tiny seeded run, asserts improvement
  train --system marconi100 --jobs 400 -t 12h --reward wait=1,energy=0.5 \\
        --generations 30 --population 16 --checkpoint results/train/run.json

Checkpoints are JSON and resumable (``--resume``): the search state (mu,
sigma, generation, elite, reward normalizers) round-trips exactly.
"""
from __future__ import annotations

import json
import pathlib
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Sequence

import numpy as np

from repro_torch.core import engine as eng
from repro_torch.core import types as T
from repro_torch.launch import env as launch_env
from repro_torch.ml import scoring
from repro_torch.obs import timing as obs_timing
from repro_torch.systems.config import SystemConfig

# ---------------------------------------------------------------------------
# Reward: telemetry -> scalar fitness (higher is better).
# ---------------------------------------------------------------------------
# Every metric is lower-is-better in raw form; the reward negates the
# weighted, baseline-normalized sum. Units listed per metric.
METRICS: Dict[str, str] = {
    "wait":       "mean wait of completed jobs (s)",
    "turnaround": "mean turnaround of completed jobs (s)",
    "energy":     "total facility energy (J)",
    "pue":        "mean PUE (dimensionless)",
    "carbon":     "grid-signal-weighted emissions (kg CO2)",
    "cost":       "electricity cost at the grid price ($)",
    "overheat":   "fraction of (step, hall) rows past the supply setpoint "
                  "margin (dimensionless)",
    "unfinished": "valid jobs not completed inside the window (count)",
    "power_peak": "max facility power (W)",
}

# ``unfinished`` counterweights window-gaming: without it, ES can "win"
# the completed-jobs-only wait/turnaround means by starving long jobs past
# the end of the rollout window instead of serving them.
DEFAULT_REWARD_SPEC = "wait=1,turnaround=0.5,energy=0.25,unfinished=0.5"

# The seeded tiny config of ``train --smoke`` (the reference's, value for
# value, so the two packages' smoke runs train on the same backlog).
SMOKE_CONFIG = dict(system="marconi100", scale=64, jobs=90, time="2h",
                    generations=4, population=8, sigma=0.35, lr=0.8)

# what the manifest's ``sweep_cache`` counters hold: the reference's keys,
# at 0 (no compiled runner to cache)
SWEEP_CACHE_STATS = {"hits": 0, "misses": 0, "evictions": 0}


def to_host(tree):
    """A batched state or history with every leaf copied to the host as
    numpy, in one pass (what ``rollout_metrics`` reads)."""
    return T.tree_map(lambda x: x.detach().cpu().numpy(), tree)


def rollout_metrics(system: SystemConfig, table: T.JobTable,
                    finals: T.SimState, hists: T.StepRecord,
                    setpoint_delta_c: float = 0.0
                    ) -> Dict[str, np.ndarray]:
    """Per-scenario metric vectors from one batched rollout.

    Args:
      system: the simulated machine (for the overheat threshold, °C).
      table: the (shared) job table of the rollout (on the host).
      finals: batched final states on the host (``to_host``), every leaf
        with leading axis P.
      hists: batched telemetry on the host, leaves [P, steps] or
        [P, steps, H].
      setpoint_delta_c: supply-setpoint offset the rollout ran with
        (``Scenario.setpoint_delta_c``), so the ``overheat`` threshold
        matches the engine's own definition (cooling.model.thermal_now).
    Returns:
      {metric name -> f64[P]} for every name in ``METRICS``.
    """
    start = np.asarray(finals.start, np.float64)          # [P, J]
    end = np.asarray(finals.end, np.float64)
    jstate = np.asarray(finals.jstate)
    submit = np.asarray(table.submit, np.float64)[None]   # [1, J]
    valid = np.asarray(table.valid)[None]
    done = (jstate == T.DONE) & np.isfinite(start) & np.isfinite(end)
    n_done = np.maximum(done.sum(-1), 1)
    wait = np.where(done, np.maximum(start - submit, 0.0), 0.0)
    turn = np.where(done, np.maximum(end - submit, 0.0), 0.0)

    cfg = system.cooling
    t_sup = np.asarray(hists.t_supply_max_hall, np.float64)  # [P, S, H]
    hot = t_sup > (cfg.t_supply_setpoint_c + setpoint_delta_c +
                   cfg.t_supply_margin_c)
    return {
        "wait": wait.sum(-1) / n_done,
        "turnaround": turn.sum(-1) / n_done,
        "energy": np.asarray(finals.energy_total, np.float64),
        "pue": np.asarray(hists.pue, np.float64).mean(-1),
        "carbon": np.asarray(finals.emissions_kg, np.float64),
        "cost": np.asarray(finals.energy_cost, np.float64),
        "overheat": hot.mean((-2, -1)),
        "unfinished": (valid & (jstate != T.DONE) &
                       (jstate != T.DISMISSED)).sum(-1).astype(np.float64),
        "power_peak": np.asarray(hists.power_total, np.float64).max(-1),
    }


@dataclass(frozen=True)
class Reward:
    """Weighted telemetry objective, higher is better.

    ``reward = -sum_m w_m * metric_m / ref_m`` where the normalizers
    ``ref_m`` are the *baseline policy's* metric values (so each term is
    1.0 at the baseline and the baseline reward is exactly ``-sum_m w_m``:
    improvement reads directly as reward above that floor). Zero
    baselines fall back to an unnormalized term.
    """
    weights: tuple  # ((metric name, weight), ...)

    @staticmethod
    def parse(spec: str) -> "Reward":
        """Parse ``"wait=1,energy=0.5"`` into a Reward. Unknown metric
        names raise with the list of valid ones."""
        weights = []
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            name, _, w = part.partition("=")
            name = name.strip()
            if name not in METRICS:
                raise ValueError(
                    f"unknown reward metric {name!r}; "
                    f"valid: {', '.join(sorted(METRICS))}")
            weights.append((name, float(w) if w else 1.0))
        if not weights:
            raise ValueError(f"empty reward spec: {spec!r}")
        return Reward(tuple(weights))

    @property
    def spec(self) -> str:
        return ",".join(f"{n}={w:g}" for n, w in self.weights)

    def refs(self, metrics: Dict[str, np.ndarray], row: int
             ) -> Dict[str, float]:
        """Baseline normalizers: the metric values of scenario ``row``."""
        return {n: float(metrics[n][row]) for n, _ in self.weights}

    def evaluate(self, metrics: Dict[str, np.ndarray],
                 refs: Dict[str, float]) -> np.ndarray:
        """f64[P] rewards for a batched rollout's metric vectors."""
        r = 0.0
        for name, w in self.weights:
            scale = refs.get(name, 0.0)
            scale = scale if abs(scale) > 1e-12 else 1.0
            r = r - w * metrics[name] / scale
        return np.asarray(r, np.float64)


# ---------------------------------------------------------------------------
# Antithetic ES with centered-rank shaping.
# ---------------------------------------------------------------------------
def antithetic_population(mu: np.ndarray, sigma: float,
                          rng: np.random.Generator, population: int
                          ) -> np.ndarray:
    """f32[P, K] candidates: mu +/- sigma * eps in antithetic pairs.

    ``population`` must be even; row i and row i + P/2 share |eps|."""
    assert population % 2 == 0, "ES population must be even (antithetic)"
    half = population // 2
    eps = rng.standard_normal((half, mu.shape[0]))
    return np.concatenate([mu + sigma * eps, mu - sigma * eps],
                          0).astype(np.float32)


def centered_ranks(r: np.ndarray) -> np.ndarray:
    """Map rewards to utilities in [-0.5, 0.5] by rank (robust to reward
    scale and outliers: the standard ES fitness shaping). Equal rewards
    take the order ``np.argsort``'s default kind gives them, as in the
    reference: the same call on the same float64 array."""
    ranks = np.empty(len(r), np.float64)
    ranks[np.argsort(r)] = np.arange(len(r), dtype=np.float64)
    return ranks / max(len(r) - 1, 1) - 0.5


def es_update(mu: np.ndarray, candidates: np.ndarray, rewards: np.ndarray,
              sigma: float, lr: float) -> np.ndarray:
    """One ES ascent step on the search mean.

    Args:
      mu: f64[K] current mean.
      candidates: f32[P, K] the antithetic population (mu +/- sigma*eps).
      rewards: f64[P] fitness per candidate (higher better).
      sigma, lr: perturbation scale / learning rate (dimensionless).
    Returns:
      f64[K] updated mean: mu + lr/(P*sigma) * sum_i u_i * eps_i with
      centered-rank utilities u and unit-normal eps (the OpenAI-ES
      estimator).
    """
    P = len(candidates)
    eps = (np.asarray(candidates, np.float64) - mu) / sigma
    u = centered_ranks(rewards)
    return mu + lr / (P * sigma) * (u @ eps)


# ---------------------------------------------------------------------------
# The training loop.
# ---------------------------------------------------------------------------
@dataclass
class TrainResult:
    """Outcome of ``train``: elite policy + search trajectory."""
    alpha: np.ndarray            # f32[K] best candidate ever evaluated
    mu: np.ndarray               # f64[K] final search mean
    reward_best: float           # elite reward (its own objective)
    reward_default: float        # the hand-set DEFAULT_ALPHA baseline
    refs: Dict[str, float]       # reward normalizers (baseline metrics)
    history: List[dict]          # per-generation records
    generations: int


def _rollout(system, table, alphas, t0, t1, *, backfill, scen_kw,
             signals, weather, sharded, device):
    """Evaluate a stack of alpha vectors as ONE batched sweep on
    ``device`` (None: the card; sharded, every visible card).

    ``alphas`` f32[P, K] -> one Scenario per row, all sharing the job
    table, signals and weather; scenario axis = population axis. The
    engine's entry points are looked up at call time."""
    scens = [T.Scenario.make("ml", backfill, alpha=a, **(scen_kw or {}))
             for a in alphas]
    if sharded:
        return eng.simulate_sweep_sharded(
            system, table, scens, t0, t1, signals=signals, weather=weather,
            devices=None if device is None else [device])
    return eng.simulate_sweep(system, table, scens, t0, t1, signals=signals,
                              weather=weather, device=device or "cuda")


def train(system: SystemConfig, table: T.JobTable, t0: float, t1: float,
          reward: Reward | str = DEFAULT_REWARD_SPEC,
          generations: int = 20, population: int = 16,
          sigma: float = 0.25, lr: float = 0.6,
          alpha0: Sequence[float] | None = None,
          backfill: str = "first-fit", scen_kw: dict | None = None,
          signals=None, weather=None, seed: int = 0,
          checkpoint: str | pathlib.Path | None = None,
          resume: bool = False, sharded: bool = True,
          log: Callable[[str], None] | None = print,
          recorder=None, device=None) -> TrainResult:
    """ES-train the scoring alpha against batched twin rollouts.

    Args:
      system: machine config.
      table: job table with ``ml_basis`` attached
        (``ml.pipeline.attach_basis``); raises otherwise.
      t0, t1: rollout window (s).
      reward: ``Reward`` or spec string, e.g. ``"wait=1,energy=0.5"``.
      generations: ES generations to run (on resume: *total*, including
        the checkpointed ones).
      population: candidates per generation (even; antithetic pairs).
        Each generation evaluates population + 2 scenarios (the search
        mean and the frozen baseline ride along) as one sweep.
      sigma, lr: ES perturbation scale / learning rate.
      alpha0: f32[K] starting mean; default ``scoring.DEFAULT_ALPHA``.
      backfill: backfill mode for every candidate scenario.
      scen_kw: extra ``Scenario.make`` knobs shared by all candidates
        (e.g. ``cells_offline`` for train-under-stress).
      signals / weather: grid signals / weather trace(s) for the rollouts
        (weather may be a per-scenario list only if it has population + 2
        entries; normally one shared trace).
      seed: RNG seed; generation g draws from ``default_rng([seed, g])``,
        so resumed runs replay the exact same perturbations.
      checkpoint: JSON path written after every generation.
      resume: load ``checkpoint`` and continue to ``generations``.
      sharded: use ``simulate_sweep_sharded`` (the rows split across
        ``device``, or every visible card); identical to
        ``simulate_sweep`` on one device.
      log: per-generation progress line sink; the default routes through
        the ``repro_torch`` logger (stderr); ``None`` silences.
      recorder: optional ``obs.RunRecorder``: gets a ``generation`` event
        per generation and a ``checkpoint`` event per save.
      device: where the rollouts run: None for the card (every visible
        card when sharded), else a torch device such as ``"cpu"``.
    Returns:
      ``TrainResult`` with the elite alpha (never worse than the baseline
      on this reward, since the baseline is evaluated in-band).
    """
    if log is print:    # route the default through logging, not stdout
        from repro_torch.obs.reporter import get_logger
        log = get_logger().info
    if table.ml_basis is None:
        raise ValueError("table has no ml_basis; call "
                         "ml.pipeline.attach_basis(js, model) before "
                         "training")
    if isinstance(reward, str):
        reward = Reward.parse(reward)
    K = table.ml_basis.shape[1]
    base_alpha = np.asarray(
        scoring.DEFAULT_ALPHA[:K] if alpha0 is None else alpha0, np.float64)
    mu = base_alpha.copy()
    gen0, history = 0, []
    best_alpha, best_reward = None, -np.inf
    refs = None

    if resume and checkpoint and pathlib.Path(checkpoint).exists():
        ck = json.loads(pathlib.Path(checkpoint).read_text())
        mu = np.asarray(ck["mu"], np.float64)
        base_alpha = np.asarray(ck["alpha0"], np.float64)
        if log and (ck["sigma"] != sigma or ck["lr"] != lr or
                    ck["seed"] != seed):
            log(f"resume: checkpoint sigma={ck['sigma']}, lr={ck['lr']}, "
                f"seed={ck['seed']} override the call's "
                f"sigma={sigma}, lr={lr}, seed={seed}")
        sigma, lr = ck["sigma"], ck["lr"]
        # population shapes the per-generation eps draw: restore it too,
        # or the promised "resume replays the same perturbations" breaks
        population = ck.get("population", population)
        gen0, history = ck["generation"], ck["history"]
        best_alpha = np.asarray(ck["best_alpha"], np.float64)
        best_reward = ck["best_reward"]
        refs = ck["refs"]
        seed = ck["seed"]
        if ck["reward"] != reward.spec and log:
            log(f"resume: checkpoint reward {ck['reward']!r} overrides "
                f"{reward.spec!r}")
            reward = Reward.parse(ck["reward"])

    for gen in range(gen0, generations):
        rng = np.random.default_rng([seed, gen])
        cands = antithetic_population(mu, sigma, rng, population)
        # rows [0:P] = population, row P = search mean, row P+1 = frozen
        # baseline (reward normalizer + the bar the elite must clear)
        stack = np.concatenate(
            [cands, mu[None].astype(np.float32),
             base_alpha[None].astype(np.float32)], 0)
        wall = time.perf_counter()
        with obs_timing.maybe_span("train.generation", generation=gen):
            finals, hists = _rollout(system, table, stack, t0, t1,
                                     backfill=backfill, scen_kw=scen_kw,
                                     signals=signals, weather=weather,
                                     sharded=sharded, device=device)
            finals, hists = to_host(finals), to_host(hists)
        wall = time.perf_counter() - wall
        cache_hits = cache_misses = 0     # no compiled runner to cache
        metrics = rollout_metrics(
            system, table, finals, hists,
            float((scen_kw or {}).get("setpoint_delta_c", 0.0)))
        if refs is None:   # first generation: pin normalizers to baseline
            refs = reward.refs(metrics, len(stack) - 1)
        rewards = reward.evaluate(metrics, refs)
        r_pop, r_mu, r_base = (rewards[:population], rewards[population],
                               rewards[population + 1])

        gen_best = int(np.argmax(rewards[:population + 1]))
        if rewards[gen_best] > best_reward:
            best_reward = float(rewards[gen_best])
            best_alpha = stack[gen_best].astype(np.float64)

        mu = es_update(mu, cands, r_pop, sigma, lr)
        history.append({
            "generation": gen, "reward_mu": float(r_mu),
            "reward_best": float(best_reward),
            "reward_baseline": float(r_base),
            "reward_pop_mean": float(r_pop.mean()),
            "wall_s": wall, "mu": [float(x) for x in mu],
            "cache_hits": cache_hits, "cache_misses": cache_misses,
        })
        if recorder is not None:
            recorder.event("generation", generation=gen,
                           reward_mu=float(r_mu),
                           reward_best=float(best_reward),
                           wall_s=wall, cache_hits=cache_hits,
                           cache_misses=cache_misses)
        if log:
            log(f"gen {gen:3d}  r(mu)={r_mu:+.4f}  "
                f"r(best)={best_reward:+.4f}  r(base)={r_base:+.4f}  "
                f"pop={population}  {wall:.2f}s/gen")
        if checkpoint:
            _save_checkpoint(checkpoint, mu=mu, alpha0=base_alpha,
                             sigma=sigma, lr=lr, population=population,
                             generation=gen + 1,
                             history=history, best_alpha=best_alpha,
                             best_reward=best_reward, refs=refs,
                             reward=reward.spec, seed=seed)
            if recorder is not None:
                recorder.event("checkpoint", path=str(checkpoint),
                               generation=gen + 1)

    # the baseline reward is deterministic: read it off the last generation
    # (== -sum of weights when every normalizer is nonzero)
    reward_default = (history[-1]["reward_baseline"] if history
                      else -sum(w for _, w in reward.weights))
    if best_alpha is None:      # generations == 0: the baseline is the elite
        best_alpha, best_reward = base_alpha, reward_default
    return TrainResult(alpha=best_alpha.astype(np.float32), mu=mu,
                       reward_best=float(best_reward),
                       reward_default=float(reward_default),
                       refs=refs or {}, history=history,
                       generations=len(history))


def _save_checkpoint(path, **state) -> None:
    """Atomic-ish JSON checkpoint (write then replace), in the
    reference's layout."""
    p = pathlib.Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    tmp = p.with_suffix(p.suffix + ".tmp")
    tmp.write_text(json.dumps(state, indent=1, default=_jsonable))
    tmp.replace(p)


def _jsonable(x):
    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, (np.floating, np.integer)):
        return x.item()
    raise TypeError(f"not JSON-serializable: {type(x)}")


def load_alpha(path: str | pathlib.Path) -> np.ndarray:
    """f32[K] elite alpha from a training checkpoint JSON."""
    ck = json.loads(pathlib.Path(path).read_text())
    return np.asarray(ck["best_alpha"], np.float32)


# ---------------------------------------------------------------------------
# CLI (dispatched from ``python -m repro_torch.launch.simulate train ...``).
# ---------------------------------------------------------------------------
def main(argv=None) -> TrainResult:
    import argparse

    from repro_torch.datasets import loaders
    from repro_torch.ml.pipeline import MLSchedulerModel, attach_basis
    from repro_torch.systems.config import get_system

    ap = argparse.ArgumentParser(
        prog="simulate train",
        description="ES-train the ML scheduling policy inside the twin")
    ap.add_argument("--system", default="marconi100")
    ap.add_argument("--jobs", type=int, default=300)
    ap.add_argument("--scale", type=int, default=0,
                    help="scale the system to N nodes (CPU-friendly)")
    ap.add_argument("-t", "--time", default="6h",
                    help="rollout window (s/m/h/d suffix)")
    ap.add_argument("--reward", default=DEFAULT_REWARD_SPEC,
                    help="metric=weight list; metrics: " +
                         ", ".join(sorted(METRICS)))
    ap.add_argument("--generations", type=int, default=12)
    ap.add_argument("--population", type=int, default=16)
    ap.add_argument("--sigma", type=float, default=0.25)
    ap.add_argument("--lr", type=float, default=0.6)
    ap.add_argument("--backfill", default="first-fit")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--heat-wave-c", type=float, default=0.0,
                    help="train under a heat wave of this amplitude (°C)")
    ap.add_argument("--cells-offline", type=float, default=0.0,
                    help="train with N tower cells out per hall")
    ap.add_argument("--checkpoint", default="results/train/ml_alpha.json")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny seeded config; asserts the trained reward "
                         "improves on the default alpha")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the rollouts (default cuda; cpu "
                         "only on request)")
    ap.add_argument("--manifest", default=None, metavar="FILE",
                    help="write a schema-versioned run manifest JSON")
    ap.add_argument("--events", default=None, metavar="FILE",
                    help="write lifecycle events as NDJSON")
    from repro_torch.obs.reporter import add_output_flags
    add_output_flags(ap)
    import sys as _sys
    argv = list(_sys.argv[1:]) if argv is None else list(argv)
    if "--smoke" in argv:
        # presets via set_defaults so explicit flags still win (e.g.
        # ``train --smoke --resume --generations 8`` extends the run)
        ap.set_defaults(**SMOKE_CONFIG)
    args = ap.parse_args(argv)

    from repro_torch.launch.simulate import _parse_time

    sys_ = get_system(args.system)
    if args.scale:
        sys_ = sys_.scaled(args.scale)
    t1 = _parse_time(args.time)
    # arrivals span ~the rollout window so the queue actually fills: the
    # policy can only move the reward when there is contention to arbitrate
    days = max((t1 / 86400.0) * 1.2, 0.02)
    js = loaders.load(args.system, n_jobs=args.jobs, days=days,
                      seed=args.seed)
    # loaders size jobs against the full-scale system; on a --scale'd one,
    # drop jobs that can never fit (they would sit QUEUED forever and put
    # a constant floor under the wait/unfinished reward terms)
    js = js.select(np.asarray(js.nodes) <= sys_.n_nodes)
    # the offline pipeline provides the basis; training only moves alpha
    model = MLSchedulerModel.fit(js, k=4, n_trees=6, depth=5,
                                 seed=args.seed)
    attach_basis(js, model)
    js.assign_prepop_placement(0.0, sys_.n_nodes)
    table = js.to_table()

    weather = None
    if args.heat_wave_c > 0.0:
        from repro_torch.cooling import weather as wsig
        n_steps = int(round(t1 / sys_.dt))
        base = wsig.synthetic_weather(n_steps, sys_.dt, seed=args.seed)
        weather = wsig.heat_wave(base, sys_.dt, start_s=0.1 * t1,
                                 duration_s=0.6 * t1,
                                 peak_amp_c=args.heat_wave_c)
    scen_kw = {}
    if args.cells_offline:
        scen_kw["cells_offline"] = args.cells_offline

    from repro_torch import obs
    rep = obs.Reporter.from_flags(args)
    recorder = None
    if args.manifest or args.events:
        recorder = obs.RunRecorder(manifest_path=args.manifest,
                                   events_path=args.events)
        recorder.begin(sys_, command="train", argv=argv,
                       scenario={"reward": args.reward,
                                 "generations": args.generations,
                                 "population": args.population,
                                 "sigma": args.sigma, "lr": args.lr,
                                 "backfill": args.backfill,
                                 "heat_wave_c": args.heat_wave_c,
                                 "cells_offline": args.cells_offline,
                                 "device": args.device},
                       seed=args.seed, jobs=js,
                       extra={"env_preset": launch_env.report("sweep")})
        recorder.event("run_start", command="train")
    timer = obs.SpanTimer(listener=recorder.span_listener
                          if recorder else None)
    with obs.use(timer):
        res = train(sys_, table, 0.0, t1, reward=args.reward,
                    generations=args.generations,
                    population=args.population,
                    sigma=args.sigma, lr=args.lr, backfill=args.backfill,
                    scen_kw=scen_kw, weather=weather, seed=args.seed,
                    checkpoint=args.checkpoint, resume=args.resume,
                    log=rep.log_fn(), recorder=recorder,
                    device=args.device)
    gain = res.reward_best - res.reward_default
    rep.result(f"trained alpha: {np.round(res.alpha, 4).tolist()}  "
               f"reward {res.reward_best:+.4f} vs default "
               f"{res.reward_default:+.4f}  (gain {gain:+.4f})",
               key="train",
               value={"alpha": res.alpha, "reward_best": res.reward_best,
                      "reward_default": res.reward_default, "gain": gain,
                      "generations": res.generations})
    if args.checkpoint:
        rep.info(f"checkpoint -> {args.checkpoint}")
        rep.result_json("checkpoint", str(args.checkpoint))
    if recorder is not None:
        recorder.event("run_end", generations=res.generations)
        recorder.finalize(
            spans=timer.summary(),
            counters={"sweep_cache": dict(SWEEP_CACHE_STATS)},
            result={"reward_best": res.reward_best,
                    "reward_default": res.reward_default, "gain": gain,
                    "generations": res.generations})
    rep.flush_json()
    if args.smoke:
        assert gain > 0.0, (
            f"smoke training failed to improve on the default alpha "
            f"(gain {gain:+.5f})")
        rep.info("smoke OK: trained policy improves the reward "
                 f"by {gain:+.4f} over the default alpha")
    return res


if __name__ == "__main__":
    main()
