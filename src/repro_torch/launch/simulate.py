"""S-RAPS CLI for the PyTorch port (a subset of ``repro.launch.simulate``).

  python -m repro_torch.launch.simulate --system frontier -t 6h \\
      --sweep fcfs:easy sjf:none thermal_aware:easy

--system selects the synthetic dataloader, --policy/--backfill the built-in
scheduler, --sweep several policy[:backfill] scenarios run as one batch.
The failure and demand-response flags (--failure-rate, --cdu-failure-rate,
--cell-failure-rate, --failure-corr, --failure-seed, --repair,
--no-requeue, --dr-announce, --dr-notice, --dr-duration, --dr-cap-mw)
turn the event layer on, as in the JAX CLI; a DR event without a grid
trace runs under neutral grid signals. The flight recorder is the JAX
CLI's: --manifest (a schema-versioned run manifest), --events (the NDJSON
event log), --metrics (per-step telemetry frames to a file, tcp:host:port
or unix:/path), --quiet and --json; --profile DIR records a
``torch.profiler`` trace (CPU and, on the card, CUDA activity) and writes
it as a Chrome trace into DIR. Runs on the card unless ``--device cpu``
is given.

Subcommand ``serve`` runs the twin as a persistent service
(``repro_torch.serve.cli``, docs/serving.md). The JAX CLI's ``train`` and
``calibrate`` subcommands and its --weather-trace, --trace and external
scheduler flags wait for the port of their layers.
"""
from __future__ import annotations

import argparse
import dataclasses
import pathlib
import sys
import time

from repro_torch import obs, resolve_device
from repro_torch.core import engine as eng
from repro_torch.core import stats as stats_mod
from repro_torch.core import types as T
from repro_torch.datasets import loaders
from repro_torch.events import EventConfig
from repro_torch.grid import signals as gsig
from repro_torch.launch import env as launch_env
from repro_torch.systems.config import FacilityTopology, get_system


def _parse_time(s: str) -> float:
    units = {"s": 1.0, "m": 60.0, "h": 3600.0, "d": 86400.0}
    if s and s[-1] in units:
        return float(s[:-1]) * units[s[-1]]
    return float(s)


def build_system(name: str, scale: int = 0, halls: int = 0):
    """Resolve a system config with optional node scaling and a hall
    split (capacity-preserving re-rate so every hall gets >= 1 CDU
    group and >= 1 tower cell)."""
    sys_ = get_system(name)
    if scale:
        sys_ = sys_.scaled(scale)
    if halls:
        cool = sys_.cooling
        # every hall needs >= 1 CDU group and >= 1 tower cell: re-rate the
        # fleet capacity-preservingly (more, smaller cells/CDUs — total
        # rated heat, flow, pump power and HX conductance unchanged) when
        # a scaled config is too coarse for the requested hall count
        cells = max(cool.n_tower_cells, halls)
        groups = max(cool.n_groups, halls)
        cell_k = cool.n_tower_cells / cells
        group_k = cool.n_groups / groups
        sys_ = dataclasses.replace(
            sys_, cooling=dataclasses.replace(
                cool,
                n_groups=groups,
                mdot_kg_s=cool.mdot_kg_s * group_k,
                ua_w_k=cool.ua_w_k * group_k,
                pump_w_per_group=cool.pump_w_per_group * group_k,
                n_tower_cells=cells,
                cell_rated_heat_w=cool.cell_rated_heat_w * cell_k,
                fan_rated_w=cool.fan_rated_w * cell_k,
                topology=FacilityTopology(n_halls=halls)))
    return sys_


def _failure_kwargs(args, t0):
    """Scenario knobs of the failure and DR layer from the CLI flags; an
    empty dict leaves the layer off. The flags' hazards are per entity
    and day, the knobs' per second; ``--dr-announce`` is relative to the
    run start, the knob absolute sim time."""
    per_day = 1.0 / 86400.0
    kw = {}
    if args.failure_rate is not None:
        kw["node_fail_rate"] = args.failure_rate * per_day
    if args.cdu_failure_rate is not None:
        kw["cdu_fail_rate"] = args.cdu_failure_rate * per_day
    if args.cell_failure_rate is not None:
        kw["cell_fail_rate"] = args.cell_failure_rate * per_day
    if kw:
        kw["failure_corr"] = args.failure_corr
        kw["failure_seed"] = float(args.failure_seed)
        kw["repair_s"] = _parse_time(args.repair)
    if args.dr_announce is not None and args.dr_cap_mw > 0:
        kw["dr_announce_s"] = t0 + _parse_time(args.dr_announce)
        kw["dr_notice_s"] = _parse_time(args.dr_notice)
        kw["dr_duration_s"] = _parse_time(args.dr_duration)
        kw["dr_cap_w"] = args.dr_cap_mw * 1e6
    return kw


# subcommands of the JAX CLI that wait for the port of their layer
UNPORTED = {"train": "ES policy training (ROADMAP item 13)",
            "calibrate": "cooling-plant calibration (ROADMAP item 12)"}


def main(argv=None):
    argv = list(sys.argv[1:]) if argv is None else list(argv)
    if argv[:1] == ["serve"]:
        # twin as a service (repro_torch.serve, docs/serving.md): a
        # persistent session with snapshot and fork over a socket
        from repro_torch.serve import cli as serve_cli
        return serve_cli.main(argv[1:])
    if argv[:1] and argv[0] in UNPORTED:
        raise SystemExit(f"simulate {argv[0]}: {UNPORTED[argv[0]]} is not "
                         f"ported to repro_torch yet")
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--system", default="marconi100")
    ap.add_argument("--scale", type=int, default=0,
                    help="scale the system to N nodes")
    ap.add_argument("--halls", type=int, default=0,
                    help="split the cooling plant into N halls")
    ap.add_argument("--jobs", type=int, default=1000)
    ap.add_argument("-t", "--time", default="6h", type=str,
                    help="simulated duration (s/m/h/d suffix)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--policy", default="replay")
    ap.add_argument("--backfill", default="none")
    ap.add_argument("--sweep", nargs="*", default=None,
                    help="policy[:backfill] list to run as one batch")
    ap.add_argument("--failure-rate", type=float, default=None,
                    help="per-node failure hazard (failures per node-day); "
                         "enables the stochastic failure layer")
    ap.add_argument("--cdu-failure-rate", type=float, default=None,
                    help="per-CDU-group failure hazard (per group-day)")
    ap.add_argument("--cell-failure-rate", type=float, default=None,
                    help="per-tower-cell failure hazard (per cell-day)")
    ap.add_argument("--failure-corr", type=float, default=0.0,
                    help="common-cause scale in [0, 1]: one per-hall draw "
                         "takes the hall's CDU groups down together")
    ap.add_argument("--failure-seed", type=int, default=0,
                    help="seed of the failure draws")
    ap.add_argument("--repair", default="1h", type=str,
                    help="mean repair time (s/m/h/d suffix)")
    ap.add_argument("--no-requeue", action="store_true",
                    help="killed jobs are dismissed instead of requeued")
    ap.add_argument("--dr-announce", default=None, type=str,
                    help="demand-response event: announcement time into "
                         "the run (s/m/h/d suffix); enables the DR layer")
    ap.add_argument("--dr-notice", default="30m", type=str,
                    help="notice window between the announcement and the "
                         "cap")
    ap.add_argument("--dr-duration", default="1h", type=str,
                    help="how long the DR cap holds")
    ap.add_argument("--dr-cap-mw", type=float, default=0.0,
                    help="DR cap level (MW)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu only on request)")
    # flight recorder (docs/observability.md)
    ap.add_argument("--manifest", default=None, metavar="FILE",
                    help="write a schema-versioned run manifest JSON")
    ap.add_argument("--events", default=None, metavar="FILE",
                    help="write lifecycle events (scan start and end) as "
                         "NDJSON")
    ap.add_argument("--metrics", default=None, metavar="TARGET",
                    help="stream per-step telemetry as NDJSON frames to a "
                         "file path, tcp:host:port, or unix:/path")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="record a torch.profiler trace of the run and "
                         "write it into DIR as a Chrome trace")
    obs.add_output_flags(ap)
    args = ap.parse_args(argv)

    sys_ = build_system(args.system, args.scale, args.halls)
    t0, t1 = 0.0, _parse_time(args.time)
    days = max((t1 / 86400.0) * 1.25, 0.5)
    js = loaders.load(args.system, n_jobs=args.jobs, days=days,
                      seed=args.seed)
    js.assign_prepop_placement(t0, sys_.n_nodes)
    table = js.to_table()
    fail_kw = _failure_kwargs(args, t0)
    events = signals = None
    if fail_kw:
        events = EventConfig(requeue=not args.no_requeue)
        if "dr_cap_w" in fail_kw:
            # demand response rides the grid-cap machinery: neutral
            # signals (zero carbon and price, uncapped) carry it
            signals = gsig.neutral(int(round((t1 - t0) / sys_.dt)))

    rep = obs.Reporter.from_flags(args)
    recorder = None
    if args.manifest or args.events:
        recorder = obs.RunRecorder(manifest_path=args.manifest,
                                   events_path=args.events)
        recorder.begin(
            sys_, command="sweep" if args.sweep else "simulate", argv=argv,
            scenario={"policy": args.policy, "backfill": args.backfill,
                      "sweep": args.sweep, "halls": args.halls,
                      "failure_rate_per_day": args.failure_rate,
                      "failure_seed": args.failure_seed,
                      "dr_cap_mw": args.dr_cap_mw, "device": args.device,
                      "t0_s": t0, "duration_s": t1 - t0},
            seed=args.seed, jobs=js,
            extra={"env_preset": launch_env.report(
                "sweep" if args.sweep else "throughput")})
        recorder.event("run_start")
    timer = obs.SpanTimer(listener=recorder.span_listener
                          if recorder else None)
    profiler = _start_profile(args) if args.profile else None

    wall0 = time.perf_counter()
    with obs.use(timer):
        runs = _run(args, sys_, table, t0, t1, fail_kw, signals, events)
    wall = time.perf_counter() - wall0
    if profiler is not None:
        profiler.stop()
        path = pathlib.Path(args.profile) / "trace.json"
        profiler.export_chrome_trace(str(path))
        rep.info(f"profiler trace -> {path}")

    sink = obs.MetricsSink(args.metrics) if args.metrics else None
    summaries = {}
    for (p, b), final, hist in runs:
        s = stats_mod.summarize(sys_, table, final, hist)
        label = f"{p}:{b}"
        summaries[label] = s
        if sink is not None:
            obs.stream_history(sink, recorder.run_id if recorder
                               else "anonymous", sys_, table, final, hist,
                               label=label, summary=s)
        rep.result(f"=== {args.system} policy={p} backfill={b} on "
                   f"{args.device} (sim {t1 - t0:.0f}s in {wall:.1f}s "
                   f"wall) ===\n" + stats_mod.format_stats(s),
                   key=label, value=s)
    if sink is not None:
        sink.close()
        rep.info(f"metrics: {sink.n_frames} frames -> {args.metrics}")
    if recorder is not None:
        recorder.event("run_end", wall_s=wall)
        counters = {}
        if sink is not None:
            counters["metrics_frames"] = sink.n_frames
        recorder.finalize(spans=timer.summary(), counters=counters,
                          wall_s=wall, summaries=summaries)
        rep.info(f"manifest -> {args.manifest}" if args.manifest
                 else f"events -> {args.events}")
    rep.flush_json()


def _start_profile(args):
    """A started ``torch.profiler`` over the run: CPU activity, and CUDA
    activity when the run is on the card."""
    from torch.profiler import ProfilerActivity, profile
    pathlib.Path(args.profile).mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if resolve_device(args.device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    return prof


def _run(args, sys_, table, t0, t1, fail_kw, signals, events):
    """One CLI invocation on the engine: a list of ((policy, backfill),
    final, hist), one per scenario."""
    if args.sweep or fail_kw:
        specs = [(p, b or "none") for p, _, b in
                 (s.partition(":") for s in args.sweep)] if args.sweep \
            else [(args.policy, args.backfill)]
        finals, hists = eng.simulate_sweep(
            sys_, table, [T.Scenario.make(p, b, **fail_kw)
                          for p, b in specs], t0, t1,
            signals=signals, events=events, device=args.device)
        return [(spec, T.row(finals, i), T.row(hists, i))
                for i, spec in enumerate(specs)]
    final, hist = eng.simulate_static(sys_, table, args.policy,
                                      args.backfill, t0, t1,
                                      device=args.device)
    return [((args.policy, args.backfill), final, hist)]


if __name__ == "__main__":
    sys.exit(main())
