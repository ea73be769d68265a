"""S-RAPS CLI for the PyTorch port (``repro.launch.simulate``'s surface).

  python -m repro_torch.launch.simulate --system marconi100 -t 61000 \
      -ff 4381000 --policy fcfs --backfill easy -o out/

--system selects the synthetic dataloader (--jobs, --seed, and --days for
the horizon to generate, by default 1.25x the run's end and at least
half a day), --scale N scales it to N nodes and --halls N splits its
cooling plant into N halls. -ff/--fastforward starts the run at that
offset (s/m/h/d suffix) and -t/--time runs that long after it;
--cells-offline takes tower cells out for maintenance, a number for
every hall or a comma list per hall ('2,0,0,0'). --smoke is a CI-sized
run (64 nodes, at most 48 jobs, 30 minutes). --policy/--backfill select
the built-in scheduler, --sweep several policy[:backfill] scenarios run
as one batch on --device (``engine.simulate_sweep_sharded`` on that one
device, which is ``simulate_sweep``: the reference splits the rows
across every device, but the port's engine is bound by the host's
dispatch, so a split from one host gains nothing).

Incentives (paper §4.3): --accounts writes each run's account ledger as
accounts.json under -o (collect), --accounts-json warm-starts every
built-in engine path from such a ledger, written by either package
(redeem). -o/--output [DIR] (default simulation_results) writes one
directory a run holding history.npz (every telemetry row), stats.out,
job_history.csv and, with --accounts, accounts.json, in the JAX CLI's
formats.

ML-guided scheduling (paper §4.4): --policy ml fits the pipeline
(``repro_torch.ml.pipeline``: k-means, the forest, per-cluster ridge) on
the loaded jobs and bakes each job's score under --ml-alpha (a training
checkpoint JSON, or comma floats; by default the paper's hand-set
alpha) into the table. Only --policy ml fits: an ml entry of --sweep
under another --policy ranks on the table's zero scores, as in the JAX
CLI.

--scheduler fastsim|scheduleflow couples an in-process event-based
external simulator (``repro_torch.core.external``: FastSim schedules the
whole backlog first and the twin replays it, ScheduleFlow is polled every
step); --external-cmd spawns an out-of-process peer and --external-socket
dials one that is listening (``core.transport``), coupled in
--external-mode plugin (polled every step) or sequential (its schedule
replayed), over --external-wire auto|ndjson|binary frames with a
--external-timeout per poll. An unset --backfill means none for the
built-in scheduler and firstfit for an external peer; the bridge's
counters reach the --json document and the manifest.
The failure and demand-response flags (--failure-rate, --cdu-failure-rate,
--cell-failure-rate, --failure-corr, --failure-seed, --repair,
--no-requeue, --dr-announce, --dr-notice, --dr-duration, --dr-cap-mw)
turn the event layer on, as in the JAX CLI; a DR event without a grid
trace runs under neutral grid signals, and --dr-announce counts from the
run's start. The flight recorder is the JAX
CLI's: --manifest (a schema-versioned run manifest), --events (the NDJSON
event log), --metrics (per-step telemetry frames to a file, tcp:host:port
or unix:/path), --quiet and --json; --profile DIR records a
``torch.profiler`` trace (CPU and, on the card, CUDA activity) and writes
it as a Chrome trace into DIR. Runs on the card unless ``--device cpu``
is given.

Real traces (``repro_torch.traces``, docs/datasets.md): ``--trace``
ingests a published job table, a cached trace NPZ or a joblive/jobprofile
telemetry dump in place of the synthetic dataset (``--trace-cache`` names
the NPZ cache directory), ``--replay-power`` plays measured power back
verbatim, ``--weather-trace`` drives the cooling tower from recorded
ambient conditions. The manifest records each trace's content digest.

Subcommand ``serve`` runs the twin as a persistent service
(``repro_torch.serve.cli``, docs/serving.md); ``calibrate`` fits the
cooling-plant parameters to recorded facility telemetry
(``repro_torch.traces.calibrate``); ``train`` ES-trains the ML
scheduler's alpha over batched twin rollouts (``repro_torch.ml.train``:
``train --smoke --device cpu`` on the CPU, ``--checkpoint`` feeds
``--ml-alpha``).
"""
from __future__ import annotations

import argparse
import dataclasses
import pathlib
import secrets
import sys
import time

import numpy as np
import torch

from repro_torch import obs, resolve_device
from repro_torch.core import accounts as acct_mod
from repro_torch.core import engine as eng
from repro_torch.core import external as ext
from repro_torch.core import stats as stats_mod
from repro_torch.core import types as T
from repro_torch.datasets import loaders
from repro_torch.events import EventConfig
from repro_torch.grid import signals as gsig
from repro_torch.launch import env as launch_env
from repro_torch.ml.pipeline import MLSchedulerModel, attach_scores
from repro_torch.ml.train import load_alpha
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


def _trace_digests(args) -> dict:
    """Content digests of the real traces feeding this run, for the
    manifest: empty when the run is fully synthetic."""
    from repro_torch.traces import source_digest
    out = {}
    if args.trace:
        out["trace_digest"] = source_digest(*args.trace)
    if args.weather_trace:
        out["weather_trace_digest"] = source_digest(args.weather_trace)
    return out


def main(argv=None):
    argv = list(sys.argv[1:]) if argv is None else list(argv)
    if argv[:1] == ["train"]:
        # policy-training subcommand (repro_torch.ml.train): ES over
        # batched twin rollouts; everything after "train" is its own
        # arg set
        from repro_torch.ml import train as ml_train
        ml_train.main(argv[1:])
        return 0
    if argv[:1] == ["serve"]:
        # twin as a service (repro_torch.serve, docs/serving.md): a
        # persistent session with snapshot and fork over a socket
        from repro_torch.serve import cli as serve_cli
        return serve_cli.main(argv[1:])
    if argv[:1] == ["calibrate"]:
        # cooling-plant calibration against recorded telemetry
        # (repro_torch.traces.calibrate, docs/datasets.md)
        from repro_torch.traces import calibrate as calibrate_cli
        return calibrate_cli.main(argv[1:])
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--system", default="marconi100")
    ap.add_argument("--scale", type=int, default=0,
                    help="scale the system to N nodes")
    ap.add_argument("--halls", type=int, default=0,
                    help="split the cooling plant into N halls")
    ap.add_argument("--cells-offline", default=None,
                    help="tower cells out for maintenance: a number "
                         "(every hall) or comma list (per hall), e.g. "
                         "'2,0,0,0'")
    ap.add_argument("--jobs", type=int, default=1000)
    ap.add_argument("--days", type=float, default=None,
                    help="dataset horizon to generate (days)")
    ap.add_argument("-ff", "--fastforward", default="0", type=str,
                    help="simulation start offset (s/m/h/d suffix)")
    ap.add_argument("-t", "--time", default="6h", type=str,
                    help="simulated duration (s/m/h/d suffix)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--smoke", action="store_true",
                    help="CI-sized run: scale to 64 nodes, <=48 jobs, "
                         "30 minutes simulated")
    # real-trace ingestion (repro_torch.traces, docs/datasets.md)
    ap.add_argument("--trace", nargs="+", default=None, metavar="PATH",
                    help="replace the synthetic --system dataset with a "
                         "real trace: one job table (.parquet/.csv), one "
                         "cached trace .npz, or a joblive dir followed by "
                         "a jobprofile dir (RAPS-style telemetry)")
    ap.add_argument("--trace-cache", default=None, metavar="DIR",
                    help="content-addressed NPZ cache directory for "
                         "parsed telemetry (repeat runs skip the CSVs)")
    ap.add_argument("--replay-power", action="store_true",
                    help="replay measured per-node power profiles from "
                         "the trace instead of the power model (jobs "
                         "without a measurement keep the model)")
    ap.add_argument("--weather-trace", default=None, metavar="FILE",
                    help="measured weather CSV/NPZ (timestamp + wet-bulb "
                         "or dry-bulb/RH) driving the cooling tower "
                         "ambient (repro_torch.traces.weather)")
    ap.add_argument("--scheduler", default="default",
                    choices=["default", "experimental", "fastsim",
                             "scheduleflow"])
    ap.add_argument("--policy", default="replay")
    ap.add_argument("--backfill", default=None,
                    help="backfill mode (default: none for built-in "
                         "schedulers, firstfit for external peers; an "
                         "explicit value always wins)")
    ap.add_argument("--sweep", nargs="*", default=None,
                    help="policy[:backfill] list to run as one batch on "
                         "--device")
    ap.add_argument("--accounts", action="store_true",
                    help="write each run's account ledger as "
                         "accounts.json under -o (the collect phase of an "
                         "incentive)")
    ap.add_argument("--accounts-json", default=None, metavar="FILE",
                    help="warm-start the ledgers from this accounts.json "
                         "(the redeem phase)")
    ap.add_argument("--ml-alpha", default=None,
                    help="scoring alpha for --policy ml: a training "
                         "checkpoint JSON or comma floats, e.g. "
                         "'1.2,0.8,1.1,0.3'")
    ap.add_argument("-o", "--output", default=None, nargs="?",
                    const="simulation_results",
                    help="write history.npz, stats.out, job_history.csv "
                         "(and accounts.json) into one directory a run "
                         "under this one")
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
    ap.add_argument("--external-cmd", default=None,
                    help="couple an out-of-process scheduler: spawn this "
                         "command as a subprocess peer (socket wire "
                         "protocol, docs/external-scheduling.md), e.g. "
                         "'python -m tools.reference_peer'")
    ap.add_argument("--external-socket", default=None,
                    help="couple a peer already listening at unix:/path "
                         "or host:port (see tools/reference_peer.py "
                         "--listen)")
    ap.add_argument("--external-mode", default="plugin",
                    choices=["plugin", "sequential"],
                    help="coupling mode for --external-cmd/--external-"
                         "socket (paper §4.2: per-step polling vs "
                         "schedule-then-replay)")
    ap.add_argument("--external-wire", default="auto",
                    choices=("auto", "ndjson", "binary"),
                    help="wire dialect for the external peer: auto "
                         "upgrades to binary frames when the peer "
                         "advertises the capability, ndjson pins the "
                         "legacy dialect, binary demands it")
    ap.add_argument("--external-timeout", type=float, default=30.0,
                    help="per-poll wall budget (s) for the external "
                         "bridge; also the socket recv timeout")
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

    if args.smoke:
        args.scale = args.scale or 64
        args.jobs = min(args.jobs, 48)
        args.time = "30m"
    sys_ = build_system(args.system, args.scale, args.halls)
    cells_offline = 0.0
    if args.cells_offline:
        parts = [float(x) for x in args.cells_offline.split(",")]
        cells_offline = parts[0] if len(parts) == 1 else tuple(parts)
    t0 = _parse_time(args.fastforward)
    t1 = t0 + _parse_time(args.time)
    days = args.days or max((t1 / 86400.0) * 1.25, 0.5)
    if args.trace:
        js = loaders.load_trace(args.trace, prof_dt=sys_.prof_dt,
                                cache_dir=args.trace_cache)
    else:
        js = loaders.load(args.system, n_jobs=args.jobs, days=days,
                          seed=args.seed)
    weather = None
    if args.weather_trace:
        from repro_torch.traces.weather import load_weather
        weather = load_weather(args.weather_trace,
                               int(round((t1 - t0) / sys_.dt)), sys_.dt,
                               t0=t0)
    if args.policy == "ml":
        # the alpha is baked into the static score, so every engine path
        # ranks alike
        model = MLSchedulerModel.fit(js, k=5, alpha=_ml_alpha(args.ml_alpha))
        attach_scores(js, model)
    js.assign_prepop_placement(t0, sys_.n_nodes)
    table = js.to_table(replay_power=args.replay_power)
    accounts = None
    if args.accounts_json:
        accounts = acct_mod.load_json(args.accounts_json, args.device)
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
            scenario={"policy": args.policy,
                      "backfill": args.backfill or "none",
                      "scheduler": args.scheduler, "sweep": args.sweep,
                      "external_cmd": args.external_cmd,
                      "external_socket": args.external_socket,
                      "external_mode": args.external_mode,
                      "external_wire": args.external_wire,
                      "halls": args.halls,
                      "cells_offline": args.cells_offline,
                      "failure_rate_per_day": args.failure_rate,
                      "failure_seed": args.failure_seed,
                      "dr_cap_mw": args.dr_cap_mw, "device": args.device,
                      "trace": args.trace,
                      "replay_power": args.replay_power,
                      "weather_trace": args.weather_trace,
                      "t0_s": t0, "duration_s": t1 - t0},
            seed=args.seed, jobs=js,
            extra={"env_preset": launch_env.report(
                "sweep" if args.sweep else "throughput"),
                # content digests pin exactly which trace bytes produced
                # this run
                **_trace_digests(args)})
        recorder.event("run_start")
    timer = obs.SpanTimer(listener=recorder.span_listener
                          if recorder else None)
    profiler = _start_profile(args) if args.profile else None

    wall0 = time.perf_counter()
    with obs.use(timer):
        runs, bridge = _run(args, sys_, js, table, accounts, t0, t1,
                            cells_offline, fail_kw, signals, events, weather,
                            recorder.span_listener if recorder else None)
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
        if args.output:
            out = _write_output(args, js, final, hist, s)
            rep.info(f"output -> {out}")
            rep.result_json("output_dir", str(out))
    if sink is not None:
        sink.close()
        rep.info(f"metrics: {sink.n_frames} frames -> {args.metrics}")
    if bridge is not None:
        rep.result_json("bridge", bridge.stats())
    if recorder is not None:
        recorder.event("run_end", wall_s=wall)
        counters = {}
        if bridge is not None:
            counters["bridge"] = bridge.stats()
        if sink is not None:
            counters["metrics_frames"] = sink.n_frames
        recorder.finalize(spans=timer.summary(), counters=counters,
                          wall_s=wall, summaries=summaries)
        rep.info(f"manifest -> {args.manifest}" if args.manifest
                 else f"events -> {args.events}")
    rep.flush_json()


def _ml_alpha(spec: str | None):
    """``--ml-alpha``: a training checkpoint JSON when such a file exists,
    else comma floats; None keeps the pipeline's default alpha."""
    if not spec:
        return None
    if pathlib.Path(spec).exists():
        return load_alpha(spec)
    return np.asarray([float(x) for x in spec.split(",")], np.float32)


def _write_output(args, js, final, hist, summary) -> pathlib.Path:
    """One run's files in a new directory under ``--output``, as the JAX
    CLI writes them: ``history.npz`` (every telemetry row), ``stats.out``,
    ``job_history.csv`` and, with ``--accounts``, ``accounts.json``."""
    out = pathlib.Path(args.output) / secrets.token_hex(4)
    out.mkdir(parents=True, exist_ok=True)
    host = lambda x: x.detach().cpu().numpy()
    np.savez(out / "history.npz",
             **{f.name: host(getattr(hist, f.name))
                for f in dataclasses.fields(hist)})
    (out / "stats.out").write_text(stats_mod.format_stats(summary))
    start, end, jstate = host(final.start), host(final.end), host(final.jstate)
    with open(out / "job_history.csv", "w") as f:
        f.write("job,submit,start,end,nodes,account,state\n")
        for j in range(len(js)):
            f.write(f"{j},{js.submit[j]:.0f},{start[j]:.0f},{end[j]:.0f},"
                    f"{js.nodes[j]},{js.account[j]},{jstate[j]}\n")
    if args.accounts:
        acct_mod.save_json(final.accounts, out / "accounts.json")
    return out


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


def _run(args, sys_, js, table, accounts, t0, t1, cells_offline, fail_kw,
         signals, events, weather, on_event=None):
    """One CLI invocation on the engine. Returns (runs, bridge): ``runs``
    a list of ((policy, backfill), final, hist), one per scenario, and
    ``bridge`` the ``SchedulerBridge`` of an external coupling in plugin
    mode (its counters feed the manifest), else None. ``accounts`` (a
    warm-start ledger, --accounts-json) reaches every built-in engine
    path, and ``cells_offline`` every path. ``weather`` (a measured
    trace, --weather-trace, or None) drives every scenario's towers; the
    external couplings model no ambient conditions, so combining them
    with a weather trace is refused, not ignored."""
    external = args.scheduler in ("fastsim", "scheduleflow")
    if weather is not None and (args.external_cmd or args.external_socket
                                or external):
        raise SystemExit("--weather-trace is not supported with external "
                         "scheduler coupling")
    # the external peer is the policy; the facility knobs reach the twin
    ext_scen = T.Scenario.make("replay", cells_offline=cells_offline)
    if args.external_cmd or args.external_socket:
        return _run_peer(args, sys_, js, t0, t1, ext_scen, on_event)
    if external:
        bridge = None
        if args.scheduler == "fastsim":
            sched = ext.FastSimLike(policy=args.policy
                                    if args.policy != "replay" else "fcfs")
            final, hist = ext.run_sequential_mode(sys_, js, sched, t0, t1,
                                                  scen=ext_scen,
                                                  device=args.device)
        else:
            # explicit bridge so its poll counters reach the manifest
            bridge = ext.SchedulerBridge(ext.ScheduleFlowLike(),
                                         on_event=on_event)
            final, hist, _ = ext.run_plugin_mode(sys_, js, bridge, t0, t1,
                                                 scen=ext_scen,
                                                 device=args.device)
            hist = _record(hist)
        return [((args.policy, "external"), final, hist)], bridge
    kw = dict(signals=signals, weather=weather, events=events)
    if args.sweep:
        specs = [(p, b or "none") for p, _, b in
                 (s.partition(":") for s in args.sweep)]
        # one device: exactly simulate_sweep there (a split across
        # cards issues the same launches from this one host thread)
        finals, hists = eng.simulate_sweep_sharded(
            sys_, table, [T.Scenario.make(p, b, cells_offline=cells_offline,
                                          **fail_kw) for p, b in specs],
            t0, t1, accounts, **kw, devices=[args.device])
        return [(spec, T.row(finals, i), T.row(hists, i))
                for i, spec in enumerate(specs)], None
    # one scenario; with every knob neutral this is simulate_static
    backfill = args.backfill or "none"
    scen = T.Scenario.make(args.policy, backfill, cells_offline=cells_offline,
                           **fail_kw)
    final, hist = eng.simulate(sys_, table, scen, t0, t1, accounts, **kw,
                               device=args.device)
    return [((args.policy, backfill), final, hist)], None


def _run_peer(args, sys_, js, t0, t1, scen, on_event):
    """An out-of-process peer (--external-cmd or --external-socket) in
    plugin or sequential mode, the facility knobs from ``scen``; returns
    ``_run``'s (runs, bridge)."""
    from repro_torch.core import transport as tr
    policy = args.policy if args.policy != "replay" else "fcfs"
    # an explicit --backfill (none included) reaches the peer; only the
    # unset default maps to FastSimLike's firstfit
    kw = dict(policy=policy, backfill=args.backfill or "firstfit",
              timeout_s=args.external_timeout, wire=args.external_wire)
    peer = tr.SubprocessPeer(cmd=args.external_cmd, **kw) \
        if args.external_cmd else \
        tr.SocketPeer(address=args.external_socket, **kw)
    bridge = None
    try:
        if args.external_mode == "sequential":
            # one-shot coupling: the peer is driven directly (the
            # bridge's poll retries have nothing to wrap here)
            final, hist = ext.run_sequential_mode(sys_, js, peer, t0, t1,
                                                  scen=scen,
                                                  device=args.device)
        else:
            bridge = ext.SchedulerBridge(
                peer, ext.BridgeConfig(timeout_s=args.external_timeout),
                on_event=on_event)
            final, hist, _ = ext.run_plugin_mode(sys_, js, bridge, t0, t1,
                                                 scen=scen,
                                                 device=args.device)
            hist = _record(hist)
    finally:
        peer.close()
    return [((policy, f"external:{args.external_mode}"), final, hist)], \
        bridge


def _record(hist: dict) -> T.StepRecord:
    """Plugin mode's history (numpy arrays by field) as a ``StepRecord``
    of tensors, which the summary and the metrics stream read."""
    return T.StepRecord(**{k: torch.from_numpy(v) for k, v in hist.items()})


if __name__ == "__main__":
    sys.exit(main())
