"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds every Hopper kernel of the port from the sources in this checkout
(one ``nvcc`` per source, all at once), holds each against its plain
PyTorch version on the card and times it, then drives the port's paths
through their entry points at full width and checks what comes out:

* ``frontier-sweep-2h``, the no-grid Frontier scenario sweep (9,600
  nodes, 25 CDU groups, 1,238 jobs, 8 scenarios; 2 h = 480 steps, cut
  from 6 h for the script's time), which runs the fused cooling kernel
  once a step (its rows are held to solo runs on the other paths);
* ``frontier-grid-6h``, the grid path: the same machine and backlog
  under synthetic carbon, price and power-cap signals (the evening cap
  dip in the last 3 h), 12 (cap level x policy x weight) scenarios, which
  runs the group-power kernel once a step; row 0 equals a solo run bit
  for bit over all 6 h, the cap binding in the dip;
* ``frontier-events-6h``, the grid path again under weather, failures
  and demand response: ``frontier-grid-6h``'s machine, backlog and
  signals, 8 (policy x summer trace or heat wave x failure seed and
  rates) scenarios with node, CDU-group and tower-cell failures and a
  demand-response cap step, one group-power launch a step (the sweep
  and its solo run cover 4 h, cut from 6 h, with the DR event, the
  whole heat wave (1-4 h) and the cap dip's first hour inside; a solo
  run with the events at zero rates is held to the grid sweep's row 0
  over all 6 h, the cap dip where ``enforce_cap`` binds included); and
  the same scenarios for 30 min without signals or DR, one fused
  cooling launch a step;
* ``frontier-session-2h``, the what-if session (``repro_torch.serve``):
  a ``TwinSession`` on ``frontier-grid-6h``'s machine, backlog and
  signals with the event layer at zero rates, in intervals of 60 steps;
  the root advances alone to 1 h, is forked there into a neutral, a
  setpoint, a demand-response and a failure branch, and all five advance
  as one batch to 2 h, one group-power launch a batched step. Segment
  resume, the neutral fork, coalescing and the snapshot codec are held
  bit for bit (against one uninterrupted scan, the parent, the branch
  advanced alone, a resume from a decoded snapshot);
* the twin service on the wire (``repro_torch.serve.TwinServer``): the
  same session served from the card over a Unix socket and driven by
  the stdlib client ``tools/twin_client``: the root to 1 h one interval
  a request, the four forks, then five client threads advancing the
  five branches at once to 1.5 h. Every branch's rows and its 1.5 h
  checkpoint's digest over the wire equal the in-process session's bit
  for bit, group-power launches equal the steps the executor
  dispatched, broken speech and an unknown branch get their error
  envelopes, and the ledger is closed after ``close()``; then the CLI's
  ``serve`` subcommand at Frontier's width, as a process;
* ``fugaku-sweep-2h``, the no-grid sweep at Fugaku's full width (158,976
  nodes, 32 CDU groups, 4,000 jobs, 120 steps of 60 s, 8 scenarios),
  whose fused cooling launches give each group's span of 4,968 nodes
  to one CTA of 512 threads;
* ``frontier-replay-2h``, measured-power replay (``repro_torch.traces``):
  the Frontier loader's day with whole-second times and a seeded
  measured per-node power channel for two thirds of the jobs, written
  as a trace NPZ and read back by ``load_trace``, packed with compact
  (int32) time columns, under the repo's measured weather week (read
  with the stdlib, loaded from an NPZ); fig4's four (policy, backfill)
  pairs at setpoint +0 and +2 °C, 8 scenarios, 2 h (cut from 6 h), one
  fused cooling launch a step. Row 0 = solo, and on the first half hour
  an all-sentinel channel = the model table and compact time = float32
  time, bit for bit; then the CLI's ``--trace --replay-power
  --weather-trace`` as a process;
* cooling-plant calibration (``repro_torch.traces.calibrate``) over
  the committed 8,640-step fixture: the graphed rollout against the
  eager loop bit for bit, the card against the CPU, then ``simulate
  calibrate --out`` and ``--check`` as processes on a 2,880 step window
  of the fixture (cut for the script's time), whose fit must recover the
  fixture's true parameters within 2 %;
* ``ml-fugaku-train`` and ``ml-fugaku-36h``, the ML-guided scheduler
  (``repro_torch.ml``) with ``benchmarks/fig10_ml.py``'s setup on Fugaku
  scaled to 32,768 nodes: the pipeline (k-means, an 8-tree forest,
  per-cluster ridge) fitted on the host on a 4,000-job 14-day history;
  ES training of its alpha (``repro_torch.ml.train``): ``simulate train
  --smoke``'s first two generations on the card against the same CLI
  with ``--device cpu`` as a process, their checkpoints' means and elite
  bit for bit, then fig10's closed loop on its 800-job validation
  backlog over 0.25 day (360 steps), population 8, 4 generations
  (fig10's ``--quick`` count), each one sweep of 10 rows, one fused
  cooling launch a step, a checkpoint each, the elite no worse than the
  default alpha;
  then the scoring basis of a 1,500-job high-load backlog in the table,
  fig10's five policies (fcfs, sjf, priority, ljf, ml at the model's
  alpha) and the trained alpha as one sweep over fig10's own 1.5 days
  (2,160 steps; the backlog queues after its first 12 h), one fused
  cooling launch a step, the ml row starting its jobs otherwise than
  every other policy's row and equal to a solo run bit for bit; then the
  CLI's ``--policy ml --ml-alpha <the trained checkpoint>`` on fig8's
  Marconi100 backlog for 2 h as a process, equal to the same argv in
  process;
* fig7's external schedulers (``repro_torch.core.external``) on Frontier
  at full width with ``benchmarks/fig7_external.py``'s backlog (5,324
  synthetic jobs over 15 days, load 0.9): FastSimLike's whole schedule
  and the reference peer's (``tools/reference_peer.py`` through a
  ``SubprocessPeer``) equal exactly; sequential mode replaying the first
  3 h (cut from 24 h); plugin mode for fig7's 6 h in process and
  through the peer (binary frames), equal bit for bit, and over NDJSON
  for the first hour;
  ``external_step`` under frontier-grid-6h's signals for 1 h with a cap
  that binds; one fused cooling launch a step without signals, one
  group-power launch a step with them; then the CLI's ``--scheduler
  fastsim`` and ``--external-cmd`` (plugin) as processes;
* ``marconi100-incentives-3h``, fig8's collect-then-redeem incentive
  workflow (``benchmarks/fig8_incentives.py``'s 1,500-job backlog on
  Marconi100 at full width, 3 h, cut from 6 h) through the CLI as two
  processes: a
  replay that writes its ledger (``--accounts -o``), then the four
  acct_* policies under first-fit warm-started from it
  (``--accounts-json``), each row's start times held against the same
  sweep run in process from empty ledgers (one fused cooling launch a
  step) and fig8's favored-start advantage printed; then the CLI's
  ``--halls 4 --cells-offline 2,0,0,0 -ff 6h -t 30m --sweep ... -o`` at
  Frontier's width as a process, and ``simulate_sweep_sharded`` on one
  card (two chunks, and every visible card) against ``simulate_sweep``
  bit for bit over 15 min;
* LM serving (``repro_torch.launch.serve_lm``) of qwen2.5-3b, rwkv6-7b
  and zamba2-7b at full width, one after another: 4 prompts of 512
  tokens and 16 greedy decode steps, whose prefills run the flash
  attention, WKV and SSD kernels, with a float32 self-check of each and
  the bf16 prefill's logits held to the float32 prefill's; then
  mixtral-8x7b (8 experts top-2 in every layer) at full width, cut to 8
  of its 32 layers (the float32 model is 186.8 GB), through
  ``serve_lm.generate`` the same way: its float32 prefill against its
  float32 forward, its bf16 prefill against a float32 prefill that
  replays the bf16 routes (the dense archs' bound), ``route_topk`` on
  bf16 logits full of exact ties and padded rows, and one MoE layer in
  float32 with capacity binding, each on the card against the CPU (the
  routing equal exactly);

and a small card-against-CPU check of each path (the two MoE smoke
archs beside the three LM smoke archs; with weather and
failures on, also of the event layer's draws; a small session too; the
SWF fixture replayed with failures; plugin and sequential mode; the
incentive workflow through the CLI; an ml sweep under scalar and vector
alphas, after the baked score is held to the basis with alpha bit for
bit). The
trace and calibration phases must not import pandas or pyarrow. Before the paths, each
kernel is held to its plain version at the paths' shapes and ragged ones
and timed (CUDA graph, eager, host enqueue, the launch floor; for the
power-topology kernels also at Fugaku's width), and the power-topology
kernels' sums are shown to be bit for bit independent of the batch and
of the load width. Any failed phase exits
non-zero; nothing is caught and passed over. The last line is the JSON
device record; the line before it lists the kernels with their
launches, errors and times.

Exits non-zero without printing a result when no CUDA card is visible,
or when the ``src/repro_torch`` package is not beside this script.
"""
from __future__ import annotations

import contextlib
import csv
import dataclasses
import importlib.util
import io
import json
import logging
import os
import pathlib
import re
import socket
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke: torch.cuda.is_available() is False; this smoke "
             "run needs an NVIDIA card")

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

from repro_torch import kernels  # noqa: E402
from repro_torch.core import engine as eng  # noqa: E402
from repro_torch.core import external as ext  # noqa: E402
from repro_torch.core import scheduler as sched  # noqa: E402
from repro_torch.core import stats as stats_mod  # noqa: E402
from repro_torch.core import transport as tr  # noqa: E402
from repro_torch.core import types as T  # noqa: E402
from repro_torch.cooling import model as cooling  # noqa: E402
from repro_torch.cooling import weather as wsig  # noqa: E402
from repro_torch.datasets import loaders  # noqa: E402
from repro_torch.datasets import swf  # noqa: E402
from repro_torch.datasets.synthetic import WorkloadSpec, generate  # noqa: E402
from repro_torch.events import EventConfig  # noqa: E402
from repro_torch.grid import signals as gsig  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ref as fa_ref  # noqa: E402
from repro_torch.kernels.mamba2_ssd import mamba2_ssd  # noqa: E402
from repro_torch.kernels.mamba2_ssd import ops as ssd_ops  # noqa: E402
from repro_torch.kernels.mamba2_ssd import ref as ssd_ref  # noqa: E402
from repro_torch.kernels.power_topo import ops as topo_ops  # noqa: E402
from repro_torch.kernels.power_topo import power_topo  # noqa: E402
from repro_torch.kernels.power_topo import ref as topo_ref  # noqa: E402
from repro_torch.kernels.rwkv6_wkv import ops as wkv_ops  # noqa: E402
from repro_torch.kernels.rwkv6_wkv import ref as wkv_ref  # noqa: E402
from repro_torch.kernels.rwkv6_wkv import rwkv6_wkv  # noqa: E402
from repro_torch.launch import serve_lm  # noqa: E402
from repro_torch.launch.simulate import build_system  # noqa: E402
from repro_torch.ml import train as ml_train  # noqa: E402
from repro_torch.ml.pipeline import (MLSchedulerModel,  # noqa: E402
                                     attach_basis, attach_scores)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import common as model_common  # noqa: E402
from repro_torch.models import mlp as model_mlp  # noqa: E402
from repro_torch.models import rwkv6  # noqa: E402
from repro_torch.models.zoo import get_api  # noqa: E402
from repro_torch.serve import TwinSession  # noqa: E402
from repro_torch.serve import snapshot as snap  # noqa: E402
from repro_torch.systems.config import FacilityTopology, get_system  # noqa: E402
from repro_torch import traces  # noqa: E402
from repro_torch.traces import calibrate as cal  # noqa: E402

DEV = torch.device("cuda")
HBM_BYTES_S = 3.35e12        # H100 SXM device memory rate (data sheet)
F32_FLOP_S = 67e12           # H100 SXM float32 rate outside tensor cores
BF16_FLOP_S = 989e12         # H100 SXM dense bf16 tensor-core rate
KERNEL_TOL = 1e-4            # rtol = atol: the reference's own kernel bound
GROUP_RTOL, GROUP_ATOL = 1e-5, 1e-3   # group sums: the reference's rtol, 1 mW
SWEEP = [("fcfs", "easy"), ("fcfs", "none"), ("sjf", "first-fit"),
         ("ljf", "easy"), ("priority", "first-fit"),
         ("acct_fugaku_pts", "easy"), ("thermal_aware", "easy"),
         ("replay", "none")]
FRONTIER_T1 = 6 * 3600.0     # the CLI's default window
# frontier-sweep-2h's window: cut from 6 h to 2 h (480 steps) to keep
# the script's time (the cell was -6h, then -3h)
SWEEP_T1 = 2 * 3600.0
ADMIT_WINDOW = 240           # steps of the synchronised admission reruns
FUGAKU_T1 = 2 * 3600.0       # 120 steps at Fugaku's dt = 60 s
# frontier-grid-6h: benchmarks/fig_carbon.py's cap levels and carbon
# weights under first-fit, plus price_aware and two EASY rows
CAP_SCALES = [1.0, 0.85, 0.7]
CARBON_WEIGHTS = [0.0, 2.0, 8.0]
GRID_SWEEP = [("fcfs" if w == 0.0 else "carbon_aware", "first-fit",
               dict(carbon_weight=w, cap_scale=cs))
              for cs in CAP_SCALES for w in CARBON_WEIGHTS] + [
    ("price_aware", "first-fit", dict(price_weight=4.0, cap_scale=0.85)),
    ("fcfs", "easy", dict(cap_scale=0.7)),
    ("carbon_aware", "easy", dict(carbon_weight=2.0, cap_scale=0.7))]
GRID_T0_CLOCK = 14 * 3600.0  # signal clock 14:00-20:00: the 17-21 h dip
# frontier-events-6h: two policies x (the summer trace, the same with an
# 8 °C heat wave from 1 h to 4 h) x (seed 1 at the base failure rates,
# seed 2 at 4x them), under a demand-response event announced at 1 h
# with 30 min notice, holding 1 h at 0.6 of peak IT power
EVENT_POLICIES = [("fcfs", "first-fit"), ("sjf", "easy")]
BASE_RATES = dict(node_fail_rate=5e-7, cdu_fail_rate=2e-5,
                  cell_fail_rate=2e-5)
EVENT_FAILURES = [
    dict(BASE_RATES, failure_seed=1.0, failure_corr=0.25, repair_s=3600.0),
    dict({k: 4.0 * v for k, v in BASE_RATES.items()}, failure_seed=2.0,
         failure_corr=0.25, repair_s=3600.0)]
DR_AT = dict(dr_announce_s=3600.0, dr_notice_s=1800.0, dr_duration_s=3600.0)
DR_CAP_FRAC = 0.6
EVENTS_NOGRID_T1 = 1800.0    # the no-grid events run: 120 steps
# the events sweep and its solo run: 4 h = 960 steps (cut from 6 h for
# the script's time; the DR event, the whole heat wave (1-4 h) and the
# cap dip's first hour lie inside it, and the zero-rate identity still
# runs the whole 6 h)
EVENTS_T1 = 4 * 3600.0
# frontier-session-2h: a what-if session on frontier-grid-6h's machine,
# backlog and signals, in 15 min intervals; the root runs alone to 1 h,
# where four forks branch off, then all five advance together to 2 h
SESSION_INTERVAL = 60
SESSION_T1 = 2 * 3600.0
SESSION_FORK_AT = 4          # intervals: step 240, t = 1 h
# the wire phase serves the same tree to step 360: five clients advance
# the five branches 2 intervals at once
WIRE_ADVANCE = 2

# frontier-replay-2h: fig4's four (policy, backfill) pairs
# (benchmarks/fig4_pm100.py) at two supply setpoints, on the Frontier day
# with a measured power channel for two thirds of the jobs, under the
# repo's measured weather week
FIG4 = [("replay", "none"), ("fcfs", "none"), ("fcfs", "easy"),
        ("priority", "first-fit")]
REPLAY_SWEEP = [(p, b, d) for d in (0.0, 2.0) for p, b in FIG4]
REPLAY_SEED = 25
REPLAY_WINDOW = 120          # steps of the bit-for-bit identity checks
REPLAY_T1 = 2 * 3600.0       # the replay sweep and its solo run: 480 steps
# calibration: tests/test_calibrate.py's recovery tolerance, and the CPU
# parity test's per-step tolerance (tests/test_torch_calibrate.py)
CAL_DIR = ROOT / "tests" / "data" / "calibration"
CAL_RECOVERY = 0.02
CAL_STEP_RTOL = 1e-5
CAL_CHANNELS = ("t_basin_c", "t_supply_c", "t_return_c", "pue")
# the calibrate subcommand's window of the fixture: 2,880 of its 8,640
# steps (cut for the script's time; the in-process fit takes all of it)
CAL_CLI_WINDOW = slice(2880, 5760)
# the reference's test_replay_composes_with_events scenario
KILL = dict(failure_seed=3.0, node_fail_rate=5e-4, cdu_fail_rate=2e-5,
            failure_corr=0.5, repair_s=900.0)

def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    return out.stdout.strip().splitlines()[0]

def cuda_ms(fn, iters: int = 200, warmup: int = 20) -> float:
    """Mean milliseconds per eager call of ``fn`` (CUDA events): what a
    caller pays per call, host launch overhead included."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters

def graph_ms(fn, iters: int = 100, reps: int = 10) -> float:
    """Mean milliseconds per call of ``fn`` on the card alone: ``iters``
    calls captured in one CUDA graph and replayed, so no host overhead is
    counted. Inputs stay in the 50 MB L2 between calls, as they do on the
    main path (the node powers are written just before the kernel)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        graph.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / (reps * iters)

def cooling_inputs(S, N, G, H, seed):
    g = torch.Generator(device=DEV).manual_seed(seed)
    u = lambda lo, hi, shape: lo + (hi - lo) * torch.rand(
        shape, generator=g, device=DEV)
    return (u(700.0, 3200.0, (S, N)), u(28.0, 40.0, (S, G)),
            u(12.0, 60.0, (S, G)), u(18.0, 30.0, (S, H)), u(30.0, 34.0, (S,)))

def check_kernel(label, sysc, S, N, G, H, seed):
    """Kernel vs plain version at one shape; returns the max abs error."""
    hog = FacilityTopology(n_halls=H).hall_of_group(G)
    p = cooling.cdu_params(sysc.cooling, sysc.dt)
    args = cooling_inputs(S, N, G, H, seed)
    got = topo_ops.fused_cooling_hier(*args, hog, G, p)
    torch.cuda.synchronize()
    want = topo_ref.fused_cooling_hier_ref(*args, hog, G, p)
    torch.cuda.synchronize()
    err = 0.0
    for name, a, b in zip(("q", "t_return", "t_supply", "mdot", "q_hall"),
                          got, want):
        if a.shape != b.shape or not torch.isfinite(a).all():
            raise SystemExit(f"fused_cooling {label}: {name} bad output")
        torch.testing.assert_close(a, b, rtol=KERNEL_TOL, atol=KERNEL_TOL,
                                   msg=lambda m: f"{label} {name}: {m}")
        err = max(err, float((a - b).abs().max()))
    print(f"kernel fused_cooling {label} S={S} N={N} G={G} H={H}: "
          f"max_abs_err={err!r} (rtol=atol={KERNEL_TOL})")
    return err

def check_order(label, sysc, S, N, G, seed):
    """Both power-topology kernels sum in an order fixed by (N, G): row i
    of a batch gives the bits of that row alone, and scalar loads (node
    powers off a 16-byte boundary) give the bits of 128-bit loads. And
    their programmatic launch waits for the torch kernel that writes the
    node powers just before them (as on the engine path), eagerly and in
    a CUDA graph. Plain and split group sums and all four fused outputs,
    compared exactly."""
    idle = sysc.power.idle_node_w
    p = cooling.cdu_params(sysc.cooling, sysc.dt)
    x = 4.5 * idle * torch.rand((S, N), generator=gen(seed), device=DEV)
    _, ts, md, tb, tset = cooling_inputs(S, 1, G, 1, seed)
    tb = tb[:, 0]
    shifted = torch.empty(S * N + 1, device=DEV)[1:].view(S, N)
    shifted.copy_(x)

    def run(z, rows):
        return (topo_ops.group_power(z, G),
                *topo_ops.group_power_split(z, idle, G),
                *topo_ops.fused_cooling(z, ts[rows], md[rows], tb[rows],
                                        tset[rows], G, p))

    every = slice(0, S)
    base = run(x, every)
    for a, b in zip(base, run(shifted, every)):
        if not torch.equal(a, b):
            raise SystemExit(f"kernel order {label}: scalar loads differ "
                             f"from 128-bit loads")
    for i in sorted({0, S // 2, S - 1}):
        rows = slice(i, i + 1)
        for a, b in zip(base, run(x[rows], rows)):
            if not torch.equal(a[rows], b):
                raise SystemExit(f"kernel order {label}: row {i} of {S} "
                                 f"differs from the row alone")
    # behind a torch kernel (not a copy: a programmatic launch relaxes
    # the order only after a kernel) that writes the powers the kernels
    # then read, which they must wait for: scaled powers, the bits of a
    # run on powers written long before
    src, staged = x.clone(), torch.empty_like(x)
    scale = 0.5                    # a power of two: exact products
    want = run((x * scale).contiguous(), every)
    torch.cuda.synchronize()

    def produced():
        torch.mul(src, scale, out=staged)
        return run(staged, every)

    staged.zero_()
    for a, b in zip(produced(), want):
        if not torch.equal(a, b):
            raise SystemExit(f"kernel order {label}: a launch behind the "
                             f"kernel writing the powers differs from a "
                             f"run on powers written before")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        produced()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replayed = produced()
    src.copy_(x.flip(0))
    staged.zero_()
    graph.replay()
    for a, b in zip(replayed, run((x.flip(0) * scale).contiguous(), every)):
        if not torch.equal(a, b):
            raise SystemExit(f"kernel order {label}: a graph replay behind "
                             f"the kernel writing the powers differs from "
                             f"an eager run")
    torch.cuda.synchronize()
    print(f"kernel order {label} S={S} N={N} G={G} "
          f"({power_topo.plan(N, G)}): every row equals the row alone, "
          f"scalar loads equal 128-bit loads, and a launch behind the "
          f"torch kernel writing the powers (eager and replayed from a "
          f"graph) equals a run on powers written before, bit for bit, in "
          f"both kernels")

def build_phase():
    """Build every kernel from source, one nvcc per source, all at once."""
    t = time.perf_counter()
    libs = _build.build_all(power_topo.LIB, flash_attention.LIB,
                            rwkv6_wkv.LIB, mamba2_ssd.LIB)
    print(f"build: {', '.join(p.name for p in libs.values())} in "
          f"{time.perf_counter() - t:.2f} s (nvcc "
          f"{' '.join(_build.NVCC_FLAGS)})")
    for name, log in _build.build_logs.items():
        fn = ""   # the instantiation, e.g. "..._wkv_chunked_tcILi64E" (hd 64)
        for line in log.splitlines():
            if "Function properties for" in line:
                entry = re.search(r"(\w{0,24}I(?:Li\d+E)+)E", line)
                seg = re.search(r"(warp|cta)_kernelILb([01])E"
                                r"\w*?(FusedOp|GroupOpILb([01])E)", line)
                fn = entry[1] if entry else (
                    f"{seg[1]}_kernel vec={seg[2]}" +
                    (" fused" if seg[4] is None else f" split={seg[4]}")
                    if seg else "")
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name} {fn}:", line.strip())

def launch_floor_ms() -> float:
    """Device time of the least kernel: a one-element ``zero_()`` replayed
    from a CUDA graph, the floor a standalone launch cannot beat."""
    one = torch.empty(1, device=DEV)
    return graph_ms(lambda: one.zero_())

def enqueue_us(fn, calls: int = 1000) -> float:
    """Host microseconds per call of ``fn`` over ``calls`` calls with no
    synchronisation in between: what the caller's thread pays to enqueue
    the work (the card runs behind it)."""
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t) / calls * 1e6
    torch.cuda.synchronize()
    return us

def f32_bound(n_bytes, n_ops):
    """(ms, "bytes" | "operations") for float32 work outside the tensor
    cores."""
    tb, to = n_bytes / HBM_BYTES_S, n_ops / F32_FLOP_S
    return max(tb, to) * 1e3, ("bytes" if tb >= to else "operations")

def topo_timing(card, name, label, x, G, kernel, plain, library, n_bytes,
                n_ops):
    """Graph times of a power-topology kernel on node powers ``x``, its
    plain version and its library yardstick, beside the bound and the
    replaced design's time; the kernel also behind a torch kernel that
    writes ``x`` (its time over that kernel's alone: what a step pays
    after its producer). Returns the kernels-line numbers."""
    S, N = x.shape
    shape = f"S={S} N={N} G={G}"
    ms, plain_ms, lib_ms = graph_ms(kernel), graph_ms(plain), graph_ms(library)
    producer = lambda: x.mul_(1.0)
    after_ms = graph_ms(lambda: (producer(), kernel())) - graph_ms(producer)
    bound_ms, bound_by = f32_bound(n_bytes, n_ops)
    print(f"[{card}] {name} {label} {shape} on the card (CUDA graph): kernel "
          f"{ms!r} ms, plain {plain_ms!r} ms, library {lib_ms!r} ms, bound "
          f"{bound_ms!r} ms ({bound_by}: {n_bytes} B, {n_ops} ops), "
          f"{bound_ms / ms!r} of its bound; behind a torch kernel writing "
          f"the powers: {after_ms!r} ms more than it alone")
    before_ms, where = BEFORE_MS[(name, label)]
    print(f"[{card}] {name} {label}: before {before_ms!r} ms ({where}) -> "
          f"now {ms!r} ms, {before_ms / ms!r}x faster")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=bound_ms, bound_by=bound_by)

def fused_timing(card, label, sysc, S, N, G, seed):
    """``fused_cooling`` timed at one shape (one hall), with the library
    yardstick: one reduction over the same spans, without the CDU update
    (the port never calls it)."""
    p = cooling.cdu_params(sysc.cooling, sysc.dt)
    x, ts, md, tb, tset = cooling_inputs(S, N, G, 1, seed)
    tb_g = tb.expand(S, G)
    kernel = lambda: topo_ops.fused_cooling(x, ts, md, tb_g, tset, G, p)
    plain = lambda: topo_ref.fused_cooling_ref(x, ts, md, tb_g, tset, G, p)
    library = lambda: torch.sum(x.view(S, G, N // G), -1)
    n_bytes = 4 * (S * N + 4 * S * G + 4 * S * G)   # each input once, outputs once
    n_ops = S * N + 16 * S * G                       # adds + the CDU update
    t = topo_timing(card, "fused_cooling", label, x, G, kernel, plain,
                    library, n_bytes, n_ops)
    return t, kernel, plain, library

def kernel_phase(card):
    fr, fu = get_system("frontier"), get_system("fugaku")
    err = check_kernel("frontier", fr, 8, 9600, 25, 1, 1)
    check_kernel("frontier-5halls", fr, 8, 9600, 25, 5, 2)
    check_kernel("fugaku", fu, 8, 158976, 32, 1, 3)
    check_kernel("ragged", fr, 8, 9601, 25, 1, 4)
    check_kernel("marconi100", get_system("marconi100"), 8, 980, 10, 1, 7)
    check_kernel("empty last group", fr, 3, 9, 4, 1, 8)
    check_kernel("fugaku 4 halls", fu, 2, 158976, 32, 4, 9)
    check_order("frontier", fr, 12, 9600, 25, 16)
    check_order("fugaku", fu, 12, 158976, 32, 17)

    # timing at the main path's shape (Frontier, 8 scenarios, one hall)
    # and at Fugaku's width
    t, kernel, plain, library = fused_timing(card, "frontier", fr, 8, 9600,
                                             25, 5)
    fugaku, *_ = fused_timing(card, "fugaku", fu, 8, 158976, 32, 6)
    floor_ms = launch_floor_ms()
    eager = {name: cuda_ms(f) for name, f in
             (("kernel", kernel), ("plain", plain), ("torch.sum", library))}
    enqueue = {name: enqueue_us(f) for name, f in
               (("kernel", kernel), ("torch.sum", library))}
    print(f"[{card}] launch floor (one-element zero_, CUDA graph): "
          f"{floor_ms!r} ms; fused_cooling frontier {t['ms']!r} ms = floor "
          f"+ {t['ms'] - floor_ms!r} ms; fugaku {fugaku['ms']!r} ms")
    print(f"[{card}] fused_cooling per eager call, host included: "
          + ", ".join(f"{k} {v!r} ms" for k, v in eager.items()))
    print(f"[{card}] fused_cooling host enqueue per call (1,000 calls, no "
          f"synchronisation): "
          + ", ".join(f"{k} {v!r} us" for k, v in enqueue.items()))
    return dict(name="fused_cooling", route="cuda",
                source="src/repro_torch/kernels/power_topo/csrc/fused_cooling.cu",
                replaces="src/repro/kernels/power_topo/power_topo.py:91",
                launches=None, max_abs_err=err, **t)

def check_group_kernel(label, S, N, G, idle, seed):
    """Both modes of the group-power kernel against their plain versions
    at one shape; returns the max abs error. Node powers lie on both sides
    of the idle floor."""
    g = torch.Generator(device=DEV).manual_seed(seed)
    x = 4.5 * idle * torch.rand((S, N), generator=g, device=DEV)
    got = topo_ops.group_power(x, G)
    torch.cuda.synchronize()
    got_floor, got_dyn = topo_ops.group_power_split(x, idle, G)
    torch.cuda.synchronize()
    want = topo_ref.group_power_ref(x, G)
    want_floor, want_dyn = topo_ref.group_power_split_ref(x, idle, G)
    torch.cuda.synchronize()
    err = 0.0
    for name, a, b in (("plain", got, want), ("floor", got_floor, want_floor),
                       ("dyn", got_dyn, want_dyn)):
        if a.shape != (S, G) or not torch.isfinite(a).all():
            raise SystemExit(f"group_power {label}: {name} bad output")
        torch.testing.assert_close(a, b, rtol=GROUP_RTOL, atol=GROUP_ATOL,
                                   msg=lambda m: f"{label} {name}: {m}")
        err = max(err, float((a - b).abs().max()))
    print(f"kernel group_power {label} S={S} N={N} G={G} (plain and split): "
          f"max_abs_err={err!r} (rtol={GROUP_RTOL}, atol={GROUP_ATOL} W)")
    return err

def group_timing(card, label, S, N, G, idle, seed):
    """``group_power`` timed at one shape in the mode the grid path runs
    (split), with the library yardstick: clamp, subtract and two library
    reductions over the same spans (the port never calls it)."""
    g = torch.Generator(device=DEV).manual_seed(seed)
    x = 4.5 * idle * torch.rand((S, N), generator=g, device=DEV)
    kernel = lambda: topo_ops.group_power_split(x, idle, G)
    plain = lambda: topo_ref.group_power_split_ref(x, idle, G)
    view = x.view(S, G, N // G)

    def library():
        f = torch.clamp(view, max=idle)
        return f.sum(-1), (view - f).sum(-1)

    n_bytes = 4 * (S * N + 2 * S * G)       # node powers once, two outputs
    n_ops = 4 * S * N                       # min, subtract, two adds a node
    t = topo_timing(card, "group_power split", label, x, G, kernel, plain,
                    library, n_bytes, n_ops)
    return t, x, kernel, plain, library

def group_kernel_phase(card):
    fr, fu = get_system("frontier"), get_system("fugaku")
    idle = fr.power.idle_node_w
    err = check_group_kernel("frontier", 12, 9600, 25, idle, 11)
    check_group_kernel("fugaku", 8, 158976, 32, fu.power.idle_node_w, 12)
    check_group_kernel("ragged", 12, 9601, 25, idle, 13)
    check_group_kernel("marconi100", 12, 980, 10, idle, 18)
    check_group_kernel("empty groups", 3, 10, 8, idle, 19)
    check_group_kernel("one CTA, 9 rounds", 2, 70000, 1, idle, 20)

    # timing at the grid sweep's shape and at Fugaku's width
    S, N, G = len(GRID_SWEEP), fr.n_nodes, fr.cooling.n_groups
    t, x, kernel, plain, library = group_timing(card, "frontier", S, N, G,
                                                idle, 14)
    fugaku, *_ = group_timing(card, "fugaku", S, fu.n_nodes,
                              fu.cooling.n_groups, fu.power.idle_node_w, 15)
    plain_mode_ms = graph_ms(lambda: topo_ops.group_power(x, G))
    floor_ms = launch_floor_ms()
    eager = {name: cuda_ms(f) for name, f in
             (("kernel", kernel), ("plain", plain), ("library", library))}
    enqueue = {name: enqueue_us(f) for name, f in
               (("kernel", kernel), ("library", library))}
    print(f"[{card}] launch floor (one-element zero_, CUDA graph): "
          f"{floor_ms!r} ms; group_power split frontier {t['ms']!r} ms = "
          f"floor + {t['ms'] - floor_ms!r} ms; plain mode {plain_mode_ms!r} "
          f"ms; fugaku {fugaku['ms']!r} ms")
    print(f"[{card}] group_power per eager call, host included: "
          + ", ".join(f"{k} {v!r} ms" for k, v in eager.items()))
    print(f"[{card}] group_power host enqueue per call (1,000 calls, no "
          f"synchronisation): "
          + ", ".join(f"{k} {v!r} us" for k, v in enqueue.items()))
    return dict(name="group_power", route="cuda",
                source="src/repro_torch/kernels/power_topo/csrc/group_power.cu",
                replaces="src/repro/kernels/power_topo/power_topo.py:45",
                launches=None, max_abs_err=err, **t)

def frontier_case():
    system = get_system("frontier")
    js = loaders.load_frontier(n_jobs=1238)
    js.assign_prepop_placement(0.0, system.n_nodes)
    return system, js.to_table()

def check_run(label, final, hist, n_steps, S):
    util = hist.util
    if tuple(util.shape) != (S, n_steps) or not torch.isfinite(util).all():
        raise SystemExit(f"{label}: util has shape {tuple(util.shape)}")
    if not ((util >= 0) & (util <= 1)).all():
        raise SystemExit(f"{label}: utilization outside [0, 1]")
    pue = hist.pue
    if not torch.isfinite(pue).all() or not ((pue > 1.0) & (pue < 1.5)).all():
        raise SystemExit(f"{label}: PUE outside (1, 1.5): "
                         f"{float(pue.min())}..{float(pue.max())}")
    for name in ("power_it", "power_total", "t_tower_return", "t_basin"):
        if not torch.isfinite(getattr(hist, name)).all():
            raise SystemExit(f"{label}: non-finite {name}")

def run_counted(run):
    """Zero every kernel's launch count, run, and return (result, wall
    seconds, the counts of this run)."""
    for k in kernels.LAUNCHES:
        kernels.LAUNCHES[k] = 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t, dict(kernels.LAUNCHES)

def check_row_vs_solo(label, finals, hists, solo, row=0):
    """Sweep row ``row`` against a solo run of the same scenario:
    schedules exactly, every float series bit for bit (at rtol 1e-6
    first, so a miss says how far off it is)."""
    solo_f, solo_h = solo
    row_f, row_h = T.row(finals, row), T.row(hists, row)
    for name in ("jstate", "start", "end", "node_job"):
        if not torch.equal(getattr(solo_f, name), getattr(row_f, name)):
            raise SystemExit(f"{label}: sweep row {row} and the solo run "
                             f"disagree on {name}")
    identical = True
    for name, a in vars(solo_h).items():
        b = getattr(row_h, name)
        torch.testing.assert_close(a, b, rtol=1e-6, atol=0.0,
                                   msg=lambda m: f"{label} solo vs row "
                                   f"{row} {name}: {m}")
        identical &= torch.equal(a, b)
    print(f"{label}: sweep row {row} vs solo run: schedules equal, float "
          f"series within rtol 1e-6, bit-identical={identical}")
    if not identical:
        raise SystemExit(f"{label}: sweep row {row} is not bit-identical to "
                         f"the solo run")

def admission_share(run):
    """(seconds in the admission loop, seconds in all) of ``run`` with the
    card synchronised around each admission loop."""
    spent = {"admit": 0.0}
    admit = sched._admit

    def timed_admit(*a):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = admit(*a)
        torch.cuda.synchronize()
        spent["admit"] += time.perf_counter() - t0
        return out

    sched._admit = timed_admit
    try:
        torch.cuda.synchronize()
        t = time.perf_counter()
        run()
        torch.cuda.synchronize()
        total = time.perf_counter() - t
    finally:
        sched._admit = admit
    return spent["admit"], total

def main_path(card, entry):
    """The no-grid Frontier sweep: one fused_cooling launch a step."""
    system, table = frontier_case()
    scens = [T.Scenario.make(p, b) for p, b in SWEEP]
    n_steps = int(round(SWEEP_T1 / system.dt))
    S = len(scens)
    print(f"main path: frontier N={system.n_nodes} G={system.cooling.n_groups} "
          f"J={table.num_jobs} steps={n_steps} S={S}")
    run = lambda: eng.simulate_sweep(system, table, scens, 0.0, SWEEP_T1)
    (finals, hists), wall, launches = run_counted(run)
    print(f"[{card}] sweep: {n_steps} steps x {S} scenarios in {wall!r} s = "
          f"{n_steps / wall!r} steps/s, launches {launches}")
    if launches["fused_cooling"] != n_steps or launches["group_power"] != 0:
        raise SystemExit(f"no-grid sweep of {n_steps} steps launched "
                         f"{launches}")
    entry["launches"] = launches["fused_cooling"]
    check_run("sweep", finals, hists, n_steps, S)
    for i, (p, b) in enumerate(SWEEP):
        s = stats_mod.summarize(system, table, T.row(finals, i),
                                T.row(hists, i))
        print(f"  {p}:{b}: jobs_completed={s['jobs_completed']:.0f} "
              f"avg_util={s['avg_util']:.4f} avg_pue={s['avg_pue']:.5f} "
              f"avg_wait_s={s['avg_wait_s']:.1f} "
              f"t_tower_return_max_c={s['t_tower_return_max_c']:.3f}")
    # no solo rerun here (cut for the script's time): frontier-replay-2h
    # holds a Frontier no-grid row to its solo run. The synchronised rerun
    # covers the first ADMIT_WINDOW steps only
    admit_s, total = admission_share(lambda: eng.simulate_sweep(
        system, table, scens, 0.0, ADMIT_WINDOW * system.dt))
    print(f"[{card}] admission loop ({ADMIT_WINDOW} steps): {admit_s!r} s "
          f"of {total!r} s = {admit_s / total!r} of step time (synchronised "
          f"run)")
    print(f"[{card}] fused_cooling total on the main path: "
          f"{entry['ms'] * n_steps!r} ms on the card ({n_steps} launches x "
          f"{entry['ms']!r} ms) of {wall * 1e3!r} ms")

def fugaku_path(card):
    """A short no-grid sweep at Fugaku's full width: 158,976 nodes in 32
    CDU groups (a span of 4,968 nodes, so fused_cooling runs its CTA
    form: one 512-thread CTA a group), the Fugaku loader's 4,000-job day, the SWEEP scenarios, 2 h
    at dt = 60 s. Launches must equal steps, and row 0 a solo run."""
    system = get_system("fugaku")
    js = loaders.load_fugaku()
    js.assign_prepop_placement(0.0, system.n_nodes)
    table = js.to_table()
    scens = [T.Scenario.make(p, b) for p, b in SWEEP]
    n_steps = int(round(FUGAKU_T1 / system.dt))
    S, N, G = len(scens), system.n_nodes, system.cooling.n_groups
    print(f"fugaku path: N={N} G={G} J={table.num_jobs} steps={n_steps} "
          f"S={S}; fused_cooling plan {power_topo.plan(N, G)}")
    run = lambda: eng.simulate_sweep(system, table, scens, 0.0, FUGAKU_T1)
    (finals, hists), wall, launches = run_counted(run)
    print(f"[{card}] fugaku sweep: {n_steps} steps x {S} scenarios in "
          f"{wall!r} s = {n_steps / wall!r} steps/s, launches {launches}")
    if launches["fused_cooling"] != n_steps or launches["group_power"] != 0:
        raise SystemExit(f"fugaku sweep of {n_steps} steps launched "
                         f"{launches}")
    check_run("fugaku sweep", finals, hists, n_steps, S)
    for i, (p, b) in enumerate(SWEEP):
        s = stats_mod.summarize(system, table, T.row(finals, i),
                                T.row(hists, i))
        print(f"  {p}:{b}: jobs_completed={s['jobs_completed']:.0f} "
              f"avg_util={s['avg_util']:.4f} avg_pue={s['avg_pue']:.5f} "
              f"t_tower_return_max_c={s['t_tower_return_max_c']:.3f}")
    check_row_vs_solo("fugaku sweep", finals, hists, eng.simulate_static(
        system, table, *SWEEP[0], 0.0, FUGAKU_T1))

def grid_case():
    """frontier-grid-6h: Frontier with benchmarks/fig_carbon.py's DVFS
    floor, the 1,238-job day, and fig_carbon's signals on a clock that
    runs 14:00-20:00, so the evening cap dip covers the last 3 h."""
    system, table = frontier_case()
    system = dataclasses.replace(system, grid=dataclasses.replace(
        system.grid, c_min=0.05))
    n_steps = int(round(FRONTIER_T1 / system.dt))
    peak_it = system.n_nodes * system.power.peak_node_w
    sig = gsig.synthetic_signals(system.grid, n_steps, system.dt,
                                 t0=GRID_T0_CLOCK, seed=11,
                                 cap_base_w=0.9 * peak_it,
                                 cap_peak_w=0.55 * peak_it)
    return system, table, sig, n_steps

def grid_path(card, entry):
    """The grid Frontier sweep: one group_power launch a step, no
    fused_cooling."""
    system, table, sig, n_steps = grid_case()
    scens = [T.Scenario.make(p, b, **kw) for p, b, kw in GRID_SWEEP]
    S = len(scens)
    print(f"grid path frontier-grid-6h: N={system.n_nodes} "
          f"G={system.cooling.n_groups} J={table.num_jobs} steps={n_steps} "
          f"S={S} c_min={system.grid.c_min} cap {float(sig.cap_w.max())!r}"
          f"..{float(sig.cap_w.min())!r} W before cap_scale")
    run = lambda: eng.simulate_sweep(system, table, scens, 0.0, FRONTIER_T1,
                                     signals=sig)
    (finals, hists), wall, launches = run_counted(run)
    print(f"[{card}] grid sweep: {n_steps} steps x {S} scenarios in {wall!r} "
          f"s = {n_steps / wall!r} steps/s, launches {launches}")
    if launches["group_power"] != n_steps or launches["fused_cooling"] != 0:
        raise SystemExit(f"grid sweep of {n_steps} steps launched "
                         f"{launches}")
    entry["launches"] = launches["group_power"]
    check_run("grid sweep", finals, hists, n_steps, S)
    over = hists.power_it - hists.cap_w
    if not (over <= 1.0).all():
        raise SystemExit(f"grid sweep: the cap is exceeded by up to "
                         f"{float(over.max())!r} W")
    for name in ("emissions_kg", "energy_cost"):
        v = getattr(finals, name)
        if not (torch.isfinite(v).all() and (v > 0).all()):
            raise SystemExit(f"grid sweep: {name} not finite and positive: "
                             f"{v.tolist()}")
    throttled_rows = 0
    for i, (p, b, kw) in enumerate(GRID_SWEEP):
        s = stats_mod.summarize(system, table, T.row(finals, i),
                                T.row(hists, i))
        throttled_rows += s["throttled_steps"] > 0
        print(f"  {p}:{b} {kw}: jobs_completed={s['jobs_completed']:.0f} "
              f"tCO2={s['emissions_kg'] / 1e3!r} "
              f"cost_usd={s['energy_cost_usd']!r} "
              f"peak_mw={s['max_power_mw']!r} "
              f"peak_it_mw={float(hists.power_it[i].max()) / 1e6!r} "
              f"throttled_steps={s['throttled_steps']:.0f} "
              f"avg_throttle_frac={s['avg_throttle_frac']!r} "
              f"avg_wait_s={s['avg_wait_s']:.1f} "
              f"avg_pue={s['avg_pue']:.5f}")
    print(f"grid sweep: {throttled_rows} of {S} rows throttled at some step; "
          f"power_it <= cap_w + 1 W at every step of every row (largest "
          f"excess {float(over.max())!r} W)")
    # row 0 is fcfs:first-fit at cap scale 1, which simulate_static names;
    # it is also the events phase's zero-rate identity's reference
    check_row_vs_solo("grid sweep", finals, hists, eng.simulate_static(
        system, table, *GRID_SWEEP[0][:2], 0.0, FRONTIER_T1, signals=sig))
    print(f"grid sweep: the cap binds in row 0 (= the solo run) at "
          f"{int((hists.throttle_frac[0] > 0).sum())} of {n_steps} steps")
    row0 = (T.row(finals, 0), T.row(hists, 0))
    # the synchronised rerun covers the first ADMIT_WINDOW steps only (cut
    # from the whole 6 h to keep the script's time)
    admit_s, total = admission_share(lambda: eng.simulate_sweep(
        system, table, scens, 0.0, ADMIT_WINDOW * system.dt, signals=sig))
    print(f"[{card}] grid admission loop ({ADMIT_WINDOW} steps): {admit_s!r} "
          f"s of {total!r} s = {admit_s / total!r} of step time "
          f"(synchronised run)")
    print(f"[{card}] group_power total on the grid path: "
          f"{entry['ms'] * n_steps!r} ms on the card ({n_steps} launches x "
          f"{entry['ms']!r} ms) of {wall * 1e3!r} ms")
    return row0, n_steps / wall

def ops_per_step(run, first=4, last=8):
    """aten operations dispatched per engine step (each launches at most
    one kernel; the hand-written kernels' launches are not aten
    operations), counted over steps [first, last) of ``run``."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    step, seen = eng.engine_step, [0]

    def counted(*a, **k):
        seen[0] += 1
        if first < seen[0] <= last:
            with Count():
                return step(*a, **k)
        return step(*a, **k)

    eng.engine_step = counted
    try:
        run()
    finally:
        eng.engine_step = step
    return Count.n / (last - first)

def events_case():
    """frontier-events-6h: ``grid_case()`` under weather, failures and a
    demand-response event. Returns (system, table, signals, n_steps,
    scenarios without the DR knobs, their weather, the DR knobs, labels)."""
    system, table, sig, n_steps = grid_case()
    summer = wsig.synthetic_weather(n_steps, system.dt, t0=GRID_T0_CLOCK,
                                    seed=5)
    wave = wsig.heat_wave(summer, system.dt, start_s=3600.0,
                          duration_s=3 * 3600.0, peak_amp_c=8.0)
    dr = dict(DR_AT, dr_cap_w=DR_CAP_FRAC * system.n_nodes *
              system.power.peak_node_w)
    rows = [((p, b), (wname, w), f) for p, b in EVENT_POLICIES
            for wname, w in (("summer", summer), ("heat wave", wave))
            for f in EVENT_FAILURES]
    scens = [dict(policy=p, backfill=b, **f) for (p, b), _, f in rows]
    labels = [f"{p}:{b} {wname} seed {f['failure_seed']:.0f}"
              for (p, b), (wname, _), f in rows]
    return (system, table, sig, n_steps, scens, [w for _, (_, w), _ in rows],
            dr, labels)

def events_path(card, grid_row0, grid_steps_s):
    """frontier-events-6h: the grid sweep under weather, failures and a
    demand-response event, one group_power launch a step; the sweep runs
    its first 4 h, the zero-rate identity all 6 h."""
    system, table, sig, n_steps, knobs, weather, dr, labels = events_case()
    scens = [T.Scenario.make(**k, **dr) for k in knobs]
    S = len(scens)
    n_sweep = int(round(EVENTS_T1 / system.dt))
    print(f"events path frontier-events-6h: N={system.n_nodes} "
          f"G={system.cooling.n_groups} C={system.cooling.n_tower_cells} "
          f"J={table.num_jobs} steps={n_sweep} S={S}; base rates "
          f"{BASE_RATES} (x4 for seed 2), DR {dr}")
    run = lambda: eng.simulate_sweep(system, table, scens, 0.0, EVENTS_T1,
                                     signals=sig, weather=weather,
                                     events=EventConfig())
    (finals, hists), wall, launches = run_counted(run)
    print(f"[{card}] events sweep: {n_sweep} steps x {S} scenarios in "
          f"{wall!r} s = {n_sweep / wall!r} steps/s (grid sweep "
          f"{grid_steps_s!r} steps/s in this run), launches {launches} = "
          f"{launches['group_power'] / n_sweep!r} group_power a step (grid "
          f"sweep: 1.0)")
    if launches["group_power"] != n_sweep or launches["fused_cooling"] != 0:
        raise SystemExit(f"events sweep of {n_sweep} steps launched "
                         f"{launches}")
    check_run("events sweep", finals, hists, n_sweep, S)
    # the cap in force: the signal's, or the DR cap while the event holds
    t = hists.t[0]
    start = dr["dr_announce_s"] + dr["dr_notice_s"]
    active = (t >= start) & (t < start + dr["dr_duration_s"])
    dr_cap = torch.tensor(dr["dr_cap_w"], dtype=torch.float32, device=DEV)
    want_cap = torch.minimum(sig.cap_w.to(DEV)[:n_sweep],
                             torch.where(active, dr_cap, torch.inf))
    if not torch.equal(hists.cap_w, want_cap.expand(S, -1)):
        raise SystemExit("events sweep: the recorded cap is not the "
                         "signal's cap lowered by the DR event")
    over = hists.power_it - hists.cap_w
    if not (over <= 1.0).all():
        raise SystemExit(f"events sweep: the cap is exceeded by up to "
                         f"{float(over.max())!r} W")
    ev = finals.events
    checks = {"a job killed": ev.jobs_killed >= 1,
              "a CDU group down": torch.isfinite(ev.group_down_until).any(1),
              "a tower cell failed": torch.isfinite(ev.cell_down_until).any(1)}
    for what, ok in checks.items():
        if not ok.all():
            raise SystemExit(f"events sweep: rows without {what}: "
                             f"{torch.nonzero(~ok).flatten().tolist()}")
    peak_basin = hists.t_basin.amax(1)
    for i, label in enumerate(labels):
        s = stats_mod.summarize(system, table, T.row(finals, i),
                                T.row(hists, i))
        print(f"  [{card}] {label}: "
              f"jobs_completed={s['jobs_completed']:.0f} "
              f"killed={s['ride_jobs_killed']:.0f} "
              f"requeued={s['ride_jobs_requeued']:.0f} "
              f"energy_unserved_mwh={s['ride_energy_unserved_mwh']!r} "
              f"node_downtime_h={s['ride_node_downtime_h']!r} "
              f"peak_it_mw={float(hists.power_it[i].max()) / 1e6!r} "
              f"t_basin_max_c={float(peak_basin[i])!r} "
              f"avg_wetbulb_c={s['avg_wetbulb_c']!r} "
              f"avg_pue={s['avg_pue']:.5f}")
    # rows are (policy, weather, failures): the heat wave rows are 2-3, 6-7
    summer_rows, wave_rows = [0, 1, 4, 5], [2, 3, 6, 7]
    if not (peak_basin[wave_rows] > peak_basin[summer_rows]).all():
        raise SystemExit(f"events sweep: a heat-wave row's peak basin "
                         f"temperature is not above its summer row's: "
                         f"{peak_basin.tolist()}")
    print(f"[{card}] events sweep: power_it <= min(signal cap, DR cap) "
          f"+ 1 W at every step of every row (largest excess "
          f"{float(over.max())!r} W); every row killed a job and lost a CDU "
          f"group and a tower cell; every heat-wave row's peak basin above "
          f"its summer row's")
    solo = eng.simulate(system, table, scens[0], 0.0, EVENTS_T1,
                        signals=sig, weather=weather[0],
                        events=EventConfig())
    check_row_vs_solo("events sweep", finals, hists, solo)
    print(f"events sweep: the cap binds at "
          f"{(hists.throttle_frac > 0).sum(1).tolist()} of {n_sweep} steps "
          f"per row (row 0 = the solo run)")
    for name, a in vars(solo[0].events).items():
        if not torch.equal(a, getattr(ev, name)[0]):
            raise SystemExit(f"events sweep: row 0's {name} differs from "
                             f"the solo run's")
    # events on at zero rates with DR off, under a constant trace at the
    # config's wet-bulb: the grid sweep's row 0, bit for bit, over the
    # whole 6 h, whose last 3 h are the cap dip where enforce_cap binds
    const = wsig.constant_weather(n_steps, system.cooling.t_wetbulb_c)
    zero_f, zero_h = eng.simulate(
        system, table, T.Scenario.make(*EVENT_POLICIES[0]), 0.0, FRONTIER_T1,
        signals=sig, weather=const, events=EventConfig())
    (row_f, row_h) = grid_row0
    n_bound = int((row_h.throttle_frac > 0).sum())
    if n_bound == 0:
        raise SystemExit("events sweep: the cap never binds in the grid "
                         "sweep's row 0, so the zero-rate identity misses "
                         "enforce_cap")
    same = all(torch.equal(getattr(zero_h, k), v) for k, v in
               vars(row_h).items()) and all(
        torch.equal(getattr(zero_f, k), getattr(row_f, k))
        for k in ("jstate", "start", "end", "node_job", "energy_total",
                  "jenergy", "emissions_kg", "energy_cost"))
    if not same or float(zero_f.events.jobs_killed) != 0.0:
        raise SystemExit("events sweep: events on at zero rates with a "
                         "constant trace differ from the grid sweep's row 0")
    print(f"events sweep: events on at zero rates, DR off, constant trace at "
          f"the config's wet-bulb: bit-identical to the grid sweep's row 0 "
          f"({n_steps} steps, the cap binding at {n_bound} of them)")
    grid_ops = ops_per_step(lambda: eng.simulate_sweep(
        system, table, [T.Scenario.make(p, b, **kw) for p, b, kw in
                        GRID_SWEEP], 0.0, 12 * system.dt, signals=sig))
    ev_ops = ops_per_step(lambda: eng.simulate_sweep(
        system, table, scens, 0.0, 12 * system.dt, signals=sig,
        weather=weather, events=EventConfig()))
    print(f"[{card}] aten operations dispatched per step (steps 5-8): grid "
          f"sweep {grid_ops!r}, events sweep {ev_ops!r}; kernel launches "
          f"per step 1.0 (group_power) in both")

def events_nogrid_path(card):
    """The frontier-events-6h scenarios without signals or DR, 30 min: one
    fused_cooling launch a step, row 0 bit-identical to its solo run."""
    system, table, _, _, knobs, weather, _, _ = events_case()
    n_steps = int(round(EVENTS_NOGRID_T1 / system.dt))
    scens = [T.Scenario.make(**k) for k in knobs]
    S = len(scens)
    run = lambda: eng.simulate_sweep(system, table, scens, 0.0,
                                     EVENTS_NOGRID_T1, weather=weather,
                                     events=EventConfig())
    (finals, hists), wall, launches = run_counted(run)
    print(f"[{card}] no-grid events sweep: {n_steps} steps x {S} scenarios "
          f"in {wall!r} s = {n_steps / wall!r} steps/s, launches {launches}")
    if launches["fused_cooling"] != n_steps or launches["group_power"] != 0:
        raise SystemExit(f"no-grid events sweep of {n_steps} steps "
                         f"launched {launches}")
    check_run("no-grid events sweep", finals, hists, n_steps, S)
    print(f"[{card}] no-grid events sweep: jobs killed "
          f"{finals.events.jobs_killed.tolist()}, node-hours down "
          f"{(finals.events.node_downtime_s / 3600.0).tolist()}")
    check_row_vs_solo("no-grid events sweep", finals, hists, eng.simulate(
        system, table, scens[0], 0.0, EVENTS_NOGRID_T1, weather=weather[0],
        events=EventConfig()))

def cols_equal(a, b):
    """Two fetches' columns, bit for bit (NaN equal to NaN)."""
    return a.keys() == b.keys() and all(
        np.array_equal(a[k], b[k], equal_nan=True) for k in a)

def digest_of(carry):
    return snap.carry_digest(snap.encode_carry(carry, binary=True))

def session_case():
    """frontier-session-2h's inputs: (system, table, signals, the root's
    scenario, the four fork deltas by name)."""
    system, table, sig, _ = grid_case()
    t_fork = SESSION_FORK_AT * SESSION_INTERVAL * system.dt
    peak_it = system.n_nodes * system.power.peak_node_w
    dr = dict(DR_AT, dr_announce_s=t_fork, dr_cap_w=DR_CAP_FRAC * peak_it)
    deltas = {"neutral": {}, "setpoint +2 C": {"setpoint_delta_c": 2.0},
              "DR": dr, "failures": dict(EVENT_FAILURES[1])}
    return system, table, sig, T.Scenario.make(*GRID_SWEEP[0][:2]), deltas

def session_path(card):
    """frontier-session-2h: the root alone for 4 intervals, 4 forks at
    1 h, then 5 branches coalesced for 4 intervals; one group_power
    launch a dispatched step (a batch of 5 is one dispatch). Returns the
    launches, and what the wire phase holds its tree to: each branch's
    rows to step 360 and the raw digest of its step-360 checkpoint."""
    system, table, sig, scen, deltas = session_case()
    dr = deltas["DR"]
    n = SESSION_INTERVAL
    fork_step = SESSION_FORK_AT * n
    horizon = int(round(SESSION_T1 / system.dt))
    print(f"session path frontier-session-2h: N={system.n_nodes} "
          f"J={table.num_jobs} horizon={horizon} steps, interval {n}, "
          f"fork at step {fork_step}; forks {deltas}")
    timing = {}

    def drive():
        t = time.perf_counter()
        sess = TwinSession(system, table, scen, 0.0, SESSION_T1, n,
                           signals=sig, events=EventConfig())
        sess.advance_many({0: SESSION_FORK_AT})
        torch.cuda.synchronize()
        timing["root"] = time.perf_counter() - t
        # the root's live carry on the card, through the codec
        card_carry = sess.branches[0].carry
        for binary in (False, True):
            torch.cuda.synchronize()
            t = time.perf_counter()
            payload = snap.encode_carry(card_carry, binary=binary)
            timing[("encode", binary)] = time.perf_counter() - t
            if not binary:
                text = json.dumps(payload)
                timing["json_bytes"] = len(text)
                payload = json.loads(text)
            t = time.perf_counter()
            decoded = snap.decode_carry(payload, sess.carry_template)
            timing[("decode", binary)] = time.perf_counter() - t
            timing[("payload", binary)] = payload
        timing["decoded"] = decoded
        t = time.perf_counter()
        ids = {name: sess.fork(0, d).branch_id for name, d in deltas.items()}
        torch.cuda.synchronize()
        timing["forks"] = time.perf_counter() - t
        t = time.perf_counter()
        sess.advance_many({b: SESSION_FORK_AT for b in sess.branches})
        torch.cuda.synchronize()
        timing["coalesced"] = time.perf_counter() - t
        return sess, ids

    (sess, ids), wall, launches = run_counted(drive)
    dispatched = 2 * SESSION_FORK_AT * n
    print(f"[{card}] session: {wall!r} s in all, launches {launches} for "
          f"{dispatched} dispatched steps ({SESSION_FORK_AT * n} of the root "
          f"alone, {SESSION_FORK_AT * n} of 5 branches coalesced)")
    if launches["group_power"] != dispatched or launches["fused_cooling"]:
        raise SystemExit(f"session of {dispatched} dispatched steps "
                         f"launched {launches}")
    coalesced_bs = len(sess.branches) * SESSION_FORK_AT * n / \
        timing["coalesced"]

    # the root's 8 segments against one uninterrupted scan on the card
    final, hist = eng.simulate(system, table, scen, 0.0, SESSION_T1,
                               signals=sig, events=EventConfig())
    root = sess.branches[0]
    for name in vars(hist):
        got = np.concatenate([getattr(h, name) for h in root.history])
        if not np.array_equal(got, getattr(hist, name).cpu().numpy(),
                              equal_nan=True):
            raise SystemExit(f"session: the root's segments differ from one "
                             f"scan in {name}")
    if digest_of(root.checkpoints[horizon]) != digest_of(final):
        raise SystemExit("session: the root's final carry differs from one "
                         "scan's")
    print(f"session: the root's {2 * SESSION_FORK_AT} segments are "
          f"bit-identical to one {horizon}-step simulate on the card "
          f"(every telemetry row, the final carry's digest)")

    # the neutral fork is its parent
    neutral = sess.branches[ids["neutral"]]
    if not cols_equal(sess.fetch(0, start=fork_step, binary=True)["cols"],
                      sess.fetch(neutral.branch_id, binary=True)["cols"]):
        raise SystemExit("session: the neutral fork's rows differ from the "
                         "root's")
    for step in neutral.checkpoints:
        if sess.snapshot(0, at_step=step)["digest"] != \
                sess.snapshot(neutral.branch_id, at_step=step)["digest"]:
            raise SystemExit(f"session: the neutral fork's checkpoint at "
                             f"step {step} differs from the root's")

    # the DR fork advanced alone from the same checkpoint
    alone = sess.fork(0, dr, at_step=fork_step).branch_id
    torch.cuda.synchronize()
    t = time.perf_counter()
    sess.advance_many({alone: SESSION_FORK_AT})
    torch.cuda.synchronize()
    serial_bs = SESSION_FORK_AT * n / (time.perf_counter() - t)
    dr_id = ids["DR"]
    if not cols_equal(sess.fetch(alone, binary=True)["cols"],
                      sess.fetch(dr_id, binary=True)["cols"]):
        raise SystemExit("session: the DR fork coalesced and alone differ")
    for step in sess.branches[dr_id].checkpoints:
        if sess.snapshot(alone, at_step=step)["digest"] != \
                sess.snapshot(dr_id, at_step=step)["digest"]:
            raise SystemExit(f"session: the DR fork's checkpoint at step "
                             f"{step} differs coalesced and alone")

    # a snapshot of the card's carry, decoded, resumes bit for bit
    for binary in (False, True):
        payload = timing[("payload", binary)]
        if snap.carry_digest(payload) != digest_of(
                root.checkpoints[fork_step]):
            raise SystemExit("session: the card carry's snapshot differs "
                             "from its host checkpoint")
    resumed, rhist = eng.simulate_segment(system, table, timing["decoded"],
                                          scen, n, sig,
                                          events=EventConfig())
    same = all(np.array_equal(a.cpu().numpy(), getattr(
        root.history[SESSION_FORK_AT], k), equal_nan=True)
        for k, a in vars(rhist).items())
    if not same or digest_of(resumed) != digest_of(
            root.checkpoints[fork_step + n]):
        raise SystemExit("session: a resume from a decoded snapshot differs "
                         "from the root")

    # the DR cap, and the failure fork's kills
    cols = sess.fetch(dr_id, binary=True)["cols"]
    start = dr["dr_announce_s"] + dr["dr_notice_s"]
    t = cols["t"]
    active = (t >= start) & (t < start + dr["dr_duration_s"])
    steps = cols["step"]
    want_cap = np.minimum(sig.cap_w.cpu().numpy()[steps],
                          np.where(active, np.float32(dr["dr_cap_w"]),
                                   np.inf))
    if not np.array_equal(cols["cap_w"], want_cap.astype(np.float64)):
        raise SystemExit("session: the DR fork's recorded cap is not "
                         "min(signal cap, DR cap)")
    over = cols["power_it"] - cols["cap_w"]
    if not (over <= 0.0).all():
        raise SystemExit(f"session: the DR fork exceeds its cap by "
                         f"{over.max()!r} W")
    killed = float(sess.fetch(ids["failures"], binary=True)["cols"]
                   ["n_killed"].sum())
    if killed < 1:
        raise SystemExit("session: the failure fork killed no job")
    throttled = int((cols["throttle_frac"][active] > 0).sum())
    print(f"session: neutral fork = root row for row and at every "
          f"checkpoint; the DR fork alone = coalesced (rows, digests); a "
          f"snapshot of the card's carry resumes bit for bit; DR cap held "
          f"(largest power_it - cap_w {float(over.max())!r} W; "
          f"{int(active.sum())} steps under the DR cap, {throttled} of them "
          f"throttled); the failure fork killed {killed!r} jobs")
    for name, b in ids.items():
        c = sess.fetch(b, binary=True)["cols"]
        print(f"  [{card}] {name}: peak_it_mw="
              f"{float(c['power_it'].max()) / 1e6!r} "
              f"avg_pue={float(c['pue'].mean())!r} t_tower_return_max_c="
              f"{float(c['t_tower_return'].max())!r} nodes_down_max="
              f"{float(c['nodes_down'].max())!r} "
              f"n_killed={float(c['n_killed'].sum())!r}")

    ck = root.checkpoints[fork_step]
    ck_bytes = sum(a.nbytes for a in
                   snap.encode_carry(ck, binary=True)["leaves"].values())
    hist_bytes = sum(a.nbytes for a in vars(root.history[0]).values())
    print(f"[{card}] session rates: {len(deltas) / timing['forks']!r} forks/s; "
          f"branch-steps/s coalesced {coalesced_bs!r} (5 branches) against "
          f"serial {serial_bs!r} (one branch alone) = "
          f"{coalesced_bs / serial_bs!r}x; root alone "
          f"{SESSION_FORK_AT * n / timing['root']!r} steps/s")
    print(f"[{card}] snapshot at Frontier's width: {timing['json_bytes']} "
          f"bytes base64 JSON, {ck_bytes} bytes of raw arrays; encode "
          f"{timing[('encode', False)] * 1e3!r} ms (JSON) / "
          f"{timing[('encode', True)] * 1e3!r} ms (binary) from the card, "
          f"decode {timing[('decode', False)] * 1e3!r} / "
          f"{timing[('decode', True)] * 1e3!r} ms; host bytes per branch "
          f"per interval: checkpoint {ck_bytes} + history {hist_bytes}")
    wire_step = fork_step + WIRE_ADVANCE * n
    ref = {b: (sess.fetch(b, stop=wire_step, binary=True)["cols"],
               sess.snapshot(b, at_step=wire_step)["raw_digest"])
           for b in [0, *ids.values()]}
    return launches, dict(branches=ref, ids=ids, step=wire_step,
                          coalesced_bs=coalesced_bs)

def listen_address(tmp, name):
    """A Unix socket in ``tmp``, or localhost TCP where the path would be
    too long for AF_UNIX."""
    path = pathlib.Path(tmp) / name
    return f"unix:{path}" if len(str(path)) < 100 else "127.0.0.1:0"

def reply_bytes(server, fn):
    """(reply, round trip s, bytes the server wrote for it)."""
    before = server.stats()["wire"]["bytes_out"]
    t = time.perf_counter()
    out = fn()
    dt = time.perf_counter() - t
    return out, dt, server.stats()["wire"]["bytes_out"] - before

def client_cols(reply):
    """A fetch reply's columns as float64 arrays: the stdlib client's
    binary dicts or the JSON rows."""
    if "cols" in reply:
        return {k: np.asarray(c["values"], np.dtype(c["dtype"])).astype(
            np.float64) for k, c in reply["cols"].items()}
    return {k: np.asarray([r[k] for r in reply["rows"]], np.float64)
            for k in reply["fields"]}

def wire_path(card, ref):
    """frontier-session-2h served over a Unix socket by a ``TwinServer``
    on the card and driven by the stdlib client (``tools/twin_client``):
    the root to step 240 one interval per request, the four forks, then
    five client threads advance the five branches 2 intervals at once
    (to step 360), coalesced as the executor batches them. Every branch's
    rows and step-360 digest equal ``session_path``'s bit for bit;
    group_power launches once per dispatched step."""
    from repro_torch.serve import TwinServer
    from tools.twin_client import TwinClient, TwinError
    system, table, sig, scen, deltas = session_case()
    n = SESSION_INTERVAL
    tmp = tempfile.TemporaryDirectory(prefix="tw")
    sess = TwinSession(system, table, scen, 0.0, SESSION_T1, n,
                       signals=sig, events=EventConfig())
    own = []      # the executor's batches: (branches, the session's s)
    advance_many = sess.advance_many

    def timed(requests):
        t = time.perf_counter()
        try:
            return advance_many(requests)
        finally:
            own.append((len(requests), time.perf_counter() - t))
    sess.advance_many = timed
    server = TwinServer(sess, listen_address(tmp.name, "twin.sock"),
                        batch_window_s=0.05, client_timeout_s=120.0)
    print(f"wire path frontier-session-2h over {server.address}: root to "
          f"step {SESSION_FORK_AT * n} one interval a request, 4 forks, 5 "
          f"client threads x advance {WIRE_ADVANCE} intervals at once")
    timing = {}

    def drive():
        with TwinClient(server.address, timeout_s=300.0) as c:
            rtt = []
            for _ in range(SESSION_FORK_AT):
                t = time.perf_counter()
                c.advance(0, 1)
                rtt.append(time.perf_counter() - t)
            timing["advance"] = (rtt, list(own))
            ids = {name: c.fork(0, d)["branch"] for name, d in deltas.items()}
        if ids != ref["ids"]:
            raise SystemExit(f"wire: forks got ids {ids}, the session "
                             f"phase {ref['ids']}")
        branches = [0, *ids.values()]
        barrier, errors = threading.Barrier(len(branches)), []

        def advance(b):
            try:
                with TwinClient(server.address, timeout_s=300.0) as c:
                    barrier.wait(timeout=60.0)
                    c.advance(b, WIRE_ADVANCE)
            except Exception as e:   # noqa: BLE001 - a failed phase below
                errors.append((b, repr(e)))
        threads = [threading.Thread(target=advance, args=(b,))
                   for b in branches]
        t = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=300.0)
        timing["coalesced"] = time.perf_counter() - t
        if errors or any(th.is_alive() for th in threads):
            raise SystemExit(f"wire: client threads failed: {errors}")
        return branches

    try:
        branches, wall, launches = run_counted(drive)
        c1 = sess.counters
        ticks = c1["coalesced_batches"] + (c1["segments"]
                                           - c1["batched_branches"])
        dispatched = ticks * n
        print(f"[{card}] wire: {wall!r} s in all, launches {launches} for "
              f"{dispatched} dispatched steps ({ticks} dispatches of "
              f"{c1['segments']} branch-intervals); the executor's batches, "
              f"branches each: {[k for k, _ in own]}; session counters "
              f"{c1}")
        if launches["group_power"] != dispatched or launches["fused_cooling"]:
            raise SystemExit(f"wire: {dispatched} dispatched steps launched "
                             f"{launches}")
        step = ref["step"]
        with TwinClient(server.address, timeout_s=300.0) as c:
            cost = {}
            for b in branches:
                want, digest = ref["branches"][b]
                fb, *cost["fetch bin"] = reply_bytes(server, lambda: c.fetch(
                    b, stop=step, binary=True))
                fj, *cost["fetch JSON"] = reply_bytes(server, lambda: c.fetch(
                    b, stop=step))
                got = client_cols(fb)
                if not (cols_equal(got, want) and
                        cols_equal(client_cols(fj), got)):
                    raise SystemExit(f"wire: branch {b}'s rows over the wire "
                                     f"differ from the session phase's")
                sb, *cost["snapshot bin"] = reply_bytes(
                    server, lambda: c.snapshot(b, at_step=step, binary=True))
                sj, *cost["snapshot JSON"] = reply_bytes(
                    server, lambda: c.snapshot(b, at_step=step))
                if not sb["raw_digest"] == sj["raw_digest"] == digest:
                    raise SystemExit(f"wire: branch {b}'s step-{step} "
                                     f"snapshot digest differs")
                if b == 0:       # the root: all 360 rows
                    root_cost = dict(cost)
            print(f"wire: every branch's rows to step {step} (binary and "
                  f"JSON fetches) and its step-{step} snapshot digest (both "
                  f"dialects) equal the in-process session's, bit for bit")
            print(f"[{card}] wire at Frontier's width, the root ({step} "
                  f"rows; a snapshot at step {step}): " + "; ".join(
                      f"{k} {nb} B in {dt * 1e3!r} ms"
                      for k, (dt, nb) in root_cost.items()))
            try:
                c.advance(999999, 1)
                raise SystemExit("wire: an unknown branch was advanced")
            except TwinError as e:
                if e.error != "session":
                    raise SystemExit(f"wire: unknown branch got {e.frame}")
            if c.state()["kind"] != "state_ok":
                raise SystemExit("wire: the connection died after a "
                                 "session error")
        family, addr = tr.parse_address(server.address)
        with socket.socket(family, socket.SOCK_STREAM) as s:
            s.settimeout(60.0)
            s.connect(addr)
            rfile = s.makefile("rb")
            tr.read_any_frame(rfile)
            s.sendall(b"this is not json\n")
            reply = tr.read_any_frame(rfile)
            if reply.get("error") != "protocol":
                raise SystemExit(f"wire: garbage got {reply}")
            try:
                tr.read_any_frame(rfile)
                raise SystemExit("wire: the connection stayed up after "
                                 "garbage")
            except ConnectionError:
                pass
            rfile.close()
    finally:
        stats = server.close()
        tmp.cleanup()
    alive = [c.client_id for c in server.clients if c.thread.is_alive()]
    if stats["n_open"] or alive:
        raise SystemExit(f"wire: after close {stats['n_open']} connections "
                         f"open, handlers alive {alive}")
    rtt, spent = timing["advance"]
    wire_bs = len(branches) * WIRE_ADVANCE * n / timing["coalesced"]
    print(f"wire: protocol error and a closed connection for garbage, a "
          f"session error on a connection that stays up for an unknown "
          f"branch; after close 0 of {stats['n_clients']} connections open, "
          f"no handler alive")
    print(f"[{card}] wire rates: branch-steps/s over the wire {wire_bs!r} (5 "
          f"clients, advance {WIRE_ADVANCE} each, {timing['coalesced']!r} s "
          f"of wall; the session's own time for the executor's last batch, "
          f"{own[-1][0]} branches: {own[-1][1]!r} s) against in-process "
          f"coalesced {ref['coalesced_bs']!r}; advance of one interval: "
          f"round trips {[x * 1e3 for x in rtt]!r} ms, the session's own "
          f"{[x * 1e3 for _, x in spent]!r} ms")
    return launches

def serve_subcommand(card):
    """``python -m repro_torch.launch.simulate serve`` at Frontier's width
    on the card, driven by ``tools/twin_client`` over 2 intervals."""
    tmp = tempfile.TemporaryDirectory(prefix="tw")
    address = listen_address(tmp.name, "serve.sock")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.simulate", "serve",
           "--system", "frontier", "--jobs", "1238", "-t", "30m",
           "--interval-steps", str(SESSION_INTERVAL), "--listen", address,
           "--max-seconds", "400"]
    t = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        start = json.loads(proc.stdout.readline() or "{}")
        up_s = time.perf_counter() - t
        if "serving" not in start:
            proc.kill()
            raise SystemExit(f"serve: no startup line; stderr "
                             f"{proc.communicate()[1][-2000:]}")
        client = subprocess.run(
            [sys.executable, "-m", "tools.twin_client", "--connect",
             start["serving"], "--timeout", "300", "--script",
             "advance 0 2; fetch 0; state; shutdown"], cwd=ROOT,
            capture_output=True, text=True, timeout=400)
        out, err = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
        tmp.cleanup()
    replies = [json.loads(line) for line in client.stdout.splitlines()]
    kinds = [r["kind"] for r in replies]
    if proc.returncode != 0 or client.returncode != 0 or kinds != [
            "hello", "advance_ok", "fetch_ok", "state_ok", "shutdown_ok"]:
        raise SystemExit(f"serve: rc {proc.returncode}, client rc "
                         f"{client.returncode} {kinds}; {err[-2000:]} "
                         f"{client.stderr[-2000:]}")
    served = json.loads(out.splitlines()[-1])
    n_rows = len(replies[2]["rows"])
    if replies[0]["system"]["n_nodes"] != 9600 or n_rows != \
            2 * SESSION_INTERVAL or "served" not in served:
        raise SystemExit(f"serve: hello {replies[0]['system']}, {n_rows} "
                         f"rows, last line {served}")
    print(f"[{card}] serve subcommand: frontier N="
          f"{replies[0]['system']['n_nodes']} on the card, {up_s!r} s from "
          f"start to serving; {n_rows} rows fetched; served {served}")

def small_session_reference(card):
    """A small session tree on the card and on the CPU (4-hall plant, no
    signals, so the fused_cooling kernel): schedules exact, floats 1e-4."""
    system, table = small_case()
    n = 30

    def tree(device):
        sess = TwinSession(system, table, T.Scenario.make("fcfs", "first-fit"),
                           0.0, 2 * 3600.0, n, num_accounts=8, device=device)
        sess.advance_many({0: 2})
        for d in ({}, {"setpoint_delta_c": 2.0},
                  {"backfill": "easy", "cells_offline": 1.0}):
            sess.fork(0, d)
        sess.advance_many({b: 2 for b in sess.branches})
        return sess

    cpu = tree("cpu")
    gpu, _, launches = run_counted(lambda: tree("cuda"))
    if launches["fused_cooling"] != 4 * n or launches["group_power"]:
        raise SystemExit(f"small session reference launched {launches}")
    schedule = ("jstate", "start", "end", "node_job", "free_count", "step")
    for b in cpu.branches:
        for k, v in cpu.fetch(b, binary=True)["cols"].items():
            np.testing.assert_allclose(gpu.fetch(b, binary=True)["cols"][k],
                                       v, rtol=1e-4, atol=1e-4,
                                       err_msg=f"small session {b} {k}")
        want = snap.encode_carry(cpu.branches[b].checkpoints[cpu.branches[b]
                                                              .step],
                                 binary=True)["leaves"]
        got = snap.encode_carry(gpu.branches[b].checkpoints[gpu.branches[b]
                                                             .step],
                                binary=True)["leaves"]
        for path, w in want.items():
            if path in schedule:
                if not np.array_equal(got[path], w):
                    raise SystemExit(f"small session reference: branch {b} "
                                     f"{path} differs on the card")
            else:
                np.testing.assert_allclose(got[path], w, rtol=1e-4,
                                           atol=1e-4,
                                           err_msg=f"small session {b} {path}")
    print(f"[{card}] small session reference (marconi100 x64, 4 halls, 4 "
          f"branches, 120 dispatched steps, {launches['fused_cooling']} "
          f"fused_cooling launches): card matches the CPU, schedules exact, "
          f"rows and checkpoints within 1e-4")

def small_case():
    system = build_system("marconi100", 64, 4)
    js = generate(system, WorkloadSpec(n_jobs=64, duration_s=4 * 3600.0,
                                       load=1.4, trace_len=8, n_accounts=8,
                                       mean_wall_s=1800.0, seed=4))
    js.assign_prepop_placement(0.0, system.n_nodes)
    return system, js.to_table(80)

def card_vs_cpu(label, system, table, scens, signals=None, weather=None,
                events=None, t1=2 * 3600.0, num_accounts=8):
    """The card's engine (with the kernels) against the port's CPU engine
    (plain versions): schedules exactly, floats at 1e-4. ``throttle_frac``
    is 1 - c with c near 1, so it also gets atol 1e-6 (a one-ulp
    difference in c from another summation order). With the event layer
    the repair times also go through the card's ``log1p``: a schedule
    that differs is reported with the first step whose counts differ."""
    kw = dict(num_accounts=num_accounts, signals=signals, weather=weather,
              events=events)
    fg, hg = eng.simulate_sweep(system, table, scens, 0.0, t1, **kw)
    fc, hc = eng.simulate_sweep(system, table, scens, 0.0, t1, **kw,
                                device="cpu")
    for name in ("jstate", "start", "end", "node_job"):
        if not torch.equal(getattr(fg, name).cpu(), getattr(fc, name)):
            counts = ("nodes_down", "n_killed", "n_running", "n_queued")
            differ = torch.zeros_like(hc.t, dtype=torch.bool)
            for c in counts:
                differ |= getattr(hg, c).cpu() != getattr(hc, c)
            steps = torch.nonzero(differ.any(0)).flatten().tolist()
            raise SystemExit(f"{label}: card and CPU disagree on {name}; "
                             f"first step whose {counts} differ: "
                             f"{steps[0] if steps else None}")
    for name, a in vars(hc).items():
        atol = 1e-6 if name == "throttle_frac" else 1e-4
        torch.testing.assert_close(getattr(hg, name).cpu(), a, rtol=1e-4,
                                   atol=atol,
                                   msg=lambda m: f"{label} {name}: {m}")
    if events is not None:
        for name, a in vars(fc.events).items():
            torch.testing.assert_close(getattr(fg.events, name).cpu(), a,
                                       rtol=1e-4, atol=1e-4,
                                       msg=lambda m: f"{label} {name}: {m}")
    return fg, hg

def small_reference():
    system, table = small_case()
    scens = [T.Scenario.make("fcfs", "easy"),
             T.Scenario.make("sjf", "first-fit"),
             T.Scenario.make("acct_avg_power", "none")]
    card_vs_cpu("small reference", system, table, scens, t1=3600.0)
    print("small reference (marconi100 x64, 4 halls, 3 scenarios, 1 h): card "
          "matches the CPU engine, schedules exact, floats within 1e-4")

def small_grid_reference():
    """The grid path on the card against the CPU under a constant cap
    that binds: 40 % of the way from the idle floor to peak IT power."""
    system, table = small_case()
    system = dataclasses.replace(system, grid=dataclasses.replace(
        system.grid, c_min=0.05))
    floor = system.n_nodes * system.power.idle_node_w
    peak = system.n_nodes * system.power.peak_node_w
    n = int(round(2 * 3600.0 / system.dt))
    sig = gsig.constant_signals(n, carbon_gkwh=400.0, price_kwh=0.1,
                                cap_w=floor + 0.4 * (peak - floor))
    scens = [T.Scenario.make("fcfs", "easy"),
             T.Scenario.make("carbon_aware", "first-fit", carbon_weight=4.0,
                             cap_scale=0.8),
             T.Scenario.make("price_aware", "none", price_weight=4.0)]
    _, hg = card_vs_cpu("small grid reference", system, table, scens, sig)
    throttled = int((hg.throttle_frac > 1e-6).sum())
    if throttled == 0:
        raise SystemExit("small grid reference: the cap never bound")
    print(f"small grid reference (marconi100 x64, 4 halls, 3 scenarios, 2 h, "
          f"constant cap): card matches the CPU engine, schedules exact, "
          f"floats within 1e-4; {throttled} throttled scenario-steps")

def small_events_reference(card):
    """The event layer on the card against the CPU, on the 4-hall plant
    for 1 h: node, CDU-group and cell failures at rates that fire within
    the hour, one per-hall weather set per scenario; first without grid
    signals (the fused cooling path), then under neutral signals with a
    demand-response event (the group-power path)."""
    system, table = small_case()
    n = int(round(3600.0 / system.dt))
    floor = system.n_nodes * system.power.idle_node_w
    fails = [dict(failure_seed=3.0, node_fail_rate=5e-5, cdu_fail_rate=2e-4,
                  failure_corr=0.5, repair_s=900.0),
             dict(failure_seed=5.0, node_fail_rate=8e-5, cell_fail_rate=5e-4,
                  repair_s=1200.0),
             dict(failure_seed=7.0, node_fail_rate=2e-4, cdu_fail_rate=1e-4,
                  cell_fail_rate=2e-4, failure_corr=1.0, repair_s=600.0)]
    policies = [("fcfs", "easy"), ("sjf", "first-fit"),
                ("thermal_aware", "none")]
    weather = [wsig.stack_halls([wsig.heat_wave(
        wsig.synthetic_weather(n, system.dt, seed=10 * i + h), system.dt,
        900.0, 1800.0, 6.0 + h) for h in range(system.cooling.n_halls)])
        for i in range(3)]
    dr = dict(dr_announce_s=600.0, dr_notice_s=600.0, dr_duration_s=1200.0,
              dr_cap_w=floor + 0.2 * (system.n_nodes *
                                      system.power.peak_node_w - floor))
    for label, signals, extra in (
            ("small events reference", None, {}),
            ("small events+DR reference", gsig.neutral(n), dr)):
        scens = [T.Scenario.make(p, b, **f, **extra)
                 for (p, b), f in zip(policies, fails)]
        fg, hg = card_vs_cpu(label, system, table, scens, signals, weather,
                             EventConfig(), t1=3600.0)
        killed = fg.events.jobs_killed.tolist()
        if min(killed) < 1:
            raise SystemExit(f"{label}: a row killed no job: {killed}")
        dr_note = ", DR" if extra else ""
        print(f"[{card}] {label} (marconi100 x64, 4 halls, 3 scenarios, "
              f"1 h, per-hall weather, failures{dr_note}): card "
              f"matches the CPU engine, schedules exact, floats and event "
              f"state within 1e-4; jobs killed {killed}, node-hours down "
              f"{(fg.events.node_downtime_s / 3600.0).tolist()}")

# ---------------------------------------------------------------------------
# Trace replay and calibration (repro_torch.traces).
# ---------------------------------------------------------------------------
def measured_channel(js, prof_dt, seed, frac=2.0 / 3.0):
    """A measured per-node power profile, f32[J, Q] on the prof_dt grid
    over the longest job: the model profile (LOCF) times a slow seeded
    drift of 2-10 % with a 30 min to 2 h period, for ``frac`` of the
    jobs; the others stay at the -1 "no measurement" sentinel."""
    rng = np.random.default_rng(seed)
    J, P = js.power_prof.shape
    q = np.arange(max(1, int(np.ceil(float(np.max(js.wall)) / prof_dt))))
    amp = rng.uniform(0.02, 0.10, (J, 1))
    period = rng.uniform(1800.0, 7200.0, (J, 1))
    phase = rng.uniform(0.0, 2.0 * np.pi, (J, 1))
    drift = 1.0 + amp * np.sin(2.0 * np.pi * q * prof_dt / period + phase)
    meas = (js.power_prof[:, np.minimum(q, P - 1)] * drift).astype(
        np.float32)
    meas[rng.random(J) >= frac] = -1.0
    return meas

def jobsets_equal(a, b):
    return all((x is None and y is None) or
               (x is not None and y is not None and
                np.asarray(x).dtype == np.asarray(y).dtype and
                np.array_equal(x, y))
               for x, y in ((getattr(a, f.name), getattr(b, f.name))
                            for f in dataclasses.fields(a)
                            if f.name != "name"))

def replay_jobset(system, tmp):
    """The Frontier loader's day with whole-second times (the SWF
    contract, so every time column is compact) and a measured channel,
    written with ``jobset_to_npz`` and read back by ``load_trace``."""
    js = loaders.load_frontier(n_jobs=1238)
    for f in ("submit", "limit", "wall", "rec_start"):
        setattr(js, f, np.round(getattr(js, f)))
    js.power_profile = measured_channel(js, system.prof_dt, REPLAY_SEED)
    path = tmp / "frontier-replay.npz"
    traces.jobset_to_npz(js, path, digest="frontier-replay")
    back = loaders.load_trace([path])
    if not jobsets_equal(js, back):
        raise SystemExit("replay: the trace NPZ did not read back as written")
    return back, path

def weather_npz(tmp):
    """tests/data/weather_week.csv read with the stdlib, written as an NPZ
    of numeric seconds, dry-bulb and humidity: the card's weather path
    reads it with numpy alone (Stull wet-bulb in ``load_weather``)."""
    import csv
    import datetime
    with open(ROOT / "tests" / "data" / "weather_week.csv", newline="") as f:
        rows = list(csv.DictReader(f))
    path = tmp / "weather_week.npz"
    np.savez(path, timestamp=np.array(
        [datetime.datetime.fromisoformat(r["timestamp"]).timestamp()
         for r in rows]),
        t_drybulb_c=np.array([float(r["t_drybulb_c"]) for r in rows]),
        rh_pct=np.array([float(r["rh_pct"]) for r in rows]))
    return path

def trees_equal(a, b) -> bool:
    """Two port dataclasses (states or histories) bit for bit, NaN equal
    to NaN, None layers included."""
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if dataclasses.is_dataclass(x):
            if not trees_equal(x, y):
                return False
        elif x is None or y is None:
            if x is not y:
                return False
        elif x.dtype != y.dtype or x.shape != y.shape or not bool(
                ((x == y) | (x.isnan() & y.isnan())).all()
                if x.is_floating_point() else torch.equal(x, y)):
            return False
    return True

def replay_path(card, tmp):
    """frontier-replay-2h: the no-grid sweep at Frontier's width replaying
    a measured power channel, compact time columns, the measured weather
    week; one fused_cooling launch a step. Returns the trace and weather
    NPZ paths for the CLI phase."""
    system = get_system("frontier")
    js, npz = replay_jobset(system, tmp)
    js.assign_prepop_placement(0.0, system.n_nodes)
    table = js.to_table(compact_time=True, replay_power=True)
    for f in ("submit", "limit", "wall", "rec_start"):
        if getattr(table, f).dtype != torch.int32:
            raise SystemExit(f"replay: {f} is {getattr(table, f).dtype}")
    n_steps = int(round(REPLAY_T1 / system.dt))
    wx = weather_npz(tmp)
    weather = traces.load_weather(wx, n_steps, system.dt)
    scens = [T.Scenario.make(p, b, setpoint_delta_c=d)
             for p, b, d in REPLAY_SWEEP]
    S = len(scens)
    prof = table.power_profile
    measured = int((prof >= 0).any(1).sum())
    print(f"replay path: frontier N={system.n_nodes} "
          f"G={system.cooling.n_groups} J={table.num_jobs} ({measured} "
          f"measured) steps={n_steps} S={S}; channel f32{list(prof.shape)} "
          f"= {prof.numel() * prof.element_size()} B; wet-bulb "
          f"{float(weather.t_wetbulb_c.min())!r}.."
          f"{float(weather.t_wetbulb_c.max())!r} C")
    run = lambda: eng.simulate_sweep(system, table, scens, 0.0, REPLAY_T1,
                                     weather=weather)
    (finals, hists), wall, launches = run_counted(run)
    print(f"[{card}] replay sweep: {n_steps} steps x {S} scenarios in "
          f"{wall!r} s = {n_steps / wall!r} steps/s, launches {launches}")
    if launches["fused_cooling"] != n_steps or launches["group_power"] != 0:
        raise SystemExit(f"replay sweep of {n_steps} steps launched "
                         f"{launches}")
    check_run("replay sweep", finals, hists, n_steps, S)
    ledger = hists.power_total.double().sum(1) * system.dt
    torch.testing.assert_close(finals.energy_total.double(), ledger,
                               rtol=1e-4, atol=0.0,
                               msg=lambda m: f"replay energy ledger: {m}")
    for i, (p, b, d) in enumerate(REPLAY_SWEEP):
        s = stats_mod.summarize(system, table, T.row(finals, i),
                                T.row(hists, i))
        print(f"  {p}:{b} setpoint {d:+.0f} C: jobs_completed="
              f"{s['jobs_completed']:.0f} avg_util={s['avg_util']:.4f} "
              f"avg_pue={s['avg_pue']:.5f} "
              f"t_tower_return_max_c={s['t_tower_return_max_c']:.3f}")
    check_row_vs_solo("replay sweep", finals, hists, eng.simulate_static(
        system, table, *FIG4[0], 0.0, REPLAY_T1, weather=weather))
    del finals, hists

    # the bit-for-bit identities, on the first REPLAY_WINDOW steps
    t_w = REPLAY_WINDOW * system.dt
    window = lambda tab: eng.simulate_sweep(system, tab, scens, 0.0, t_w,
                                            weather=weather)
    model = js.to_table(compact_time=True)
    sentinel = dataclasses.replace(model, power_profile=torch.full_like(
        prof, -1.0))
    for label, a, b in (
            ("all-sentinel replay = the model table", model, sentinel),
            ("compact time = float32 time", js.to_table(replay_power=True),
             table)):
        ra, rb = window(a), window(b)
        if not (trees_equal(ra[0], rb[0]) and trees_equal(ra[1], rb[1])):
            raise SystemExit(f"replay: {label} does not hold bit for bit")
        print(f"[{card}] replay, {REPLAY_WINDOW} steps x {S}: {label}, "
              f"final state and history bit for bit")
    admit_s, total = admission_share(lambda: window(table))
    print(f"[{card}] replay admission loop ({REPLAY_WINDOW} steps): "
          f"{admit_s!r} s of {total!r} s = {admit_s / total!r} of step time "
          f"(synchronised run)")
    return npz, wx

def replay_cli(card, npz, wx, tmp):
    """The CLI's trace flags on the card, as a process: the replay NPZ,
    --replay-power and the weather NPZ; its manifest records the digests."""
    manifest = tmp / "replay-run.json"
    cmd = [sys.executable, "-m", "repro_torch.launch.simulate", "--system",
           "frontier", "-t", "30m", "--policy", "fcfs", "--backfill", "easy",
           "--trace", str(npz), "--replay-power", "--weather-trace", str(wx),
           "--manifest", str(manifest)]
    t = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, env=dict(
        os.environ, PYTHONPATH=str(ROOT / "src")), capture_output=True,
        text=True, timeout=600)
    wall = time.perf_counter() - t
    if proc.returncode != 0:
        raise SystemExit(f"replay CLI exited {proc.returncode}: "
                         f"{proc.stderr[-3000:]}")
    m = json.loads(manifest.read_text())
    want = {"weather_trace_digest": traces.source_digest(wx),
            "trace_digest": traces.source_digest(npz)}
    got = {k: m.get(k) for k in want}
    if got != want or m["scenario"]["replay_power"] is not True:
        raise SystemExit(f"replay CLI manifest: {got} != {want}, scenario "
                         f"{m['scenario']}")
    pue = [ln.strip() for ln in proc.stdout.splitlines() if "avg_pue" in ln]
    print(f"[{card}] replay CLI (frontier, 30 min, fcfs:easy, --trace NPZ "
          f"--replay-power --weather-trace NPZ) exited 0 in {wall!r} s; "
          f"manifest weather_trace_digest {got['weather_trace_digest'][:16]}"
          f"...; {pue}")

def calibrate_path(card, tmp):
    """Cooling-plant calibration on the card over the committed fixture
    (8,640 steps of 20 s): the graphed rollout against the eager loop, the
    whole fixture on the card against the CPU, then ``simulate calibrate
    --out`` and ``--check`` as processes on a 2,880 step window of it,
    whose fit must recover the truth within 2 %."""
    z = np.load(CAL_DIR / "telemetry.npz", allow_pickle=False)
    cfg = get_system("frontier").cooling
    committed = cal.FittedParams.load(CAL_DIR / "fitted_params.json")
    heat, dt, wb = z["p_it_w"], float(z["dt"]), z["t_wetbulb_c"]
    obs = {ch: z[ch] for ch in CAL_CHANNELS}
    roll = cal._Rollout(cfg, tuple(committed.params),
                        cal._as_group_heat(heat[:REPLAY_WINDOW],
                                           cfg.n_groups),
                        dt, wb[:REPLAY_WINDOW], DEV)
    theta = list(committed.params.values())
    forward = roll.graphed()
    per_step = {}
    for label, fn in (("eager", roll.eager), ("graphed", forward)):
        fn(theta)                                  # warm
        t = time.perf_counter()
        per_step[label] = (fn(theta), (time.perf_counter() - t) * 1e3 /
                           REPLAY_WINDOW)
    (eager, eager_ms), (graphed, graph_ms_) = per_step.values()
    if any(not np.array_equal(eager[ch], graphed[ch])
           for ch in CAL_CHANNELS):
        raise SystemExit("calibrate: the graphed rollout differs from the "
                         "eager loop")
    print(f"[{card}] calibrate plant step (frontier, 25 groups, one "
          f"scenario): eager loop {eager_ms!r} ms a step, CUDA graph "
          f"replay {graph_ms_!r} ms a step ({REPLAY_WINDOW} steps, host "
          f"clock, observables read back)")
    t = time.perf_counter()
    got = cal.simulate_plant(cfg, heat, dt, wb, overrides=committed.params)
    card_s = time.perf_counter() - t
    t = time.perf_counter()
    want = cal.simulate_plant(cfg, heat, dt, wb, overrides=committed.params,
                              device="cpu")
    cpu_s = time.perf_counter() - t
    errs = {}
    for ch in CAL_CHANNELS:
        np.testing.assert_allclose(got[ch], want[ch], rtol=CAL_STEP_RTOL,
                                   err_msg=f"calibrate card vs CPU {ch}")
        a, b = got[ch].astype(np.float64), want[ch].astype(np.float64)
        errs[ch] = float((np.abs(a - b) / np.abs(b)).max())
    fresh = cal._envelope(got, obs, int(committed.meta["discard"]))
    print(f"[{card}] calibrate: {REPLAY_WINDOW} graphed steps = the eager "
          f"loop bit for bit; the fixture's {len(heat)} steps on the card "
          f"in {card_s!r} s (CPU {cpu_s!r} s), card vs CPU max rel "
          f"{errs} within rtol {CAL_STEP_RTOL}; fresh RMSEs {fresh} beside "
          f"the committed envelope {committed.envelope}")
    out, window = tmp / "fitted.json", tmp / "telemetry-window.npz"
    np.savez(window, **{k: z[k][CAL_CLI_WINDOW] if z[k].ndim else z[k]
                        for k in z.files})
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    base = [sys.executable, "-m", "repro_torch.launch.simulate", "calibrate",
            "--telemetry", str(window)]
    for args, label in ((["--out", str(out)], "fit"),
                        (["--check", str(out)], "check")):
        t = time.perf_counter()
        proc = subprocess.run(base + args, cwd=ROOT, env=env,
                              capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - t
        if proc.returncode != 0 or (label == "check" and
                                    "envelope holds" not in proc.stdout):
            raise SystemExit(f"calibrate CLI {label} exited "
                             f"{proc.returncode}: {proc.stdout[-2000:]} "
                             f"{proc.stderr[-2000:]}")
        print(f"[{card}] simulate calibrate {' '.join(args[:1])} (steps "
              f"{CAL_CLI_WINDOW.start}-{CAL_CLI_WINDOW.stop} of the "
              f"fixture): exit 0 in "
              f"{wall!r} s; " + "; ".join(ln.strip() for ln in
                                          proc.stdout.splitlines()))
    cli_fit = cal.FittedParams.load(out)
    errs = {n: abs(v - float(z[f"true_{n}"])) / float(z[f"true_{n}"])
            for n, v in cli_fit.params.items()}
    print(f"[{card}] calibrate CLI fit: relative error to the truth {errs}")
    if sorted(errs) != sorted(cal.DEFAULT_FIT) or \
            max(errs.values()) > CAL_RECOVERY:
        raise SystemExit(f"calibrate CLI: the fit missed the truth: {errs}")

def small_replay_reference(card):
    """Replay with the event layer on the card against the CPU: the SWF
    trace tests/data/pm100_small.swf (read with numpy alone) with a seeded
    measured channel, compact time, on Marconi100 scaled to 64 nodes, its
    busiest hour moved to t = 0; the reference's kill scenario."""
    system = get_system("marconi100").scaled(64)
    js = swf.read_swf(str(ROOT / "tests" / "data" / "pm100_small.swf"))
    grid = np.unique(js.rec_start)
    busy = [int(js.nodes[(js.rec_start <= t) &
                         (js.rec_start + js.wall > t)].sum()) for t in grid]
    shift = float(grid[int(np.argmax(busy))]) - 1800.0
    js.submit, js.rec_start = js.submit - shift, js.rec_start - shift
    js.power_profile = measured_channel(js, system.prof_dt, REPLAY_SEED)
    js.assign_prepop_placement(0.0, system.n_nodes)
    table = js.to_table(compact_time=True, replay_power=True)
    scens = [T.Scenario.make("fcfs", "easy", **KILL),
             T.Scenario.make("replay", "none"),
             T.Scenario.make("sjf", "first-fit", setpoint_delta_c=2.0)]
    t1 = 120 * system.dt
    fg, _ = card_vs_cpu("small replay reference", system, table, scens,
                        events=EventConfig(), t1=t1, num_accounts=64)
    killed = fg.events.jobs_killed.tolist()
    if killed[0] < 1:
        raise SystemExit(f"small replay reference killed no job: {killed}")
    print(f"[{card}] small replay reference (pm100_small.swf, marconi100 "
          f"x64, {int((table.power_profile >= 0).any(1).sum())} of "
          f"{len(js)} jobs measured, 3 scenarios, 120 steps, failures): card "
          f"matches the CPU engine, schedules exact, floats and event state "
          f"within 1e-4; jobs killed {killed}")

# ---------------------------------------------------------------------------
# fig7: external schedulers (repro_torch.core.external), on Frontier.
# ---------------------------------------------------------------------------
# benchmarks/fig7_external.py's workload: a synthetic Frontier backlog of
# 5,324 jobs over 15 days (the paper's fig7 count), load 0.9
FIG7_SPEC = dict(n_jobs=5324, duration_s=15 * 86400.0, load=0.9,
                 trace_len=1, n_accounts=64, mean_wall_s=7200.0, seed=42)
FIG7_SEQ_T1 = 3 * 3600.0     # the replayed window (cut from 15 days)
FIG7_PLUGIN_T1 = 6 * 3600.0  # fig7_external.py's plugin window
FIG7_NDJSON_T1 = 3600.0      # the NDJSON-pinned peer's window
FIG7_GRID_T1 = 3600.0        # the grid external_step run
FIG7_PEER = [sys.executable, str(ROOT / "tools" / "reference_peer.py")]
PEER_HANDSHAKE_S = 300.0     # spawn + the peer's whole schedule + ack

def fig7_case():
    system = get_system("frontier")
    return system, generate(system, WorkloadSpec(**FIG7_SPEC))

def reaped(peer, label):
    if peer._proc is not None or not peer.spawned or any(
            p.returncode is None for p in peer.spawned):
        raise SystemExit(f"{label}: a peer process was left unreaped")

def hists_equal(a, b, label, n=None):
    """Two plugin histories (dicts of numpy arrays) bit for bit, on the
    first ``n`` steps of ``b`` when given."""
    if set(a) != set(b):
        raise SystemExit(f"{label}: history keys differ")
    for k in a:
        if not np.array_equal(a[k], b[k][:n] if n else b[k]):
            raise SystemExit(f"{label}: channel {k!r} differs")

def timed_polls(bridge):
    """Record each ``bridge.poll``'s wall time (seconds) in a list."""
    lat, poll = [], bridge.poll

    def timed(t):
        t0 = time.perf_counter()
        out = poll(t)
        lat.append(time.perf_counter() - t0)
        return out
    bridge.poll = timed
    return lat

def plugin_run(card, label, system, js, bridge, t1):
    """Plugin mode on the card, counted: fused_cooling once a step."""
    lat = timed_polls(bridge)
    (final, hist, wall), _, launches = run_counted(
        lambda: ext.run_plugin_mode(system, js, bridge, 0.0, t1))
    n_steps = int(round(t1 / system.dt))
    if launches["fused_cooling"] != n_steps or launches["group_power"] != 0:
        raise SystemExit(f"{label}: {n_steps} steps launched {launches}")
    check_run(label, final, T.StepRecord(**{
        k: torch.from_numpy(v)[None] for k, v in hist.items()}), n_steps, 1)
    st = bridge.stats()
    print(f"[{card}] {label}: {n_steps} steps in {wall!r} s = "
          f"{n_steps / wall!r} steps/s, {t1 / wall!r}x real time; launches "
          f"{launches}; bridge polls {st['polls']}, poll p50 "
          f"{float(np.median(lat)) * 1e3!r} ms, max {max(lat) * 1e3!r} ms, "
          f"{sum(lat) / wall!r} of the wall in the poll; reconnects "
          f"{st['reconnects']}; peer {st.get('peer')}")
    return hist, launches

def fig7_path(card):
    """Sequential and plugin mode at Frontier's width on fig7's backlog,
    the reference peer as a subprocess, and ``external_step`` on the
    grid branch; returns the two kernels' launch counts of each run."""
    system, js = fig7_case()
    N, G = system.n_nodes, system.cooling.n_groups
    print(f"fig7 path: frontier N={N} G={G} J={len(js)} over "
          f"{FIG7_SPEC['duration_s'] / 86400.0:.0f} days, load "
          f"{FIG7_SPEC['load']}")
    # the reference peer's whole schedule equals FastSimLike's exactly
    t = time.perf_counter()
    fs = ext.FastSimLike(policy="fcfs", backfill="firstfit")
    fs.reset(system, js, 0.0)
    fs_s = time.perf_counter() - t
    peer = tr.SubprocessPeer(cmd=FIG7_PEER, policy="fcfs",
                             backfill="firstfit",
                             handshake_timeout_s=PEER_HANDSHAKE_S)
    try:
        t = time.perf_counter()
        peer.reset(system, js, 0.0)
        remote = np.asarray(peer.start, np.float64)
        peer_s = time.perf_counter() - t
    finally:
        peer.close()
    reaped(peer, "fig7 schedule")
    fin = np.isfinite(fs.start)
    if not (np.array_equal(fin, np.isfinite(remote)) and
            np.array_equal(fs.start[fin], remote[fin])):
        raise SystemExit("fig7: the peer's schedule differs from "
                         "FastSimLike's")
    print(f"[{card}] fig7 schedule: FastSimLike {fs_s!r} s, the reference "
          f"peer over the wire ({peer.stats()['wire']}) {peer_s!r} s; "
          f"{int(fin.sum())} of {len(js)} jobs started, equal exactly")
    counts = {}

    # sequential: FastSimLike schedules the whole backlog, the twin replays
    # the first FIG7_SEQ_T1 of it
    n_steps = int(round(FIG7_SEQ_T1 / system.dt))
    seq = lambda: ext.run_sequential_mode(
        system, js, ext.FastSimLike(policy="fcfs", backfill="firstfit"),
        0.0, FIG7_SEQ_T1)
    (final, hist), wall, launches = run_counted(seq)
    counts["sequential"] = launches
    if launches["fused_cooling"] != n_steps or launches["group_power"] != 0:
        raise SystemExit(f"fig7 sequential: {n_steps} steps launched "
                         f"{launches}")
    check_run("fig7 sequential", final, T.tree_map(lambda x: x[None], hist),
              n_steps, 1)
    s = stats_mod.summarize(system, js.to_table(), final, hist)
    if s["jobs_completed"] < 1:
        raise SystemExit(f"fig7 sequential completed no job: {s}")
    print(f"[{card}] fig7 sequential ({FIG7_SEQ_T1 / 3600:.0f} h replayed, "
          f"the schedule included): {n_steps} steps in {wall!r} s = "
          f"{n_steps / wall!r} steps/s, {FIG7_SEQ_T1 / wall!r}x real time; "
          f"launches {launches}; jobs_completed={s['jobs_completed']:.0f} "
          f"avg_util={s['avg_util']:.4f} avg_pue={s['avg_pue']:.5f}")
    del final, hist

    # plugin: in process, then the reference peer over auto (binary) and
    # NDJSON frames; every channel bit for bit
    in_proc = ext.SchedulerBridge(ext.FastSimLike(policy="fcfs",
                                                  backfill="firstfit"))
    h_in, counts["plugin"] = plugin_run(card, "fig7 plugin, in process",
                                        system, js, in_proc, FIG7_PLUGIN_T1)
    for wire, t1, expect in (("auto", FIG7_PLUGIN_T1, "binary"),
                             ("ndjson", FIG7_NDJSON_T1, "ndjson")):
        peer = tr.SubprocessPeer(cmd=FIG7_PEER, wire=wire,
                                 handshake_timeout_s=PEER_HANDSHAKE_S)
        try:
            h, counts[f"plugin {wire}"] = plugin_run(
                card, f"fig7 plugin, subprocess peer wire={wire}", system,
                js, ext.SchedulerBridge(peer), t1)
            got = peer.stats()["wire"]
        finally:
            peer.close()
        reaped(peer, f"fig7 plugin wire={wire}")
        if got != expect:
            raise SystemExit(f"fig7 plugin: wire={wire} negotiated {got}")
        hists_equal(h, h_in, f"fig7 plugin wire={wire} vs in process",
                    n=int(round(t1 / system.dt)))
    print(f"fig7 plugin: the peer's rows over binary "
          f"({FIG7_PLUGIN_T1 / 3600:.0f} h) and NDJSON "
          f"({FIG7_NDJSON_T1 / 3600:.1f} h) equal the in-process rows bit "
          f"for bit; every peer process reaped")

    # external_step on the grid branch: frontier-grid-6h's signals, a cap
    # scaled to bind halfway between the idle floor and this hour's peak
    gsys = dataclasses.replace(system, grid=dataclasses.replace(
        system.grid, c_min=0.05))
    n_steps = int(round(FIG7_GRID_T1 / system.dt))
    peak_it = N * system.power.peak_node_w
    sig = gsig.synthetic_signals(gsys.grid, n_steps, system.dt,
                                 t0=GRID_T0_CLOCK, seed=11,
                                 cap_base_w=0.9 * peak_it,
                                 cap_peak_w=0.55 * peak_it)
    floor = N * system.power.idle_node_w
    p_hour = h_in["power_it"][:n_steps]
    cap_scale = (floor + 0.5 * (float(p_hour.max()) - floor)) / \
        float(sig.cap_w.max())
    counts["grid"], rows, wall = grid_external(gsys, js, sig, cap_scale,
                                               n_steps)
    over = rows.power_it - rows.cap_w
    throttled = int((rows.throttle_frac > 0).sum())
    if counts["grid"]["group_power"] != n_steps or \
            counts["grid"]["fused_cooling"] != 0:
        raise SystemExit(f"fig7 grid: {n_steps} steps launched "
                         f"{counts['grid']}")
    if throttled < 1 or not (over <= 1.0).all():
        raise SystemExit(f"fig7 grid: {throttled} throttled steps, largest "
                         f"excess over the cap {float(over.max())!r} W")
    print(f"[{card}] fig7 external_step, grid branch (1 h, cap_scale "
          f"{cap_scale!r}): {n_steps} steps in {wall!r} s = "
          f"{n_steps / wall!r} steps/s, launches {counts['grid']}; "
          f"{throttled} throttled steps, max throttle_frac "
          f"{float(rows.throttle_frac.max())!r}, power_it <= cap_w + 1 W "
          f"at every step (largest excess {float(over.max())!r} W)")
    return counts

def grid_external(system, js, sig, cap_scale, n_steps):
    """``external_step`` with grid signals, placements from FastSimLike,
    counted; returns (launches, StepRecord, wall seconds)."""
    table = js.to_table().to(DEV)
    sig = sig.to(DEV)
    scen = T.tree_map(lambda x: x.to(DEV), T.stack_scenarios(
        [T.Scenario.make("replay", cap_scale=cap_scale)]))
    fs = ext.FastSimLike(policy="fcfs", backfill="firstfit")
    fs.reset(system, js, 0.0)

    def run():
        st = eng._fresh(system, table, 1, 0.0, n_steps * system.dt, None,
                        64, None, DEV)
        rows, running = [], set()
        for i in range(n_steps):
            new = sorted(set(fs.running_at(i * system.dt).tolist()) -
                         running)[:64]
            st, rec = eng.external_step(system, table, st, new, signals=sig,
                                        scen=scen)
            running = set(torch.nonzero(st.jstate[0] == T.RUNNING)
                          .flatten().tolist())
            rows.append(rec)
        return T.row(eng._history(rows), 0)
    rows, wall, launches = run_counted(run)
    return launches, rows, wall

def small_external_reference(card):
    """Plugin and sequential mode on the 64-node test system, on the card
    against the port's CPU path: schedules exact, floats within 1e-4."""
    system = get_system("frontier").scaled(64)
    js = generate(system, WorkloadSpec(n_jobs=40, duration_s=2 * 3600.0,
                                       load=1.2, trace_len=4, seed=3))
    runs = {}
    for dev in ("cuda", "cpu"):
        final, hist, _ = ext.run_plugin_mode(
            system, js, ext.FastSimLike(policy="sjf", backfill="firstfit"),
            0.0, 3600.0, device=dev)
        sf, sh = ext.run_sequential_mode(system, js, ext.FastSimLike(), 0.0,
                                         3600.0, device=dev)
        runs[dev] = (final, T.StepRecord(**{
            k: torch.from_numpy(v) for k, v in hist.items()}), sf, sh)
    for i, label in ((0, "plugin"), (2, "sequential")):
        (fg, hg), (fc, hc) = runs["cuda"][i:i + 2], runs["cpu"][i:i + 2]
        for name in ("jstate", "start", "end", "node_job"):
            if not torch.equal(getattr(fg, name).cpu(), getattr(fc, name)):
                raise SystemExit(f"small external {label}: card and CPU "
                                 f"disagree on {name}")
        for name, a in vars(hc).items():
            torch.testing.assert_close(
                getattr(hg, name).cpu(), a, rtol=1e-4, atol=1e-4,
                msg=lambda m: f"small external {label} {name}: {m}")
    print(f"[{card}] small external reference (frontier x64, 40 jobs, 1 h): "
          f"plugin and sequential mode on the card match the CPU path, "
          f"schedules exact, floats within 1e-4")

def cli_process(label, args, timeout=600):
    """The port's simulate CLI as a process on the card, under --json;
    returns (its JSON document, wall seconds, its progress log)."""
    t = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.simulate", *args,
         "--json"], cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
        capture_output=True, text=True, timeout=timeout)
    wall = time.perf_counter() - t
    if proc.returncode != 0:
        raise SystemExit(f"CLI {label} exited {proc.returncode}: "
                         f"{proc.stderr[-3000:]}")
    return json.loads(proc.stdout), wall, proc.stderr

def external_cli(card):
    """The CLI's external flags on the card, as processes, 1 h each:
    ``--scheduler fastsim`` and the reference peer in plugin mode."""
    base = ["--system", "frontier", "-t", "30m"]
    peer = " ".join(FIG7_PEER)
    for label, extra in (("--scheduler fastsim", ["--scheduler", "fastsim"]),
                         ("--external-cmd (plugin)",
                          ["--external-cmd", peer, "--external-mode",
                           "plugin"])):
        doc, wall, _ = cli_process(label, base + extra)
        runs = {k: v for k, v in doc.items() if k != "bridge"}
        (name, s), = runs.items()
        if not (0.0 < s["avg_util"] <= 1.0 and 1.0 < s["avg_pue"] < 1.5):
            raise SystemExit(f"CLI {label}: summary {s}")
        bridge = doc.get("bridge")
        if ("plugin" in label) != (bridge is not None) or (
                bridge and bridge["polls"] != 120):
            raise SystemExit(f"CLI {label}: bridge {bridge}")
        print(f"[{card}] CLI {label} (frontier, 30 min) exited 0 in "
              f"{wall!r} "
              f"s: {name} avg_util={s['avg_util']:.4f} "
              f"avg_pue={s['avg_pue']:.5f}"
              + (f"; bridge polls {bridge['polls']}, peer wire "
                 f"{bridge['peer']['wire']}" if bridge else ""))

# ---------------------------------------------------------------------------
# fig8: the collect-then-redeem incentive workflow through the CLI, on
# Marconi100; the CLI's other flags and the sharded sweep at Frontier's
# width.
# ---------------------------------------------------------------------------
# marconi100-incentives-3h: benchmarks/fig8_incentives.py's backlog (1,500
# jobs over a day, seed 8) at full width, 3 h (cut from fig8's 0.8 day)
FIG8_DATA = ["--system", "marconi100", "--jobs", "1500", "--days", "1",
             "--seed", "8"]
# (at 2 h no warm redeem starts a job otherwise than the cold sweep)
FIG8_T, FIG8_T1 = "3h", 3 * 3600.0
FIG8_REDEEM = ["acct_avg_power", "acct_low_avg_power", "acct_edp",
               "acct_fugaku_pts"]
FIG8_SWEEP = [f"{p}:first-fit" for p in FIG8_REDEEM]
FIG8_TOP = 8                 # fig8's favored accounts: the top 8 by rank
# the sharded sweep's window: 60 steps (cut from 1 h for the script's
# time; the split's identity does not depend on the window)
SHARD_T1 = 900.0

def read_stats(path):
    """stats.out as {name: value}."""
    rows = {}
    for line in path.read_text().splitlines():
        k, v = line.split(" : ")
        rows[k.strip()] = float(v.replace(",", ""))
    return rows

def run_dirs(out, doc, labels, log):
    """The run directories a CLI call wrote under ``out``, in the order of
    its runs (``labels``), as its progress log names them ("output -> DIR"
    after each run), each one's stats.out checked against that run's
    summary in the JSON document."""
    dirs = [pathlib.Path(d) for d in re.findall(r"^output -> (.+)$", log,
                                                re.M)]
    if len(dirs) != len(labels) or sorted(dirs) != sorted(out.iterdir()):
        raise SystemExit(f"{out}: the log names {dirs} for the runs "
                         f"{labels}; the directory holds "
                         f"{sorted(out.iterdir())}")
    for label, d in zip(labels, dirs):
        want = {k: float(f"{v:,.3f}".replace(",", ""))
                for k, v in doc[label].items()}
        if read_stats(d / "stats.out") != want:
            raise SystemExit(f"{d}/stats.out is not the summary of {label}")
    return dirs

def job_history(d):
    """job_history.csv as (start f64[J], account i64[J], state i64[J])."""
    with open(d / "job_history.csv") as f:
        rows = list(csv.DictReader(f))
    return (np.array([float(r["start"]) for r in rows]),
            np.array([int(r["account"]) for r in rows]),
            np.array([int(r["state"]) for r in rows]))

def favored_start_advantage(policy, ledger, account, start):
    """benchmarks/fig8_incentives.py's metric: the mean start of the
    other accounts' jobs minus that of the top 8 accounts' by the
    policy's own ranking of the collected ledger (started jobs only; 0
    when either set is empty, as there). Returns (it, the top accounts'
    started jobs)."""
    pts = np.asarray(ledger["fugaku_pts"], np.float32)
    avg_pw = np.asarray(ledger["power_sum"], np.float32) / np.maximum(
        np.asarray(ledger["jobs_done"], np.float32), 1.0)
    rank = {"acct_avg_power": -avg_pw, "acct_low_avg_power": avg_pw,
            "acct_edp": np.asarray(ledger["edp"], np.float32),
            "acct_fugaku_pts": -pts}[policy]
    top = np.argsort(rank)[:FIG8_TOP]
    started = np.isfinite(start)
    m_top = np.isin(account, top) & started
    m_rest = ~np.isin(account, top) & started
    adv = float(start[m_rest].mean() - start[m_top].mean()) \
        if m_top.any() and m_rest.any() else 0.0
    return adv, int(m_top.sum())

def manifest_rate(path, n_steps):
    """(run wall seconds, steps/s) from a CLI call's manifest."""
    wall = json.loads(path.read_text())["wall_s"]
    return wall, n_steps / wall

def incentives_path(card, tmp):
    """marconi100-incentives-3h: fig8's workflow as two CLI processes on
    the card, collect (replay, --accounts -o) then redeem (the four
    acct_* policies under first-fit, --accounts-json), each redeem row
    held against the same sweep run in process from empty ledgers, one
    fused_cooling launch a step."""
    system = get_system("marconi100")
    n_steps = int(round(FIG8_T1 / system.dt))
    print(f"incentives path marconi100-incentives-3h: N={system.n_nodes} "
          f"G={system.cooling.n_groups} steps={n_steps}; {' '.join(FIG8_DATA)}")
    col = tmp / "collect"
    doc, wall, log = cli_process("collect", FIG8_DATA + [
        "--policy", "replay", "-t", FIG8_T, "--accounts", "-o", str(col),
        "--manifest", str(tmp / "collect.json")])
    (cdir,) = run_dirs(col, doc, ["replay:none"], log)
    if doc["output_dir"] != str(cdir):
        raise SystemExit(f"collect: output_dir {doc['output_dir']}")
    ledger = json.loads((cdir / "accounts.json").read_text())
    start, account, state = job_history(cdir)
    done = int((state == T.DONE).sum())
    if sum(ledger["jobs_done"]) != done or done < 1:
        raise SystemExit(f"collect: the ledger counts "
                         f"{sum(ledger['jobs_done'])} jobs done, "
                         f"job_history.csv {done}")
    run_s, rate = manifest_rate(tmp / "collect.json", n_steps)
    print(f"[{card}] collect (replay, --accounts -o): process {wall!r} s, "
          f"run {run_s!r} s = {rate!r} steps/s; {done} jobs done = the "
          f"ledger's jobs_done ({len(ledger['jobs_done'])} accounts), "
          f"{len(start)} jobs in job_history.csv")

    red = tmp / "redeem"
    doc, wall, log = cli_process("redeem", FIG8_DATA + [
        "-t", FIG8_T, "--sweep", *FIG8_SWEEP, "--accounts-json",
        str(cdir / "accounts.json"), "--accounts", "-o", str(red),
        "--manifest", str(tmp / "redeem.json")])
    rdirs = run_dirs(red, doc, FIG8_SWEEP, log)
    run_s, rate = manifest_rate(tmp / "redeem.json", n_steps)
    print(f"[{card}] redeem ({len(FIG8_SWEEP)} acct_* policies, "
          f"--accounts-json): process {wall!r} s, run {run_s!r} s = "
          f"{rate!r} steps/s")

    # the same sweep in process from empty ledgers, counted
    js = loaders.load("marconi100", n_jobs=1500, days=1.0, seed=8)
    js.assign_prepop_placement(0.0, system.n_nodes)
    table = js.to_table()
    scens = [T.Scenario.make(p, "first-fit") for p in FIG8_REDEEM]
    (cold, _), cold_s, launches = run_counted(lambda: eng.simulate_sweep(
        system, table, scens, 0.0, FIG8_T1))
    if launches["fused_cooling"] != n_steps or launches["group_power"] != 0:
        raise SystemExit(f"cold redeem of {n_steps} steps launched "
                         f"{launches}")
    print(f"[{card}] cold redeem in process (empty ledgers): {cold_s!r} s = "
          f"{n_steps / cold_s!r} steps/s, launches {launches}")
    # job_history.csv prints whole seconds
    cold_start = np.array([[float(f"{v:.0f}") for v in row] for row in
                           cold.start.cpu().numpy()[:, :len(js)]])
    differ = {}
    for i, (p, d) in enumerate(zip(FIG8_REDEEM, rdirs)):
        w_start, w_account, w_state = job_history(d)
        if not np.array_equal(w_account, np.asarray(js.account)):
            raise SystemExit(f"redeem {p}: another backlog than the cold run's")
        n_moved = int((w_start != cold_start[i]).sum())
        differ[p] = n_moved > 0
        folded = sum(json.loads((d / "accounts.json").read_text())[
            "jobs_done"]) - sum(ledger["jobs_done"])
        if folded != int((w_state == T.DONE).sum()):
            raise SystemExit(f"redeem {p}: the ledger gained {folded} jobs, "
                             f"job_history.csv completed "
                             f"{int((w_state == T.DONE).sum())}: the warm "
                             f"ledger did not start it")
        s = doc[f"{p}:first-fit"]
        warm, n_top = favored_start_advantage(p, ledger, w_account, w_start)
        cold_adv, _ = favored_start_advantage(p, ledger, w_account,
                                              cold_start[i])
        print(f"  [{card}] {p}:first-fit: favored_start_advantage_s warm "
              f"{warm!r}, cold {cold_adv!r}, warm - cold {warm - cold_adv!r} "
              f"({n_top} started jobs of the top {FIG8_TOP} accounts); "
              f"{n_moved} jobs start otherwise than from empty ledgers; "
              f"jobs_completed={s['jobs_completed']:.0f} "
              f"avg_wait_s={s['avg_wait_s']:.1f} "
              f"avg_util={s['avg_util']:.4f} avg_pue={s['avg_pue']:.5f}")
    same = [p for p, d in differ.items() if not d]
    print(f"incentives: the warm redeem differs from the cold one in start "
          f"times for {[p for p, d in differ.items() if d]}; not for {same}")
    if len(same) == len(FIG8_REDEEM):
        raise SystemExit("incentives: no redeem row differs from the cold "
                         "sweep: the collected ledger did not reach the "
                         "engine")
    return launches

def frontier_flags_cli(card, tmp):
    """The CLI's other flags at Frontier's width, one process: four halls,
    two cells of hall 0 offline, a 6 h fast-forward, a 30 min sweep,
    -o."""
    out = tmp / "frontier"
    labels = ["fcfs:easy", "sjf:first-fit"]
    doc, wall, log = cli_process("frontier flags", [
        "--system", "frontier", "--halls", "4", "--cells-offline", "2,0,0,0",
        "-ff", "6h", "-t", "30m", "--sweep", *labels, "-o", str(out)])
    dt = get_system("frontier").dt
    for label, d in zip(labels, run_dirs(out, doc, labels, log)):
        h = np.load(d / "history.npz")
        t, cells = h["t"], h["cells_online"]
        # a row's t is its step's start: the first is t0, as in the
        # reference's history
        if t[0] != 6 * 3600.0 or t[-1] != 6.5 * 3600.0 - dt or \
                len(t) != 120:
            raise SystemExit(f"frontier flags {label}: t from {t[0]} to "
                             f"{t[-1]} over {len(t)} steps")
        if cells.shape != (120, 4) or not (cells[:, 1:] - cells[:, :1]
                                           == 2.0).all():
            raise SystemExit(f"frontier flags {label}: cells_online "
                             f"{cells.min(0)}..{cells.max(0)}")
        s = doc[label]
        if not (0.0 < s["avg_util"] <= 1.0 and 1.0 < s["avg_pue"] < 1.5):
            raise SystemExit(f"frontier flags {label}: summary {s}")
        print(f"[{card}] CLI frontier --halls 4 --cells-offline 2,0,0,0 -ff "
              f"6h -t 30m {label}: t {float(t[0])!r}..{float(t[-1])!r} s, "
              f"cells_online "
              f"{cells[0].tolist()} at every step; "
              f"jobs_completed={s['jobs_completed']:.0f} "
              f"avg_util={s['avg_util']:.4f} avg_pue={s['avg_pue']:.5f}")
    print(f"[{card}] CLI frontier flags: process {wall!r} s")

def sharded_path(card):
    """simulate_sweep_sharded on one card: frontier-sweep-2h's eight
    scenarios for 30 min as two chunks on cuda:0, and on every
    visible card, each bit for bit simulate_sweep."""
    system, table = frontier_case()
    scens = [T.Scenario.make(p, b) for p, b in SWEEP]
    n_steps = int(round(SHARD_T1 / system.dt))
    runs = {"simulate_sweep": (lambda: eng.simulate_sweep(
                system, table, scens, 0.0, SHARD_T1), 1),
            "sharded cuda:0 x 2": (lambda: eng.simulate_sweep_sharded(
                system, table, scens, 0.0, SHARD_T1,
                devices=["cuda:0", "cuda:0"]), 2),
            "sharded devices=None": (lambda: eng.simulate_sweep_sharded(
                system, table, scens, 0.0, SHARD_T1), 1)}
    out, counts = {}, {}
    for label, (run, chunks) in runs.items():
        out[label], wall, counts[label] = run_counted(run)
        if counts[label]["fused_cooling"] != chunks * n_steps or \
                counts[label]["group_power"] != 0:
            raise SystemExit(f"{label}: {n_steps} steps launched "
                             f"{counts[label]}")
        print(f"[{card}] {label}: {n_steps} steps x {len(scens)} scenarios "
              f"in {wall!r} s = {n_steps / wall!r} steps/s, fused_cooling "
              f"{counts[label]['fused_cooling']}")
    ref = out.pop("simulate_sweep")
    for label, (f, h) in out.items():
        if not (trees_equal(ref[0], f) and trees_equal(ref[1], h)):
            raise SystemExit(f"{label} differs from simulate_sweep")
        if f.t.device != ref[0].t.device:
            raise SystemExit(f"{label}: the result lies on {f.t.device}")
    print(f"sharded sweep: two chunks on one card and "
          f"devices=None equal simulate_sweep bit for bit (final state and "
          f"every telemetry row); multi-card splits are not run here")
    return counts

def small_incentives_reference(card, tmp):
    """fig8's workflow through the CLI on the 64-node test system, in
    process, on the card against the port's CPU path: ledgers' job
    counts, schedules and job_history.csv exact, floats within 1e-4."""
    from repro_torch.launch import simulate as cli
    base = ["--system", "marconi100", "--scale", "64", "--jobs", "48",
            "--seed", "8", "--days", "0.1", "-t", "1h", "--json",
            "--accounts"]
    dirs = {}
    for dev in ("cuda", "cpu"):
        col, red = tmp / f"small-{dev}-collect", tmp / f"small-{dev}-redeem"
        with contextlib.redirect_stdout(io.StringIO()):
            cli.main(base + ["-o", str(col), "--device", dev])
        (cdir,) = col.iterdir()
        buf, log = io.StringIO(), io.StringIO()
        grab = logging.StreamHandler(log)
        logging.getLogger("repro_torch").addHandler(grab)
        try:
            with contextlib.redirect_stdout(buf):
                cli.main(base + ["-ff", "1h", "--accounts-json",
                                 str(cdir / "accounts.json"), "-o", str(red),
                                 "--device", dev, "--sweep", *FIG8_SWEEP])
        finally:
            logging.getLogger("repro_torch").removeHandler(grab)
        dirs[dev] = [cdir] + run_dirs(red, json.loads(buf.getvalue()),
                                      FIG8_SWEEP, log.getvalue())
    bitwise = True
    for label, g, c in zip(["collect"] + FIG8_SWEEP, dirs["cuda"],
                           dirs["cpu"]):
        if (g / "job_history.csv").read_text() != \
                (c / "job_history.csv").read_text():
            raise SystemExit(f"small incentives {label}: job_history.csv "
                             f"differs between the card and the CPU")
        ga = json.loads((g / "accounts.json").read_text())
        ca = json.loads((c / "accounts.json").read_text())
        if ga["jobs_done"] != ca["jobs_done"]:
            raise SystemExit(f"small incentives {label}: jobs_done differs")
        for k in ca:
            np.testing.assert_allclose(ga[k], ca[k], rtol=1e-4, err_msg=(
                f"small incentives {label} accounts {k}"))
        bitwise &= ga == ca
        gh, ch = np.load(g / "history.npz"), np.load(c / "history.npz")
        if set(gh.files) != set(ch.files):
            raise SystemExit(f"small incentives {label}: history keys")
        for k in ch.files:
            np.testing.assert_allclose(
                gh[k], ch[k], rtol=1e-4,
                atol=1e-6 if k == "throttle_frac" else 1e-4,
                err_msg=f"small incentives {label} {k}")
    print(f"[{card}] small incentives reference (marconi100 x64, 48 jobs, "
          f"collect 1 h, redeem 4 acct_* policies 1 h after -ff 1h, through "
          f"the CLI in process): card = CPU, job_history.csv and jobs_done "
          f"exact, ledgers and history within 1e-4; ledgers bit-identical="
          f"{bitwise}")

# ---------------------------------------------------------------------------
# fig10: the ML-guided scheduler on Fugaku at 32,768 nodes.
# ---------------------------------------------------------------------------
# ml-fugaku-36h: benchmarks/fig10_ml.py's setup (its lines 43-59): train on
# a 14-day history, sweep its five policies on a high-load 2-day backlog,
# the ml row at the model's own alpha, over fig10's 1.5 days = 2,160 steps
# of 60 s (the backlog first queues after 12 h)
ML_NODES = 32768
ML_TRAIN = dict(n_jobs=4000, duration_s=14 * 86400.0, load=0.8, trace_len=8,
                n_accounts=64, seed=30)
ML_TEST = dict(n_jobs=1500, duration_s=2 * 86400.0, load=1.8, trace_len=8,
               n_accounts=64, seed=31, max_frac_nodes=0.15)
ML_FIT = dict(k=5, n_trees=8, depth=6)
ML_POLICIES = ["fcfs", "sjf", "priority", "ljf", "ml"]
ML_OBJECTIVES = ["avg_wait_s", "avg_turnaround_s", "avg_job_energy_j", "edp",
                 "max_power_mw"]
ML_T1 = 1.5 * 86400.0
# the CLI's --policy ml with the trained checkpoint's alpha, on fig8's
# Marconi100 backlog at full width, 2 h
ML_CLI = FIG8_DATA + ["-t", "2h", "--policy", "ml", "--backfill",
                      "first-fit"]
# fig10's closed loop (benchmarks/fig10_ml.py:87-96): ES on the 800-job
# validation backlog over 0.25 day (360 steps), population 8 (10 rows a
# sweep with the mean and the baseline), seed 33, the default reward; 4
# generations, fig10's --quick count (fig10 itself runs 8)
ES_VAL = dict(n_jobs=800, duration_s=0.5 * 86400.0, load=1.8, trace_len=8,
              n_accounts=64, seed=32, max_frac_nodes=0.15)
ES_T1 = 0.25 * 86400.0
ES_GENERATIONS = 4
ES_POPULATION = 8
ES_SEED = 33
# the card against the CPU: `simulate train --smoke`'s first two
# generations, whose distinct rewards lie at least 2.95e-5 apart; the
# rewards are held within a sixth of that, so no swap hides inside it
ES_SMOKE = ["--smoke", "--generations", "2", "--quiet"]
ES_REWARD_TOL = 5e-6
ES_REFS_RTOL = 1e-5

def start_es_cpu(tmp):
    """Start the CPU half of the smoke comparison: ``simulate train`` with
    ``ES_SMOKE`` and ``--device cpu``, a process of its own on one thread
    that runs beside the card's work. Returns (process, the checkpoint it
    writes)."""
    ck = tmp / "es_smoke_cpu.json"
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.simulate", "train",
         *ES_SMOKE, "--device", "cpu", "--checkpoint", str(ck)], cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                 OMP_NUM_THREADS="1"),
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    return proc, ck

def es_smoke(card, tmp, cpu):
    """The smoke config's ES trajectory on the card against the CPU (the
    process ``cpu`` from ``start_es_cpu``), read off the two checkpoints:
    the settings, every generation's next mean and the elite bit for bit,
    the rewards within ``ES_REWARD_TOL``, the normalizers within
    ``ES_REFS_RTOL``. A generation's candidates follow from its mean and
    the seed, and the next mean adds each candidate's perturbation times
    its rank's utility: equal means in every generation hold the
    candidates and the order the ES step gave them."""
    ck = tmp / "es_smoke_card.json"
    t = time.perf_counter()
    res = ml_train.main(ES_SMOKE + ["--checkpoint", str(ck)])
    wall = time.perf_counter() - t
    proc, cpu_ck = cpu
    try:
        _, err = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if proc.returncode != 0:
        raise SystemExit(f"ES smoke on the CPU exited {proc.returncode}: "
                         f"{err[-3000:]}")
    got, want = json.loads(ck.read_text()), json.loads(cpu_ck.read_text())
    for k in ("alpha0", "sigma", "lr", "population", "generation", "reward",
              "seed", "mu", "best_alpha"):
        if got[k] != want[k]:
            raise SystemExit(f"ES smoke: {k} on the card {got[k]}, on the "
                             f"CPU {want[k]}")
    if len(got["history"]) != len(want["history"]) or not got["history"]:
        raise SystemExit(f"ES smoke: {len(got['history'])} generations on "
                         f"the card, {len(want['history'])} on the CPU")
    rewards = ("reward_mu", "reward_best", "reward_baseline",
               "reward_pop_mean")
    pairs = [(got["best_reward"], want["best_reward"])]
    for c, h in zip(got["history"], want["history"]):
        g = c["generation"]
        if g != h["generation"] or c["mu"] != h["mu"]:
            raise SystemExit(f"ES smoke generation {g}: mu on the card "
                             f"{c['mu']}, on the CPU {h['mu']}")
        pairs += [(c[k], h[k]) for k in rewards]
        print(f"  [{card}] ES smoke generation {g}: " + " ".join(
            f"{k}={c[k]!r}" for k in rewards) + f"; mu -> {c['mu']}")
    worst = max(abs(c - h) for c, h in pairs)
    if worst > ES_REWARD_TOL:
        raise SystemExit(f"ES smoke: rewards {worst!r} apart")
    refs = max(abs(got["refs"].get(k, np.inf) - v) / max(abs(v), 1e-300)
               for k, v in want["refs"].items())
    if got["refs"].keys() != want["refs"].keys() or refs > ES_REFS_RTOL:
        raise SystemExit(f"ES smoke: normalizers on the card {got['refs']}, "
                         f"on the CPU {want['refs']}")
    print(f"[{card}] ES smoke (`simulate train {' '.join(ES_SMOKE)}`, "
          f"marconi100 x64, 90 jobs, 2 h, population 8): "
          f"{len(got['history'])} generations in {wall!r} s on the card; "
          f"the checkpoint against the CPU process's: mu in every "
          f"generation and the elite {got['best_alpha']} bit for bit, "
          f"rewards within {worst!r} (bound {ES_REWARD_TOL}), normalizers "
          f"within {refs!r} relative (bound {ES_REFS_RTOL}); gain "
          f"{res.reward_best - res.reward_default!r}")

def es_train(card, system, model, tmp):
    """fig10's closed loop at its width: ES on the validation backlog's
    basis under ``model``, ``ES_GENERATIONS`` generations on the card,
    a checkpoint each. Each generation is one sweep of population + 2
    rows, one fused_cooling launch a step; the elite is no worse than the
    default alpha, whose reward is the reference's baseline formula.
    Returns (TrainResult, the checkpoint file, the launches)."""
    val = generate(system, WorkloadSpec(**ES_VAL))
    attach_basis(val, model)
    val.assign_prepop_placement(0.0, system.n_nodes)
    table = val.to_table()
    n_steps = int(round(ES_T1 / system.dt))
    reward = ml_train.Reward.parse(ml_train.DEFAULT_REWARD_SPEC)
    ck = tmp / "es_fig10.json"
    print(f"ml path ml-fugaku-train: N={system.n_nodes} J={table.num_jobs} "
          f"steps={n_steps} generations={ES_GENERATIONS} rows a sweep="
          f"{ES_POPULATION + 2}; reward {reward.spec}, seed {ES_SEED}")
    rows = {"simulate_sweep_sharded": [], "simulate_sweep": []}
    spied = {name: getattr(eng, name) for name in rows}

    def spy(name):
        def run(system_, table_, scens, *a, **k):
            rows[name].append(len(scens))
            return spied[name](system_, table_, scens, *a, **k)
        return run
    for name in rows:
        setattr(eng, name, spy(name))
    saves, save = [], ml_train._save_checkpoint
    ml_train._save_checkpoint = lambda path, **state: (
        saves.append(state["generation"]), save(path, **state))
    try:
        res, wall, launches = run_counted(lambda: ml_train.train(
            system, table, 0.0, ES_T1, reward=reward,
            generations=ES_GENERATIONS, population=ES_POPULATION,
            seed=ES_SEED, checkpoint=ck, log=None))
    finally:
        for name, fn in spied.items():
            setattr(eng, name, fn)
        ml_train._save_checkpoint = save
    one_sweep = [ES_POPULATION + 2] * ES_GENERATIONS
    if rows["simulate_sweep_sharded"] != one_sweep or \
            rows["simulate_sweep"] != one_sweep:
        raise SystemExit(f"ES train: sweeps of {rows}, not one of "
                         f"{ES_POPULATION + 2} rows a generation")
    if launches["fused_cooling"] != ES_GENERATIONS * n_steps or \
            launches["group_power"] != 0:
        raise SystemExit(f"ES train of {ES_GENERATIONS} x {n_steps} steps "
                         f"launched {launches}")
    if saves != list(range(1, ES_GENERATIONS + 1)):
        raise SystemExit(f"ES train: checkpoints after generations {saves}")
    for h in res.history:
        print(f"  [{card}] ES generation {h['generation']}: reward_mu "
              f"{h['reward_mu']!r} reward_best {h['reward_best']!r} "
              f"reward_baseline {h['reward_baseline']!r} in {h['wall_s']!r} "
              f"s = {n_steps / h['wall_s']!r} steps/s; mu -> {h['mu']}")
    # the baseline's reward: each term w * ref / ref = w, or w * ref when
    # a normaliser is zero (then unnormalised), in the reference's order
    want = 0.0
    for name, w in reward.weights:
        ref = res.refs[name]
        want = want - w * ref / (ref if abs(ref) > 1e-12 else 1.0)
    zero = [n for n, v in res.refs.items() if abs(v) <= 1e-12]
    if res.reward_default != want or (not zero and want != -2.25):
        raise SystemExit(f"ES train: the default alpha's reward "
                         f"{res.reward_default!r}, not {want!r} (zero "
                         f"normalisers {zero})")
    if not res.reward_best >= res.reward_default:
        raise SystemExit(f"ES train: elite {res.reward_best!r} below the "
                         f"default alpha's {res.reward_default!r}")
    print(f"[{card}] ES train: {ES_GENERATIONS} generations x {n_steps} "
          f"steps x {ES_POPULATION + 2} rows in {wall!r} s = "
          f"{ES_GENERATIONS * n_steps / wall!r} steps/s, one sweep a "
          f"generation, launches {launches}, a checkpoint each generation; "
          f"elite alpha {res.alpha.tolist()} reward {res.reward_best!r} "
          f"against the default's {res.reward_default!r} (zero normalisers: "
          f"{zero}), gain {res.reward_best - res.reward_default!r}; mu "
          f"{res.mu.tolist()}; normalisers {res.refs}")
    return res, ck, launches


def ml_path(card, tmp):
    """ml-fugaku-36h with fig10's closed loop: the pipeline fitted on the
    host; ES training of its alpha (the smoke config card = CPU, then
    fig10's loop on the validation backlog at 32,768 nodes); the test
    backlog's scoring basis in the table, fig10's five policies and the
    trained alpha as one sweep on the card, one fused_cooling launch a
    step, the ml row starting its jobs otherwise than every other
    baseline and equal to a solo run. Returns (the sweep's launches, the
    training's, the trained checkpoint)."""
    cpu = start_es_cpu(tmp)
    try:
        system = get_system("fugaku").scaled(ML_NODES)
        train = generate(system, WorkloadSpec(**ML_TRAIN))
        t = time.perf_counter()
        model = MLSchedulerModel.fit(train, **ML_FIT)
        fit_s = time.perf_counter() - t
        es_smoke(card, tmp, cpu)
    finally:
        if cpu[0].poll() is None:
            cpu[0].kill()
            cpu[0].wait()
    trained, ck, es_launches = es_train(card, system, model, tmp)
    test = generate(system, WorkloadSpec(**ML_TEST))
    attach_basis(test, model)
    test.assign_prepop_placement(0.0, system.n_nodes)
    table = test.to_table()
    alpha = model.alpha.numpy()
    names = ML_POLICIES + ["ml_trained"]
    scens = [T.Scenario.make(p, "first-fit", alpha=alpha if p == "ml"
                             else 0.0) for p in ML_POLICIES]
    scens.append(T.Scenario.make("ml", "first-fit", alpha=trained.alpha))
    n_steps = int(round(ML_T1 / system.dt))
    S = len(scens)
    print(f"ml path ml-fugaku-36h: N={system.n_nodes} "
          f"G={system.cooling.n_groups} J={table.num_jobs} steps={n_steps} "
          f"S={S}; fit on {len(train)} jobs ({ML_FIT}) on the host in "
          f"{fit_s!r} s; alpha {alpha.tolist()}, trained "
          f"{trained.alpha.tolist()}")
    run = lambda: eng.simulate_sweep(system, table, scens, 0.0, ML_T1)
    (finals, hists), wall, launches = run_counted(run)
    print(f"[{card}] ml sweep: {n_steps} steps x {S} scenarios in {wall!r} s "
          f"= {n_steps / wall!r} steps/s, launches {launches}")
    if launches["fused_cooling"] != n_steps or launches["group_power"] != 0:
        raise SystemExit(f"ml sweep of {n_steps} steps launched {launches}")
    check_run("ml sweep", finals, hists, n_steps, S)
    obj = np.zeros((S, len(ML_OBJECTIVES)))
    for i, p in enumerate(names):
        s = stats_mod.summarize(system, table, T.row(finals, i),
                                T.row(hists, i))
        obj[i] = [s[o] for o in ML_OBJECTIVES]
        print(f"  [{card}] {p}:first-fit: jobs_completed="
              f"{s['jobs_completed']:.0f} " + " ".join(
                  f"{o}={s[o]!r}" for o in ML_OBJECTIVES))
    # fig10b: the L2-normalized multi-objective score (lower is better),
    # over fig10's five policies, and with the trained row beside them
    l2 = lambda o: (o / (np.linalg.norm(o, axis=0) + 1e-9)).mean(axis=1)
    score = dict(zip(ML_POLICIES, l2(obj[:-1]).tolist()))
    score6 = dict(zip(names, l2(obj).tolist()))
    print(f"[{card}] ml sweep: L2 multi-objective score {score}; fig10's "
          f"check ml <= ljf + 0.02 (not gated here): "
          f"{score['ml'] <= score['ljf'] + 0.02}; with the trained row "
          f"{score6}")
    ml = ML_POLICIES.index("ml")
    # the trained alpha under the training reward, normalised by the ml
    # row (fig10's sweep_trained)
    reward = ml_train.Reward.parse(ml_train.DEFAULT_REWARD_SPEC)
    metrics = ml_train.rollout_metrics(system, table,
                                       ml_train.to_host(finals),
                                       ml_train.to_host(hists))
    rewards = reward.evaluate(metrics, reward.refs(metrics, ml))
    s = stats_mod.summarize(system, table, T.row(finals, S - 1),
                            T.row(hists, S - 1))
    print(f"[{card}] ml sweep, held-out backlog: ml_trained avg_wait_s="
          f"{s['avg_wait_s']!r}, L2 {score6['ml_trained']!r} against ml's "
          f"{score6['ml']!r}; reward ({reward.spec}, normalised by the ml "
          f"row) {float(rewards[-1])!r} against ml's {float(rewards[ml])!r} "
          f"(not gated)")
    same = [p for i, p in enumerate(ML_POLICIES) if i != ml and
            torch.equal(finals.start[i], finals.start[ml])]
    moved = [int((finals.start[i] != finals.start[ml]).sum())
             for i in range(S)]
    print(f"[{card}] ml sweep: mean queue length "
          f"{hists.n_queued.mean(1).tolist()}, longest "
          f"{hists.n_queued.amax(1).tolist()}; jobs whose start differs from "
          f"the ml row's: {dict(zip(names, moved))}")
    if same:
        raise SystemExit(f"ml sweep: the rows {same} start their jobs as the "
                         f"ml row does: the ML ranking was not exercised")
    check_row_vs_solo("ml sweep", finals, hists, eng.simulate(
        system, table, scens[ml], 0.0, ML_T1), row=ml)
    return launches, es_launches, ck.read_text()

def ml_cli(card, tmp, checkpoint):
    """One CLI process with --policy ml and the trained checkpoint's alpha
    (--ml-alpha FILE, the file ES training wrote): its stats.out and
    job_history.csv equal those of the same argv run in this process."""
    ck = tmp / "ml_alpha.json"
    ck.write_text(checkpoint)
    alpha = ml_train.load_alpha(ck).tolist()
    argv = ML_CLI + ["--ml-alpha", str(ck)]
    doc, wall, log = cli_process("--policy ml", argv + ["-o",
                                                        str(tmp / "proc")])
    (proc,) = run_dirs(tmp / "proc", doc, ["ml:first-fit"], log)
    from repro_torch.launch import simulate as cli
    with contextlib.redirect_stdout(io.StringIO()):
        cli.main(argv + ["-o", str(tmp / "inproc")])
    (inproc,) = (tmp / "inproc").iterdir()
    for name in ("stats.out", "job_history.csv"):
        if (proc / name).read_text() != (inproc / name).read_text():
            raise SystemExit(f"CLI --policy ml: {name} differs between the "
                             f"process and the same argv in process")
    s = doc["ml:first-fit"]
    print(f"[{card}] CLI {' '.join(ML_CLI)} --ml-alpha <the trained "
          f"checkpoint, {alpha}> as a process: exit 0 in {wall!r} s; "
          f"stats.out and job_history.csv = the same argv in process; "
          f"jobs_completed={s['jobs_completed']:.0f} "
          f"avg_wait_s={s['avg_wait_s']!r}")

def small_ml_reference(card):
    """On the small test system under a contended backlog (80 jobs of
    ~10 min arriving in 30 min at load 3): the pipeline's baked score
    against the basis with Scenario.alpha on the card (the keys and a 1 h
    run bit for bit), then an ml sweep under the model's, a vector and a
    scalar alpha on the card against the CPU, schedules exact, each ml
    row ranking otherwise than fcfs."""
    system, _ = small_case()
    spec = WorkloadSpec(n_jobs=80, duration_s=1800.0, load=3.0, trace_len=8,
                        n_accounts=8, mean_wall_s=600.0, seed=7)
    model = MLSchedulerModel.fit(generate(system, spec), k=3, n_trees=4,
                                 depth=4)
    alpha = model.alpha.numpy()
    tables = {}
    for attach in (attach_scores, attach_basis):
        jobs = generate(system, spec)
        attach(jobs, model)
        jobs.assign_prepop_placement(0.0, system.n_nodes)
        tables[attach.__name__] = jobs.to_table(96)
    baked, basis = tables["attach_scores"], tables["attach_basis"]
    acct = T.tree_map(lambda x: x[None].to(DEV), T.AccountStats.zeros(8))
    keys = [sched.policy_key(t.to(DEV), acct, T.tree_map(
        lambda x: x.to(DEV), T.stack_scenarios([s])))
        for t, s in ((baked, T.Scenario.make("ml")),
                     (basis, T.Scenario.make("ml", alpha=alpha)))]
    if not torch.equal(*keys):
        raise SystemExit("small ml reference: the baked score's key and the "
                         "basis with alpha differ on the card")
    static = eng.simulate_static(system, baked, "ml", "first-fit", 0.0,
                                 3600.0, num_accounts=8)
    alpha_run = eng.simulate(system, basis, T.Scenario.make(
        "ml", "first-fit", alpha=alpha), 0.0, 3600.0, num_accounts=8)
    if not all(trees_equal(a, b) for a, b in zip(static, alpha_run)):
        raise SystemExit("small ml reference: the baked and alpha runs "
                         "differ")
    finals, _ = card_vs_cpu("small ml reference", system, basis, [
        T.Scenario.make("ml", "first-fit", alpha=alpha),
        T.Scenario.make("ml", "first-fit", alpha=(0.1, 3.0, 0.1, 3.0)),
        T.Scenario.make("ml", "first-fit", alpha=0.5),
        T.Scenario.make("fcfs", "first-fit")], t1=3600.0)
    if any(torch.equal(finals.start[i], finals.start[3]) for i in range(3)):
        raise SystemExit("small ml reference: an ml row starts its jobs as "
                         "the fcfs row does: the ranking was not exercised")
    print(f"[{card}] small ml reference (marconi100 x64, 4 halls, 80 jobs, "
          f"1 h): the baked score's keys and run = the basis with "
          f"Scenario.alpha, bit for bit, on the card; an ml sweep (model, "
          f"vector and scalar alphas, fcfs) card = CPU, schedules exact, "
          f"floats within 1e-4")

# ---------------------------------------------------------------------------
# The LM serving path's kernels: flash attention, WKV, SSD.
# ---------------------------------------------------------------------------
# Tolerances of kernel vs plain version on the card (rtol = atol). float32:
# the reference's own bounds (tests/test_kernels.py): 2e-5 for attention,
# 2e-4 for WKV and 3e-4 for SSD, whose float32 kernels run the per-token
# recurrence against the plain chunked form. bfloat16: both versions round
# the output once to bf16, so they may differ by one bf16 ulp (at most
# 2^-7 relative: rtol 1e-2, with atol 1e-2 for values near 0); the
# tensor-core flash kernel also rounds P to bf16 before P.V (2^-9 relative
# per weight, well inside). WKV's final state and all of SSD's outputs are
# float32 and keep the float32 bounds: the bf16 WKV and SSD kernels'
# chunked products split every f32 operand into a bf16 pair (about 2^-17).
LM_TOL = {"flash_attention": {torch.float32: 2e-5, torch.bfloat16: 1e-2},
          "wkv": {torch.float32: 2e-4, torch.bfloat16: 1e-2},
          "wkv_state": {torch.float32: 2e-4, torch.bfloat16: 2e-4},
          "ssd": {torch.float32: 3e-4, torch.bfloat16: 3e-4}}
LM_DTYPES = (torch.bfloat16, torch.float32)
# Device times of the kernels the redesigned ones replaced (on the bf16
# path the CUDA-core flash kernel, the per-token SSD and WKV recurrences;
# the first fused_cooling and group_power designs, one block of 256
# threads per group; PERF.md section 6) with where they were measured,
# printed beside the new ones.
BEFORE_MS = {
    ("flash_attention", "qwen2.5-3b"): (
        0.40369022369384766, "commit 38e3238 on NVIDIA H100 80GB HBM3, 700.00 W"),
    ("flash_attention", "zamba2-7b"): (
        0.6393235015869141, "commit 38e3238 on NVIDIA H100 80GB HBM3, 700.00 W"),
    ("ssd", "zamba2-7b"): (
        0.35346622467041017, "commit 38e3238 on NVIDIA H100 80GB HBM3, 700.00 W"),
    ("wkv", "rwkv6-7b"): (
        0.3395753479003906, "commit 1d75dc0 on NVIDIA H100 80GB HBM3, 700.00 W"),
    ("fused_cooling", "frontier"): (
        0.00219651198387146, "commit 8df0e84 on NVIDIA H100 80GB HBM3, 700.00 W"),
    ("fused_cooling", "fugaku"): (
        0.0032528319358825684, "commit 8df0e84 on NVIDIA H100 80GB HBM3, 700.00 W"),
    ("group_power split", "frontier"): (
        0.0020456318855285646, "commit 8df0e84 on NVIDIA H100 80GB HBM3, 700.00 W"),
    ("group_power split", "fugaku"): (
        0.0032296960353851317, "commit 8df0e84 on NVIDIA H100 80GB HBM3, 700.00 W")}

def gen(seed):
    return torch.Generator(device=DEV).manual_seed(seed)

def close(label, got, want, tol):
    """Assert kernel output ``got`` equals the plain ``want`` within
    rtol = atol = ``tol``; returns the largest absolute error."""
    torch.cuda.synchronize()
    if got.shape != want.shape or got.dtype != want.dtype or \
            not torch.isfinite(got).all():
        raise SystemExit(f"{label}: bad output {tuple(got.shape)} "
                         f"{got.dtype} (want {tuple(want.shape)} "
                         f"{want.dtype}), finite={bool(torch.isfinite(got).all())}")
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol,
                               msg=lambda m: f"{label}: {m}")
    return float((got.float() - want.float()).abs().max())

def attn_inputs(B, S, Tk, H, KV, hd, dtype, seed):
    g = gen(seed)
    return (torch.randn((B, S, H, hd), generator=g, device=DEV).to(dtype),
            torch.randn((B, Tk, KV, hd), generator=g, device=DEV).to(dtype),
            torch.randn((B, Tk, KV, hd), generator=g, device=DEV).to(dtype))

def wkv_inputs(B, S, H, hd, dtype, seed, strong=False):
    """The reference test's distributions (tests/test_kernels.py).
    ``strong``: w log-uniform down to 1e-30, every 8th channel (from 3)
    at exactly 1 and every 8th (from 5) at exactly 0."""
    g = gen(seed)
    n = lambda *shape: torch.randn(shape, generator=g, device=DEV)
    r, k, v = (n(B, S, H, hd) * 0.5).to(dtype), \
        (n(B, S, H, hd) * 0.5).to(dtype), n(B, S, H, hd).to(dtype)
    w = torch.sigmoid(n(B, S, H, hd) - 1.0) * 0.97 + 0.02
    u = n(H, hd) * 0.3
    if strong:
        w = 10.0 ** (-30.0 * torch.rand((B, S, H, hd), generator=g,
                                         device=DEV))
        w[..., 3::8] = 1.0
        w[..., 5::8] = 0.0
    return r, k, v, w, u

def rwkv_layer_inputs(B, S, dtype, seed):
    """r, k, v, w, u of layer 0 of rwkv6-7b at full width (D=4096, H=64,
    hd=64) under seeded random weights, for random tokens: the model's own
    time mix and ``_decay`` (``rwkv6.wkv_inputs``), so w is the model's
    data-dependent exp(-exp(w0 + lora))."""
    cfg = dataclasses.replace(get_config("rwkv6-7b"), n_layers=1)
    params = get_api(cfg).init(gen(seed), DEV)
    tokens = torch.randint(0, cfg.vocab, (B, S), generator=gen(seed + 1),
                           device=DEV)
    lp = model_common.layer(params["blocks"], 0)
    x = model_common.rmsnorm(model_common.embed_tokens(
        params["embed"], tokens, cfg), lp["ln1"])
    r, k, v, w, u, _ = rwkv6.wkv_inputs(lp, x, cfg)
    return (*(z.to(dtype).contiguous() for z in (r, k, v)), w.contiguous(),
            u.contiguous())

def ssd_inputs(Bz, S, H, P, N, dtype, seed):
    """The reference test's distributions (tests/test_kernels.py)."""
    g = gen(seed)
    n = lambda *shape: torch.randn(shape, generator=g, device=DEV)
    sp = torch.nn.functional.softplus
    return (n(Bz, S, H, P).to(dtype), sp(n(Bz, S, H)),
            torch.exp(-sp(n(Bz, S, H))), (n(Bz, S, N) * 0.5).to(dtype),
            (n(Bz, S, N) * 0.5).to(dtype))

def bound(n_bytes, n_ops):
    """(ms, "bytes" | "operations"): the least time for the work."""
    tb, to = n_bytes / HBM_BYTES_S, n_ops / BF16_FLOP_S
    return max(tb, to) * 1e3, ("bytes" if tb >= to else "operations")

def timing(card, name, shape, kernel, plain, library, n_bytes, n_ops,
           before=None):
    """Graph and eager times of the kernel, its plain version and (where
    there is one) the library call, with the ratio to the library call
    and the replaced kernel's (time, where measured) where given; returns
    the kernels-line numbers."""
    ms = graph_ms(kernel, iters=20, reps=5)
    plain_ms = graph_ms(plain, iters=5, reps=3)
    lib_ms = graph_ms(library, iters=20, reps=5) if library else None
    eager = {"kernel": cuda_ms(kernel, iters=20, warmup=3),
             "plain": cuda_ms(plain, iters=5, warmup=2)}
    if library:
        eager["library"] = cuda_ms(library, iters=20, warmup=3)
    bound_ms, bound_by = bound(n_bytes, n_ops)
    print(f"[{card}] {name} {shape} on the card (CUDA graph): kernel {ms!r} "
          f"ms, plain {plain_ms!r} ms, library {lib_ms!r} ms, bound "
          f"{bound_ms!r} ms ({bound_by}: {n_bytes} B, {n_ops} flops), "
          f"{ms / bound_ms!r}x its bound")
    if lib_ms:
        print(f"[{card}] {name} {shape}: kernel / library = "
              f"{ms / lib_ms!r}")
    if before:
        before_ms, where = before
        print(f"[{card}] {name} {shape}: before {before_ms!r} ms "
              f"({where}) -> now {ms!r} ms, {before_ms / ms!r}x faster")
    print(f"[{card}] {name} per eager call, host included: "
          + ", ".join(f"{k} {v!r} ms" for k, v in eager.items()))
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=lib_ms)

def flash_phase(card):
    """Flash attention against its plain version at qwen2.5-3b's (H=16,
    KV=2, hd=128), zamba2-7b's (H=32 MHA, hd=112) and mixtral-8x7b's
    (H=32, KV=8, hd=128, window 4096) prefill shapes, serve_lm's ragged
    32-token prompt, a sliding window, mixtral's window binding (S = T =
    8192), S < T, a row past a 64-row tile (S = T = 129) and hd=64 GQA
    (qwen2.5-0.5b's heads). bfloat16 runs the tensor-core kernel, float32
    the CUDA-core one."""
    t0 = time.perf_counter()
    cases = [("qwen2.5-3b", 4, 512, 512, 16, 2, 128, 0),
             ("qwen2.5-3b prompt 32", 4, 32, 32, 16, 2, 128, 0),
             ("zamba2-7b", 4, 512, 512, 32, 32, 112, 0),
             ("zamba2-7b prompt 32", 4, 32, 32, 32, 32, 112, 0),
             ("window 200", 2, 512, 512, 16, 2, 128, 200),
             ("S=100 < T=300", 2, 100, 300, 8, 2, 64, 0),
             ("S=T=129", 2, 129, 129, 16, 2, 128, 0),
             ("hd=64 GQA", 4, 512, 512, 14, 2, 64, 0),
             ("mixtral-8x7b", 4, 512, 512, 32, 8, 128, 4096),
             ("mixtral-8x7b window binding", 1, 8192, 8192, 32, 8, 128,
              4096)]
    err = 0.0
    for dtype in LM_DTYPES:
        for i, (label, B, S, Tk, H, KV, hd, win) in enumerate(cases):
            q, k, v = attn_inputs(B, S, Tk, H, KV, hd, dtype, 20 + i)
            e = close(f"flash_attention {label} {dtype}",
                      fa_ops.mha(q, k, v, True, win),
                      fa_ref.mha_ref(q, k, v, True, win),
                      LM_TOL["flash_attention"][dtype])
            err = max(err, e) if dtype == torch.bfloat16 else err
            print(f"kernel flash_attention {label} B={B} S={S} T={Tk} H={H} "
                  f"KV={KV} hd={hd} window={win} {dtype}: max_abs_err={e!r} "
                  f"(rtol=atol={LM_TOL['flash_attention'][dtype]})")
            del q, k, v
    torch.cuda.empty_cache()    # the S = T = 8192 plain version's scores
    print(f"[{card}] flash_attention checks ({len(cases)} cases x 2 dtypes, "
          f"mixtral's two included): {time.perf_counter() - t0!r} s")
    entry = dict(name="flash_attention", route="cuda",
                 source="src/repro_torch/kernels/flash_attention/csrc/"
                 "flash_attention_tc.cu",
                 replaces="src/repro/kernels/flash_attention/"
                 "flash_attention.py:90", launches=None, max_abs_err=err)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for label, B, S, H, KV, hd in (("qwen2.5-3b", 4, 512, 16, 2, 128),
                                   ("zamba2-7b", 4, 512, 32, 32, 112)):
        q, k, v = attn_inputs(B, S, S, H, KV, hd, torch.bfloat16, 30)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        pairs = B * H * S * (S + 1) // 2          # causal (query, key) pairs
        n_bytes = 2 * (2 * B * S * H * hd + 2 * B * S * KV * hd)
        t = timing(card, "flash_attention", f"{label} B={B} S={S} bf16",
                   lambda: fa_ops.mha(q, k, v),
                   lambda: fa_ref.mha_ref(q, k, v),
                   lambda: sdpa(qt, kt, vt, is_causal=True,
                                enable_gqa=KV != H),
                   n_bytes, 4 * hd * pairs,
                   BEFORE_MS[("flash_attention", label)])
        if label == "qwen2.5-3b":
            entry.update(t)
    return entry

def wkv_phase(card):
    """WKV against its plain chunked version at rwkv6-7b's prefill shape
    (H=64, hd=64, S=512), serve_lm's 32-token prompt, a ragged S=45,
    strong decay (w down to 1e-30, channels at exactly 1 and 0) at
    S=512, the operands of one real rwkv6-7b layer (seeded random
    weights, the model's own decay), S=65 (one token past a chunk pair),
    S=7 (under a 16-token sub-block), and the other head widths (hd = 8,
    zero-padded to 16 in shared memory, 16 and 32). bfloat16 runs the
    chunked tensor-core kernel, float32 the recurrence. The plain version
    runs in float64 on the same inputs: in float32 its log-space cumsum
    loses precision under strong decay (the float32 plain version's own
    distance from the float64 run is printed beside each case)."""
    cases = [("B=4 S=512", lambda dt: wkv_inputs(4, 512, 64, 64, dt, 40)),
             ("B=4 S=32", lambda dt: wkv_inputs(4, 32, 64, 64, dt, 41)),
             ("B=2 S=45", lambda dt: wkv_inputs(2, 45, 64, 64, dt, 42)),
             ("strong decay B=4 S=512",
              lambda dt: wkv_inputs(4, 512, 64, 64, dt, 43, strong=True)),
             ("rwkv6-7b layer 0 B=4 S=512",
              lambda dt: rwkv_layer_inputs(4, 512, dt, 44)),
             ("B=2 S=65", lambda dt: wkv_inputs(2, 65, 64, 64, dt, 46)),
             ("B=2 S=7", lambda dt: wkv_inputs(2, 7, 64, 64, dt, 47)),
             ("B=2 S=45", lambda dt: wkv_inputs(2, 45, 3, 8, dt, 48)),
             ("B=2 S=100", lambda dt: wkv_inputs(2, 100, 4, 16, dt, 49)),
             ("B=2 S=65", lambda dt: wkv_inputs(2, 65, 2, 32, dt, 50))]
    err = 0.0
    for dtype in LM_DTYPES:
        for label, make in cases:
            r, k, v, w, u = make(dtype)
            label = f"{label} H={r.shape[2]} hd={r.shape[3]} {dtype}"
            y, st = wkv_ops.wkv(r, k, v, w, u)
            y0, st0 = wkv_ref.wkv_chunked(
                *(z.double() for z in (r, k, v, w, u)))
            e = close(f"wkv y {label}", y, y0.to(y.dtype),
                      LM_TOL["wkv"][dtype])
            es = close(f"wkv state {label}", st, st0.float(),
                       LM_TOL["wkv_state"][dtype])
            if dtype == torch.bfloat16:
                err = max(err, e, es)
            yp, sp = wkv_ref.wkv_chunked(r, k, v, w, u)
            print(f"kernel wkv {label}: y "
                  f"max_abs_err={e!r} (rtol=atol={LM_TOL['wkv'][dtype]}), "
                  f"state max_abs_err={es!r} (rtol=atol="
                  f"{LM_TOL['wkv_state'][dtype]}) against the float64 "
                  f"plain run; float32 plain version: y "
                  f"{float((yp.double() - y0.to(y.dtype).double()).abs().max())!r}"
                  f", state {float((sp.double() - st0).abs().max())!r}; w in "
                  f"[{float(w.min())!r}, {float(w.max())!r}], |state| up to "
                  f"{float(st0.abs().max())!r}")
    B, S, H, hd = 4, 512, 64, 64
    r, k, v, w, u = wkv_inputs(B, S, H, hd, torch.bfloat16, 45)
    n = B * S * H * hd
    t = timing(card, "wkv", f"B={B} S={S} H={H} hd={hd} bf16",
               lambda: wkv_ops.wkv(r, k, v, w, u),
               lambda: wkv_ref.wkv_chunked(r, k, v, w, u), None,
               3 * 2 * n + 4 * n + 4 * H * hd + 2 * n + 4 * B * H * hd * hd,
               5 * n * hd, BEFORE_MS[("wkv", "rwkv6-7b")])
    return dict(name="wkv", route="cuda",
                source="src/repro_torch/kernels/rwkv6_wkv/csrc/wkv_tc.cu",
                replaces="src/repro/kernels/rwkv6_wkv/rwkv6_wkv.py:68",
                launches=None, max_abs_err=err, **t)

def ssd_phase(card):
    """SSD against its plain chunked version at zamba2-7b's prefill shape
    (H=112, P=64, N=64, S=512), serve_lm's 32-token prompt, a ragged S=45
    with an odd head count and S=65 (one token past a chunk). bfloat16
    runs the chunked tensor-core kernel, float32 the recurrence."""
    err = 0.0
    for dtype in LM_DTYPES:
        for i, (Bz, S, H) in enumerate(((4, 512, 112), (4, 32, 112),
                                        (2, 45, 7), (2, 65, 112))):
            x, dt, a, Bm, Cm = ssd_inputs(Bz, S, H, 64, 64, dtype, 50 + i)
            y, st = ssd_ops.ssd(x, dt, a, Bm, Cm)
            y0, st0 = ssd_ref.ssd_chunked(x, dt, a, Bm, Cm)
            tol = LM_TOL["ssd"][dtype]
            e = close(f"ssd y Bz={Bz} S={S} {dtype}", y, y0, tol)
            es = close(f"ssd state Bz={Bz} S={S} {dtype}", st, st0, tol)
            if dtype == torch.bfloat16:
                err = max(err, e, es)
            print(f"kernel ssd Bz={Bz} S={S} H={H} P=64 N=64 {dtype}: y "
                  f"max_abs_err={e!r}, state max_abs_err={es!r} "
                  f"(rtol=atol={tol})")
    Bz, S, H, P, N = 4, 512, 112, 64, 64
    x, dt, a, Bm, Cm = ssd_inputs(Bz, S, H, P, N, torch.bfloat16, 55)
    n = Bz * S * H * P
    t = timing(card, "ssd", f"Bz={Bz} S={S} H={H} P={P} N={N} bf16",
               lambda: ssd_ops.ssd(x, dt, a, Bm, Cm),
               lambda: ssd_ref.ssd_chunked(x, dt, a, Bm, Cm), None,
               2 * n + 2 * 4 * Bz * S * H + 2 * 2 * Bz * S * N + 4 * n +
               4 * Bz * H * P * N, 5 * n * N,
               BEFORE_MS[("ssd", "zamba2-7b")])
    return dict(name="ssd", route="cuda",
                source="src/repro_torch/kernels/mamba2_ssd/csrc/ssd.cu",
                replaces="src/repro/kernels/mamba2_ssd/mamba2_ssd.py:59",
                launches=None, max_abs_err=err, **t)

# ---------------------------------------------------------------------------
# LM serving at full width: qwen2.5-3b, rwkv6-7b, zamba2-7b; mixtral-8x7b
# at full width, 8 of its 32 layers.
# ---------------------------------------------------------------------------
LM_ARCHS = ["qwen2.5-3b", "rwkv6-7b", "zamba2-7b"]
# kernel launches of one prefill (the decode runs no kernel): a flash
# attention per layer; a WKV per layer; an SSD per Mamba2 layer and a
# flash attention per shared-block call (81 layers, every 6th: 13 calls)
# (bf16: the tensor-core flash and WKV kernels; the float32 ones launch
# nothing)
LM_LAUNCHES = {"qwen2.5-3b": {"flash_attention_tc": 36},
               "rwkv6-7b": {"wkv_tc": 32},
               "zamba2-7b": {"ssd": 81, "flash_attention_tc": 13},
               "mixtral-8x7b": {"flash_attention_tc": 8}}
# mixtral-8x7b's depth cut: 32 layers are 46.70 B params, 186.8 GB in
# float32, which no 80 GB card holds; 8 layers are 11.87 B, 47.5 GB
MOE_ARCH, MOE_LAYERS = "mixtral-8x7b", 8
MOE_SMOKE = ["mixtral-8x7b-smoke", "llama4-maverick-400b-a17b-smoke"]
PREFILL_TOL = 2e-3   # the JAX package's prefill-vs-forward bound
ROUTE_TOL = 1e-6     # route_topk's combine, card vs CPU (float32)
MOE_LAYER_TOL = 1e-4  # forward_moe, card vs CPU, of the largest output
# the launch count of each kernels-line entry of the LM path
LM_COUNTER = {"flash_attention": "flash_attention_tc", "wkv": "wkv_tc",
              "ssd": "ssd"}
LM_BATCH, LM_PROMPT, LM_GEN = 4, 512, 16
SELF_TOL = 4e-3      # the JAX package's recurrent-vs-parallel bound
# The bf16 prefill's last-position logits against the float32 prefill's
# of the same weights and prompts, as max |bf16 - f32| / max |f32|
# (PERF.md section 2 gives the reasoning): bf16 rounds the operands of
# every product to 2^-9, and under untrained weights the drift compounds
# with depth, far more in rwkv6 (the JAX package's bf16 path drifts as
# much); tests/test_torch_lm_bf16.py holds the smoke widths at full
# depth to the same bounds on the CPU.
# mixtral-8x7b's float32 prefill replays the bf16 prefill's routes (every
# token in the same experts and slots), so it drifts as a dense arch does
BF16_LOGIT_TOL = {"qwen2.5-3b": 0.05, "rwkv6-7b": 0.5, "zamba2-7b": 0.05,
                  "mixtral-8x7b": 0.05}

def self_check(arch, api, params, prompts):
    """Whole path in float32 at full width (dtype replaced, widths and
    depths unchanged): prefill(S) and one decode step against the last
    logits of prefill(S + 1), at the JAX package's own 4e-3. Returns the
    float32 prefill(S) logits."""
    cfg32 = dataclasses.replace(api.cfg, dtype=torch.float32)
    api32 = get_api(cfg32)
    nxt = prompts[:, :1].flip(0)
    logits, state = api32.prefill(params, {"tokens": prompts}, LM_PROMPT + 1)
    dec, _ = api32.decode(params, nxt[:, 0], state)
    full, _ = api32.prefill(params, {"tokens": torch.cat([prompts, nxt], 1)},
                            LM_PROMPT + 1)
    torch.cuda.synchronize()
    if not (torch.isfinite(dec).all() and torch.isfinite(full).all()):
        raise SystemExit(f"{arch}: float32 self-check logits not finite")
    torch.testing.assert_close(dec, full, rtol=SELF_TOL, atol=SELF_TOL,
                               msg=lambda m: f"{arch} f32 self-check: {m}")
    err = float((dec - full).abs().max())
    print(f"{arch}: float32 full-width self-check, prefill({LM_PROMPT}) + "
          f"decode vs prefill({LM_PROMPT + 1}): max_abs_err={err!r} "
          f"(rtol=atol={SELF_TOL}; logits up to {float(full.abs().max())!r})")
    return logits

def bf16_check(arch, got, want):
    """The bf16 serving path's prefill logits against the float32 ones
    of the same weights and prompts, relative to the largest logit."""
    if got.shape != want.shape or not torch.isfinite(got).all():
        raise SystemExit(f"{arch}: bf16 prefill logits {tuple(got.shape)} "
                         f"bad or not finite")
    top = float(want.abs().max())
    rel = float((got.float() - want).abs().max()) / top
    print(f"{arch}: bf16 prefill vs float32 prefill, {LM_BATCH} x "
          f"{LM_PROMPT} tokens: max |bf16 - f32| / max |f32| = {rel!r} "
          f"(bound {BF16_LOGIT_TOL[arch]}; largest logit {top!r}; argmax "
          f"agrees on {int((got.argmax(-1) == want.argmax(-1)).sum())} of "
          f"{LM_BATCH})")
    if not rel <= BF16_LOGIT_TOL[arch]:
        raise SystemExit(f"{arch}: bf16 prefill logits {rel!r} of the "
                         f"largest away from float32, over "
                         f"{BF16_LOGIT_TOL[arch]}")

def serve_path(card, entries):
    """Each arch in turn: the counted serving run through
    ``serve_lm.serve`` (prefill of 4 x 512 tokens, 16 greedy decode
    steps, bf16 as configured), then prefill time, decode rate and peak
    memory, the float32 self-check, and the model freed."""
    total = {k: 0 for k in kernels.LAUNCHES}
    for arch in LM_ARCHS:
        cfg = get_config(arch)
        api = get_api(cfg)
        torch.cuda.reset_peak_memory_stats()
        toks, wall, launches = run_counted(lambda: serve_lm.serve(
            arch, batch=LM_BATCH, prompt_len=LM_PROMPT, gen=LM_GEN))
        want = {k: LM_LAUNCHES[arch].get(k, 0) for k in kernels.LAUNCHES}
        if launches != want:
            raise SystemExit(f"{arch}: one prefill launched {launches}, "
                             f"want {want}")
        for k, n in launches.items():
            total[k] += n
        if toks.shape != (LM_BATCH, LM_GEN) or not \
                ((toks >= 0) & (toks < cfg.vocab)).all():
            raise SystemExit(f"{arch}: bad tokens {toks.shape}")
        params = api.init(torch.Generator(device=DEV).manual_seed(0), DEV)
        g = torch.Generator(device=DEV).manual_seed(1)
        prompts = torch.randint(0, cfg.vocab, (LM_BATCH, LM_PROMPT),
                                generator=g, device=DEV)
        _, logits, dec_s = serve_lm.generate(api, params, prompts, LM_GEN)
        if tuple(logits.shape) != (LM_BATCH, LM_GEN + 1, cfg.vocab) or \
                not torch.isfinite(logits).all():
            raise SystemExit(f"{arch}: logits {tuple(logits.shape)} not "
                             f"finite")
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t = time.perf_counter()
            bf16_logits = api.prefill(params, {"tokens": prompts},
                                      LM_PROMPT + LM_GEN)[0]
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
        prefill_ms = 1e3 * sum(times) / len(times)
        prefill_tok_s = LM_BATCH * LM_PROMPT / (prefill_ms / 1e3)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        print(f"[{card}] {arch} ({cfg.param_count / 1e9:.2f} B params f32, "
              f"{cfg.n_layers} layers, d_model {cfg.d_model}) batch "
              f"{LM_BATCH} x prompt {LM_PROMPT}: launches {launches}; "
              f"prefill {prefill_ms!r} ms ({prefill_tok_s!r} tok/s); "
              f"decode {LM_GEN} steps "
              f"{dec_s!r} s = {LM_BATCH * LM_GEN / dec_s!r} tok/s; peak "
              f"memory {peak!r} GiB; serve wall {wall!r} s; sample "
              f"{toks[0][:8].tolist()}")
        bf16_check(arch, bf16_logits, self_check(arch, api, params, prompts))
        del params, logits, bf16_logits
        torch.cuda.empty_cache()
    for k, n in moe_serve(card).items():
        total[k] += n
    for e in entries:
        e["launches"] = total[LM_COUNTER[e["name"]]]
    print(f"LM serving launches in all: {total}")

@contextlib.contextmanager
def recorded_routes(replay=None):
    """Record every ``route_topk`` call's (dispatch, combine); yields the
    list of records. With ``replay``, an earlier run's records, each call
    returns the record of its turn instead of routing afresh (the
    dispatch in the logits' dtype), so every token goes to the same
    experts and slots with the same gates as in that run."""
    calls, inner = [], model_mlp.route_topk

    def spy(logits, cfg, capacity):
        if replay is None:
            dispatch, combine = inner(logits, cfg, capacity)
        else:
            dispatch, combine = replay[len(calls)]
            if tuple(dispatch.shape) != (*logits.shape, capacity):
                raise SystemExit(f"replayed dispatch {tuple(dispatch.shape)}"
                                 f" does not fit logits "
                                 f"{tuple(logits.shape)}, capacity "
                                 f"{capacity}")
            dispatch = dispatch.to(logits.dtype)
        calls.append((dispatch, combine))
        return dispatch, combine
    model_mlp.route_topk = spy
    try:
        yield calls
    finally:
        model_mlp.route_topk = inner

def token_routes(calls, B, S):
    """Per layer, the experts each of the B x S real tokens is kept in:
    bool [layers, B, S, E]."""
    kept = [d.sum(-1) > 0 for d, _ in calls]
    return torch.stack([k.reshape(-1, k.shape[-1])[:B * S].reshape(B, S, -1)
                        for k in kept])

def tied_routes_check(card, cfg):
    """route_topk on bf16 logits full of exact ties, card against the
    CPU: two groups of moe_group tokens whose logits take 7 levels over
    the 8 experts (every row ties somewhere), expert 0 raised by one in
    group 0 so that capacity binds, and group 1's second half all zero,
    as forward_moe's padded tokens are (uniform probabilities: experts
    0..k-1 by the tie order, their slot-0 positions ahead of the real
    tokens' slot-1). The dispatch must be equal, the combine within
    ROUTE_TOL."""
    sg, E, k = cfg.moe_group, cfg.n_experts, cfg.top_k
    g = torch.Generator().manual_seed(11)
    logits = 0.5 * torch.randint(-3, 4, (2, sg, E), generator=g).float()
    logits[0, :, 0] += 1.0
    logits[1, sg // 2:] = 0.0
    logits = logits.to(torch.bfloat16)
    cap = model_mlp._capacity(cfg, sg)
    d_cpu, c_cpu = model_mlp.route_topk(logits, cfg, cap)
    d_dev, c_dev = model_mlp.route_topk(logits.to(DEV), cfg, cap)
    torch.cuda.synchronize()
    if not torch.equal(d_dev.cpu(), d_cpu):
        raise SystemExit(f"{cfg.name}: route_topk's dispatch on bf16 ties "
                         f"differs card vs CPU at "
                         f"{int((d_dev.cpu() != d_cpu).sum())} entries")
    c_err = close(f"{cfg.name} route_topk combine on bf16 ties", c_dev.cpu(),
                  c_cpu, ROUTE_TOL)
    srt = torch.sort(logits.float(), -1, descending=True)[0]
    at_edge = int((srt[..., k - 1] == srt[..., k]).sum())
    flat = int((srt[..., 0] == srt[..., -1]).sum())
    dropped = (k - d_cpu.sum((-2, -1))).sum(-1).tolist()
    print(f"[{card}] {cfg.name} route_topk on bf16 logits with exact ties "
          f"(2 groups of {sg}, capacity {cap}), card vs CPU: dispatch equal, "
          f"combine max_abs_err={c_err!r} (tol {ROUTE_TOL}); rows whose "
          f"top-{k} edge is a tie {at_edge} of {2 * sg}, all-equal (padded) "
          f"rows {flat}; (token, slot) assignments dropped per group "
          f"{dropped}")
    if at_edge == 0 or flat == 0 or min(dropped) <= 0:
        raise SystemExit(f"{cfg.name}: the tied logits missed ties at the "
                         f"edge, padded rows or drops")

def moe_layer_check(card, cfg, lp):
    """Check (b): one full-width MoE layer (layer 0's experts) in float32
    on one group of moe_group tokens, card against the CPU, with router
    column 0 skewed (+1 on its logit) so that capacity binds: route_topk
    on the same logits (dispatch equal, combine within ROUTE_TOL), then
    forward_moe (within MOE_LAYER_TOL of the largest output)."""
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    D, sg = cfg.d_model, cfg.moe_group
    g = gen(7)
    x = torch.randn((1, sg, D), generator=g, device=DEV) + 0.5
    p = {k: v.clone() if k == "router" else v for k, v in lp.items()}
    p["router"][:, 0] += 1.0 / (0.5 * D)
    t = time.perf_counter()
    p_cpu = {k: v.cpu() for k, v in p.items()}
    x_cpu = x.cpu()
    copy_s = time.perf_counter() - t
    logits = x_cpu @ p_cpu["router"]
    cap = model_mlp._capacity(cfg, sg)
    d_cpu, c_cpu = model_mlp.route_topk(logits, cfg32, cap)
    d_dev, c_dev = model_mlp.route_topk(logits.to(DEV), cfg32, cap)
    torch.cuda.synchronize()
    if not torch.equal(d_dev.cpu(), d_cpu):
        raise SystemExit(f"{cfg.name}: route_topk's dispatch on the card "
                         f"differs from the CPU's at "
                         f"{int((d_dev.cpu() != d_cpu).sum())} entries")
    c_err = close(f"{cfg.name} route_topk combine", c_dev.cpu(), c_cpu,
                  ROUTE_TOL)
    dropped = sg * cfg.top_k - int(d_cpu.sum())
    probs = torch.sort(torch.softmax(logits, -1), -1, descending=True)[0]
    margin = float((probs[..., cfg.top_k - 1] - probs[..., cfg.top_k]).min())
    out = model_mlp.forward_moe(p, x, cfg32)
    torch.cuda.synchronize()
    t = time.perf_counter()
    want = model_mlp.forward_moe(p_cpu, x_cpu, cfg32)
    host_s = time.perf_counter() - t
    top = float(want.abs().max())
    err = float((out.cpu() - want).abs().max())
    if tuple(out.shape) != tuple(want.shape) or not \
            torch.isfinite(out).all() or not err <= MOE_LAYER_TOL * top:
        raise SystemExit(f"{cfg.name}: forward_moe on the card is {err!r} "
                         f"from the CPU's, over {MOE_LAYER_TOL} of the "
                         f"largest output {top!r}")
    flops = 3 * 2 * cfg.n_experts * cap * D * cfg.d_ff
    print(f"[{card}] {cfg.name} one MoE layer at full width (D {D}, F "
          f"{cfg.d_ff}, {cfg.n_experts} experts top-{cfg.top_k}, one group "
          f"of {sg}, capacity {cap}), float32, card vs CPU: dispatch equal, "
          f"combine max_abs_err={c_err!r} (tol {ROUTE_TOL}); {dropped} of "
          f"{sg * cfg.top_k} (token, slot) assignments dropped at capacity "
          f"(expert loads {d_cpu.sum((0, 1, 3)).tolist()}); smallest top-"
          f"{cfg.top_k} margin {margin!r}; forward_moe max_abs_err={err!r} "
          f"= {err / top!r} of the largest output {top!r} (tol "
          f"{MOE_LAYER_TOL}); the CPU's layer {host_s!r} s for "
          f"{flops / 1e12!r} TFLOP of expert products, the weights' copy "
          f"{copy_s!r} s")
    if dropped <= 0:
        raise SystemExit(f"{cfg.name}: the skewed group dropped nothing")

def moe_serve(card):
    """mixtral-8x7b at full width, depth cut to MOE_LAYERS: the counted
    serving run through ``serve_lm.generate`` (bf16, 4 x 512 tokens, 16
    greedy steps; check (d): finite logits, tokens in range), prefill time,
    decode rate and peak memory; (a) float32 prefill against float32
    forward; (c) bf16 prefill against a float32 prefill that replays the
    bf16 routes, with the tokens float32 would route otherwise counted;
    (b) route_topk on bf16 ties and one MoE layer, card against CPU.
    Returns the counted run's launches."""
    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config(MOE_ARCH), n_layers=MOE_LAYERS)
    full = get_config(MOE_ARCH)
    api = get_api(cfg)
    torch.cuda.reset_peak_memory_stats()
    params = api.init(gen(0), DEV)
    init_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    torch.cuda.reset_peak_memory_stats()
    prompts = torch.randint(0, cfg.vocab, (LM_BATCH, LM_PROMPT),
                            generator=gen(1), device=DEV)
    (toks, logits, dec_s), wall, launches = run_counted(
        lambda: serve_lm.generate(api, params, prompts, LM_GEN))
    want = {k: LM_LAUNCHES[MOE_ARCH].get(k, 0) for k in kernels.LAUNCHES}
    if launches != want:
        raise SystemExit(f"{MOE_ARCH}: one prefill launched {launches}, "
                         f"want {want}")
    if tuple(logits.shape) != (LM_BATCH, LM_GEN + 1, cfg.vocab) or \
            not torch.isfinite(logits).all() or \
            tuple(toks.shape) != (LM_BATCH, LM_GEN) or \
            not ((toks >= 0) & (toks < cfg.vocab)).all():
        raise SystemExit(f"{MOE_ARCH}: decode logits {tuple(logits.shape)} "
                         f"not finite or tokens {tuple(toks.shape)} out of "
                         f"range")
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        api.prefill(params, {"tokens": prompts}, LM_PROMPT + LM_GEN)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    with recorded_routes() as bf16_calls:
        bf16_logits = api.prefill(params, {"tokens": prompts},
                                  LM_PROMPT + LM_GEN)[0]
    bf16_routes = token_routes(bf16_calls, LM_BATCH, LM_PROMPT)
    prefill_ms = 1e3 * sum(times) / len(times)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    kept = bf16_routes.sum(-1)                       # [layers, B, S]
    dropped = (cfg.top_k - kept).sum((1, 2)).tolist()
    print(f"[{card}] {MOE_ARCH} ({cfg.param_count / 1e9:.2f} B params f32, "
          f"{MOE_LAYERS} of {full.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_experts} experts top-{cfg.top_k}) batch {LM_BATCH} x "
          f"prompt {LM_PROMPT}: launches {launches}; prefill {prefill_ms!r} "
          f"ms ({LM_BATCH * LM_PROMPT / (prefill_ms / 1e3)!r} tok/s); decode "
          f"{LM_GEN} steps {dec_s!r} s = {LM_BATCH * LM_GEN / dec_s!r} "
          f"tok/s; peak memory serving {peak!r} GiB (the init's "
          f"{init_peak!r} GiB: a stacked expert leaf is drawn, then "
          f"scaled into a copy); counted run {wall!r} s; (token, "
          f"slot) assignments dropped at capacity in the bf16 prefill, per "
          f"layer: {dropped} of {LM_BATCH * LM_PROMPT * cfg.top_k}; sample "
          f"{toks[0][:8].tolist()}")
    # (a) float32 prefill against float32 forward: the same groups
    api32 = get_api(dataclasses.replace(cfg, dtype=torch.float32))
    with recorded_routes() as calls:
        f32_logits = api32.prefill(params, {"tokens": prompts},
                                   LM_PROMPT + LM_GEN)[0]
    f32_routes = token_routes(calls, LM_BATCH, LM_PROMPT)
    with recorded_routes() as calls:
        fwd = api32.forward(params, {"tokens": prompts})[:, -1]
    fwd_routes = token_routes(calls, LM_BATCH, LM_PROMPT)
    torch.cuda.synchronize()
    if not (torch.isfinite(f32_logits).all() and torch.isfinite(fwd).all()):
        raise SystemExit(f"{MOE_ARCH}: float32 logits not finite")
    torch.testing.assert_close(f32_logits, fwd, rtol=PREFILL_TOL,
                               atol=PREFILL_TOL,
                               msg=lambda m: f"{MOE_ARCH} (a): {m}")
    other = int((f32_routes != fwd_routes).any(-1).sum())
    print(f"{MOE_ARCH} (a): float32 prefill's last logits vs float32 "
          f"forward's last position: max_abs_err="
          f"{float((f32_logits - fwd).abs().max())!r} (rtol=atol="
          f"{PREFILL_TOL}; logits up to {float(fwd.abs().max())!r}); "
          f"(token, layer) pairs routed otherwise: {other}")
    del fwd
    # (c) bf16 prefill against a float32 prefill that replays its routes
    with recorded_routes(replay=bf16_calls) as calls:
        replayed = api32.prefill(params, {"tokens": prompts},
                                 LM_PROMPT + LM_GEN)[0]
    if len(calls) != len(bf16_calls):
        raise SystemExit(f"{MOE_ARCH}: the replayed prefill routed "
                         f"{len(calls)} times, the bf16 one "
                         f"{len(bf16_calls)}")
    differ = (bf16_routes != f32_routes).any(-1)          # [layers, B, S]
    rows = ((bf16_logits.float() - replayed).abs().amax(-1) /
            replayed.abs().max()).tolist()
    print(f"{MOE_ARCH} (c): the float32 prefill replays the bf16 prefill's "
          f"dispatch and combine at every layer; routed afresh, float32 "
          f"sends {differ.sum((1, 2)).tolist()} of {LM_BATCH * LM_PROMPT} "
          f"tokens a layer to other experts (the last token, in rows "
          f"{torch.nonzero(differ[:, :, -1].any(0)).flatten().tolist()}); "
          f"max |bf16 - f32| / max |f32| per row {rows}")
    bf16_check(MOE_ARCH, bf16_logits, replayed)
    del bf16_logits, f32_logits, replayed, logits, bf16_calls, calls
    # (b) route_topk on bf16 ties and one MoE layer, card against the CPU
    tied_routes_check(card, cfg)
    moe_layer_check(card, cfg, model_common.layer(
        params["blocks"]["layers"][0], 0)["mlp"])
    del params
    torch.cuda.empty_cache()
    print(f"[{card}] {MOE_ARCH}: serving phase {time.perf_counter() - t0!r} s")
    return launches

def small_lm_reference():
    """Each smoke arch (the MoE ones too) on the card against the CPU: the
    same weights (drawn on the CPU, copied over), the CPU's greedy tokens
    fed to both (teacher forcing), prefill and every decode step's logits
    at 1e-4."""
    for arch in serve_lm.ARCHS + MOE_SMOKE:
        api = get_api(get_config(arch))
        params = api.init(torch.Generator().manual_seed(0), "cpu")
        prompts = torch.randint(0, api.cfg.vocab, (4, 32),
                                generator=torch.Generator().manual_seed(1))
        toks, want, _ = serve_lm.generate(api, params, prompts, 16)
        on_card = lambda t: {k: on_card(v) for k, v in t.items()} \
            if isinstance(t, dict) else [on_card(v) for v in t] \
            if isinstance(t, list) else t.to(DEV)
        _, got, _ = serve_lm.generate(api, on_card(params), prompts.to(DEV),
                                      16, forced=toks.to(DEV))
        torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4,
                                   msg=lambda m: f"{arch} card vs CPU: {m}")
        print(f"small LM reference {arch} (batch 4, prompt 32, 16 steps): "
              f"card matches the CPU at 1e-4, max_abs_err="
              f"{float((got.cpu() - want).abs().max())!r}")

def main():
    t_start = time.perf_counter()
    card = nvidia_smi()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}")
    # full float32 products for the plain versions and the f32 checks
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch.backends.cuda.matmul.allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32} "
          f"torch.backends.cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    elapsed = lambda what: print(f"chip_smoke: {what} done at "
                                 f"{time.perf_counter() - t_start:.1f} s")
    build_phase()
    fused = kernel_phase(card)
    group = group_kernel_phase(card)
    lm = [flash_phase(card), wkv_phase(card), ssd_phase(card)]
    elapsed("build and kernel checks")
    main_path(card, fused)
    elapsed("frontier-sweep-2h")
    grid_row0, grid_steps_s = grid_path(card, group)
    elapsed("frontier-grid-6h")
    events_path(card, grid_row0, grid_steps_s)
    del grid_row0
    elapsed("frontier-events-6h")
    events_nogrid_path(card)
    elapsed("frontier-events no-grid 30 min")
    session, wire_ref = session_path(card)
    elapsed("frontier-session-2h")
    wire = wire_path(card, wire_ref)
    del wire_ref
    serve_subcommand(card)
    elapsed("wire and the serve subcommand")
    fugaku_path(card)
    elapsed("fugaku-sweep-2h")
    with tempfile.TemporaryDirectory(prefix="ml") as tmp:
        ml, es, trained_ck = ml_path(card, pathlib.Path(tmp))
    elapsed("ml-fugaku-train and ml-fugaku-36h")
    with tempfile.TemporaryDirectory(prefix="replay") as tmp:
        tmp = pathlib.Path(tmp)
        npz, wx = replay_path(card, tmp)
        elapsed("frontier-replay-2h")
        replay_cli(card, npz, wx, tmp)
        elapsed("the replay CLI")
        calibrate_path(card, tmp)
        elapsed("calibration")
    small_replay_reference(card)
    elapsed("the small replay reference")
    fig7 = fig7_path(card)
    elapsed("fig7")
    external_cli(card)
    elapsed("the external CLI")
    with tempfile.TemporaryDirectory(prefix="incentives") as tmp:
        tmp = pathlib.Path(tmp)
        fig8 = incentives_path(card, tmp)
        elapsed("marconi100-incentives-3h")
        frontier_flags_cli(card, tmp)
        elapsed("the frontier flags CLI")
        sharded = sharded_path(card)
        elapsed("the sharded sweep")
        small_incentives_reference(card, tmp)
        elapsed("the small incentives reference")
        ml_cli(card, tmp, trained_ck)
        elapsed("the ML CLI")
    loaded = sorted(m for m in ("pandas", "pyarrow") if m in sys.modules)
    if loaded:
        raise SystemExit(f"the trace and calibration phases imported "
                         f"{loaded}: the card's path must need neither")
    print(f"trace phases imported neither pandas nor pyarrow (pandas "
          f"installed here: {importlib.util.find_spec('pandas') is not None})")
    serve_path(card, lm)
    elapsed("LM serving")
    small_reference()
    elapsed("the small reference")
    small_grid_reference()
    elapsed("the small grid reference")
    small_events_reference(card)
    elapsed("the small events references")
    small_session_reference(card)
    elapsed("the small session reference")
    small_lm_reference()
    elapsed("the small LM reference")
    small_external_reference(card)
    elapsed("the small external reference")
    small_ml_reference(card)
    elapsed("the small ML reference")
    print("fig7 launches: " + "; ".join(
        f"{k}: fused_cooling {v['fused_cooling']}, group_power "
        f"{v['group_power']}" for k, v in fig7.items()))
    print(f"incentives launches (cold redeem in process): fused_cooling "
          f"{fig8['fused_cooling']}, group_power {fig8['group_power']}; "
          f"sharded launches: " + "; ".join(
              f"{k}: fused_cooling {v['fused_cooling']}"
              for k, v in sharded.items()))
    print(f"ml launches: fused_cooling {ml['fused_cooling']}, group_power "
          f"{ml['group_power']}; ES training (fig10's loop): fused_cooling "
          f"{es['fused_cooling']}, group_power {es['group_power']}")
    print(f"session launches: group_power {session['group_power']}, "
          f"fused_cooling {session['fused_cooling']}; wire launches: "
          f"group_power {wire['group_power']}, fused_cooling "
          f"{wire['fused_cooling']}")
    # the grid sweep's rate says how fast this machine's host is: budgets
    # scale the total by it
    print(f"chip_smoke: all phases passed in "
          f"{time.perf_counter() - t_start:.1f} s (grid sweep "
          f"{grid_steps_s!r} steps/s on this machine)")
    print(json.dumps({"kernels": [fused, group, *lm]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))

if __name__ == "__main__":
    main()
