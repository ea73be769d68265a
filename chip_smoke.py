"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds every Hopper kernel of the port from the sources in this checkout
(one ``nvcc`` per source, all at once), holds each against its plain
PyTorch version on the card and times it, then drives the port's paths
through their entry points at full width and checks what comes out:

* the no-grid Frontier scenario sweep (9,600 nodes, 25 CDU groups, 1,238
  jobs, 6 h = 1,440 steps, 8 scenarios), which runs the fused cooling
  kernel once a step;
* ``frontier-grid-6h``, the grid path: the same machine and backlog
  under synthetic carbon, price and power-cap signals (the evening cap
  dip in the last 3 h), 12 (cap level x policy x weight) scenarios, which
  runs the group-power kernel once a step;
* ``frontier-events-6h``, the grid path again under weather, failures
  and demand response: ``frontier-grid-6h``'s machine, backlog and
  signals, 8 (policy x summer trace or heat wave x failure seed and
  rates) scenarios with node, CDU-group and tower-cell failures and a
  demand-response cap step, one group-power launch a step; and the same
  scenarios for 1 h without signals or DR, one fused cooling launch a
  step;
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
* LM serving (``repro_torch.launch.serve_lm``) of qwen2.5-3b, rwkv6-7b
  and zamba2-7b at full width, one after another: 4 prompts of 512
  tokens and 16 greedy decode steps, whose prefills run the flash
  attention, WKV and SSD kernels, with a float32 self-check of each and
  the bf16 prefill's logits held to the float32 prefill's;

and a small card-against-CPU check of each path (with weather and
failures on, also of the event layer's draws; a small session too). Before the paths, each
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

import dataclasses
import json
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
from repro_torch.core import scheduler as sched  # noqa: E402
from repro_torch.core import stats as stats_mod  # noqa: E402
from repro_torch.core import transport as tr  # noqa: E402
from repro_torch.core import types as T  # noqa: E402
from repro_torch.cooling import model as cooling  # noqa: E402
from repro_torch.cooling import weather as wsig  # noqa: E402
from repro_torch.datasets import loaders  # noqa: E402
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
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import common as model_common  # noqa: E402
from repro_torch.models import rwkv6  # noqa: E402
from repro_torch.models.zoo import get_api  # noqa: E402
from repro_torch.serve import TwinSession  # noqa: E402
from repro_torch.serve import snapshot as snap  # noqa: E402
from repro_torch.systems.config import FacilityTopology, get_system  # noqa: E402

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
EVENTS_NOGRID_T1 = 3600.0    # the no-grid events run: 240 steps
# frontier-session-2h: a what-if session on frontier-grid-6h's machine,
# backlog and signals, in 15 min intervals; the root runs alone to 1 h,
# where four forks branch off, then all five advance together to 2 h
SESSION_INTERVAL = 60
SESSION_T1 = 2 * 3600.0
SESSION_FORK_AT = 4          # intervals: step 240, t = 1 h
# the wire phase serves the same tree to step 360: five clients advance
# the five branches 2 intervals at once
WIRE_ADVANCE = 2

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

def check_row_vs_solo(label, finals, hists, solo):
    """Sweep row 0 against a solo run of the same scenario: schedules
    exactly, every float series bit for bit (at rtol 1e-6 first, so a
    miss says how far off it is)."""
    solo_f, solo_h = solo
    row_f, row_h = T.row(finals, 0), T.row(hists, 0)
    for name in ("jstate", "start", "end", "node_job"):
        if not torch.equal(getattr(solo_f, name), getattr(row_f, name)):
            raise SystemExit(f"{label}: sweep row 0 and the solo run "
                             f"disagree on {name}")
    identical = True
    for name, a in vars(solo_h).items():
        b = getattr(row_h, name)
        torch.testing.assert_close(a, b, rtol=1e-6, atol=0.0,
                                   msg=lambda m: f"{label} solo vs row 0 "
                                   f"{name}: {m}")
        identical &= torch.equal(a, b)
    print(f"{label}: sweep row 0 vs solo run: schedules equal, float series "
          f"within rtol 1e-6, bit-identical={identical}")
    if not identical:
        raise SystemExit(f"{label}: sweep row 0 is not bit-identical to the "
                         f"solo run")

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
    n_steps = int(round(FRONTIER_T1 / system.dt))
    S = len(scens)
    print(f"main path: frontier N={system.n_nodes} G={system.cooling.n_groups} "
          f"J={table.num_jobs} steps={n_steps} S={S}")
    run = lambda: eng.simulate_sweep(system, table, scens, 0.0, FRONTIER_T1)
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
    check_row_vs_solo("no-grid sweep", finals, hists, eng.simulate_static(
        system, table, *SWEEP[0], 0.0, FRONTIER_T1))
    admit_s, total = admission_share(run)
    print(f"[{card}] admission loop: {admit_s!r} s of {total!r} s "
          f"= {admit_s / total!r} of step time (synchronised run)")
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
    # row 0 is fcfs:first-fit at cap scale 1, which simulate_static names
    row0 = eng.simulate_static(system, table, *GRID_SWEEP[0][:2], 0.0,
                               FRONTIER_T1, signals=sig)
    check_row_vs_solo("grid sweep", finals, hists, row0)
    admit_s, total = admission_share(run)
    print(f"[{card}] grid admission loop: {admit_s!r} s of {total!r} s "
          f"= {admit_s / total!r} of step time (synchronised run)")
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
    demand-response event, one group_power launch a step."""
    system, table, sig, n_steps, knobs, weather, dr, labels = events_case()
    scens = [T.Scenario.make(**k, **dr) for k in knobs]
    S = len(scens)
    print(f"events path frontier-events-6h: N={system.n_nodes} "
          f"G={system.cooling.n_groups} C={system.cooling.n_tower_cells} "
          f"J={table.num_jobs} steps={n_steps} S={S}; base rates "
          f"{BASE_RATES} (x4 for seed 2), DR {dr}")
    run = lambda: eng.simulate_sweep(system, table, scens, 0.0, FRONTIER_T1,
                                     signals=sig, weather=weather,
                                     events=EventConfig())
    (finals, hists), wall, launches = run_counted(run)
    print(f"[{card}] events sweep: {n_steps} steps x {S} scenarios in "
          f"{wall!r} s = {n_steps / wall!r} steps/s (grid sweep "
          f"{grid_steps_s!r} steps/s in this run), launches {launches} = "
          f"{launches['group_power'] / n_steps!r} group_power a step (grid "
          f"sweep: 1.0)")
    if launches["group_power"] != n_steps or launches["fused_cooling"] != 0:
        raise SystemExit(f"events sweep of {n_steps} steps launched "
                         f"{launches}")
    check_run("events sweep", finals, hists, n_steps, S)
    # the cap in force: the signal's, or the DR cap while the event holds
    t = hists.t[0]
    start = dr["dr_announce_s"] + dr["dr_notice_s"]
    active = (t >= start) & (t < start + dr["dr_duration_s"])
    dr_cap = torch.tensor(dr["dr_cap_w"], dtype=torch.float32, device=DEV)
    want_cap = torch.minimum(sig.cap_w.to(DEV)[:n_steps],
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
    solo = eng.simulate(system, table, scens[0], 0.0, FRONTIER_T1,
                        signals=sig, weather=weather[0],
                        events=EventConfig())
    check_row_vs_solo("events sweep", finals, hists, solo)
    for name, a in vars(solo[0].events).items():
        if not torch.equal(a, getattr(ev, name)[0]):
            raise SystemExit(f"events sweep: row 0's {name} differs from "
                             f"the solo run's")
    # events on at zero rates with DR off, under a constant trace at the
    # config's wet-bulb: the grid sweep's row 0, bit for bit
    const = wsig.constant_weather(n_steps, system.cooling.t_wetbulb_c)
    zero_f, zero_h = eng.simulate(
        system, table, T.Scenario.make(*EVENT_POLICIES[0]), 0.0, FRONTIER_T1,
        signals=sig, weather=const, events=EventConfig())
    (row_f, row_h) = grid_row0
    same = all(torch.equal(getattr(zero_h, k), v) for k, v in
               vars(row_h).items()) and all(
        torch.equal(getattr(zero_f, k), getattr(row_f, k))
        for k in ("jstate", "start", "end", "node_job", "energy_total",
                  "jenergy", "emissions_kg", "energy_cost"))
    if not same or float(zero_f.events.jobs_killed) != 0.0:
        raise SystemExit("events sweep: events on at zero rates with a "
                         "constant trace differ from the grid sweep's row 0")
    print("events sweep: events on at zero rates, DR off, constant trace at "
          "the config's wet-bulb: bit-identical to the grid sweep's row 0")
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
    """The frontier-events-6h scenarios without signals or DR, 1 h: one
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
                events=None, t1=2 * 3600.0):
    """The card's engine (with the kernels) against the port's CPU engine
    (plain versions): schedules exactly, floats at 1e-4. ``throttle_frac``
    is 1 - c with c near 1, so it also gets atol 1e-6 (a one-ulp
    difference in c from another summation order). With the event layer
    the repair times also go through the card's ``log1p``: a schedule
    that differs is reported with the first step whose counts differ."""
    kw = dict(num_accounts=8, signals=signals, weather=weather,
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
    card_vs_cpu("small reference", system, table, scens)
    print("small reference (marconi100 x64, 4 halls, 3 scenarios, 2 h): card "
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
    KV=2, hd=128) and zamba2-7b's (H=32 MHA, hd=112) prefill shapes,
    serve_lm's ragged 32-token prompt, a sliding window, S < T, a row past
    a 64-row tile (S = T = 129) and hd=64 GQA (qwen2.5-0.5b's heads).
    bfloat16 runs the tensor-core kernel, float32 the CUDA-core one."""
    cases = [("qwen2.5-3b", 4, 512, 512, 16, 2, 128, 0),
             ("qwen2.5-3b prompt 32", 4, 32, 32, 16, 2, 128, 0),
             ("zamba2-7b", 4, 512, 512, 32, 32, 112, 0),
             ("zamba2-7b prompt 32", 4, 32, 32, 32, 32, 112, 0),
             ("window 200", 2, 512, 512, 16, 2, 128, 200),
             ("S=100 < T=300", 2, 100, 300, 8, 2, 64, 0),
             ("S=T=129", 2, 129, 129, 16, 2, 128, 0),
             ("hd=64 GQA", 4, 512, 512, 14, 2, 64, 0)]
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
# LM serving at full width: qwen2.5-3b, rwkv6-7b, zamba2-7b.
# ---------------------------------------------------------------------------
LM_ARCHS = ["qwen2.5-3b", "rwkv6-7b", "zamba2-7b"]
# kernel launches of one prefill (the decode runs no kernel): a flash
# attention per layer; a WKV per layer; an SSD per Mamba2 layer and a
# flash attention per shared-block call (81 layers, every 6th: 13 calls)
# (bf16: the tensor-core flash and WKV kernels; the float32 ones launch
# nothing)
LM_LAUNCHES = {"qwen2.5-3b": {"flash_attention_tc": 36},
               "rwkv6-7b": {"wkv_tc": 32},
               "zamba2-7b": {"ssd": 81, "flash_attention_tc": 13}}
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
BF16_LOGIT_TOL = {"qwen2.5-3b": 0.05, "rwkv6-7b": 0.5, "zamba2-7b": 0.05}

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
    for e in entries:
        e["launches"] = total[LM_COUNTER[e["name"]]]
    print(f"LM serving launches in all: {total}")

def small_lm_reference():
    """Each smoke arch on the card against the CPU: the same weights
    (drawn on the CPU, copied over), the CPU's greedy tokens fed to both
    (teacher forcing), prefill and every decode step's logits at 1e-4."""
    for arch in serve_lm.ARCHS:
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
    elapsed("frontier-sweep-6h")
    grid_row0, grid_steps_s = grid_path(card, group)
    elapsed("frontier-grid-6h")
    events_path(card, grid_row0, grid_steps_s)
    del grid_row0
    elapsed("frontier-events-6h")
    events_nogrid_path(card)
    elapsed("frontier-events no-grid 1 h")
    session, wire_ref = session_path(card)
    elapsed("frontier-session-2h")
    wire = wire_path(card, wire_ref)
    del wire_ref
    serve_subcommand(card)
    elapsed("wire and the serve subcommand")
    fugaku_path(card)
    elapsed("fugaku-sweep-2h")
    serve_path(card, lm)
    elapsed("LM serving")
    small_reference()
    small_grid_reference()
    small_events_reference(card)
    small_session_reference(card)
    small_lm_reference()
    print(f"session launches: group_power {session['group_power']}, "
          f"fused_cooling {session['fused_cooling']}; wire launches: "
          f"group_power {wire['group_power']}, fused_cooling "
          f"{wire['fused_cooling']}")
    print(f"chip_smoke: all phases passed in "
          f"{time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [fused, group, *lm]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))

if __name__ == "__main__":
    main()
