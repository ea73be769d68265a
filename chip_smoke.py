"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds every Hopper kernel of the port's main path from the sources in
this checkout, holds each against its plain PyTorch version on the card,
times it, then drives the main path (the Frontier scenario sweep at full
width: 9,600 nodes, 25 CDU groups, 1,238 jobs, 6 h = 1,440 steps, 8
scenarios) through ``repro_torch.core.engine`` and checks what comes out.
Any failed phase exits non-zero; nothing is caught and passed over. The
last line is the JSON device record; the line before it lists the
kernels with their launches, errors and times.

Exits non-zero without printing a result when no CUDA card is visible,
or when the ``src/repro_torch`` package is not beside this script.
"""
from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke: torch.cuda.is_available() is False; this smoke "
             "run needs an NVIDIA card")

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent / "src"))

from repro_torch import kernels  # noqa: E402
from repro_torch.core import engine as eng  # noqa: E402
from repro_torch.core import scheduler as sched  # noqa: E402
from repro_torch.core import stats as stats_mod  # noqa: E402
from repro_torch.core import types as T  # noqa: E402
from repro_torch.cooling import model as cooling  # noqa: E402
from repro_torch.datasets import loaders  # noqa: E402
from repro_torch.datasets.synthetic import WorkloadSpec, generate  # noqa: E402
from repro_torch.kernels.power_topo import ops as topo_ops  # noqa: E402
from repro_torch.kernels.power_topo import power_topo  # noqa: E402
from repro_torch.kernels.power_topo import ref as topo_ref  # noqa: E402
from repro_torch.launch.simulate import build_system  # noqa: E402
from repro_torch.systems.config import FacilityTopology, get_system  # noqa: E402

DEV = torch.device("cuda")
HBM_BYTES_S = 3.35e12        # H100 SXM device memory rate (data sheet)
F32_FLOP_S = 67e12           # H100 SXM float32 rate outside tensor cores
KERNEL_TOL = 1e-4            # rtol = atol: the reference's own kernel bound
SWEEP = [("fcfs", "easy"), ("fcfs", "none"), ("sjf", "first-fit"),
         ("ljf", "easy"), ("priority", "first-fit"),
         ("acct_fugaku_pts", "easy"), ("thermal_aware", "easy"),
         ("replay", "none")]
FRONTIER_T1 = 6 * 3600.0     # the CLI's default window

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

def kernel_phase(card):
    t = time.perf_counter()
    lib = power_topo.build()
    print(f"build: {lib.name} in {time.perf_counter() - t:.2f} s "
          f"(nvcc {' '.join(power_topo.NVCC_FLAGS)})")
    for line in power_topo.build_log.splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())
    fr, fu = get_system("frontier"), get_system("fugaku")
    err = check_kernel("frontier", fr, 8, 9600, 25, 1, 1)
    check_kernel("frontier-5halls", fr, 8, 9600, 25, 5, 2)
    check_kernel("fugaku", fu, 8, 158976, 32, 1, 3)
    check_kernel("ragged", fr, 8, 9601, 25, 1, 4)

    # timing at the main path's shape: Frontier, 8 scenarios, one hall
    S, N, G = 8, 9600, 25
    p = cooling.cdu_params(fr.cooling, fr.dt)
    x, ts, md, tb, tset = cooling_inputs(S, N, G, 1, 5)
    tb_g = tb.expand(S, G)
    kernel = lambda: topo_ops.fused_cooling(x, ts, md, tb_g, tset, G, p)
    plain = lambda: topo_ref.fused_cooling_ref(x, ts, md, tb_g, tset, G, p)
    # yardstick only (the port never calls it): one library reduction over
    # the same spans, without the CDU update
    library = lambda: torch.sum(x.view(S, G, N // G), -1)
    ms, plain_ms, lib_ms = graph_ms(kernel), graph_ms(plain), graph_ms(library)
    eager = {name: cuda_ms(f) for name, f in
             (("kernel", kernel), ("plain", plain), ("torch.sum", library))}
    n_bytes = 4 * (S * N + 4 * S * G + 4 * S * G)   # each input once, outputs once
    n_ops = S * N + 16 * S * G                       # adds + the CDU update
    bound_ms = max(n_bytes / HBM_BYTES_S, n_ops / F32_FLOP_S) * 1e3
    bound_by = "bytes" if n_bytes / HBM_BYTES_S >= n_ops / F32_FLOP_S \
        else "operations"
    print(f"[{card}] fused_cooling S={S} N={N} G={G} on the card (CUDA "
          f"graph): kernel {ms!r} ms, plain {plain_ms!r} ms, torch.sum "
          f"{lib_ms!r} ms, bound {bound_ms!r} ms ({bound_by}: {n_bytes} B, "
          f"{n_ops} ops)")
    print(f"[{card}] fused_cooling per eager call, host included: "
          + ", ".join(f"{k} {v!r} ms" for k, v in eager.items()))
    return dict(name="fused_cooling", route="cuda",
                source="src/repro_torch/kernels/power_topo/csrc/fused_cooling.cu",
                replaces="src/repro/kernels/power_topo/power_topo.py:91",
                launches=None, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=lib_ms)

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

def main_path(card, entry):
    system, table = frontier_case()
    scens = [T.Scenario.make(p, b) for p, b in SWEEP]
    n_steps = int(round(FRONTIER_T1 / system.dt))
    S = len(scens)
    print(f"main path: frontier N={system.n_nodes} G={system.cooling.n_groups} "
          f"J={table.num_jobs} steps={n_steps} S={S}")

    for k in kernels.LAUNCHES:
        kernels.LAUNCHES[k] = 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    finals, hists = eng.simulate_sweep(system, table, scens, 0.0, FRONTIER_T1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = dict(kernels.LAUNCHES)
    print(f"[{card}] sweep: {n_steps} steps x {S} scenarios in {wall!r} s = "
          f"{n_steps / wall!r} steps/s, launches {launches}")
    if launches["fused_cooling"] != n_steps:
        raise SystemExit(f"fused_cooling launched {launches['fused_cooling']}"
                         f" times in {n_steps} steps")
    entry["launches"] = launches["fused_cooling"]
    check_run("sweep", finals, hists, n_steps, S)
    for i, (p, b) in enumerate(SWEEP):
        s = stats_mod.summarize(system, table, T.row(finals, i),
                                T.row(hists, i))
        print(f"  {p}:{b}: jobs_completed={s['jobs_completed']:.0f} "
              f"avg_util={s['avg_util']:.4f} avg_pue={s['avg_pue']:.5f} "
              f"avg_wait_s={s['avg_wait_s']:.1f} "
              f"t_tower_return_max_c={s['t_tower_return_max_c']:.3f}")

    # row 0 against a solo run of the same scenario
    solo_f, solo_h = eng.simulate_static(system, table, *SWEEP[0], 0.0,
                                         FRONTIER_T1)
    row_f, row_h = T.row(finals, 0), T.row(hists, 0)
    for name in ("jstate", "start", "end", "node_job"):
        if not torch.equal(getattr(solo_f, name), getattr(row_f, name)):
            raise SystemExit(f"sweep row 0 and the solo run disagree on "
                             f"{name}")
    identical = True
    for name, a in vars(solo_h).items():
        b = getattr(row_h, name)
        torch.testing.assert_close(a, b, rtol=1e-6, atol=0.0,
                                   msg=lambda m: f"solo vs row 0 {name}: {m}")
        identical &= torch.equal(a, b)
    print(f"sweep row 0 vs solo simulate_static: schedules equal, float "
          f"series within rtol 1e-6, bit-identical={identical}")

    # where a step's time goes: the same sweep with the card synchronised
    # around each admission loop and each step
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
        eng.simulate_sweep(system, table, scens, 0.0, FRONTIER_T1)
        torch.cuda.synchronize()
        total = time.perf_counter() - t
    finally:
        sched._admit = admit
    print(f"[{card}] admission loop: {spent['admit']!r} s of {total!r} s "
          f"= {spent['admit'] / total!r} of step time (synchronised run)")
    print(f"[{card}] fused_cooling total on the main path: "
          f"{entry['ms'] * n_steps!r} ms on the card ({n_steps} launches x "
          f"{entry['ms']!r} ms) of {wall * 1e3!r} ms")

def small_reference():
    """The card's engine (with the kernel) against the port's CPU engine
    (plain versions) on a small input: schedules exactly, floats at 1e-4."""
    system = build_system("marconi100", 64, 4)
    js = generate(system, WorkloadSpec(n_jobs=64, duration_s=4 * 3600.0,
                                       load=1.4, trace_len=8, n_accounts=8,
                                       mean_wall_s=1800.0, seed=4))
    js.assign_prepop_placement(0.0, system.n_nodes)
    table = js.to_table(80)
    scens = [T.Scenario.make("fcfs", "easy"),
             T.Scenario.make("sjf", "first-fit"),
             T.Scenario.make("acct_avg_power", "none")]
    fg, hg = eng.simulate_sweep(system, table, scens, 0.0, 2 * 3600.0,
                                num_accounts=8)
    fc, hc = eng.simulate_sweep(system, table, scens, 0.0, 2 * 3600.0,
                                num_accounts=8, device="cpu")
    for name in ("jstate", "start", "end", "node_job"):
        if not torch.equal(getattr(fg, name).cpu(), getattr(fc, name)):
            raise SystemExit(f"small reference: card and CPU disagree on "
                             f"{name}")
    for name, a in vars(hc).items():
        torch.testing.assert_close(getattr(hg, name).cpu(), a, rtol=1e-4,
                                   atol=1e-4,
                                   msg=lambda m: f"small reference {name}: {m}")
    print("small reference (marconi100 x64, 4 halls, 3 scenarios, 2 h): card "
          "matches the CPU engine, schedules exact, floats within 1e-4")

def main():
    card = nvidia_smi()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}")
    entry = kernel_phase(card)
    main_path(card, entry)
    small_reference()
    print(json.dumps({"kernels": [entry]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))

if __name__ == "__main__":
    main()
