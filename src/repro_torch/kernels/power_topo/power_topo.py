"""Hopper kernel for the fused node->CDU cooling step: build, bind, launch.

``csrc/fused_cooling.cu`` replaces the Pallas TPU kernel
``fused_cooling_pallas`` (``repro/kernels/power_topo/power_topo.py``). It
is compiled with ``nvcc`` for ``sm_90a`` into a shared library with a
plain C entry point at first use, into ``build/`` beside this module (a
directory git ignores), and bound with ``ctypes``. Nothing here runs at
import time, so the CPU-only tests can import the module.

The wrapper takes CUDA tensors only; the CPU path is ``ref.py``, chosen
by ``ops`` from the tensor's device.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess

import torch

from repro_torch import kernels
from repro_torch.kernels.power_topo.ref import CduParams, slew_factors

_HERE = pathlib.Path(__file__).resolve().parent
_SOURCE = _HERE / "csrc" / "fused_cooling.cu"
BUILD_DIR = _HERE / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler",
              "-fPIC")

_lib = None          # the loaded library, once built
build_log = ""       # nvcc's output of the last build (ptxas register use)

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
_ARGTYPES = [_P, _I, _I, _I, _I,                 # node_pw, S, N, G, span
             _P, _P, _P, _L, _L, _P, _L, _L,     # t_sup, mdot, tb(+strides), tset(+strides)
             _F, _F, _F, _F, _F, _F, _F,         # CDU scalars
             _P, _P, _P, _P, _P]                 # 4 outputs, stream


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or \
        "/usr/local/cuda"
    return str(pathlib.Path(home) / "bin" / "nvcc")


def build() -> pathlib.Path:
    """Compile the kernel (if this source and these flags have not been
    built yet) and return the library's path. Raises if ``nvcc`` fails."""
    global build_log
    digest = hashlib.sha256(_SOURCE.read_bytes() +
                            " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"libfused_cooling-{digest}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_SOURCE)],
                          capture_output=True, text=True)
    build_log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {_SOURCE}:\n{build_log}")
    os.replace(tmp, out)   # atomic: a concurrent process never loads a partial file
    return out


def _library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        lib.fused_cooling_launch.argtypes = _ARGTYPES
        lib.fused_cooling_launch.restype = ctypes.c_int
        _lib = lib
    return _lib


def fused_cooling_cuda(node_pw: torch.Tensor, t_supply: torch.Tensor,
                       mdot: torch.Tensor, t_basin: torch.Tensor,
                       t_set: torch.Tensor, n_groups: int, p: CduParams):
    """Launch the fused kernel on the current stream.

    Args:
      node_pw: f32[S, N] per-node power (W), contiguous, on a CUDA device.
      t_supply, mdot: f32[S, G] CDU loop state (°C, kg/s), contiguous.
      t_basin, t_set: f32[S, G] basin temperature and setpoint seen by each
        group (°C); any strides, so a broadcast (expanded) column is
        passed without a copy.
    Returns:
      (q, t_return, t_supply_new, mdot_new), each a new f32[S, G].
    """
    if node_pw.ndim != 2:
        raise ValueError(f"fused_cooling: node_pw must have shape [S, N], "
                         f"got {tuple(node_pw.shape)}")
    S, N = node_pw.shape
    args = (("node_pw", node_pw, (S, N)), ("t_supply", t_supply, (S, n_groups)),
            ("mdot", mdot, (S, n_groups)), ("t_basin", t_basin, (S, n_groups)),
            ("t_set", t_set, (S, n_groups)))
    for name, x, shape in args:
        if x.dtype != torch.float32:
            raise ValueError(f"fused_cooling: {name} must be float32, got "
                             f"{x.dtype}")
        if tuple(x.shape) != shape:
            raise ValueError(f"fused_cooling: {name} has shape "
                             f"{tuple(x.shape)}, want {shape}")
    dev = node_pw.device
    for name, x, _ in args:
        if x.device.type != "cuda" or x.device != dev:
            raise ValueError(f"fused_cooling: {name} must be a CUDA tensor "
                             f"on the device of node_pw, got {x.device}")
    for name, x, _ in args[:3]:
        if not x.is_contiguous():
            raise ValueError(f"fused_cooling: {name} must be contiguous")
    span = -(-N // n_groups)        # ceil: matches ref.group_ids
    a_valve, a_hx = slew_factors(p)
    outs = [torch.empty((S, n_groups), dtype=torch.float32, device=dev)
            for _ in range(4)]
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fused_cooling_launch(
            node_pw.data_ptr(), S, N, n_groups, span,
            t_supply.data_ptr(), mdot.data_ptr(),
            t_basin.data_ptr(), t_basin.stride(0), t_basin.stride(1),
            t_set.data_ptr(), t_set.stride(0), t_set.stride(1),
            a_valve, a_hx, p.cp_j_kg_k, p.cp_j_kg_k * p.delta_t_design_c,
            p.ua_w_k, p.mdot_min_kg_s, p.mdot_max_kg_s,
            *(o.data_ptr() for o in outs), stream)
    if err != 0:
        raise RuntimeError(f"fused_cooling: kernel launch failed with CUDA "
                           f"error {err}")
    kernels.LAUNCHES["fused_cooling"] += 1
    return tuple(outs)
