"""Hopper SSD with its final state: build, bind, launch.

``csrc/ssd.cu`` replaces the Pallas TPU kernel ``ssd_pallas``
(``repro/kernels/mamba2_ssd/mamba2_ssd.py``) and also writes the final
state, which that kernel drops. Its entry point chooses by dtype:
bfloat16 x, B, C (the serving path) run the chunked form on the tensor
cores, float32 the per-token recurrence on the CUDA cores.
``kernels._build`` compiles it for ``sm_90a`` at first use and binds it
with ``ctypes``. The wrapper takes CUDA tensors only; the CPU path is
``ref.ssd_chunked``, chosen by ``ops.ssd`` from the tensor's device.
"""
from __future__ import annotations

import pathlib

import torch

from repro_torch import kernels
from repro_torch.kernels import _build
from repro_torch.kernels._build import I as _I, P as _P

LIB = _build.Library(pathlib.Path(__file__).parent, {
    "ssd": [_P, _P, _P, _P, _P, _P, _P,     # x, dt, a, B, C, y, state
            _I, _I, _I, _I, _I, _I,         # Bz, S, H, P, N, bf16
            _P],                            # stream
})
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
NS = (8, 16, 32, 64)
P_MAX = 128


def ssd_cuda(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor):
    """Launch the SSD kernel on the current stream.

    Args:
      x: [Bz, S, H, P]; B, C: [Bz, S, N], x's dtype (float32 or
        bfloat16; then 16-byte aligned); dt, a: f32[Bz, S, H] step sizes
        and decays in (0, 1]. All contiguous, on one CUDA device; P <= 128,
        N in (8, 16, 32, 64).
    Returns:
      (y f32[Bz, S, H, P], final state f32[Bz, H, P, N]).
    """
    if x.ndim != 4 or B.ndim != 3:
        raise ValueError(f"ssd: x must be [Bz, S, H, P] and B [Bz, S, N], got "
                         f"{tuple(x.shape)} and {tuple(B.shape)}")
    Bz, S, H, P = x.shape
    N = B.shape[-1]
    if N not in NS or not 1 <= P <= P_MAX or min(Bz, S, H) < 1:
        raise ValueError(f"ssd: unsupported shape x {tuple(x.shape)}, N={N} "
                         f"(P <= {P_MAX}, N in {NS})")
    for name, z, shape in (("dt", dt, (Bz, S, H)), ("a", a, (Bz, S, H)),
                           ("B", B, (Bz, S, N)), ("C", C, (Bz, S, N))):
        if tuple(z.shape) != shape:
            raise ValueError(f"ssd: {name} has shape {tuple(z.shape)}, want "
                             f"{shape}")
    if x.dtype not in DTYPES or B.dtype != x.dtype or C.dtype != x.dtype:
        raise ValueError(f"ssd: x, B, C must all be float32 or bfloat16, got "
                         f"{x.dtype}, {B.dtype}, {C.dtype}")
    for name, z in (("dt", dt), ("a", a)):
        if z.dtype != torch.float32:
            raise ValueError(f"ssd: {name} must be float32, got {z.dtype}")
    for name, z in (("x", x), ("dt", dt), ("a", a), ("B", B), ("C", C)):
        if z.device.type != "cuda" or z.device != x.device:
            raise ValueError(f"ssd: {name} must be a CUDA tensor on x's "
                             f"device, got {z.device}")
        if not z.is_contiguous():
            raise ValueError(f"ssd: {name} must be contiguous")
        if x.dtype == torch.bfloat16 and name in ("x", "B", "C") and \
                z.data_ptr() % 16:
            raise ValueError(f"ssd: {name} must start on a 16-byte boundary")
    y = torch.empty((Bz, S, H, P), dtype=torch.float32, device=x.device)
    state = torch.empty((Bz, H, P, N), dtype=torch.float32, device=x.device)
    _build.launch(LIB, "ssd", x.device, x.data_ptr(), dt.data_ptr(),
                  a.data_ptr(), B.data_ptr(), C.data_ptr(), y.data_ptr(),
                  state.data_ptr(), Bz, S, H, P, N, DTYPES[x.dtype])
    kernels.LAUNCHES["ssd"] += 1
    return y, state
