"""Hopper WKV with its final state: build, bind, launch.

Two kernels replace the Pallas TPU kernel ``wkv_pallas``
(``repro/kernels/rwkv6_wkv/rwkv6_wkv.py``), one per dtype, and also
write the final state, which that kernel drops: ``csrc/wkv_tc.cu`` takes
bfloat16 r, k, v (the serving path), chunked on the tensor cores;
``csrc/wkv.cu`` takes float32, the per-token recurrence on the CUDA
cores. ``kernels._build`` compiles each for ``sm_90a`` at first use and
binds it with ``ctypes``. The wrapper takes CUDA tensors only; the CPU
path is ``ref.wkv_chunked``, chosen by ``ops.wkv`` from the tensor's
device.
"""
from __future__ import annotations

import pathlib

import torch

from repro_torch import kernels
from repro_torch.kernels import _build
from repro_torch.kernels._build import I as _I, P as _P

_ARGS = [_P, _P, _P, _P, _P, _P, _P,        # r, k, v, w, u, y, state
         _I, _I, _I, _I,                    # B, S, H, hd
         _P]                                # stream
LIB = _build.Library(pathlib.Path(__file__).parent, {
    "wkv": _ARGS,                           # float32, CUDA cores
    "wkv_tc": _ARGS,                        # bfloat16, tensor cores
})
KERNEL = {torch.float32: "wkv", torch.bfloat16: "wkv_tc"}
HDS = (8, 16, 32, 64)


def wkv_cuda(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             w: torch.Tensor, u: torch.Tensor):
    """Launch the WKV kernel on the current stream.

    Args:
      r, k, v: [B, S, H, hd], one dtype: bfloat16 (the tensor-core
        kernel; r, k, v and w then 16-byte aligned) or float32 (the
        recurrence); w: f32[B, S, H, hd] decays in (0, 1]; u: f32[H, hd]
        bonus. All contiguous, on one CUDA device; hd in (8, 16, 32, 64).
    Returns:
      (y [B, S, H, hd] in r's dtype, final state f32[B, H, hd, hd]).
    """
    if r.ndim != 4:
        raise ValueError(f"wkv: r must have shape [B, S, H, hd], got "
                         f"{tuple(r.shape)}")
    B, S, H, hd = r.shape
    if hd not in HDS or min(B, S, H) < 1:
        raise ValueError(f"wkv: unsupported shape {tuple(r.shape)} (hd in "
                         f"{HDS})")
    for name, x, shape in (("k", k, r.shape), ("v", v, r.shape),
                           ("w", w, r.shape), ("u", u, (H, hd))):
        if tuple(x.shape) != tuple(shape):
            raise ValueError(f"wkv: {name} has shape {tuple(x.shape)}, want "
                             f"{tuple(shape)}")
    if r.dtype not in KERNEL or k.dtype != r.dtype or v.dtype != r.dtype:
        raise ValueError(f"wkv: r, k, v must all be float32 or bfloat16, got "
                         f"{r.dtype}, {k.dtype}, {v.dtype}")
    for name, x in (("w", w), ("u", u)):
        if x.dtype != torch.float32:
            raise ValueError(f"wkv: {name} must be float32, got {x.dtype}")
    for name, x in (("r", r), ("k", k), ("v", v), ("w", w), ("u", u)):
        if x.device.type != "cuda" or x.device != r.device:
            raise ValueError(f"wkv: {name} must be a CUDA tensor on r's "
                             f"device, got {x.device}")
        if not x.is_contiguous():
            raise ValueError(f"wkv: {name} must be contiguous")
        if r.dtype == torch.bfloat16 and name != "u" and x.data_ptr() % 16:
            raise ValueError(f"wkv: {name} must start on a 16-byte boundary")
    kernel = KERNEL[r.dtype]
    y = torch.empty_like(r)
    state = torch.empty((B, H, hd, hd), dtype=torch.float32, device=r.device)
    _build.launch(LIB, kernel, r.device, r.data_ptr(), k.data_ptr(),
                  v.data_ptr(), w.data_ptr(), u.data_ptr(), y.data_ptr(),
                  state.data_ptr(), B, S, H, hd)
    kernels.LAUNCHES[kernel] += 1
    return y, state
