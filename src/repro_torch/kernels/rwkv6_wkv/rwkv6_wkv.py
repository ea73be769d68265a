"""Hopper WKV recurrence with its final state: build, bind, launch.

``csrc/wkv.cu`` replaces the Pallas TPU kernel ``wkv_pallas``
(``repro/kernels/rwkv6_wkv/rwkv6_wkv.py``) and also writes the final
state, which that kernel drops. ``kernels._build`` compiles it for
``sm_90a`` at first use and binds it with ``ctypes``. The wrapper takes
CUDA tensors only; the CPU path is ``ref.wkv_chunked``, chosen by
``ops.wkv`` from the tensor's device.
"""
from __future__ import annotations

import pathlib

import torch

from repro_torch import kernels
from repro_torch.kernels import _build
from repro_torch.kernels._build import I as _I, P as _P

LIB = _build.Library(pathlib.Path(__file__).parent, {
    "wkv": [_P, _P, _P, _P, _P, _P, _P,     # r, k, v, w, u, y, state
            _I, _I, _I, _I, _I,             # B, S, H, hd, bf16
            _P],                            # stream
})
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HDS = (8, 16, 32, 64)


def wkv_cuda(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             w: torch.Tensor, u: torch.Tensor):
    """Launch the WKV kernel on the current stream.

    Args:
      r, k, v: [B, S, H, hd], one dtype (float32 or bfloat16); w:
        f32[B, S, H, hd] decays in (0, 1]; u: f32[H, hd] bonus. All
        contiguous, on one CUDA device; hd in (8, 16, 32, 64).
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
    if r.dtype not in DTYPES or k.dtype != r.dtype or v.dtype != r.dtype:
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
    y = torch.empty_like(r)
    state = torch.empty((B, H, hd, hd), dtype=torch.float32, device=r.device)
    _build.launch(LIB, "wkv", r.device, r.data_ptr(), k.data_ptr(),
                  v.data_ptr(), w.data_ptr(), u.data_ptr(), y.data_ptr(),
                  state.data_ptr(), B, S, H, hd, DTYPES[r.dtype])
    kernels.LAUNCHES["wkv"] += 1
    return y, state
