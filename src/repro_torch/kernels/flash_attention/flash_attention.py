"""Hopper flash-attention forward: build, bind, launch.

Two kernels replace the Pallas TPU kernel ``flash_attention``
(``repro/kernels/flash_attention/flash_attention.py``), one per dtype:
``csrc/flash_attention_tc.cu`` takes bfloat16 (the serving path) on the
tensor cores, for hd a multiple of 16 up to 128; ``csrc/flash_attention.cu``
takes float32 with float32 FMAs, for any hd <= 128. ``kernels._build``
compiles each for ``sm_90a`` at first use and binds it with ``ctypes``.
The wrapper takes CUDA tensors only; the CPU path is ``ref.mha_ref``,
chosen by ``ops.mha`` from the tensor's device.
"""
from __future__ import annotations

import math
import pathlib

import torch

from repro_torch import kernels
from repro_torch.kernels import _build
from repro_torch.kernels._build import F as _F, I as _I, P as _P

_ARGS = [_P, _P, _P, _P,                    # q, k, v, out
         _I, _I, _I, _I, _I, _I, _I,        # B, S, T, H, KV, hd, group
         _I, _I, _F,                        # causal, window, scale
         _P]                                # stream
LIB = _build.Library(pathlib.Path(__file__).parent, {
    "flash_attention": _ARGS,               # float32, CUDA cores
    "flash_attention_tc": _ARGS,            # bfloat16, tensor cores
})
KERNEL = {torch.float32: "flash_attention",
          torch.bfloat16: "flash_attention_tc"}
HD_MAX = 128
TC_HD_STEP = 16                             # mma k-step: bf16 hd % 16 == 0


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True, window: int = 0
                         ) -> torch.Tensor:
    """Launch the flash kernel on the current stream.

    Args:
      q: [B, S, H, hd]; k, v: [B, T, KV, hd]; one dtype, contiguous, on
        one CUDA device; hd <= 128. float32 takes any hd (the CUDA-core
        kernel); bfloat16 takes hd % 16 == 0 and 16-byte aligned tensors
        (the tensor-core kernel).
      causal, window: the masks of ``ref.mha_ref`` (queries right-aligned
        when S != T; window 0 = none). H is a multiple of KV: head h
        reads kv head h // (H / KV).
    Returns:
      a new [B, S, H, hd] tensor in q's dtype.
    """
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError(f"flash_attention: q, k, v must be 4-d [B, S, H, "
                         f"hd], got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    if tuple(k.shape) != (B, T, KV, hd) or tuple(v.shape) != (B, T, KV, hd):
        raise ValueError(f"flash_attention: k and v must have shape "
                         f"[{B}, T, KV, {hd}] alike, got {tuple(k.shape)} "
                         f"and {tuple(v.shape)}")
    if min(B, S, T, H, KV) < 1 or not 1 <= hd <= HD_MAX or H % KV:
        raise ValueError(f"flash_attention: unsupported shape B={B} S={S} "
                         f"T={T} H={H} KV={KV} hd={hd} (hd <= {HD_MAX}, H "
                         f"a multiple of KV)")
    if q.dtype not in KERNEL or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: q, k, v must all be float32 or "
                         f"bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    name = KERNEL[q.dtype]
    if name == "flash_attention_tc" and hd % TC_HD_STEP:
        raise ValueError(f"flash_attention: bfloat16 needs hd a multiple of "
                         f"{TC_HD_STEP} (the tensor cores' k-step), got "
                         f"hd={hd}")
    for label, x in (("q", q), ("k", k), ("v", v)):
        if x.device.type != "cuda" or x.device != q.device:
            raise ValueError(f"flash_attention: {label} must be a CUDA "
                             f"tensor on q's device, got {x.device}")
        if not x.is_contiguous():
            raise ValueError(f"flash_attention: {label} must be contiguous")
        if name == "flash_attention_tc" and x.data_ptr() % 16:
            raise ValueError(f"flash_attention: {label} must start on a "
                             f"16-byte boundary")
    out = torch.empty_like(q)
    _build.launch(LIB, name, q.device,
                  q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  B, S, T, H, KV, hd, H // KV, int(causal), int(window),
                  1.0 / math.sqrt(hd))
    kernels.LAUNCHES[name] += 1
    return out
