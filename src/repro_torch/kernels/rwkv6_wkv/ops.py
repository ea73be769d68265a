"""WKV dispatcher: a CUDA tensor goes through the Hopper kernel
(``rwkv6_wkv.wkv_cuda``), a CPU tensor through the plain chunked version
(``ref.wkv_chunked``). The choice follows the tensor's device and
nothing else: there is no fallback from one to the other. Both return the
final state, which the prefill hands to the decode."""
from __future__ import annotations

import torch

from repro_torch.kernels.rwkv6_wkv import rwkv6_wkv
from repro_torch.kernels.rwkv6_wkv.ref import wkv_chunked


def wkv(r, k, v, w, u):
    """r,k,v: [B,S,H,hd] (one dtype), w: f32[B,S,H,hd], u: f32[H,hd].
    Returns (y [B,S,H,hd] in r's dtype, final state f32[B,H,hd,hd])."""
    if r.device.type == "cpu":
        return wkv_chunked(r, k, v, w, u)
    return rwkv6_wkv.wkv_cuda(*(x.contiguous() for x in (r, k, v, w, u)))


def wkv_decode_step(r1, k1, v1, w1, u, state):
    """Single-token recurrence for serving. r1..w1: [B,H,hd]; state:
    [B,H,hd,hd]. Returns (y f32[B,H,hd], new_state)."""
    r1, k1, v1, w1 = (x.float() for x in (r1, k1, v1, w1))
    kv = k1[..., :, None] * v1[..., None, :]
    att = state + u[None, :, :, None].float() * kv
    y = torch.einsum("bhi,bhij->bhj", r1, att)
    return y, w1[..., :, None] * state + kv
