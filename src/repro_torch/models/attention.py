"""Grouped-query attention with RoPE, optional sliding window, optional
QKV bias (Qwen2.5), and a KV cache for serving; the port of
``repro.models.attention``.

The prefill's attention goes through ``kernels.flash_attention.ops.mha``:
the Hopper flash kernel for a CUDA tensor, its plain version for a CPU
one. Training-style forward and the one-token decode stay plain torch,
as the JAX package leaves them to XLA.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models import common as C
from repro_torch.models.common import ArchConfig, param


class KVCache(NamedTuple):
    k: torch.Tensor       # [B, Smax, KV, hd]
    v: torch.Tensor       # [B, Smax, KV, hd]


def init(gen, cfg: ArchConfig, device, stack: int = 0):
    """Weights use the *padded* head counts (cfg.h_pad / cfg.kv_pad); wo
    rows for padded heads are zeroed, so the padded model computes the
    spec model's function at init."""
    hd, H, KV, D = cfg.hd, cfg.h_pad, cfg.kv_pad, cfg.d_model
    pd = cfg.param_dtype
    p = {
        "wq": param(gen, (D, H, hd), pd, device, stack=stack),
        "wk": param(gen, (D, KV, hd), pd, device, stack=stack),
        "wv": param(gen, (D, KV, hd), pd, device, stack=stack),
        "wo": param(gen, (H, hd, D), pd, device, stack=stack),
    }
    if H > cfg.n_heads and p["wo"].device.type != "meta":
        p["wo"][..., cfg.n_heads:, :, :] = 0.0
    if cfg.qkv_bias:
        p["bq"] = param(gen, (H, hd), pd, device, init="zeros", stack=stack)
        p["bk"] = param(gen, (KV, hd), pd, device, init="zeros", stack=stack)
        p["bv"] = param(gen, (KV, hd), pd, device, init="zeros", stack=stack)
    return p


def _proj(x, w, cfg: ArchConfig):
    """x [B,S,D] @ w [D,H,hd] -> [B,S,H,hd] in the compute dtype."""
    D, H, hd = w.shape
    return (x @ w.to(cfg.dtype).reshape(D, H * hd)).reshape(
        *x.shape[:-1], H, hd)


def _out(o, wo, cfg: ArchConfig):
    """o [B,S,H,hd] @ wo [H,hd,D] -> [B,S,D]."""
    H, hd, D = wo.shape
    return o.reshape(*o.shape[:-2], H * hd) @ \
        wo.to(cfg.dtype).reshape(H * hd, D)


def _qkv(p, x, cfg: ArchConfig, positions):
    q = _proj(x, p["wq"], cfg)
    k = _proj(x, p["wk"], cfg)
    v = _proj(x, p["wv"], cfg)
    if "bq" in p:
        q = q + p["bq"].to(cfg.dtype)
        k = k + p["bk"].to(cfg.dtype)
        v = v + p["bv"].to(cfg.dtype)
    q = C.apply_rope(q, positions, cfg.rope_theta)
    k = C.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _sdpa(q, k, v, mask, cfg: ArchConfig):
    """q: [B,S,H,hd]; k/v: [B,T,KV,hd]; mask broadcastable to [B,H,S,T].
    Head h reads kv head h // G (G = the spec model's group)."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    g = cfg.group
    if g == 1 and KV == H:
        kh, vh = k, v
    else:
        head_kv = torch.arange(H, device=q.device) // g
        kh = k.index_select(2, head_kv)
        vh = v.index_select(2, head_kv)
    logits = torch.einsum("bshd,bthd->bhst", q, kh).float()
    logits = logits / math.sqrt(hd)
    m = mask
    while m.ndim > 4:
        m = m.squeeze(1)
    logits = logits.masked_fill(~m, -1e30)
    w = torch.softmax(logits, dim=-1).to(cfg.dtype)
    return torch.einsum("bhst,bthd->bshd", w, vh)


def causal_mask(S: int, T: int, window: int = 0, device=None):
    """[S, T] bool; query i attends key j iff j <= i (and within the
    sliding window when window > 0)."""
    qi = torch.arange(S, device=device)[:, None]
    kj = torch.arange(T, device=device)[None, :]
    m = kj <= qi
    if window > 0:
        m &= kj > (qi - window)
    return m


def forward_train(p, x, cfg: ArchConfig):
    B, S, D = x.shape
    positions = torch.arange(S, device=x.device)[None, :]
    q, k, v = _qkv(p, x, cfg, positions)
    mask = causal_mask(S, S, cfg.sliding_window, device=x.device)
    return _out(_sdpa(q, k, v, mask[None, None], cfg), p["wo"], cfg)


# ---------------------------------------------------------------------------
# Serving path.
# ---------------------------------------------------------------------------
def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               device) -> KVCache:
    shape = (batch, max_len, cfg.kv_pad, cfg.hd)
    return KVCache(torch.zeros(shape, dtype=cfg.dtype, device=device),
                   torch.zeros(shape, dtype=cfg.dtype, device=device))


def forward_prefill(p, x, cfg: ArchConfig, max_len: int):
    """Prefill S tokens; returns (out, cache padded to max_len). The
    attention is the flash kernel on the card."""
    B, S, D = x.shape
    positions = torch.arange(S, device=x.device)[None, :]
    q, k, v = _qkv(p, x, cfg, positions)
    out = fa_ops.mha(q, k, v, causal=True, window=cfg.sliding_window)
    pad = (0, 0, 0, 0, 0, max_len - S)
    cache = KVCache(torch.nn.functional.pad(k, pad),
                    torch.nn.functional.pad(v, pad))
    return _out(out, p["wo"], cfg), cache


def forward_decode(p, x, cache: KVCache, pos: int, cfg: ArchConfig):
    """One-token decode. x: [B, 1, D]; pos: the current position (the same
    for the whole batch). Returns (out, new_cache); the cache passed in is
    not modified."""
    B = x.shape[0]
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q, k, v = _qkv(p, x, cfg, positions)
    k_cache, v_cache = cache.k.clone(), cache.v.clone()
    k_cache[:, pos:pos + 1] = k
    v_cache[:, pos:pos + 1] = v
    T = k_cache.shape[1]
    kj = torch.arange(T, device=x.device)[None, :]
    m = kj <= pos
    if cfg.sliding_window > 0:
        m &= kj > (pos - cfg.sliding_window)
    out = _sdpa(q, k_cache, v_cache, m[:, None, None, :], cfg)
    return _out(out, p["wo"], cfg), KVCache(k_cache, v_cache)
