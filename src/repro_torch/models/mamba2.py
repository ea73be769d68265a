"""Mamba2 (SSD) blocks and the Zamba2 hybrid (arXiv:2411.15242): a Mamba2
backbone with a *shared* transformer block invoked every
``shared_attn_every`` SSM layers; the port of ``repro.models.mamba2``.

SSD recurrence per head (state S in R^{P x N}, scalar decay a_t per head):
    S_t = a_t S_{t-1} + (dt_t x_t) (x) B_t
    y_t = S_t C_t + D x_t
``forward`` and ``prefill`` run it through ``kernels.mamba2_ssd.ops.ssd``
(the Hopper kernel on the card, the chunked plain version on the CPU),
and the shared block's prefill attention through the flash kernel. The
layers keep the JAX package's group/tail layout: ``n_layers //
shared_attn_every`` groups of SSM layers, each followed by the shared
block, then the remaining tail of SSM layers.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch
import torch.nn.functional as Fn

from repro_torch.kernels.mamba2_ssd import ops as ssd_ops
from repro_torch.models import attention as attn
from repro_torch.models import common as C
from repro_torch.models import mlp
from repro_torch.models.common import ArchConfig, param

P_HEAD = 64  # mamba2 head dim


def _dims(cfg: ArchConfig):
    d_inner = 2 * cfg.d_model
    return d_inner, d_inner // P_HEAD, cfg.ssm_state


def _groups(cfg: ArchConfig):
    """(n_groups, every, tail): the shared block follows layers
    every-1, 2*every-1, ...; the last ``tail`` layers have none."""
    every = max(cfg.shared_attn_every, 1)
    n_groups, tail = divmod(cfg.n_layers, every)
    return n_groups, every, tail


def init(gen, cfg: ArchConfig, device):
    D, L, pd = cfg.d_model, cfg.n_layers, cfg.param_dtype
    d_inner, H, N = _dims(cfg)
    conv_ch = d_inner + 2 * N
    p = lambda shape, **kw: param(gen, shape, pd, device, stack=L, **kw)
    blocks = {
        "ln": p((D,), init="zeros"),
        # fused input projection: [z, x, B, C, dt]
        "in_proj": p((D, 2 * d_inner + 2 * N + H)),
        "conv_w": p((cfg.conv_kernel, conv_ch), scale=0.5),
        "conv_b": p((conv_ch,), init="zeros"),
        "A_log": p((H,), init="zeros"),
        "dt_bias": p((H,), init="zeros"),
        "D": p((H,), init="ones"),
        "out_proj": p((d_inner, D)),
    }
    shared = {
        "ln1": param(gen, (D,), pd, device, init="zeros"),
        "ln2": param(gen, (D,), pd, device, init="zeros"),
        "attn": attn.init(gen, cfg, device),
        "mlp": mlp.init_dense(gen, cfg, device),
    }
    return {"blocks": blocks, "shared": shared,
            "embed": C.embed_init(gen, cfg, device)}


# ---------------------------------------------------------------------------
# Mamba2 layer.
# ---------------------------------------------------------------------------
def _split_proj(zxbcdt, cfg: ArchConfig):
    d_inner, H, N = _dims(cfg)
    return torch.split(zxbcdt, [d_inner, d_inner, N, N, H], dim=-1)


def _causal_conv(x, w, b, cfg: ArchConfig):
    """Depthwise causal conv over time. x: [B,S,C]; w: [K,C]."""
    K, S = w.shape[0], x.shape[1]
    xp = Fn.pad(x, (0, 0, K - 1, 0))
    out = sum(xp[:, i:i + S, :] * w[i][None, None, :] for i in range(K))
    return Fn.silu(out + b[None, None, :])


def _ssm_layer_with_state(lp, xres, cfg: ArchConfig):
    """One Mamba2 layer over S tokens: (out, ssd_state, conv_state)."""
    Bsz, S, D = xres.shape
    d_inner, H, N = _dims(cfg)
    dt_ = cfg.dtype
    h = C.rmsnorm(xres, lp["ln"])
    z, x, Bc, Cc, dt = _split_proj(h @ lp["in_proj"].to(dt_), cfg)
    xbc_raw = torch.cat([x, Bc, Cc], dim=-1)
    # the last K-1 inputs; a shorter prompt is preceded by zeros, as an
    # empty history is in the decode
    conv_state = Fn.pad(xbc_raw[:, -(cfg.conv_kernel - 1):, :],
                        (0, 0, max(cfg.conv_kernel - 1 - S, 0), 0))
    xbc = _causal_conv(xbc_raw, lp["conv_w"].to(dt_), lp["conv_b"].to(dt_),
                       cfg)
    x, Bc, Cc = torch.split(xbc, [d_inner, N, N], dim=-1)
    dt = Fn.softplus(dt.float() + lp["dt_bias"].float())       # [B,S,H]
    a = torch.exp(-torch.exp(lp["A_log"].float()) * dt)        # decay/head
    xh = x.reshape(Bsz, S, H, P_HEAD)
    y, ssd_state = ssd_ops.ssd(xh, dt, a, Bc, Cc)
    y = y + lp["D"].float()[None, None, :, None] * xh.float()
    y = y.reshape(Bsz, S, d_inner).to(dt_) * Fn.silu(z)
    out = xres + y @ lp["out_proj"].to(dt_)
    return out, ssd_state, conv_state


def _ssm_layer(lp, xres, cfg: ArchConfig):
    return _ssm_layer_with_state(lp, xres, cfg)[0]


def _shared_block(sp, x, cfg: ArchConfig):
    h = C.rmsnorm(x, sp["ln1"])
    x = x + attn.forward_train(sp["attn"], h, cfg)
    h = C.rmsnorm(x, sp["ln2"])
    return x + mlp.forward_dense(sp["mlp"], h, cfg)


def forward(params, tokens, cfg: ArchConfig, **_) -> torch.Tensor:
    x = C.embed_tokens(params["embed"], tokens, cfg)
    n_groups, every, _ = _groups(cfg)
    for i in range(cfg.n_layers):
        x = _ssm_layer(C.layer(params["blocks"], i), x, cfg)
        if i < n_groups * every and i % every == every - 1:
            x = _shared_block(params["shared"], x, cfg)
    return C.lm_head(params["embed"], x, cfg)


# ---------------------------------------------------------------------------
# Serving.
# ---------------------------------------------------------------------------
class MambaState(NamedTuple):
    ssd: torch.Tensor       # [L, B, H, P, N]
    conv: torch.Tensor      # [L, B, K-1, conv_ch]
    shared_caches: Any      # KVCache of leaves [n_shared, B, max_len, KV, hd]
    pos: int


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               device="cpu") -> MambaState:
    d_inner, H, N = _dims(cfg)
    L = cfg.n_layers
    n_shared = _groups(cfg)[0]
    kv = attn.init_cache(cfg, batch, max_len, device)
    shared = attn.KVCache(*(z.expand((n_shared,) + z.shape).clone()
                            for z in kv))
    return MambaState(
        torch.zeros((L, batch, H, P_HEAD, N), device=device),
        torch.zeros((L, batch, cfg.conv_kernel - 1, d_inner + 2 * N),
                    dtype=cfg.dtype, device=device),
        shared, 0)


def _ssm_step(lp, x1, ssd_s, conv_s, cfg: ArchConfig):
    """Single-token step. x1: [B, D]."""
    Bsz, D = x1.shape
    d_inner, H, N = _dims(cfg)
    dt_ = cfg.dtype
    h = C.rmsnorm(x1, lp["ln"])
    z, x, Bc, Cc, dt = _split_proj(h @ lp["in_proj"].to(dt_), cfg)
    xbc = torch.cat([x, Bc, Cc], dim=-1)                        # [B, conv_ch]
    hist = torch.cat([conv_s, xbc[:, None, :]], dim=1)          # [B, K, ch]
    out = torch.einsum("bkc,kc->bc", hist, lp["conv_w"].to(dt_)) + \
        lp["conv_b"].to(dt_)
    x, Bc, Cc = torch.split(Fn.silu(out), [d_inner, N, N], dim=-1)
    dt = Fn.softplus(dt.float() + lp["dt_bias"].float())        # [B,H]
    a = torch.exp(-torch.exp(lp["A_log"].float()) * dt)
    xh = x.reshape(Bsz, H, P_HEAD).float()
    dbx = dt[..., None] * xh                                    # [B,H,P]
    ssd_new = a[..., None, None] * ssd_s + \
        dbx[..., :, None] * Bc.float()[:, None, None, :]
    y = torch.einsum("bhpn,bn->bhp", ssd_new, Cc.float())
    y = y + lp["D"].float()[None, :, None] * xh
    y = y.reshape(Bsz, d_inner).to(dt_) * Fn.silu(z)
    return x1 + y @ lp["out_proj"].to(dt_), ssd_new, hist[:, 1:, :]


def _shared_prefill(sp, x, cfg: ArchConfig, max_len: int):
    h = C.rmsnorm(x, sp["ln1"])
    a, cache = attn.forward_prefill(sp["attn"], h, cfg, max_len)
    x = x + a
    return x + mlp.forward_dense(sp["mlp"], C.rmsnorm(x, sp["ln2"]), cfg), \
        cache


def prefill(params, tokens, cfg: ArchConfig, max_len: int):
    """Prefill S tokens, returning (last logits, MambaState)."""
    x = C.embed_tokens(params["embed"], tokens, cfg)
    n_groups, every, _ = _groups(cfg)
    ssd_s, conv_s, caches = [], [], []
    for i in range(cfg.n_layers):
        x, s, c = _ssm_layer_with_state(C.layer(params["blocks"], i), x, cfg)
        ssd_s.append(s)
        conv_s.append(c)
        if i < n_groups * every and i % every == every - 1:
            x, cache = _shared_prefill(params["shared"], x, cfg, max_len)
            caches.append(cache)
    logits = C.lm_head(params["embed"], x[:, -1:], cfg)[:, 0]
    shared = attn.KVCache(*(torch.stack(z) for z in zip(*caches)))
    return logits, MambaState(torch.stack(ssd_s), torch.stack(conv_s),
                              shared, tokens.shape[1])


def decode_step(params, token, state: MambaState, cfg: ArchConfig):
    x = C.embed_tokens(params["embed"], token[:, None], cfg)[:, 0]
    n_groups, every, _ = _groups(cfg)
    sp = params["shared"]
    ssd_s, conv_s, caches = [], [], []
    for i in range(cfg.n_layers):
        x, s, c = _ssm_step(C.layer(params["blocks"], i), x, state.ssd[i],
                            state.conv[i], cfg)
        ssd_s.append(s)
        conv_s.append(c)
        if i < n_groups * every and i % every == every - 1:
            g = i // every
            h = C.rmsnorm(x, sp["ln1"])
            a, cache = attn.forward_decode(
                sp["attn"], h[:, None, :], C.layer(state.shared_caches, g),
                state.pos, cfg)
            x = x + a[:, 0]
            h = C.rmsnorm(x, sp["ln2"])
            x = x + mlp.forward_dense(sp["mlp"], h[:, None, :], cfg)[:, 0]
            caches.append(cache)
    logits = C.lm_head(params["embed"], x[:, None], cfg)[:, 0]
    shared = attn.KVCache(*(torch.stack(z) for z in zip(*caches)))
    return logits, MambaState(torch.stack(ssd_s), torch.stack(conv_s),
                              shared, state.pos + 1)
