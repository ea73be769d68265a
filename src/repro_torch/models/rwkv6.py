"""RWKV6 "Finch" (arXiv:2404.05892): attention-free LM with token-shift
time-mix, data-dependent decay (LoRA-produced per-channel w_t), WKV linear
recurrence, and squared-ReLU channel-mix; the port of
``repro.models.rwkv6``.

``forward`` and ``prefill`` take y and the final WKV state from
``kernels.rwkv6_wkv.ops.wkv`` (the Hopper kernel on the card, the chunked
plain version on the CPU); serving carries the O(1) per-layer state (the
WKV state [H, hd, hd] and the two token-shift vectors).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as Fn

from repro_torch.kernels.rwkv6_wkv import ops as wkv_ops
from repro_torch.models import common as C
from repro_torch.models.common import ArchConfig, param

LORA_RANK = 64


def init(gen, cfg: ArchConfig, device):
    D, F, L, pd = cfg.d_model, cfg.d_ff, cfg.n_layers, cfg.param_dtype
    p = lambda shape, **kw: param(gen, shape, pd, device, stack=L, **kw)
    blocks = {
        "ln1": p((D,), init="zeros"),
        "ln2": p((D,), init="zeros"),
        "mu": p((5, D), scale=0.5),            # time-mix lerp (token shift)
        "wr": p((D, D)), "wk": p((D, D)), "wv": p((D, D)), "wg": p((D, D)),
        "wo": p((D, D)),
        # data-dependent decay: w_t = exp(-exp(w0 + tanh(x A) B))
        "w0": p((D,), init="zeros"),
        "wA": p((D, LORA_RANK)),
        "wB": p((LORA_RANK, D)),
        "u": p((D,), scale=0.3),
        "ln_x": p((D,), init="zeros"),
        "cm_mu": p((2, D), scale=0.5),          # channel mix
        "cm_k": p((D, F)), "cm_r": p((D, D)), "cm_v": p((F, D)),
    }
    return {"blocks": blocks, "embed": C.embed_init(gen, cfg, device)}


def _shift(x):
    """Token shift: previous token's features (zeros for step 0)."""
    return torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], dim=1)


def _decay(lp, xw, cfg):
    lora = torch.tanh(xw @ lp["wA"].to(cfg.dtype)) @ lp["wB"].to(cfg.dtype)
    return torch.exp(-torch.exp(lp["w0"].float() + lora.float()))  # in (0, 1)


def wkv_inputs(lp, x, cfg: ArchConfig):
    """The WKV operands of the normed input x [B,S,D]: (r, k, v
    [B,S,H,hd] in cfg.dtype, w f32[B,S,H,hd], u f32[H,hd], the output
    gate g [B,S,D])."""
    B, S = x.shape[:2]
    H, hd, dt = cfg.n_heads, cfg.hd, cfg.dtype
    sx = _shift(x)
    mu = lp["mu"].to(dt)
    xr, xk, xv, xw, xg = (x + mu[i] * (sx - x) for i in range(5))
    r = xr @ lp["wr"].to(dt)
    k = xk @ lp["wk"].to(dt)
    v = xv @ lp["wv"].to(dt)
    g = Fn.silu(xg @ lp["wg"].to(dt))
    w = _decay(lp, xw, cfg)
    heads = lambda z: z.reshape(B, S, H, hd)
    u = lp["u"].float().reshape(H, hd)
    return heads(r), heads(k), heads(v), heads(w), u, g


def _time_mix(lp, x, cfg: ArchConfig):
    """Time mix of the normed input x [B,S,D]; returns (out, final WKV
    state f32[B,H,hd,hd])."""
    B, S, D = x.shape
    r, k, v, w, u, g = wkv_inputs(lp, x, cfg)
    y, s_fin = wkv_ops.wkv(r, k, v, w, u)
    y = C.rmsnorm(y.reshape(B, S, D), lp["ln_x"])
    return (y * g).to(cfg.dtype) @ lp["wo"].to(cfg.dtype), s_fin


def _channel_mix(lp, x, cfg: ArchConfig):
    dt = cfg.dtype
    sx = _shift(x)
    mu = lp["cm_mu"].to(dt)
    xk = x + mu[0] * (sx - x)
    xr = x + mu[1] * (sx - x)
    k = torch.square(torch.relu(xk @ lp["cm_k"].to(dt)))
    r = torch.sigmoid(xr @ lp["cm_r"].to(dt))
    return r * (k @ lp["cm_v"].to(dt))


def forward(params, tokens, cfg: ArchConfig, **_) -> torch.Tensor:
    x = C.embed_tokens(params["embed"], tokens, cfg)
    for i in range(cfg.n_layers):
        lp = C.layer(params["blocks"], i)
        x = x + _time_mix(lp, C.rmsnorm(x, lp["ln1"]), cfg)[0]
        x = x + _channel_mix(lp, C.rmsnorm(x, lp["ln2"]), cfg)
    return C.lm_head(params["embed"], x, cfg)


# ---------------------------------------------------------------------------
# Serving: O(1) state per layer.
# ---------------------------------------------------------------------------
class RwkvState(NamedTuple):
    wkv: torch.Tensor      # [L, B, H, hd, hd]
    tm_prev: torch.Tensor  # [L, B, D] last token features (time mix)
    cm_prev: torch.Tensor  # [L, B, D] last token features (channel mix)
    pos: int


def init_cache(cfg: ArchConfig, batch: int, max_len: int = 0,
               device="cpu") -> RwkvState:
    L, B, D, H, hd = cfg.n_layers, batch, cfg.d_model, cfg.n_heads, cfg.hd
    return RwkvState(
        torch.zeros((L, B, H, hd, hd), device=device),
        torch.zeros((L, B, D), dtype=cfg.dtype, device=device),
        torch.zeros((L, B, D), dtype=cfg.dtype, device=device), 0)


def _layer_step(lp, x1, wkv_s, tm_prev, cm_prev, cfg: ArchConfig):
    """x1: [B, D] single token."""
    B, D = x1.shape
    H, hd, dt = cfg.n_heads, cfg.hd, cfg.dtype
    h = C.rmsnorm(x1, lp["ln1"])
    mu = lp["mu"].to(dt)
    xr, xk, xv, xw, xg = (h + mu[i] * (tm_prev - h) for i in range(5))
    r = (xr @ lp["wr"].to(dt)).reshape(B, H, hd)
    k = (xk @ lp["wk"].to(dt)).reshape(B, H, hd)
    v = (xv @ lp["wv"].to(dt)).reshape(B, H, hd)
    g = Fn.silu(xg @ lp["wg"].to(dt))
    lora = torch.tanh(xw @ lp["wA"].to(dt)) @ lp["wB"].to(dt)
    w = torch.exp(-torch.exp(lp["w0"].float() + lora.float())
                  ).reshape(B, H, hd)
    u = lp["u"].float().reshape(H, hd)
    y, wkv_new = wkv_ops.wkv_decode_step(r, k, v, w, u, wkv_s)
    y = C.rmsnorm(y.reshape(B, D), lp["ln_x"])
    x1 = x1 + ((y * g).to(dt) @ lp["wo"].to(dt))

    h2 = C.rmsnorm(x1, lp["ln2"])
    cmu = lp["cm_mu"].to(dt)
    xk2 = h2 + cmu[0] * (cm_prev - h2)
    xr2 = h2 + cmu[1] * (cm_prev - h2)
    kk = torch.square(torch.relu(xk2 @ lp["cm_k"].to(dt)))
    rr = torch.sigmoid(xr2 @ lp["cm_r"].to(dt))
    x1 = x1 + rr * (kk @ lp["cm_v"].to(dt))
    return x1, wkv_new, h, h2


def decode_step(params, token, state: RwkvState, cfg: ArchConfig):
    """token: i64[B] -> (logits f32[B, V], new state)."""
    x = C.embed_tokens(params["embed"], token[:, None], cfg)[:, 0]
    outs = []
    for i in range(cfg.n_layers):
        x, *new = _layer_step(C.layer(params["blocks"], i), x, state.wkv[i],
                              state.tm_prev[i], state.cm_prev[i], cfg)
        outs.append(new)
    wkv_s, tm, cm = (torch.stack(z) for z in zip(*outs))
    logits = C.lm_head(params["embed"], x[:, None], cfg)[:, 0]
    return logits, RwkvState(wkv_s, tm, cm, state.pos + 1)


def prefill(params, tokens, cfg: ArchConfig, max_len: int = 0):
    """Prefill through the WKV kernel, returning the decode state."""
    x = C.embed_tokens(params["embed"], tokens, cfg)
    outs = []
    for i in range(cfg.n_layers):
        lp = C.layer(params["blocks"], i)
        h = C.rmsnorm(x, lp["ln1"])
        a, s_fin = _time_mix(lp, h, cfg)
        x = x + a
        h2 = C.rmsnorm(x, lp["ln2"])
        x = x + _channel_mix(lp, h2, cfg)
        outs.append((s_fin, h[:, -1], h2[:, -1]))
    wkv_s, tm, cm = (torch.stack(z) for z in zip(*outs))
    logits = C.lm_head(params["embed"], x[:, -1:], cfg)[:, 0]
    return logits, RwkvState(wkv_s, tm, cm, tokens.shape[1])
