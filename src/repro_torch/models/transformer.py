"""Decoder-only transformer LM, dense GQA layout, with a KV-cache serving
path; the port of ``repro.models.transformer`` for ``n_experts == 0``
(every block is one dense layer). The MoE layouts wait for a later slice.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.models import attention as attn
from repro_torch.models import common as C
from repro_torch.models import mlp
from repro_torch.models.common import ArchConfig, param, unported


def n_blocks(cfg: ArchConfig) -> int:
    if cfg.n_experts > 0:
        raise unported(f"the MoE transformer ({cfg.name})")
    return cfg.n_layers


def init(gen, cfg: ArchConfig, device):
    """{"blocks": {"layers": [layer]}, "embed": ...}, every leaf of the
    layer stacked over the n_layers blocks, as the JAX package's tree."""
    nb, pd = n_blocks(cfg), cfg.param_dtype
    layer = {
        "ln1": param(gen, (cfg.d_model,), pd, device, init="zeros", stack=nb),
        "ln2": param(gen, (cfg.d_model,), pd, device, init="zeros", stack=nb),
        "attn": attn.init(gen, cfg, device, stack=nb),
        "mlp": mlp.init_dense(gen, cfg, device, stack=nb),
    }
    return {"blocks": {"layers": [layer]},
            "embed": C.embed_init(gen, cfg, device)}


def _blocks(params, cfg: ArchConfig):
    """The dense layer of each block, in order."""
    stacked = params["blocks"]["layers"][0]
    return [C.layer(stacked, i) for i in range(n_blocks(cfg))]


def forward(params, tokens, cfg: ArchConfig) -> torch.Tensor:
    """tokens: i64[B, S] -> logits f32[B, S, V]."""
    x = C.embed_tokens(params["embed"], tokens, cfg)
    for lp in _blocks(params, cfg):
        x = x + attn.forward_train(lp["attn"], C.rmsnorm(x, lp["ln1"]), cfg)
        x = x + mlp.forward_dense(lp["mlp"], C.rmsnorm(x, lp["ln2"]), cfg)
    return C.lm_head(params["embed"], x, cfg)


# ---------------------------------------------------------------------------
# Serving.
# ---------------------------------------------------------------------------
class DecodeState(NamedTuple):
    caches: Any          # [KVCache] of leaves [n_blocks, B, max_len, KV, hd]
    pos: int             # next position


def init_cache(cfg: ArchConfig, batch: int, max_len: int, device) -> Any:
    c = attn.init_cache(cfg, batch, max_len, device)
    nb = n_blocks(cfg)
    return [attn.KVCache(*(z.expand((nb,) + z.shape).clone() for z in c))]


def _stack(caches):
    return [attn.KVCache(torch.stack([c.k for c in caches]),
                         torch.stack([c.v for c in caches]))]


def prefill(params, tokens, cfg: ArchConfig, max_len: int):
    """Returns (last-position logits f32[B, V], DecodeState)."""
    x = C.embed_tokens(params["embed"], tokens, cfg)
    caches = []
    for lp in _blocks(params, cfg):
        a, cache = attn.forward_prefill(lp["attn"], C.rmsnorm(x, lp["ln1"]),
                                        cfg, max_len)
        x = x + a
        x = x + mlp.forward_dense(lp["mlp"], C.rmsnorm(x, lp["ln2"]), cfg)
        caches.append(cache)
    logits = C.lm_head(params["embed"], x[:, -1:], cfg)[:, 0]
    return logits, DecodeState(_stack(caches), tokens.shape[1])


def decode_step(params, token, state: DecodeState, cfg: ArchConfig):
    """token: i64[B] -> (logits f32[B, V], new DecodeState)."""
    x = C.embed_tokens(params["embed"], token[:, None], cfg)
    caches = []
    for i, lp in enumerate(_blocks(params, cfg)):
        cache = C.layer(state.caches[0], i)
        a, cache = attn.forward_decode(lp["attn"], C.rmsnorm(x, lp["ln1"]),
                                       cache, state.pos, cfg)
        x = x + a
        x = x + mlp.forward_dense(lp["mlp"], C.rmsnorm(x, lp["ln2"]), cfg)
        caches.append(cache)
    logits = C.lm_head(params["embed"], x, cfg)[:, 0]
    return logits, DecodeState(_stack(caches), state.pos + 1)
