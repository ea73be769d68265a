"""Decoder-only transformer LM (dense GQA and MoE variants) with a
KV-cache serving path; the port of ``repro.models.transformer``.

Layers are stacked into *blocks*, as in the JAX package:
  - dense archs: block = 1 dense layer
  - mixtral: block = 1 MoE layer
  - llama4 (interleaved): block = ``moe_every`` layers, the last one MoE.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.models import attention as attn
from repro_torch.models import common as C
from repro_torch.models import mlp
from repro_torch.models.common import ArchConfig, param


# ---------------------------------------------------------------------------
# Block = smallest repeating unit.
# ---------------------------------------------------------------------------
def _block_layout(cfg: ArchConfig) -> list[str]:
    """Kinds of the layers inside one block: 'dense' | 'moe'."""
    if cfg.n_experts == 0:
        return ["dense"]
    if cfg.moe_every == 1:
        return ["moe"]
    return ["dense"] * (cfg.moe_every - 1) + ["moe"]


def n_blocks(cfg: ArchConfig) -> int:
    per = len(_block_layout(cfg))
    if cfg.n_layers % per:
        raise ValueError(f"{cfg.name}: {cfg.n_layers} layers are not whole "
                         f"blocks of {per}")
    return cfg.n_layers // per


def init(gen, cfg: ArchConfig, device):
    """{"blocks": {"layers": [layer, ...]}, "embed": ...}: one layer per
    entry of the block layout, every leaf stacked over the blocks, as the
    JAX package's tree."""
    nb, pd = n_blocks(cfg), cfg.param_dtype
    layers = []
    for kind in _block_layout(cfg):
        init_mlp = mlp.init_moe if kind == "moe" else mlp.init_dense
        layers.append({
            "ln1": param(gen, (cfg.d_model,), pd, device, init="zeros",
                         stack=nb),
            "ln2": param(gen, (cfg.d_model,), pd, device, init="zeros",
                         stack=nb),
            "attn": attn.init(gen, cfg, device, stack=nb),
            "mlp": init_mlp(gen, cfg, device, stack=nb),
        })
    return {"blocks": {"layers": layers},
            "embed": C.embed_init(gen, cfg, device)}


def _layers(params, cfg: ArchConfig):
    """(kind, parameters) of every layer, in order: block by block, and
    within a block by the layout; with its (block, index in block)."""
    stacked = params["blocks"]["layers"]
    for b in range(n_blocks(cfg)):
        for i, kind in enumerate(_block_layout(cfg)):
            yield (b, i), kind, C.layer(stacked[i], b)


def _ffn(kind, lp, x, cfg: ArchConfig):
    """x plus the layer's feed-forward (dense or MoE) of rmsnorm(x)."""
    h = C.rmsnorm(x, lp["ln2"])
    if kind == "moe":
        return x + mlp.forward_moe(lp["mlp"], h, cfg)
    return x + mlp.forward_dense(lp["mlp"], h, cfg)


def forward(params, tokens, cfg: ArchConfig) -> torch.Tensor:
    """tokens: i64[B, S] -> logits f32[B, S, V]."""
    x = C.embed_tokens(params["embed"], tokens, cfg)
    for _, kind, lp in _layers(params, cfg):
        x = x + attn.forward_train(lp["attn"], C.rmsnorm(x, lp["ln1"]), cfg)
        x = _ffn(kind, lp, x, cfg)
    return C.lm_head(params["embed"], x, cfg)


# ---------------------------------------------------------------------------
# Serving.
# ---------------------------------------------------------------------------
class DecodeState(NamedTuple):
    caches: Any          # [KVCache] per layer of a block, [n_blocks, ...]
    pos: int             # next position


def init_cache(cfg: ArchConfig, batch: int, max_len: int, device) -> Any:
    nb = n_blocks(cfg)
    out = []
    for _ in _block_layout(cfg):
        c = attn.init_cache(cfg, batch, max_len, device)
        out.append(attn.KVCache(*(z.expand((nb,) + z.shape).clone()
                                  for z in c)))
    return out


def _stack(caches, cfg: ArchConfig):
    """Per-layer caches (in ``_layers`` order) -> one KVCache per layer of
    a block, stacked over the blocks."""
    per = len(_block_layout(cfg))
    return [attn.KVCache(torch.stack([c.k for c in caches[i::per]]),
                         torch.stack([c.v for c in caches[i::per]]))
            for i in range(per)]


def prefill(params, tokens, cfg: ArchConfig, max_len: int):
    """Returns (last-position logits f32[B, V], DecodeState)."""
    x = C.embed_tokens(params["embed"], tokens, cfg)
    caches = []
    for _, kind, lp in _layers(params, cfg):
        a, cache = attn.forward_prefill(lp["attn"], C.rmsnorm(x, lp["ln1"]),
                                        cfg, max_len)
        x = _ffn(kind, lp, x + a, cfg)
        caches.append(cache)
    logits = C.lm_head(params["embed"], x[:, -1:], cfg)[:, 0]
    return logits, DecodeState(_stack(caches, cfg), tokens.shape[1])


def decode_step(params, token, state: DecodeState, cfg: ArchConfig):
    """token: i64[B] -> (logits f32[B, V], new DecodeState)."""
    x = C.embed_tokens(params["embed"], token[:, None], cfg)
    caches = []
    for (b, i), kind, lp in _layers(params, cfg):
        cache = C.layer(state.caches[i], b)
        a, cache = attn.forward_decode(lp["attn"], C.rmsnorm(x, lp["ln1"]),
                                       cache, state.pos, cfg)
        x = _ffn(kind, lp, x + a, cfg)
        caches.append(cache)
    logits = C.lm_head(params["embed"], x, cfg)[:, 0]
    return logits, DecodeState(_stack(caches, cfg), state.pos + 1)
