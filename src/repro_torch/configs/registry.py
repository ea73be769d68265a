"""The 10 assigned architectures + shape grid + reduced smoke variants:
the port's own copy of ``repro.configs.registry`` (same values, torch
dtypes in place of ``jnp`` ones; a test holds the two equal).

Sources are tagged in each config comment; vocabs are padded minimally
where the JAX package needed clean sharding (noted inline).
"""
from __future__ import annotations

from dataclasses import replace
from typing import Dict, Tuple

import torch

from repro_torch.models.common import ArchConfig

# ---------------------------------------------------------------------------
# Shapes (assignment): name -> (seq_len, global_batch, kind)
#   kind: train | prefill | decode | long_decode
# ---------------------------------------------------------------------------
SHAPES: Dict[str, Tuple[int, int, str]] = {
    "train_4k": (4096, 256, "train"),
    "prefill_32k": (32768, 32, "prefill"),
    "decode_32k": (32768, 128, "decode"),
    "long_500k": (524288, 1, "long_decode"),
}

# ---------------------------------------------------------------------------
# Architectures.
# ---------------------------------------------------------------------------
ARCHS: Dict[str, ArchConfig] = {}


def _reg(cfg: ArchConfig) -> ArchConfig:
    ARCHS[cfg.name] = cfg
    return cfg


# [ssm] Finch — data-dependent decay [arXiv:2404.05892; hf]
RWKV6_7B = _reg(ArchConfig(
    name="rwkv6-7b", family="ssm", n_layers=32, d_model=4096,
    n_heads=64, n_kv_heads=64, head_dim=64, d_ff=14336, vocab=65536,
))

# [dense] 128k ctx [hf:mistralai/Mistral-Nemo-Base-2407]
MISTRAL_NEMO_12B = _reg(ArchConfig(
    name="mistral-nemo-12b", family="dense", n_layers=40, d_model=5120,
    n_heads=32, n_kv_heads=8, head_dim=128, d_ff=14336, vocab=131072,
    rope_theta=1e6, skip_shapes=("long_500k",),
))

# [dense] RoPE SwiGLU GQA [arXiv:2404.14219]
PHI3_MEDIUM_14B = _reg(ArchConfig(
    name="phi3-medium-14b", family="dense", n_layers=40, d_model=5120,
    n_heads=40, n_kv_heads=10, head_dim=128, d_ff=17920, vocab=100352,
    rope_theta=1e4, skip_shapes=("long_500k",),
    pad_heads_to=48,  # 40 heads don't divide the 16-way TP axis (§Perf)
))

# [dense] llama-arch GQA [arXiv:2403.04652]
YI_9B = _reg(ArchConfig(
    name="yi-9b", family="dense", n_layers=48, d_model=4096,
    n_heads=32, n_kv_heads=4, head_dim=128, d_ff=11008, vocab=64000,
    rope_theta=5e6, skip_shapes=("long_500k",),
))

# [dense] GQA, QKV bias [hf:Qwen/Qwen2.5]
QWEN25_3B = _reg(ArchConfig(
    name="qwen2.5-3b", family="dense", n_layers=36, d_model=2048,
    n_heads=16, n_kv_heads=2, head_dim=128, d_ff=11008, vocab=151936,
    rope_theta=1e6, qkv_bias=True, skip_shapes=("long_500k",),
))

# [moe] 8 experts top-2, SWA [arXiv:2401.04088] — SWA(4096) makes long-context
# decode sub-quadratic, so long_500k RUNS for mixtral.
MIXTRAL_8X7B = _reg(ArchConfig(
    name="mixtral-8x7b", family="moe", n_layers=32, d_model=4096,
    n_heads=32, n_kv_heads=8, head_dim=128, d_ff=14336, vocab=32000,
    rope_theta=1e6, sliding_window=4096, n_experts=8, top_k=2,
    moe_every=1, moe_group=512,
))

# [moe] MoE 128e top-1, interleaved dense/MoE, early fusion
# [hf:meta-llama/Llama-4]; bf16 params + bf16 moments to fit 256 chips.
LLAMA4_MAVERICK = _reg(ArchConfig(
    name="llama4-maverick-400b-a17b", family="moe", n_layers=48,
    d_model=5120, n_heads=40, n_kv_heads=8, head_dim=128, d_ff=8192,
    vocab=202048, rope_theta=5e5, n_experts=128, top_k=1, moe_every=2,
    moe_group=1024, param_dtype=torch.bfloat16, moment_dtype=torch.bfloat16,
    pad_heads_to=48,  # 40 heads -> 48 for 16-way TP (§Perf)
    skip_shapes=("long_500k",),
))

# [audio] enc-dec, multimodal [arXiv:2308.11596] — 24 enc + 24 dec layers,
# vocab padded 256206 -> 256256 for 16-way sharding.
SEAMLESS_M4T_V2 = _reg(ArchConfig(
    name="seamless-m4t-large-v2", family="encdec", n_layers=24,
    n_enc_layers=24, d_model=1024, n_heads=16, n_kv_heads=16, head_dim=64,
    d_ff=8192, vocab=256256, rope_theta=1e4, frontend="audio",
    frontend_tokens=1024, skip_shapes=("long_500k",),
))

# [vlm] InternViT + InternLM2/Qwen2-ish backbone [arXiv:2404.16821] —
# vocab padded 151655 -> 151680.
INTERNVL2_1B = _reg(ArchConfig(
    name="internvl2-1b", family="vlm", n_layers=24, d_model=896,
    n_heads=14, n_kv_heads=2, head_dim=64, d_ff=4864, vocab=151680,
    rope_theta=1e6, qkv_bias=True, frontend="vit", frontend_tokens=256,
    pad_heads_to=16,  # 14 heads -> 16 for 16-way TP (§Perf)
    skip_shapes=("long_500k",),
))

# [hybrid] Mamba2 + shared attn blocks [arXiv:2411.15242]
ZAMBA2_7B = _reg(ArchConfig(
    name="zamba2-7b", family="hybrid", n_layers=81, d_model=3584,
    n_heads=32, n_kv_heads=32, head_dim=112, d_ff=14336, vocab=32000,
    rope_theta=1e4, ssm_state=64, shared_attn_every=6,
))


# ---------------------------------------------------------------------------
# Reduced (smoke) variants: same family/topology, tiny dims.
# ---------------------------------------------------------------------------
def reduced(cfg: ArchConfig) -> ArchConfig:
    n_layers = {"zamba2-7b": 7}.get(cfg.name, 2 * max(cfg.moe_every, 1))
    kw = dict(
        name=cfg.name + "-smoke",
        n_layers=n_layers,
        d_model=128,
        n_heads=4, n_kv_heads=min(cfg.n_kv_heads, 2), head_dim=32,
        d_ff=256, vocab=512,
        dtype=torch.float32, param_dtype=torch.float32,
        remat="none",
        frontend_tokens=8 if cfg.frontend != "none" else cfg.frontend_tokens,
        moe_group=64,
        pad_heads_to=0,
    )
    if cfg.family == "ssm":
        kw.update(n_heads=2, n_kv_heads=2, head_dim=64)   # rwkv hd=64
    if cfg.family == "hybrid":
        kw.update(ssm_state=16, shared_attn_every=3, n_heads=4,
                  n_kv_heads=4, head_dim=32)
    if cfg.n_experts:
        kw.update(n_experts=4, top_k=min(cfg.top_k, 2))
    if cfg.family == "encdec":
        kw.update(n_enc_layers=2)
    if cfg.n_kv_heads == cfg.n_heads:  # MHA archs stay MHA
        kw.update(n_kv_heads=kw["n_heads"])
    return replace(cfg, **kw)


def get_config(name: str) -> ArchConfig:
    if name.endswith("-smoke"):
        return reduced(ARCHS[name[:-len("-smoke")]])
    return ARCHS[name]


def arch_names() -> list[str]:
    return list(ARCHS.keys())


def cells() -> list[tuple[str, str]]:
    """All (arch, shape) cells incl. skips (caller filters on skip_shapes)."""
    return [(a, s) for a in ARCHS for s in SHAPES]
