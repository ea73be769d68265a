"""Shared model-zoo plumbing: arch config, norms, RoPE, embeddings, init.

Models are functional, as in ``repro.models``: ``init(cfg, generator,
device)`` returns a dict tree of tensors, and pure forward functions take
it. Layer parameters are *stacked* along a leading layer axis, as the JAX
package stacks them for ``lax.scan``; here a Python loop indexes them, so
the JAX package's value tree carries over leaf for leaf
(``zoo.from_arrays``). Sharding annotations and remat are for training
on a mesh and are not ported.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Tuple

import torch


# ---------------------------------------------------------------------------
# Architecture config (one per assigned arch; see repro_torch.configs).
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str               # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0         # 0 -> d_model // n_heads
    # attention
    rope_theta: float = 1.0e6
    sliding_window: int = 0   # 0 = full causal attention
    qkv_bias: bool = False
    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_every: int = 1        # every k-th layer is MoE (llama4 interleaves)
    capacity_factor: float = 1.25
    moe_group: int = 1024     # router group size (tokens)
    # SSM (rwkv6 / mamba2)
    ssm_state: int = 0
    ssm_heads: int = 0
    conv_kernel: int = 4
    # q heads padded to this count (0 = off); padded wo rows are zero
    pad_heads_to: int = 0
    # hybrid (zamba2): a shared attention block every k SSM layers
    shared_attn_every: int = 0
    # encoder-decoder
    n_enc_layers: int = 0
    # modality frontend stub (vlm/audio): precomputed embeddings
    frontend: str = "none"    # none | vit | audio
    frontend_tokens: int = 256
    # numerics / training
    dtype: Any = torch.bfloat16        # activation/compute dtype
    param_dtype: Any = torch.float32   # parameter storage dtype
    moment_dtype: Any = torch.float32  # optimizer moment dtype
    remat: str = "full"                # none | full | dots (training only)
    scan_unroll: int | bool = 1        # JAX scan unroll (kept for parity)
    # which shapes are meaningful for this arch (None = all)
    skip_shapes: Tuple[str, ...] = ()

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def h_pad(self) -> int:
        """Padded q-head count used by attention weights/compute."""
        return max(self.pad_heads_to, self.n_heads) or self.n_heads

    @property
    def kv_pad(self) -> int:
        """Padded kv-head count: ceil(h_pad / group); real heads keep their
        original kv mapping (head h -> kv h // G)."""
        return -(-self.h_pad // self.group)

    @property
    def group(self) -> int:
        """Query heads per kv head of the spec model (head h -> kv h // G)."""
        return max(self.n_heads // max(self.n_kv_heads, 1), 1)

    def is_moe_layer(self, i: int) -> bool:
        return self.n_experts > 0 and (i % self.moe_every == self.moe_every - 1)

    @property
    def param_count(self) -> int:
        """Analytic parameter count (the JAX package's formula)."""
        D, F, V, hd = self.d_model, self.d_ff, self.vocab, self.hd
        H, KV = self.n_heads, self.n_kv_heads
        attn = D * (H * hd) + 2 * D * (KV * hd) + (H * hd) * D
        dense_mlp = 3 * D * F
        moe_mlp = self.n_experts * 3 * D * F + D * self.n_experts
        if self.family in ("ssm",):
            per_layer = 6 * D * D + int(2 * D * F)
            return self.n_layers * per_layer + 2 * V * D
        if self.family == "hybrid":
            d_inner = 2 * D
            per_ssm = 2 * D * d_inner + d_inner * D + \
                d_inner * (2 * self.ssm_state)
            shared = attn + dense_mlp
            return self.n_layers * per_ssm + shared + 2 * V * D
        n_moe = sum(1 for i in range(self.n_layers) if self.is_moe_layer(i))
        n_dense = self.n_layers - n_moe
        total = self.n_layers * attn + n_dense * dense_mlp + n_moe * moe_mlp
        enc = self.n_enc_layers * (attn + dense_mlp)
        dec_cross = self.n_enc_layers and self.n_layers * attn  # cross-attn
        return total + enc + (dec_cross or 0) + 2 * V * D


def unported(what: str) -> NotImplementedError:
    """The error a family or layer of the zoo that this port has not
    reached yet raises."""
    return NotImplementedError(
        f"repro_torch: {what} is not ported yet; it waits for a later "
        f"slice of the port (ROADMAP queue 1, item 15: encdec, vlm, "
        f"training)")


# ---------------------------------------------------------------------------
# Parameters.
# ---------------------------------------------------------------------------
def param(gen, shape, dtype, device, scale: float | None = None,
          init: str = "normal", stack: int = 0) -> torch.Tensor:
    """One parameter, drawn as ``repro.models.common.param`` draws it:
    normal x ``1/sqrt(fan_in)`` (or ``scale``), or zeros / ones. ``stack``
    > 0 prepends a layer axis of that length; ``fan_in`` is the per-layer
    shape's, as under the JAX package's ``vmap``. On the ``meta`` device
    only the shape and dtype are made (``gen`` may be None).

    The reference's default scale is a numpy float64, which JAX (without
    x64) promotes a bfloat16 draw by: such a leaf comes out float32, while
    zeros, ones and a Python-float ``scale`` keep ``dtype``."""
    full = ((stack,) if stack else ()) + tuple(shape)
    if init == "zeros":
        return torch.zeros(full, dtype=dtype, device=device)
    if init == "ones":
        return torch.ones(full, dtype=dtype, device=device)
    fan_in = shape[0] if len(shape) > 1 else shape[-1]
    out = dtype if scale is not None else \
        torch.promote_types(dtype, torch.float32)
    s = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    if torch.device(device).type == "meta":
        return torch.empty(full, dtype=out, device=device)
    return torch.randn(full, generator=gen, dtype=dtype,
                       device=device).to(out) * s


def layer(tree, i: int):
    """Layer ``i`` of a tree of stacked parameters (or states)."""
    if isinstance(tree, dict):
        return {k: layer(v, i) for k, v in tree.items()}
    if hasattr(tree, "_fields"):                       # a NamedTuple
        return type(tree)(*(layer(v, i) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(layer(v, i) for v in tree)
    return tree[i]


# ---------------------------------------------------------------------------
# Layers.
# ---------------------------------------------------------------------------
def rmsnorm(x, scale, eps=1e-6):
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.float())).to(dt)


def rope_freqs(hd: int, theta: float, device=None):
    return 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                         device=device) / hd))


def apply_rope(x, positions, theta: float):
    """x: [..., S, H, hd]; positions: broadcastable to [..., S]."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                    # [hd/2]
    ang = positions[..., :, None].float() * freqs              # [..., S, hd/2]
    cos = torch.cos(ang)[..., :, None, :]                      # [..., S, 1, hd/2]
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def embed_init(gen, cfg: ArchConfig, device):
    pd = cfg.param_dtype
    return {
        "tok": param(gen, (cfg.vocab, cfg.d_model), pd, device, scale=1.0),
        "out": param(gen, (cfg.d_model, cfg.vocab), pd, device),
        "ln_f": param(gen, (cfg.d_model,), pd, device, init="zeros"),
    }


def embed_tokens(params, tokens, cfg: ArchConfig):
    return params["tok"][tokens].to(cfg.dtype)


def lm_head(params, x, cfg: ArchConfig):
    x = rmsnorm(x, params["ln_f"])
    return (x @ params["out"].to(cfg.dtype)).float()
