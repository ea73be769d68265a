"""Feed-forward layers: the dense SwiGLU of ``repro.models.mlp``. The
grouped top-k MoE waits for a later slice of the port."""
from __future__ import annotations

import torch

from repro_torch.models.common import ArchConfig, param, unported


def init_dense(gen, cfg: ArchConfig, device, stack: int = 0):
    D, F, pd = cfg.d_model, cfg.d_ff, cfg.param_dtype
    return {
        "w_gate": param(gen, (D, F), pd, device, stack=stack),
        "w_up": param(gen, (D, F), pd, device, stack=stack),
        "w_down": param(gen, (F, D), pd, device, stack=stack),
    }


def forward_dense(p, x, cfg: ArchConfig):
    g = x @ p["w_gate"].to(cfg.dtype)
    u = x @ p["w_up"].to(cfg.dtype)
    return (torch.nn.functional.silu(g) * u) @ p["w_down"].to(cfg.dtype)


def init_moe(gen, cfg: ArchConfig, device, stack: int = 0):
    raise unported("the MoE feed-forward (mlp.init_moe/forward_moe)")


def forward_moe(p, x, cfg: ArchConfig):
    raise unported("the MoE feed-forward (mlp.init_moe/forward_moe)")
