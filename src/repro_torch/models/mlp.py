"""Feed-forward layers: dense SwiGLU and grouped top-k MoE (GShard-style
dispatch with capacity, einsum formulation); the port of
``repro.models.mlp``.

MoE: tokens are routed in *groups* of ``moe_group`` tokens; the dispatch
and combine tensors are dense [G, Sg, E, C] with
C = int(top_k * Sg * capacity_factor / E) + 1 (within [top_k, Sg]), and
every expert computes all C slots of every group, as the reference does.
"""
from __future__ import annotations

import torch

from repro_torch.models.common import ArchConfig, param


# ---------------------------------------------------------------------------
# Dense SwiGLU.
# ---------------------------------------------------------------------------
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


# ---------------------------------------------------------------------------
# Mixture of experts.
# ---------------------------------------------------------------------------
def init_moe(gen, cfg: ArchConfig, device, stack: int = 0):
    """Router [D, E] and expert weights [E, D, F] / [E, F, D]; the
    reference draws each at 1/sqrt(shape[0]), so the experts' scale is
    1/sqrt(E)."""
    D, F, E, pd = cfg.d_model, cfg.d_ff, cfg.n_experts, cfg.param_dtype
    return {
        "router": param(gen, (D, E), pd, device, stack=stack),
        "w_gate": param(gen, (E, D, F), pd, device, stack=stack),
        "w_up": param(gen, (E, D, F), pd, device, stack=stack),
        "w_down": param(gen, (E, F, D), pd, device, stack=stack),
    }


def _capacity(cfg: ArchConfig, sg: int) -> int:
    c = int(cfg.top_k * sg * cfg.capacity_factor / cfg.n_experts) + 1
    return min(max(c, cfg.top_k), sg)


def top_k(x: torch.Tensor, k: int):
    """The ``k`` largest values along the last axis and their indices,
    largest first, equal values in index order (as ``jax.lax.top_k``;
    ``torch.topk`` promises no order on ties)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route_topk(logits: torch.Tensor, cfg: ArchConfig, capacity: int):
    """GShard-style dispatch. logits: [G, Sg, E].

    Returns (dispatch [G,Sg,E,C] one-hot in the logits' dtype, combine
    [G,Sg,E,C] gate-weighted in float32). Position-in-expert is slot-major
    (all slot-0 assignments get positions before slot-1); an assignment
    at a position past ``capacity`` is dropped (an all-zero row)."""
    G, Sg, E = logits.shape
    k = cfg.top_k
    probs = torch.softmax(logits.float(), dim=-1)
    gate_vals, expert_idx = top_k(probs, k)                # [G,Sg,k]
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True)

    experts = torch.arange(E, device=logits.device)
    onehot = (expert_idx[..., None] == experts).to(torch.int32)  # [G,Sg,k,E]
    oh_km = onehot.transpose(1, 2).reshape(G, k * Sg, E)
    pos_flat = torch.cumsum(oh_km, dim=1) - oh_km         # positions from 0
    pos = pos_flat.reshape(G, k, Sg, E).transpose(1, 2)   # [G,Sg,k,E]
    keep = (pos < capacity) & (onehot > 0)

    slots = torch.arange(capacity, device=logits.device)
    pos_oh = (pos[..., None] == slots).to(logits.dtype)   # [G,Sg,k,E,C]
    keepf = keep.to(logits.dtype)[..., None]
    ohf = onehot[..., None].to(logits.dtype)
    dispatch = torch.sum(pos_oh * keepf * ohf, dim=2)      # [G,Sg,E,C]
    combine = torch.sum(pos_oh * keepf * (gate_vals[..., None, None] * ohf),
                        dim=2)
    return dispatch, combine


def forward_moe(p, x, cfg: ArchConfig):
    """x: [B, S, D] -> [B, S, D]."""
    B, S, D = x.shape
    tokens = x.reshape(B * S, D)
    sg = min(cfg.moe_group, B * S)
    n_tok = tokens.shape[0]
    n_groups = -(-n_tok // sg)
    pad = n_groups * sg - n_tok
    if pad:                     # zero tokens; they route and take capacity
        tokens = torch.nn.functional.pad(tokens, (0, 0, 0, pad))
    xg = tokens.reshape(n_groups, sg, D)

    logits = xg @ p["router"].to(cfg.dtype)                # [G, Sg, E]
    dispatch, combine = route_topk(logits, cfg, _capacity(cfg, sg))
    dispatch = dispatch.to(cfg.dtype)
    combine = combine.to(cfg.dtype)

    xe = torch.einsum("gsec,gsd->egcd", dispatch, xg)      # [E, G, C, D]
    g = torch.einsum("egcd,edf->egcf", xe, p["w_gate"].to(cfg.dtype))
    u = torch.einsum("egcd,edf->egcf", xe, p["w_up"].to(cfg.dtype))
    h = torch.nn.functional.silu(g) * u
    ye = torch.einsum("egcf,efd->egcd", h, p["w_down"].to(cfg.dtype))
    out = torch.einsum("gsec,egcd->gsd", combine, ye)

    return out.reshape(n_groups * sg, D)[:n_tok].reshape(B, S, D)


def aux_load_balance_loss(logits: torch.Tensor, cfg: ArchConfig
                          ) -> torch.Tensor:
    """Switch-style load-balancing auxiliary loss over router logits."""
    probs = torch.softmax(logits.float(), dim=-1)
    lead = tuple(range(probs.ndim - 1))
    frac_probs = probs.mean(dim=lead)
    top1 = torch.argmax(probs, dim=-1)
    frac_tokens = torch.nn.functional.one_hot(
        top1, cfg.n_experts).float().mean(dim=lead)
    return cfg.n_experts * torch.sum(frac_probs * frac_tokens)
