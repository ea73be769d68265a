"""Plain PyTorch oracle for blockwise (flash) attention: a transcription
of ``repro.kernels.flash_attention.ref.mha_ref``, plain f32 softmax
attention with causal + sliding-window masking and GQA head grouping.
It is the path a CPU tensor takes and what the CUDA kernel is held to on
the card."""
from __future__ import annotations

import math

import torch


def mha_ref(q, k, v, causal: bool = True, window: int = 0):
    """q: [B,S,H,hd]; k,v: [B,T,KV,hd]; returns [B,S,H,hd] (q dtype).

    GQA: H is a multiple of KV; query head h uses kv head h // (H / KV).
    Queries are right-aligned when S != T; masked logits are -1e30, so a
    row with no visible key averages every value, as the reference does.
    """
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    head_kv = torch.arange(H, device=q.device) // G
    qf = q.float()
    kf = k.float().index_select(2, head_kv)
    vf = v.float().index_select(2, head_kv)
    logits = torch.einsum("bshd,bthd->bhst", qf, kf) / math.sqrt(hd)
    qi = torch.arange(S, device=q.device)[:, None] + (T - S)
    kj = torch.arange(T, device=q.device)[None, :]
    mask = torch.ones((S, T), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kj <= qi
    if window > 0:
        mask &= kj > (qi - window)
    logits = logits.masked_fill(~mask, -1e30)
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhst,bthd->bshd", w, vf)
    return out.to(q.dtype)
