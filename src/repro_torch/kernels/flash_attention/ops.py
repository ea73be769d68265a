"""Attention dispatcher: a CUDA tensor goes through the Hopper flash
kernel (``flash_attention.flash_attention_cuda``), a CPU tensor through
the plain version (``ref.mha_ref``). The choice follows the tensor's
device and nothing else: there is no fallback from one to the other."""
from __future__ import annotations

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention.ref import mha_ref


def mha(q, k, v, causal: bool = True, window: int = 0):
    """q: [B,S,H,hd]; k,v: [B,T,KV,hd] -> [B,S,H,hd] in q's dtype; query
    head h reads kv head h // (H / KV)."""
    if q.device.type == "cpu":
        return mha_ref(q, k, v, causal, window)
    return flash_attention.flash_attention_cuda(
        q.contiguous(), k.contiguous(), v.contiguous(), causal, window)
