"""Plain PyTorch versions of the RWKV6 WKV recurrence: the naive scan
(``wkv_ref``, after ``repro.kernels.rwkv6_wkv.ref``) and the chunked form
(``wkv_chunked``, a transcription of ``repro.kernels.rwkv6_wkv.ops``),
which is the path a CPU tensor takes and what the CUDA kernel is held to
on the card.

Per head (state S in R^{hd x hd}):
    y_t[j]   = sum_i r_t[i] * ( S_t[i,j] + u[i] * k_t[i] * v_t[j] )
    S_{t+1}  = diag(w_t) S_t + k_t (x) v_t
"""
from __future__ import annotations

import torch


def wkv_ref(r, k, v, w, u):
    """r,k,v,w: [B,S,H,hd]; u: [H,hd]. Returns (y f32[B,S,H,hd], final
    state f32[B,H,hd,hd]) from a zero state."""
    B, S, H, hd = r.shape
    r, k, v, w = (x.float() for x in (r, k, v, w))
    u = u.float()
    s = torch.zeros((B, H, hd, hd), device=r.device)
    ys = []
    for t in range(S):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]       # [B,H,hd,hd]
        att = s + u[None, :, :, None] * kv
        ys.append(torch.einsum("bhi,bhij->bhj", r[:, t], att))
        s = w[:, t, :, :, None] * s + kv
    return torch.stack(ys, 1), s


def wkv_chunked(r, k, v, w, u, chunk: int = 32):
    """Chunked WKV (state0 = 0): returns (y in r's dtype, final state f32
    [B,H,hd,hd]; float64 inputs compute and return float64). Everything
    stays in log space until the last exp, and the pairwise decays are
    masked BEFORE the exp, so strong decay cannot make inf * 0. A
    sequence that is not a multiple of the chunk is padded with tokens
    that leave the state as it is (k = 0, w = 1).

    In float32, strong decay costs precision: a chunk's log-space cumsum
    reaches |cum| ~ 2,000 and the exponent cum_prev[t] - cum[s] of two
    near tokens is a difference of two such numbers, so the card holds
    its kernels to this function run in float64 (``chip_smoke.py``)."""
    B, S, H, hd = r.shape
    dt_out = r.dtype
    wide = lambda x: x.to(torch.promote_types(x.dtype, torch.float32))
    r, k, v, w = map(wide, (r, k, v, w))
    u = wide(u)
    L = min(chunk, S)
    pad = -S % L
    if pad:
        z = lambda x, val=0.0: torch.nn.functional.pad(
            x, (0, 0, 0, 0, 0, pad), value=val)
        r, k, v, w = z(r), z(k), z(v), z(w, 1.0)
    nC = (S + pad) // L

    def to_chunks(x):                                  # [nC, B, H, L, hd]
        return x.reshape(B, nC, L, H, hd).permute(1, 0, 3, 2, 4)

    rc, kc, vc, wc = map(to_chunks, (r, k, v, w))
    logw = torch.log(torch.clamp(wc, 1e-38, 1.0))
    cum = torch.cumsum(logw, dim=-2)                   # inclusive
    cum_prev = cum - logw                              # exclusive
    cum_last = cum[..., -1:, :]
    mask = (torch.arange(L, device=r.device)[:, None] >
            torch.arange(L, device=r.device)[None, :])
    s = torch.zeros((B, H, hd, hd), dtype=r.dtype, device=r.device)
    ys = []
    for c in range(nC):
        rt, kt, vt = rc[c], kc[c], vc[c]
        cumt, cumpt, cumlast = cum[c], cum_prev[c], cum_last[c]
        diff = cumpt[..., :, None, :] - cumt[..., None, :, :]  # [B,H,L,L,hd]
        att = torch.exp(diff.masked_fill(~mask[None, None, :, :, None],
                                         -torch.inf))
        a = torch.einsum("bhti,bhtsi,bhsi->bhts", rt, att, kt)
        y = torch.einsum("bhts,bhsj->bhtj", a, vt)
        y = y + torch.einsum("bhti,bhti,bhtj->bhtj", rt,
                             u[None, :, None, :] * kt, vt)
        y = y + torch.einsum("bhti,bhij->bhtj", rt * torch.exp(cumpt), s)
        kdec = kt * torch.exp(cumlast - cumt)
        s = torch.exp(cumlast[..., 0, :])[..., :, None] * s + \
            torch.einsum("bhsi,bhsj->bhij", kdec, vt)
        ys.append(y)
    y = torch.stack(ys).permute(1, 0, 3, 2, 4).reshape(B, nC * L, H, hd)
    return y[:, :S].to(dt_out), s

