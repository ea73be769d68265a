"""Plain PyTorch versions of the Mamba2 SSD recurrence: the naive scan
(``ssd_ref``, after ``repro.kernels.mamba2_ssd.ref``) and the chunked
"state-space duality" form (``ssd_chunked``, a transcription of
``repro.kernels.mamba2_ssd.ops``), which is the path a CPU tensor takes
and what the CUDA kernel is held to on the card.

Per head (state S in R^{P x N}, scalar decay a_t):
    S_t = a_t S_{t-1} + (dt_t * x_t) (x) B_t
    y_t = S_t C_t
"""
from __future__ import annotations

import torch


def ssd_ref(x, dt, a, B, C):
    """x: [Bz,S,H,P]; dt,a: [Bz,S,H]; B,C: [Bz,S,N]. Returns (y
    f32[Bz,S,H,P], final state f32[Bz,H,P,N]) from a zero state."""
    Bz, S, H, P = x.shape
    N = B.shape[-1]
    x, dt, a, B, C = (z.float() for z in (x, dt, a, B, C))
    s = torch.zeros((Bz, H, P, N), device=x.device)
    ys = []
    for t in range(S):
        dbx = dt[:, t, :, None] * x[:, t]                    # [Bz,H,P]
        s = a[:, t, :, None, None] * s + \
            dbx[..., :, None] * B[:, t, None, None, :]
        ys.append(torch.einsum("bhpn,bn->bhp", s, C[:, t]))
    return torch.stack(ys, 1), s


def ssd_chunked(x, dt, a, B, C, chunk: int = 64):
    """Chunked SSD (state0 = 0): returns (y f32[Bz,S,H,P], final state
    f32[Bz,H,P,N]). The pairwise decays are masked BEFORE the exp. A
    sequence that is not a multiple of the chunk is padded with tokens
    that leave the state as it is (dt = 0, a = 1)."""
    Bz, S, H, P = x.shape
    N = B.shape[-1]
    x, dt, a, B, C = (z.float() for z in (x, dt, a, B, C))
    L = min(chunk, S)
    pad = -S % L
    if pad:
        x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
        dt = torch.nn.functional.pad(dt, (0, 0, 0, pad))
        a = torch.nn.functional.pad(a, (0, 0, 0, pad), value=1.0)
        B = torch.nn.functional.pad(B, (0, 0, 0, pad))
        C = torch.nn.functional.pad(C, (0, 0, 0, pad))
    nC = (S + pad) // L

    xc = x.reshape(Bz, nC, L, H, P).permute(1, 0, 3, 2, 4)    # [nC,Bz,H,L,P]
    dtc = dt.reshape(Bz, nC, L, H).permute(1, 0, 3, 2)        # [nC,Bz,H,L]
    ac = a.reshape(Bz, nC, L, H).permute(1, 0, 3, 2)
    Bc = B.reshape(Bz, nC, L, N).permute(1, 0, 2, 3)          # [nC,Bz,L,N]
    Cc = C.reshape(Bz, nC, L, N).permute(1, 0, 2, 3)
    cum = torch.cumsum(torch.log(torch.clamp(ac, 1e-38, 1.0)), dim=-1)
    mask = (torch.arange(L, device=x.device)[:, None] >=
            torch.arange(L, device=x.device)[None, :])
    s = torch.zeros((Bz, H, P, N), device=x.device)
    ys = []
    for c in range(nC):
        xt, dtt, cumt, Bt, Ct = xc[c], dtc[c], cum[c], Bc[c], Cc[c]
        dbx = dtt[..., None] * xt                              # [Bz,H,L,P]
        diff = cumt[..., :, None] - cumt[..., None, :]
        att = torch.exp(diff.masked_fill(~mask, -torch.inf))
        g = torch.einsum("bln,bsn->bls", Ct, Bt)               # [Bz,L,L]
        y = torch.einsum("bhls,bls,bhsp->bhlp", att, g, dbx)
        y = y + torch.einsum("bhl,bln,bhpn->bhlp", torch.exp(cumt), Ct, s)
        dec = torch.exp(cumt[..., -1:] - cumt)                 # [Bz,H,L]
        s = torch.exp(cumt[..., -1])[..., None, None] * s + \
            torch.einsum("bhl,bhlp,bln->bhpn", dec, dbx, Bt)
        ys.append(y)
    y = torch.stack(ys).permute(1, 0, 3, 2, 4).reshape(Bz, nC * L, H, P)
    return y[:, :S], s
