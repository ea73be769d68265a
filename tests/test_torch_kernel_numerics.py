"""The rounding schemes of the port's tensor-core kernels, emulated in
torch on the CPU and held to the plain versions and the JAX oracles.

The CUDA kernels run only on the card (``chip_smoke.py`` holds them to
their plain versions there). What can be checked here is their
arithmetic: each emulation below rounds exactly where its kernel rounds,
and is held to the plain version at ``chip_smoke.py``'s tolerances
(``LM_TOL``) at the serving path's head shapes with a smaller batch.

* ``csrc/flash_attention_tc.cu`` (bfloat16): q, k, v enter the products
  exact; logits, softmax and the output sum are float32, per key tile of
  64 with the online max and sum; P is rounded to bf16 before P.V, and
  the output once to bf16. Tolerance 1e-2 (one bf16 ulp of the output).
* ``csrc/ssd.cu``'s chunked kernel (bfloat16 x, B, C): per chunk of 64
  tokens, every float32 operand of a product (M = att o g o dt, the state
  S, the decay-weighted x) is split into a bf16 pair hi + lo and enters
  as two products; x, B and C enter exact. Tolerance 3e-4 (float32
  outputs), which a single bf16 rounding of those operands would miss.
"""
import math

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels.flash_attention import mha_ref as j_mha_ref
from repro.kernels.mamba2_ssd import ssd_ref as j_ssd_ref
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.mamba2_ssd import ref as ssd_ref

from test_torch_common import as_np

torch.set_num_threads(1)

BF = torch.bfloat16
FLASH_TOL = 1e-2      # chip_smoke.LM_TOL["flash_attention"][bfloat16]
SSD_TOL = 3e-4        # chip_smoke.LM_TOL["ssd"][bfloat16]
TILE = 64             # query rows per block, keys per tile, SSD chunk


def bf16_round(x):
    return x.to(BF).float()


def split(v):
    """v = hi + lo, each a bf16 value (as float32), as the kernel splits."""
    hi = bf16_round(v)
    return hi, bf16_round(v - hi)


# ---------------------------------------------------------------------------
# Flash attention: the tensor-core kernel's arithmetic.
# ---------------------------------------------------------------------------
def flash_tc_emulated(q, k, v, causal=True, window=0, round_p=True):
    """q [B,S,H,hd], k, v [B,T,KV,hd] -> f32 [B,S,H,hd] before the
    output's rounding, tile by tile as ``flash_tc_kernel`` computes it,
    over its key-tile range. ``round_p=False`` keeps P in float32."""
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = torch.tensor(1.0 / math.sqrt(hd), dtype=torch.float32)
    qf = q.float().permute(0, 2, 1, 3)                          # [B,H,S,hd]
    kf = k.float().permute(0, 2, 1, 3).repeat_interleave(G, 1)  # [B,H,T,hd]
    vf = v.float().permute(0, 2, 1, 3).repeat_interleave(G, 1)
    off = T - S
    n_tiles = -(-T // TILE)
    out = torch.empty((B, H, S, hd))
    for q0 in range(0, S, TILE):
        rows = torch.arange(q0, min(q0 + TILE, S))
        qp = rows + off
        first, last = int(qp[0]), int(qp[-1])
        lo, hi = 0, n_tiles
        if not (causal and first < 0):          # no blind row
            if causal:
                hi = min(n_tiles, last // TILE + 1)
            while window > 0 and lo < hi and \
                    min((lo + 1) * TILE, T) - 1 <= first - window:
                lo += 1
        m = torch.full((B, H, len(rows), 1), -1e30)
        l = torch.zeros((B, H, len(rows), 1))
        o = torch.zeros((B, H, len(rows), hd))
        for kt in range(lo, hi):
            keys = torch.arange(kt * TILE, min((kt + 1) * TILE, T))
            s = (qf[:, :, rows] @ kf[:, :, keys].transpose(-1, -2)) * scale
            mask = torch.zeros((len(rows), len(keys)), dtype=torch.bool)
            if causal:
                mask |= keys[None, :] > qp[:, None]
            if window > 0:
                mask |= keys[None, :] <= qp[:, None] - window
            s = s.masked_fill(mask, -1e30)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new)
            l = alpha * l + p.sum(-1, keepdim=True)
            o = alpha * o + (bf16_round(p) if round_p else p) @ \
                vf[:, :, keys]
            m = m_new
        out[:, :, rows] = o / torch.clamp(l, min=1e-30)
    return out.permute(0, 2, 1, 3)


def attn_inputs(B, S, Tk, H, KV, hd, seed):
    """numpy normals from a seed, rounded to bf16 (the kernel's inputs)."""
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal(shape, np.float32))
                 .to(BF) for shape in ((B, S, H, hd), (B, Tk, KV, hd),
                                       (B, Tk, KV, hd)))


FLASH_CASES = [  # B, S, T, H, KV, hd, causal, window: the path's heads
    (1, 128, 128, 8, 1, 128, True, 0),      # qwen2.5-3b's GQA group, hd 128
    (1, 129, 129, 4, 1, 128, True, 0),      # a row past a 64-row tile
    (1, 128, 128, 4, 4, 112, True, 0),      # zamba2-7b MHA, hd 112
    (1, 192, 192, 7, 1, 64, True, 0),       # hd 64 GQA (qwen2.5-0.5b)
    (1, 256, 256, 4, 2, 128, True, 100),    # sliding window: skipped tiles
    (1, 100, 300, 4, 2, 64, True, 0),       # S < T, right-aligned
    (1, 130, 70, 4, 2, 64, True, 0),        # S > T: blind rows
    (1, 65, 65, 4, 2, 112, False, 0),       # non-causal, ragged
]


@pytest.mark.parametrize("B,S,Tk,H,KV,hd,causal,window", FLASH_CASES)
def test_flash_tc_rounding_meets_the_bf16_tolerance(
        B, S, Tk, H, KV, hd, causal, window):
    q, k, v = attn_inputs(B, S, Tk, H, KV, hd, seed=S * hd + window)
    got = flash_tc_emulated(q, k, v, causal, window).to(BF)
    assert got.shape == (B, S, H, hd) and got.dtype == BF
    assert torch.isfinite(got.float()).all()
    want = fa_ref.mha_ref(q, k, v, causal, window)
    torch.testing.assert_close(got.float(), want.float(), rtol=FLASH_TOL,
                               atol=FLASH_TOL)
    jwant = j_mha_ref(*(jnp.asarray(as_np(z.float())) for z in (q, k, v)),
                      causal, window)
    np.testing.assert_allclose(as_np(got.float()), np.asarray(jwant),
                               rtol=FLASH_TOL, atol=FLASH_TOL)


@pytest.mark.parametrize("B,S,Tk,H,KV,hd,causal,window", FLASH_CASES)
def test_flash_tc_tiling_matches_plain_attention_in_float32(
        B, S, Tk, H, KV, hd, causal, window):
    """The kernel's tiles, skipped tiles, blind rows and online softmax
    alone, with P kept in float32: the plain version's float32 result to
    the reference's 2e-5."""
    q, k, v = (z.float() for z in
               attn_inputs(B, S, Tk, H, KV, hd, seed=S * hd + window))
    got = flash_tc_emulated(q, k, v, causal, window, round_p=False)
    torch.testing.assert_close(got, fa_ref.mha_ref(q, k, v, causal, window),
                               rtol=2e-5, atol=2e-5)


# ---------------------------------------------------------------------------
# SSD: the chunked tensor-core kernel's arithmetic.
# ---------------------------------------------------------------------------
def ssd_tc_emulated(x, dt, a, B, C, hi_lo=True):
    """bf16 x [Bz,S,H,P], B, C [Bz,S,N]; f32 dt, a [Bz,S,H] -> (y
    f32[Bz,S,H,P], state f32[Bz,H,P,N]), chunk by chunk as
    ``ssd_chunked_tc`` computes them. ``hi_lo=False`` rounds each f32
    operand once to bf16 instead of splitting it (what the kernel does
    not do)."""
    Bz, S, H, P = x.shape
    N = B.shape[-1]
    pair = split if hi_lo else (lambda v: (bf16_round(v), torch.zeros_like(v)))
    xf, Bf, Cf = x.float(), B.float(), C.float()
    tri = torch.tril(torch.ones((TILE, TILE), dtype=torch.bool))
    st = torch.zeros((Bz, H, P, N))
    ys = []
    for t0 in range(0, S, TILE):
        cnt = min(TILE, S - t0)
        pad = TILE - cnt
        sl = slice(t0, t0 + cnt)
        xc = torch.nn.functional.pad(xf[:, sl], (0, 0, 0, 0, 0, pad))
        Bc = torch.nn.functional.pad(Bf[:, sl], (0, 0, 0, pad))
        Cc = torch.nn.functional.pad(Cf[:, sl], (0, 0, 0, pad))
        dc = torch.nn.functional.pad(dt[:, sl], (0, 0, 0, pad))
        la = torch.nn.functional.pad(
            torch.log(torch.clamp(a[:, sl], 1e-38, 1.0)), (0, 0, 0, pad))
        cum = torch.cumsum(la, 1).transpose(1, 2)              # [Bz,H,L]
        dch = dc.transpose(1, 2)                               # [Bz,H,L]
        xh = xc.permute(0, 2, 1, 3)                            # [Bz,H,L,P]
        g = Cc @ Bc.transpose(-1, -2)                          # [Bz,L,L]
        diff = (cum[..., :, None] - cum[..., None, :]).masked_fill(~tri,
                                                                   -torch.inf)
        M = torch.exp(diff) * g[:, None] * dch[..., None, :]   # [Bz,H,L,L]
        m_hi, m_lo = pair(M)
        s_hi, s_lo = pair(st)
        inter = Cc[:, None] @ s_hi.transpose(-1, -2) + \
            Cc[:, None] @ s_lo.transpose(-1, -2)               # [Bz,H,L,P]
        y = torch.exp(cum)[..., None] * inter + (m_hi @ xh + m_lo @ xh)
        w = torch.exp(cum[..., -1:] - cum) * dch               # [Bz,H,L]
        a_hi, a_lo = pair(w[..., None] * xh)                   # [Bz,H,L,P]
        st = torch.exp(cum[..., -1])[..., None, None] * st + \
            (a_hi.transpose(-1, -2) @ Bc[:, None] +
             a_lo.transpose(-1, -2) @ Bc[:, None])
        ys.append(y[:, :, :cnt].permute(0, 2, 1, 3))
    return torch.cat(ys, 1), st


def ssd_inputs(Bz, S, H, P, N, seed, strong=False):
    """The reference test's distributions, x, B, C rounded to bf16."""
    rng = np.random.default_rng(seed)
    n = lambda *shape: torch.from_numpy(rng.standard_normal(shape, np.float32))
    sp = torch.nn.functional.softplus
    x, dt, a = n(Bz, S, H, P), sp(n(Bz, S, H)), torch.exp(-sp(n(Bz, S, H)))
    B, C = n(Bz, S, N) * 0.5, n(Bz, S, N) * 0.5
    if strong:
        a = torch.full_like(a, 1e-6)
    return x.to(BF), dt, a, B.to(BF), C.to(BF)


SSD_CASES = [  # Bz, S, H, P, N, strong decay: zamba2-7b's heads (P=N=64)
    (1, 128, 3, 64, 64, False),
    (2, 45, 3, 64, 64, False),              # ragged, shorter than a chunk
    (1, 65, 3, 64, 64, False),              # one token past a chunk
    (1, 192, 2, 64, 64, True),              # strong decay
    (1, 100, 2, 64, 16, False),             # the smoke archs' N
]


@pytest.mark.parametrize("Bz,S,H,P,N,strong", SSD_CASES)
def test_ssd_tc_rounding_meets_the_f32_tolerance(Bz, S, H, P, N, strong):
    x, dt, a, B, C = ssd_inputs(Bz, S, H, P, N, seed=S + N, strong=strong)
    y, st = ssd_tc_emulated(x, dt, a, B, C)
    assert y.shape == (Bz, S, H, P) and st.shape == (Bz, H, P, N)
    assert torch.isfinite(y).all() and torch.isfinite(st).all()
    y0, st0 = ssd_ref.ssd_chunked(x, dt, a, B, C)
    torch.testing.assert_close(y, y0, rtol=SSD_TOL, atol=SSD_TOL)
    torch.testing.assert_close(st, st0, rtol=SSD_TOL, atol=SSD_TOL)
    jy, js = j_ssd_ref(*(jnp.asarray(as_np(z.float()))
                         for z in (x, dt, a, B, C)))
    np.testing.assert_allclose(as_np(y), np.asarray(jy), rtol=SSD_TOL,
                               atol=SSD_TOL)
    np.testing.assert_allclose(as_np(st), np.asarray(js), rtol=SSD_TOL,
                               atol=SSD_TOL)


def test_ssd_single_bf16_rounding_would_miss_the_tolerance():
    """Why the kernel splits its f32 operands: rounding each once to bf16
    (2^-9 relative) leaves y and the state further than 3e-4 from the
    plain version; the hi + lo split stays well inside."""
    x, dt, a, B, C = ssd_inputs(1, 128, 3, 64, 64, seed=11)
    y0, st0 = ssd_ref.ssd_chunked(x, dt, a, B, C)

    def excess(y, st):
        return max(float(((y - y0).abs() - SSD_TOL * (1 + y0.abs())).max()),
                   float(((st - st0).abs() -
                          SSD_TOL * (1 + st0.abs())).max()))

    assert excess(*ssd_tc_emulated(x, dt, a, B, C, hi_lo=False)) > 0
    assert excess(*ssd_tc_emulated(x, dt, a, B, C)) < -SSD_TOL / 2
