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
* ``csrc/wkv_tc.cu`` (bfloat16 r, k, v): per chunk of 32 tokens, two
  sub-blocks of 16 of two halves of 8; every decay factor is a running
  product of clamped w (no exp, no factor above 1); scores across sub-
  blocks and across the halves of one are tensor-core products, those
  inside a half a walk over t; each float32 operand of a product (r o
  dec, r E, k F, r E8, k F8, k o prod w, the state, the score tiles) is
  split into a bf16 pair, r, k, v enter exact, y is rounded to bf16 once. Tolerances: y
  1e-2 (one bf16 ulp), the float32 state 2e-4 (``LM_TOL``).
"""
import math

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels.flash_attention import mha_ref as j_mha_ref
from repro.kernels.mamba2_ssd import ssd_ref as j_ssd_ref
from repro.kernels.rwkv6_wkv import wkv_ref as j_wkv_ref
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.mamba2_ssd import ref as ssd_ref
from repro_torch.kernels.rwkv6_wkv import ref as wkv_ref

from test_torch_common import as_np

torch.set_num_threads(1)

BF = torch.bfloat16
FLASH_TOL = 1e-2      # chip_smoke.LM_TOL["flash_attention"][bfloat16]
SSD_TOL = 3e-4        # chip_smoke.LM_TOL["ssd"][bfloat16]
WKV_TOL = 1e-2        # chip_smoke.LM_TOL["wkv"][bfloat16]: y, one bf16 ulp
WKV_STATE_TOL = 2e-4  # chip_smoke.LM_TOL["wkv_state"][bfloat16]
TILE = 64             # query rows per block, keys per tile, SSD chunk
WKV_L, WKV_SUB, WKV_HALF = 32, 16, 8   # WKV chunk, sub-block, half


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


# ---------------------------------------------------------------------------
# WKV: the chunked tensor-core kernel's arithmetic.
# ---------------------------------------------------------------------------
def wkv_tc_emulated(r, k, v, w, u, hi_lo=True):
    """bf16 r, k, v [B,S,H,hd]; f32 w [B,S,H,hd], u [H,hd] -> (y bf16
    [B,S,H,hd], state f32[B,H,hd,hd]), chunk by chunk as
    ``wkv_chunked_tc`` computes them: the running products in its order,
    its splits, its products. ``hi_lo=False`` rounds each f32 operand
    once to bf16 instead of splitting it (what the kernel does not do)."""
    B, S, H, hd = r.shape
    pair = split if hi_lo else (lambda x: (bf16_round(x), torch.zeros_like(x)))
    rf, kf, vf = (x.float().permute(0, 2, 1, 3) for x in (r, k, v))
    wf = torch.clamp(w.float(), 1e-38, 1.0).permute(0, 2, 1, 3)
    uf = u.float()[None, :, :]                                 # [1,H,hd]
    L, Q, Hf = WKV_L, WKV_SUB, WKV_HALF
    tril = torch.tril(torch.ones((Hf, Hf), dtype=torch.bool), -1)
    st = torch.zeros((B, H, hd, hd))
    ys = []
    for t0 in range(0, S, L):
        cnt = min(L, S - t0)
        pad = lambda x, val=0.0: torch.nn.functional.pad(
            x[:, :, t0:t0 + cnt], (0, 0, 0, L - cnt), value=val)
        rc, kc, vc, wc = pad(rf), pad(kf), pad(vf), pad(wf, 1.0)
        rdec, kdec = torch.empty_like(rc), torch.empty_like(kc)
        # prefix products (threads 0..hd-1): E from each sub-block's start,
        # E8 from the start of its upper half
        one = lambda: torch.ones((B, H, hd))
        r_e8 = torch.zeros((B, H, L, hd))                      # t % 16 >= 8
        e, e8 = one(), one()
        for t in range(Q):
            if t == Hf:
                e8 = one()
            rdec[:, :, t] = rc[:, :, t] * e
            r_e8[:, :, t] = rc[:, :, t] * e8
            e, e8 = e * wc[:, :, t], e8 * wc[:, :, t]
        d0, e = e, one()
        r_e = torch.empty((B, H, Q, hd))
        for t in range(Q, L):
            if t == Q + Hf:
                e8 = one()
            r_e[:, :, t - Q] = rc[:, :, t] * e
            rdec[:, :, t] = r_e[:, :, t - Q] * d0
            r_e8[:, :, t] = rc[:, :, t] * e8
            e, e8 = e * wc[:, :, t], e8 * wc[:, :, t]
        # suffix products (threads hd..2hd-1): F to each sub-block's end,
        # F8 to the end of its lower half
        k_f8 = torch.zeros((B, H, L, hd))                      # s % 16 < 8
        f = one()
        for s_ in range(L - 1, Q - 1, -1):
            if s_ == Q + Hf - 1:
                f8 = one()
            kdec[:, :, s_] = kc[:, :, s_] * f
            if s_ < Q + Hf:
                k_f8[:, :, s_] = kc[:, :, s_] * f8
                f8 = f8 * wc[:, :, s_]
            f = f * wc[:, :, s_]
        d1, f = f, one()
        k_f = torch.empty((B, H, Q, hd))
        for s_ in range(Q - 1, -1, -1):
            if s_ == Hf - 1:
                f8 = one()
            k_f[:, :, s_] = kc[:, :, s_] * f
            kdec[:, :, s_] = k_f[:, :, s_] * d1
            if s_ < Hf:
                k_f8[:, :, s_] = kc[:, :, s_] * f8
                f8 = f8 * wc[:, :, s_]
            f = f * wc[:, :, s_]
        e_last = f * d1                                        # dec_L
        # the diagonal blocks: inside each half of 8 a walk over t (CUDA
        # cores, att *= w_t); upper half x lower half (r E8)(k F8)^T
        diag = []
        for q in range(2):
            a = torch.zeros((B, H, Q, Q))
            for hf in range(2):
                rows = slice(q * Q + hf * Hf, q * Q + hf * Hf + Hf)
                rq, kq, wq = rc[:, :, rows], kc[:, :, rows], wc[:, :, rows]
                att = torch.ones((B, H, Hf, hd))               # per s
                blk = slice(hf * Hf, hf * Hf + Hf)
                for t in range(Hf):
                    below = (rq[:, :, t, None] * (kq * att)).sum(-1)
                    row = torch.where(tril[t], below, a[:, :, hf * Hf + t, blk])
                    row[:, :, t] = (rq[:, :, t] * (uf * kq[:, :, t])).sum(-1)
                    a[:, :, hf * Hf + t, blk] = row
                    att = torch.where(tril[t][None, None, :, None],
                                      att * wq[:, :, t, None], att)
            up = slice(q * Q + Hf, q * Q + Q)
            lo = slice(q * Q, q * Q + Hf)
            e8_hi, e8_lo = pair(r_e8[:, :, up])
            f8_hi, f8_lo = pair(k_f8[:, :, lo])
            a[:, :, Hf:, :Hf] = e8_hi @ f8_hi.transpose(-1, -2) + e8_lo @ \
                f8_hi.transpose(-1, -2) + e8_hi @ f8_lo.transpose(-1, -2)
            diag.append(a)
        # y: (r o dec)(S_hi + S_lo), 3 products; scores and a.v
        rd_hi, rd_lo = pair(rdec)
        s_hi, s_lo = pair(st)
        y = rd_hi @ s_hi + rd_lo @ s_hi + rd_hi @ s_lo
        re_hi, re_lo = pair(r_e)
        kf_hi, kf_lo = pair(k_f)
        sc = re_hi @ kf_hi.transpose(-1, -2) + re_lo @ \
            kf_hi.transpose(-1, -2) + re_hi @ kf_lo.transpose(-1, -2)
        a_v = lambda a, v_: pair(a)[0] @ v_ + pair(a)[1] @ v_
        v0, v1 = vc[:, :, :Q], vc[:, :, Q:]
        y = y + torch.cat([a_v(diag[0], v0),
                           a_v(sc, v0) + a_v(diag[1], v1)], 2)
        ys.append(y[:, :, :cnt])
        # S = dec_L S + (k o prod w)^T v, 2 products
        kd_hi, kd_lo = pair(kdec)
        st = e_last[..., :, None] * st + kd_hi.transpose(-1, -2) @ vc + \
            kd_lo.transpose(-1, -2) @ vc
    y = torch.cat(ys, 2).permute(0, 2, 1, 3)
    return y.to(BF), st


def wkv_inputs(B, S, H, hd, seed, strong=False):
    """The reference test's distributions, r, k, v rounded to bf16.
    ``strong``: w log-uniform down to 1e-30, every 8th channel (from 3)
    at exactly 1 and every 8th (from 5) at exactly 0 (chip_smoke.py's
    strong-decay case)."""
    rng = np.random.default_rng(seed)
    n = lambda *shape: torch.from_numpy(rng.standard_normal(shape, np.float32))
    r, k, v = n(B, S, H, hd) * 0.5, n(B, S, H, hd) * 0.5, n(B, S, H, hd)
    w = torch.sigmoid(n(B, S, H, hd) - 1.0) * 0.97 + 0.02
    u = n(H, hd) * 0.3
    if strong:
        w = 10.0 ** (-30.0 * torch.from_numpy(
            rng.uniform(0.0, 1.0, (B, S, H, hd)).astype(np.float32)))
        w[..., 3::8] = 1.0
        w[..., 5::8] = 0.0
    return r.to(BF), k.to(BF), v.to(BF), w, u


WKV_CASES = [  # B, S, H, hd, strong decay: rwkv6-7b's heads (hd = 64)
    (2, 128, 2, 64, False),
    (1, 45, 3, 64, False),                  # ragged, shorter than 2 chunks
    (2, 20, 2, 64, False),                  # shorter than a chunk
    (1, 7, 2, 64, False),                   # shorter than a sub-block
    (1, 65, 2, 64, False),                  # one token past two chunks
    (2, 65, 3, 8, False),                   # hd = 8 (padded to 16)
    (1, 96, 2, 32, False),
    (1, 512, 1, 64, True),                  # strong decay, chip_smoke's S
]


@pytest.mark.parametrize("B,S,H,hd,strong", WKV_CASES)
def test_wkv_tc_arithmetic_meets_the_lm_tolerances(B, S, H, hd, strong):
    r, k, v, w, u = wkv_inputs(B, S, H, hd, seed=S + hd, strong=strong)
    y, st = wkv_tc_emulated(r, k, v, w, u)
    assert y.shape == (B, S, H, hd) and y.dtype == BF
    assert st.shape == (B, H, hd, hd)
    assert torch.isfinite(y.float()).all() and torch.isfinite(st).all()
    y0, st0 = wkv_ref.wkv_chunked(r, k, v, w, u)
    torch.testing.assert_close(y.float(), y0.float(), rtol=WKV_TOL,
                               atol=WKV_TOL)
    torch.testing.assert_close(st, st0, rtol=WKV_STATE_TOL,
                               atol=WKV_STATE_TOL)
    jy, js = j_wkv_ref(*(jnp.asarray(as_np(z.float()))
                         for z in (r, k, v, w, u)))
    np.testing.assert_allclose(as_np(y.float()), np.asarray(jy),
                               rtol=WKV_TOL, atol=WKV_TOL)
    np.testing.assert_allclose(as_np(st), np.asarray(js), rtol=WKV_STATE_TOL,
                               atol=WKV_STATE_TOL)


def test_wkv_single_bf16_rounding_would_miss_the_state_tolerance():
    """Why the kernel splits its f32 operands: rounding each once to bf16
    (2^-9 relative) leaves the final state further than 2e-4 from the
    plain version; the hi + lo split stays well inside."""
    r, k, v, w, u = wkv_inputs(1, 128, 2, 64, seed=11)
    _, st0 = wkv_ref.wkv_chunked(r, k, v, w, u)

    def excess(st):
        return float(((st - st0).abs() - WKV_STATE_TOL *
                      (1 + st0.abs())).max())

    assert excess(wkv_tc_emulated(r, k, v, w, u, hi_lo=False)[1]) > 0
    assert excess(wkv_tc_emulated(r, k, v, w, u)[1]) < -WKV_STATE_TOL / 2


def test_wkv_factoring_through_exp_minus_cum_overflows_under_strong_decay():
    """Why every factor is a product of decays <= 1: the textbook split of
    a chunk's scores, (r o exp(cum_prev)) (k o exp(-cum))^T, needs
    exp(-cum) > 1, which overflows to inf once a chunk's summed log-decay
    passes about -88, and the scores become inf * 0 = nan. The kernel's
    arithmetic on the same inputs stays finite and within tolerance."""
    r, k, v, w, u = wkv_inputs(1, WKV_L, 1, 64, seed=5, strong=True)
    rf, kf = r.float()[0, :, 0], k.float()[0, :, 0]           # [L, hd]
    logw = torch.log(torch.clamp(w[0, :, 0], 1e-38, 1.0))
    cum = torch.cumsum(logw, 0)
    scores = (rf * torch.exp(cum - logw)) @ (kf * torch.exp(-cum)).T
    assert torch.isinf(torch.exp(-cum)).any()
    assert not torch.isfinite(torch.tril(scores, -1)).all()
    y, st = wkv_tc_emulated(r, k, v, w, u)
    y0, st0 = wkv_ref.wkv_chunked(r, k, v, w, u)
    assert torch.isfinite(y.float()).all() and torch.isfinite(st).all()
    torch.testing.assert_close(y.float(), y0.float(), rtol=WKV_TOL,
                               atol=WKV_TOL)
    torch.testing.assert_close(st, st0, rtol=WKV_STATE_TOL,
                               atol=WKV_STATE_TOL)
