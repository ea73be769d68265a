"""Job ranking score (paper §4.4.2), port of ``repro.ml.scoring``:

    S(X_i) = sum_j alpha_j * exp( 1 / sqrt(X_i^j + 1) )

The score is linear in alpha: ``S = basis(X) @ alpha``. The per-job
basis is computed once and stored in ``JobTable.ml_basis``; the alpha
vector rides the scenario axis (``Scenario.alpha``), so a sweep ranks the
same jobs under one alpha per scenario.

Feature convention (``K_SCORE`` = 4 columns, in order): predicted
runtime (s), predicted average per-node power (W), predicted job energy
(J), requested node count (``MLSchedulerModel.score_basis``).

Rounding. The scheduler sorts these numbers, so a key one ulp off can
swap two jobs. Every step below is rounded as the JAX package's CPU
backend rounds it, and the same on every device:

* ``basis``: the square root and the division are correctly rounded
  (``sqrt_f32``: torch's own float32 ``sqrt`` on the CPU misses by an
  ulp on some inputs); ``exp_f32`` is the single-precision Cephes
  polynomial that XLA's CPU backend emits for ``exp``, with its fused
  multiply-adds;
* ``weighted_sum``, the scheduler's key: a chain of fused multiply-adds
  over the K columns in order, from 0, which is how XLA fuses the
  reference's jitted ``sum(ml_basis * alpha, -1)``;
* ``score``, the baked score: each product rounded, then summed in
  order, as the reference's eager ``score`` runs.

The two sums agree whenever every product is exact, as under
``DEFAULT_ALPHA``; under another alpha they may differ by an ulp, as they
do in the reference. torch has no fused multiply-add, so ``fma`` computes
one in float64: the float32 product is exact there, the sum is rounded to
odd, and the one rounding to float32 is then correct (Boldo and
Melquiond's round-to-odd).
"""
from __future__ import annotations

import torch

# Number of scoring features: predicted (runtime s, avg power W, energy J)
# + node count. Keep in sync with MLSchedulerModel.score_basis.
K_SCORE = 4

# The paper's hand-set trade-off (Fig. 10a): favor predicted-short,
# low-power, low-energy jobs, with half weight on size.
DEFAULT_ALPHA = (1.0, 1.0, 1.0, 0.5)

_F32_TINY = torch.finfo(torch.float32).tiny
# Cephes expf: input clamp, log2(e), ln(2) split in two, polynomial
_EXP_LO = float.fromhex("-0x1.5f3334p+6")
_EXP_HI = float.fromhex("0x1.633334p+6")
_LOG2E = float.fromhex("0x1.715476p+0")
_LN2_HI, _LN2_LO = float.fromhex("0x1.63p-1"), float.fromhex("-0x1.bd0106p-13")
_EXP_POLY = tuple(float.fromhex(h) for h in (
    "0x1.a0d2cep-13", "0x1.6e879cp-10", "0x1.111210p-7", "0x1.555382p-5",
    "0x1.555554p-3", "0x1p-1"))


def _f32(v, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=like.device)


def fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """``a * b + c`` on float32 operands (tensors or numbers, broadcast
    together) with one rounding to float32, as a hardware fused
    multiply-add gives it."""
    a = torch.as_tensor(a, dtype=torch.float32)
    p = a.double() * _f32(b, a).double()       # exact: 24 + 24 bits
    c = _f32(c, a).double()
    s = p + c
    # the exact error of the float64 sum (Knuth's TwoSum)
    bv = s - p
    err = (p - (s - bv)) + (c - bv)
    # round to odd: an inexact sum with an even last bit moves one ulp
    # toward the exact value
    even = (s.view(torch.int64) & 1) == 0
    step = even & (err != 0) & torch.isfinite(err)
    toward = torch.where(err > 0, torch.inf, -torch.inf).to(s.dtype)
    s = torch.where(step, torch.nextafter(s, toward), s)
    return s.float()


def sqrt_f32(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root of non-negative float32
    ``x``: torch's float32 ``sqrt`` on the CPU is not."""
    s = torch.sqrt(x.double()).float()
    xd = x.double()
    up = torch.nextafter(s, _f32(torch.inf, s))
    down = torch.nextafter(s, _f32(0.0, s))
    # the midpoints to each neighbour have 25 bits: their squares are exact
    hi = (s.double() + up.double()) * 0.5
    lo = (s.double() + down.double()) * 0.5
    s = torch.where(hi * hi < xd, up, s)
    return torch.where(lo * lo > xd, down, s)


def exp_f32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``exp`` bit for bit as XLA's CPU backend computes it (the
    Cephes polynomial, fused multiply-adds included; a result below the
    smallest normal flushes to zero)."""
    x = x.clamp(_EXP_LO, _EXP_HI)
    fx = torch.floor(fma(x, _LOG2E, 0.5)).clamp(-127.0, 127.0)
    r = fma(-fx, _LN2_HI, x)
    r = fma(-fx, _LN2_LO, r)
    y = torch.full_like(r, _EXP_POLY[0])
    for p in _EXP_POLY[1:]:
        y = fma(y, r, p)
    y = 1.0 + fma(y, r * r, r)
    pow2 = ((fx.to(torch.int32) + 127) << 23).view(torch.float32)
    out = y * pow2
    return torch.where(out < _F32_TINY, torch.zeros_like(out), out)


def basis(features: torch.Tensor) -> torch.Tensor:
    """Per-job scoring basis: ``exp(1 / sqrt(max(X, 0) + 1))``.

    Args:
      features: f32[N, K] non-negative predicted metrics + static features
        (runtime s, power W, energy J, nodes; see the module docstring).
    Returns:
      f32[N, K], each column in (1, e]: a large predicted impact gives
      values near 1, a tiny one values near e.
    """
    x = torch.clamp(features.to(torch.float32), min=0.0)
    return exp_f32(1.0 / sqrt_f32(x + 1.0))


def weighted_sum(basis_: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """``sum(basis_ * alpha, -1)`` as one chain of fused multiply-adds over
    the last axis in order, from 0. ``alpha`` broadcasts against
    ``basis_`` (a scalar weight is the same weight on every column)."""
    b, a = torch.broadcast_tensors(basis_.to(torch.float32),
                                   alpha.to(torch.float32))
    acc = torch.zeros(b.shape[:-1], dtype=torch.float32, device=b.device)
    for k in range(b.shape[-1]):
        acc = fma(b[..., k], a[..., k], acc)
    return acc


def score(features: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """Ranking score S(X) per job (higher = scheduled earlier).

    Args:
      features: f32[N, K] non-negative predicted metrics + static features.
      alpha: f32[K] trade-off coefficients (or one for every column).
    Returns:
      f32[N] scores: ``alpha * basis(features)`` rounded, then summed over
      the K columns in order (the reference's eager rounding).
    """
    b, a = torch.broadcast_tensors(
        basis(features), torch.as_tensor(alpha, dtype=torch.float32))
    p = b * a
    acc = p[..., 0]
    for k in range(1, p.shape[-1]):
        acc = acc + p[..., k]
    return acc
