"""K-means clustering (paper §4.4.1 step 1), port of ``repro.ml.kmeans``:
partition historical jobs into behavioral clusters from static +
dynamic features.

Float32 throughout, as the reference runs it. The seed points are the
reference's ``jax.random.choice(PRNGKey(seed), n, (k,), replace=False)``
bit for bit: the first ``k`` of ``jax.random.permutation``, which sorts
``arange(n)`` by fresh 32-bit random keys (stably) in as many rounds as
``ceil(3 ln n / ln(2^32 - 1))``, each round a ``split`` and a
``random_bits`` of ``repro_torch.prng``. The squared distances are the
reference's fused multiply-add chain over the features
(``scoring.fma``), so an assignment the reference makes from the same
centers is made here too. ``standardize`` sums over the jobs in XLA's
CPU order (``_sum_rows``), so its moments are the reference's bit for
bit; the center update sums in torch's order, which is not XLA's (a few
ulps apart).
"""
from __future__ import annotations

import math

import torch

from repro_torch import prng
from repro_torch.ml.scoring import fma, sqrt_f32

_WINDOW = 32    # XLA's CPU tree-reduction window


def permutation(seed: int, n: int) -> torch.Tensor:
    """``jax.random.permutation(PRNGKey(seed), n)``: i64[n]."""
    key = prng.seed_key(torch.tensor(seed))
    x = torch.arange(n)
    rounds = math.ceil(3 * math.log(max(1, n)) / math.log(2 ** 32 - 1))
    for _ in range(rounds):
        key, sub = prng.split(key, 2)
        order = torch.sort(prng.random_bits(sub, (n,)), stable=True).indices
        x = x[order]
    return x


def _sq_dist(x: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """f32[N, k]: ``sum((x - c)**2, -1)`` as the reference's fused
    reduction rounds it (each difference rounded, then one fused
    multiply-add a feature, in order)."""
    diff = x[:, None, :] - centers[None, :, :]
    acc = torch.zeros(diff.shape[:-1], dtype=torch.float32)
    for d in range(diff.shape[-1]):
        acc = fma(diff[..., d], diff[..., d], acc)
    return acc


def fit(x: torch.Tensor, k: int, iters: int = 50, seed: int = 0):
    """Lloyd's algorithm (paper §4.4.1 step 1). x: f32[N, D]
    (standardized, dimensionless). Returns (centers f32[k, D], labels
    i64[N], inertia f32[]: the summed squared distances)."""
    x = x.to(torch.float32)
    centers = x[permutation(seed, x.shape[0])[:k]]
    for _ in range(iters):
        labels = torch.argmin(_sq_dist(x, centers), dim=1)
        one_hot = torch.nn.functional.one_hot(labels, k).to(x.dtype)
        counts = one_hot.sum(0)
        new = (one_hot.T @ x) / torch.clamp(counts[:, None], min=1.0)
        # keep empty clusters where they were
        centers = torch.where(counts[:, None] > 0, new, centers)
    d2 = _sq_dist(x, centers)
    return centers, torch.argmin(d2, dim=1), d2.min(dim=1).values.sum()


def predict(centers: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Nearest-center assignment (paper §4.4.1 inference): centers
    f32[k, D], x f32[N, D] (standardized) -> labels i64[N]."""
    return torch.argmin(_sq_dist(x.to(torch.float32), centers), dim=1)


def _sum_rows(x: torch.Tensor) -> torch.Tensor:
    """f32[N, D] -> f32[D]: the sum over axis 0 in the order of XLA's
    CPU tree reduction. While more than 32 rows are left, they are padded
    with zeros to a multiple of 32 (half the padding in front, the odd one
    behind) and each window of 32 is summed in order from 0; the last
    rows are summed in order from 0."""
    while x.shape[0] > _WINDOW:
        n = x.shape[0]
        m = -(-n // _WINDOW) * _WINDOW
        lo = (m - n) // 2
        padded = torch.zeros((m, *x.shape[1:]), dtype=x.dtype)
        padded[lo:lo + n] = x
        windows = padded.reshape(m // _WINDOW, _WINDOW, *x.shape[1:])
        x = torch.zeros_like(windows[:, 0])
        for i in range(_WINDOW):
            x = x + windows[:, i]
    acc = torch.zeros(x.shape[1:], dtype=x.dtype)
    for row in x:
        acc = acc + row
    return acc


def standardize(x: torch.Tensor, mean=None, std=None):
    """Zero-mean / unit-std feature scaling: x f32[N, D] -> (x_std f32[N,
    D], mean f32[D], std f32[D]); pass the stored moments at inference
    time so train and test share one scale. The moments are the
    reference's ``x.mean(0)`` and ``x.std(0) + 1e-6`` as XLA rounds them
    (a sum times ``1/N``; squared deviations summed, divided by ``N``)."""
    x = x.to(torch.float32)
    if mean is None:
        n = x.shape[0]
        mean = _sum_rows(x) * torch.tensor(1.0 / n, dtype=torch.float32)
        dev = x - mean
        std = sqrt_f32(_sum_rows(dev * dev) / n) + 1e-6
    return (x - mean) / std, mean, std
