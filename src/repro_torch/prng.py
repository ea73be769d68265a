"""Counter-based random numbers, bit for bit those of ``jax.random``'s
threefry2x32 in its partitionable form (``jax_threefry_partitionable``,
on by default in jax 0.9).

The JAX package draws its stochastic failures from
``fold_in(PRNGKey(seed), step)``, ``split(key, 7)`` and
``uniform``/``exponential`` (``repro.events.process``). torch's
generators cannot reproduce that stream, so this module transcribes it:

* ``threefry_2x32``: the Threefry-2x32 block cipher, 20 rounds with a
  key injection every 4 (``jax._src.prng._threefry2x32_lowering``);
* ``seed_key``: the key of a 32-bit integer seed, ``[0, seed mod 2^32]``
  (``threefry_seed``; a 32-bit seed shifted right by 32 is 0);
* ``fold_in``: hash the counter pair ``(0, data)`` under the key;
* ``split``: key ``i`` of ``num`` is the hash of ``(0, i)`` (the
  partitionable ``_threefry_split_foldlike``, not the original form
  that hashes ``2 * num`` counters and reshapes);
* ``random_bits``: element ``i`` is ``y0 ^ y1`` of the hash of
  ``(i >> 32, i & 0xffffffff)`` (``_threefry_random_bits_partitionable``
  with counters from ``iota_2x32_shape``);
* ``uniform`` on [0, 1): ``bits >> 9 | 0x3f800000`` read as float32,
  minus 1;
* ``exponential``: ``-log1p(-uniform)``.

Every key is a tensor of shape ``[..., 2]``: a batch of keys (one per
scenario) goes through each function at once, with no loop over the
batch. ``random_bits_many`` hashes several draws of several keys in one
pass, which is how the event layer takes its seven draws a step.

torch's ``uint32`` lacks most operations and a right shift of ``int32``
is arithmetic, so the words are held in ``int64`` masked to 32 bits
after every add and shift: every shift is then logical and no add can
overflow. Keys and bits are ``int64`` in ``[0, 2^32)``.
"""
from __future__ import annotations

import functools
import math
from typing import Sequence

import numpy as np
import torch

M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & M32) | (x >> (32 - r))


def threefry_2x32(k0: torch.Tensor, k1: torch.Tensor, x0: torch.Tensor,
                  x1: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32 of the counter words ``(x0, x1)`` under the key
    ``(k0, k1)``; all int64 in [0, 2^32), broadcast together. Returns the
    two output words."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & M32
    return x0, x1


def seed_key(seed: torch.Tensor) -> torch.Tensor:
    """``PRNGKey`` of 32-bit integer seeds: [...] -> int64 [..., 2]."""
    lo = seed.to(torch.int64) & M32
    return torch.stack([torch.zeros_like(lo), lo], -1)


def fold_in(key: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """``jax.random.fold_in``: a key [..., 2] and a non-negative integer
    per key [...] -> the derived keys [..., 2]."""
    lo = data.to(torch.int64) & M32
    y0, y1 = threefry_2x32(key[..., 0], key[..., 1], torch.zeros_like(lo), lo)
    return torch.stack([y0, y1], -1)


def _counters(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int64, device=device)


def split(key: torch.Tensor, num: int) -> torch.Tensor:
    """``jax.random.split`` (partitionable): [..., 2] -> [..., num, 2]."""
    lo = _counters(num, key.device)
    y0, y1 = threefry_2x32(key[..., 0, None], key[..., 1, None],
                           torch.zeros_like(lo), lo)
    return torch.stack([y0, y1], -1)


def random_bits(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.bits`` of 32 bits (partitionable): element i of the
    flattened ``shape`` hashes the counter i. [..., 2] -> [..., *shape]."""
    n = math.prod(shape)
    idx = _counters(n, key.device)
    y0, y1 = threefry_2x32(key[..., 0, None], key[..., 1, None], idx >> 32,
                           idx & M32)
    return (y0 ^ y1).reshape(*key.shape[:-1], *shape)


@functools.lru_cache(maxsize=32)
def _segments(sizes: tuple[int, ...], device: torch.device):
    """(draw of each element, its counter) for ``random_bits_many``,
    built on the host once per (sizes, device)."""
    seg = np.repeat(np.arange(len(sizes)), sizes)
    idx = np.concatenate([np.arange(n) for n in sizes])
    return (torch.from_numpy(seg).to(device),
            torch.from_numpy(idx.astype(np.int64)).to(device))


def random_bits_many(keys: torch.Tensor, sizes: Sequence[int]
                     ) -> list[torch.Tensor]:
    """``random_bits(keys[..., j, :], (sizes[j],))`` for every j, hashed
    in one pass over all of them: keys [..., K, 2] -> K tensors
    [..., sizes[j]]."""
    sizes = tuple(int(n) for n in sizes)
    seg, idx = _segments(sizes, keys.device)
    k = keys[..., seg, :]
    y0, y1 = threefry_2x32(k[..., 0], k[..., 1], idx >> 32, idx & M32)
    return list(torch.split(y0 ^ y1, list(sizes), -1))


def bits_to_uniform(bits: torch.Tensor) -> torch.Tensor:
    """float32 uniforms in [0, 1) from 32 random bits, as
    ``jax.random.uniform`` forms them: the top 23 bits as the fraction
    of a float in [1, 2), minus 1 (its scaling to [minval, maxval) and
    floor at minval are exact no-ops for [0, 1))."""
    one = (bits >> 9) | 0x3F800000
    return one.to(torch.int32).view(torch.float32) - 1.0


def uniform(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.uniform`` on [0, 1) in float32: [..., 2] ->
    [..., *shape]."""
    return bits_to_uniform(random_bits(key, shape))


def uniform_to_exponential(u: torch.Tensor) -> torch.Tensor:
    """Unit-mean exponentials from uniforms in [0, 1), as
    ``jax.random.exponential``: -log1p(-u). torch's ``log1p`` and XLA's
    may differ by an ulp."""
    return -torch.log1p(-u)


def exponential(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.exponential`` in float32: [..., 2] -> [..., *shape]."""
    return uniform_to_exponential(uniform(key, shape))
