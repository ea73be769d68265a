"""The port's threefry2x32 (``repro_torch.prng``) against ``jax.random``.

The event layer draws its failures from ``fold_in(PRNGKey(seed), step)``,
``split(key, 7)``, ``uniform`` and ``exponential``; the port must give
the same raw uint32 bits, exactly, for the keys, the splits and the
random bits, and the same float32 uniforms. The exponentials go through
``log1p``, where torch's and XLA's may differ by an ulp each side of the
true value: they are held to 2 float32 ulps.

These tests compare against the partitionable threefry, which jax 0.9
runs by default; they check that it is on and set nothing.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import prng

from test_torch_common import assert_threefry_partitionable

torch.set_num_threads(1)

SEEDS = [0, 1, 2 ** 31 - 1, -7]
STEPS = [0, 1, 1439, 2 ** 20]
SHAPES = [(1,), (7,), (25,), (9600,), (9601,)]
EXP_ULPS = 2


@pytest.fixture(scope="module", autouse=True)
def partitionable():
    assert_threefry_partitionable()


def jkey(seed, step):
    return jax.random.fold_in(jax.random.PRNGKey(jnp.int32(seed)),
                              jnp.int32(step))


def tkey(seed, step):
    return prng.fold_in(prng.seed_key(torch.tensor(seed, dtype=torch.int32)),
                        torch.tensor(step, dtype=torch.int32))


def bits_of(x):
    """uint32 words as int64, the port's representation."""
    return np.asarray(x).astype(np.uint32).astype(np.int64)


def test_seed_key_matches_prngkey():
    for seed in SEEDS + [-2 ** 31]:
        want = bits_of(jax.random.PRNGKey(jnp.int32(seed)))
        got = prng.seed_key(torch.tensor(seed, dtype=torch.int32)).numpy()
        np.testing.assert_array_equal(got, want, err_msg=str(seed))


@pytest.mark.parametrize("step", STEPS)
@pytest.mark.parametrize("seed", SEEDS)
def test_fold_in_and_split_are_bit_exact(seed, step):
    k = jkey(seed, step)
    np.testing.assert_array_equal(tkey(seed, step).numpy(), bits_of(k))
    np.testing.assert_array_equal(prng.split(tkey(seed, step), 7).numpy(),
                                  bits_of(jax.random.split(k, 7)))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", SEEDS)
def test_random_bits_are_bit_exact(seed, shape):
    for j, (jk, tk) in enumerate(zip(jax.random.split(jkey(seed, 1439), 7),
                                     prng.split(tkey(seed, 1439), 7))):
        want = bits_of(jax.random.bits(jk, shape, jnp.uint32))
        np.testing.assert_array_equal(prng.random_bits(tk, shape).numpy(),
                                      want, err_msg=f"draw {j}")


def test_random_bits_of_a_matrix_count_in_row_major_order():
    want = bits_of(jax.random.bits(jkey(3, 5), (3, 50), jnp.uint32))
    np.testing.assert_array_equal(prng.random_bits(tkey(3, 5), (3, 50)),
                                  want)


@pytest.mark.parametrize("shape", SHAPES)
def test_uniform_is_bit_exact(shape):
    for seed in SEEDS:
        for jk, tk in zip(jax.random.split(jkey(seed, 2 ** 20), 7),
                          prng.split(tkey(seed, 2 ** 20), 7)):
            want = np.asarray(jax.random.uniform(jk, shape))
            got = prng.uniform(tk, shape).numpy()
            assert got.dtype == want.dtype == np.float32
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", SHAPES)
def test_exponential_within_two_ulps(shape):
    worst = 0
    for seed in SEEDS:
        for jk, tk in zip(jax.random.split(jkey(seed, 1), 7),
                          prng.split(tkey(seed, 1), 7)):
            want = np.asarray(jax.random.exponential(jk, shape))
            got = prng.exponential(tk, shape).numpy()
            assert got.dtype == want.dtype == np.float32
            # both are non-negative: the int32 patterns order like the values
            ulps = np.abs(got.view(np.int32).astype(np.int64) -
                          want.view(np.int32).astype(np.int64))
            worst = max(worst, int(ulps.max()))
    assert worst <= EXP_ULPS, f"{worst} ulps"


def test_a_batch_of_keys_equals_one_key_at_a_time():
    """S keys (one per scenario) through each function at once equal S
    single-key calls, and ``random_bits_many`` equals one
    ``random_bits`` a draw."""
    seeds = torch.tensor(SEEDS, dtype=torch.int32)
    steps = torch.tensor([0, 1439, 7, 2 ** 20], dtype=torch.int32)
    keys = prng.fold_in(prng.seed_key(seeds), steps)
    splits = prng.split(keys, 7)
    sizes = (25, 9601, 1, 7, 25, 9601, 7)
    many = prng.random_bits_many(splits, sizes)
    for s in range(len(SEEDS)):
        one = tkey(SEEDS[s], int(steps[s]))
        assert torch.equal(keys[s], one)
        assert torch.equal(splits[s], prng.split(one, 7))
        assert torch.equal(prng.uniform(keys[:, None], (9600,))[s, 0],
                           prng.uniform(one, (9600,)))
        for j, n in enumerate(sizes):
            assert torch.equal(many[j][s],
                               prng.random_bits(prng.split(one, 7)[j], (n,)))
