"""Parity of the port's power-topology kernel module with the JAX package.

On the CPU the port's ``fused_cooling``/``fused_cooling_hier`` and
``group_power``/``group_power_split`` take their plain versions; the JAX
side runs its Pallas kernels in interpret mode, as its own tests do, and
its ``ref.py`` oracles. Tolerances: rtol = atol = 1e-4 for the fused
cooling step, the reference's own bound (tests/test_cooling.py); rtol
1e-5 for the group sums, the reference's own (tests/test_kernels.py):
the two frameworks sum a group's nodes in different orders. The integer
maps and the hall max are exact. The CUDA kernels themselves are held to
their plain versions on the card (``chip_smoke.py`` and the card-only
tests below).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels.power_topo import ops as jops
from repro.kernels.power_topo import ref as jref
from repro.systems.config import FacilityTopology
from repro_torch.kernels.power_topo import ops as tops
from repro_torch.kernels.power_topo import power_topo
from repro_torch.kernels.power_topo import ref as tref

from test_torch_common import as_np, assert_exact

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)
PARAMS = dict(cp_j_kg_k=4186.0, ua_w_k=4e5, dt=15.0, tau_hx_s=120.0,
              tau_valve_s=60.0, delta_t_design_c=8.0, mdot_min_kg_s=8.0,
              mdot_max_kg_s=40.0)
SHAPES = [(3, 100, 4), (8, 256, 8), (1, 37, 5)]
NAMES = ("q", "t_return", "t_supply", "mdot", "q_hall")


def _inputs(S, N, G, H, seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(200.0, 2500.0, (S, N)).astype(np.float32),
            rng.uniform(20.0, 35.0, (S, G)).astype(np.float32),
            rng.uniform(8.0, 40.0, (S, G)).astype(np.float32),
            rng.uniform(18.0, 30.0, (S, H)).astype(np.float32),
            rng.uniform(24.0, 32.0, (S,)).astype(np.float32))


@pytest.mark.parametrize("S,N,G", SHAPES)
def test_fused_cooling_matches_jax_kernel_and_ref(S, N, G):
    x, ts, md, tb_h, tset = _inputs(S, N, G, 1, seed=S * N + G)
    tb = tb_h[:, 0]
    jp, tp = jref.CduParams(**PARAMS), tref.CduParams(**PARAMS)
    j = [jnp.asarray(a) for a in (x, ts, md, tb, tset)]
    pallas = jops.fused_cooling(*j, G, jp, use_pallas=True, interpret=True)
    oracle = jref.fused_cooling_ref(*j, G, jp)
    got = tops.fused_cooling(*(torch.from_numpy(a) for a in
                               (x, ts, md, tb, tset)), G, tp)
    for name, p, o, g in zip(NAMES, pallas, oracle, got):
        assert g.shape == (S, G) and g.dtype == torch.float32
        np.testing.assert_allclose(as_np(g), np.asarray(p), err_msg=name,
                                   **TOL)
        np.testing.assert_allclose(as_np(g), np.asarray(o), err_msg=name,
                                   **TOL)


@pytest.mark.parametrize("S,N,G", SHAPES)
@pytest.mark.parametrize("H", [1, 4])
def test_fused_cooling_hier_matches_jax(S, N, G, H):
    H = min(H, G)
    hog = FacilityTopology(n_halls=H).hall_of_group(G)
    x, ts, md, tb, tset = _inputs(S, N, G, H, seed=7 * S + N + H)
    jp, tp = jref.CduParams(**PARAMS), tref.CduParams(**PARAMS)
    j = [jnp.asarray(a) for a in (x, ts, md, tb, tset)]
    pallas = jops.fused_cooling_hier(*j, hog, G, jp, use_pallas=True,
                                     interpret=True)
    oracle = jref.fused_cooling_hier_ref(*j, hog, G, jp)
    t = [torch.from_numpy(a) for a in (x, ts, md, tb, tset)]
    got = tops.fused_cooling_hier(*t, hog, G, tp)
    plain = tref.fused_cooling_hier_ref(*t, hog, G, tp)
    for name, p, o, g, q in zip(NAMES, pallas, oracle, got, plain):
        np.testing.assert_allclose(as_np(g), np.asarray(p), err_msg=name,
                                   **TOL)
        np.testing.assert_allclose(as_np(g), np.asarray(o), err_msg=name,
                                   **TOL)
        # the CPU wrapper IS the plain version
        assert torch.equal(g, q), name


@pytest.mark.parametrize("N,G", [(100, 4), (37, 5), (9601, 25), (10, 8)])
def test_group_ids_exact(N, G):
    assert_exact(jref.group_ids(N, G), tref.group_ids(N, G), "group_ids")


@pytest.mark.parametrize("G,H", [(4, 1), (8, 4), (25, 5), (7, 3)])
def test_hall_reductions_exact(G, H):
    """Both packages reduce groups to halls with a one-hot product. Heats
    are whole watts below 2^19, so every partial sum is exact in float32
    and any summation order gives the same bits; the hall max is an
    exact select."""
    hog = FacilityTopology(n_halls=H).hall_of_group(G)
    rng = np.random.default_rng(G * H)
    q = rng.integers(0, 2 ** 19, (3, G)).astype(np.float32)
    assert_exact(jref.hall_power_ref(jnp.asarray(q), hog, H),
                 tref.hall_power_ref(torch.from_numpy(q), hog, H),
                 "hall_power")
    assert_exact(jref.hall_max_ref(jnp.asarray(q), hog, H),
                 tref.hall_max_ref(torch.from_numpy(q), hog, H), "hall_max")
    assert_exact(jref.hall_matrix(hog, H), tref.hall_matrix(hog, H),
                 "hall_matrix")


def test_kernel_matches_plain_version_on_the_card():
    """The CUDA kernel against its plain version at Frontier shape, a
    ragged span and 5 halls (rtol = atol = 1e-4)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernel has no CPU mode")
    tp = tref.CduParams(**PARAMS)
    for S, N, G, H in [(8, 9600, 25, 1), (8, 9601, 25, 1), (8, 9600, 25, 5)]:
        hog = FacilityTopology(n_halls=H).hall_of_group(G)
        t = [torch.from_numpy(a).cuda() for a in _inputs(S, N, G, H, 11)]
        got = tops.fused_cooling_hier(*t, hog, G, tp)
        want = tref.fused_cooling_hier_ref(*t, hog, G, tp)
        torch.cuda.synchronize()
        for name, g, w in zip(NAMES, got, want):
            torch.testing.assert_close(g, w, **TOL, msg=name)


GROUP_SHAPES = [(64, 4), (980, 10), (356, 4), (129, 7)]


@pytest.mark.parametrize("N,G", GROUP_SHAPES)
@pytest.mark.parametrize("S", [1, 3])
def test_group_power_matches_jax_kernel_and_ref(S, N, G):
    x = np.random.default_rng(N + G + S).uniform(
        0.0, 3000.0, (S, N)).astype(np.float32)
    pallas = jops.group_power(jnp.asarray(x), G, use_pallas=True,
                              interpret=True)
    oracle = jref.group_power_ref(jnp.asarray(x), G)
    got = tops.group_power(torch.from_numpy(x), G)
    assert got.shape == (S, G) and got.dtype == torch.float32
    np.testing.assert_allclose(as_np(got), np.asarray(pallas), rtol=1e-5)
    np.testing.assert_allclose(as_np(got), np.asarray(oracle), rtol=1e-5)


@pytest.mark.parametrize("N,G", GROUP_SHAPES)
def test_group_power_split_matches_two_jax_calls(N, G):
    """The split's floor and dynamic sums against the reference's two
    ``group_power`` calls on ``min(p, idle)`` and ``p - floor`` (what
    ``grid.powercap.enforce_cap`` does), with nodes on both sides of the
    idle floor and exactly on it."""
    idle = 240.0
    rng = np.random.default_rng(N * G)
    x = rng.uniform(0.0, 2200.0, (3, N)).astype(np.float32)
    x[:, ::5] = idle
    floor = jnp.minimum(jnp.asarray(x), idle)
    dyn = jnp.asarray(x) - floor
    floor_g, dyn_g = tops.group_power_split(torch.from_numpy(x), idle, G)
    for got, arr, name in ((floor_g, floor, "floor"), (dyn_g, dyn, "dyn")):
        for want in (jops.group_power(arr, G, use_pallas=True,
                                      interpret=True),
                     jref.group_power_ref(arr, G)):
            np.testing.assert_allclose(as_np(got), np.asarray(want),
                                       rtol=1e-5, err_msg=name)
    # the floors and the dynamic shares add up to the plain group sum
    np.testing.assert_allclose(as_np(floor_g + dyn_g),
                               as_np(tops.group_power(torch.from_numpy(x), G)),
                               rtol=1e-5)


def test_group_power_wrapper_rejects_bad_inputs():
    """The CUDA wrapper validates type, shape and device before anything
    else, and never takes a CPU tensor (the CPU path is the plain
    version)."""
    for bad, match in [(torch.ones(2, 40, dtype=torch.float64), "float32"),
                       (torch.ones(40), "shape"),
                       (torch.ones(2, 40), "CUDA")]:
        with pytest.raises(ValueError, match=match):
            power_topo.group_power_cuda(bad, 4)
        with pytest.raises(ValueError, match=match):
            power_topo.group_power_cuda(bad, 4, idle_w=240.0)


def test_group_power_kernel_matches_plain_version_on_the_card():
    """The CUDA kernel, both modes, against its plain version at the grid
    sweep's Frontier shape and a ragged span (rtol 1e-5, atol 1e-3 W)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernel has no CPU mode")
    for S, N, G in [(12, 9600, 25), (12, 9601, 25), (3, 10, 8)]:
        x = torch.from_numpy(np.random.default_rng(N).uniform(
            0.0, 3200.0, (S, N)).astype(np.float32)).cuda()
        got = (tops.group_power(x, G), *tops.group_power_split(x, 700.0, G))
        want = (tref.group_power_ref(x, G),
                *tref.group_power_split_ref(x, 700.0, G))
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-3)
