"""Parity of the port's power-topology kernel module with the JAX package.

On the CPU the port's ``fused_cooling``/``fused_cooling_hier`` take their
plain versions; the JAX side runs its Pallas kernel in interpret mode,
as its own tests do, and its ``ref.py`` oracles. Tolerance rtol = atol =
1e-4, the reference's own kernel bound (tests/test_cooling.py): the two
frameworks sum a group's nodes in different orders. The integer maps and
the hall max are exact. The CUDA kernel itself is held to its plain
version on the card (``chip_smoke.py`` and the card-only test below).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels.power_topo import ops as jops
from repro.kernels.power_topo import ref as jref
from repro.systems.config import FacilityTopology
from repro_torch.kernels.power_topo import ops as tops
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
