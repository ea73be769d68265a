"""Parity of the port's MoE feed-forward (``repro_torch.models.mlp``:
``route_topk``, ``forward_moe``, ``aux_load_balance_loss``, ``init_moe``)
with the JAX package's, on the same inputs made with numpy from a seed.

Tolerances: the routing is held exactly (the dispatch tensor equal bit
for bit, so every choice of expert, tie order, slot-major position and
capacity drop is the reference's) and its combine weights within 1e-6
(both float32: a softmax and one division apart); ``forward_moe`` at
1e-5 of the largest output in float32 (one layer, two frameworks; the
reference's expert weights are drawn at 1/sqrt(E), so the outputs run
to ~1e2 at these widths); the auxiliary loss at 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import common as jC
from repro.models import mlp as jmlp
from repro.models.zoo import get_api as jget_api
from repro_torch.configs import registry as treg
from repro_torch.models import mlp as tmlp
from repro_torch.models import zoo as tzoo

torch.set_num_threads(1)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
COMBINE_TOL = 1e-6
MOE_TOL = 1e-5
# top-2 (mixtral's) and top-1 (llama4's) smoke configs: E = 4
CONFIGS = {"top2": "mixtral-8x7b-smoke",
           "top1": "llama4-maverick-400b-a17b-smoke"}


def _cfgs(top):
    return jreg.get_config(CONFIGS[top]), treg.get_config(CONFIGS[top])


def _logits(case, rng, G, Sg, E):
    """Router logits for one case: random; small integers (exact ties)
    with every row of group 0 all equal; or expert 0 far ahead of the
    rest (its capacity overflows) with ties among the others."""
    if case == "random":
        return rng.standard_normal((G, Sg, E)).astype(np.float32)
    ties = rng.integers(-2, 3, (G, Sg, E)).astype(np.float32)
    if case == "ties":
        ties[0] = 1.0
        return ties
    ties[..., 0] += 8.0
    return ties


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", ["random", "ties", "overflow"])
@pytest.mark.parametrize("top", sorted(CONFIGS))
def test_route_topk_matches_jax(top, case, dtype):
    jcfg, tcfg = _cfgs(top)
    jdt, tdt = DTYPES[dtype]
    G, Sg, E = 3, 40, tcfg.n_experts
    x = _logits(case, np.random.default_rng(11), G, Sg, E)
    for capacity in (tmlp._capacity(tcfg, Sg), 5):
        jd, jc = jmlp.route_topk(jnp.asarray(x, jdt), jcfg, capacity)
        td, tc = tmlp.route_topk(torch.from_numpy(x).to(tdt), tcfg, capacity)
        assert td.dtype == tdt and tc.dtype == torch.float32
        assert tuple(td.shape) == jd.shape == (G, Sg, E, capacity)
        assert np.array_equal(td.float().numpy(), np.asarray(jd, np.float32))
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc),
                                   rtol=COMBINE_TOL, atol=COMBINE_TOL)
        kept = int(td.float().sum())
        if case == "overflow" or capacity == 5:
            assert kept < G * Sg * tcfg.top_k, (case, capacity)   # drops
        if case == "ties":      # equal rows take experts 0..k-1
            sel = td[0].float().sum(-1)                   # [Sg, E]
            assert (sel[:capacity, :tcfg.top_k] == 1).all()
            assert (sel[:, tcfg.top_k:] == 0).all()


@pytest.mark.parametrize("sg", [1, 2, 4, 30, 64, 512, 1024])
def test_capacity_matches_jax(sg):
    for top in CONFIGS:
        jcfg, tcfg = _cfgs(top)
        assert tmlp._capacity(tcfg, sg) == jmlp._capacity(jcfg, sg)
    for name in ("mixtral-8x7b", "llama4-maverick-400b-a17b"):
        assert tmlp._capacity(treg.get_config(name), sg) == \
            jmlp._capacity(jreg.get_config(name), sg)


def _moe_params(jcfg, seed, skew):
    """The reference's init_moe values as numpy; ``skew`` adds a constant
    to every weight of router columns 0 and 1, so that tokens with a
    positive mean crowd into experts 0 and 1 past their capacity."""
    vals, _ = jC.split_tree(jmlp.init_moe(jax.random.PRNGKey(seed), jcfg))
    p = {k: np.array(v) for k, v in vals.items()}
    if skew:
        p["router"][:, :2] += 0.05
    return p


@pytest.mark.parametrize("skew", [False, True], ids=["plain", "drops"])
@pytest.mark.parametrize("B,S", [(2, 32), (3, 30), (1, 3)])
@pytest.mark.parametrize("top", sorted(CONFIGS))
def test_forward_moe_matches_jax(top, B, S, skew):
    """(2, 32): one whole group of 64; (3, 30): 90 tokens, two groups, the
    last padded with 38 zero tokens that route and take capacity; (1, 3):
    a group smaller than moe_group, as at decode."""
    jcfg, tcfg = _cfgs(top)
    p = _moe_params(jcfg, 5, skew)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((B, S, jcfg.d_model)).astype(np.float32)
    if skew:
        x += 1.0
    want = np.asarray(jmlp.forward_moe({k: jnp.asarray(v) for k, v in
                                        p.items()}, jnp.asarray(x), jcfg))
    got = tmlp.forward_moe({k: torch.from_numpy(v) for k, v in p.items()},
                           torch.from_numpy(x), tcfg)
    assert tuple(got.shape) == want.shape == (B, S, jcfg.d_model)
    top_abs = float(np.abs(want).max())
    np.testing.assert_allclose(got.numpy(), want, rtol=MOE_TOL,
                               atol=MOE_TOL * top_abs)
    # the drops the skew makes, counted from the port's own routing
    sg = min(tcfg.moe_group, B * S)
    n_groups = -(-B * S // sg)
    tok = torch.nn.functional.pad(torch.from_numpy(x).reshape(B * S, -1),
                                  (0, 0, 0, n_groups * sg - B * S))
    logits = tok.reshape(n_groups, sg, -1) @ torch.from_numpy(p["router"])
    dispatch, _ = tmlp.route_topk(logits, tcfg, tmlp._capacity(tcfg, sg))
    dropped = n_groups * sg * tcfg.top_k - int(dispatch.sum())
    if skew:
        assert dropped > 0


def test_aux_load_balance_loss_matches_jax():
    jcfg, tcfg = _cfgs("top2")
    rng = np.random.default_rng(8)
    for shape in ((3, 40, 4), (2, 5, 7, 4)):
        x = rng.standard_normal(shape).astype(np.float32)
        want = float(jmlp.aux_load_balance_loss(jnp.asarray(x), jcfg))
        got = tmlp.aux_load_balance_loss(torch.from_numpy(x), tcfg)
        assert got.dtype == torch.float32 and got.ndim == 0
        assert abs(float(got) - want) <= COMBINE_TOL * max(1.0, abs(want))
    ties = np.zeros((2, 6, 4), np.float32)      # argmax ties: expert 0
    assert float(tmlp.aux_load_balance_loss(torch.from_numpy(ties), tcfg)) \
        == pytest.approx(float(jmlp.aux_load_balance_loss(
            jnp.asarray(ties), jcfg)), abs=COMBINE_TOL)


def _numel(shape):
    return int(np.prod(shape, dtype=np.int64))


@pytest.mark.parametrize("name", ["mixtral-8x7b",
                                  "llama4-maverick-400b-a17b"])
def test_meta_init_matches_jax_shapes_and_param_count(name):
    """The full-width tree on the ``meta`` device: every leaf the JAX
    package's ``eval_shape`` leaf (shape and dtype, in flattening order),
    and the total ``cfg.param_count`` plus what that count leaves out:
    the norm scales (two a layer and the final one) and the padded heads'
    attention weights (llama4: 40 -> 48 query heads, 8 -> 10 kv heads)."""
    jcfg, tcfg = jreg.get_config(name), treg.get_config(name)
    shapes = jax.tree_util.tree_leaves(jax.eval_shape(
        lambda k: jC.split_tree(jget_api(jcfg).init(k))[0],
        jax.random.PRNGKey(0)))
    got = tzoo.get_api(tcfg).init(None, "meta")

    def flat(t):
        if isinstance(t, dict):
            return [x for k in sorted(t) for x in flat(t[k])]
        if isinstance(t, list):
            return [x for v in t for x in flat(v)]
        return [t]
    leaves = flat(got)
    assert len(leaves) == len(shapes)
    for a, b in zip(shapes, leaves):
        assert a.shape == tuple(b.shape) and b.device.type == "meta"
        assert DTYPES[str(a.dtype)][1] == b.dtype, (a.shape, a.dtype)
    total = sum(_numel(b.shape) for b in leaves)
    assert total == sum(_numel(a.shape) for a in shapes)
    D, L, hd = tcfg.d_model, tcfg.n_layers, tcfg.hd
    pad = (tcfg.h_pad - tcfg.n_heads) * 2 * D * hd + \
        (tcfg.kv_pad - tcfg.n_kv_heads) * 2 * D * hd
    assert total == tcfg.param_count + (2 * L + 1) * D + L * pad
    n_experts = [b.shape for b in leaves if len(b.shape) == 4 and
                 b.shape[1] == tcfg.n_experts]
    assert len(n_experts) == 3, n_experts          # w_down, w_gate, w_up
