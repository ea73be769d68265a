"""Parity of the port's LM serving path (``repro_torch.models``,
``repro_torch.launch.serve_lm``) with the JAX package, on the ``-smoke``
configs of the four ported families: qwen2.5-3b (dense GQA with QKV
bias), rwkv6-7b (attention-free), zamba2-7b (Mamba2 + shared attention),
mixtral-8x7b (every layer MoE, top-2) and llama4-maverick (blocks of a
dense and an MoE layer, top-1).

Weights come from the JAX package's init and are carried over with
``from_arrays``; tokens are made with numpy. On the CPU the port's
prefill takes the plain versions of its kernels. Tolerances: model parts
at rtol = atol = 1e-5 (one f32 layer); logits and every state leaf at
1e-4 (a whole f32 model, two frameworks); the port against itself at the
JAX package's own invariants (tests/test_archs_smoke.py): prefill vs
forward at 2e-3, recurrent decode vs teacher forcing at 4e-3.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import attention as jattn
from repro.models import common as jC
from repro.models import mamba2 as jmamba
from repro.models import mlp as jmlp
from repro.models.zoo import get_api as jget_api
from repro_torch.configs import registry as treg
from repro_torch.launch import serve_lm
from repro_torch.models import attention as tattn
from repro_torch.models import common as tC
from repro_torch.models import mamba2 as tmamba
from repro_torch.models import mlp as tmlp
from repro_torch.models import zoo as tzoo

from test_torch_common import as_np

torch.set_num_threads(1)

ARCHS = ["qwen2.5-3b-smoke", "rwkv6-7b-smoke", "zamba2-7b-smoke",
         "mixtral-8x7b-smoke", "llama4-maverick-400b-a17b-smoke"]
B, S, MAX_LEN, STEPS = 2, 32, 48, 8
DTYPES = {jnp.bfloat16: torch.bfloat16, jnp.float32: torch.float32}


def close(got, want, tol, what=""):
    np.testing.assert_allclose(as_np(got), np.asarray(want), rtol=tol,
                               atol=tol, err_msg=what)


def flat(tree):
    """Leaves of a port state or parameter tree, in the JAX package's
    flattening order (dict keys sorted, NamedTuple fields in order)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in flat(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in flat(v)]
    return [tree]


# ---------------------------------------------------------------------------
# Registry.
# ---------------------------------------------------------------------------
def test_registry_copy_equals_jax_registry():
    assert list(treg.ARCHS) == list(jreg.ARCHS) and len(treg.ARCHS) == 10
    assert treg.SHAPES == jreg.SHAPES
    for name in jreg.ARCHS:
        for n in (name, name + "-smoke"):
            j, t = jreg.get_config(n), treg.get_config(n)
            for f in dataclasses.fields(j):
                a, b = getattr(j, f.name), getattr(t, f.name)
                if f.name.endswith("dtype"):
                    assert DTYPES[a] == b, (n, f.name)
                else:
                    assert a == b, (n, f.name)
            for prop in ("hd", "h_pad", "kv_pad", "param_count"):
                assert getattr(j, prop) == getattr(t, prop), (n, prop)
    assert treg.cells() == jreg.cells()


# ---------------------------------------------------------------------------
# Model parts, one layer each, at 1e-5.
# ---------------------------------------------------------------------------
def _rng(seed):
    return np.random.default_rng(seed)


def test_rmsnorm_and_rope_match_jax():
    rng = _rng(0)
    x = rng.standard_normal((2, 7, 4, 32), np.float32)
    scale = rng.standard_normal(32).astype(np.float32) * 0.1
    close(tC.rmsnorm(torch.from_numpy(x), torch.from_numpy(scale)),
          jC.rmsnorm(jnp.asarray(x), jnp.asarray(scale)), 1e-5, "rmsnorm")
    pos = np.arange(3, 10)[None, :]
    close(tC.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e4),
          jC.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e4), 1e-5,
          "apply_rope")
    close(tC.rope_freqs(32, 1e6), jC.rope_freqs(32, 1e6), 1e-7, "freqs")


def test_sdpa_dense_mlp_and_causal_conv_match_jax():
    cfg_j = jreg.get_config("qwen2.5-3b-smoke")       # GQA: H=4, KV=2
    cfg_t = treg.get_config("qwen2.5-3b-smoke")
    rng = _rng(1)
    q = rng.standard_normal((2, 9, 4, 32), np.float32)
    k = rng.standard_normal((2, 9, 2, 32), np.float32)
    v = rng.standard_normal((2, 9, 2, 32), np.float32)
    for window in (0, 4):
        jm = jattn.causal_mask(9, 9, window)
        tm = tattn.causal_mask(9, 9, window)
        assert np.array_equal(np.asarray(jm), as_np(tm))
        close(tattn._sdpa(*(torch.from_numpy(a) for a in (q, k, v)),
                          tm[None, None], cfg_t),
              jattn._sdpa(*(jnp.asarray(a) for a in (q, k, v)),
                          jm[None, None], cfg_j), 1e-5, f"_sdpa w={window}")
    x = rng.standard_normal((2, 5, cfg_j.d_model), np.float32)
    p = {n: rng.standard_normal(s, np.float32) * 0.05 for n, s in
         (("w_gate", (128, 256)), ("w_up", (128, 256)),
          ("w_down", (256, 128)))}
    close(tmlp.forward_dense({n: torch.from_numpy(a) for n, a in p.items()},
                             torch.from_numpy(x), cfg_t),
          jmlp.forward_dense({n: jnp.asarray(a) for n, a in p.items()},
                             jnp.asarray(x), cfg_j), 1e-5, "forward_dense")
    xc = rng.standard_normal((2, 11, 24), np.float32)
    w = rng.standard_normal((4, 24), np.float32) * 0.5
    b = rng.standard_normal(24).astype(np.float32) * 0.1
    close(tmamba._causal_conv(*(torch.from_numpy(a) for a in (xc, w, b)),
                              cfg_t),
          jmamba._causal_conv(*(jnp.asarray(a) for a in (xc, w, b)),
                              cfg_j), 1e-5, "_causal_conv")


# ---------------------------------------------------------------------------
# Whole families against the JAX package.
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module", params=ARCHS)
def family(request):
    """(name, JAX results, port api, port params, tokens) for one arch:
    the JAX package's forward, prefill state and 8 greedy decode steps."""
    name = request.param
    jcfg = jreg.get_config(name)
    japi = jget_api(jcfg)
    params, _ = jC.split_tree(japi.init(jax.random.PRNGKey(3)))
    tokens = _rng(7).integers(0, jcfg.vocab, (B, S)).astype(np.int32)
    jt = {"tokens": jnp.asarray(tokens)}
    out = {"forward": np.asarray(japi.forward(params, jt))}
    logits, state = japi.prefill(params, jt, MAX_LEN)
    out["prefill"] = np.asarray(logits)
    out["state"] = [np.asarray(x) for x in jax.tree_util.tree_leaves(state)]
    decode = jax.jit(japi.decode)
    fed, steps = [], []
    for _ in range(STEPS):
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        fed.append(np.asarray(tok))
        logits, state = decode(params, tok, state)
        steps.append(np.asarray(logits))
    out["fed"], out["steps"] = np.stack(fed, 1), np.stack(steps, 1)
    out["final_state"] = [np.asarray(x)
                          for x in jax.tree_util.tree_leaves(state)]
    tcfg = treg.get_config(name)
    np_params = jax.tree_util.tree_map(np.asarray, params)
    return name, out, tzoo.get_api(tcfg), tzoo.from_arrays(tcfg, np_params), \
        torch.from_numpy(tokens).long()


def test_forward_logits_match_jax(family):
    name, j, api, params, tokens = family
    got = api.forward(params, {"tokens": tokens})
    assert got.shape == (B, S, api.cfg.vocab) and got.dtype == torch.float32
    close(got, j["forward"], 1e-4, name)


def _state_matches(name, got_state, want_leaves, what):
    got = flat(got_state)
    assert len(got) == len(want_leaves), (name, what, len(got))
    for i, (g, w) in enumerate(zip(got, want_leaves)):
        if isinstance(g, int):                       # pos
            assert g == int(w), (name, what, i)
            continue
        assert tuple(g.shape) == w.shape, (name, what, i)
        assert g.dtype == DTYPES[jnp.dtype(w.dtype).type], (name, what, i)
        close(g, w, 1e-4, f"{name} {what} leaf {i}")


def test_prefill_logits_and_state_match_jax(family):
    name, j, api, params, tokens = family
    logits, state = api.prefill(params, {"tokens": tokens}, MAX_LEN)
    close(logits, j["prefill"], 1e-4, f"{name} prefill logits")
    _state_matches(name, state, j["state"], "prefill state")
    assert state.pos == S


def test_teacher_forced_decode_matches_jax(family):
    """8 decode steps fed the JAX run's greedy tokens, so that a near-tie
    in an argmax cannot fork the two runs."""
    name, j, api, params, tokens = family
    fed = torch.from_numpy(j["fed"]).long()
    _, steps, _ = serve_lm.generate(api, params, tokens, STEPS, forced=fed)
    close(steps[:, 0], j["prefill"], 1e-4, f"{name} prefill")
    close(steps[:, 1:], j["steps"], 1e-4, f"{name} decode logits")
    _, state = api.prefill(params, {"tokens": tokens}, MAX_LEN)
    for i in range(STEPS):
        _, state = api.decode(params, fed[:, i], state)
    _state_matches(name, state, j["final_state"], "state after decode")


def test_port_prefill_matches_its_forward(family):
    """The JAX package's own invariant (tests/test_archs_smoke.py:48)."""
    name, _, api, params, tokens = family
    full = api.forward(params, {"tokens": tokens})
    pre, _ = api.prefill(params, {"tokens": tokens}, MAX_LEN)
    torch.testing.assert_close(pre, full[:, -1], rtol=2e-3, atol=2e-3)


def test_port_recurrent_decode_matches_teacher_forcing(family):
    """Prefilling one token and decoding the rest token by token
    reproduces the forward logits (tests/test_archs_smoke.py:79; here for
    the dense, ssm and hybrid families)."""
    name, _, api, params, tokens = family
    if api.cfg.family == "moe":
        pytest.skip("an MoE model routes a decode token in a group of B "
                    "tokens and a forward token in a group of moe_group: "
                    "capacity differs, so the identity does not hold (the "
                    "reference holds it only for ssm and hybrid, "
                    "tests/test_archs_smoke.py:78)")
    toks = tokens[:1, :8]
    full = api.forward(params, {"tokens": toks})
    lg, state = api.prefill(params, {"tokens": toks[:, :1]}, 16)
    dec = [lg]
    for t in range(1, toks.shape[1]):
        lg, state = api.decode(params, toks[:, t], state)
        dec.append(lg)
    torch.testing.assert_close(torch.stack(dec, 1), full, rtol=4e-3,
                               atol=4e-3)


# ---------------------------------------------------------------------------
# Harness.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ARCHS)
def test_init_cache_matches_jax_init_cache(name):
    """``ModelAPI.init_cache``: the JAX package's leaves (shapes, dtypes,
    all zeros) with the write position at max_len - 1."""
    want = jget_api(jreg.get_config(name)).init_cache(2, 24)
    got = tzoo.get_api(treg.get_config(name)).init_cache(2, 24, "cpu")
    _state_matches(name, got, [np.asarray(x) for x in
                               jax.tree_util.tree_leaves(want)], "init_cache")
    assert got.pos == 23


@pytest.mark.parametrize("name", ARCHS)
def test_port_init_matches_jax_init_distributions(name):
    """The port's own init draws the JAX package's distributions: same
    tree, shapes and dtypes; the same leaves are all zeros or all ones;
    every normal leaf's std within 10 % of the JAX leaf's."""
    jcfg, tcfg = jreg.get_config(name), treg.get_config(name)
    jp, _ = jC.split_tree(jget_api(jcfg).init(jax.random.PRNGKey(0)))
    tp = tzoo.get_api(tcfg).init(torch.Generator().manual_seed(0), "cpu")
    jl = jax.tree_util.tree_leaves(jp)
    tl = flat(tp)
    assert len(jl) == len(tl)
    for i, (a, b) in enumerate(zip(jl, tl)):
        a = np.asarray(a)
        assert a.shape == tuple(b.shape) and b.dtype == torch.float32, i
        for const in (0.0, 1.0):
            assert np.all(a == const) == bool((b == const).all()), i
        if a.std() > 0:
            assert abs(float(b.std()) / a.std() - 1) < 0.1, (i, a.shape)


@pytest.mark.parametrize("name", ARCHS + [n.removesuffix("-smoke")
                                          for n in ARCHS])
def test_from_arrays_round_trips_every_leaf(name):
    """Every leaf of the JAX package's value tree (shapes only, full
    widths included) maps to a port leaf of the same shape and dtype,
    and a wrong tree is refused."""
    jcfg, tcfg = jreg.get_config(name), treg.get_config(name)
    shapes = jax.eval_shape(lambda k: jC.split_tree(
        jget_api(jcfg).init(k))[0], jax.random.PRNGKey(0))
    if name.endswith("-smoke"):
        arrays = jax.tree_util.tree_map(
            lambda s: np.full(s.shape, 0.5, s.dtype), shapes)
        got = tzoo.from_arrays(tcfg, arrays)
        for a, b in zip(jax.tree_util.tree_leaves(arrays), flat(got)):
            assert a.shape == tuple(b.shape) and b.dtype == torch.float32
            assert np.array_equal(a, b.numpy())
        arrays["embed"]["out"] = arrays["embed"]["out"][:, :3]
        with pytest.raises(ValueError, match="embed/out"):
            tzoo.from_arrays(tcfg, arrays)
    want = tzoo.get_api(tcfg).init(None, "meta")
    for a, b in zip(jax.tree_util.tree_leaves(shapes), flat(want)):
        assert a.shape == tuple(b.shape) and DTYPES[a.dtype.type] == b.dtype


@pytest.mark.parametrize("name,family", [
    ("seamless-m4t-large-v2-smoke", "encdec"),
    ("internvl2-1b-smoke", "vlm")])
def test_unported_families_raise(name, family):
    with pytest.raises(NotImplementedError, match=f"{family}.*later slice"):
        tzoo.get_api(treg.get_config(name))


def test_lm_entry_points_raise_without_a_card_unless_cpu(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_lm.serve("qwen2.5-3b-smoke")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_lm.main(["--arch", "rwkv6-7b-smoke"])
    assert capsys.readouterr().out == ""


def test_serve_lm_runs_on_the_cpu(capsys):
    toks = serve_lm.serve("zamba2-7b-smoke", batch=2, prompt_len=16, gen=4,
                          device="cpu")
    assert toks.shape == (2, 4) and toks.dtype == np.int64
    assert ((toks >= 0) & (toks < 512)).all()
    serve_lm.main(["--arch", "qwen2.5-3b-smoke", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "zamba2-7b-smoke" in out and "qwen2.5-3b-smoke" in out
    assert out.count("tok/s") == 2 and "(4, 16)" in out


@pytest.mark.parametrize("arch", ["mixtral-8x7b-smoke",
                                  "llama4-maverick-400b-a17b-smoke"])
def test_serve_lm_serves_the_moe_smoke_archs_on_the_cpu(arch, capsys):
    """``serve`` takes the MoE configs unchanged (``ARCHS`` stays the
    JAX example's three, which name no MoE arch)."""
    assert arch not in serve_lm.ARCHS
    toks = serve_lm.serve(arch, batch=3, prompt_len=30, gen=4, device="cpu")
    assert toks.shape == (3, 4) and toks.dtype == np.int64
    assert ((toks >= 0) & (toks < 512)).all()
    assert arch in capsys.readouterr().out
