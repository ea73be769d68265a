"""Parity of the port's LM kernel modules (flash attention, RWKV6 WKV,
Mamba2 SSD) with the JAX package.

On the CPU the port's ``mha``/``wkv``/``ssd`` take their plain versions
(``ref.py``); the JAX side runs its oracles, its chunked jnp forms and its
Pallas kernels in interpret mode, as its own tests do. Tolerances:

* flash attention, f32: rtol = atol = 2e-5, the reference's own bound
  for its kernel against ``mha_ref`` (tests/test_kernels.py);
* WKV and SSD plain chunked versions against ``wkv_chunked`` /
  ``ssd_chunked``: 1e-4 (``CHUNKED_TOL``), the same algorithm in f32. Not
  1e-5: the log-space cumsum of a chunk's decays reaches |cum| ~ 56
  (f32 ulp 3.8e-6) and JAX on the CPU sums it as an associative scan,
  torch sequentially, so the exponentiated pairwise decays differ by
  ~1e-5 relative; on these inputs JAX's own chunked form departs from
  its naive scan by up to 3.3e-5, and the port's from JAX's by up to
  3.9e-5. 1e-4 is half the reference's own chunked-vs-scan bound;
* against the naive scans and the interpret-mode Pallas kernels: the
  reference's 2e-4 (WKV) and 3e-4 (SSD), the chunked form's rounding
  against a per-token scan; the strong-decay case at the reference's
  atol 1e-4 (tests/test_kernels.py:81);
* ``wkv_decode_step``: 1e-5.

The CUDA kernels themselves are held to their plain versions on the card
(``chip_smoke.py`` and the card-only tests at the end).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as j_flash
from repro.kernels.flash_attention import mha_ref as j_mha_ref
from repro.kernels.mamba2_ssd import ssd_chunked as j_ssd_chunked
from repro.kernels.mamba2_ssd import ssd_ref as j_ssd_ref
from repro.kernels.mamba2_ssd.mamba2_ssd import ssd_pallas as j_ssd_pallas
from repro.kernels.rwkv6_wkv import wkv_chunked as j_wkv_chunked
from repro.kernels.rwkv6_wkv import wkv_decode_step as j_wkv_decode_step
from repro.kernels.rwkv6_wkv import wkv_ref as j_wkv_ref
from repro.kernels.rwkv6_wkv.rwkv6_wkv import wkv_pallas as j_wkv_pallas
from repro_torch import kernels
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import flash_attention as t_flash
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.mamba2_ssd import mamba2_ssd as t_ssd
from repro_torch.kernels.mamba2_ssd import ops as ssd_ops
from repro_torch.kernels.mamba2_ssd import ref as ssd_ref
from repro_torch.kernels.power_topo import power_topo
from repro_torch.kernels.rwkv6_wkv import ops as wkv_ops
from repro_torch.kernels.rwkv6_wkv import ref as wkv_ref
from repro_torch.kernels.rwkv6_wkv import rwkv6_wkv as t_wkv

from test_torch_common import as_np

torch.set_num_threads(1)

T = torch.from_numpy
J = jnp.asarray


CHUNKED_TOL = 1e-4


def close(got, want, tol, what=""):
    np.testing.assert_allclose(as_np(got), np.asarray(want), rtol=tol,
                               atol=tol, err_msg=what)


# ---------------------------------------------------------------------------
# Inputs (numpy, from a seed; the reference test's distributions).
# ---------------------------------------------------------------------------
def attn_inputs(B, S, Tk, H, KV, hd, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, H, hd), np.float32),
            rng.standard_normal((B, Tk, KV, hd), np.float32),
            rng.standard_normal((B, Tk, KV, hd), np.float32))


def wkv_inputs(B, S, H, hd, seed):
    rng = np.random.default_rng(seed)
    n = lambda *shape: rng.standard_normal(shape, np.float32)
    w = 1.0 / (1.0 + np.exp(-(n(B, S, H, hd) - 1.0))) * 0.97 + 0.02
    return (n(B, S, H, hd) * 0.5, n(B, S, H, hd) * 0.5, n(B, S, H, hd),
            w.astype(np.float32), n(H, hd) * 0.3)


def ssd_inputs(Bz, S, H, P, N, seed):
    rng = np.random.default_rng(seed)
    n = lambda *shape: rng.standard_normal(shape, np.float32)
    sp = lambda z: np.log1p(np.exp(z)).astype(np.float32)
    return (n(Bz, S, H, P), sp(n(Bz, S, H)),
            np.exp(-sp(n(Bz, S, H))).astype(np.float32),
            n(Bz, S, N) * 0.5, n(Bz, S, N) * 0.5)


# ---------------------------------------------------------------------------
# Flash attention.
# ---------------------------------------------------------------------------
FLASH_CASES = [  # B, S, T, H, KV, hd, causal, window
    (1, 128, 128, 2, 2, 64, True, 0),       # MHA, causal
    (2, 128, 128, 4, 2, 112, True, 0),      # GQA, zamba2's head dim
    (1, 128, 128, 8, 2, 128, True, 0),      # GQA, qwen's head dim
    (1, 256, 256, 2, 2, 64, True, 64),      # sliding window
    (1, 128, 128, 4, 2, 64, False, 0),      # non-causal
    (1, 64, 192, 4, 2, 64, True, 0),        # S != T, right-aligned
]


@pytest.mark.parametrize("B,S,Tk,H,KV,hd,causal,window", FLASH_CASES)
def test_mha_plain_matches_jax_ref_and_interpret_kernel(
        B, S, Tk, H, KV, hd, causal, window):
    q, k, v = attn_inputs(B, S, Tk, H, KV, hd, seed=S + hd + H)
    got = fa_ops.mha(T(q), T(k), T(v), causal, window)
    assert got.shape == (B, S, H, hd) and got.dtype == torch.float32
    close(got, j_mha_ref(J(q), J(k), J(v), causal, window), 2e-5, "mha_ref")
    bq = min(64, S)
    close(got, j_flash(J(q), J(k), J(v), causal, window, bq, 64, True),
          2e-5, "flash_attention(interpret)")


@pytest.mark.parametrize("S,Tk,window", [(37, 37, 0), (50, 20, 0),
                                         (45, 90, 16)])
def test_mha_plain_ragged_and_blind_rows_match_jax_ref(S, Tk, window):
    """Shapes the Pallas kernel refuses (S, T not multiples of its tile)
    and S > T, where the first causal rows see no key at all and the
    reference averages every value."""
    q, k, v = attn_inputs(2, S, Tk, 4, 2, 32, seed=S * Tk)
    got = fa_ops.mha(T(q), T(k), T(v), True, window)
    close(got, j_mha_ref(J(q), J(k), J(v), True, window), 2e-5)


# ---------------------------------------------------------------------------
# WKV.
# ---------------------------------------------------------------------------
WKV_CASES = [(1, 32, 1, 8, 8), (2, 64, 3, 16, 16), (1, 128, 2, 64, 32)]


@pytest.mark.parametrize("B,S,H,hd,chunk", WKV_CASES)
def test_wkv_plain_matches_jax_chunked_ref_and_interpret_kernel(
        B, S, H, hd, chunk):
    r, k, v, w, u = wkv_inputs(B, S, H, hd, seed=S + hd)
    y, s = wkv_ref.wkv_chunked(T(r), T(k), T(v), T(w), T(u), chunk)
    assert y.shape == (B, S, H, hd) and s.shape == (B, H, hd, hd)
    jy, js = j_wkv_chunked(J(r), J(k), J(v), J(w), J(u), chunk)
    close(y, jy, CHUNKED_TOL, "y vs wkv_chunked")
    close(s, js, CHUNKED_TOL, "state vs wkv_chunked")
    ry, rs = j_wkv_ref(J(r), J(k), J(v), J(w), J(u))
    close(y, ry, 2e-4, "y vs wkv_ref")
    close(s, rs, 2e-4, "state vs wkv_ref")
    py, _ = j_wkv_pallas(J(r), J(k), J(v), J(w), J(u), chunk=chunk,
                         interpret=True)
    close(y, py, 3e-4, "y vs wkv_pallas(interpret)")
    # the port's naive scan is the reference's
    ty, ts = wkv_ref.wkv_ref(T(r), T(k), T(v), T(w), T(u))
    close(ty, ry, 1e-5, "wkv_ref y")
    close(ts, rs, 1e-5, "wkv_ref state")


def test_wkv_plain_bf16_keeps_dtype_and_f32_state():
    r, k, v, w, u = wkv_inputs(1, 64, 2, 16, seed=5)
    bf = lambda a: T(a).to(torch.bfloat16)
    y, s = wkv_ref.wkv_chunked(bf(r), bf(k), bf(v), T(w), T(u), 16)
    assert y.dtype == torch.bfloat16 and s.dtype == torch.float32
    ry, rs = j_wkv_chunked(*(J(as_np(bf(a).float())) for a in (r, k, v)),
                           J(w), J(u), 16)
    close(y.float(), np.asarray(ry, np.float32), 1e-2, "y (bf16 ulp)")
    close(s, rs, CHUNKED_TOL, "state")


def test_wkv_strong_decay_is_stable():
    """Near-zero decay: the chunked form masks before the exp."""
    r, k, v, w, u = wkv_inputs(1, 64, 1, 8, seed=0)
    w = np.full_like(w, 1e-6)
    y, s = wkv_ref.wkv_chunked(T(r), T(k), T(v), T(w), T(u), 16)
    assert torch.isfinite(y).all() and torch.isfinite(s).all()
    ry, rs = j_wkv_ref(J(r), J(k), J(v), J(w), J(u))
    np.testing.assert_allclose(as_np(y), np.asarray(ry), atol=1e-4)
    np.testing.assert_allclose(as_np(s), np.asarray(rs), atol=1e-4)


def test_wkv_plain_runs_in_float64_for_the_card_checks():
    """float64 inputs compute and return float64: the reference the card
    holds the WKV kernels to. It matches a float64 per-token scan to
    1e-9 under strong decay (w log-uniform down to 1e-30, channels at
    exactly 1 and 0), where the float32 chunked form, as the JAX
    package's, misses y by more than the 2e-4 tolerance (its log-space
    cumsum reaches |cum| ~ 2,000 in a chunk); on the reference
    distribution it equals the float32 form at ``CHUNKED_TOL``."""
    args = [T(a) for a in wkv_inputs(1, 128, 2, 64, seed=3)]
    y32, s32 = wkv_ref.wkv_chunked(*args)
    y64, s64 = wkv_ref.wkv_chunked(*(a.double() for a in args))
    assert y64.dtype == s64.dtype == torch.float64
    close(y64, as_np(y32), CHUNKED_TOL, "y, float64 vs float32")
    close(s64, as_np(s32), CHUNKED_TOL, "state, float64 vs float32")

    rng = np.random.default_rng(3)
    w = 10.0 ** (-30.0 * rng.uniform(0.0, 1.0, (1, 128, 2, 64)))
    w[..., 3::8], w[..., 5::8] = 1.0, 0.0
    args[3] = T(w.astype(np.float32))
    r, k, v, w, u = (a.double() for a in args)
    s = torch.zeros((1, 2, 64, 64), dtype=torch.float64)
    ys = []
    for t in range(128):                       # per-token scan, float64
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]
        ys.append(torch.einsum("bhi,bhij->bhj", r[:, t],
                               s + u[None, :, :, None] * kv))
        s = torch.clamp(w[:, t], 1e-38, 1.0)[..., None] * s + kv
    y_scan = torch.stack(ys, 1)
    y64, s64 = wkv_ref.wkv_chunked(r, k, v, w, u)
    torch.testing.assert_close(y64, y_scan, rtol=1e-9, atol=1e-9)
    torch.testing.assert_close(s64, s, rtol=1e-9, atol=1e-9)
    y32, _ = wkv_ref.wkv_chunked(*args)
    miss = (y32.double() - y_scan).abs() - 2e-4 * (1 + y_scan.abs())
    assert float(miss.max()) > 0


def test_wkv_plain_ragged_sequence_matches_jax_ref():
    """S = 45 is no multiple of the chunk: the padded tail leaves y and
    the final state as the naive scan has them."""
    r, k, v, w, u = wkv_inputs(2, 45, 2, 16, seed=45)
    y, s = wkv_ref.wkv_chunked(T(r), T(k), T(v), T(w), T(u), 16)
    ry, rs = j_wkv_ref(J(r), J(k), J(v), J(w), J(u))
    close(y, ry, 2e-4, "y")
    close(s, rs, 2e-4, "state")


def test_wkv_decode_step_matches_jax():
    rng = np.random.default_rng(9)
    B, H, hd = 2, 3, 16
    r, k, v = (rng.standard_normal((B, H, hd), np.float32) for _ in "rkv")
    w = rng.uniform(0.1, 0.99, (B, H, hd)).astype(np.float32)
    u = rng.standard_normal((H, hd), np.float32)
    st = rng.standard_normal((B, H, hd, hd), np.float32)
    y, s = wkv_ops.wkv_decode_step(*(T(a) for a in (r, k, v, w, u, st)))
    jy, js = j_wkv_decode_step(*(J(a) for a in (r, k, v, w, u, st)))
    close(y, jy, 1e-5, "y")
    close(s, js, 1e-5, "state")


# ---------------------------------------------------------------------------
# SSD.
# ---------------------------------------------------------------------------
SSD_CASES = [(1, 32, 1, 8, 4, 8), (2, 128, 3, 16, 8, 32),
             (1, 64, 2, 64, 64, 64), (1, 128, 2, 64, 16, 64)]


@pytest.mark.parametrize("Bz,S,H,P,N,chunk", SSD_CASES)
def test_ssd_plain_matches_jax_chunked_ref_and_interpret_kernel(
        Bz, S, H, P, N, chunk):
    x, dt, a, B, C = ssd_inputs(Bz, S, H, P, N, seed=S + N)
    y, s = ssd_ref.ssd_chunked(T(x), T(dt), T(a), T(B), T(C), chunk)
    assert y.shape == (Bz, S, H, P) and s.shape == (Bz, H, P, N)
    jy, js = j_ssd_chunked(J(x), J(dt), J(a), J(B), J(C), chunk)
    close(y, jy, CHUNKED_TOL, "y vs ssd_chunked")
    close(s, js, CHUNKED_TOL, "state vs ssd_chunked")
    ry, rs = j_ssd_ref(J(x), J(dt), J(a), J(B), J(C))
    close(y, ry, 3e-4, "y vs ssd_ref")
    close(s, rs, 3e-4, "state vs ssd_ref")
    if S % chunk == 0:
        py = j_ssd_pallas(J(x), J(dt), J(a), J(B), J(C), chunk=chunk,
                          interpret=True)
        close(y, py, 3e-4, "y vs ssd_pallas(interpret)")
    ty, ts = ssd_ref.ssd_ref(T(x), T(dt), T(a), T(B), T(C))
    close(ty, ry, 1e-5, "ssd_ref y")
    close(ts, rs, 1e-5, "ssd_ref state")


def test_ssd_strong_decay_and_ragged_sequence():
    """Near-zero decay stays finite; S = 45 (no multiple of the chunk)
    matches the naive scan."""
    x, dt, a, B, C = ssd_inputs(2, 45, 3, 16, 8, seed=7)
    for a_ in (a, np.full_like(a, 1e-6)):
        y, s = ssd_ref.ssd_chunked(T(x), T(dt), T(a_), T(B), T(C), 16)
        assert torch.isfinite(y).all() and torch.isfinite(s).all()
        ry, rs = j_ssd_ref(J(x), J(dt), J(a_), J(B), J(C))
        close(y, ry, 3e-4, "y")
        close(s, rs, 3e-4, "state")


# ---------------------------------------------------------------------------
# Wrappers, build helper, card.
# ---------------------------------------------------------------------------
def test_cpu_dispatch_is_the_plain_chunked_form_and_launches_nothing():
    """A CPU tensor takes the plain version at the reference's chunk (32
    for WKV, 64 for SSD), bit for bit, and no kernel is counted."""
    before = dict(kernels.LAUNCHES)
    args = [T(a) for a in wkv_inputs(2, 45, 2, 16, seed=3)]
    for got, want in zip(wkv_ops.wkv(*args),
                         wkv_ref.wkv_chunked(*args, 32)):
        assert torch.equal(got, want)
    args = [T(z) for z in ssd_inputs(2, 45, 3, 16, 8, seed=3)]
    for got, want in zip(ssd_ops.ssd(*args),
                         ssd_ref.ssd_chunked(*args, 64)):
        assert torch.equal(got, want)
    assert kernels.LAUNCHES == before


def test_lm_kernel_wrappers_reject_bad_inputs():
    """The CUDA wrappers check dtype, shape and device before anything
    else, and never take a CPU tensor (the CPU path is the plain one)."""
    q, k, v = (T(a) for a in attn_inputs(1, 8, 8, 4, 2, 16, seed=1))
    for args, match in [((q.double(), k, v), "float32 or bfloat16"),
                        ((q, k.to(torch.bfloat16), v), "float32 or bfloat16"),
                        ((q, k[:, :, :1], v), "shape"),
                        ((q[..., :8], k, v), "shape"),
                        ((q[0], k, v), "4-d"),
                        ((q, k, v), "CUDA")]:
        with pytest.raises(ValueError, match=match):
            t_flash.flash_attention_cuda(*args)
    big = T(np.zeros((1, 4, 2, 160), np.float32))
    with pytest.raises(ValueError, match="hd <= 128"):
        t_flash.flash_attention_cuda(big, big, big)
    with pytest.raises(ValueError, match="multiple of KV"):
        t_flash.flash_attention_cuda(q[:, :, :3], k, v)
    # bfloat16 goes to the tensor-core kernel, whose k-step is 16 wide
    for hd in (8, 24, 120):
        odd = T(np.zeros((1, 4, 2, hd), np.float32)).to(torch.bfloat16)
        with pytest.raises(ValueError, match="multiple of 16"):
            t_flash.flash_attention_cuda(odd, odd, odd)

    r, kk, vv, w, u = (T(a) for a in wkv_inputs(1, 8, 2, 16, seed=1))
    for args, match in [((r, kk, vv, w, u[:1]), "shape"),
                        ((r, kk, vv, w.double(), u), "float32"),
                        ((r, kk.to(torch.bfloat16), vv, w, u),
                         "float32 or bfloat16"),
                        ((r[..., :12], kk[..., :12], vv[..., :12],
                          w[..., :12], u[:, :12]), "hd in"),
                        ((r, kk, vv, w, u), "CUDA")]:
        with pytest.raises(ValueError, match=match):
            t_wkv.wkv_cuda(*args)

    x, dt, a, B, C = (T(z) for z in ssd_inputs(1, 8, 2, 16, 8, seed=1))
    for args, match in [((x, dt, a, B[..., :4], C), "shape"),
                        ((x, dt[:, :4], a, B, C), "shape"),
                        ((x, dt, a.double(), B, C), "float32"),
                        ((x, dt, a, B.to(torch.bfloat16), C),
                         "float32 or bfloat16"),
                        ((x, dt, a, B[..., :6], C[..., :6]), "N in"),
                        ((x, dt, a, B, C), "CUDA")]:
        with pytest.raises(ValueError, match=match):
            t_ssd.ssd_cuda(*args)


def test_every_kernel_family_shares_the_build_helper():
    """One ``_build.Library`` per family, every source in its csrc/, one
    library per source under the family's ignored build/ directory, and
    a launch counter per kernel."""
    libs = (power_topo.LIB, t_flash.LIB, t_wkv.LIB, t_ssd.LIB)
    names = [n for lib in libs for n in lib.names]
    assert names == ["fused_cooling", "group_power", "flash_attention",
                     "flash_attention_tc", "wkv", "wkv_tc", "ssd"]
    assert set(kernels.LAUNCHES) == set(names)
    for lib in libs:
        for name in lib.names:
            src, out = lib.target(name)
            assert src.is_file() and src.parent == lib.here / "csrc"
            assert out.parent == lib.here / "build"
            assert out.name.startswith(f"lib{name}-") and out.suffix == ".so"
            # device pointers and sizes (or a struct of them), then the
            # stream
            assert len(lib.argtypes[name]) >= 5
            assert lib.argtypes[name][-1] is _build.P


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernel has no CPU mode")


def test_flash_kernel_matches_plain_version_on_the_card():
    """bf16 at rtol = atol = 1e-2 (one bf16 ulp), f32 at 2e-5."""
    _needs_card()
    for dt, tol in ((torch.bfloat16, 1e-2), (torch.float32, 2e-5)):
        for B, S, Tk, H, KV, hd, causal, window in FLASH_CASES:
            q, k, v = (T(a).cuda().to(dt) for a in
                       attn_inputs(B, S, Tk, H, KV, hd, seed=hd))
            got = fa_ops.mha(q, k, v, causal, window)
            want = fa_ref.mha_ref(q, k, v, causal, window)
            torch.cuda.synchronize()
            torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                       atol=tol)


def test_wkv_kernel_matches_plain_version_on_the_card():
    """Against the plain chunked form run in float64 (in float32 its
    log-space cumsum loses precision under strong decay): f32 (the
    recurrence) at 2e-4; bf16 (the chunked tensor-core kernel) y at 1e-2
    (one bf16 ulp) and the f32 state at 2e-4. The last case is strong
    decay: w log-uniform down to 1e-30, some channels at exactly 1 and
    some at exactly 0."""
    _needs_card()
    rng = np.random.default_rng(17)
    strong = 10.0 ** (-30.0 * rng.uniform(0.0, 1.0, (2, 512, 2, 64)))
    strong[..., 3::8], strong[..., 5::8] = 1.0, 0.0
    cases = [(wkv_inputs(B, S, H, hd, seed=S), "")
             for B, S, H, hd in ((4, 512, 64, 64), (2, 45, 3, 16),
                                 (2, 7, 3, 8), (2, 65, 2, 32))]
    r, k, v, _, u = wkv_inputs(2, 512, 2, 64, seed=17)
    cases.append(((r, k, v, strong.astype(np.float32), u), "strong decay"))
    for dt, y_tol in ((torch.float32, 2e-4), (torch.bfloat16, 1e-2)):
        for arrays, label in cases:
            r, k, v, w, u = (T(a).cuda() for a in arrays)
            args = (r.to(dt), k.to(dt), v.to(dt), w, u)
            (y, st), (y0, st0) = wkv_ops.wkv(*args), \
                wkv_ref.wkv_chunked(*(z.double() for z in args))
            torch.cuda.synchronize()
            assert y.dtype == dt and st.dtype == torch.float32, label
            torch.testing.assert_close(y.float(), y0.to(dt).float(),
                                       rtol=y_tol, atol=y_tol)
            torch.testing.assert_close(st, st0.float(), rtol=2e-4, atol=2e-4)


def test_ssd_kernel_matches_plain_version_on_the_card():
    """3e-4 in both dtypes: f32 x, B, C run the recurrence, bf16 ones the
    chunked tensor-core kernel (outputs f32 in both)."""
    _needs_card()
    for dt_ in (torch.float32, torch.bfloat16):
        for Bz, S, H, P, N in ((4, 512, 112, 64, 64), (2, 45, 7, 64, 16),
                               (2, 65, 3, 64, 64)):
            x, dt, a, B, C = (T(z).cuda() for z in
                              ssd_inputs(Bz, S, H, P, N, seed=S))
            args = (x.to(dt_), dt, a, B.to(dt_), C.to(dt_))
            for got, want in zip(ssd_ops.ssd(*args),
                                 ssd_ref.ssd_chunked(*args)):
                torch.cuda.synchronize()
                torch.testing.assert_close(got, want, rtol=3e-4, atol=3e-4)
