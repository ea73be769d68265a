"""The launch plan and the order of the adds of the power-topology kernels
(``src/repro_torch/kernels/power_topo/csrc/segment_sum.cuh``), on the CPU.

The CUDA kernels run only on the card (``chip_smoke.py`` holds them to
their plain versions there). What is checked here is what decides their
numbers: ``power_topo.plan`` (who sums which nodes) and a numpy float32
emulation of the kernels' order of adds (each thread's quads in order, a
warp's xor butterfly, a CTA's butterfly over its warp partials).
Tolerances, unchanged from
``chip_smoke.py``: rtol 1e-5 and atol 1e-3 W for the group sums against
the plain versions (another order of float32 adds; the reference's rtol,
1 mW), the same against a float64 sum, and rtol = atol = 1e-4 for the
fused cooling step (the reference's kernel bound). A row of a batch must
equal a solo row bit for bit. Also here: the build digest, which covers
the shared header, and the wrappers' refusals.
"""
import ctypes
import re
import shutil

import numpy as np
import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.power_topo import ops as tops
from repro_torch.kernels.power_topo import power_topo as pt
from repro_torch.kernels.power_topo import ref as tref

torch.set_num_threads(1)

HEADER = pt.LIB.here / "csrc" / "segment_sum.cuh"
GROUP_TOL = dict(rtol=1e-5, atol=1e-3)
FUSED_TOL = dict(rtol=1e-4, atol=1e-4)
PARAMS = tref.CduParams(cp_j_kg_k=4186.0, ua_w_k=4e5, dt=15.0,
                        tau_hx_s=120.0, tau_valve_s=60.0,
                        delta_t_design_c=8.0, mdot_min_kg_s=8.0,
                        mdot_max_kg_s=40.0)
# (N, G): the repo's systems (Frontier, Fugaku, Fugaku cut to the 32,768
# nodes benchmarks/fig10_ml.py sweeps, Marconi100, Lassen, Adastra), a
# ragged span, an empty last group, three empty groups, one group past
# 8,192 nodes (several rounds)
SHAPES = {"frontier": (9600, 25), "fugaku": (158976, 32),
          "fugaku-32k": (32768, 7), "marconi100": (980, 10),
          "lassen": (792, 8), "adastra": (356, 4), "ragged": (9601, 25),
          "empty-last": (9, 4), "empty-three": (10, 8),
          "rounds": (70000, 1)}


def thread_nodes(plan, N, G):
    """int64[G, T, K]: the node (index in a row) that thread t of the warp
    (or CTA) of group g adds k-th; -1 where it adds none. The kernels'
    indexing (segment_sum.cuh ``thread_sums``): quads t + j * T of the
    group, each quad's four nodes in order, masked at the group's end."""
    T = plan.unit_threads
    g = np.arange(G)[:, None, None]
    t = np.arange(T)[None, :, None]
    j = np.arange(plan.rounds * pt.QUADS_PER_THREAD)[None, None, :]
    lo = g * plan.span
    n = np.clip(np.minimum(lo + plan.span, N) - lo, 0, None)
    q = t + j * T
    k = 4 * q[..., None] + np.arange(4)
    ok = (q < (n + 3) // 4)[..., None] & (k < n[..., None])
    return np.where(ok, lo[..., None] + k, -1).reshape(G, T, -1)


def grid(plan, S, G):
    """(blocks along x, blocks along y, threads a block) of a launch over
    S rows, as segment_sum.cuh ``launch_vec`` forms it: the only part of
    a launch that depends on S."""
    if plan.unit_threads == 32:
        return -(-S * G // pt.WARP_BLOCK_WARPS), 1, 32 * pt.WARP_BLOCK_WARPS
    return G, S, pt.CTA_THREADS


def butterfly(v, width):
    """Lane 0 after an xor butterfly over the last axis (``width`` lanes,
    offsets width/2 .. 1), in float32."""
    lanes = np.arange(width)
    off = width // 2
    while off:
        v = v + v[..., lanes ^ off]
        off //= 2
    return v[..., 0]


def emulate(x, G, idle=None):
    """The kernels' sums of float32[S, N] node powers in their order: the
    group sums f32[S, G], or (split) the sums of min(p, idle) and of the
    rest."""
    S, N = x.shape
    plan = pt.plan(N, G)
    nodes = thread_nodes(plan, N, G)
    valid = nodes >= 0
    vals = np.where(valid, x[:, np.maximum(nodes, 0)], np.float32(0))
    if idle is None:
        streams = [vals]
    else:
        floor = np.minimum(vals, np.float32(idle))
        streams = [floor, vals - floor]
    out = []
    for v in streams:
        acc = np.zeros(v.shape[:-1], np.float32)          # [S, G, T]
        for k in range(v.shape[-1]):
            acc = np.where(valid[..., k], acc + v[..., k], acc)
        W = plan.unit_threads // 32
        warp = butterfly(acc.reshape(*acc.shape[:-1], W, 32), 32)
        out.append(butterfly(warp, W))                    # [S, G]
    return out[0] if idle is None else tuple(out)


def _powers(S, N, seed, lo=700.0, hi=3200.0):
    return np.random.default_rng(seed).uniform(lo, hi, (S, N)).astype(
        np.float32)


# ---------------------------------------------------------------------------
# The plan.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", list(SHAPES))
def test_plan_covers_every_node_once(case):
    """Every (row, group) is reduced by exactly one warp or one CTA, and
    within a group every node is added by exactly one thread, once."""
    N, G = SHAPES[case]
    plan = pt.plan(N, G)
    S = 3
    bx, by, threads = grid(plan, S, G)
    assert plan.quads == -(-plan.span // 4)
    if plan.unit_threads == 32:
        assert plan.rounds == 1
        assert threads == 32 * pt.WARP_BLOCK_WARPS and by == 1
        pairs = (np.arange(bx)[:, None] * pt.WARP_BLOCK_WARPS +
                 np.arange(pt.WARP_BLOCK_WARPS)).ravel()
        pairs = pairs[pairs < S * G]
        assert np.array_equal(np.sort(pairs), np.arange(S * G))
    else:
        # block (g, s): each group once per row
        assert (bx, by, threads) == (G, S, pt.CTA_THREADS)
        assert plan.unit_threads == pt.CTA_THREADS
    nodes = thread_nodes(plan, N, G)
    added = nodes[nodes >= 0]
    assert np.array_equal(np.sort(added), np.arange(N))
    gid = tref.group_ids(N, G)
    for g in range(G):
        mine = nodes[g][nodes[g] >= 0]
        assert (gid[mine] == g).all()
    assert (nodes >= 0).sum(-1).max() <= 4 * pt.QUADS_PER_THREAD * \
        plan.rounds


@pytest.mark.parametrize("case", list(SHAPES))
def test_plan_depends_on_n_and_g_only(case):
    """The plan takes no S; what the C side receives for S = 1 and
    S = 12 differs only in the row count, and the grid grows by rows (or
    by (row, group) pairs) without changing any group's threads."""
    N, G = SHAPES[case]
    one, twelve = (pt._plan_struct(S, N, G) for S in (1, 12))
    fields = [f for f, _ in pt._Plan._fields_ if f != "n_scen"]
    assert [getattr(one, f) for f in fields] == \
        [getattr(twelve, f) for f in fields]
    assert (one.n_scen, twelve.n_scen) == (1, 12)
    plan = pt.plan(N, G)
    assert pt.plan(N, G) is plan                 # cached: one per (N, G)
    if plan.unit_threads > 32:
        assert grid(plan, 12, G)[0] == grid(plan, 1, G)[0]


@pytest.mark.parametrize("N,G", [(9600, 25), (158976, 32), (980, 10),
                                 (9601, 25), (9, 4), (9604, 2), (9602, 2),
                                 (64, 4), (66, 3), (12, 4), (8, 1)])
def test_vector_path_only_when_every_group_is_16_byte_aligned(N, G):
    """128-bit loads exactly when N % 4 == 0 and span % 4 == 0: then every
    row and every group starts on a 16-byte boundary and every quad the
    threads take is whole."""
    plan = pt.plan(N, G)
    span = -(-N // G)
    assert plan.span == span
    assert plan.vector == (N % 4 == 0 and span % 4 == 0)
    if plan.vector:
        nodes = thread_nodes(plan, N, G)
        quads = nodes.reshape(*nodes.shape[:-1], -1, 4)
        first = quads[..., 0]
        taken = first >= 0
        assert (first[taken] % 4 == 0).all()
        assert (quads[taken] >= 0).all()        # no partial quad


def test_vector_loads_follow_the_rows_alignment():
    """``_vec`` asks for 128-bit loads only where the plan allows them and
    the first row starts on a 16-byte boundary (the adds are the same
    either way)."""
    whole = torch.zeros(8 * 9601 + 4)
    assert whole.data_ptr() % 16 == 0
    for rows, N, want in [(whole[:8 * 9600], 9600, 1),
                          (whole[1:8 * 9600 + 1], 9600, 0),
                          (whole[:8 * 9601], 9601, 0)]:
        x = rows.view(8, N)
        allowed = pt._group_args((8, N, 25), None)[2]
        assert allowed == pt.plan(N, 25).vector
        assert pt._vec(allowed, x.data_ptr()) == want


@pytest.mark.parametrize("N,G", [(0, 4), (16, 0), (-4, 2)])
def test_plan_refuses_empty_shapes(N, G):
    with pytest.raises(ValueError, match="N, G >= 1"):
        pt.plan(N, G)


# ---------------------------------------------------------------------------
# The order of the adds.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", list(SHAPES))
def test_emulated_group_sums_match_plain_versions(case):
    """Both modes of ``group_power`` in the kernels' order against
    ``group_power_ref``, ``group_power_split_ref`` and a float64 sum, with
    node powers on both sides of the idle floor (as chip_smoke.py)."""
    N, G = SHAPES[case]
    S, idle = 4, 700.0
    x = _powers(S, N, N + G, lo=0.0, hi=4.5 * idle)
    got = emulate(x, G)
    floor, dyn = emulate(x, G, idle)
    t = torch.from_numpy(x)
    want_floor, want_dyn = tref.group_power_split_ref(t, idle, G)
    for name, a, b in (("plain", got, tref.group_power_ref(t, G)),
                       ("floor", floor, want_floor), ("dyn", dyn, want_dyn)):
        assert a.dtype == np.float32 and a.shape == (S, G)
        np.testing.assert_allclose(a, b.numpy(), err_msg=name, **GROUP_TOL)
    gid = tref.group_ids(N, G)
    x64 = x.astype(np.float64)
    f64 = np.minimum(x64, idle)
    for name, a, v in (("plain", got, x64), ("floor", floor, f64),
                       ("dyn", dyn, x64 - f64)):
        exact = np.stack([np.bincount(gid, v[s], minlength=G)
                          for s in range(S)])
        np.testing.assert_allclose(a, exact, err_msg=name, **GROUP_TOL)


@pytest.mark.parametrize("case", list(SHAPES))
def test_emulated_fused_cooling_matches_plain_version(case):
    """The CDU update on the kernels' group sums against
    ``fused_cooling_ref`` (rtol = atol = 1e-4), basins per scenario."""
    N, G = SHAPES[case]
    S = 3
    rng = np.random.default_rng(G)
    x = _powers(S, N, N)
    ts = torch.from_numpy(rng.uniform(28.0, 40.0, (S, G)).astype(np.float32))
    md = torch.from_numpy(rng.uniform(12.0, 60.0, (S, G)).astype(np.float32))
    tb = torch.from_numpy(rng.uniform(18.0, 30.0, (S,)).astype(np.float32))
    tset = torch.from_numpy(rng.uniform(30.0, 34.0, (S,)).astype(np.float32))
    got = tref.cdu_update_ref(torch.from_numpy(emulate(x, G)), ts, md, tb,
                              tset, PARAMS)
    want = tref.fused_cooling_ref(torch.from_numpy(x), ts, md, tb, tset, G,
                                  PARAMS)
    for name, a, b in zip(("q", "t_return", "t_supply", "mdot"), got, want):
        torch.testing.assert_close(a, b, msg=name, **FUSED_TOL)


@pytest.mark.parametrize("case", list(SHAPES))
def test_row_of_a_batch_equals_a_solo_row(case):
    """Row i of an S = 12 batch sums to the same bits as that row alone,
    in both modes: the order is the plan's, and the plan is (N, G)'s."""
    N, G = SHAPES[case]
    x = _powers(12, N, 7 * N + G)
    batch = emulate(x, G)
    b_floor, b_dyn = emulate(x, G, 1000.0)
    for i in (0, 5, 11):
        solo = emulate(x[i:i + 1], G)
        floor, dyn = emulate(x[i:i + 1], G, 1000.0)
        for a, b in ((solo, batch), (floor, b_floor), (dyn, b_dyn)):
            assert np.array_equal(a[0].view(np.uint32), b[i].view(np.uint32))


# ---------------------------------------------------------------------------
# The C side's mirror, the build digest, the wrappers' refusals.
# ---------------------------------------------------------------------------
def test_python_mirror_matches_the_header():
    """``power_topo``'s constants and ``_Plan`` fields are the header's,
    and the argument structs have the C layout (natural alignment)."""
    src = HEADER.read_text()
    const = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    assert int(const["kQuads"]) == pt.QUADS_PER_THREAD
    assert int(const["kWarpBlockWarps"]) == pt.WARP_BLOCK_WARPS
    assert int(const["kCtaThreads"]) == pt.CTA_THREADS
    body = re.search(r"struct Plan \{(.*?)\};", src, re.S)[1]
    assert re.findall(r"int (\w+);", body) == [f for f, _ in
                                               pt._Plan._fields_]
    assert ctypes.sizeof(pt._Plan) == 24
    assert pt._FusedArgs.tb_s.offset == 24
    assert ctypes.sizeof(pt._FusedArgs) == 88
    assert ctypes.sizeof(pt._GroupArgs) == 32


def test_build_digest_covers_the_included_header(tmp_path):
    """An edit of ``segment_sum.cuh`` changes both kernels' library names,
    so a stale build is never reused; a file the sources do not include
    changes nothing."""
    shutil.copytree(pt.LIB.here / "csrc", tmp_path / "csrc")
    lib = _build.Library(tmp_path, pt.LIB.argtypes)
    before = {n: lib.target(n)[1] for n in lib.names}
    for n in lib.names:
        assert [p.name for p in lib.sources(n)] == [f"{n}.cu",
                                                     "segment_sum.cuh"]
    (tmp_path / "csrc" / "notes.txt").write_text("not included\n")
    assert {n: lib.target(n)[1] for n in lib.names} == before
    header = tmp_path / "csrc" / "segment_sum.cuh"
    header.write_text(header.read_text() + "// edited\n")
    after = {n: lib.target(n)[1] for n in lib.names}
    for n in lib.names:
        assert after[n] != before[n] and after[n].parent == before[n].parent
        assert lib.target(n)[0] == tmp_path / "csrc" / f"{n}.cu"


def test_fused_wrapper_rejects_bad_inputs():
    """The CUDA wrapper refuses what the kernel does not take before
    anything else, and never a CPU tensor (the CPU path is the plain
    version), as ``group_power_cuda`` does."""
    S, N, G = 2, 40, 4
    ok = torch.ones(S, G)
    for bad, match in [(torch.ones(S, N, dtype=torch.float64), "float32"),
                       (torch.ones(N), "shape"),
                       (torch.ones(S, N), "CUDA")]:
        with pytest.raises(ValueError, match=match):
            pt.fused_cooling_cuda(bad, ok, ok, ok, torch.ones(S), G, PARAMS)
    # every operand's type and shape is checked before any device
    for t_set, match in [(torch.ones(S + 1), "t_set has shape"),
                         (torch.ones(S, G + 1), "t_set has shape"),
                         (torch.ones(S, dtype=torch.float16), "t_set must be "
                          "float32"), (torch.ones(S), "node_pw must be a CUDA")]:
        with pytest.raises(ValueError, match=match):
            pt.fused_cooling_cuda(torch.ones(S, N), ok, ok, torch.ones(S),
                                  t_set, G, PARAMS)
    with pytest.raises(ValueError, match="hall"):
        tops._halls((0, 1, 2, 3), 3, torch.device("cpu"))


@pytest.mark.parametrize("hall,match", [
    (torch.zeros(4, dtype=torch.int64), "hall must be int32"),
    (torch.zeros(5, dtype=torch.int32), "hall has shape"),
    (torch.zeros(4, 1, dtype=torch.int32), "hall has shape"),
    (torch.zeros(8, dtype=torch.int32)[::2], "node_pw must be a CUDA")])
def test_fused_wrapper_rejects_a_bad_hall_index(hall, match):
    """The hall index is checked as the other operands are: i32[G] (its
    type and shape before any device; off the card, node_pw is refused
    first; its layout last)."""
    S, N, G, H = 2, 40, 4, 3
    ok = torch.ones(S, G)
    with pytest.raises(ValueError, match=match):
        pt.fused_cooling_cuda(torch.ones(S, N), ok, ok, torch.ones(S, H),
                              torch.ones(S), G, PARAMS, hall=hall)
