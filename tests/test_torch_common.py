"""Shared pieces of the PyTorch-port parity tests, and the port's guards.

The other ``test_torch_*.py`` files import the helpers below (pytest puts
this directory on ``sys.path``). Inputs are made with numpy from a seed
and handed to both packages as numpy arrays; the JAX package runs on the
CPU as its own tests run it. Nothing here flips a global JAX, torch or
environment setting except torch's intra-op thread count, which each
port test file pins to 1 so that several test workers do not oversubscribe
the machine's cores.
"""
import ast
import dataclasses
import pathlib

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from repro.systems import config as jcfg  # noqa: E402
from repro_torch.core import engine as teng  # noqa: E402
from repro_torch.core import types as TT  # noqa: E402
from repro_torch.launch import simulate as tcli  # noqa: E402
from repro_torch.kernels.power_topo import power_topo  # noqa: E402
from repro_torch.systems import config as tcfg  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]


# ---------------------------------------------------------------------------
# Helpers shared by the parity files.
# ---------------------------------------------------------------------------
def to_port(obj):
    """The port's copy of a JAX-package config dataclass (same values)."""
    if dataclasses.is_dataclass(obj):
        cls = getattr(tcfg, type(obj).__name__)
        return cls(**{f.name: to_port(getattr(obj, f.name))
                      for f in dataclasses.fields(obj)})
    return obj


def leaves(obj):
    """A JAX dataclass as a (nested) mapping of numpy arrays by field
    name, the input of the port's ``from_arrays``."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            out[f.name] = leaves(v)
        else:
            out[f.name] = None if v is None else np.asarray(v)
    return out


def as_np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def assert_exact(want, got, what=""):
    """Same dtype, same shape, same values (NaN == NaN)."""
    want, got = np.asarray(want), as_np(got)
    assert want.dtype == got.dtype, f"{what}: {want.dtype} != {got.dtype}"
    assert want.shape == got.shape, f"{what}: {want.shape} != {got.shape}"
    floating = np.issubdtype(want.dtype, np.floating)
    assert np.array_equal(want, got, equal_nan=floating), \
        f"{what}: differs at {np.argwhere(want != got)[:5].tolist()}"


def assert_jobsets_equal(want, got, what=""):
    """Two host ``JobSet``s (either package's) field for field: the same
    fields, each array of the same dtype, shape and values, the same
    ``None`` channels and name."""
    names = [f.name for f in dataclasses.fields(want)]
    assert names == [f.name for f in dataclasses.fields(got)], what
    for name in names:
        w, g = getattr(want, name), getattr(got, name)
        if w is None or isinstance(w, str):
            assert w == g, f"{what} {name}: {w!r} != {g!r}"
        else:
            assert_exact(w, np.asarray(g), f"{what} {name}")


def assert_runs_match(want, got, rtol=1e-4, what="", atol=None):
    """A JAX engine run (final state, history) against the port's: the
    schedule (``jstate``, ``start``, ``end``, ``node_job``, ``free_count``)
    exactly, every telemetry row and float leaf of the final state
    (``events`` included) at ``rtol``, the reference's engine tolerance.
    ``throttle_frac`` (1 - c, c near 1) also gets atol 1e-6: the port's
    cap factor is rounded down. ``atol`` adds absolute tolerances to
    telemetry rows by name."""
    atol = dict({"throttle_frac": 1e-6}, **(atol or {}))
    (wf, wh), (gf, gh) = want, got
    for name in ("jstate", "start", "end", "node_job", "free_count"):
        assert_exact(getattr(wf, name), getattr(gf, name), f"{what} {name}")
    for f in dataclasses.fields(gh):
        w, g = np.asarray(getattr(wh, f.name)), as_np(getattr(gh, f.name))
        assert w.shape == g.shape and w.dtype == g.dtype, f.name
        np.testing.assert_allclose(g, w, rtol=rtol,
                                   atol=atol.get(f.name, 0.0),
                                   err_msg=f"{what} {f.name}")

    def leaves_match(w_map, g_obj, prefix):
        for name, w in w_map.items():
            g = getattr(g_obj, name)
            if isinstance(w, dict):
                leaves_match(w, g, f"{prefix}{name}.")
            elif w is None:
                assert g is None, f"{what} {prefix}{name}"
            elif np.issubdtype(w.dtype, np.floating):
                np.testing.assert_allclose(as_np(g), w, rtol=rtol,
                                           err_msg=f"{what} {prefix}{name}")
    leaves_match(leaves(wf), gf, "")


def assert_threefry_partitionable():
    """The port transcribes jax's partitionable threefry; comparing its
    failure draws with JAX's needs that form on (jax 0.9's default). It
    is checked, never set: no global switch."""
    import jax
    assert jax.config.jax_threefry_partitionable, \
        "jax_threefry_partitionable is off: the port transcribes the " \
        "partitionable threefry (split and random_bits differ without it)"


def four_hall(system):
    """``system`` with a 4-hall plant of 4 CDU groups and 4 tower cells,
    sized tight (small towers, a low return limit and supply margin) so
    that hall pressure, the hall-aware placement order and the per-hall
    admission gate all come into play within a short run."""
    return dataclasses.replace(system, cooling=dataclasses.replace(
        system.cooling, n_groups=4, n_tower_cells=4, cell_rated_heat_w=5e4,
        fan_rated_w=2e3, t_return_limit_c=34.0, thermal_margin_c=4.0,
        t_supply_margin_c=4.0, topology=jcfg.FacilityTopology(n_halls=4)))


def workload_pair(jsystem, pad, **spec):
    """One synthetic workload made by both packages' dataset copies
    (``generate``, the jobs running at t = 0 placed, padded to ``pad``),
    as (port table, JAX table), checked equal leaf for leaf. ``spec``
    overrides the serve tests' ``WorkloadSpec`` (``conftest.make_jobs``)."""
    from repro.datasets import synthetic as jsyn
    from repro_torch.datasets import synthetic as tsyn
    spec = dict(dict(duration_s=4 * 3600.0, trace_len=8, n_accounts=8,
                     mean_wall_s=1800.0), **spec)
    tables = []
    for syn, system in ((tsyn, to_port(jsystem)), (jsyn, jsystem)):
        js = syn.generate(system, syn.WorkloadSpec(**spec))
        js.assign_prepop_placement(0.0, system.n_nodes)
        tables.append(js.to_table(pad))
    ttable, jtable = tables
    for name, w in leaves(jtable).items():
        if w is not None:
            assert_exact(w, getattr(ttable, name), f"table {name}")
    return ttable, jtable


def ml_pair(jsystem, train_spec, test_spec, pad=None, attach="basis",
            **fit):
    """The JAX pipeline fitted on a training workload (``WorkloadSpec``
    fields ``train_spec``, ``fit`` to ``MLSchedulerModel.fit``) and
    carried into the port (``MLSchedulerModel.from_arrays``), and one test
    workload made by both packages' dataset copies with the scoring basis
    attached (``attach="basis"``) or the score baked (``"scores"``), the
    jobs running at t = 0 placed, padded to ``pad``. Returns (port table,
    JAX table, port model, JAX model), the tables checked equal leaf for
    leaf: the carried model bases and scores bit for bit."""
    from repro.datasets import synthetic as jsyn
    from repro.ml import pipeline as jpipe
    from repro_torch.datasets import synthetic as tsyn
    from repro_torch.ml import pipeline as tpipe
    jmodel = jpipe.MLSchedulerModel.fit(
        jsyn.generate(jsystem, jsyn.WorkloadSpec(**train_spec)), **fit)
    tmodel = tpipe.MLSchedulerModel.from_arrays(leaves(jmodel))
    tables = []
    for syn, pipe, model, system in (
            (tsyn, tpipe, tmodel, to_port(jsystem)),
            (jsyn, jpipe, jmodel, jsystem)):
        js = syn.generate(system, syn.WorkloadSpec(**test_spec))
        getattr(pipe, f"attach_{attach}")(js, model)
        js.assign_prepop_placement(0.0, system.n_nodes)
        tables.append(js.to_table(pad))
    ttable, jtable = tables
    for name, w in leaves(jtable).items():
        if w is None:
            assert getattr(ttable, name) is None, name
        else:
            assert_exact(w, getattr(ttable, name), f"table {name}")
    return ttable, jtable, tmodel, jmodel


def port_signals(system, n_steps, seed=11):
    """The port's copy of ``conftest.make_signals``: time-varying carbon
    and a cap schedule between 1.5x and 6x the idle floor (the reference
    of each stays the constant signals')."""
    from repro_torch.grid import signals as tgsig
    rng = np.random.default_rng(seed)
    floor = system.n_nodes * system.power.idle_node_w
    sig = tgsig.constant_signals(n_steps, carbon_gkwh=300.0, price_kwh=0.1)
    carbon = (300.0 + 200.0 * np.sin(np.linspace(0, 6.0, n_steps))
              ).astype(np.float32)
    cap = rng.uniform(1.5 * floor, 6.0 * floor, n_steps).astype(np.float32)
    return dataclasses.replace(sig, carbon_gkwh=torch.from_numpy(carbon),
                               cap_w=torch.from_numpy(cap))


def cat_hists(hists):
    """Unbatched port histories concatenated along time."""
    return TT.StepRecord(**{f.name: torch.cat([getattr(h, f.name)
                                               for h in hists])
                            for f in dataclasses.fields(TT.StepRecord)})


def assert_states_equal(want, got, what=""):
    """Two port dataclasses (states or histories) bit for bit, leaf by
    leaf, ``None`` layers included."""
    for f in dataclasses.fields(want):
        w, g = getattr(want, f.name), getattr(got, f.name)
        if dataclasses.is_dataclass(w):
            assert_states_equal(w, g, f"{what} {f.name}.")
        elif w is None:
            assert g is None, f"{what}{f.name}"
        else:
            assert_exact(as_np(w), g, f"{what}{f.name}")


# ES training (``ml.train``): a sixth of the smallest gap between distinct
# rewards on ``SMOKE_CONFIG`` (2.95e-5), so a swap of two ranks cannot
# hide inside it; the metrics' float tolerance
REWARD_TOL = 5e-6
METRIC_RTOL = 1e-5


def assert_histories_match(want, got, upto, tol=REWARD_TOL):
    """Two ``history`` lists (``TrainResult`` or checkpoint): the same
    keys and generations, rewards within ``tol`` up to generation
    ``upto`` (None: all), the mean bit for bit before it; ``wall_s`` and
    the cache counters are not compared."""
    assert len(want) == len(got)
    for w, o in zip(want, got):
        g = w["generation"]
        assert set(w) == set(o) and o["generation"] == g
        if upto is not None and g > upto:
            continue
        for k in ("reward_mu", "reward_best", "reward_baseline",
                  "reward_pop_mean"):
            assert abs(w[k] - o[k]) <= tol, (g, k, w[k], o[k])
        if upto is None or g < upto:
            assert w["mu"] == o["mu"], g


def assert_checkpoints_match(want, got, upto, tol=REWARD_TOL):
    """Two training checkpoints (either package's): the search settings
    and (when the runs ranked alike throughout, ``upto`` None) the mean
    bit for bit, the normalizers at ``METRIC_RTOL``, rewards within
    ``tol``, the history as ``assert_histories_match`` holds it. The
    elite is compared apart; ``wall_s`` and the cache fields are not
    compared."""
    assert set(want) == set(got)
    for k in ("alpha0", "sigma", "lr", "population", "generation", "reward",
              "seed"):
        assert want[k] == got[k], k
    if upto is None:
        assert want["mu"] == got["mu"]
    assert set(want["refs"]) == set(got["refs"])
    for k, v in want["refs"].items():
        assert abs(got["refs"][k] - v) <= METRIC_RTOL * abs(v), k
    assert abs(want["best_reward"] - got["best_reward"]) <= tol
    assert_histories_match(want["history"], got["history"], upto, tol)


# ---------------------------------------------------------------------------
# Guards.
# ---------------------------------------------------------------------------
def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _module_level_imports(path):
    """Imports a module runs when it is imported: its body's, not those
    inside a function."""
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_the_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 15
    names = {p.relative_to(ROOT / "src").as_posix() for p in files[:-1]}
    assert {"repro_torch/traces/calibrate.py", "repro_torch/datasets/swf.py",
            "repro_torch/traces/telemetry.py"} <= names
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), \
                f"{path.relative_to(ROOT)} imports {mod}"
        # the card's path needs no pandas (nor pyarrow, nor scipy to
        # import): they are imported only inside the functions that read
        # a CSV or parquet file, or fit
        for mod in _module_level_imports(path):
            assert mod.split(".")[0] not in ("pandas", "pyarrow", "scipy"), \
                f"{path.relative_to(ROOT)} imports {mod} when imported"


def test_system_configs_are_copies():
    for name, system in jcfg.SYSTEMS.items():
        assert to_port(system) == tcfg.get_system(name), name
    js = jcfg.get_system("frontier").scaled(96)
    assert to_port(js) == tcfg.get_system("frontier").scaled(96)


def test_entry_point_without_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    system = tcfg.get_system("marconi100").scaled(64)
    table = TT.JobTable.from_arrays({
        "submit": np.zeros(2, np.float32), "limit": np.ones(2, np.float32),
        "wall": np.ones(2, np.float32), "nodes": np.ones(2, np.int32),
        "priority": np.zeros(2, np.float32), "account": np.zeros(2, np.int32),
        "rec_start": np.zeros(2, np.float32),
        "first_node": np.full(2, -1, np.int32),
        "score": np.zeros(2, np.float32),
        "power_prof": np.ones((2, 1), np.float32),
        "util_prof": np.ones((2, 1), np.float32),
        "valid": np.ones(2, bool)})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        teng.simulate_static(system, table, "fcfs", "none", 0.0, 60.0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        teng.simulate_sweep(system, table, [TT.Scenario.make("fcfs")],
                            0.0, 60.0)


def test_kernel_wrapper_rejects_bad_inputs():
    """The CUDA wrapper validates type and shape before anything else, and
    never takes a CPU tensor (the CPU path is the plain version)."""
    p = tcfg.get_system("frontier").cooling
    from repro_torch.cooling import model as tcool
    params = tcool.cdu_params(p, 15.0)
    S, N, G = 2, 40, 4
    good = dict(node_pw=torch.ones(S, N), t_supply=torch.ones(S, G),
                mdot=torch.ones(S, G), t_basin=torch.ones(S, G),
                t_set=torch.ones(S, G))
    for name, bad, match in [
            ("node_pw", torch.ones(S, N, dtype=torch.float64), "float32"),
            ("mdot", torch.ones(S, G, dtype=torch.float16), "float32"),
            ("node_pw", torch.ones(N), "shape"),
            ("t_supply", torch.ones(S, G + 1), "shape"),
            ("t_set", torch.ones(S + 1, G), "shape"),
            ("t_basin", torch.ones(S, G), "CUDA")]:
        kw = dict(good, **{name: bad})
        with pytest.raises(ValueError, match=match):
            power_topo.fused_cooling_cuda(**kw, n_groups=G, p=params)


def test_cli_runs_on_the_cpu(capsys):
    tcli.main(["--system", "marconi100", "--scale", "64", "--jobs", "40",
               "-t", "20m", "--device", "cpu", "--sweep", "fcfs:easy",
               "sjf"])
    out = capsys.readouterr().out
    assert out.count("avg_pue") == 2 and "policy=sjf backfill=none" in out
    tcli.main(["--system", "marconi100", "--scale", "64", "--jobs", "40",
               "-t", "10m", "--device", "cpu", "--policy", "fcfs"])
    assert "policy=fcfs backfill=none on cpu" in capsys.readouterr().out
