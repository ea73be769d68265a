"""The port's data path against the JAX package: the synthetic generator,
the loaders, ``JobSet.to_table`` and ``from_arrays``, all exact (same
numpy draws, same dtypes, same values)."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import engine as jeng
from repro.datasets import loaders as jload
from repro.datasets.synthetic import WorkloadSpec as JSpec, generate as jgen
from repro.systems.config import get_system
from repro_torch.core import engine as teng
from repro_torch.core import types as TT
from repro_torch.datasets import loaders as tload
from repro_torch.datasets.synthetic import WorkloadSpec as TSpec, \
    generate as tgen

from test_torch_common import assert_exact, leaves, to_port

torch.set_num_threads(1)

JOBSET_FIELDS = ("submit", "limit", "wall", "nodes", "priority", "account",
                 "rec_start", "power_prof", "util_prof", "first_node")


def _same_jobset(a, b):
    for name in JOBSET_FIELDS:
        x, y = getattr(a, name), getattr(b, name)
        if x is None and y is None:
            continue
        assert_exact(x, y, name)


def _same_table(jt, tt):
    for f in dataclasses.fields(tt):
        assert_exact(getattr(jt, f.name), getattr(tt, f.name), f.name)


@pytest.mark.parametrize("system_name,spec", [
    ("marconi100", dict(n_jobs=80, duration_s=4 * 3600.0, load=1.0,
                        trace_len=8, n_accounts=8, mean_wall_s=1800.0,
                        seed=7)),
    ("fugaku", dict(n_jobs=60, duration_s=7200.0, trace_len=1, seed=3,
                    full_system_jobs=1)),
])
def test_generate_and_to_table_identical(system_name, spec):
    js_sys = get_system(system_name).scaled(64)
    jjs = jgen(js_sys, JSpec(**spec))
    tjs = tgen(to_port(js_sys), TSpec(**spec))
    for j in (jjs, tjs):
        j.assign_prepop_placement(0.0, js_sys.n_nodes)
    _same_jobset(jjs, tjs)
    for pad in (None, spec["n_jobs"] + 16):
        _same_table(jjs.to_table(pad), tjs.to_table(pad))


@pytest.mark.parametrize("name", ["frontier", "marconi100", "adastra"])
def test_loaders_identical(name):
    kw = dict(n_jobs=60, days=0.25, seed=5)
    _same_jobset(jload.load(name, **kw), tload.load(name, **kw))


def test_from_arrays_round_trips_jax_leaves():
    system = get_system("marconi100").scaled(64)
    js = jgen(system, JSpec(n_jobs=40, duration_s=7200.0, trace_len=4,
                            n_accounts=4, seed=9))
    js.assign_prepop_placement(1800.0, system.n_nodes)
    jtable = js.to_table(48)
    ttable = TT.JobTable.from_arrays(leaves(jtable))
    _same_table(jtable, ttable)
    # init_state from the same table is the same state, and a JAX state
    # handed over through from_arrays is the port's (with an S axis of 1)
    jst = jeng.init_state(system, jtable, 1800.0, 7200.0, num_accounts=4)
    tst = teng.init_state(to_port(system), ttable, 1800.0, 7200.0,
                          num_accounts=4)
    moved = TT.SimState.from_arrays(leaves(jst))
    for name, v in leaves(jst).items():
        if isinstance(v, dict):
            for k, x in v.items():
                assert_exact(x, getattr(getattr(tst, name), k), f"{name}.{k}")
                assert_exact(x[None], getattr(getattr(moved, name), k), k)
        elif v is not None:
            assert_exact(v, getattr(tst, name), name)
            assert_exact(v[None], getattr(moved, name), name)


def test_scenario_from_arrays_and_unported_knobs():
    """The grid knobs (carbon and price weights, cap scale), the
    failure and demand-response knobs and the ML scoring weights (a
    scalar alpha, a vector alpha and the two stacked) are carried."""
    from repro.core import types as JT
    kw = [dict(thermal_weight=2.0, carbon_weight=3.0, cap_scale=0.7),
          dict(setpoint_delta_c=-1.5, price_weight=0.25, cap_scale=0.85)]
    scens = [JT.Scenario.make("thermal_aware", "easy", **kw[0]),
             JT.Scenario.make("sjf", "first-fit", **kw[1])]
    got = TT.Scenario.from_arrays(leaves(JT.stack_scenarios(scens)))
    want = TT.stack_scenarios([
        TT.Scenario.make("thermal_aware", "easy", **kw[0]),
        TT.Scenario.make("sjf", "first-fit", **kw[1])])
    for f in dataclasses.fields(want):
        assert torch.equal(getattr(got, f.name), getattr(want, f.name)), \
            f.name
    assert got.cap_scale.tolist() == [np.float32(0.7), np.float32(0.85)]
    assert got.carbon_weight.tolist() == [3.0, 1.0]
    assert got.price_weight.tolist() == [1.0, 0.25]
    for alpha in (0.5, (1.0, 0.25, 2.0, 0.5)):
        got = TT.Scenario.from_arrays(leaves(JT.Scenario.make(
            "ml", alpha=alpha)))
        assert_exact(np.asarray(alpha, np.float32), got.alpha, "alpha")
    got = TT.Scenario.from_arrays(leaves(JT.stack_scenarios([
        JT.Scenario.make("ml", alpha=0.5),
        JT.Scenario.make("ml", alpha=(1.0, 0.25, 2.0, 0.5))])))
    want = TT.stack_scenarios([TT.Scenario.make("ml", alpha=0.5),
                               TT.Scenario.make("ml",
                                                alpha=(1.0, 0.25, 2.0, 0.5))])
    assert torch.equal(got.alpha, want.alpha) and got.alpha.shape == (2, 4)
    for knob, value in [("node_fail_rate", 1e-6), ("cdu_fail_rate", 1e-6),
                        ("cell_fail_rate", 1e-6), ("failure_corr", 0.5),
                        ("dr_announce_s", 600.0)]:
        got = TT.Scenario.from_arrays(leaves(JT.Scenario.make(
            "fcfs", **{knob: value})))
        assert getattr(got, knob) == np.float32(value), knob
    # a scoring basis is carried, its padded rows zero in both tables
    system = get_system("marconi100").scaled(64)
    js = jgen(system, JSpec(n_jobs=40, duration_s=7200.0, trace_len=4,
                            n_accounts=4, seed=9))
    js.ml_basis = np.random.default_rng(3).uniform(
        1.0, np.e, (40, 4)).astype(np.float32)
    jtable = js.to_table(48)
    got = TT.JobTable.from_arrays(leaves(jtable))
    assert_exact(np.asarray(jtable.ml_basis), got.ml_basis, "ml_basis")
    assert not got.ml_basis[40:].any()
