"""The slice end to end: the port's scenario sweep against the JAX engine.

Three scenarios on ``small_system`` (marconi100 scaled to 64 nodes) over
2 h, flat and on a tight 4-hall plant (hall-aware placement, a hall
losing its setpoint under maintenance). The schedule (``jstate``,
``start``, ``end``, ``node_job``) must match exactly; the telemetry and
the final accumulators at rtol 1e-4, the reference's engine tolerance
(float sums over nodes, groups and halls run in another order). These
are the file's two JAX engine compilations.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import engine as jeng
from repro.core import stats as jstats
from repro.core import types as JT
from repro.datasets.synthetic import WorkloadSpec, generate
from repro.systems.config import get_system
from repro_torch.core import engine as teng
from repro_torch.core import stats as tstats
from repro_torch.core import types as TT

from test_torch_common import as_np, assert_exact, four_hall, leaves, \
    to_port

torch.set_num_threads(1)

T1 = 2 * 3600.0
RTOL = 1e-4
CASES = {
    "flat": dict(
        scens=[("fcfs", "easy", {}), ("acct_avg_power", "first-fit", {}),
               ("thermal_aware", "none", {})],
        spec=dict(n_jobs=80, duration_s=4 * 3600.0, load=1.0, trace_len=8,
                  n_accounts=8, mean_wall_s=1800.0, seed=7), pad=96),
    "4halls": dict(
        scens=[("thermal_aware", "easy", {}),
               ("fcfs", "first-fit", {"cells_offline": (2.0, 0.0, 0.0, 0.0)}),
               ("sjf", "none", {})],
        spec=dict(n_jobs=64, duration_s=4 * 3600.0, load=1.6, trace_len=8,
                  n_accounts=8, mean_wall_s=1800.0, seed=4), pad=80),
}


@pytest.fixture(scope="module", params=list(CASES))
def sweeps(request):
    case = CASES[request.param]
    base = get_system("marconi100").scaled(64)
    system = base if request.param == "flat" else four_hall(base)
    js = generate(system, WorkloadSpec(**case["spec"]))
    js.assign_prepop_placement(0.0, system.n_nodes)
    jtable = js.to_table(case["pad"])
    want = jeng.simulate_sweep(
        system, jtable, [JT.Scenario.make(p, b, **kw)
                         for p, b, kw in case["scens"]], 0.0, T1,
        num_accounts=8)
    tsys, ttable = to_port(system), TT.JobTable.from_arrays(leaves(jtable))
    got = teng.simulate_sweep(
        tsys, ttable, [TT.Scenario.make(p, b, **kw)
                       for p, b, kw in case["scens"]], 0.0, T1,
        num_accounts=8, device="cpu")
    return dict(case=case, system=system, jtable=jtable, tsys=tsys,
                ttable=ttable, want=want, got=got, name=request.param)


def test_schedules_match_exactly(sweeps):
    (wf, _), (gf, _) = sweeps["want"], sweeps["got"]
    for name in ("jstate", "start", "end", "node_job", "free_count",
                 "step"):
        assert_exact(getattr(wf, name), getattr(gf, name), name)
    # the runs did real scheduling work
    js = np.asarray(wf.jstate)
    assert (js == JT.DONE).sum(1).min() > 0 and (js == JT.RUNNING).any()


def test_telemetry_and_accumulators_match(sweeps):
    (wf, wh), (gf, gh) = sweeps["want"], sweeps["got"]
    for f in dataclasses.fields(gh):
        w, g = np.asarray(getattr(wh, f.name)), as_np(getattr(gh, f.name))
        assert w.shape == g.shape and w.dtype == g.dtype, f.name
        np.testing.assert_allclose(g, w, rtol=RTOL, err_msg=f.name)
    for name, w in leaves(wf).items():
        if isinstance(w, dict):
            for k, x in w.items():
                np.testing.assert_allclose(
                    as_np(getattr(getattr(gf, name), k)), x, rtol=RTOL,
                    err_msg=f"{name}.{k}")
        elif w is not None and np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(as_np(getattr(gf, name)), w,
                                       rtol=RTOL, err_msg=name)
    if sweeps["name"] == "4halls":
        # the maintenance scenario lost setpoint in hall 0 for a while
        assert np.asarray(wh.overheat_hall)[1, :, 0].sum() > 0
    for i in range(len(sweeps["case"]["scens"])):
        ws = jstats.summarize(sweeps["system"], sweeps["jtable"],
                              JT_row(wf, i), JT_row(wh, i))
        gs = tstats.summarize(sweeps["tsys"], sweeps["ttable"],
                              TT.row(gf, i), TT.row(gh, i))
        assert ws.keys() == gs.keys()
        for k in ws:
            np.testing.assert_allclose(gs[k], ws[k], rtol=RTOL, err_msg=k)


def JT_row(obj, i):
    import jax
    return jax.tree_util.tree_map(lambda x: x[i], obj)


def test_sweep_row_is_bit_identical_to_a_solo_run(sweeps):
    """A scenario run alone through ``simulate``/``simulate_static`` gives
    the same bits as its row of the sweep (on the CPU)."""
    p, b, kw = sweeps["case"]["scens"][0]
    if kw:
        solo = teng.simulate(sweeps["tsys"], sweeps["ttable"],
                             TT.Scenario.make(p, b, **kw), 0.0, T1,
                             num_accounts=8, device="cpu")
    else:
        solo = teng.simulate_static(sweeps["tsys"], sweeps["ttable"], p, b,
                                    0.0, T1, num_accounts=8, device="cpu")
    final, hist = sweeps["got"]
    for f in dataclasses.fields(hist):
        assert torch.equal(getattr(solo[1], f.name),
                           getattr(hist, f.name)[0]), f.name
    for name in ("jstate", "start", "end", "node_job", "energy_total",
                 "jenergy"):
        assert torch.equal(getattr(solo[0], name), getattr(final, name)[0])
