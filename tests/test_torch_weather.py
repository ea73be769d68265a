"""Weather traces (``repro_torch.cooling.weather``) and their path into
the plant and the engine, against the JAX package's.

* The builders give the JAX package's float32 arrays bit for bit.
* ``at_step`` gathers a shared site-wide, a shared per-hall and a
  per-scenario stack of traces as the JAX gather does row by row.
* The plant step with a weather wet-bulb and failed tower cells matches
  JAX's at the plant's tolerances (rtol 1e-5 on group heat, 1e-4 on the
  fused path, as in ``tests/test_torch_grid.py`` and
  ``tests/test_torch_physics.py``).
* Engine sweeps with a site-wide trace, with per-hall traces and with
  traces stacked one per scenario match the JAX engine: the schedule
  exactly, telemetry and the final state at rtol 1e-4.
* A constant trace at the config's wet-bulb equals no trace bit for bit,
  and a heat wave raises the tower temperatures
  (``tests/test_cooling.py:230-280``).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cooling import model as jcool
from repro.cooling import weather as jwx
from repro.core import engine as jeng
from repro.core import types as JT
from repro.datasets.synthetic import WorkloadSpec, generate
from repro.systems.config import get_system
from repro_torch.cooling import model as tcool
from repro_torch.cooling import weather as twx
from repro_torch.core import engine as teng
from repro_torch.core import types as TT
from repro_torch.grid import signals as tgsig

from test_torch_common import (as_np, assert_exact, assert_runs_match,
                               four_hall, leaves, to_port)

torch.set_num_threads(1)

SYSTEM = get_system("marconi100").scaled(64)
T1 = 2 * 3600.0
RTOL = 1e-4
SYNTH = [dict(n_steps=360, dt=20.0, seed=0),
         dict(n_steps=1440, dt=15.0, t0=14 * 3600.0, seed=7),
         dict(n_steps=97, dt=60.0, t_wb_mean_c=24.0, diurnal_amp_c=6.0,
              seasonal_amp_c=2.0, day_of_year=200.0, noise_c=1.5, seed=3),
         dict(n_steps=1, dt=15.0, depression_c=3.0, seed=11)]
WAVES = [dict(start_s=3600.0, duration_s=3 * 3600.0, peak_amp_c=8.0),
         dict(start_s=-600.0, duration_s=0.5, peak_amp_c=14.0)]


def pair(name, *args, **kw):
    return getattr(jwx, name)(*args, **kw), getattr(twx, name)(*args, **kw)


def assert_weather_equal(want, got, what=""):
    assert_exact(want.t_wetbulb_c, got.t_wetbulb_c, f"{what} wet-bulb")
    assert_exact(want.t_drybulb_c, got.t_drybulb_c, f"{what} dry-bulb")


# ---------------------------------------------------------------------------
# Builders and the gather.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kw", SYNTH)
def test_synthetic_weather_is_bit_equal(kw):
    assert_weather_equal(*pair("synthetic_weather", **kw))


@pytest.mark.parametrize("kw", WAVES)
def test_heat_wave_is_bit_equal(kw):
    jb, tb = pair("synthetic_weather", 720, 20.0, seed=5)
    assert_weather_equal(jwx.heat_wave(jb, 20.0, **kw),
                         twx.heat_wave(tb, 20.0, **kw))


def test_constant_and_measured_traces_are_bit_equal():
    assert_weather_equal(*pair("constant_weather", 100, 21.3))
    assert_weather_equal(*pair("constant_weather", 0, 19.0, 30.1))
    rng = np.random.default_rng(1)
    wb = rng.uniform(10.0, 28.0, 50)
    assert_weather_equal(*pair("from_arrays", wb))
    assert_weather_equal(*pair("from_arrays", wb,
                               wb + rng.uniform(2.0, 9.0, 50)))
    with pytest.raises(ValueError, match="shape mismatch"):
        twx.from_arrays(wb, wb[:-1])


def test_stacked_traces_are_bit_equal():
    seeds = (1, 2, 3, 4)
    js = [jwx.synthetic_weather(30, 20.0, seed=s) for s in seeds]
    ts = [twx.synthetic_weather(30, 20.0, seed=s) for s in seeds]
    halls = twx.stack_halls(ts)
    assert_weather_equal(jwx.stack_halls(js), halls, "halls")
    assert halls.num_steps == 30 and not halls.batched
    both = twx.stack_weather([halls, halls])
    assert_weather_equal(jwx.stack_weather([jwx.stack_halls(js)] * 2), both,
                         "scenarios x halls")
    assert both.batched and both.num_steps == 30


@pytest.mark.parametrize("layout", ["site", "halls", "per-scenario"])
def test_at_step_gathers_like_jax(layout):
    """Each scenario's row at its own (clamped) step."""
    ts = [twx.synthetic_weather(20, 20.0, seed=s) for s in range(4)]
    js = [jwx.synthetic_weather(20, 20.0, seed=s) for s in range(4)]
    steps = np.asarray([0, 7, 19, 25], np.int32)     # 25 is past the end
    if layout == "site":
        tw, jws = ts[0], [js[0]] * 4
    elif layout == "halls":
        tw, jws = twx.stack_halls(ts), [jwx.stack_halls(js)] * 4
    else:
        tw, jws = twx.stack_weather(ts), js
    now = twx.at_step(tw, torch.from_numpy(steps))
    for s in range(4):
        want = jwx.at_step(jws[s], jnp.int32(steps[s]))
        assert_exact(want.t_wetbulb_c, now.t_wetbulb_c[s], "wet-bulb")
        assert_exact(want.t_drybulb_c, now.t_drybulb_c[s], "dry-bulb")


# ---------------------------------------------------------------------------
# The plant step.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("halls", [1, 4])
def test_plant_step_with_weather_and_failed_cells_matches_jax(halls, fused):
    """Several steps for 3 scenarios with their own wet-bulb (site-wide
    for scenario 0, per hall for the rest) and failed cells, on the
    grid path's group heat or the no-grid path's node power."""
    system = SYSTEM if halls == 1 else four_hall(SYSTEM)
    cfg, tcfg = system.cooling, to_port(system.cooling)
    S, G, H, N = 3, cfg.n_groups, cfg.n_halls, system.n_nodes
    cells = np.asarray(cfg.cells_per_hall(), np.float32)
    rng = np.random.default_rng(10 + halls)
    deltas = np.asarray([0.0, -1.0, 2.0], np.float32)
    j_states = [jcool.init_state(cfg) for _ in range(S)]
    t_state = TT.tree_map(lambda x: x.unsqueeze(0).repeat(S, *[1] * x.ndim),
                          tcool.init_state(tcfg))
    rtol = RTOL if fused else 1e-5
    for step in range(6):
        wb = rng.uniform(12.0, 30.0, (S, H)).astype(np.float32)
        wb[0] = wb[0, 0]                  # scenario 0: one site-wide value
        failed = np.floor(rng.uniform(0.0, 1.0, (S, H)) * (cells + 1.0))
        failed = np.minimum(failed, cells).astype(np.float32)
        failed[0] = 0.0
        tw, tf, td = (torch.from_numpy(x) for x in (wb, failed, deltas))
        if fused:
            load = rng.uniform(2e3, 2e4, (S, N)).astype(np.float32)
            t_state, t_out, _ = tcool.step_from_node_power(
                tcfg, t_state, torch.from_numpy(load), system.dt, td, 0.0,
                t_wetbulb_c=tw, cells_failed=tf)
        else:
            load = rng.uniform(1e4, 1.5e5, (S, G)).astype(np.float32)
            t_state, t_out = tcool.step(tcfg, t_state, torch.from_numpy(load),
                                        system.dt, td, 0.0, t_wetbulb_c=tw,
                                        cells_failed=tf)
        for s in range(S):
            jw = wb[s, 0] if s == 0 else jnp.asarray(wb[s])
            args = (cfg, j_states[s], jnp.asarray(load[s]), system.dt, jw,
                    deltas[s], 0.0, jnp.asarray(failed[s]))
            if fused:
                j_states[s], j_out, _ = jcool.step_from_node_power(*args)
            else:
                j_states[s], j_out = jcool.step(*args)
            for name, w in j_out._asdict().items():
                np.testing.assert_allclose(
                    as_np(getattr(t_out, name)[s]), np.asarray(w),
                    rtol=rtol, err_msg=f"step {step} out {name}")
            for name, w in vars(j_states[s]).items():
                np.testing.assert_allclose(
                    as_np(getattr(t_state, name)[s]), np.asarray(w),
                    rtol=rtol, err_msg=f"step {step} state {name}")


# ---------------------------------------------------------------------------
# The engine.
# ---------------------------------------------------------------------------
def make_table(system, seed, load=1.2):
    js = generate(system, WorkloadSpec(
        n_jobs=64, duration_s=4 * 3600.0, load=load, trace_len=8,
        n_accounts=8, mean_wall_s=1800.0, seed=seed))
    js.assign_prepop_placement(0.0, system.n_nodes)
    return js.to_table(80)


# Fans coming on from rest run at a stage r of ~1e-3 and a power of
# rated x r^3 ~ 1e-6 W, where r's last-ulp differences are amplified
# (4.7e-4 relative, 2.3e-10 W measured): fan power also gets a microwatt
# of absolute tolerance.
FAN_ATOL = {"power_fan": 1e-6}
SPECS = [("fcfs", "first-fit", {}), ("thermal_aware", "easy",
                                     {"thermal_weight": 20.0}),
         ("sjf", "none", {"setpoint_delta_c": 1.5})]


@pytest.mark.parametrize("layout", ["site", "halls", "per-scenario"])
def test_engine_with_weather_matches_jax(layout):
    """A 4-hall plant under a hot trace: one site-wide trace shared by
    every scenario, one trace per hall shared, or one per-hall set per
    scenario stacked on the S axis."""
    system = four_hall(SYSTEM)
    jtable = make_table(system, 4, load=1.4)
    n = int(T1 / system.dt)
    base = lambda mod, s: mod.heat_wave(
        mod.synthetic_weather(n, system.dt, t_wb_mean_c=22.0, seed=s),
        system.dt, 1800.0, 3600.0, 9.0)
    halls = lambda mod, k: mod.stack_halls([base(mod, k + h)
                                            for h in range(4)])
    if layout == "site":
        jw, tw = base(jwx, 1), base(twx, 1)
    elif layout == "halls":
        jw, tw = halls(jwx, 1), halls(twx, 1)
    else:
        jw = [halls(jwx, 10 * i) for i in range(3)]
        tw = [halls(twx, 10 * i) for i in range(3)]
    want = jeng.simulate_sweep(system, jtable,
                               [JT.Scenario.make(p, b, **kw)
                                for p, b, kw in SPECS], 0.0, T1,
                               num_accounts=8, weather=jw)
    got = teng.simulate_sweep(to_port(system),
                              TT.JobTable.from_arrays(leaves(jtable)),
                              [TT.Scenario.make(p, b, **kw)
                               for p, b, kw in SPECS], 0.0, T1,
                              num_accounts=8, weather=tw, device="cpu")
    assert_runs_match(want, got, RTOL, layout, atol=FAN_ATOL)
    # the trace reached the plant: the recorded wet-bulb is the trace's
    wb = as_np(got[1].t_wetbulb_hall)
    assert wb.max() - wb.min() > 5.0


@pytest.mark.parametrize("grid", [False, True])
@pytest.mark.parametrize("halls", [1, 4])
def test_constant_weather_equals_no_weather(halls, grid):
    """A constant trace at the config's wet-bulb, site-wide or one per
    hall, gives the bits of a run without a trace."""
    system = to_port(SYSTEM if halls == 1 else four_hall(SYSTEM))
    table = TT.JobTable.from_arrays(leaves(make_table(SYSTEM, 3)))
    n = int(T1 / system.dt)
    const = twx.constant_weather(n, system.cooling.t_wetbulb_c)
    if halls > 1:
        const = twx.stack_halls([const] * halls)
    scens = [TT.Scenario.make("fcfs", "easy"),
             TT.Scenario.make("thermal_aware", "first-fit")]
    kw = dict(num_accounts=8, device="cpu",
              signals=tgsig.neutral(n) if grid else None)
    f0, h0 = teng.simulate_sweep(system, table, scens, 0.0, T1, **kw)
    f1, h1 = teng.simulate_sweep(system, table, scens, 0.0, T1,
                                 weather=const, **kw)
    for f in dataclasses.fields(h0):
        assert torch.equal(getattr(h0, f.name), getattr(h1, f.name)), f.name
    for name in ("jstate", "start", "end", "node_job", "energy_total",
                 "energy_cooling", "heat_reuse_j"):
        assert torch.equal(getattr(f0, name), getattr(f1, name)), name
    for k, v in vars(f0.cooling).items():
        assert torch.equal(v, getattr(f1.cooling, k)), k


def test_heat_wave_raises_tower_temps():
    """The reference's heat wave (10 °C over 2 h from 1 h) on a constant
    trace: tower return and basin peaks rise by more than 3 °C, the same
    scenario in both rows of one sweep."""
    system = to_port(SYSTEM)
    table = TT.JobTable.from_arrays(leaves(make_table(SYSTEM, 1)))
    t1 = 4 * 3600.0
    n = int(t1 / system.dt)
    base = twx.constant_weather(n, system.cooling.t_wetbulb_c)
    wave = twx.heat_wave(base, system.dt, start_s=3600.0, duration_s=7200.0,
                         peak_amp_c=10.0)
    scen = TT.Scenario.make("fcfs", "first-fit")
    _, h = teng.simulate_sweep(system, table, [scen, scen], 0.0, t1,
                               num_accounts=8, weather=[base, wave],
                               device="cpu")
    assert float(h.t_tower_return[1].max()) > \
        float(h.t_tower_return[0].max()) + 3.0
    assert float(h.t_basin[1].max()) > float(h.t_basin[0].max()) + 3.0
    _, solo = teng.simulate(system, table, scen, 0.0, t1, num_accounts=8,
                            weather=wave, device="cpu")
    for f in dataclasses.fields(solo):
        assert torch.equal(getattr(solo, f.name), getattr(h, f.name)[1]), \
            f.name
