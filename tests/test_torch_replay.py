"""Measured-power replay and compact time in the PyTorch port.

``JobSet.to_table(replay_power=True)`` carries the measured per-node
power of a telemetry trace into the table, and the port's power model
plays it back verbatim (``repro_torch.power.model``), jobs without a
measurement keeping the model. ``compact_time=True`` stores the time
columns as int32 with a 2^30 sentinel for +inf.

* The tables equal the JAX package's leaf for leaf (dtypes included).
* Replayed power is the measurement point by point, profile-less jobs
  keep the model, as in the JAX function.
* In the port, bit for bit: a table whose measured channel is all
  sentinel runs exactly as the table without one, and a compact table
  exactly as the float32 one.
* Against the JAX engine on the telemetry fixture at small size, with
  the event layer on (jobs killed) and the weather week: schedules
  exactly, every float within 1e-4, the reference's engine tolerance.
* The CLI's ``--trace``/``--replay-power``/``--weather-trace`` on the CPU.
"""
import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from conftest import DATA_DIR  # noqa: E402
from repro.core import engine as jeng  # noqa: E402
from repro.core import types as JT  # noqa: E402
from repro.events import EventConfig as JEventConfig  # noqa: E402
from repro.power import model as jpm  # noqa: E402
from repro_torch import traces as ttr  # noqa: E402
from repro_torch.core import engine as teng  # noqa: E402
from repro_torch.core import stats as tstats  # noqa: E402
from repro_torch.core import types as TT  # noqa: E402
from repro_torch.events import EventConfig  # noqa: E402
from repro_torch.launch import simulate as tcli  # noqa: E402
from repro_torch.power import model as tpm  # noqa: E402
from test_torch_common import (assert_exact, assert_runs_match,  # noqa: E402
                               assert_states_equal,
                               assert_threefry_partitionable, leaves,
                               to_port)

HORIZON = 120     # engine steps, as the reference's replay tests
RTOL = 1e-4       # the reference's engine tolerance
# the reference's test_replay_composes_with_events scenario
KILL = dict(failure_seed=3.0, node_fail_rate=5e-4, cdu_fail_rate=2e-5,
            failure_corr=0.5, repair_s=900.0)
TELEMETRY = (DATA_DIR / "joblive", DATA_DIR / "jobprofile")


@pytest.fixture(scope="module")
def port_jobset():
    return ttr.load_telemetry(*TELEMETRY, prof_dt=20.0)


def table_pair(jjs, tjs, **kw):
    """(JAX table, port table) of one trace, padded by 8 rows, checked
    equal leaf for leaf."""
    jt, tt = jjs.to_table(len(jjs) + 8, **kw), tjs.to_table(len(tjs) + 8,
                                                           **kw)
    for name, w in leaves(jt).items():
        if w is None:             # no scoring basis, or no replay channel
            assert getattr(tt, name) is None, name
        else:
            assert_exact(w, getattr(tt, name), f"{kw} {name}")
    return jt, tt


@pytest.mark.parametrize("kw", [{}, {"replay_power": True},
                                {"compact_time": True},
                                {"compact_time": True, "replay_power": True}])
def test_tables_equal_the_reference(trace_jobset, port_jobset, kw):
    jt, tt = table_pair(trace_jobset, port_jobset, **kw)
    compact = kw.get("compact_time", False)
    for f in ("submit", "limit", "wall", "rec_start"):
        assert getattr(tt, f).dtype == (torch.int32 if compact
                                        else torch.float32)
    if compact:
        assert int(tt.rec_start[-1]) == 1 << 30      # the +inf pad fill


def test_compact_time_falls_back_per_column(port_jobset):
    js = dataclasses.replace(port_jobset, submit=port_jobset.submit + 0.25)
    table = js.to_table(compact_time=True)
    assert table.submit.dtype == torch.float32
    assert table.wall.dtype == torch.int32
    big = dataclasses.replace(port_jobset, limit=port_jobset.limit + 2 ** 24)
    assert big.to_table(compact_time=True).limit.dtype == torch.float32


def test_to_table_replay_gate(port_jobset):
    js = port_jobset
    assert js.to_table(len(js) + 8).power_profile is None
    prof = js.to_table(len(js) + 8, replay_power=True).power_profile
    assert prof.shape == (len(js) + 8, js.power_profile.shape[1])
    assert (prof[len(js):] == -1.0).all(), "padded rows must be sentinel"
    with pytest.raises(ValueError, match="power_profile"):
        dataclasses.replace(js, power_profile=None).to_table(
            replay_power=True)


def test_from_arrays_takes_the_replay_channel(trace_jobset, port_jobset):
    jt, tt = table_pair(trace_jobset, port_jobset, replay_power=True)
    got = TT.JobTable.from_arrays(leaves(jt))
    assert_states_equal(tt, got, "from_arrays ")
    assert TT.JobTable.from_arrays({**leaves(jt), "power_profile": None}
                                   ).power_profile is None
    # a scoring basis rides along with the replay channel
    basis = np.random.default_rng(5).uniform(1.0, np.e, (len(tt.valid), 4))
    got = TT.JobTable.from_arrays({**leaves(jt),
                                   "ml_basis": basis.astype(np.float32)})
    assert_exact(basis.astype(np.float32), got.ml_basis, "ml_basis")
    assert_exact(leaves(jt)["power_profile"], got.power_profile,
                 "power_profile")


@pytest.mark.parametrize("elapsed_s", [0.0, 10.0, 45.0, 300.0, 1e6])
def test_replayed_power_is_the_measurement(trace_jobset, port_jobset,
                                           elapsed_s):
    jt, tt = table_pair(trace_jobset, port_jobset, replay_power=True)
    J, Q = tt.power_profile.shape
    prof, model = tt.power_profile.numpy(), tt.power_prof.numpy()
    measured = (prof >= 0).any(axis=1)
    running = torch.full((1, J), TT.RUNNING, dtype=torch.int32)
    got = tpm.job_node_power_elapsed(
        tt, running, torch.full((1, J), elapsed_s), 20.0)[0].numpy()
    idx = min(int(elapsed_s / 20.0), Q - 1)
    np.testing.assert_array_equal(got[measured], prof[measured, idx])
    np.testing.assert_array_equal(got[~measured], model[~measured, 0])
    want = jpm.job_node_power_elapsed(
        jt, jnp.full((J,), TT.RUNNING, jnp.int32),
        jnp.full((J,), elapsed_s, jnp.float32), 20.0)
    assert_exact(np.asarray(want), got, f"elapsed={elapsed_s}")


@pytest.fixture(scope="module")
def port_case(small_system, port_jobset):
    system = to_port(small_system)
    return system, port_jobset, HORIZON * system.dt


@pytest.mark.parametrize("identity", ["all-sentinel", "compact"])
def test_port_identities_are_bit_for_bit(port_case, identity):
    """All-sentinel replay == the model table, compact == float32: the
    final state, the history and the summary, bit for bit."""
    system, js, t1 = port_case
    if identity == "all-sentinel":
        base = js.to_table(len(js) + 8)
        other = dataclasses.replace(base, power_profile=torch.full(
            (base.num_jobs, js.power_profile.shape[1]), -1.0))
    else:
        base = js.to_table(len(js) + 8, replay_power=True)
        other = js.to_table(len(js) + 8, replay_power=True,
                            compact_time=True)
    scens = [TT.Scenario.make("fcfs", "easy"),
             TT.Scenario.make("replay", "none", setpoint_delta_c=2.0)]
    a = teng.simulate_sweep(system, base, scens, 0.0, t1, device="cpu")
    b = teng.simulate_sweep(system, other, scens, 0.0, t1, device="cpu")
    assert_states_equal(a[0], b[0], f"{identity} final ")
    assert_states_equal(a[1], b[1], f"{identity} hist ")
    for i in range(len(scens)):
        assert tstats.summarize(system, base, TT.row(a[0], i),
                                TT.row(a[1], i)) == tstats.summarize(
            system, other, TT.row(b[0], i), TT.row(b[1], i))


def test_replay_moves_power_not_the_schedule(port_case):
    system, js, t1 = port_case
    scen = TT.Scenario.make("fcfs", "easy")
    f_rep, h_rep = teng.simulate(system, js.to_table(len(js) + 8,
                                                     replay_power=True),
                                 scen, 0.0, t1, device="cpu")
    f_mod, h_mod = teng.simulate(system, js.to_table(len(js) + 8), scen,
                                 0.0, t1, device="cpu")
    assert not torch.equal(h_rep.power_total, h_mod.power_total)
    assert torch.equal(f_rep.jstate, f_mod.jstate)
    assert torch.equal(f_rep.start, f_mod.start)
    # the energy ledger integrates the replayed power
    np.testing.assert_allclose(
        float(f_rep.energy_total),
        float(h_rep.power_total.double().sum()) * system.dt, rtol=1e-4)


@pytest.fixture(scope="module")
def events_replay(small_system, trace_jobset, port_jobset, trace_weather):
    """Replay with the event layer on and the weather week, in both
    engines: the reference's kill scenario, an outage-free row and a
    replay row with a warmer setpoint."""
    assert_threefry_partitionable()
    jt, tt = table_pair(trace_jobset, port_jobset, replay_power=True)
    specs = [("fcfs", "easy", KILL), ("sjf", "first-fit", {}),
             ("replay", "none", dict(setpoint_delta_c=2.0))]
    system = to_port(small_system)
    t1 = HORIZON * system.dt
    tw = ttr.load_weather(DATA_DIR / "weather_week.csv", 360, 20.0)
    want = jeng.simulate_sweep(
        small_system, jt, [JT.Scenario.make(p, b, **kw) for p, b, kw in specs],
        0.0, t1, weather=trace_weather, events=JEventConfig())
    got = teng.simulate_sweep(
        system, tt, [TT.Scenario.make(p, b, **kw) for p, b, kw in specs],
        0.0, t1, weather=tw, events=EventConfig(), device="cpu")
    return want, got


def test_replay_with_events_and_weather_matches_jax(events_replay):
    want, got = events_replay
    assert_runs_match(want, got, RTOL, "replay + events + weather")
    final = got[0]
    assert float(final.events.jobs_killed[0]) > 0, \
        "the kill scenario drew no failure: the composition is vacuous"
    # killed profiled jobs hand their accrued energy to the not-served
    # ledger; survivors + not-served never exceed the IT integral
    lost = float(final.events.energy_lost_j[0])
    assert lost > 0.0
    jobs = float(final.jenergy[0].double().sum())
    assert jobs + lost <= float(final.energy_it[0]) * (1.0 + 1e-5)


def test_compact_replay_matches_jax(small_system, trace_jobset, port_jobset):
    jt, tt = table_pair(trace_jobset, port_jobset, replay_power=True,
                        compact_time=True)
    t1 = HORIZON * small_system.dt
    want = jeng.simulate(small_system, jt, JT.Scenario.make("fcfs", "easy"),
                         0.0, t1)
    got = teng.simulate(to_port(small_system), tt,
                        TT.Scenario.make("fcfs", "easy"), 0.0, t1,
                        device="cpu")
    assert_runs_match(want, got, RTOL, "compact replay")


def test_cli_trace_flags_on_the_cpu(tmp_path, capsys):
    manifest = tmp_path / "run.json"
    weather = DATA_DIR / "weather_week.csv"
    tcli.main(["--system", "marconi100", "--scale", "64", "-t", "20m",
               "--device", "cpu", "--policy", "fcfs", "--backfill", "easy",
               "--trace", *map(str, TELEMETRY), "--trace-cache",
               str(tmp_path / "cache"), "--replay-power", "--weather-trace",
               str(weather), "--manifest", str(manifest)])
    out = capsys.readouterr().out
    assert "policy=fcfs backfill=easy on cpu" in out and "avg_pue" in out
    m = json.loads(manifest.read_text())
    assert m["weather_trace_digest"] == ttr.source_digest(weather)
    assert m["trace_digest"] == ttr.source_digest(*TELEMETRY)
    assert m["scenario"]["replay_power"] is True
    assert m["scenario"]["trace"] == list(map(str, TELEMETRY))
    assert len(list((tmp_path / "cache").iterdir())) == 1
    # the cached trace restarts the run; a sweep takes the weather too
    npz = next((tmp_path / "cache").iterdir())
    tcli.main(["--system", "marconi100", "--scale", "64", "-t", "10m",
               "--device", "cpu", "--trace", str(npz), "--replay-power",
               "--weather-trace", str(weather), "--sweep", "fcfs:easy",
               "sjf"])
    assert capsys.readouterr().out.count("avg_pue") == 2
    with pytest.raises(ttr.TraceError):
        tcli.main(["--device", "cpu", "--trace",
                   str(DATA_DIR / "nope.xyz")])
    with pytest.raises(ValueError, match="power_profile"):
        tcli.main(["--device", "cpu", "--system", "marconi100", "--scale",
                   "64", "--trace", str(DATA_DIR / "pm100_small.parquet"),
                   "--replay-power"])
