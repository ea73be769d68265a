"""Account ledgers as JSON and the sharded sweep of the port, against the
JAX package and against the port itself, on the CPU.

* Ledgers (``repro_torch.core.accounts``): a ledger written by either
  package loads in the other exactly (float32 through the JSON and
  back), a ledger saved before the grid fields existed loads with zeros
  for them, and a ledger shorter than the backlog's account ids runs as
  the reference runs it: the folds drop the jobs of ids past its end
  and the ``acct_*`` keys read its last entry for them (JAX clamps an
  out-of-range gather). The JAX sweep with such a ledger is matched:
  schedules exactly, floats at rtol 1e-4.
* ``simulate_sweep_sharded``: any split of the rows across devices
  (here CPU "devices", 5 rows on 3: chunks of 2, 2 and 1) equals one
  ``simulate_sweep`` batch bit for bit, with a warm ledger, grid
  signals, a per-scenario weather list and the event layer; one device
  is ``simulate_sweep``, and its schedules equal the JAX package's
  ``simulate_sweep_sharded`` on its one CPU device.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.core import accounts as jacct  # noqa: E402
from repro.core import engine as jeng  # noqa: E402
from repro.core import types as JT  # noqa: E402
from repro.systems.config import get_system  # noqa: E402
from repro_torch.cooling import weather as twx  # noqa: E402
from repro_torch.core import accounts as tacct  # noqa: E402
from repro_torch.core import engine as teng  # noqa: E402
from repro_torch.core import types as TT  # noqa: E402
from repro_torch.events import EventConfig  # noqa: E402
from test_torch_common import (as_np, assert_exact,  # noqa: E402
                               assert_runs_match, assert_states_equal,
                               four_hall, port_signals, to_port,
                               workload_pair)

SYS = get_system("marconi100").scaled(64)
TSYS = to_port(SYS)
N_ACCOUNTS = 8
STEPS = 90
T1 = STEPS * SYS.dt
SPECS = [("acct_fugaku_pts", "first-fit", {}), ("fcfs", "easy", {}),
         ("acct_edp", "none", {}), ("sjf", "first-fit", {}),
         ("acct_low_avg_power", "easy", {})]
FIELDS = [f.name for f in dataclasses.fields(TT.AccountStats)]


def ledger(n, seed):
    """A warm ledger of ``n`` accounts as {field: float32 array}."""
    rng = np.random.default_rng(seed)
    d = {k: rng.uniform(0.0, 1e6, n).astype(np.float32) for k in FIELDS}
    d["jobs_done"] = rng.integers(0, 20, n).astype(np.float32)
    return d


@pytest.fixture(scope="module")
def tables():
    return workload_pair(SYS, 80, n_jobs=64, load=1.4, seed=12,
                         n_accounts=N_ACCOUNTS)


def scens(specs=SPECS):
    return [TT.Scenario.make(p, b, **kw) for p, b, kw in specs]


# ---------------------------------------------------------------------------
# Ledgers as JSON.
# ---------------------------------------------------------------------------
def test_a_jax_ledger_loads_in_the_port_exactly(tmp_path):
    d = ledger(N_ACCOUNTS, 1)
    path = tmp_path / "accounts.json"
    jacct.save_json(JT.AccountStats(**{k: jnp.asarray(v)
                                       for k, v in d.items()}), str(path))
    got = tacct.load_json(path, device="cpu")
    for k in FIELDS:
        assert_exact(d[k], getattr(got, k), k)
    # and back: the port's file is the reference's, byte for byte
    tacct.save_json(got, tmp_path / "again.json")
    assert (tmp_path / "again.json").read_text() == path.read_text()


def test_a_port_ledger_loads_in_jax_exactly(tmp_path):
    d = ledger(N_ACCOUNTS, 2)
    path = tmp_path / "accounts.json"
    tacct.save_json(TT.AccountStats(**{k: torch.from_numpy(v)
                                       for k, v in d.items()}), path)
    assert list(json.loads(path.read_text())) == FIELDS
    got = jacct.load_json(str(path))
    for k in FIELDS:
        assert_exact(d[k], np.asarray(getattr(got, k)), k)
    assert tacct.to_json_dict(tacct.from_json_dict(
        json.loads(path.read_text()), "cpu")) == json.loads(path.read_text())


def test_a_ledger_without_grid_fields_loads_with_zeros(tmp_path):
    d = {k: v.tolist() for k, v in ledger(5, 3).items()
         if k not in ("carbon_kg", "cost")}
    path = tmp_path / "old.json"
    path.write_text(json.dumps(d))
    got, want = tacct.load_json(path, device="cpu"), jacct.load_json(
        str(path))
    for k in FIELDS:
        assert_exact(np.asarray(getattr(want, k)), getattr(got, k), k)
    assert not got.carbon_kg.any() and not got.cost.any()
    assert got.carbon_kg.dtype == torch.float32


def test_load_json_defaults_to_the_card(tmp_path):
    path = tmp_path / "accounts.json"
    tacct.save_json(TT.AccountStats.zeros(3), path)
    if torch.cuda.is_available():
        assert tacct.load_json(path).jobs_done.is_cuda
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tacct.load_json(path)


def test_a_short_ledger_runs_as_the_reference_runs_it(tables):
    """A 4-account ledger under a backlog of ids 0-7: the ids past its
    end fold nowhere and rank by its last entry, in both packages."""
    ttable, jtable = tables
    assert int(ttable.account.max()) >= 4
    d = ledger(4, 4)
    specs = [("acct_fugaku_pts", "first-fit", {}),
             ("acct_avg_power", "easy", {}), ("acct_edp", "none", {})]
    want = jeng.simulate_sweep(
        SYS, jtable, [JT.Scenario.make(p, b) for p, b, _ in specs], 0.0,
        4 * T1, JT.AccountStats(**{k: jnp.asarray(v) for k, v in d.items()}))
    got = teng.simulate_sweep(
        TSYS, ttable, scens(specs), 0.0, 4 * T1,
        TT.AccountStats(**{k: torch.from_numpy(v) for k, v in d.items()}),
        device="cpu")
    assert_runs_match(want, got, what="short ledger")
    # each row's ledger counts exactly its completed jobs of ids 0-3
    folded = as_np(got[0].accounts.jobs_done) - d["jobs_done"]
    done = as_np(got[0].jstate) == TT.DONE
    inside = as_np(ttable.account) < 4
    assert folded.shape == (3, 4)
    assert (folded.sum(1) == (done & inside).sum(1)).all()
    assert (done & ~inside).any()


# ---------------------------------------------------------------------------
# simulate_sweep_sharded.
# ---------------------------------------------------------------------------
def _case(name, system):
    """simulate_sweep's keywords for one of the split cases."""
    n = STEPS
    if name == "warm-ledger":
        return dict(accounts=TT.AccountStats(**{
            k: torch.from_numpy(v) for k, v in ledger(N_ACCOUNTS, 5).items()}))
    if name == "grid-signals":
        return dict(signals=port_signals(system, n))
    if name == "weather-list":
        return dict(weather=[twx.synthetic_weather(n, system.dt,
                                                   t_wb_mean_c=20.0 + s,
                                                   seed=s)
                             for s in range(len(SPECS))])
    assert name == "events"
    return dict(events=EventConfig())


EVENT_KNOBS = [dict(failure_seed=float(s), node_fail_rate=8e-5,
                    cdu_fail_rate=2e-5, failure_corr=0.5, repair_s=900.0)
               for s in range(len(SPECS))]


@pytest.mark.parametrize("case", ["warm-ledger", "grid-signals",
                                  "weather-list", "events"])
def test_any_split_equals_one_batch_bit_for_bit(case, tables):
    ttable, _ = tables
    system = TSYS
    specs = SPECS
    if case == "weather-list":
        system = to_port(four_hall(SYS))
    if case == "events":
        specs = [(p, b, k) for (p, b, _), k in zip(SPECS, EVENT_KNOBS)]
    kw = dict(_case(case, system), num_accounts=N_ACCOUNTS)
    want = teng.simulate_sweep(system, ttable, scens(specs), 0.0, T1, **kw,
                               device="cpu")
    got = teng.simulate_sweep_sharded(system, ttable, scens(specs), 0.0, T1,
                                      **kw, devices=["cpu"] * 3)
    assert_states_equal(want[0], got[0], "final ")
    assert_states_equal(want[1], got[1], "history ")
    if case == "events":
        assert (as_np(want[1].nodes_down) > 0).any()


def test_fewer_rows_than_devices_and_one_device(tables):
    ttable, _ = tables
    kw = dict(num_accounts=N_ACCOUNTS, accounts=_case(
        "warm-ledger", TSYS)["accounts"])
    for n_rows, devices in ((2, ["cpu"] * 3), (5, ["cpu"])):
        want = teng.simulate_sweep(TSYS, ttable, scens(SPECS[:n_rows]), 0.0,
                                   T1, **kw, device="cpu")
        got = teng.simulate_sweep_sharded(TSYS, ttable, scens(SPECS[:n_rows]),
                                          0.0, T1, **kw, devices=devices)
        assert_states_equal(want[0], got[0], f"{n_rows} rows final ")
        assert_states_equal(want[1], got[1], f"{n_rows} rows history ")


def test_one_device_matches_jax_sharded_sweep(tables):
    """The reference's sharded sweep on its one CPU device is its
    ``simulate_sweep``; the port's on one device is the port's."""
    import jax
    assert len(jax.devices()) == 1
    ttable, jtable = tables
    d = ledger(N_ACCOUNTS, 6)
    want = jeng.simulate_sweep_sharded(
        SYS, jtable, [JT.Scenario.make(p, b) for p, b, _ in SPECS], 0.0, T1,
        JT.AccountStats(**{k: jnp.asarray(v) for k, v in d.items()}))
    got = teng.simulate_sweep_sharded(
        TSYS, ttable, scens(), 0.0, T1,
        TT.AccountStats(**{k: torch.from_numpy(v) for k, v in d.items()}),
        devices=["cpu"])
    assert_runs_match(want, got, what="sharded, one device")


def test_a_missing_device_raises_and_never_falls_back(tables):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default devices are usable")
    ttable, _ = tables
    for devices in (None, ["cpu", "cuda"], ["cuda"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            teng.simulate_sweep_sharded(TSYS, ttable, scens(), 0.0, T1,
                                        num_accounts=N_ACCOUNTS,
                                        devices=devices)
    with pytest.raises(ValueError, match="one weather trace per scenario"):
        teng.simulate_sweep_sharded(
            TSYS, ttable, scens(), 0.0, T1, num_accounts=N_ACCOUNTS,
            weather=[twx.constant_weather(STEPS, 18.0)] * 2,
            devices=["cpu"] * 2)
