"""Parity of the port's scheduler, resource manager and ledgers with the
JAX package.

Policy keys, the queue order (ties and +inf keys included), placements,
start/end times and the node map must match exactly: they are integer
decisions and float times computed by the same IEEE operations. The
ledger sums are held at 1e-6 relative: the port sums each account in
float64 (deterministic on the card), the reference in float32.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.cooling import model as jcool
from repro.core import accounts as jacct
from repro.core import engine as jeng
from repro.core import resource_manager as jrm
from repro.core import scheduler as jsched
from repro.core import types as JT
from repro.datasets.synthetic import WorkloadSpec, generate
from repro.systems.config import get_system
from repro_torch.cooling import model as tcool
from repro_torch.core import accounts as tacct
from repro_torch.core import resource_manager as trm
from repro_torch.core import scheduler as tsched
from repro_torch.core import types as TT

from test_torch_common import assert_exact, four_hall, leaves, to_port

torch.set_num_threads(1)

ALL_POLICIES = list(JT.POLICY_NAMES)


def _batch(x, S):
    return x.unsqueeze(0).repeat(S, *[1] * x.ndim)


def _ledger(rng, A=8):
    vals = {f.name: jnp.asarray(rng.uniform(0.0, 50.0, A), jnp.float32)
            for f in dataclasses.fields(JT.AccountStats)}
    vals["jobs_done"] = jnp.asarray(rng.integers(0, 4, A), jnp.float32)
    return JT.AccountStats(**vals)


def _thermal(excess):
    """JAX ThermalNow with a non-zero soft-band excess (flat plant)."""
    z = jnp.float32(0.0)
    return jcool.ThermalNow(excess=jnp.float32(excess), overheat=jnp.bool_(False),
                            t_return_max=z, t_supply_max=z,
                            excess_hall=jnp.asarray([excess], jnp.float32),
                            overheat_hall=jnp.zeros((1,), bool))


def _t_thermal(jth, S):
    return tcool.ThermalNow(*(_batch(torch.tensor(np.asarray(v)), S)
                              for v in jth))


def _tie_table(seed=0, J=30, pad=6):
    """A job table full of ties: few distinct submit times, limits, sizes
    and priorities, some recorded starts in the future, padded rows."""
    rng = np.random.default_rng(seed)
    Jp = J + pad
    f32 = lambda a, fill: np.concatenate([a, np.full(pad, fill)]).astype(
        np.float32)
    m = dict(
        submit=f32(rng.choice([0.0, 60.0, 120.0], J), np.inf),
        limit=f32(rng.choice([600.0, 1200.0], J), 1.0),
        wall=f32(rng.choice([300.0, 900.0], J), 1.0),
        nodes=np.concatenate([rng.integers(1, 5, J), np.ones(pad)]).astype(
            np.int32),
        priority=f32(rng.choice([1.0, 2.0], J), 0.0),
        account=np.concatenate([rng.integers(0, 8, J),
                                np.zeros(pad)]).astype(np.int32),
        rec_start=f32(rng.choice([0.0, 100.0, 5000.0], J), np.inf),
        first_node=np.full(Jp, -1, np.int32),
        score=np.zeros(Jp, np.float32),
        power_prof=rng.uniform(200.0, 2000.0, (Jp, 3)).astype(np.float32),
        util_prof=np.full((Jp, 3), 0.5, np.float32),
        valid=np.arange(Jp) < J)
    jt = JT.JobTable(**{k: jnp.asarray(v) for k, v in m.items()})
    jstate = rng.choice([JT.QUEUED, JT.QUEUED, JT.RUNNING, JT.PENDING],
                        Jp).astype(np.int32)
    return jt, TT.JobTable.from_arrays(m), jstate


def test_policy_key_every_policy_exact():
    jt, tt, _ = _tie_table()
    rng = np.random.default_rng(1)
    ledger = _ledger(rng)
    jth = _thermal(0.37)
    kw = dict(acct_weight=1.5, thermal_weight=2.0)
    # the carbon/price weights act on grid signals only (the port has none
    # yet): the reference's keys must not depend on them without signals
    grid_kw = dict(carbon_weight=3.0, price_weight=0.5)
    S = len(ALL_POLICIES)
    tscen = TT.stack_scenarios([TT.Scenario.make(p, **kw)
                                for p in ALL_POLICIES])
    taccts = TT.tree_map(lambda x: _batch(x, S), TT.AccountStats(
        **{k: torch.tensor(v) for k, v in leaves(ledger).items()}))
    got = tsched.policy_key(tt, taccts, tscen, _t_thermal(jth, S))
    for i, p in enumerate(ALL_POLICIES):
        want = jsched.policy_key(jt, ledger,
                                 JT.Scenario.make(p, **kw, **grid_kw),
                                 thermal=jth)
        assert_exact(want, got[i], p)
        # the static (one-policy) path of the reference agrees too
        static = JT.Scenario(policy=JT.POLICY_NAMES[p], backfill=0, **kw,
                             **grid_kw)
        assert_exact(jsched.policy_key(jt, ledger, static, thermal=jth),
                     got[i], f"{p} static")


def test_queue_order_ties_and_inf_exact():
    jt, tt, jstate = _tie_table(seed=3)
    jst = JT.SimState(**{**vars(jeng.init_state(get_system("marconi100")
                                                .scaled(32), jt, 0.0, 7200.0,
                                                num_accounts=8)),
                         "t": jnp.float32(1800.0),
                         "jstate": jnp.asarray(jstate)})
    ledger = _ledger(np.random.default_rng(2))
    policies = ["fcfs", "sjf", "ljf", "priority", "ml", "replay",
                "acct_edp", "thermal_aware"]
    S = len(policies)
    tst = TT.SimState.from_arrays(leaves(jst))
    tst = TT.tree_map(lambda x: x.expand(S, *x.shape[1:]).clone(), tst)
    tst = dataclasses.replace(tst, accounts=TT.AccountStats(
        **{k: _batch(torch.tensor(v), S) for k, v in leaves(ledger).items()}))
    jth = _thermal(0.0)
    order, elig = tsched.queue_order(
        tt, tst, tst.accounts,
        TT.stack_scenarios([TT.Scenario.make(p) for p in policies]),
        _t_thermal(jth, S))
    for i, p in enumerate(policies):
        w_order, w_elig = jsched.queue_order(jt, jst, ledger,
                                             JT.Scenario.make(p), thermal=jth)
        assert_exact(w_elig, elig[i], f"{p} eligible")
        assert_exact(np.asarray(w_order).astype(np.int64), order[i],
                     f"{p} order")
        assert 0 < int(elig[i].sum()) < tt.num_jobs   # inf keys present


def _backlog(system, seed=5):
    spec = WorkloadSpec(n_jobs=60, duration_s=7200.0, load=2.5, trace_len=4,
                        mean_wall_s=1800.0, seed=seed, max_frac_nodes=0.6,
                        n_accounts=8)
    js = generate(system, spec)
    # placements recorded for the jobs running at t = 2400: at t = 3600
    # some of them still run (a release profile for EASY), part of the
    # machine is free and the jobs submitted since wait in the queue
    js.assign_prepop_placement(2400.0, system.n_nodes)
    jt = js.to_table(64)
    jst = jeng.init_state(system, jt, 3600.0, 7200.0, num_accounts=8)
    # a non-trivial ledger so the account policies order by it
    jst = JT.SimState(**{**vars(jst), "accounts": _ledger(
        np.random.default_rng(seed))})
    return jt, jst


SCHED_CASES = [("fcfs", "none"), ("fcfs", "easy"), ("sjf", "first-fit"),
               ("ljf", "easy"), ("replay", "none"),
               ("thermal_aware", "easy"), ("acct_edp", "first-fit"),
               ("priority", "none")]


@pytest.mark.parametrize("halls", [1, 4])
def test_schedule_step_placements_exact(halls):
    base = get_system("marconi100").scaled(32)
    system = base if halls == 1 else four_hall(base)
    jt, jst = _backlog(system)
    if halls > 1:
        # hall 0 has lost its supply setpoint, halls 1-3 run warm to
        # different degrees: the hall-aware order and gate both engage
        G = system.cooling.n_groups
        t_sup = np.full(G, system.cooling.t_supply_setpoint_c, np.float32)
        t_sup[0] += system.cooling.t_supply_margin_c + 1.0
        t_ret = np.asarray([36.0, 32.5, 31.0, 33.5], np.float32)
        jst = JT.SimState(**{**vars(jst), "cooling": JT.CoolingState(
            **{**vars(jst.cooling), "t_supply": jnp.asarray(t_sup),
               "t_return": jnp.asarray(t_ret)})})
    jth = jcool.thermal_now(system.cooling, jst.cooling, 0.0)
    scens = [JT.Scenario.make(p, b) for p, b in SCHED_CASES]
    run = jax.jit(jax.vmap(lambda sc: jsched.schedule_step(
        system, jt, jst, sc, thermal=jth)))
    want = run(JT.stack_scenarios(scens))

    S = len(scens)
    tsys, tt = to_port(system), TT.JobTable.from_arrays(leaves(jt))
    tst = TT.tree_map(lambda x: x.expand(S, *x.shape[1:]).clone(),
                      TT.SimState.from_arrays(leaves(jst)))
    tscen = TT.stack_scenarios([TT.Scenario.make(p, b)
                                for p, b in SCHED_CASES])
    tth = tcool.thermal_now(tsys.cooling, tst.cooling, tscen.setpoint_delta_c)
    for name, v in jth._asdict().items():
        assert_exact(np.broadcast_to(np.asarray(v), (S,) + np.shape(v)),
                     getattr(tth, name), f"thermal {name}")
    got = tsched.schedule_step(tsys, tt, tst, tscen, thermal=tth)
    for name in ("jstate", "start", "end", "node_job", "free_count"):
        assert_exact(getattr(want, name), getattr(got, name), name)
    # the pass really admitted work, and held some back
    placed = (np.asarray(want.jstate) == JT.RUNNING).sum(1) - \
        (np.asarray(jst.jstate) == JT.RUNNING).sum()
    assert placed.max() > 0 and (np.asarray(want.jstate) == JT.QUEUED).any()
    if halls > 1:
        oh = np.asarray(jth.overheat_hall)
        assert oh[0] and not oh[1:].any()


def test_resource_manager_exact():
    rng = np.random.default_rng(4)
    S, N, J = 3, 48, 20
    node_job = rng.integers(-1, J, (S, N)).astype(np.int32)
    done = rng.random((S, J)) < 0.3
    need = rng.integers(0, 20, S).astype(np.int32)
    order = np.stack([rng.permutation(N) for _ in range(S)]).astype(np.int32)
    released = trm.release_done(torch.from_numpy(node_job),
                                torch.from_numpy(done))
    ff = trm.firstfree_mask(released, torch.from_numpy(need))
    ffo = trm.firstfree_mask_ordered(released, torch.from_numpy(need),
                                     torch.from_numpy(order).long())
    for s in range(S):
        r = jrm.release_done(jnp.asarray(node_job[s]), jnp.asarray(done[s]))
        assert_exact(r, released[s], "release_done")
        assert_exact(jrm.firstfree_mask(r, jnp.int32(need[s])), ff[s],
                     "firstfree")
        assert_exact(jrm.firstfree_mask_ordered(r, jnp.int32(need[s]),
                                                jnp.asarray(order[s])),
                     ffo[s], "firstfree_ordered")
    first = np.asarray([0, 5, -1, 9, 30], np.int32)
    nodes = np.asarray([5, 4, 3, 10, 18], np.int32)
    run0 = np.asarray([True, True, False, True, True])
    assert_exact(jrm.prepopulate(N, jnp.asarray(first), jnp.asarray(nodes),
                                 jnp.asarray(run0)),
                 trm.prepopulate(N, torch.from_numpy(first),
                                 torch.from_numpy(nodes),
                                 torch.from_numpy(run0)), "prepopulate")


def test_fold_completions_matches_and_is_batch_invariant():
    system = get_system("marconi100").scaled(32)
    jt, jst = _backlog(system, seed=8)
    rng = np.random.default_rng(9)
    J = jt.num_jobs
    S = 3
    done = rng.random((S, J)) < 0.4
    start = np.where(rng.random((S, J)) < 0.8,
                     rng.uniform(0, 3000, (S, J)), np.inf).astype(np.float32)
    end = (start + rng.uniform(60, 4000, (S, J))).astype(np.float32)
    done &= np.isfinite(start)        # a completed job has started
    jenergy = rng.uniform(1e5, 1e8, (S, J)).astype(np.float32)
    tsys, tt = to_port(system), TT.JobTable.from_arrays(leaves(jt))
    tacc = TT.tree_map(lambda x: _batch(x, S), TT.AccountStats(
        **{k: torch.tensor(v) for k, v in leaves(jst.accounts).items()}))
    args = [torch.from_numpy(a) for a in (done, start, end, jenergy)]
    got = tacct.fold_completions(tsys, tt, tacc, *args)
    for s in range(S):
        want = jax.jit(lambda *a: jacct.fold_completions(system, jt, *a))(
            jst.accounts, *(jnp.asarray(a[s]) for a in
                            (done, start, end, jenergy)))
        for name, w in vars(want).items():
            np.testing.assert_allclose(getattr(got, name)[s].numpy(),
                                       np.asarray(w), rtol=1e-6, err_msg=name)
        # one scenario alone sums to the same bits as inside the batch
        one = tacct.fold_completions(
            tsys, tt, TT.tree_map(lambda x: x[s:s + 1], tacc),
            *(a[s:s + 1] for a in args))
        for name in vars(want):
            assert torch.equal(getattr(one, name)[0], getattr(got, name)[s])
