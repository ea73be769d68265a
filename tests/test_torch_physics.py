"""Parity of the port's physics with the JAX package: power model,
conversion losses, the fused cooling step, thermal signals and PUE.

The port runs a batch of scenarios at once ([S, ...]); the JAX functions
run one scenario each. Floats are held at 1e-5 relative: the one-hot
products sum groups and halls in another order than XLA's, a few ulps
over a few steps. The profile lookup is exact.
"""
import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.cooling import model as jcool
from repro.core import types as JT
from repro.power import losses as jloss
from repro.power import model as jpow
from repro.systems.config import get_system
from repro_torch.cooling import model as tcool
from repro_torch.core import types as TT
from repro_torch.power import losses as tloss
from repro_torch.power import model as tpow

from test_torch_common import as_np, assert_exact, four_hall, leaves, \
    to_port

torch.set_num_threads(1)

RTOL = 1e-5
BASE = get_system("marconi100").scaled(64)


def _table(rng, J=12, P=5):
    t = JT.JobTable(
        submit=jnp.zeros(J), limit=jnp.full(J, 600.0), wall=jnp.full(J, 500.0),
        nodes=jnp.asarray(rng.integers(1, 6, J), jnp.int32),
        priority=jnp.zeros(J), account=jnp.zeros(J, jnp.int32),
        rec_start=jnp.zeros(J), first_node=jnp.full(J, -1, jnp.int32),
        score=jnp.zeros(J),
        power_prof=jnp.asarray(rng.uniform(200.0, 2200.0, (J, P)),
                               jnp.float32),
        util_prof=jnp.ones((J, P)) * 0.5, valid=jnp.ones(J, bool))
    return t, TT.JobTable.from_arrays(leaves(t))


def test_power_model_and_losses():
    rng = np.random.default_rng(0)
    jt, tt = _table(rng)
    S, J = 3, jt.num_jobs
    jstate = rng.choice([JT.RUNNING, JT.QUEUED, JT.DONE], (S, J)).astype(
        np.int32)
    # exact multiples of prof_dt, in-between values and past the trace end
    elapsed = (rng.integers(0, 8, (S, J)) * 20.0 +
               rng.choice([0.0, 7.5, 19.99], (S, J))).astype(np.float32)
    node_job = rng.integers(-1, J, (S, 40)).astype(np.int32)
    t_pw = tpow.job_node_power_elapsed(tt, torch.from_numpy(jstate),
                                       torch.from_numpy(elapsed), 20.0)
    t_node = tpow.node_power(to_port(BASE), tt, torch.from_numpy(node_job),
                             t_pw)
    for s in range(S):
        j_pw = jpow.job_node_power_elapsed(jt, jnp.asarray(jstate[s]),
                                           jnp.asarray(elapsed[s]), 20.0)
        assert_exact(j_pw, t_pw[s], "job power")
        j_node = jpow.node_power(BASE, jt, jnp.asarray(node_job[s]), j_pw)
        assert_exact(j_node, t_node[s], "node power")
        np.testing.assert_allclose(as_np(tpow.system_it_power(t_node))[s],
                                   float(jpow.system_it_power(j_node)),
                                   rtol=RTOL)
    p_it = np.asarray([1e3, 1e5, 1e6, 5e6, 4e7], np.float32)
    want = jloss.conversion(BASE.power, jnp.asarray(p_it), 10.0)
    got = tloss.conversion(to_port(BASE).power, torch.from_numpy(p_it), 10.0)
    for w, g in zip(want, got):
        np.testing.assert_allclose(as_np(g), np.asarray(w), rtol=RTOL)


@pytest.mark.parametrize("halls", [1, 4])
def test_cooling_steps_thermal_and_pue(halls):
    """A few steps of the fused cooling step for 3 scenarios with their own
    setpoint offsets and maintenance, hot enough to engage heat reuse, fan
    staging and the thermal signals."""
    system = BASE if halls == 1 else four_hall(BASE)
    cfg = dataclasses.replace(system.cooling, reuse_t_min_c=30.0)
    tcfg = to_port(cfg)
    S, N, H = 3, system.n_nodes, cfg.n_halls
    deltas = np.asarray([0.0, -2.0, 1.5], np.float32)
    offline = np.zeros((S, H), np.float32)
    offline[1, 0] = 1.0
    offline[2, -1] = 0.5
    rng = np.random.default_rng(halls)
    j_states = [jcool.init_state(cfg) for _ in range(S)]
    t_state = TT.tree_map(lambda x: x.unsqueeze(0).repeat(S, *[1] * x.ndim),
                          tcool.init_state(tcfg))
    for step in range(6):
        node_pw = rng.uniform(2e3, 2e4, (S, N)).astype(np.float32)
        t_th = tcool.thermal_now(tcfg, t_state, torch.from_numpy(deltas))
        t_state, t_out, t_pit = tcool.step_from_node_power(
            tcfg, t_state, torch.from_numpy(node_pw), system.dt,
            torch.from_numpy(deltas), torch.from_numpy(offline))
        for s in range(S):
            j_th = jcool.thermal_now(cfg, j_states[s], deltas[s])
            for name, w in j_th._asdict().items():
                np.testing.assert_allclose(as_np(getattr(t_th, name)[s]),
                                           np.asarray(w), rtol=RTOL,
                                           err_msg=f"thermal {name}")
            j_states[s], j_out, j_pit = jcool.step_from_node_power(
                cfg, j_states[s], jnp.asarray(node_pw[s]), system.dt,
                None, deltas[s], jnp.asarray(offline[s]))
            np.testing.assert_allclose(as_np(t_pit[s]), float(j_pit),
                                       rtol=RTOL)
            for name, w in j_out._asdict().items():
                np.testing.assert_allclose(
                    as_np(getattr(t_out, name)[s]), np.asarray(w), rtol=RTOL,
                    err_msg=f"step {step} out {name}")
            for name, w in vars(j_states[s]).items():
                np.testing.assert_allclose(
                    as_np(getattr(t_state, name)[s]), np.asarray(w),
                    rtol=RTOL, err_msg=f"step {step} state {name}")
            p_in, p_loss = jloss.conversion(BASE.power, j_pit, 1.0)
            np.testing.assert_allclose(
                as_np(tcool.pue(t_pit, tloss.conversion(
                    to_port(BASE).power, t_pit, 1.0)[1], t_out.p_cooling)[s]),
                float(jcool.pue(j_pit, p_loss, j_out.p_cooling)), rtol=RTOL)
    # the run was hot: heat export engaged and the unmaintained plant's
    # fans run
    assert (t_out.q_reuse_w > 0).all() and t_out.p_fan[0] > 0
