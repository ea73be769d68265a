"""The port's snapshot codec (``repro_torch.serve.snapshot``) against
itself and against the JAX package's (``repro.serve.snapshot``).

Round trips are byte-faithful in both dialects (base64 JSON and raw
arrays), NaN and ±inf bit patterns included, with ``carry_digest`` equal
across dialects. The port's payload of a carry built from a JAX carry
(``SimState.from_arrays``) is byte for byte JAX's payload of it, with
both digests equal, on a flat and a 4-hall plant and with the event
layer. A JAX snapshot decoded with a port template resumes in the port
and matches JAX's own resume (the schedule exactly, floats at rtol
1e-4); a port snapshot decodes with JAX's ``decode_carry``. Malformed
payloads fail with ``SnapshotError`` and nothing else (the reference's
``tests/test_serve_properties.py`` cases, and seeded random garbage
where the reference draws it with hypothesis); fork deltas are
validated as the reference validates them, the ML scoring weights
(``alpha``, a scalar or one per scoring column) included.
"""
import json
import random

import jax
import numpy as np
import pytest
import torch

from repro.core import engine as jeng
from repro.core import types as JT
from repro.events import EventConfig as JEventConfig
from repro.launch.simulate import build_system as jbuild
from repro.serve import snapshot as jsnap
from repro_torch.core import engine as teng
from repro_torch.core import types as TT
from repro_torch.events import EventConfig
from repro_torch.serve import snapshot as snap

from test_torch_common import (as_np, assert_runs_match, assert_states_equal,
                               assert_threefry_partitionable, leaves,
                               to_port, workload_pair)

torch.set_num_threads(1)

STEPS = 8
HORIZON = 48
RTOL = 1e-4
FAILURES = dict(node_fail_rate=1e-3, cdu_fail_rate=2e-4, failure_corr=0.5,
                failure_seed=7.0, repair_s=300.0)
CASES = {"flat": (dict(), False), "halls": (dict(halls=4), False),
         "events": (dict(), True)}


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    """A JAX carry after STEPS steps and the port's copy of it."""
    sys_kw, with_events = CASES[request.param]
    if with_events:
        assert_threefry_partitionable()
    jsystem = jbuild("marconi100", scale=64, **sys_kw)
    table, jtable = workload_pair(jsystem, 80, n_jobs=64, load=1.2, seed=3)
    knobs = FAILURES if with_events else {}
    jev = JEventConfig() if with_events else None
    jcarry = jeng.init_state(jsystem, jtable, 0.0, HORIZON * jsystem.dt,
                             num_accounts=8, events=jev)
    jcarry, _ = jeng.simulate_segment(jsystem, jtable, jcarry,
                                      JT.Scenario.make("fcfs", "easy",
                                                       **knobs),
                                      STEPS, events=jev)
    jcarry = jax.tree_util.tree_map(np.asarray, jcarry)
    carry = TT.row(TT.SimState.from_arrays(leaves(jcarry)), 0)
    return dict(name=request.param, jsystem=jsystem, jtable=jtable,
                jcarry=jcarry, system=to_port(jsystem), table=table,
                carry=carry, knobs=knobs, jevents=jev,
                events=EventConfig() if with_events else None)


def port_template(c):
    return teng.init_state(c["system"], c["table"], 0.0,
                           HORIZON * c["system"].dt, num_accounts=8,
                           events=c["events"])


def jax_template(c):
    return jeng.init_state(c["jsystem"], c["jtable"], 0.0,
                           HORIZON * c["jsystem"].dt, num_accounts=8,
                           events=c["jevents"])


# ---------------------------------------------------------------------------
# Round trips.
# ---------------------------------------------------------------------------
def randomized(template, seed):
    """``template`` with every leaf's bytes drawn at random (same dtype
    and shape), the float leaves seasoned with NaN and ±inf."""
    rng = np.random.default_rng(seed)

    def scramble(x):
        if x.dtype.is_floating_point:
            out = rng.normal(size=tuple(x.shape)).astype(np.float32)
            flat = out.reshape(-1)
            if flat.size >= 4:
                flat[0], flat[1], flat[2] = np.nan, np.inf, -np.inf
            return torch.from_numpy(flat.reshape(x.shape))
        info = np.iinfo(np.int32)
        return torch.from_numpy(rng.integers(
            info.min, info.max, size=tuple(x.shape), dtype=np.int32,
            endpoint=True))
    return TT.tree_map(scramble, template)


@pytest.mark.parametrize("seed", [0, 7, 1234])
def test_round_trip_is_byte_faithful(case, seed):
    carry = randomized(port_template(case), seed)
    text = json.loads(json.dumps(snap.encode_carry(carry)))
    raw = snap.encode_carry(carry, binary=True)
    for payload in (text, raw):
        out = snap.decode_carry(payload, carry)
        for (p, a), (_, b) in zip(snap._flatten(carry), snap._flatten(out)):
            assert as_np(a).tobytes() == as_np(b).tobytes(), p
            assert b.device.type == "cpu"
    assert snap.carry_digest(text) == snap.carry_digest(raw)
    assert (snap.snapshot_digest(snap.encode_carry(snap.decode_carry(
        text, carry))) == snap.snapshot_digest(text))
    # a binary leaf is a copy: writing into it never reaches the carry
    raw["leaves"]["t"][...] = 123.0
    assert float(carry.t) != 123.0
    # and a decoded tensor never aliases the payload's array
    out = snap.decode_carry(raw, carry)
    out.node_job.fill_(-7)
    assert (raw["leaves"]["node_job"] != -7).any()


# ---------------------------------------------------------------------------
# Across the two packages.
# ---------------------------------------------------------------------------
def test_payload_of_a_jax_carry_is_jax_payload(case):
    """The converted carry encodes to JAX's bytes: the leaf paths, their
    order, dtypes, shapes and data, so both digests agree too."""
    want = jsnap.encode_carry(case["jcarry"])
    got = snap.encode_carry(case["carry"])
    assert json.dumps(got) == json.dumps(want)
    assert snap.snapshot_digest(got) == jsnap.snapshot_digest(want)
    assert snap.carry_digest(got) == jsnap.carry_digest(want)
    raw = snap.encode_carry(case["carry"], binary=True)
    assert snap.carry_digest(raw) == jsnap.carry_digest(
        jsnap.encode_carry(case["jcarry"], binary=True))
    if case["events"] is not None:
        assert "events.node_down_until" in got["leaves"]
    else:
        assert not any(p.startswith("events") for p in got["leaves"])


def test_jax_snapshot_resumes_in_the_port(case):
    """A JAX snapshot, decoded with a port template, resumes in the port
    as JAX resumes it."""
    payload = json.loads(json.dumps(jsnap.encode_carry(case["jcarry"])))
    carry = snap.decode_carry(payload, port_template(case))
    assert_states_equal(case["carry"], carry)
    scen = dict(policy="sjf", backfill="first-fit", **case["knobs"])
    got = teng.simulate_segment(case["system"], case["table"], carry,
                                TT.Scenario.make(**scen), 2 * STEPS,
                                events=case["events"], device="cpu")
    jcarry = jsnap.decode_carry(payload, jax_template(case))
    want = jeng.simulate_segment(case["jsystem"], case["jtable"], jcarry,
                                 JT.Scenario.make(**scen), 2 * STEPS,
                                 events=case["jevents"])
    want = jax.tree_util.tree_map(np.asarray, want)
    assert_runs_match(want, got, RTOL, f"{case['name']} resume")


def test_port_snapshot_decodes_in_jax(case):
    """A port snapshot of a port-made carry, in both dialects, decodes
    with JAX's ``decode_carry`` and a JAX template, bit for bit."""
    carry, _ = teng.simulate_segment(
        case["system"], case["table"], case["carry"],
        TT.Scenario.make("fcfs", "easy", **case["knobs"]), STEPS,
        events=case["events"], device="cpu")
    for binary in (False, True):
        payload = snap.encode_carry(carry, binary=binary)
        if not binary:
            payload = json.loads(json.dumps(payload))
        out = jsnap.decode_carry(payload, jax_template(case))
        flat = jax.tree_util.tree_flatten_with_path(out)[0]
        mine = snap._flatten(carry)
        assert [jsnap._path_str(p) for p, _ in flat] == [p for p, _ in mine]
        for (path, a), (_, b) in zip(flat, mine):
            a = np.asarray(a)
            assert a.dtype == as_np(b).dtype and \
                a.tobytes() == as_np(b).tobytes(), path


# ---------------------------------------------------------------------------
# Malformed payloads.
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def template():
    jsystem = jbuild("marconi100", scale=64)
    table, _ = workload_pair(jsystem, 64, n_jobs=48, load=1.2, seed=9,
                             duration_s=2 * 3600.0, mean_wall_s=1200.0)
    system = to_port(jsystem)
    return teng.init_state(system, table, 0.0, HORIZON * system.dt,
                           num_accounts=8)


def test_decode_rejects_wrong_shape_and_version(template):
    good = snap.encode_carry(template)
    with pytest.raises(snap.SnapshotError, match="version"):
        snap.decode_carry({**good, "v": 99}, template)
    mangled = json.loads(json.dumps(good))
    mangled["leaves"]["t"]["shape"] = [3]
    with pytest.raises(snap.SnapshotError):
        snap.decode_carry(mangled, template)
    dropped = json.loads(json.dumps(good))
    del dropped["leaves"]["node_job"]
    with pytest.raises(snap.SnapshotError, match="node_job"):
        snap.decode_carry(dropped, template)
    retyped = json.loads(json.dumps(good))
    retyped["leaves"]["step"] = snap.encode_array(np.zeros((), np.int64))
    with pytest.raises(snap.SnapshotError, match="'step'"):
        snap.decode_carry(retyped, template)


GARBAGE_LEAVES = {
    "not an object": 3,
    "no data": {"dtype": "<f4", "shape": []},
    "bad base64": {"dtype": "<f4", "shape": [], "data": "!!!"},
    "bad dtype": {"dtype": "zz", "shape": [], "data": ""},
    "object dtype": {"dtype": "O", "shape": [], "data": "AAAAAAAAAAA="},
    "shape not a list": {"dtype": "<f4", "shape": 5, "data": "AAAAAA=="},
    "negative shape": {"dtype": "<f4", "shape": [-1], "data": ""},
    "two negative dims": {"dtype": "<f4", "shape": [-1, -1],
                          "data": "AAAAAA=="},
    "huge shape": {"dtype": "<f4", "shape": [10 ** 30], "data": ""},
    "short data": {"dtype": "<f4", "shape": [2], "data": "AAAAAA=="},
    "data not text": {"dtype": "<f4", "shape": [], "data": 17},
}


@pytest.mark.parametrize("name", list(GARBAGE_LEAVES))
def test_decode_rejects_garbage_leaves(template, name):
    payload = json.loads(json.dumps(snap.encode_carry(template)))
    payload["leaves"]["t"] = GARBAGE_LEAVES[name]
    with pytest.raises(snap.SnapshotError):
        snap.decode_carry(payload, template)


def random_json(rng: random.Random, depth=0):
    kind = rng.randrange(7 if depth < 3 else 5)
    if kind == 0:
        return None
    if kind == 1:
        return rng.random() < 0.5
    if kind == 2:
        return rng.randint(-10 ** 6, 10 ** 6)
    if kind == 3:
        return rng.uniform(-1e9, 1e9)
    if kind == 4:
        return "".join(rng.choice("v leavesdtypeshapedata0<f4") for _ in
                       range(rng.randrange(8)))
    if kind == 5:
        return [random_json(rng, depth + 1) for _ in range(rng.randrange(4))]
    keys = ["v", "leaves", "t", "dtype", "shape", "data", "x"]
    return {rng.choice(keys): random_json(rng, depth + 1)
            for _ in range(rng.randrange(4))}


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_decode_rejects_random_garbage(template, seed):
    """Whatever JSON arrives, decode succeeds or raises ``SnapshotError``
    (seeded draws standing in for the reference's hypothesis search)."""
    rng = random.Random(seed)
    for _ in range(300):
        payload = random_json(rng)
        if rng.random() < 0.5:
            payload = {"v": 1, "leaves": payload}
        try:
            snap.decode_carry(payload, template)
        except snap.SnapshotError:
            pass


# ---------------------------------------------------------------------------
# Scenario deltas.
# ---------------------------------------------------------------------------
def test_scenario_delta_rejects_unknown_knobs():
    base = TT.Scenario.make("fcfs")
    with pytest.raises(snap.SnapshotError, match="unknown scenario knob"):
        snap.apply_scenario_delta(base, {"warp_factor": 9})
    with pytest.raises(snap.SnapshotError):
        snap.apply_scenario_delta(base, {"policy": "telepathy"})
    with pytest.raises(snap.SnapshotError):
        snap.apply_scenario_delta(base, {"cap_scale": "big"})
    with pytest.raises(snap.SnapshotError):
        snap.apply_scenario_delta(base, {"backfill": True})
    # and the happy path maps names to ids
    scen = snap.apply_scenario_delta(base, {"policy": "thermal_aware",
                                            "cap_scale": 0.9})
    assert int(scen.policy) == TT.POLICY_NAMES["thermal_aware"]
    assert scen.policy.dtype == torch.int32 and scen.policy.ndim == 0
    assert float(scen.cap_scale) == pytest.approx(0.9)


def test_scenario_delta_validates_vector_shapes():
    flat = TT.Scenario.make("fcfs")
    halls = TT.Scenario.make("fcfs", cells_offline=(0.0, 0.0, 0.0, 0.0))
    with pytest.raises(snap.SnapshotError, match="scalar in this session"):
        snap.apply_scenario_delta(flat, {"cells_offline": [1.0, 0.0]})
    with pytest.raises(snap.SnapshotError, match="length 4"):
        snap.apply_scenario_delta(halls, {"cells_offline": [1.0]})
    with pytest.raises(snap.SnapshotError, match="length 4"):
        snap.apply_scenario_delta(
            halls, {"cells_offline": [1.0, 0.0, 0.0, 0.0, 0.0]})
    out = snap.apply_scenario_delta(halls,
                                    {"cells_offline": [1.0, 0.0, 0.0, 0.0]})
    assert out.cells_offline.shape == (4,)
    out = snap.apply_scenario_delta(halls, {"cells_offline": 2.0})
    assert torch.equal(out.cells_offline, torch.full((4,), 2.0))


@pytest.mark.parametrize("delta", [{"alpha": 0.5}, {"alpha": [0.1, 0.2]},
                                   {"alpha": 0.0, "cap_scale": 0.9}])
def test_alpha_delta_is_refused_by_name(delta):
    """``alpha`` (refused by name until the ML layer was ported, hence the
    test's name) merges as the reference merges it: a scalar on a scalar
    session or broadcast over a vector one, a vector of the session's
    length K; any other shape is the reference's ``SnapshotError``."""
    for alpha in (0.0, (1.0, 1.0, 1.0, 0.5)):
        port = TT.Scenario.make("ml", "first-fit", alpha=alpha)
        ref = JT.Scenario.make("ml", "first-fit", alpha=alpha)
        try:
            merged = jsnap.apply_scenario_delta(ref, delta)
        except jsnap.SnapshotError as e:
            with pytest.raises(snap.SnapshotError) as err:
                snap.apply_scenario_delta(port, delta)
            # the same refusal (the reference's tail names its tracer)
            assert str(err.value).split(";")[0] == str(e).split(";")[0]
            continue
        got = snap.apply_scenario_delta(port, delta)
        for name, w in leaves(merged).items():
            np.testing.assert_array_equal(as_np(getattr(got, name)), w,
                                          err_msg=f"{alpha} {delta} {name}")
            assert as_np(getattr(got, name)).dtype == w.dtype, name
        assert snap.encode_scenario(got) == jsnap.encode_scenario(merged)
    with pytest.raises(snap.SnapshotError, match="scalar in this session"):
        snap.apply_scenario_delta(TT.Scenario.make("ml"),
                                  {"alpha": [1.0, 1.0, 1.0, 0.5]})
    with pytest.raises(snap.SnapshotError, match="length 4"):
        snap.apply_scenario_delta(TT.Scenario.make("ml", alpha=(1.0,) * 4),
                                  {"alpha": [0.1, 0.2]})


SCENARIOS = [
    ("fcfs", "easy", {}),
    ("thermal_aware", "first-fit", dict(cells_offline=(1.0, 0.0, 2.0, 0.0),
                                        setpoint_delta_c=1.5)),
    ("carbon_aware", "none", dict(carbon_weight=2.0, cap_scale=0.85,
                                  dr_announce_s=600.0, dr_notice_s=300.0,
                                  dr_duration_s=900.0, dr_cap_w=1e5,
                                  **FAILURES)),
    ("ml", "first-fit", dict(alpha=(1.0, 1.0, 1.0, 0.5))),
]
DELTAS = [{}, {"setpoint_delta_c": 2.0}, {"policy": "sjf", "backfill": 2},
          {"cells_offline": 1.0}, {"node_fail_rate": 2e-4,
                                   "failure_seed": 7, "repair_s": 600.0},
          {"dr_cap_w": 123456.7, "dr_announce_s": 3600}, {"alpha": 0.25}]


@pytest.mark.parametrize("scen", range(len(SCENARIOS)))
def test_scenario_codec_matches_jax(scen):
    """``encode_scenario`` is the reference's, ``alpha`` and the knobs'
    order included, and every delta merges to the reference's knobs bit
    for bit."""
    p, b, kw = SCENARIOS[scen]
    port, ref = TT.Scenario.make(p, b, **kw), JT.Scenario.make(p, b, **kw)
    assert list(snap.encode_scenario(port).items()) == \
        list(jsnap.encode_scenario(ref).items())
    for delta in DELTAS:
        got = snap.apply_scenario_delta(port, delta)
        merged = jsnap.apply_scenario_delta(ref, delta)
        for name, w in leaves(merged).items():
            np.testing.assert_array_equal(as_np(getattr(got, name)), w,
                                          err_msg=f"{delta} {name}")
            assert as_np(getattr(got, name)).dtype == w.dtype, name
