"""The port's wire (``repro_torch.core.transport`` and the host part of
``repro_torch.core.external``) against the reference's.

The framing units of ``tests/test_binary_wire.py`` and
``tests/test_transport.py`` on the port: special floats, empty and 0-d
arrays, the reserved key and bad dtypes, an oversize and a truncated
frame, ``read_any_frame`` passing NDJSON through, the failure classes of
``read_frame``, ``decode_schedule`` validation and the address forms.
The binary-vs-NDJSON property of ``tests/test_wire_properties.py`` as a
hypothesis test, plus its falsifying example as fixed cases: there the
port departs from the reference on purpose (``_bin_restore`` reads
exactly each array's bytes), and the departure is named below.

The copy held equal: for seeded messages the port's NDJSON and RBW1
bytes equal the reference's byte for byte, and wherever the reference
decodes a frame the port decodes it to the same message; the digests
and the running-set envelopes agree, error messages included.
"""
import io
import json
import socket

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core import external as jext
from repro.core import transport as jtr
from repro.datasets import synthetic as jsyn
from repro.systems.config import get_system as jget
from repro_torch.core import external as ext
from repro_torch.core import transport as tr
from repro_torch.datasets import synthetic as tsyn

from test_torch_common import to_port

torch.set_num_threads(1)

BIN_DTYPES = ["<f8", "<f4", "<i8", "<i4", "<u8", "<u4", "|b1"]


def roundtrip(msg, as_arrays=True):
    """Encode as an RBW1 frame and read it back through the byte layer."""
    buf = io.BytesIO()
    tr.write_bin_frame(buf, msg)
    buf.seek(0)
    return tr.read_any_frame(buf, as_arrays=as_arrays)


# ---------------------------------------------------------------------------
# Codec units (tests/test_binary_wire.py).
# ---------------------------------------------------------------------------
def test_binary_roundtrip_preserves_special_floats_exactly():
    arr = np.array([np.nan, np.inf, -np.inf, 0.0, -0.0, 1e-308], np.float64)
    got = roundtrip({"version": 1, "kind": "x", "a": arr})["a"]
    assert isinstance(got, np.ndarray) and got.dtype == np.float64
    assert got.tobytes() == arr.tobytes()      # NaN payload, signed zero


def test_binary_roundtrip_empty_and_zero_d_arrays():
    msg = {"version": 1, "kind": "x",
           "empty": np.zeros((0,), np.int64),
           "scalar": np.array(2.5, np.float32),
           "mat": np.arange(6, dtype=np.float32).reshape(2, 3)}
    out = roundtrip(msg)
    assert out["empty"].shape == (0,) and out["empty"].dtype == np.int64
    assert out["scalar"].shape == () and out["scalar"] == np.float32(2.5)
    assert out["mat"].shape == (2, 3)
    assert np.array_equal(out["mat"], msg["mat"])


def test_binary_as_lists_matches_ndjson_spelling():
    vals = np.array([0.1, 1.0 / 3.0, 2.0 ** 52 + 1], np.float64)
    out = roundtrip({"version": 1, "kind": "x", "v": vals}, as_arrays=False)
    assert out["v"] == vals.tolist()


def test_binary_rejects_reserved_key_and_bad_dtype():
    with pytest.raises(ext.ProtocolError, match="reserved"):
        tr.encode_bin_frame({"version": 1, "__bin__": 0})
    with pytest.raises(ext.ProtocolError, match="binary-wire dtype"):
        tr.encode_bin_frame({"version": 1, "a": np.zeros(2, np.complex128)})


def test_binary_oversize_frame_rejected_before_write(monkeypatch):
    monkeypatch.setattr(tr, "MAX_FRAME_BYTES", 1024)
    buf = io.BytesIO()
    counters = tr.WireCounters()
    with pytest.raises(ext.ProtocolError, match="protocol cap"):
        tr.write_bin_frame(buf, {"version": 1, "a": np.zeros(200)}, counters)
    assert counters.frames_rejected == 1
    assert buf.getvalue() == b"", "oversize frame leaked bytes"


def test_truncated_binary_frame_is_protocol_error():
    buf = io.BytesIO()
    tr.write_bin_frame(buf, {"version": 1, "a": np.arange(8)})
    whole = buf.getvalue()
    for cut in (3, len(whole) - 5, len(whole) - 1):
        with pytest.raises(ext.ProtocolError, match="truncated"):
            tr.read_any_frame(io.BytesIO(whole[:cut]))
    with pytest.raises(ConnectionError):        # EOF before any byte
        tr.read_any_frame(io.BytesIO(b""))
    with pytest.raises(ext.ProtocolError, match="magic"):
        tr.read_any_frame(io.BytesIO(b"RXYZ" + whole[4:]))


@pytest.mark.parametrize("header, payload, match", [
    (b'{"a":{"__bin__":0,"dtype":"<c16","shape":[1]}}', b"\0" * 16,
     "binary-wire dtype"),
    (b'{"a":{"__bin__":0,"dtype":"<f8","shape":[-1]}}', b"", "negative"),
    (b'{"a":{"__bin__":0,"dtype":"<f8","shape":[1]},'
     b'"b":{"__bin__":0,"dtype":"<f8","shape":[1]}}', b"\0" * 16,
     "duplicate"),
    (b'{"a":{"__bin__":1,"dtype":"<f8","shape":[1]}}', b"\0" * 8,
     "indices"),
    (b'{"a":{"__bin__":0,"dtype":"<f8","shape":[2]}}', b"\0" * 8,
     "header implies"),
    (b'[1, 2]', b"", "JSON object"),
    (b'{nope', b"", "not JSON"),
])
def test_decode_bin_frame_rejects_bad_headers(header, payload, match):
    for mod in (tr, jtr):
        with pytest.raises(mod.ProtocolError, match=match):
            mod.decode_bin_frame(header, payload)


def test_read_any_frame_passes_ndjson_through():
    buf = io.BytesIO(b'{"version": 1, "kind": "x", "v": [1, 2]}\n')
    assert tr.read_any_frame(buf) == {"version": 1, "kind": "x", "v": [1, 2]}


def test_ndarray_schedule_decodes_like_list_schedule():
    start = np.array([0.0, 30.0, np.inf], np.float64)
    as_bin = tr.decode_schedule(
        {"version": ext.WIRE_VERSION, "kind": "schedule", "start": start}, 3)
    as_json = tr.decode_schedule(
        {"version": ext.WIRE_VERSION, "kind": "schedule",
         "start": [0.0, 30.0, None]}, 3)
    assert np.array_equal(as_bin, as_json)
    with pytest.raises(ext.ProtocolError):
        tr.decode_schedule(
            {"version": ext.WIRE_VERSION, "kind": "schedule",
             "start": np.array([np.nan, 0.0, 0.0])}, 3)


# ---------------------------------------------------------------------------
# NDJSON framing (tests/test_transport.py).
# ---------------------------------------------------------------------------
def test_read_frame_classifies_failures(monkeypatch):
    counters = tr.WireCounters()
    ok = io.BytesIO(b'{"version":1,"kind":"hello"}\n')
    assert tr.read_frame(ok, counters)["kind"] == "hello"
    assert counters.as_dict() == {"frames_out": 0, "bytes_out": 0,
                                  "frames_in": 1, "bytes_in": 29,
                                  "frames_rejected": 0}
    with pytest.raises(ConnectionError):          # EOF: peer died
        tr.read_frame(io.BytesIO(b""))
    for bad in (b"}{ nope\n", b'{"version":1', b"[1,2,3]\n"):
        with pytest.raises(ext.ProtocolError):    # garbage, truncated, list
            tr.read_frame(io.BytesIO(bad), counters)
    assert counters.frames_rejected == 3
    monkeypatch.setattr(tr, "MAX_FRAME_BYTES", 1024)
    huge = b'{"pad":"' + b"x" * 2048 + b'"}\n'
    with pytest.raises(ext.ProtocolError):        # over-long inbound
        tr.read_frame(io.BytesIO(huge))
    with pytest.raises(ext.ProtocolError):
        tr.read_any_frame(io.BytesIO(huge))
    with pytest.raises(ext.ProtocolError):        # over-long outbound
        tr.write_frame(io.BytesIO(), {"pad": "x" * 2048})


def test_decode_schedule_validation():
    msg = {"version": 1, "kind": "schedule", "start": [0.0, None, 30.5]}
    out = tr.decode_schedule(msg, 3)
    assert out[0] == 0.0 and np.isinf(out[1]) and out[2] == 30.5
    for bad in [
        {"version": 2, "kind": "schedule", "start": [0.0]},
        {"version": 1, "kind": "running_set", "start": [0.0]},
        {"version": 1, "kind": "schedule", "start": [0.0, 1.0]},
        {"version": 1, "kind": "schedule", "start": "soon"},
        {"version": 1, "kind": "schedule", "start": [True]},
        {"version": 1, "kind": "schedule", "start": ["0.0"]},
        {"version": 1, "kind": "schedule", "start": [float("nan")]},
        {"version": 1, "kind": "schedule", "start": [float("inf")]},
        {"version": 1, "kind": "schedule", "start": [10 ** 400]},
    ]:
        n = 1 if len(bad.get("start", [])) == 1 else 3
        with pytest.raises(ext.ProtocolError) as mine:
            tr.decode_schedule(bad, n)
        with pytest.raises(jext.ProtocolError) as theirs:
            jtr.decode_schedule(bad, n)
        assert str(mine.value) == str(theirs.value)


def test_parse_address_forms():
    assert tr.parse_address("unix:/tmp/x.sock") == \
        (socket.AF_UNIX, "/tmp/x.sock")
    assert tr.parse_address("/tmp/x.sock") == (socket.AF_UNIX, "/tmp/x.sock")
    assert tr.parse_address("127.0.0.1:7700") == \
        (socket.AF_INET, ("127.0.0.1", 7700))
    assert tr.parse_address("tcp:localhost:80") == \
        (socket.AF_INET, ("localhost", 80))
    with pytest.raises(ValueError):
        tr.parse_address("not-an-address")
    assert tr.format_address(socket.AF_UNIX, "/tmp/x.sock") == \
        "unix:/tmp/x.sock"
    assert tr.format_address(socket.AF_INET, ("127.0.0.1", 7700)) == \
        "127.0.0.1:7700"


# ---------------------------------------------------------------------------
# Binary vs NDJSON (tests/test_wire_properties.py), and the departure.
# ---------------------------------------------------------------------------
def same_message_both_dialects(msg):
    """An RBW1 frame decoded as lists equals the NDJSON spelling of the
    same message, both read through the dialect-agnostic reader."""
    as_json = {k: v.tolist() if isinstance(v, np.ndarray) else v
               for k, v in msg.items()}
    b = io.BytesIO()
    tr.write_bin_frame(b, msg)
    b.seek(0)
    j = io.BytesIO()
    tr.write_frame(j, as_json)
    j.seek(0)
    assert tr.read_any_frame(b, as_arrays=False) == tr.read_any_frame(j)


@st.composite
def wire_arrays(draw):
    """A numpy array any envelope could carry (the reference's strategy)."""
    dt = np.dtype(draw(st.sampled_from(BIN_DTYPES)))
    n = draw(st.integers(0, 32))
    if dt.kind == "f":
        vals = draw(st.lists(st.floats(width=32, allow_nan=False),
                             min_size=n, max_size=n))
    elif dt.kind == "b":
        vals = draw(st.lists(st.booleans(), min_size=n, max_size=n))
    elif dt.kind == "u":
        vals = draw(st.lists(st.integers(0, 2**31 - 1), min_size=n,
                             max_size=n))
    else:
        vals = draw(st.lists(st.integers(-2**31, 2**31 - 1), min_size=n,
                             max_size=n))
    return np.asarray(vals, dt)


@given(st.dictionaries(
    st.text(st.characters(min_codepoint=97, max_codepoint=122),
            min_size=1, max_size=8),
    wire_arrays() | st.floats(allow_nan=False) | st.integers(-10, 10)
    | st.text(max_size=8),
    max_size=5))
@settings(max_examples=150, deadline=None)
def test_binary_and_ndjson_decode_to_the_same_message(fields):
    same_message_both_dialects({"version": ext.WIRE_VERSION, "kind": "prop",
                                **fields})


# the reference's falsifying example, and the other leaf orders whose
# bytes after the leaf are not a multiple of its itemsize
FALSIFYING = {
    "f8 empty before one f4": {"b": np.zeros(0, np.float64),
                               "a": np.zeros(1, np.float32)},
    "f8 before three i4": {"a": np.arange(2, dtype=np.float64),
                           "b": np.arange(3, dtype=np.int32)},
    "f4 before five bools": {"a": np.ones(1, np.float32),
                             "b": np.ones(5, np.bool_)},
}


@pytest.mark.parametrize("fields", FALSIFYING.values(), ids=FALSIFYING)
def test_binary_and_ndjson_agree_on_the_reference_falsifying_example(fields):
    msg = {"version": ext.WIRE_VERSION, "kind": "prop", **fields}
    same_message_both_dialects(msg)
    out = roundtrip(msg)
    for k, v in fields.items():
        assert out[k].dtype == v.dtype and np.array_equal(out[k], v)
    # the departure: the reference's _bin_restore reads count=-1 from the
    # leaf's offset, which numpy refuses here (the red
    # tests/test_wire_properties.py case); the port reads nbytes exactly
    b = io.BytesIO()
    jtr.write_bin_frame(b, msg)
    b.seek(0)
    with pytest.raises(ValueError, match="multiple of element size"):
        jtr.read_any_frame(b)


# ---------------------------------------------------------------------------
# The copy held equal to the reference.
# ---------------------------------------------------------------------------
def seeded_messages(n=60, seed=0):
    """Envelopes with every wire dtype in random orders and lengths,
    nested dicts and lists, special floats and plain JSON values."""
    rng = np.random.default_rng(seed)
    msgs = []
    for i in range(n):
        fields = {}
        for j in range(int(rng.integers(1, 6))):
            dt = np.dtype(BIN_DTYPES[int(rng.integers(len(BIN_DTYPES)))])
            size = int(rng.integers(0, 9))
            if dt.kind == "f":
                a = rng.normal(0, 1e3, size).astype(dt)
                if size and i % 5 == 0:
                    a[0] = [np.inf, -np.inf, -0.0][i % 3]
            elif dt.kind == "b":
                a = rng.random(size) < 0.5
            else:
                a = rng.integers(0, 2**31 - 1, size).astype(dt)
            fields[f"k{j}"] = a
        fields["nested"] = {"x": [float(rng.normal()), "s", None, True],
                            "arr": np.arange(int(rng.integers(0, 4)),
                                             dtype=np.int64)}
        msgs.append({"version": ext.WIRE_VERSION, "kind": f"m{i}", **fields})
    return msgs


def as_json(obj):
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, dict):
        return {k: as_json(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [as_json(v) for v in obj]
    return obj


def assert_same_decoded(a, b):
    if isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype
        assert a.shape == b.shape and a.tobytes() == b.tobytes()
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            assert_same_decoded(a[k], b[k])
    elif isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert_same_decoded(x, y)
    else:
        assert a == b


def test_frames_are_byte_for_byte_the_reference_s():
    decoded_by_reference = 0
    for msg in seeded_messages():
        mine, theirs = io.BytesIO(), io.BytesIO()
        tr.write_frame(mine, as_json(msg), tr.WireCounters())
        jtr.write_frame(theirs, as_json(msg), jtr.WireCounters())
        assert mine.getvalue() == theirs.getvalue()
        mine, theirs = io.BytesIO(), io.BytesIO()
        tr.write_bin_frame(mine, msg)
        jtr.write_bin_frame(theirs, msg)
        frame = mine.getvalue()
        assert frame == theirs.getvalue()
        for as_arrays in (True, False):
            got = tr.read_any_frame(io.BytesIO(frame), as_arrays=as_arrays)
            try:
                want = jtr.read_any_frame(io.BytesIO(frame),
                                          as_arrays=as_arrays)
            except ValueError:   # the reference's _bin_restore fault
                assert_same_decoded(as_json(msg) if not as_arrays else msg,
                                    got)
                continue
            decoded_by_reference += 1
            assert_same_decoded(want, got)
    assert decoded_by_reference >= 20


def test_wire_counters_count_like_the_reference():
    msg = seeded_messages(3, seed=4)[1]
    mine, theirs = tr.WireCounters(), jtr.WireCounters()
    for mod, c in ((tr, mine), (jtr, theirs)):
        buf = io.BytesIO()
        mod.write_frame(buf, as_json(msg), c)
        mod.write_bin_frame(buf, msg, c)
        buf.seek(0)
        mod.read_any_frame(buf, c)
        mod.read_any_frame(buf, c, as_arrays=False)
    assert mine.as_dict() == theirs.as_dict()
    assert mine.frames_out == mine.frames_in == 2


def test_digests_equal_the_reference_s():
    for name, scale in (("marconi100", 64), ("frontier", 0)):
        jsystem = jget(name)
        if scale:
            jsystem = jsystem.scaled(scale)
        assert tr.system_digest(to_port(jsystem)) == \
            jtr.system_digest(jsystem)
    jsystem = jget("marconi100").scaled(64)
    spec = dict(n_jobs=80, duration_s=4 * 3600.0, load=1.0, trace_len=8,
                n_accounts=8, mean_wall_s=1800.0, seed=7)
    mine = tsyn.generate(to_port(jsystem), tsyn.WorkloadSpec(**spec))
    theirs = jsyn.generate(jsystem, jsyn.WorkloadSpec(**spec))
    assert tr.job_digest(mine) == jtr.job_digest(theirs)
    other = tsyn.generate(to_port(jsystem),
                          tsyn.WorkloadSpec(**dict(spec, seed=8)))
    assert tr.job_digest(other) != tr.job_digest(mine)


@pytest.mark.parametrize("payload", [
    None, [], [3, 1, 2], [0, 0], [64], [-1], [1.5], [True], [[1]], [[]],
    "x", {"a": 1}, [2**40],
], ids=repr)
def test_running_sets_decode_like_the_reference(payload):
    """``decode_running`` and ``decode_running_sets``: the same ids or
    the same ``ProtocolError`` message as the reference's."""
    for kind, make in ((ext.WIRE_KIND_RUNNING,
                        lambda p: {"job_ids": p}),
                       (ext.WIRE_KIND_RUNNING_SETS,
                        lambda p: {"sets": [p, [0]]})):
        msg = {"version": ext.WIRE_VERSION, "kind": kind, **make(payload)}
        results = []
        for mod in (ext, jext):
            try:
                if kind == ext.WIRE_KIND_RUNNING:
                    results.append(mod.decode_running(msg, 64).tolist())
                else:
                    results.append([a.tolist() for a in
                                    mod.decode_running_sets(msg, 64, 2)])
            except mod.ProtocolError as e:
                results.append(("error", str(e)))
        assert results[0] == results[1]
    assert ext.encode_running([3, 1]) == jext.encode_running([3, 1])
    assert ext.encode_running_sets([[1], []]) == \
        jext.encode_running_sets([[1], []])
    assert json.loads(json.dumps(ext.encode_running([2])))["job_ids"] == [2]
    assert ext.TRANSPORT_ERRORS == jext.TRANSPORT_ERRORS
