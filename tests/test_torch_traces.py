"""Trace ingestion in the PyTorch port against the JAX package.

``repro_torch.traces`` and ``repro_torch.datasets.swf`` are copies of the
reference's host modules. On the committed fixtures of ``tests/data``
(the PM100-style parquet and its SWF export, the RAPS-style
joblive/jobprofile dump, the weather week) each package's loader must
give the same ``JobSet`` leaf for leaf and the same digests; the NPZ
cache one package writes must load in the other bit for bit; the same
malformed input must raise ``TraceError`` in both; and the weather each
package resamples must be the same array.
"""
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from conftest import DATA_DIR  # noqa: E402
from repro import traces as jtr  # noqa: E402
from repro.core import transport as jtransport  # noqa: E402
from repro.datasets import loaders as jloaders  # noqa: E402
from repro.datasets import swf as jswf  # noqa: E402
from repro_torch import traces as ttr  # noqa: E402
from repro_torch.core import transport as ttransport  # noqa: E402
from repro_torch.datasets import loaders as tloaders  # noqa: E402
from repro_torch.datasets import swf as tswf  # noqa: E402
from test_torch_common import assert_exact, assert_jobsets_equal  # noqa: E402
from test_traces_properties import (CORRUPTIONS, random_frame,  # noqa: E402
                                    random_weather)

TELEMETRY = (DATA_DIR / "joblive", DATA_DIR / "jobprofile")


def both_digests_equal(jjs, tjs):
    assert jtransport.job_digest(jjs) == ttransport.job_digest(tjs)


@pytest.mark.parametrize("source", ["parquet", "swf", "telemetry", "csv"])
def test_ingest_gives_equal_jobsets_and_digests(source, tmp_path):
    """Each fixture read by each package: equal arrays, equal digest;
    the parquet and its SWF export share one digest in both packages."""
    if source == "parquet":
        want = jtr.read_job_table(DATA_DIR / "pm100_small.parquet")
        got = ttr.read_job_table(DATA_DIR / "pm100_small.parquet")
    elif source == "swf":
        want = jswf.read_swf(DATA_DIR / "pm100_small.swf")
        got = tswf.read_swf(DATA_DIR / "pm100_small.swf")
    elif source == "csv":
        random_frame(7, 40).to_csv(tmp_path / "t.csv", index=False)
        want = jtr.read_job_table(tmp_path / "t.csv")
        got = ttr.read_job_table(tmp_path / "t.csv")
    else:
        want = jtr.load_telemetry(*TELEMETRY, prof_dt=20.0)
        got = ttr.load_telemetry(*TELEMETRY, prof_dt=20.0)
        assert got.power_profile is not None
    assert_jobsets_equal(want, got, source)
    both_digests_equal(want, got)
    if source in ("parquet", "swf"):
        assert ttransport.job_digest(got) == ttransport.job_digest(
            tswf.read_swf(DATA_DIR / "pm100_small.swf"))


def test_writers_write_what_the_reference_writes(tmp_path):
    """write_swf writes the reference's bytes; write_job_table's parquet
    and CSV read back to the reference's JobSet in both packages."""
    js = ttr.read_job_table(DATA_DIR / "pm100_small.parquet")
    jjs = jtr.read_job_table(DATA_DIR / "pm100_small.parquet")
    tswf.write_swf(js, tmp_path / "t.swf")
    jswf.write_swf(jjs, tmp_path / "j.swf")
    assert (tmp_path / "t.swf").read_bytes() == \
        (tmp_path / "j.swf").read_bytes()
    for ext in ("parquet", "csv"):
        ttr.write_job_table(js, tmp_path / f"t.{ext}")
        assert_jobsets_equal(jtr.read_job_table(tmp_path / f"t.{ext}"),
                             ttr.read_job_table(tmp_path / f"t.{ext}"), ext)
        both_digests_equal(jjs, ttr.read_job_table(tmp_path / f"t.{ext}"))


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_npz_cache_loads_in_the_other_package(writer, tmp_path,
                                              trace_jobset):
    """A cache written by one package is the other's cache hit: same
    file name (content digest), same bytes back, leaf for leaf."""
    first, second = (ttr, jtr) if writer == "port" else (jtr, ttr)
    cold = first.load_telemetry(*TELEMETRY, prof_dt=20.0,
                                cache_dir=tmp_path)
    digest = second.source_digest(*TELEMETRY)
    npz = tmp_path / f"trace-{digest[:16]}.npz"
    assert sorted(tmp_path.iterdir()) == [npz]
    hit = second.load_telemetry(*TELEMETRY, prof_dt=20.0,
                                cache_dir=tmp_path)
    assert sorted(tmp_path.iterdir()) == [npz], "the hit re-parsed"
    assert_jobsets_equal(cold, hit, f"{writer} cache")
    assert_jobsets_equal(trace_jobset, hit, "the session fixture")
    assert_jobsets_equal(cold, second.jobset_from_npz(npz), "direct npz")


def test_npz_writers_round_trip_every_channel(tmp_path):
    """jobset_to_npz of either package keeps every channel (first_node,
    score, the measured profile, the ML basis) through the other's
    jobset_from_npz, and both packages' tables carry the ML basis alike
    (its padded rows zero)."""
    js = ttr.load_telemetry(*TELEMETRY, prof_dt=20.0)
    js.assign_prepop_placement(0.0, 64)
    js.score = np.linspace(0.0, 1.0, len(js))
    js.ml_basis = np.ones((len(js), 3), np.float32)
    ttr.jobset_to_npz(js, tmp_path / "t.npz", digest="abc")
    back = jtr.jobset_from_npz(tmp_path / "t.npz")
    assert_jobsets_equal(back, js, "port -> reference")
    jtr.jobset_to_npz(back, tmp_path / "j.npz", digest="abc")
    assert_jobsets_equal(back, ttr.jobset_from_npz(tmp_path / "j.npz"),
                         "reference -> port")
    pad = len(js) + 8
    want, got = back.to_table(pad).ml_basis, js.to_table(pad).ml_basis
    assert_exact(np.asarray(want), got, "ml_basis")
    assert not got[len(js):].any()
    np.savez(tmp_path / "old.npz", version=np.array(0))
    for pkg in (jtr, ttr):
        with pytest.raises(pkg.TraceError, match="version"):
            pkg.jobset_from_npz(tmp_path / "old.npz")


def test_source_digests_are_equal():
    for roots in (TELEMETRY, (DATA_DIR / "weather_week.csv",),
                  (DATA_DIR / "pm100_small.parquet",
                   DATA_DIR / "pm100_small.swf")):
        assert ttr.source_digest(*roots) == jtr.source_digest(*roots)
    for pkg in (jtr, ttr):
        with pytest.raises(pkg.TraceError, match="does not exist"):
            pkg.source_digest(DATA_DIR / "nope")


def test_load_trace_dispatch_matches(tmp_path):
    for paths in ([*TELEMETRY], [DATA_DIR / "pm100_small.parquet"],
                  [DATA_DIR / "joblive"]):
        assert_jobsets_equal(jloaders.load_trace(paths, cache_dir=tmp_path),
                             tloaders.load_trace(paths, cache_dir=tmp_path),
                             str(paths))
    digest = ttr.source_digest(*TELEMETRY)
    npz = [tmp_path / f"trace-{digest[:16]}.npz"]
    assert_jobsets_equal(jloaders.load_trace(npz), tloaders.load_trace(npz),
                         "cached npz")
    for bad in ([DATA_DIR / "does_not_exist.xyz"], [], [1, 2, 3]):
        for ld, pkg in ((jloaders, jtr), (tloaders, ttr)):
            with pytest.raises(pkg.TraceError):
                ld.load_trace(bad)


@pytest.mark.parametrize("name", sorted(CORRUPTIONS))
def test_malformed_rows_raise_in_both(name):
    col, row, val = CORRUPTIONS[name]
    df = random_frame(3, 16)
    if name.endswith("duration"):
        df.loc[row, "end_time"] = df.loc[row, "start_time"] + val
    df.loc[row, col] = val
    messages = []
    for pkg in (jtr, ttr):
        with pytest.raises(pkg.TraceError) as exc:
            pkg.jobset_from_frame(df)
        messages.append(str(exc.value))
    assert messages[0] == messages[1]


def test_malformed_telemetry_raises_in_both(tmp_path):
    """A profile sample of an unknown job and a bad joblive file raise
    the same TraceError in both packages."""
    import shutil
    live = tmp_path / "live"
    shutil.copytree(DATA_DIR / "joblive", live)
    prof = tmp_path / "prof" / "p.csv"
    prof.parent.mkdir()
    prof.write_text("timestamp,job_id,node_power_w\n0,424242,300.0\n")
    (tmp_path / "empty").mkdir()
    for args in ((live, prof.parent), (tmp_path / "empty", None)):
        messages = []
        for pkg in (jtr, ttr):
            with pytest.raises(pkg.TraceError) as exc:
                pkg.load_telemetry(*args)
            messages.append(str(exc.value))
        assert messages[0] == messages[1]


@pytest.mark.parametrize("form", ["csv", "npz", "wetbulb"])
def test_weather_resampled_equally(form, tmp_path):
    """The weather week (CSV with datetimes, an NPZ of numeric seconds,
    a ready wet-bulb column) resampled by each package: the same arrays,
    and a grid past the record clamps at its edges in both."""
    if form == "csv":
        path = DATA_DIR / "weather_week.csv"
    else:
        import pandas as pd
        df = pd.read_csv(DATA_DIR / "weather_week.csv")
        ts = pd.to_datetime(df["timestamp"], utc=True).astype("int64") / 1e9
        cols = {"timestamp": ts.to_numpy()}
        if form == "npz":
            cols.update(t_drybulb_c=df["t_drybulb_c"].to_numpy(),
                        rh_pct=df["rh_pct"].to_numpy())
        else:
            cols.update(t_wetbulb_c=df["t_drybulb_c"].to_numpy() - 4.0)
        path = tmp_path / "wx.npz"
        np.savez(path, **cols)
    for n_steps, dt, t0 in ((360, 20.0, 0.0), (50, 3600.0, 7200.0),
                            (400, 3600.0, 0.0)):
        want = jtr.load_weather(path, n_steps, dt, t0=t0)
        got = ttr.load_weather(path, n_steps, dt, t0=t0)
        for f in ("t_wetbulb_c", "t_drybulb_c"):
            w, g = np.asarray(getattr(want, f)), getattr(got, f).numpy()
            assert w.dtype == g.dtype and np.array_equal(w, g), (form, f)


@pytest.mark.parametrize("fault", ["non-monotone", "humidity", "nan",
                                   "columns", "one row", "suffix"])
def test_bad_weather_raises_in_both(fault, tmp_path):
    df = random_weather(2, 16)
    path = tmp_path / "wx.csv"
    if fault == "non-monotone":
        df.loc[7, "timestamp"] = df.loc[3, "timestamp"]
        df = df.sort_values("timestamp")
    elif fault == "humidity":
        df.loc[5, "rh_pct"] = 130.0
    elif fault == "nan":
        df.loc[5, "rh_pct"] = np.nan
    elif fault == "columns":
        df = df.drop(columns=["rh_pct"])
    elif fault == "one row":
        df = df.iloc[:1]
    else:
        path = tmp_path / "wx.txt"
    df.to_csv(path, index=False)
    messages = []
    for pkg in (jtr, ttr):
        with pytest.raises(pkg.TraceError) as exc:
            pkg.load_weather(path, 10, 20.0)
        messages.append(str(exc.value))
    assert messages[0] == messages[1]


def test_wet_bulb_stull_is_the_reference():
    t = np.linspace(-40.0, 50.0, 91)
    for rh in (0.0, 1e-3, 37.5, 100.0):
        np.testing.assert_array_equal(
            ttr.wet_bulb_stull(t, np.full_like(t, rh)),
            jtr.wet_bulb_stull(t, np.full_like(t, rh)))
