"""Cooling-plant calibration in the PyTorch port against the JAX package.

``repro_torch.traces.calibrate`` rolls the port's ``cooling.step`` over a
heat + weather trace with the candidate parameters as float32 tensors,
and fits them with scipy's ``least_squares`` called as the reference
calls it. Tolerances:

* ``simulate_plant`` over the committed 8,640-step fixture: every
  channel at every step within rtol 1e-5 of the reference's live output
  (float32 plant arithmetic in both; PUE's total IT power is summed
  exactly in the port and in float32 in the reference).
* ``check_envelope``: the temperature channels' fresh RMSEs within rtol
  1e-4 of the reference's; the PUE RMSE differs by no more than the RMS
  of the two rollouts' per-step PUE difference (the triangle
  inequality). At the fixture's idle steps (zero IT power) the PUE is
  the cooling power over 1 W, five to six digits, where one float32 ulp
  is a few thousandths to hundredths, so that RMSE moves with the last
  bit of a few steps. The committed ``fitted_params.json`` envelope does
  not hold in either package (the reference's red ``test_calibrate.py``
  gates): both fresh PUE RMSEs exceed it, the idle steps carry most of
  the reference's squared PUE residual, and without them its RMSE is
  within the gate.
* A fit on a 960-step window of the fixture's heat and weather, against
  telemetry the JAX ``simulate_plant`` makes with known parameters: the
  port's fitted parameters within rtol 1e-4 of the JAX fit's, and both
  within the reference's 2 % of the truth.
"""
import dataclasses

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import repro.traces.calibrate as jcal  # noqa: E402
from conftest import DATA_DIR  # noqa: E402
from repro.systems.config import SYSTEMS  # noqa: E402
from repro.traces import TraceError as JTraceError  # noqa: E402
from repro_torch.traces import TraceError  # noqa: E402
from repro_torch.traces import calibrate as tcal  # noqa: E402
from test_torch_common import to_port  # noqa: E402

CAL_DIR = DATA_DIR / "calibration"
CHANNELS = ("t_basin_c", "t_supply_c", "t_return_c", "pue")
STEP_RTOL = 1e-5        # simulate_plant, per channel and step
RMSE_RTOL = 1e-4        # check_envelope's temperature channels
FIT_RTOL = 1e-4         # the port's fit against the JAX fit
RECOVERY_RTOL = 0.02    # the reference's recovery tolerance
WINDOW = slice(3600, 4560)   # a window where every default field moves
TRUTH = {"ua_w_k": 840000.0, "tau_hx_s": 72.0, "basin_margin_c": 4.5}


@pytest.fixture(scope="module")
def tel():
    z = np.load(CAL_DIR / "telemetry.npz", allow_pickle=False)
    return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def cfgs():
    jc = SYSTEMS["frontier"].cooling
    return jc, to_port(jc)


@pytest.fixture(scope="module")
def fitted():
    return tcal.FittedParams.load(CAL_DIR / "fitted_params.json")


@pytest.fixture(scope="module")
def fixture_runs(tel, cfgs, fitted):
    """Both packages' rollouts of the whole fixture at the committed
    parameters."""
    jc, tc = cfgs
    args = (tel["p_it_w"], float(tel["dt"]), tel["t_wetbulb_c"])
    return (jcal.simulate_plant(jc, *args, overrides=fitted.params),
            tcal.simulate_plant(tc, *args, overrides=fitted.params,
                                device="cpu"))


def obs_of(tel):
    return {ch: tel[ch] for ch in CHANNELS}


def test_simulate_plant_matches_the_reference_over_the_fixture(tel,
                                                               fixture_runs):
    want, got = fixture_runs
    assert sorted(got) == sorted(want) == sorted(CHANNELS)
    for ch in CHANNELS:
        assert got[ch].dtype == np.float32 and got[ch].shape == (8640,)
        np.testing.assert_allclose(got[ch], want[ch], rtol=STEP_RTOL,
                                   err_msg=ch)


def test_check_envelope_fresh_rmses_match_the_reference(tel, cfgs, fitted,
                                                        fixture_runs):
    jc, tc = cfgs
    # an envelope wide enough for both, so each returns its fresh RMSEs
    wide = dataclasses.replace(fitted, envelope={
        ch: 100.0 * v for ch, v in fitted.envelope.items()})
    args = (tel["p_it_w"], float(tel["dt"]), tel["t_wetbulb_c"],
            obs_of(tel))
    want = jcal.check_envelope(jcal.FittedParams(**vars(wide)), jc, *args)
    got = tcal.check_envelope(wide, tc, *args, device="cpu")
    assert sorted(got) == sorted(want) == sorted(fitted.envelope)
    for ch in ("t_basin_c", "t_supply_c", "t_return_c"):
        np.testing.assert_allclose(got[f"{ch}_rmse"], want[f"{ch}_rmse"],
                                   rtol=RMSE_RTOL, err_msg=ch)
    d = int(fitted.meta["discard"])
    jp, tp = (r["pue"][d:].astype(np.float64) for r in fixture_runs)
    assert abs(got["pue_rmse"] - want["pue_rmse"]) <= \
        np.sqrt(np.mean((tp - jp) ** 2)) + 1e-12
    # the committed envelope's PUE gate does not hold in either package,
    # because of the idle steps
    for fresh in (want, got):
        assert fresh["pue_rmse"] > 1.05 * fitted.envelope["pue_rmse"]
    idle = tel["p_it_w"][d:] == 0
    r = jp - tel["pue"][d:].astype(np.float64)
    assert (r[idle] ** 2).sum() > 0.5 * (r ** 2).sum()
    assert np.sqrt(np.mean(r[~idle] ** 2)) <= \
        1.05 * fitted.envelope["pue_rmse"]
    with pytest.raises(TraceError, match="pue_rmse"):
        tcal.check_envelope(dataclasses.replace(
            wide, envelope={"pue_rmse": fitted.envelope["pue_rmse"]}),
            tc, *args, device="cpu")


def test_short_window_fit_matches_the_jax_fit(tel, cfgs):
    jc, tc = cfgs
    heat, wb = tel["p_it_w"][WINDOW], tel["t_wetbulb_c"][WINDOW]
    dt = float(tel["dt"])
    obs = jcal.simulate_plant(jc, heat, dt, wb, overrides=TRUTH)
    want = jcal.calibrate(jc, heat, dt, wb, obs)
    got = tcal.calibrate(tc, heat, dt, wb, obs, device="cpu")
    assert list(got.params) == list(want.params) == list(TRUTH)
    for n, truth in TRUTH.items():
        np.testing.assert_allclose(got.params[n], want.params[n],
                                   rtol=FIT_RTOL, err_msg=n)
        assert abs(got.params[n] - truth) <= RECOVERY_RTOL * truth, n
    # the fit moves: the truth is far from the config's initial guess
    for n in ("ua_w_k", "tau_hx_s", "basin_margin_c"):
        assert abs(got.params[n] - getattr(tc, n)) > 0.05 * getattr(tc, n)
    assert got.meta["channels"] == sorted(CHANNELS)
    assert got.meta["rollouts"] >= got.meta["nfev"] + 1
    for ch in ("t_basin_c", "t_supply_c", "t_return_c"):
        assert got.envelope[f"{ch}_rmse"] < 1e-4


def test_simulate_plant_overrides_change_the_rollout(tel, cfgs):
    _, tc = cfgs
    heat, wb = tel["p_it_w"][:300], tel["t_wetbulb_c"][:300]
    base = tcal.simulate_plant(tc, heat, 20.0, wb, device="cpu")
    for n, v in (("ua_w_k", 0.5 * tc.ua_w_k), ("tau_valve_s", 5.0),
                 ("tower_tau_s", 300.0), ("basin_margin_c", 9.0)):
        moved = tcal.simulate_plant(tc, heat, 20.0, wb, device="cpu",
                                    overrides={n: v})
        assert any(not np.array_equal(base[ch], moved[ch])
                   for ch in CHANNELS), n
        assert all(np.isfinite(moved[ch]).all() for ch in CHANNELS), n


def test_refusals_match_the_reference(tel, cfgs):
    jc, tc = cfgs
    dt, heat, wb = float(tel["dt"]), tel["p_it_w"], tel["t_wetbulb_c"]
    cases = [
        ("calibrate", (heat[:100], dt, wb, obs_of(tel)), {}),
        ("calibrate", (heat, dt, wb, {}), {}),
        ("calibrate", (heat, dt, wb, obs_of(tel)), {"fit": ("not_a_field",)}),
        ("calibrate", (heat, dt, wb, {"pue": tel["pue"][:10]}), {}),
        ("simulate_plant", (heat[:10], dt, wb[:9]), {}),
        ("simulate_plant", (-heat[:10] - 1.0, dt, wb[:10]), {}),
        ("simulate_plant", (np.ones((10, 3)), dt, wb[:10]), {}),
        ("simulate_plant", (heat[:10], dt, wb[:10]),
         {"overrides": {"cp_j_kg_k": 1.0}}),
    ]
    for fn, args, kw in cases:
        messages = []
        for mod, cfg, err, dev in ((jcal, jc, JTraceError, {}),
                                   (tcal, tc, TraceError,
                                    {"device": "cpu"})):
            with pytest.raises(err) as exc:
                getattr(mod, fn)(cfg, *args, **kw, **dev)
            messages.append(str(exc.value))
        assert messages[0] == messages[1], (fn, messages)
    with pytest.raises(TraceError, match="cannot read"):
        tcal.FittedParams.load(DATA_DIR / "weather_week.csv")


def test_cli_out_then_check(tel, tmp_path, capsys):
    """``simulate calibrate --out`` then ``--check`` of what it wrote
    exits 0; a check against other weather widens the envelope and exits
    1. The telemetry is a 240-step window of the fixture."""
    from repro_torch.launch import simulate as tcli
    win = slice(2160, 2400)
    npz = tmp_path / "tel.npz"
    np.savez(npz, dt=tel["dt"], p_it_w=tel["p_it_w"][win],
             t_wetbulb_c=tel["t_wetbulb_c"][win],
             **{ch: tel[ch][win] for ch in CHANNELS})
    out = tmp_path / "fit.json"
    base = ["calibrate", "--telemetry", str(npz), "--device", "cpu"]
    assert tcli.main(base + ["--fit", "ua_w_k,basin_margin_c",
                             "--out", str(out)]) == 0
    assert f"wrote {out}" in capsys.readouterr().out
    fit = tcal.FittedParams.load(out)
    assert sorted(fit.params) == ["basin_margin_c", "ua_w_k"]
    assert fit.meta["n_steps"] == 240 and fit.meta["system"] == "frontier"
    assert tcli.main(base + ["--check", str(out)]) == 0
    assert "calibration envelope holds" in capsys.readouterr().out
    assert tcli.main(base + ["--check", str(out), "--weather-trace",
                             str(DATA_DIR / "weather_week.csv")]) == 1
    assert "FAIL calibration envelope widened" in capsys.readouterr().out
