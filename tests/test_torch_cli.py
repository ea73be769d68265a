"""Parity of the port's CLI (``repro_torch.launch.simulate``) with the JAX
CLI (``repro.launch.simulate``) on the same argv, on the CPU.

The flags: ``-ff/--fastforward``, ``--days``, ``--cells-offline``,
``--smoke``, ``--accounts``, ``--accounts-json`` and ``-o/--output``, on
the built-in paths, a sweep, the failure and DR layer and an external
coupling; the ``-o`` files; the two-phase incentive workflow (collect a
ledger, redeem it); and the ML policy (``--policy ml``, an ``ml`` sweep
entry, ``--ml-alpha`` as floats and as a checkpoint). Each run
is small (64 nodes, at most 48 jobs, at most 1 h). Summaries: the job
count exactly, every float at rtol 1e-4 (``power_fan``-derived fan
energy also within an absolute 1e-9 MWh: on these small machines the
fans run near zero, as ``tests/test_torch_external.py`` sets out).
"""
import csv
import json

import jax
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from repro.launch import simulate as jcli  # noqa: E402
from repro_torch.launch import simulate as tcli  # noqa: E402

RTOL = 1e-4
BASE = ["--system", "marconi100", "--scale", "64", "--jobs", "40", "-t",
        "1h", "--quiet", "--json"]
CASES = {
    "smoke": ["--smoke"],
    "fastforward": ["-ff", "2h"],
    "days": ["--days", "0.2"],
    "halls-cells-offline": ["--halls", "4", "--cells-offline", "2,0,0,0"],
    "cells-offline-sweep": ["--cells-offline", "1", "--sweep", "fcfs:easy",
                            "sjf:first-fit"],
    "fastforward-dr-failures": ["-ff", "1h", "--policy", "fcfs",
                                "--dr-announce", "10m", "--dr-notice", "5m",
                                "--dr-duration", "20m", "--dr-cap-mw", "0.03",
                                "--failure-rate", "2", "--failure-seed",
                                "3"],
    "fastsim-fastforward-cells-offline": ["--scheduler", "fastsim", "-ff",
                                          "1h", "--cells-offline", "1"],
}
# summary keys that integrate the fan power, which runs near zero here
FAN_ATOL = {"fan_energy_mwh": 1e-9, "cooling_energy_mwh": 1e-9}


def both(argv, capsys):
    """The JAX CLI's and the port's --json documents for ``argv``."""
    jcli.main(argv)
    want = json.loads(capsys.readouterr().out)
    tcli.main(argv + ["--device", "cpu"])
    got = json.loads(capsys.readouterr().out)
    return want, got


def assert_summaries_match(want, got, what=""):
    runs = lambda d: {k: v for k, v in d.items() if k != "output_dir"}
    want, got = runs(want), runs(got)
    assert want.keys() == got.keys(), what
    for label, ws in want.items():
        gs = got[label]
        assert ws.keys() == gs.keys(), f"{what} {label}"
        assert gs["jobs_completed"] == ws["jobs_completed"], f"{what} {label}"
        for k in ws:
            np.testing.assert_allclose(gs[k], ws[k], rtol=RTOL,
                                       atol=FAN_ATOL.get(k, 0.0),
                                       err_msg=f"{what} {label} {k}")


@pytest.mark.parametrize("case", sorted(CASES))
def test_cli_summaries_match_jax(case, capsys):
    want, got = both(BASE + CASES[case], capsys)
    assert_summaries_match(want, got, case)
    runs = [s for k, s in want.items() if k != "output_dir"]
    assert all(s["avg_util"] > 0 for s in runs), case


def test_fastforward_shifts_the_window_and_the_dataset(capsys, tmp_path):
    """``-ff`` moves the run's clock: the first row is the first step's
    start, t0, as in the JAX CLI's history."""
    tcli.main(BASE + ["-ff", "2h", "--device", "cpu", "-o",
                      str(tmp_path)])
    (out,) = tmp_path.iterdir()
    t = np.load(out / "history.npz")["t"]
    dt = tcli.build_system("marconi100", 64).dt
    assert t[0] == 2 * 3600.0 and t[-1] == 3 * 3600.0 - dt
    assert len(t) == round(3600.0 / dt)
    doc = json.loads(capsys.readouterr().out)
    assert doc["output_dir"] == str(out)


def _read_stats(path):
    rows = {}
    for line in path.read_text().splitlines():
        k, v = line.split(" : ")
        rows[k.strip()] = float(v.replace(",", ""))
    return rows


def _output(tmp, pkg):
    (out,) = (tmp / pkg).iterdir()
    return out


def test_output_files_match_jax(capsys, tmp_path):
    argv = BASE + ["--halls", "4", "-ff", "1h", "--policy", "fcfs",
                   "--backfill", "easy", "--accounts"]
    jcli.main(argv + ["-o", str(tmp_path / "jax")])
    capsys.readouterr()
    tcli.main(argv + ["-o", str(tmp_path / "torch"), "--device", "cpu"])
    capsys.readouterr()
    want, got = _output(tmp_path, "jax"), _output(tmp_path, "torch")
    assert sorted(p.name for p in got.iterdir()) == sorted(
        p.name for p in want.iterdir()) == ["accounts.json", "history.npz",
                                            "job_history.csv", "stats.out"]
    wh, gh = np.load(want / "history.npz"), np.load(got / "history.npz")
    assert set(wh.files) == set(gh.files)
    for k in wh.files:
        assert wh[k].dtype == gh[k].dtype and wh[k].shape == gh[k].shape, k
        np.testing.assert_allclose(gh[k], wh[k], rtol=RTOL,
                                   atol=1e-4 if k == "power_fan" else 0.0,
                                   err_msg=k)
    text = (got / "job_history.csv").read_text()
    assert text == (want / "job_history.csv").read_text()
    assert "inf" in text        # jobs that never start print as the JAX CLI's
    ws, gs = _read_stats(want / "stats.out"), _read_stats(got / "stats.out")
    assert list(ws) == list(gs)
    for k in ws:
        # stats.out rounds to 0.001: one rounding step apart at most
        np.testing.assert_allclose(gs[k], ws[k], rtol=RTOL, atol=1e-3,
                                   err_msg=k)
    wa = json.loads((want / "accounts.json").read_text())
    ga = json.loads((got / "accounts.json").read_text())
    assert list(wa) == list(ga)
    assert ga["jobs_done"] == wa["jobs_done"]
    for k in wa:
        np.testing.assert_allclose(ga[k], wa[k], rtol=RTOL, err_msg=k)
    # the ledger counts the completed rows of job_history.csv
    with open(got / "job_history.csv") as f:
        done = sum(int(r["state"]) == 3 for r in csv.DictReader(f))
    assert sum(ga["jobs_done"]) == done > 0


def test_collect_then_redeem_matches_jax(capsys, tmp_path):
    """fig8's workflow from the CLI: a replay collects the ledgers
    (``--accounts -o``), an acct_* sweep redeems them
    (``--accounts-json``), in each package on its own ledger. The
    backlog is packed into 2.4 h so that the queue is long enough for
    the ledgers to reorder it."""
    argv = ["--system", "marconi100", "--scale", "64", "--jobs", "48",
            "--seed", "8", "--days", "0.1", "--quiet", "--json"]
    redeem = ["--sweep", "acct_avg_power:first-fit",
              "acct_low_avg_power:first-fit", "acct_edp:first-fit",
              "acct_fugaku_pts:first-fit"]
    docs = {}
    for pkg, main, dev in (("jax", jcli.main, []),
                           ("torch", tcli.main, ["--device", "cpu"])):
        main(argv + ["-t", "1h", "--accounts", "-o",
                     str(tmp_path / pkg)] + dev)
        capsys.readouterr()
        ledger = _output(tmp_path, pkg) / "accounts.json"
        main(argv + ["-t", "1h", "-ff", "1h", "--accounts-json",
                     str(ledger)] + redeem + dev)
        docs[pkg] = json.loads(capsys.readouterr().out)
        # a cold redeem (empty ledgers) for the warm one to differ from
        main(argv + ["-t", "1h", "-ff", "1h"] + redeem + dev)
        docs[pkg + "-cold"] = json.loads(capsys.readouterr().out)
    assert_summaries_match(docs["jax"], docs["torch"], "warm redeem")
    assert_summaries_match(docs["jax-cold"], docs["torch-cold"],
                           "cold redeem")
    for label, warm in docs["torch"].items():
        assert warm != docs["torch-cold"][label], label


ML_CASES = {
    "policy": ["--policy", "ml", "--backfill", "first-fit"],
    # an ml entry under another --policy ranks on zero scores in both
    "sweep": ["--sweep", "fcfs", "ml:none"],
    "ml-alpha": ["--policy", "ml", "--ml-alpha", "1,1,1,0.5"],
    "checkpoint": ["--policy", "ml", "--backfill", "easy", "--ml-alpha"],
    # an alpha whose products round: the baked (eager) sum and the key's
    # fused one differ on some of these jobs
    "rounding": ["--policy", "ml", "--backfill", "first-fit", "--ml-alpha",
                 "1.2,0.8,1.1,0.3"],
}


@pytest.mark.parametrize("case", sorted(ML_CASES))
def test_ml_is_refused_as_not_ported(case, capsys, tmp_path, monkeypatch):
    """``--policy ml`` (refused until the ML layer was ported, hence the
    name) fits the pipeline on the loaded jobs in each package and bakes
    the scores under ``--ml-alpha`` (comma floats, or a training
    checkpoint's ``best_alpha``): the same baked scores bit for bit, the
    same summaries and the same ``job_history.csv``."""
    extra = list(ML_CASES[case])
    if case == "checkpoint":
        ck = tmp_path / "ml_alpha.json"
        ck.write_text(json.dumps({"best_alpha": [1.3, 0.4, 0.9, 1.1]}))
        extra.append(str(ck))
    # one run a package writes one -o directory (a sweep writes several)
    out = (lambda pkg: []) if case == "sweep" else \
        (lambda pkg: ["-o", str(tmp_path / pkg)])
    baked = {}
    docs = {}
    for pkg, cli, dev in (("jax", jcli, []),
                          ("torch", tcli, ["--device", "cpu"])):
        def spy(js, model, attach=cli.attach_scores, pkg=pkg):
            baked[pkg] = (np.asarray(model.score_basis(js)),
                          np.asarray(model.alpha))
            js = attach(js, model)
            baked[pkg] += (np.asarray(js.score),)
            return js
        monkeypatch.setattr(cli, "attach_scores", spy)
        cli.main(BASE + extra + out(pkg) + dev)
        docs[pkg] = json.loads(capsys.readouterr().out)
    assert_summaries_match(docs["jax"], docs["torch"], case)
    if case == "sweep":
        assert not baked
        return
    for want, got, what in zip(baked["jax"], baked["torch"],
                               ("basis", "alpha", "score")):
        assert np.array_equal(want, got), f"{case} {what}"
    want, got = _output(tmp_path, "jax"), _output(tmp_path, "torch")
    assert (got / "job_history.csv").read_text() == \
        (want / "job_history.csv").read_text(), case
    if case == "rounding":
        basis, alpha, score = baked["jax"]
        key = jax.jit(lambda b, a: jax.numpy.sum(b * a, axis=-1))(basis,
                                                                  alpha)
        assert not np.array_equal(np.asarray(key), score)
        (run,) = (v for k, v in docs["torch"].items() if k != "output_dir")
        assert run["avg_wait_s"] > 0 and \
            run["jobs_completed"] < int(BASE[BASE.index("--jobs") + 1])


def test_smoke_and_days_set_the_dataset(monkeypatch):
    """``--smoke`` is 64 nodes, at most 48 jobs and 30 minutes; ``--days``
    sets the loader's horizon, else 1.25x the run's end (at least half a
    day), counted from time 0 through the fast-forward."""
    seen = {}

    def load(name, n_jobs, days, seed):
        seen.update(n_jobs=n_jobs, days=days)
        raise SystemExit("stop")
    monkeypatch.setattr(tcli.loaders, "load", load)
    for extra, want in ((["--smoke"], dict(n_jobs=48, days=0.5)),
                        (["--days", "3"], dict(n_jobs=1000, days=3.0)),
                        (["-ff", "1d", "-t", "12h"],
                         dict(n_jobs=1000, days=1.875))):
        with pytest.raises(SystemExit, match="stop"):
            tcli.main(extra + ["--device", "cpu"])
        assert seen == want, extra
