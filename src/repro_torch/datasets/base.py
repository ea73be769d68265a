"""Host-side job-set schema shared by all dataloaders (paper §3.2.2).

The port's copy of ``repro.datasets.base``: a ``JobSet`` is a numpy
struct-of-arrays (SWF-style fields plus power/trace channels) and
``to_table`` pads and packs it into the fixed-shape tensor ``JobTable``
the engine consumes, with the JAX package's ``compact_time`` int32 time
columns, its measured-power replay channel and the ML scoring basis
(``repro_torch.ml.pipeline.attach_basis``). The pre-submission and
behavior feature matrices feed the ML pipeline (paper §4.4).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core import types as T

# far past any simulation window, exactly representable in both int32 and
# float32: the +inf of a compact (int32) time column
TIME_SENTINEL = np.int64(1) << 30


@dataclass
class JobSet:
    """Host-side struct-of-arrays job set (paper §3.2.2, SWF-style).

    Times are absolute seconds from the dataset origin; ``power_prof`` is
    per-node watts sampled at ``SystemConfig.prof_dt`` (P == 1 for
    scalar-summary datasets); ``util_prof`` is dimensionless in [0, 1].
    """
    submit: np.ndarray       # f64[J] seconds
    limit: np.ndarray        # f64[J] requested walltime
    wall: np.ndarray         # f64[J] true runtime
    nodes: np.ndarray        # i64[J]
    priority: np.ndarray     # f64[J]
    account: np.ndarray      # i64[J]
    rec_start: np.ndarray    # f64[J] recorded start times
    power_prof: np.ndarray   # f32[J, P] per-node power (W)
    util_prof: np.ndarray    # f32[J, P] in [0,1]
    first_node: np.ndarray | None = None  # i32[J], -1 unknown
    score: np.ndarray | None = None       # f32[J] baked ML/external score
    ml_basis: np.ndarray | None = None    # f32[J, K] scoring basis
    #   (repro_torch.ml.scoring.basis of the predicted features; lets the
    #    table score jobs under any Scenario.alpha, see attach_basis)
    power_profile: np.ndarray | None = None  # f32[J, Q] measured per-node W
    #   (repro_torch.traces telemetry replay: negative samples mean "no
    #    measurement" — those jobs fall back to ``power_prof``; the field
    #    only reaches the table via to_table(replay_power=True))
    name: str = "jobset"

    def __len__(self) -> int:
        return int(self.submit.shape[0])

    @property
    def rec_end(self) -> np.ndarray:
        return self.rec_start + self.wall

    def select(self, mask: np.ndarray) -> "JobSet":
        """The jobs where ``mask`` holds, every channel carried (the ML
        basis and the measured profile included)."""
        def pick(x):
            return None if x is None else x[mask]
        return JobSet(self.submit[mask], self.limit[mask], self.wall[mask],
                      self.nodes[mask], self.priority[mask],
                      self.account[mask], self.rec_start[mask],
                      self.power_prof[mask], self.util_prof[mask],
                      pick(self.first_node), pick(self.score),
                      pick(self.ml_basis), pick(self.power_profile),
                      self.name)

    def assign_prepop_placement(self, t0: float, n_nodes: int) -> None:
        """Give contiguous spans to jobs running at t0 (prepopulation)."""
        first = np.full(len(self), -1, np.int64)
        running0 = (self.rec_start <= t0) & (self.rec_end > t0)
        cursor = 0
        for j in np.nonzero(running0)[0]:
            need = int(self.nodes[j])
            if cursor + need <= n_nodes:
                first[j] = cursor
                cursor += need
        self.first_node = first

    def to_table(self, pad_to: int | None = None,
                 compact_time: bool = False,
                 replay_power: bool = False) -> T.JobTable:
        """Pad and pack into the fixed-shape ``JobTable`` (on the CPU; the
        engine moves it to its device): times -> f32 s, power -> f32 W,
        counts -> i32. Padded rows are marked invalid; ``ml_basis`` (if
        attached) pads with zeros, so padded jobs score 0 under every
        alpha.

        ``compact_time=True`` narrows the time columns (submit / limit /
        wall / rec_start) from float32 to int32 when every value is a
        whole second below 2^24 (the SWF contract and the f32-exact
        integer range), with non-finite entries (and the inf pad fill)
        mapped to a 2^30-second sentinel that every window test
        classifies exactly like +inf. A column that is fractional or too
        large stays float32. The engine meets int32 with float32 only in
        that exact range, so a compact run equals the float32 run bit for
        bit.

        ``replay_power=True`` carries the measured ``power_profile``
        channel (repro_torch.traces telemetry) into the table, padded
        with the -1 "no measurement" sentinel so padded rows, like
        profile-less jobs, fall back to the ``power_prof`` model. Off by
        default: the table's ``power_profile`` is then None and the power
        model runs as before. Requires the JobSet to carry measurements."""
        J = len(self)
        Jp = pad_to or J
        if Jp < J:
            raise ValueError(f"pad_to={Jp} < {J} jobs")
        P = self.power_prof.shape[1]

        def pad1(x, fill, dtype):
            out = np.full((Jp,), fill, dtype)
            out[:J] = x
            return torch.from_numpy(out)

        def pad_time(x, fill):
            if compact_time:
                a = np.asarray(x, np.float64)
                finite = np.isfinite(a)
                vals = a[finite]
                if vals.size == 0 or (np.all(vals == np.round(vals)) and
                                      np.all(np.abs(vals) < (1 << 24))):
                    out = np.full((Jp,), TIME_SENTINEL, np.int32)
                    out[:J] = np.where(finite, a, float(TIME_SENTINEL))
                    if np.isfinite(fill):
                        out[J:] = np.int32(fill)
                    return torch.from_numpy(out)
            return pad1(x, fill, np.float32)

        def pad2(x, fill, width=P):
            out = np.full((Jp, width), fill, np.float32)
            out[:J] = x
            return torch.from_numpy(out)

        first = self.first_node if self.first_node is not None else \
            np.full(J, -1, np.int64)
        score = self.score if self.score is not None else np.zeros(J)
        basis = None if self.ml_basis is None else \
            pad2(self.ml_basis, 0.0, width=self.ml_basis.shape[1])
        measured = None
        if replay_power:
            if self.power_profile is None:
                raise ValueError(
                    "replay_power=True but this JobSet carries no measured "
                    "power_profile (load one via repro_torch.traces)")
            measured = pad2(self.power_profile, -1.0,
                            width=self.power_profile.shape[1])
        valid = np.zeros((Jp,), bool)
        valid[:J] = True
        return T.JobTable(
            submit=pad_time(self.submit, np.inf),
            limit=pad_time(self.limit, 1.0),
            wall=pad_time(self.wall, 1.0),
            nodes=pad1(self.nodes, 1, np.int32),
            priority=pad1(self.priority, 0.0, np.float32),
            account=pad1(self.account, 0, np.int32),
            rec_start=pad_time(self.rec_start, np.inf),
            first_node=pad1(first, -1, np.int32),
            score=pad1(score, 0.0, np.float32),
            power_prof=pad2(self.power_prof, 0.0),
            util_prof=pad2(self.util_prof, 0.0),
            valid=torch.from_numpy(valid),
            ml_basis=basis,
            power_profile=measured,
        )

    # -- pre-submission feature matrix for the ML pipeline (paper §4.4) -----
    def presubmit_features(self) -> np.ndarray:
        """f64[J, 5] features known at submit time: nodes, limit (s),
        priority, log1p(nodes), log1p(limit). Account aggregates are
        intentionally excluded (they're ledger state)."""
        return np.stack([
            self.nodes.astype(np.float64),
            self.limit.astype(np.float64),
            self.priority.astype(np.float64),
            np.log1p(self.nodes.astype(np.float64)),
            np.log1p(self.limit.astype(np.float64)),
        ], axis=1)

    def behavior_features(self) -> np.ndarray:
        """f64[J, 7] post-hoc features (clustering targets): power trace
        mean/max/min/std (W), utilization mean/std, runtime (s): summary
        statistics of the noisy time series, as the paper does for PM100
        (§4.4.3)."""
        p = self.power_prof
        u = self.util_prof
        return np.stack([
            p.mean(1), p.max(1), p.min(1), p.std(1),
            u.mean(1), u.std(1),
            self.wall.astype(np.float64),
        ], axis=1)
