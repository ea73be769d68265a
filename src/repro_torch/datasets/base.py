"""Host-side job-set schema shared by all dataloaders (paper §3.2.2).

The port's copy of ``repro.datasets.base``: a ``JobSet`` is a numpy
struct-of-arrays (SWF-style fields plus power/trace channels) and
``to_table`` pads and packs it into the fixed-shape tensor ``JobTable``
the engine consumes. Times stay float32 seconds (the JAX package's
``compact_time`` int32 encoding and its measured-power replay channel
belong to later slices of the port).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core import types as T


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
    name: str = "jobset"

    def __len__(self) -> int:
        return int(self.submit.shape[0])

    @property
    def rec_end(self) -> np.ndarray:
        return self.rec_start + self.wall

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

    def to_table(self, pad_to: int | None = None) -> T.JobTable:
        """Pad and pack into the fixed-shape ``JobTable`` (on the CPU; the
        engine moves it to its device): times -> f32 s, power -> f32 W,
        counts -> i32. Padded rows are marked invalid."""
        J = len(self)
        Jp = pad_to or J
        if Jp < J:
            raise ValueError(f"pad_to={Jp} < {J} jobs")
        P = self.power_prof.shape[1]

        def pad1(x, fill, dtype):
            out = np.full((Jp,), fill, dtype)
            out[:J] = x
            return torch.from_numpy(out)

        def pad2(x, fill, dtype):
            out = np.full((Jp, P), fill, dtype)
            out[:J] = x
            return torch.from_numpy(out)

        first = self.first_node if self.first_node is not None else \
            np.full(J, -1, np.int64)
        score = self.score if self.score is not None else np.zeros(J)
        valid = np.zeros((Jp,), bool)
        valid[:J] = True
        return T.JobTable(
            submit=pad1(self.submit, np.inf, np.float32),
            limit=pad1(self.limit, 1.0, np.float32),
            wall=pad1(self.wall, 1.0, np.float32),
            nodes=pad1(self.nodes, 1, np.int32),
            priority=pad1(self.priority, 0.0, np.float32),
            account=pad1(self.account, 0, np.int32),
            rec_start=pad1(self.rec_start, np.inf, np.float32),
            first_node=pad1(first, -1, np.int32),
            score=pad1(score, 0.0, np.float32),
            power_prof=pad2(self.power_prof, 0.0, np.float32),
            util_prof=pad2(self.util_prof, 0.0, np.float32),
            valid=torch.from_numpy(valid),
        )
