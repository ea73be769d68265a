"""Reading a trained scoring alpha (port of part of ``repro.ml.train``).

Only ``load_alpha`` is ported: the checkpoint reader behind the CLI's
``--ml-alpha``. ES training of the alpha over batched twin rollouts
(the reference's ``train``, its reward and the ``train`` subcommand) is
not ported yet.
"""
from __future__ import annotations

import json
import pathlib

import numpy as np


def load_alpha(path: str | pathlib.Path) -> np.ndarray:
    """f32[K] elite alpha from a training checkpoint JSON."""
    ck = json.loads(pathlib.Path(path).read_text())
    return np.asarray(ck["best_alpha"], np.float32)
