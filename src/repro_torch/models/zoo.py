"""Model zoo dispatch: one uniform functional API over the ported
families (the port of ``repro.models.zoo`` for serving).

    api = get_api(cfg)
    params = api.init(generator, device)           # dict tree of tensors
    logits = api.forward(params, batch)
    logits, state = api.prefill(params, batch, max_len)
    logits, state = api.decode(params, tokens, state)

``dense`` and ``moe`` run ``transformer``, ``ssm`` runs ``rwkv6`` and
``hybrid`` runs ``mamba2``; ``encdec`` and ``vlm`` wait for a later slice.
``from_arrays`` carries the JAX package's parameters over.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict

import numpy as np
import torch

from repro_torch.models import mamba2, rwkv6, transformer
from repro_torch.models.common import ArchConfig, unported

_FAMILY_MODULE = {"dense": transformer, "moe": transformer, "ssm": rwkv6,
                  "hybrid": mamba2}


@dataclass
class ModelAPI:
    cfg: ArchConfig
    mod: Any

    def init(self, generator: torch.Generator | None, device):
        """Parameters drawn from ``generator`` (on ``device``) with the JAX
        package's distributions; on the ``meta`` device, shapes only."""
        return self.mod.init(generator, self.cfg, device)

    def forward(self, params, batch: Dict[str, torch.Tensor]):
        return self.mod.forward(params, batch["tokens"], self.cfg)

    def prefill(self, params, batch: Dict[str, torch.Tensor], max_len: int):
        return self.mod.prefill(params, batch["tokens"], self.cfg, max_len)

    def decode(self, params, tokens, state):
        return self.mod.decode_step(params, tokens, state, self.cfg)

    def init_cache(self, batch: int, max_len: int, device):
        """Full decode state with the cache sized ``max_len`` and the write
        position at ``max_len - 1`` (cache almost full), as the JAX
        package's default."""
        pos = max_len - 1
        if self.cfg.family in ("dense", "moe"):
            caches = transformer.init_cache(self.cfg, batch, max_len, device)
            return transformer.DecodeState(caches, pos)
        state = self.mod.init_cache(self.cfg, batch, max_len, device)
        return state._replace(pos=pos)


def get_api(cfg: ArchConfig) -> ModelAPI:
    if cfg.family not in _FAMILY_MODULE:
        raise unported(f"the {cfg.family!r} family ({cfg.name})")
    return ModelAPI(cfg, _FAMILY_MODULE[cfg.family])


def from_arrays(cfg: ArchConfig, params):
    """The port's parameters from the JAX package's value tree
    (``split_tree(api.init(key))[0]``, leaves as numpy arrays): the same
    tree of dicts and lists, each leaf a CPU tensor of the same shape and
    dtype. Raises if the tree differs from the port's."""
    want = get_api(cfg).init(None, "meta")

    def conv(w, a, path):
        if isinstance(w, dict):
            if not isinstance(a, dict) or set(a) != set(w):
                raise ValueError(f"from_arrays: {path or 'params'} has keys "
                                 f"{sorted(a) if isinstance(a, dict) else a!r}"
                                 f", want {sorted(w)}")
            return {k: conv(w[k], a[k], f"{path}/{k}") for k in w}
        if isinstance(w, list):
            if not isinstance(a, (list, tuple)) or len(a) != len(w):
                raise ValueError(f"from_arrays: {path} is not a list of "
                                 f"{len(w)}")
            return [conv(wi, ai, f"{path}/{i}")
                    for i, (wi, ai) in enumerate(zip(w, a))]
        t = torch.from_numpy(np.array(a))   # a writable copy
        if tuple(t.shape) != tuple(w.shape) or t.dtype != w.dtype:
            raise ValueError(f"from_arrays: {path} is {tuple(t.shape)} "
                             f"{t.dtype}, want {tuple(w.shape)} {w.dtype}")
        return t

    return conv(want, params, "")
