"""The bf16 serving path against the float32 one, at full depth.

``chip_smoke.py`` holds each LM arch's bf16 prefill logits (the path that
runs the tensor-core kernels) to the float32 prefill logits of the same
weights and prompts at full width on the card, as
max |bf16 - f32| / max |f32| under ``BF16_LOGIT_TOL``. This file holds
the smoke widths at each arch's full depth to the same bounds on the CPU,
for the port and for the JAX package on the same weights (numpy from a
seed, carried over with ``from_arrays``): bf16 rounds the operands of
every product to 2^-9, and under untrained weights the drift compounds
with depth, in the reference as much as in the port, far more in rwkv6
than in the other two. The float32 paths of the two packages agree at
full depth to the LM tolerance, 1e-4.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import common as jC
from repro.models.zoo import get_api as jget_api
from repro_torch.configs import registry as treg
from repro_torch.models import zoo as tzoo

torch.set_num_threads(1)

# chip_smoke.BF16_LOGIT_TOL
BF16_LOGIT_TOL = {"qwen2.5-3b": 0.05, "rwkv6-7b": 0.5, "zamba2-7b": 0.05}
F32_TOL = 1e-4


def drift(got, want):
    """max |got - want| / max |want|."""
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("arch", sorted(BF16_LOGIT_TOL))
def test_bf16_prefill_tracks_float32_at_full_depth(arch):
    depth = jreg.get_config(arch).n_layers
    jcfg = dataclasses.replace(jreg.get_config(arch + "-smoke"),
                               n_layers=depth)
    tcfg = dataclasses.replace(treg.get_config(arch + "-smoke"),
                               n_layers=depth)
    params, _ = jC.split_tree(jget_api(jcfg).init(jax.random.PRNGKey(0)))
    tparams = tzoo.from_arrays(tcfg, jax.tree_util.tree_map(np.asarray,
                                                            params))
    tokens = np.random.default_rng(1).integers(0, jcfg.vocab, (2, 64))
    jlog, tlog = {}, {}
    for jdt, tdt in ((jnp.bfloat16, torch.bfloat16),
                     (jnp.float32, torch.float32)):
        japi = jget_api(dataclasses.replace(jcfg, dtype=jdt))
        jl, _ = japi.prefill(params, {"tokens": jnp.asarray(tokens, jnp.int32)},
                             65)
        jlog[tdt] = np.asarray(jl, np.float32)
        tapi = tzoo.get_api(dataclasses.replace(tcfg, dtype=tdt))
        tl, _ = tapi.prefill(tparams, {"tokens": torch.from_numpy(tokens)}, 65)
        assert tl.shape == (2, tcfg.vocab) and torch.isfinite(tl).all()
        tlog[tdt] = tl.float().numpy()
    np.testing.assert_allclose(tlog[torch.float32], jlog[torch.float32],
                               rtol=F32_TOL, atol=F32_TOL)
    bound = BF16_LOGIT_TOL[arch]
    assert drift(tlog[torch.bfloat16], tlog[torch.float32]) <= bound
    assert drift(jlog[torch.bfloat16], jlog[torch.float32]) <= bound
