"""SSD dispatcher: a CUDA tensor goes through the Hopper kernel
(``mamba2_ssd.ssd_cuda``), a CPU tensor through the plain chunked version
(``ref.ssd_chunked``). The choice follows the tensor's device and
nothing else: there is no fallback from one to the other. Both return the
final state, which the prefill hands to the decode."""
from __future__ import annotations

from repro_torch.kernels.mamba2_ssd import mamba2_ssd
from repro_torch.kernels.mamba2_ssd.ref import ssd_chunked


def ssd(x, dt, a, B, C):
    """x: [Bz,S,H,P]; dt, a: f32[Bz,S,H]; B, C: [Bz,S,N] in x's dtype.
    Returns (y f32[Bz,S,H,P], final state f32[Bz,H,P,N])."""
    if x.device.type == "cpu":
        return ssd_chunked(x, dt, a, B, C)
    return mamba2_ssd.ssd_cuda(*(z.contiguous() for z in (x, dt, a, B, C)))
