from repro_torch.kernels.mamba2_ssd.ops import ssd  # noqa: F401
from repro_torch.kernels.mamba2_ssd.ref import ssd_chunked, ssd_ref  # noqa: F401
