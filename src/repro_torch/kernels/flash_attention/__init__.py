from repro_torch.kernels.flash_attention.ops import mha  # noqa: F401
from repro_torch.kernels.flash_attention.ref import mha_ref  # noqa: F401
