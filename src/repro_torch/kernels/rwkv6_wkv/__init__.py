from repro_torch.kernels.rwkv6_wkv.ops import wkv, wkv_decode_step  # noqa: F401
from repro_torch.kernels.rwkv6_wkv.ref import wkv_chunked, wkv_ref  # noqa: F401
