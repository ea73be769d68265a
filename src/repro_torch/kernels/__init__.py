"""Hand-written Hopper kernels, one package per JAX Pallas kernel family.

``LAUNCHES`` counts each kernel's launches, one count per CUDA source
(flash attention and WKV have one per dtype: ``flash_attention`` and
``wkv`` for float32, ``flash_attention_tc`` and ``wkv_tc`` for
bfloat16): a wrapper adds one exactly where it launches its kernel, so a
run can show that its path went through the kernel (``chip_smoke.py``
zeroes the counts before the main path and reads them after).
"""
LAUNCHES: dict[str, int] = {"fused_cooling": 0, "group_power": 0,
                             "flash_attention": 0, "flash_attention_tc": 0,
                             "wkv": 0, "wkv_tc": 0, "ssd": 0}
