"""PyTorch/CUDA port of the S-RAPS digital twin (``repro``).

Mirrors ``repro`` module for module. Tensors carry an explicit leading
scenario axis ``S`` where the JAX package used ``vmap``, the engine scan
is a Python loop over steps, and every Pallas TPU kernel runs as a CUDA
kernel written for Hopper (``kernels/*/csrc``): the node->CDU cooling and
group-power reductions of the engine, and the flash attention, chunked
WKV and chunked SSD of the LM zoo's serving path (``models``). The
package imports ``torch`` and ``numpy`` (and, inside the functions that
need them, scipy for calibration's fit and pandas for CSV and parquet
traces): nothing from JAX or from ``repro``.
"""
import torch


def resolve_device(device) -> torch.device:
    """The device an entry point runs on: never the CPU unless asked for,
    so a CUDA request without a card raises instead of carrying on."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("repro_torch: no CUDA device is available; pass "
                           "device='cpu' to run on the CPU")
    return dev
