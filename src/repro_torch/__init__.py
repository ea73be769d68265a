"""PyTorch/CUDA port of the S-RAPS digital twin (``repro``).

Mirrors ``repro`` module for module. Tensors carry an explicit leading
scenario axis ``S`` where the JAX package used ``vmap``, the engine scan
is a Python loop over steps, and the fused node->CDU cooling step runs as
a CUDA kernel written for Hopper (``kernels/power_topo/csrc``). The
package imports ``torch`` and ``numpy`` only: nothing from JAX or from
``repro``.
"""
