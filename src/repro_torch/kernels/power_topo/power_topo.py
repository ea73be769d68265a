"""Hopper kernels of the power topology: build, bind, launch.

``csrc/fused_cooling.cu`` replaces the Pallas TPU kernel
``fused_cooling_pallas`` and ``csrc/group_power.cu`` replaces
``group_power_pallas`` (both in ``repro/kernels/power_topo/power_topo.py``).
``kernels._build`` compiles each source for ``sm_90a`` at first use and
binds it with ``ctypes``.

The wrappers take CUDA tensors only; the CPU path is ``ref.py``, chosen by
``ops`` from the tensor's device.
"""
from __future__ import annotations

import pathlib

import torch

from repro_torch import kernels
from repro_torch.kernels import _build
from repro_torch.kernels._build import F as _F, I as _I, L as _L, P as _P
from repro_torch.kernels.power_topo.ref import CduParams, slew_factors

LIB = _build.Library(pathlib.Path(__file__).parent, {
    "fused_cooling": [
        _P, _I, _I, _I, _I,                 # node_pw, S, N, G, span
        _P, _P, _P, _L, _L, _P, _L, _L,     # t_sup, mdot, tb(+strides), tset(+strides)
        _F, _F, _F, _F, _F, _F, _F,         # CDU scalars
        _P, _P, _P, _P, _P],                # 4 outputs, stream
    "group_power": [
        _P, _I, _I, _I, _I,                 # node_pw, S, N, G, span
        _I, _F,                             # split flag, idle floor (W)
        _P, _P, _P],                        # 2 outputs, stream
})


def fused_cooling_cuda(node_pw: torch.Tensor, t_supply: torch.Tensor,
                       mdot: torch.Tensor, t_basin: torch.Tensor,
                       t_set: torch.Tensor, n_groups: int, p: CduParams):
    """Launch the fused kernel on the current stream.

    Args:
      node_pw: f32[S, N] per-node power (W), contiguous, on a CUDA device.
      t_supply, mdot: f32[S, G] CDU loop state (°C, kg/s), contiguous.
      t_basin, t_set: f32[S, G] basin temperature and setpoint seen by each
        group (°C); any strides, so a broadcast (expanded) column is
        passed without a copy.
    Returns:
      (q, t_return, t_supply_new, mdot_new), each a new f32[S, G].
    """
    if node_pw.ndim != 2:
        raise ValueError(f"fused_cooling: node_pw must have shape [S, N], "
                         f"got {tuple(node_pw.shape)}")
    S, N = node_pw.shape
    args = (("node_pw", node_pw, (S, N)), ("t_supply", t_supply, (S, n_groups)),
            ("mdot", mdot, (S, n_groups)), ("t_basin", t_basin, (S, n_groups)),
            ("t_set", t_set, (S, n_groups)))
    for name, x, shape in args:
        if x.dtype != torch.float32:
            raise ValueError(f"fused_cooling: {name} must be float32, got "
                             f"{x.dtype}")
        if tuple(x.shape) != shape:
            raise ValueError(f"fused_cooling: {name} has shape "
                             f"{tuple(x.shape)}, want {shape}")
    dev = node_pw.device
    for name, x, _ in args:
        if x.device.type != "cuda" or x.device != dev:
            raise ValueError(f"fused_cooling: {name} must be a CUDA tensor "
                             f"on the device of node_pw, got {x.device}")
    for name, x, _ in args[:3]:
        if not x.is_contiguous():
            raise ValueError(f"fused_cooling: {name} must be contiguous")
    span = -(-N // n_groups)        # ceil: matches ref.group_ids
    a_valve, a_hx = slew_factors(p)
    outs = [torch.empty((S, n_groups), dtype=torch.float32, device=dev)
            for _ in range(4)]
    _build.launch(
        LIB, "fused_cooling", dev,
        node_pw.data_ptr(), S, N, n_groups, span,
        t_supply.data_ptr(), mdot.data_ptr(),
        t_basin.data_ptr(), t_basin.stride(0), t_basin.stride(1),
        t_set.data_ptr(), t_set.stride(0), t_set.stride(1),
        a_valve, a_hx, p.cp_j_kg_k, p.cp_j_kg_k * p.delta_t_design_c,
        p.ua_w_k, p.mdot_min_kg_s, p.mdot_max_kg_s,
        *(o.data_ptr() for o in outs))
    kernels.LAUNCHES["fused_cooling"] += 1
    return tuple(outs)


def group_power_cuda(node_pw: torch.Tensor, n_groups: int,
                     idle_w: float | None = None):
    """Launch the group-power kernel on the current stream.

    Args:
      node_pw: f32[S, N] per-node power (W), contiguous, on a CUDA device.
      n_groups: number of CDU groups G (contiguous ceil-spans of nodes).
      idle_w: None for the plain segment sum; the per-node idle floor (W)
        for the split mode.
    Returns:
      plain: a new f32[S, G] of group sums; split: (floor_g, dyn_g), two
      new f32[S, G], the groups' sums of ``min(p, idle)`` and of the rest.
    """
    if node_pw.ndim != 2:
        raise ValueError(f"group_power: node_pw must have shape [S, N], "
                         f"got {tuple(node_pw.shape)}")
    if node_pw.dtype != torch.float32:
        raise ValueError(f"group_power: node_pw must be float32, got "
                         f"{node_pw.dtype}")
    if node_pw.device.type != "cuda":
        raise ValueError(f"group_power: node_pw must be a CUDA tensor, got "
                         f"{node_pw.device}")
    if not node_pw.is_contiguous():
        raise ValueError("group_power: node_pw must be contiguous")
    S, N = node_pw.shape
    if S < 1 or N < 1 or n_groups < 1:
        raise ValueError(f"group_power: need S, N, G >= 1, got S={S} N={N} "
                         f"G={n_groups}")
    span = -(-N // n_groups)        # ceil: matches ref.group_ids
    split = idle_w is not None
    dev = node_pw.device
    outs = [torch.empty((S, n_groups), dtype=torch.float32, device=dev)
            for _ in range(2 if split else 1)]
    _build.launch(
        LIB, "group_power", dev,
        node_pw.data_ptr(), S, N, n_groups, span, int(split),
        float(idle_w) if split else 0.0, outs[0].data_ptr(),
        outs[1].data_ptr() if split else None)
    kernels.LAUNCHES["group_power"] += 1
    return tuple(outs) if split else outs[0]
