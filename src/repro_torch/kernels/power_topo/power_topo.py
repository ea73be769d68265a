"""Hopper kernels of the power topology: launch plan, build, bind, launch.

``csrc/fused_cooling.cu`` replaces the Pallas TPU kernel
``fused_cooling_pallas`` and ``csrc/group_power.cu`` replaces
``group_power_pallas`` (both in ``repro/kernels/power_topo/power_topo.py``);
both sum node powers over CDU groups with ``csrc/segment_sum.cuh``, whose
launch plan ``plan`` mirrors. ``kernels._build`` compiles each source for
``sm_90a`` at first use and binds it with ``ctypes``.

The wrappers take CUDA tensors only; the CPU path is ``ref.py``, chosen by
``ops`` from the tensor's device. What does not change from call to call
(the plan, strides and CDU scalars) is packed into a C struct once per
shape and parameter set, so a call passes ten arguments.
"""
from __future__ import annotations

import ctypes
import functools
import pathlib
from typing import NamedTuple

import torch

from repro_torch import kernels
from repro_torch.kernels import _build
from repro_torch.kernels._build import F as _F, I as _I, L as _L, P as _P
from repro_torch.kernels.power_topo.ref import CduParams, slew_factors

# segment_sum.cuh's constants
QUADS_PER_THREAD = 4     # kQuads: quads (4 nodes) a thread loads at once
WARP_BLOCK_WARPS = 4     # kWarpBlockWarps: groups per block in warp mode
CTA_THREADS = 512        # kCtaThreads: threads a CTA in CTA mode

LIB = _build.Library(pathlib.Path(__file__).parent, {
    # node_pw, t_supply, mdot, t_basin, hall, t_set, out, args, vec, stream
    "fused_cooling": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _P],
    # node_pw, out, args, vec, stream
    "group_power": [_P, _P, _P, _I, _P],
})


class Plan(NamedTuple):
    """How the kernels cut a row of N node powers into G group sums: a
    function of (N, G) alone, so a row of a sweep sums in the order of a
    solo run (``csrc/segment_sum.cuh`` states the order)."""
    span: int          # nodes per group, ceil(N / G); the last is ragged
    vector: bool       # 128-bit loads: N % 4 == 0 and span % 4 == 0
    unit_threads: int  # threads summing one group: 32 (a warp) or a CTA's
    quads: int         # quads (4 nodes) per group, ceil(span / 4)
    rounds: int        # rounds of QUADS_PER_THREAD loads per thread


@functools.lru_cache(maxsize=64)
def plan(n_nodes: int, n_groups: int) -> Plan:
    """The launch plan for groups of ceil(N / G) contiguous nodes.

    A span of up to 32 x QUADS_PER_THREAD quads (512 nodes; Frontier's is
    384) is one warp's. A longer one (Fugaku's 4,968) is one CTA's of
    CTA_THREADS threads, each thread taking at most QUADS_PER_THREAD quads
    at once (more rounds past 8,192 nodes a group).
    """
    if n_nodes < 1 or n_groups < 1:
        raise ValueError(f"power_topo: need N, G >= 1, got N={n_nodes} "
                         f"G={n_groups}")
    span = -(-n_nodes // n_groups)          # ceil: matches ref.group_ids
    quads = -(-span // 4)
    vector = n_nodes % 4 == 0 and span % 4 == 0
    if quads <= 32 * QUADS_PER_THREAD:
        return Plan(span, vector, 32, quads, 1)
    return Plan(span, vector, CTA_THREADS, quads,
                -(-quads // (CTA_THREADS * QUADS_PER_THREAD)))


class _Plan(ctypes.Structure):          # segment_sum.cuh segsum::Plan
    _fields_ = [(name, ctypes.c_int) for name in (
        "n_scen", "n_nodes", "n_groups", "span", "quads", "rounds")]


class _FusedArgs(ctypes.Structure):     # fused_cooling.cu FusedArgs
    _fields_ = [("plan", _Plan), ("tb_s", _L), ("tb_g", _L), ("ts_s", _L),
                ("ts_g", _L)] + [(name, _F) for name in (
                    "a_valve", "a_hx", "cp", "cp_dt_design", "ua",
                    "mdot_min", "mdot_max")]


class _GroupArgs(ctypes.Structure):     # group_power.cu GroupArgs
    _fields_ = [("plan", _Plan), ("split", _I), ("idle", _F)]


def _plan_struct(n_scen: int, n_nodes: int, n_groups: int) -> _Plan:
    p = plan(n_nodes, n_groups)
    return _Plan(n_scen, n_nodes, n_groups, p.span, p.quads, p.rounds)


@functools.lru_cache(maxsize=64)
def _fused_args(shape: tuple, tb_stride: tuple, ts_stride: tuple,
                p: CduParams):
    """(struct, its address, 128-bit loads allowed) for shape (S, N, G)
    and the strides of t_basin and t_set: kept alive by the cache."""
    a_valve, a_hx = slew_factors(p)
    args = _FusedArgs(_plan_struct(*shape), *_columns(tb_stride),
                      *_columns(ts_stride), a_valve, a_hx, p.cp_j_kg_k,
                      p.cp_j_kg_k * p.delta_t_design_c, p.ua_w_k,
                      p.mdot_min_kg_s, p.mdot_max_kg_s)
    return args, ctypes.addressof(args), plan(*shape[1:]).vector


@functools.lru_cache(maxsize=64)
def _group_args(shape: tuple, idle_w):
    """As ``_fused_args``, for the plain (idle_w None) or split mode."""
    args = _GroupArgs(_plan_struct(*shape), int(idle_w is not None),
                      0.0 if idle_w is None else idle_w)
    return args, ctypes.addressof(args), plan(*shape[1:]).vector


def _columns(stride: tuple) -> tuple[int, int]:
    """(row, column) element strides of an [S] or [S, K] operand from its
    ``stride()``; an [S] operand is shared by every column (stride 0)."""
    return (stride[0], 0) if len(stride) == 1 else stride


def _vec(allowed: bool, ptr: int) -> int:
    """128-bit loads where the plan allows them and the rows start on a
    16-byte boundary; scalar loads add in the same order."""
    return int(allowed and ptr % 16 == 0)


def _check(kernel: str, operands) -> None:
    """Raise ValueError for what the kernel does not take, in this order:
    a type or shape of any operand, then an operand off node_pw's CUDA
    device, then a layout. ``operands``: (name, tensor, dtype, allowed
    shapes, must be contiguous), node_pw first."""
    for name, x, dtype, shapes, _ in operands:
        if x.dtype is not dtype:
            want = str(dtype).removeprefix("torch.")
            raise ValueError(f"{kernel}: {name} must be {want}, got "
                             f"{x.dtype}")
        if x.shape not in shapes:
            raise ValueError(f"{kernel}: {name} has shape {tuple(x.shape)}, "
                             f"want one of {sorted(shapes)}")
    on = operands[0][1].get_device()      # node_pw's (-1 on the CPU)
    for name, x, *_ in operands:
        if on < 0 or x.get_device() != on:
            raise ValueError(f"{kernel}: {name} must be a CUDA tensor on the "
                             f"device of node_pw, got {x.device}")
    for name, x, _, _, contiguous in operands:
        if contiguous and not x.is_contiguous():
            raise ValueError(f"{kernel}: {name} must be contiguous")


def _rows(kernel: str, node_pw: torch.Tensor) -> tuple[int, int]:
    """(S, N) of node_pw [S, N], both at least 1."""
    if node_pw.ndim != 2 or 0 in node_pw.shape:
        raise ValueError(f"{kernel}: node_pw must have shape [S, N] with "
                         f"S, N >= 1, got {tuple(node_pw.shape)}")
    return node_pw.shape


def fused_cooling_cuda(node_pw: torch.Tensor, t_supply: torch.Tensor,
                       mdot: torch.Tensor, t_basin: torch.Tensor,
                       t_set: torch.Tensor, n_groups: int, p: CduParams,
                       hall: torch.Tensor | None = None):
    """Launch the fused kernel on the current stream.

    Args:
      node_pw: f32[S, N] per-node power (W), contiguous, on a CUDA device.
      t_supply, mdot: f32[S, G] CDU loop state (°C, kg/s), contiguous.
      t_basin: basin temperature (°C): f32[S, G] per group, f32[S] per
        scenario, or with ``hall`` f32[S, H] per hall; any strides.
      t_set: setpoint (°C), f32[S] or f32[S, G]; any strides.
      hall: None, or i32[G] on the device: the hall (column of t_basin)
        of each group, each below H (``ops.fused_cooling_hier`` makes it).
    Returns:
      (q, t_return, t_supply_new, mdot_new): f32[S, G] views of one new
      f32[4, S, G].
    """
    S, N = _rows("fused_cooling", node_pw)
    G, f32 = n_groups, torch.float32
    H = G if hall is None else t_basin.shape[-1]
    sg, s1 = ((S, G),), ((S,), (S, G))
    operands = [("node_pw", node_pw, f32, ((S, N),), True),
                ("t_supply", t_supply, f32, sg, True),
                ("mdot", mdot, f32, sg, True),
                ("t_basin", t_basin, f32, ((S,), (S, H)), False),
                ("t_set", t_set, f32, s1, False)]
    if hall is not None:
        operands.append(("hall", hall, torch.int32, ((G,),), True))
    _check("fused_cooling", operands)
    _, args, vector = _fused_args((S, N, G), t_basin.stride(),
                                  t_set.stride(), p)
    ptr = node_pw.data_ptr()
    out = node_pw.new_empty((4, S, G))      # float32, node_pw's device
    _build.launch(
        LIB, "fused_cooling", out.device, ptr, t_supply.data_ptr(),
        mdot.data_ptr(), t_basin.data_ptr(),
        None if hall is None else hall.data_ptr(), t_set.data_ptr(),
        out.data_ptr(), args, _vec(vector, ptr))
    kernels.LAUNCHES["fused_cooling"] += 1
    return out.unbind(0)


def group_power_cuda(node_pw: torch.Tensor, n_groups: int,
                     idle_w: float | None = None):
    """Launch the group-power kernel on the current stream.

    Args:
      node_pw: f32[S, N] per-node power (W), contiguous, on a CUDA device.
      n_groups: number of CDU groups G (contiguous ceil-spans of nodes).
      idle_w: None for the plain segment sum; the per-node idle floor (W)
        for the split mode.
    Returns:
      plain: a new f32[S, G] of group sums; split: (floor_g, dyn_g), the
      groups' sums of ``min(p, idle)`` and of the rest, f32[S, G] views of
      one new f32[2, S, G].
    """
    S, N = _rows("group_power", node_pw)
    _check("group_power",
           [("node_pw", node_pw, torch.float32, ((S, N),), True)])
    split = idle_w is not None
    _, args, vector = _group_args((S, N, n_groups),
                                  float(idle_w) if split else None)
    ptr = node_pw.data_ptr()
    out = node_pw.new_empty((2, S, n_groups) if split else (S, n_groups))
    _build.launch(LIB, "group_power", out.device, ptr, out.data_ptr(), args,
                  _vec(vector, ptr))
    kernels.LAUNCHES["group_power"] += 1
    return out.unbind(0) if split else out
