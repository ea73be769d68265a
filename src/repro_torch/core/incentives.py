"""Incentive structures (paper §4.3), after Solorzano et al. [37]; port of
``repro.core.incentives``. An account running ``node_hours`` at average
per-node power ``avg_pnode`` earns

    pts = node_hours * max(0, (P_ref - avg_pnode) / P_ref)

and redeems them through the ``acct_fugaku_pts`` scheduler policy.
"""
from __future__ import annotations

import torch

from repro_torch.systems.config import SystemConfig


def fugaku_points(system: SystemConfig, node_hours: torch.Tensor,
                  avg_pnode_w: torch.Tensor) -> torch.Tensor:
    p_ref = system.power.ref_node_w
    frac = (p_ref - avg_pnode_w) / p_ref
    return node_hours * torch.clamp(frac, 0.0, 1.0)
