"""Power-conversion losses (rectifier + secondary conversion), after
Wojda et al. [42] as used by ExaDigiT (port of ``repro.power.losses``):
efficiency is a quadratic function of fractional load, applied in two
stages (480V rectification, then on-board SIVOC / voltage regulation).

Facility input power  P_in = P_IT / (eta_rect(load) * eta_sivoc(load)).
Loss = P_in - P_IT.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.systems.config import PowerConfig


def _eta(coeffs, load):
    c0, c1, c2 = coeffs
    eta = c0 + c1 * load + c2 * load * load
    return torch.clamp(eta, 0.5, 0.999)


def conversion(power_cfg: PowerConfig, p_it: torch.Tensor,
               n_racks: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Return (facility_input_power, loss_power) in W for aggregate IT
    power ``p_it`` (W, any shape).

    ``load`` is the fractional loading of the rectifier fleet: IT power over
    the rated capacity of all racks. Efficiency degrades toward low load,
    which is what makes *scheduling* visible in the loss curve.
    """
    # rated capacity rounded through f32 step by step, as the reference
    # does it in f32 arithmetic
    rated_w = np.float32(n_racks) * np.float32(power_cfg.rated_rack_kw) \
        * np.float32(1e3)
    load = torch.clamp(p_it / float(max(rated_w, np.float32(1.0))), 0.0, 1.5)
    eta = _eta(power_cfg.rect_c, load) * _eta(power_cfg.sivoc_c, load)
    p_in = p_it / eta
    return p_in, p_in - p_it
