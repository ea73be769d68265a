"""Grid-aware power management: time-varying grid signals (carbon
intensity, electricity price, facility power-cap schedule), DVFS cap
enforcement, and the sustainability-aware scheduling hooks they feed.

``signals``  -- precomputed per-step signal arrays + per-step gathering.
``powercap`` -- per-step proportional DVFS throttle against the active cap.
"""
from repro_torch.grid.signals import (  # noqa: F401
    GridNow, GridSignals, at_step, constant_signals, neutral,
    synthetic_signals)
from repro_torch.grid.powercap import enforce_cap, throttle_power  # noqa: F401
