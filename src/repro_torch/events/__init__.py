"""Failure and demand-response layer (port of ``repro.events``): seeded
stochastic node, CDU-group and tower-cell outages with repair times,
realized inside the engine step as availability masks, and grid
demand-response cap steps with notice windows. Enabled by passing an
``EventConfig`` to the engine's entry points; with every rate at zero and
no DR event the engine's results equal those of a run without it, bit
for bit."""
from repro_torch.events.process import (DrNow, EventConfig, EventsNow,
                                        apply_failures, dr_now,
                                        init_event_state, realize_masks)

__all__ = ["DrNow", "EventConfig", "EventsNow", "apply_failures", "dr_now",
           "init_event_state", "realize_masks"]
