"""Observability layer (port of ``repro.obs``): the schema-versioned
frame formats (``schema``) and the telemetry fields a metrics stream
carries (``sink``). The run recorder, the span timer, the reporter and
the streaming sink come with the port of the scheduler wire."""
from repro_torch.obs import schema  # noqa: F401
from repro_torch.obs.sink import HALL_FIELDS, SCALAR_FIELDS, history_frames  # noqa: F401
