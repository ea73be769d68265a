"""Real-trace ingestion and telemetry replay (paper contribution 2), the
port of ``repro.traces``.

Everything the synthetic generators fake, this package ingests for real,
behind the same ``JobSet`` interface (``repro_torch.datasets.base``):

- ``jobtable``  — parquet/CSV job tables (PM100/Marconi100-style column
  mapping via a configurable ``TraceSchema``), whole-second rounded to
  the SWF contract so ``core.transport.job_digest`` is stable across
  parquet ↔ ``JobSet`` ↔ SWF roundtrips.
- ``telemetry`` — RAPS-style ``joblive`` + ``jobprofile`` directories
  folded into one cached NPZ per trace, content-addressed by a digest of
  the source bytes; jobs gain a measured ``power_profile`` the engine
  replays verbatim (``JobSet.to_table(replay_power=True)``).
- ``weather``   — measured meteorological traces (CSV/NPZ), resampled to
  the engine ``dt`` with wet-bulb derivation, feeding
  ``cooling.weather.from_arrays``.
- ``calibrate`` — least-squares fit of the transient cooling-loop
  parameters (UA / time constants / fan-staging threshold) to a replayed
  power trace + recorded facility telemetry, emitting a fitted-params
  JSON with residual envelopes.

Every malformed input raises ``TraceError``: rows are never silently
dropped. CSV and parquet need pandas (imported where they are read);
SWF, NPZ traces, NPZ weather and calibration need only numpy (and scipy
for the fit), so the card's path needs no pandas.
"""
from repro_torch.traces.errors import TraceError  # noqa: F401
from repro_torch.traces.jobtable import (PM100_SCHEMA,  # noqa: F401
                                         TraceSchema, jobset_from_frame,
                                         read_job_table, write_job_table)
from repro_torch.traces.telemetry import (jobset_from_npz,  # noqa: F401
                                          jobset_to_npz, load_telemetry,
                                          source_digest)
from repro_torch.traces.weather import (load_weather,  # noqa: F401
                                        wet_bulb_stull)
# (the fitting entry point lives at repro_torch.traces.calibrate.calibrate:
#  re-exporting it here would shadow the submodule)
from repro_torch.traces.calibrate import (FittedParams,  # noqa: F401
                                          check_envelope, simulate_plant)
