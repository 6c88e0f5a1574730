"""Telemetry of the port (counterpart of ``paddle_tpu/observability``):
for now only the crash flight recorder, which TrainGuard notes every
guarded step into and dumps on a rollback. The metrics registry, the
recompile tracer, spans, the exporter and the rest come with ROADMAP.md
queue 1 item 8."""
from . import flightrec  # noqa: F401
from .flightrec import FlightRecorder  # noqa: F401
