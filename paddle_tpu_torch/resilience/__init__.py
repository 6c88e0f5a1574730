"""Resilience of the port (counterpart of ``paddle_tpu/resilience``): the
preemption flag that ``Model.fit`` reads. Fault injection, TrainGuard,
retries and the watchdog come with ROADMAP.md queue 1 items 1.3 and 8."""
from . import preemption  # noqa: F401
