"""Resilience of the port (counterpart of ``paddle_tpu/resilience``): fault
injection, the train guard, preemption and retry.

- faults:      env/context-driven injection registry + seam helpers
- TrainGuard:  in-step finite check and masked update, skip counters,
               snapshot ring, in-place rollback (guard.py; the step half
               in hapi/engine.py)
- preemption:  SIGTERM/SIGINT -> flag that Model.fit polls
- retry:       bounded deterministic backoff for transient errors

The watchdog (serving health) comes with ROADMAP.md queue 1 item 8.
"""
from . import faults  # noqa: F401
from . import preemption  # noqa: F401
from . import retry  # noqa: F401
from .faults import TransientError, inject, scenario  # noqa: F401
from .guard import TrainGuard  # noqa: F401
from .retry import (RetryStats, backoff_schedule,  # noqa: F401
                    call_with_retries, is_transient)

__all__ = ["faults", "preemption", "retry", "TrainGuard", "TransientError",
           "RetryStats", "inject", "scenario", "call_with_retries",
           "backoff_schedule", "is_transient"]

# arm any faults PADDLE_TPU_FAULTS names at the subsystem's first import,
# as the reference does
faults.load_env()
