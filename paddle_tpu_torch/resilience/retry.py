"""Retry/backoff wrapper for transient runtime errors (a copy of
``paddle_tpu/resilience/retry.py``, which imports no JAX).

TPU runtimes surface recoverable conditions as textual status codes
(RESOURCE_EXHAUSTED while another client's pages drain, UNAVAILABLE /
DEADLINE_EXCEEDED across a flaky tunnel, ABORTED on a preempted
dispatch). Those deserve a bounded, deterministic backoff-and-retry at
the dispatch seam — not a dead training job. Everything else (shape
errors, OOM of the program itself, assertion failures) must propagate
untouched.

Deterministic by design: delays are a fixed exponential ladder (no
jitter by default) so chaos tests assert exact retry counts and the
campaign replays identically under a fixed seed. Jitter is OPT-IN and
itself seeded (``jitter=``/``jitter_seed=``): N fleet replicas
retrying the same transient fault would otherwise back off in
lockstep and re-collide as a thundering herd — each replica passes its
own seed, so the schedules de-synchronize but any single schedule
still replays bit-identically.
"""
from __future__ import annotations

import random
import time

from .faults import TransientError

__all__ = ["TransientError", "is_transient", "retryable_for",
           "call_with_retries", "backoff_schedule", "RetryStats"]

# status-code grammar shared by PJRT/XLA runtime errors; matched against
# str(exc) because the concrete exception types vary by jaxlib version
_TRANSIENT_MARKERS = ("RESOURCE_EXHAUSTED", "UNAVAILABLE",
                      "DEADLINE_EXCEEDED", "ABORTED",
                      "connection reset", "Socket closed")


def is_transient(exc):
    """Retryable? Injected TransientErrors always are; real errors only
    when their message carries a transient status code."""
    if isinstance(exc, TransientError):
        return True
    if isinstance(exc, (RuntimeError, OSError, ConnectionError)):
        msg = str(exc)
        return any(m in msg for m in _TRANSIENT_MARKERS)
    return False


def retryable_for(donate):
    """The canonical dispatch-seam retry predicate. Under buffer
    donation a REAL mid-execute failure has already consumed the
    donated arrays, so only injected TransientErrors — which seams
    raise BEFORE the execute — are safely retryable; without donation
    the full transient grammar is."""
    if donate:
        return lambda e: isinstance(e, TransientError)
    return is_transient


class RetryStats:
    """Mutable counter bag a caller can thread through many
    call_with_retries sites (TrainGuard and ServingEngine each own
    one; health()/log_scalars() surface it)."""

    __slots__ = ("retries", "gave_up")

    def __init__(self):
        self.retries = 0
        self.gave_up = 0

    def as_dict(self):
        return {"retries": self.retries, "gave_up": self.gave_up}


def backoff_schedule(retries, base_delay=0.05, max_delay=2.0,
                     jitter=0.0, jitter_seed=0):
    """The exact delays call_with_retries would sleep, precomputed:
    delay[i] = min(base_delay * 2**i, max_delay), each stretched by a
    factor in [1, 1+jitter) drawn from ``random.Random(jitter_seed)``.
    jitter=0 (the default) is the historical exact ladder; with jitter
    on, the schedule is a pure function of the seed — two replicas
    with different seeds spread out, one replica replays identically."""
    rng = random.Random(jitter_seed)
    out = []
    for attempt in range(max(0, int(retries))):
        d = min(base_delay * (2 ** attempt), max_delay)
        if jitter:
            d *= 1.0 + float(jitter) * rng.random()
        out.append(d)
    return out


def call_with_retries(fn, *args, retries=3, base_delay=0.05,
                      max_delay=2.0, retryable=is_transient,
                      stats=None, on_retry=None, jitter=0.0,
                      jitter_seed=0, **kwargs):
    """Run fn(*args, **kwargs); on a retryable error, back off
    (base_delay * 2**attempt, capped; optionally seeded-jittered — see
    backoff_schedule) and retry up to `retries` times. The final
    failure re-raises the last error unchanged.

    CAUTION at donating seams: a retry re-submits the same argument
    arrays, which is only safe when the failure happened before the
    donated buffers were consumed. The engine/serving dispatch seams
    therefore pass a narrowed `retryable` when donation is on —
    injected TransientErrors (raised BEFORE the execute) retry, real
    runtime errors from the execute itself propagate."""
    delays = backoff_schedule(retries, base_delay, max_delay,
                              jitter=jitter, jitter_seed=jitter_seed)
    attempt = 0
    while True:
        try:
            return fn(*args, **kwargs)
        except Exception as e:  # noqa: BLE001 — filtered by retryable()
            if not retryable(e) or attempt >= retries:
                if stats is not None and retryable(e):
                    stats.gave_up += 1
                raise
            if stats is not None:
                stats.retries += 1
            if on_retry is not None:
                on_retry(e, attempt)
            time.sleep(delays[attempt])
            attempt += 1
