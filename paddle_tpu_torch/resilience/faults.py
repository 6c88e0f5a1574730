"""Deterministic fault-injection registry — the chaos-campaign backbone
(a copy of ``paddle_tpu/resilience/faults.py``, which imports no JAX; the
port keeps its own, so that nothing of the JAX package is imported).

In the port, the Engine's guarded training step consults ``nan_grads``,
``slow_step`` and ``dispatch_error`` and ``Model.fit`` consults ``sigterm``;
the other seams of the table belong to parts still to port.

A production TPU stack dies from unhandled faults (NaN storms, pod
preemption, page exhaustion, wedged dispatches), not slow kernels.
Every resilience behavior in this repo is therefore driven by a seam
that consults this registry, so the whole failure model is testable on
CPU tier-1 with zero nondeterminism:

    with faults.scenario(("nan_grads", {"step": 5}),
                         ("nan_grads", {"step": 6})):
        model.fit(...)

or from the environment (chaos_smoke campaign stage)::

    PADDLE_TPU_FAULTS="nan_grads@10x3,sigterm@25,slow_step@5:seconds=0.5"

Entry grammar: ``kind[@step][xCOUNT][:k=v;k=v]`` — ``@step`` pins the
fault to a seam step, ``xCOUNT`` arms COUNT firings (default 1), and
``:k=v`` pairs ride as the payload (floats/ints auto-coerced). A
pinned fault with COUNT > 1 is a STORM: it matches the window
[step, step + COUNT), i.e. ``nan_grads@10x3`` poisons steps 10-12 —
exactly the consecutive-bad-step shape that drills rollback.

Seams and their kinds (each seam passes its own step counter):

==================  =====================================================
kind                consulted by
==================  =====================================================
nan_grads           Engine guarded train step (loss *= NaN pre-grad)
slow_step           ServingEngine decode dispatch (host sleep; trips the
                    watchdog), Engine guarded step
dispatch_error      Engine guarded step / ServingEngine dispatch — raises
                    a transient RESOURCE_EXHAUSTED-style error that the
                    retry wrapper absorbs
torn_ckpt           CheckpointManager._write — truncates the state file
                    and suppresses the COMPLETE marker (simulated crash
                    mid-finalize)
sigterm             hapi fit() batch boundary — raises SIGTERM in-process
page_exhaustion     ServingEngine admission — pretends the free list is
                    empty for the matching round
replica_crash       serving_fleet replica worker round — the replica
                    thread dies mid-decode (failover drill)
replica_wedge       serving_fleet replica worker round — the worker stops
                    heartbeating for ``seconds`` (wedge-detection drill)
replica_slow        serving_fleet replica worker round — host sleep per
                    round (tail-latency / hedging drill)
scrape_timeout      FleetRouter health scrape — the scrape raises a
                    transient DEADLINE_EXCEEDED
flaky_transport     ReplicaClient transport op — transient error before
                    (or, with ``after=1``, AFTER) delivery; the retry
                    wrapper + rid idempotency absorb it
router_crash        FleetRouter control round — the router dies mid-step
                    (recovery drill: FleetRouter.recover replays the
                    write-ahead journal and re-adopts the replicas)
journal_torn_write  fleet journal append — the record is written
                    TRUNCATED and JournalCrash raises (process died
                    mid-append); replay drops the torn tail
journal_io_error    fleet journal append — raises JournalError with
                    nothing written (transient disk failure; the
                    router retries lifecycle records, rejects submits)
journal_slow_fsync  fleet journal fsync — host sleep of ``seconds``
                    (slow-disk drill; stalls, never corruption)
replica_exit_at_boot  ProcReplica child boot (serving_fleet/
                    proc_child.py, BEFORE any heavy import) — the
                    subprocess exits nonzero immediately (payload
                    ``exit_code``, default 7). Armed via the child's
                    own ``PADDLE_TPU_PROC_FAULTS`` env; the seam step
                    is the INCARNATION number, so
                    ``replica_exit_at_boot@2x99`` kills every respawn
                    from incarnation 2 on — the crash-loop-breaker
                    drill
replica_slow_boot   ProcReplica child boot — host sleep of ``seconds``
                    before the heavy import (slow-boot-past-the-gate
                    drill; the supervisor's boot timeout kills it).
                    Seam step = incarnation, like exit_at_boot
==================  =====================================================

The journal seams pass the journal's own append (or fsync) sequence
number as the seam step, so ``journal_torn_write@12`` tears exactly
the 12th record this incarnation writes; ``router_crash`` steps are
router control rounds.

Fleet faults target ONE replica via payload (``replica_crash:replica=r1``
or ``inject("replica_crash", replica="r1")``): seams pass their own
identity through ``pull(..., match={"replica": name})`` and a fault
whose payload pins a different identity is skipped without being
consumed. A fault with no ``replica`` payload matches any replica.

The registry is process-global and consult-only-on-armed: ``pull`` on
an empty registry is a tuple check, so production paths pay nothing.
"""
from __future__ import annotations

import contextlib
import os
import signal
import threading
import time

__all__ = ["Fault", "inject", "clear", "armed", "pull", "scenario",
           "load_env", "fired_log", "nan_scale", "maybe_sleep",
           "maybe_raise", "maybe_sigterm", "TransientError"]


class TransientError(RuntimeError):
    """Injected stand-in for a transient runtime/dispatch failure
    (RESOURCE_EXHAUSTED, UNAVAILABLE, ...). The retry wrapper treats it
    — and real errors whose message matches the same grammar — as
    retryable."""


class Fault:
    """One armed fault: fires up to `count` times, optionally pinned to
    a seam step. `payload` rides back to the seam on each firing."""

    __slots__ = ("kind", "step", "count", "payload", "fired")

    def __init__(self, kind, step=None, count=1, **payload):
        self.kind = str(kind)
        self.step = None if step is None else int(step)
        self.count = int(count)
        self.payload = dict(payload)
        self.fired = 0

    @property
    def remaining(self):
        return self.count - self.fired

    def __repr__(self):
        at = "" if self.step is None else f"@{self.step}"
        return (f"Fault({self.kind}{at} x{self.count} "
                f"fired={self.fired} {self.payload})")


_lock = threading.Lock()
_registry: list[Fault] = []
_fired_log: list[tuple[str, int | None]] = []
_env_loaded = False


def inject(kind, step=None, count=1, **payload):
    """Arm one fault. Returns the Fault (inspect `.fired` later)."""
    f = Fault(kind, step=step, count=count, **payload)
    with _lock:
        _registry.append(f)
    return f


def clear():
    """Disarm everything and forget the firing log."""
    with _lock:
        _registry.clear()
        _fired_log.clear()


def armed(kind=None):
    """Any un-exhausted fault (of `kind`, or at all) still armed?"""
    with _lock:
        return any(f.remaining > 0 and (kind is None or f.kind == kind)
                   for f in _registry)


def pull(kind, step=None, match=None):
    """Consume one firing of `kind` matching `step`; returns its payload
    dict, or None when nothing armed matches. A fault armed with
    step=None matches any seam step; a pinned fault matches its storm
    window [step, step + count) — each seam consults a given step once,
    so a pinned count is a run of consecutive steps, not N firings at
    one step. Cheap when the registry is empty (the common case).

    `match` narrows by payload identity (fleet seams): for every key in
    `match`, a fault that PINS that key in its payload must pin the
    same value, or it is skipped WITHOUT being consumed — so
    ``inject("replica_crash", replica="r1")`` fires only for the seam
    pulling with ``match={"replica": "r1"}``, while an unpinned fault
    still matches any puller."""
    if not _registry:          # unlocked fast path: seams in hot loops
        return None
    with _lock:
        for f in _registry:
            if f.kind != kind or f.remaining <= 0:
                continue
            if f.step is not None:
                if step is None:
                    continue
                if not (f.step <= step < f.step + f.count):
                    continue
            if match and any(k in f.payload and f.payload[k] != v
                             for k, v in match.items()):
                continue
            f.fired += 1
            _fired_log.append((kind, step))
            return dict(f.payload)
    return None


def fired_log():
    """(kind, step) tuples in firing order — chaos-test assertions."""
    with _lock:
        return list(_fired_log)


@contextlib.contextmanager
def scenario(*specs):
    """Arm a set of faults for the `with` body, restoring the previous
    registry after. Each spec is a Fault, a kind string, or a
    (kind, kwargs) pair."""
    with _lock:
        saved = list(_registry)
        saved_log = list(_fired_log)
        _registry.clear()
        _fired_log.clear()   # fired_log() inside the scenario reports
        #                      ONLY the scenario's own firings
    for s in specs:
        if isinstance(s, Fault):
            with _lock:
                _registry.append(s)
        elif isinstance(s, str):
            inject(s)
        else:
            kind, kw = s
            inject(kind, **kw)
    try:
        yield
    finally:
        with _lock:
            _registry[:] = saved
            _fired_log[:] = saved_log


def _coerce(v):
    for cast in (int, float):
        try:
            return cast(v)
        except ValueError:
            pass
    return v


def load_env(force=False):
    """Parse PADDLE_TPU_FAULTS (once per process unless force=True).
    Called lazily by the resilience package import; safe to re-call."""
    global _env_loaded
    if _env_loaded and not force:
        return
    _env_loaded = True
    spec = os.environ.get("PADDLE_TPU_FAULTS", "").strip()
    if not spec:
        return
    for entry in spec.split(","):
        entry = entry.strip()
        if not entry:
            continue
        payload = {}
        if ":" in entry:
            entry, raw = entry.split(":", 1)
            for pair in raw.split(";"):
                if "=" in pair:
                    k, v = pair.split("=", 1)
                    payload[k.strip()] = _coerce(v.strip())
        count = 1
        if "x" in entry:
            # only a trailing xN with numeric N is a count suffix —
            # kinds themselves may contain 'x' (page_exhaustion)
            head, c = entry.rsplit("x", 1)
            if c.isdigit():
                entry, count = head, int(c)
        step = None
        if "@" in entry:
            entry, s = entry.split("@", 1)
            step = int(s)
        inject(entry.strip(), step=step, count=count, **payload)


# -- seam helpers (one per fault kind, so seams stay one-liners) ----------

def nan_scale(step=None):
    """Guarded-train-step seam: a scalar the step multiplies into the
    loss BEFORE autodiff — NaN poisons the loss and every gradient in
    one shot; 1.0 is the no-fault value. Returned as a host float so it
    rides the step's stable scalar signature (no recompile)."""
    return float("nan") if pull("nan_grads", step) is not None else 1.0


def maybe_sleep(kind="slow_step", step=None, match=None):
    """Host-side stall seam (watchdog/hedging drills). Payload:
    seconds."""
    p = pull(kind, step, match=match)
    if p is not None:
        time.sleep(float(p.get("seconds", 0.05)))
    return p


def maybe_raise(kind="dispatch_error", step=None, match=None):
    """Transient-dispatch-failure seam. Payload: message."""
    p = pull(kind, step, match=match)
    if p is not None:
        raise TransientError(p.get(
            "message", f"RESOURCE_EXHAUSTED: injected {kind} "
                       f"(step={step})"))


def maybe_sigterm(step=None):
    """Preemption seam: deliver SIGTERM to this process at a step
    boundary, exactly like a pod preemption notice."""
    if pull("sigterm", step) is not None:
        signal.raise_signal(signal.SIGTERM)
        return True
    return False
