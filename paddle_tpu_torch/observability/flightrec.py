"""Crash flight recorder — the last N run facts survive the incident (a
copy of ``paddle_tpu/observability/flightrec.py``, which imports no JAX,
with the reference's two atomic-write helpers of ``io/atomic.py`` kept
here).

In the port, TrainGuard notes every guarded step and dumps on a
rollback; the metrics registry and the recompile report that the
reference adds to a dump belong to ROADMAP.md item 8, and a dump
records them as null until then.

When a run dies (guard rollback storm, wedged dispatch, SIGTERM
preemption, unhandled exception in fit()/serve), the postmortem
question is always "what were the last few steps doing". This module
keeps a bounded ring of telemetry records (train steps, serve
dispatches, request finishes, guard outcomes — whatever the
instrumented layers ``note()``) and, on a trigger, dumps the ring
plus a registry snapshot and the recompile report to
``flight_<reason>.json`` — always RFC-valid JSON (a storm's NaN loss
nulls out), always atomic, never clobbering an earlier dump (numeric
suffixes).

Dump directory resolution (at dump time, not construction — the env
may be set per campaign stage): explicit ``run_dir`` >
``PADDLE_TPU_FLIGHT_DIR`` > ``BENCH_TELEMETRY_DIR`` >
``<tempdir>/paddle_tpu_flight``. Never the CWD — a chaos suite must
not litter the repo root.

Triggers are wired through the resilience seams: TrainGuard dumps on
rollback, ServingEngine on a watchdog wedge, ``Model.fit`` on
preemption and on an unhandled exception, ``ServingEngine.step`` on
an unhandled exception — so chaos tests can assert a parseable dump
exists for every failure mode they inject. ``note()`` is one deque
append under a lock; ``dump()`` never raises (a broken disk must not
mask the original failure).

Stdlib-only.
"""
from __future__ import annotations

import json
import math
import os
import tempfile
import threading
import time

__all__ = ["FlightRecorder", "get_recorder", "note", "dump"]

def _unique_path(directory, stem, ext=".json"):
    """A fresh ``<dir>/<stem><ext>`` that never clobbers an existing file
    (numeric ``_2``, ``_3``... suffixes); `stem` sanitized to [alnum - _]
    (the reference's ``io.atomic.unique_path``)."""
    safe = "".join(c if (c.isalnum() or c in "-_") else "_"
                   for c in str(stem)) or "unknown"
    path = os.path.join(directory, f"{safe}{ext}")
    n = 2
    while os.path.exists(path):
        path = os.path.join(directory, f"{safe}_{n}{ext}")
        n += 1
    return path


def _atomic_replace(path, text):
    """Write `text` to `path` atomically: a tmp sibling, fsync,
    ``os.replace`` (the reference's ``io.atomic.atomic_replace``)."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(text.encode("utf-8"))
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return path


def _finite(obj):
    if isinstance(obj, float):
        return obj if math.isfinite(obj) else None
    if isinstance(obj, dict):
        return {k: _finite(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_finite(v) for v in obj]
    return obj


def _default_dir():
    return (os.environ.get("PADDLE_TPU_FLIGHT_DIR")
            or os.environ.get("BENCH_TELEMETRY_DIR")
            or os.path.join(tempfile.gettempdir(), "paddle_tpu_flight"))


class FlightRecorder:
    """Bounded ring of {"ts", "kind", ...} records + dump-on-trigger.

    capacity: ring size — oldest records evict first, so the ring is
        always the LAST `capacity` facts in arrival order.
    run_dir: dump directory (None = resolve from env at dump time).
    registry: an object with ``snapshot()`` put into every dump (None:
        the dump's ``registry`` is null; the port has no metrics
        registry yet).
    """

    def __init__(self, capacity=256, run_dir=None, registry=None):
        import collections
        self.capacity = int(capacity)
        self._ring = collections.deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self.run_dir = run_dir
        self._registry = registry
        self.dumps = []            # paths written, in order
        self._seq = 0              # total records ever noted

    # -- recording ---------------------------------------------------------
    def note(self, kind, **fields):
        """Append one record. O(1), host-side, never raises."""
        rec = {"ts": round(time.time(), 6), "kind": kind}
        rec.update(fields)
        with self._lock:
            rec["seq"] = self._seq
            self._seq += 1
            self._ring.append(rec)
        return rec

    def records(self):
        with self._lock:
            return [dict(r) for r in self._ring]

    def clear(self):
        with self._lock:
            self._ring.clear()
            self.dumps = []
            self._seq = 0

    # -- dumping -----------------------------------------------------------
    def _resolve_dir(self):
        return self.run_dir or _default_dir()

    def _unique_path(self, d, reason):
        return _unique_path(d, f"flight_{reason}")

    def dump(self, reason, extra=None):
        """Write the flight record for `reason`; returns the path or
        None (a failed write must never mask the original failure —
        the reason a dump is happening at all)."""
        try:
            doc = {"reason": str(reason),
                   "ts": round(time.time(), 6),
                   "records": self.records()}
            if extra:
                doc.update(extra)
            reg = self._registry
            try:
                doc["registry"] = None if reg is None else reg.snapshot()
            except Exception:  # noqa: BLE001
                doc["registry"] = None
            doc["recompile_report"] = None
            d = self._resolve_dir()
            os.makedirs(d, exist_ok=True)
            path = self._unique_path(d, reason)
            try:
                text = json.dumps(doc, indent=1, allow_nan=False)
            except ValueError:
                text = json.dumps(_finite(doc), indent=1,
                                  allow_nan=False)
            # shared crash-safe write (io/atomic.py): the dump itself
            # must never be a torn artifact for the postmortem to trip on
            _atomic_replace(path, text)
            self.dumps.append(path)
            return path
        except Exception:  # noqa: BLE001 — see docstring
            return None


_default = None
_default_lock = threading.Lock()


def get_recorder():
    """The process-global recorder every instrumented layer notes
    into (capacity via PADDLE_TPU_FLIGHT_CAP, default 256)."""
    global _default
    with _default_lock:
        if _default is None:
            try:
                cap = int(os.environ.get("PADDLE_TPU_FLIGHT_CAP", 256))
            except ValueError:
                cap = 256
            _default = FlightRecorder(capacity=cap)
        return _default


def note(kind, **fields):
    return get_recorder().note(kind, **fields)


def dump(reason, extra=None):
    return get_recorder().dump(reason, extra=extra)
