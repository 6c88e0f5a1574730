"""Preemption-safe shutdown: SIGTERM/SIGINT -> a flag (counterpart of
``paddle_tpu/resilience/preemption.py``).

Pod preemption delivers SIGTERM with a grace window. The handler only sets
a flag; ``Model.fit`` polls ``requested()`` at every batch boundary, where
training state is consistent, and stops cleanly. The flag functions are a
copy of the reference's. The full-training-state checkpoint that turns
the flag into an exact resume (``save_training_state``,
``restore_training_state``, the ``PreemptionCheckpoint`` callback) rides
the reference's CheckpointManager and comes with ROADMAP.md queue 1 item
8.
"""
from __future__ import annotations

import signal
import threading

from ..framework import later

__all__ = ["install", "installed", "requested", "request", "clear",
           "save_training_state", "restore_training_state"]

_flag = threading.Event()
_installed_for: dict[int, object] = {}   # signum -> previous handler


def install(signals=(signal.SIGTERM, signal.SIGINT), chain=True):
    """Install flag-setting handlers (idempotent). chain=True also
    invokes the previously-installed USER handler — a supervisor's own
    SIGTERM bookkeeping keeps working underneath ours. Python's
    default SIGINT handler is NOT chained: it raises
    KeyboardInterrupt mid-step, which is exactly the unclean unwind
    this module exists to replace with a boundary checkpoint."""
    for signum in signals:
        if signum in _installed_for:
            continue
        prev = signal.getsignal(signum)
        _installed_for[signum] = prev
        chain_prev = (chain and callable(prev)
                      and prev is not signal.default_int_handler)

        def _handler(num, frame, _prev=prev, _chain=chain_prev):
            _flag.set()
            if _chain:
                _prev(num, frame)

        signal.signal(signum, _handler)


def uninstall():
    """Restore the pre-install handlers (test hygiene)."""
    for signum, prev in list(_installed_for.items()):
        try:
            signal.signal(signum, prev)
        except (ValueError, TypeError):
            pass
        del _installed_for[signum]


def installed():
    return bool(_installed_for)


def requested():
    """True once a preemption signal arrived (sticky until clear())."""
    return _flag.is_set()


def request():
    """Programmatic preemption (tests, external orchestrators)."""
    _flag.set()


def clear():
    _flag.clear()


# -- full-training-state payloads (exact resume) --------------------------

def save_training_state(model, manager, metric=None):
    """ref: the checkpoint through a CheckpointManager (io/checkpoint.py)."""
    raise NotImplementedError(f"save_training_state {later('8')}")


def restore_training_state(model, manager, step=None):
    """ref: the inverse of save_training_state."""
    raise NotImplementedError(f"restore_training_state {later('8')}")
