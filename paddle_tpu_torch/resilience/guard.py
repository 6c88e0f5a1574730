"""TrainGuard of the port — NaN/inf skip, snapshot ring, rollback
(counterpart of ``paddle_tpu/resilience/guard.py``).

A NaN storm (a bad batch, a float16 overflow, a flipped bit) must cost
skipped steps, not a dead run or a poisoned model. The work splits as in
the reference:

in the step (``hapi.Engine``'s guarded step, one function that a CUDA
graph records on the card):
  - the finite flag over the loss and every gradient;
  - the parameter, optimizer-slot and buffer updates masked by it (#10
    reads the flag and writes nothing on a bad step; the plain paths
    select with ``torch.where``), so a bad step leaves the model as it
    was, bit for bit;
  - with a GradScaler attached, its dynamic scale on the device: the loss
    scaled before autograd, 1/scale folded into the update's gradient
    scale, the scale updated from the flag.

on the host (this object):
  - skip counters and the consecutive-bad count, from the flag the Engine
    reads back once a step;
  - a last-good snapshot ring (parameters, buffers, every optimizer slot,
    the scaler's device state, ``opt_step`` and the LR scheduler's
    position) refreshed every ``snapshot_every`` good steps. Host copies
    in pinned memory (on CUDA), copied without blocking and synchronised
    once; when the ring is full, the evicted entry's buffers are reused;
  - a rollback to the newest entry after ``rollback_after`` consecutive
    bad steps, which copies the snapshot back INTO the live tensors: a
    recorded CUDA graph reads the parameters, the slots, #10's leaf table
    and the scaler's state at fixed addresses, so rebinding any of them
    would leave the graph updating the old tensors;
  - a bounded retry around the dispatch for injected transient errors
    (``retry.py``).

Attach with ``Model.prepare(..., guard=TrainGuard(...))`` or
``engine.attach_guard(TrainGuard(...))``. It covers ``train_batch``;
gradient accumulation and ``train_batch_multi`` refuse a guard.
"""
from __future__ import annotations

import collections
import copy

import torch

from .retry import RetryStats

__all__ = ["TrainGuard"]


def _to_host(tensors, reuse=None):
    """{key: host copy} of {key: tensor}: pinned memory for CUDA tensors,
    copied without blocking and synchronised once at the end. ``reuse``:
    an evicted snapshot's copies, written over where key, shape and dtype
    match."""
    out, on_cuda = {}, False
    for key, t in tensors.items():
        dst = None if reuse is None else reuse.get(key)
        if dst is None or dst.shape != t.shape or dst.dtype != t.dtype:
            dst = torch.empty(t.shape, dtype=t.dtype,
                              pin_memory=t.device.type == "cuda")
        with torch.no_grad():
            dst.copy_(t, non_blocking=True)
        on_cuda |= t.device.type == "cuda"
        out[key] = dst
    if on_cuda:
        torch.cuda.synchronize()
    return out


def _to_live(host, tensors):
    """Copy each snapshot tensor into the live tensor of its key, in
    place."""
    missing = sorted(set(tensors) - set(host))
    if missing:
        raise RuntimeError(f"TrainGuard.rollback: the snapshot lacks "
                           f"{missing[:4]}")
    with torch.no_grad():
        for key, t in tensors.items():
            t.copy_(host[key], non_blocking=True)


class TrainGuard:
    """Host-side half of the guarded train step.

    snapshot_every: good steps between snapshot-ring refreshes. COST: each
        snapshot copies parameters, buffers and optimizer state to host
        memory (~3x the parameter bytes under Adam), and the ring holds
        ring_size such copies.
    ring_size: retained snapshots (newest wins on rollback).
    rollback_after: consecutive bad steps that trigger a rollback.
    scaler: optional amp.GradScaler — its dynamic loss scale runs in the
        step and its found-inf/skip counters track the guard.
    retries / retry_base_delay: transient-dispatch retry budget.
    """

    def __init__(self, snapshot_every=10, ring_size=2, rollback_after=3,
                 scaler=None, retries=2, retry_base_delay=0.05):
        if snapshot_every < 1:
            raise ValueError("snapshot_every must be >= 1")
        if rollback_after < 1:
            raise ValueError("rollback_after must be >= 1")
        self.snapshot_every = int(snapshot_every)
        self.rollback_after = int(rollback_after)
        self.scaler = scaler
        self.retries = int(retries)
        self.retry_base_delay = float(retry_base_delay)
        self.ring = collections.deque(maxlen=int(ring_size))
        self.retry_stats = RetryStats()
        # counters (log_scalars surfaces these in fit() logs)
        self.good_steps = 0
        self.skipped_steps = 0
        self.consecutive_bad = 0
        self.rollbacks = 0
        self.last_outcome = "ok"   # ok | skipped | rolled_back
        self._since_snapshot = 0
        self._lr_refresh_pending = False

    # -- snapshots ---------------------------------------------------------
    @staticmethod
    def _lr_sched(engine):
        from ..optimizer.lr import LRScheduler
        lr = getattr(engine.optimizer, "_lr", None)
        return lr if isinstance(lr, LRScheduler) else None

    def snapshot(self, engine):
        """Capture the last-good training state (host copies), the LR
        scheduler's position included: a rollback that rewinds opt_step
        but left the schedule ahead would replay the window under the
        wrong learning rates."""
        sched = self._lr_sched(engine)
        full = self.ring.maxlen is not None and len(self.ring) == \
            self.ring.maxlen
        reuse = self.ring[0]["tensors"] if full and self.ring else None
        self.ring.append({
            "tensors": _to_host(engine._guard_tensors(), reuse),
            "opt_step": engine._opt_step,
            "lr_sched": None if sched is None
            else copy.deepcopy(sched.state_dict()),
        })
        self._since_snapshot = 0
        # hapi steps the scheduler after the engine call this snapshot
        # ran in; note_lr_stepped refreshes the captured position
        self._lr_refresh_pending = True

    def note_lr_stepped(self, engine):
        """Call right after advancing the LR scheduler for an applied
        update (hapi does): re-captures the newest snapshot's scheduler
        position if that snapshot was taken this step."""
        if self._lr_refresh_pending and self.ring:
            sched = self._lr_sched(engine)
            if sched is not None:
                self.ring[-1]["lr_sched"] = copy.deepcopy(sched.state_dict())
        self._lr_refresh_pending = False

    def rollback(self, engine):
        """Restore the newest snapshot into the engine, in place (the same
        tensors, so a recorded step keeps its addresses; no step is
        recorded again). Returns True if a snapshot existed."""
        if not self.ring:
            return False
        snap = self.ring[-1]
        _to_live(snap["tensors"], engine._guard_tensors())
        engine._opt_step = snap["opt_step"]
        sched = self._lr_sched(engine)
        if sched is not None and snap.get("lr_sched") is not None:
            sched.set_state_dict(copy.deepcopy(snap["lr_sched"]))
        engine.reset_accum_window()
        self.rollbacks += 1
        self.consecutive_bad = 0
        return True

    # -- per-step bookkeeping ---------------------------------------------
    def before_first_step(self, engine):
        """Seed the ring so a storm in the first window can roll back to
        the initial state."""
        if not self.ring:
            self.snapshot(engine)

    def after_step(self, engine, ok):
        """Called by the engine with the step's finite flag, read back
        once. Returns 'ok' | 'skipped' | 'rolled_back' (also kept on
        .last_outcome: hapi steps the LR scheduler only on 'ok', so its
        position tracks applied updates as opt_step does)."""
        if self.scaler is not None:
            self.scaler.note_step(found_inf=not ok)
        # only a snapshot taken THIS step may have its LR position
        # refreshed by a following note_lr_stepped
        self._lr_refresh_pending = False
        if ok:
            self.good_steps += 1
            self.consecutive_bad = 0
            self._since_snapshot += 1
            if self._since_snapshot >= self.snapshot_every:
                self.snapshot(engine)
            self.last_outcome = "ok"
            rolled = False
        else:
            self.skipped_steps += 1
            self.consecutive_bad += 1
            rolled = self.consecutive_bad >= self.rollback_after \
                and self.rollback(engine)
            self.last_outcome = "rolled_back" if rolled else "skipped"
        # every guarded step leaves a flight-recorder record, before the
        # dump, so that a rollback's dump holds the storm's own steps
        self._flight_note(engine, ok)
        if rolled:
            self._flight_dump(engine)
        return self.last_outcome

    def _flight_note(self, engine, ok):
        try:
            from ..observability import flightrec
            flightrec.note("guard_step", step=engine._step, ok=bool(ok),
                           outcome=self.last_outcome,
                           consecutive_bad=self.consecutive_bad,
                           skipped_steps=self.skipped_steps)
        except Exception:  # noqa: BLE001 — accounting never kills a step
            pass

    def _flight_dump(self, engine):
        """A rollback dumps the flight recorder (flight_rollback.json).
        Never raises: recovery must not die to disk."""
        try:
            from ..observability import flightrec
            flightrec.note("guard_rollback", step=engine._step,
                           **self.stats())
            flightrec.dump("rollback",
                           extra={"guard": self.stats(),
                                  "step": engine._step})
        except Exception:  # noqa: BLE001
            pass

    # -- reporting ---------------------------------------------------------
    def log_scalars(self):
        """Flat numeric dict for hapi fit() logs."""
        out = {"skipped": self.skipped_steps,
               "rollbacks": self.rollbacks}
        if self.retry_stats.retries:
            out["retries"] = self.retry_stats.retries
        if self.scaler is not None:
            out["found_inf"] = self.scaler.found_inf_count
        return out

    def stats(self):
        return {"good_steps": self.good_steps,
                "skipped_steps": self.skipped_steps,
                "consecutive_bad": self.consecutive_bad,
                "rollbacks": self.rollbacks,
                "snapshots": len(self.ring),
                **self.retry_stats.as_dict()}
