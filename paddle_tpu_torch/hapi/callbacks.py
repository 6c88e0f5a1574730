"""hapi callbacks of the port (counterpart of
``paddle_tpu/hapi/callbacks.py``, ref: python/paddle/hapi/callbacks.py).

A copy of the reference: ``Callback``, ``CallbackList``, ``ProgBarLogger``,
``ModelCheckpoint``, ``LRScheduler``, ``EarlyStopping``,
``ReduceLROnPlateau`` and ``config_callbacks``. The callbacks that write
telemetry or a full training state (``VisualDL``, ``WandbCallback``,
``PreemptionCheckpoint`` and the ``TelemetryCallback`` re-export) come
with ROADMAP.md queue 1 item 8 and raise on construction.
"""
from __future__ import annotations

import numbers
import os
import time

from ..framework import later

__all__ = ["WandbCallback", "Callback", "CallbackList", "ProgBarLogger", "ModelCheckpoint",
           "LRScheduler", "EarlyStopping", "VisualDL", "ReduceLROnPlateau",
           "PreemptionCheckpoint", "TelemetryCallback", "config_callbacks"]


class Callback:
    def __init__(self):
        self.model = None
        self.params = {}

    def set_params(self, params):
        self.params = params or {}

    def set_model(self, model):
        self.model = model

    def on_train_begin(self, logs=None):
        pass

    def on_train_end(self, logs=None):
        pass

    def on_eval_begin(self, logs=None):
        pass

    def on_eval_end(self, logs=None):
        pass

    def on_predict_begin(self, logs=None):
        pass

    def on_predict_end(self, logs=None):
        pass

    def on_epoch_begin(self, epoch, logs=None):
        pass

    def on_epoch_end(self, epoch, logs=None):
        pass

    def on_train_batch_begin(self, step, logs=None):
        pass

    def on_train_batch_end(self, step, logs=None):
        pass

    def on_eval_batch_begin(self, step, logs=None):
        pass

    def on_eval_batch_end(self, step, logs=None):
        pass


class CallbackList:
    def __init__(self, callbacks=None):
        self.callbacks = list(callbacks or [])

    def append(self, cb):
        self.callbacks.append(cb)

    def set_params(self, params):
        for c in self.callbacks:
            c.set_params(params)

    def set_model(self, model):
        for c in self.callbacks:
            c.set_model(model)

    def on_begin(self, mode, logs=None):
        for c in self.callbacks:
            getattr(c, f"on_{mode}_begin")(logs)

    def on_end(self, mode, logs=None):
        for c in self.callbacks:
            getattr(c, f"on_{mode}_end")(logs)

    def on_epoch_begin(self, epoch, logs=None):
        for c in self.callbacks:
            c.on_epoch_begin(epoch, logs)

    def on_epoch_end(self, epoch, logs=None):
        for c in self.callbacks:
            c.on_epoch_end(epoch, logs)

    def on_batch_begin(self, mode, step, logs=None):
        for c in self.callbacks:
            getattr(c, f"on_{mode}_batch_begin")(step, logs)

    def on_batch_end(self, mode, step, logs=None):
        for c in self.callbacks:
            getattr(c, f"on_{mode}_batch_end")(step, logs)

    def on_eval_end(self, logs=None):
        for c in self.callbacks:
            c.on_eval_end(logs)


class ProgBarLogger(Callback):
    def __init__(self, log_freq=1, verbose=2):
        super().__init__()
        self.log_freq = log_freq
        self.verbose = verbose

    def on_train_begin(self, logs=None):
        self.epochs = self.params.get("epochs")
        self.steps = self.params.get("steps")

    def on_epoch_begin(self, epoch, logs=None):
        self.epoch = epoch
        self._start = time.time()

    def _fmt(self, logs):
        parts = []
        for k, v in (logs or {}).items():
            if k == "batch_size":
                continue
            if isinstance(v, list):
                v = v[0] if v else None
            if isinstance(v, numbers.Number):
                parts.append(f"{k}: {v:.4f}")
        return " - ".join(parts)

    def on_train_batch_end(self, step, logs=None):
        if self.verbose and step % self.log_freq == 0:
            print(f"Epoch {self.epoch + 1}/{self.epochs} step {step} "
                  f"- {self._fmt(logs)}")

    def on_epoch_end(self, epoch, logs=None):
        if self.verbose:
            dur = time.time() - self._start
            print(f"Epoch {epoch + 1}/{self.epochs} done ({dur:.1f}s) "
                  f"- {self._fmt(logs)}")


class ModelCheckpoint(Callback):
    def __init__(self, save_freq=1, save_dir=None):
        super().__init__()
        self.save_freq = save_freq
        self.save_dir = save_dir

    def on_epoch_end(self, epoch, logs=None):
        if self.save_dir and epoch % self.save_freq == 0:
            path = os.path.join(self.save_dir, str(epoch))
            os.makedirs(self.save_dir, exist_ok=True)
            self.model.save(path)

    def on_train_end(self, logs=None):
        if self.save_dir:
            self.model.save(os.path.join(self.save_dir, "final"))


class LRScheduler(Callback):
    """Steps the optimizer's LRScheduler (by_step or by_epoch)."""

    def __init__(self, by_step=True, by_epoch=False):
        super().__init__()
        assert by_step ^ by_epoch
        self.by_step = by_step

    def on_epoch_end(self, epoch, logs=None):
        from ..optimizer.lr import LRScheduler as Sched
        if not self.by_step and isinstance(self.model._optimizer._lr, Sched):
            self.model._optimizer._lr.step()
    # by_step handled inside Model.train_batch


class EarlyStopping(Callback):
    def __init__(self, monitor="loss", mode="auto", patience=0, verbose=1,
                 min_delta=0, baseline=None, save_best_model=True):
        super().__init__()
        self.monitor = monitor
        self.patience = patience
        self.min_delta = abs(min_delta)
        self.baseline = baseline
        self.save_best_model = save_best_model
        if mode == "auto":
            mode = "min" if "loss" in monitor or "err" in monitor else "max"
        self.mode = mode
        self.wait = 0
        self.best = None

    def _better(self, cur):
        if self.best is None:
            return True
        if self.mode == "min":
            return cur < self.best - self.min_delta
        return cur > self.best + self.min_delta

    def on_eval_end(self, logs=None):
        logs = logs or {}
        v = logs.get(self.monitor)
        if v is None:
            return
        if isinstance(v, list):
            v = v[0]
        if self._better(v):
            self.best = v
            self.wait = 0
        else:
            self.wait += 1
            if self.wait >= self.patience:
                self.model.stop_training = True


class ReduceLROnPlateau(Callback):
    def __init__(self, monitor="loss", factor=0.1, patience=10, verbose=1,
                 mode="auto", min_delta=1e-4, cooldown=0, min_lr=0):
        super().__init__()
        self.monitor = monitor
        self.factor = factor
        self.patience = patience
        if mode == "auto":
            mode = "min" if "loss" in monitor or "err" in monitor else "max"
        self.mode = mode
        self.min_delta = min_delta
        self.cooldown = cooldown
        self.min_lr = min_lr
        self.wait = 0
        self.best = None
        self.cool = 0

    def on_eval_end(self, logs=None):
        logs = logs or {}
        v = logs.get(self.monitor)
        if v is None:
            return
        if isinstance(v, list):
            v = v[0]
        if self.cool > 0:
            self.cool -= 1
            return
        better = (self.best is None or
                  (self.mode == "min" and v < self.best - self.min_delta) or
                  (self.mode == "max" and v > self.best + self.min_delta))
        if better:
            self.best = v
            self.wait = 0
        else:
            self.wait += 1
            if self.wait > self.patience:
                opt = self.model._optimizer
                from ..optimizer.lr import LRScheduler as Sched
                if not isinstance(opt._lr, Sched):
                    opt._lr = max(float(opt._lr) * self.factor, self.min_lr)
                self.cool = self.cooldown
                self.wait = 0


def config_callbacks(callbacks=None, model=None, epochs=None, steps=None,
                     log_freq=2, verbose=2, save_freq=1, save_dir=None,
                     metrics=None, mode="train"):
    cbks = list(callbacks or [])
    if not any(isinstance(c, ProgBarLogger) for c in cbks) and verbose:
        cbks.append(ProgBarLogger(log_freq, verbose=verbose))
    if not any(isinstance(c, LRScheduler) for c in cbks):
        cbks.append(LRScheduler())
    if not any(isinstance(c, ModelCheckpoint) for c in cbks) and save_dir:
        cbks.append(ModelCheckpoint(save_freq, save_dir))
    lst = CallbackList(cbks)
    lst.set_model(model)
    lst.set_params({"epochs": epochs, "steps": steps, "verbose": verbose,
                    "metrics": metrics or []})
    return lst


class _Later(Callback):
    """A callback of the reference that writes telemetry or a training
    state; constructing one raises naming its ROADMAP.md item."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(f"{type(self).__name__} {later('8')}")


class VisualDL(_Later):
    """ref: the JSONL scalar logger (VisualDL parity)."""


class WandbCallback(_Later):
    """ref: paddle.callbacks.WandbCallback."""


class PreemptionCheckpoint(_Later):
    """ref: the preemption-safe checkpoint through a CheckpointManager."""


class TelemetryCallback(_Later):
    """ref: observability.telemetry.TelemetryCallback."""
