"""AMP of the port (counterpart of ``paddle_tpu/amp/__init__.py``, ref:
python/paddle/amp/*).

- ``auto_cast`` (``autocast``, ``amp_guard``) records the AMP state that
  ``is_auto_cast_enabled``, ``get_amp_dtype`` and ``get_amp_level`` read.
  As in the reference, no op reads it: mixed precision in training is the
  Engine's ``amp_dtype`` (``Model.prepare(amp_configs=...)``), which casts
  every floating parameter and input inside the step, and O2 is
  ``decorate``.
- ``decorate`` (O2) casts the models to the AMP dtype and sets
  ``_multi_precision`` on the optimizers, so that Adam keeps f32 master
  weights (its ``master`` slot).
- ``GradScaler`` — dynamic loss scaling for float16. The eager API
  (``scale``, ``unscale_``, ``step``, ``update``, ``minimize``,
  ``unscale_guarded_step``) works on the parameters' ``.grad`` and reads
  the finite flag back to the host, as the reference's does. The
  functional core (``functional_init`` / ``functional_update``) keeps the
  scale (f32) and the good and bad counts (int32) as device tensors and
  updates them with ``torch.where`` from a found-inf flag, with no host
  read: the Engine's guarded step (``resilience.TrainGuard(scaler=...)``)
  runs it inside the step, which a CUDA graph records.
"""
from __future__ import annotations

import contextlib
import threading

import torch

from ..framework import convert_dtype

__all__ = ["auto_cast", "autocast", "amp_guard", "GradScaler", "decorate",
           "is_auto_cast_enabled", "get_amp_dtype"]

_state = threading.local()

# ops that are numerically safe in low precision (ref: white/black lists in
# python/paddle/amp/amp_lists.py)
WHITE_LIST = {"matmul", "conv2d", "linear", "einsum", "bmm"}
BLACK_LIST = {"log", "exp", "softmax", "cross_entropy", "mean", "sum",
              "layer_norm", "batch_norm"}


def is_auto_cast_enabled():
    return getattr(_state, "enabled", False)


def get_amp_dtype():
    return getattr(_state, "dtype", "bfloat16")


def get_amp_level():
    return getattr(_state, "level", "O1")


@contextlib.contextmanager
def auto_cast(enable=True, custom_white_list=None, custom_black_list=None,
              level="O1", dtype="bfloat16", use_promote=True):
    prev = (getattr(_state, "enabled", False), getattr(_state, "dtype", None),
            getattr(_state, "level", None))
    _state.enabled = enable
    _state.dtype = dtype
    _state.level = level
    try:
        yield
    finally:
        _state.enabled, _state.dtype, _state.level = prev


autocast = auto_cast
amp_guard = auto_cast


def decorate(models, optimizers=None, level="O2", dtype="bfloat16",
             master_weight=None, save_dtype=None):
    """ref: paddle.amp.decorate — O2 casts the models' parameters (and
    floating buffers) to the AMP dtype; the optimizers get
    ``multi_precision`` master weights."""
    single = not isinstance(models, (list, tuple))
    model_list = [models] if single else list(models)
    if level == "O2":
        for m in model_list:
            m.to(dtype=convert_dtype(dtype))
    if optimizers is not None:
        opt_single = not isinstance(optimizers, (list, tuple))
        opt_list = [optimizers] if opt_single else list(optimizers)
        for o in opt_list:
            o._multi_precision = True
        if opt_single:
            optimizers = opt_list[0]
        ret_models = model_list[0] if single else model_list
        return ret_models, optimizers
    return model_list[0] if single else model_list


def _grads(optimizer):
    return [p for _, p in optimizer._parameter_list or []
            if p.grad is not None]


def _all_finite(tensors):
    """One host read: whether every value of every tensor is finite."""
    if not tensors:
        return True
    return bool(torch.stack([torch.isfinite(t).all() for t in tensors])
                .all())


class GradScaler:
    """ref: paddle.amp.GradScaler — dynamic loss scaling.

    Eager API: scale()/unscale_()/step()/update() or minimize(), over the
    optimizer's parameters' ``.grad``. The functional core
    (``functional_init`` / ``functional_update``) is what the Engine's
    guarded step runs on the device: the loss scaled before autograd, the
    update masked by the finite flag, the scale updated from it."""

    def __init__(self, enable=True, init_loss_scaling=65536.0,
                 incr_ratio=2.0, decr_ratio=0.5, incr_every_n_steps=2000,
                 decr_every_n_nan_or_inf=1, use_dynamic_loss_scaling=True):
        self._enable = enable
        self._scale = float(init_loss_scaling)
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every = incr_every_n_steps
        self._decr_every = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._good = 0
        self._bad = 0
        self._found_inf = False
        self._unscaled = False
        # lifetime counters: steps that saw non-finite grads / were
        # skipped; TrainGuard's log_scalars surfaces them in fit() logs
        self._found_inf_count = 0
        self._skip_count = 0

    @property
    def found_inf_count(self):
        """Steps that observed a non-finite loss/grad (lifetime)."""
        return self._found_inf_count

    @property
    def skip_count(self):
        """Optimizer updates skipped because of non-finite grads."""
        return self._skip_count

    def note_step(self, found_inf):
        """Record one guarded-step outcome (called by TrainGuard; the
        dynamic-scale arithmetic itself runs in the step)."""
        if found_inf:
            self._found_inf_count += 1
            self._skip_count += 1

    def is_enable(self):
        return self._enable

    def is_use_dynamic_loss_scaling(self):
        return self._dynamic

    def get_init_loss_scaling(self):
        return self._scale

    def scale(self, var):
        if not self._enable:
            return var
        return var * self._scale

    def unscale_(self, optimizer):
        """Divide every gradient by the scale (in its dtype) and record
        whether all of them are finite (one host read)."""
        if not self._enable:
            return
        inv = 1.0 / self._scale
        params = _grads(optimizer)
        with torch.no_grad():
            for p in params:
                p.grad = p.grad * inv
        found = not _all_finite([p.grad for p in params])
        self._found_inf = found
        # step() after this must not unscale again: the unscale_, clip,
        # step pattern divides by the scale exactly once
        self._unscaled = True
        if found:
            self._found_inf_count += 1

    def step(self, optimizer):
        if not self._enable:
            optimizer.step()
            return
        if not self._unscaled:
            self.unscale_(optimizer)
        if not self._found_inf:
            optimizer.step()
        else:
            self._skip_count += 1
        self._unscaled = False

    def update(self):
        if not (self._enable and self._dynamic):
            return
        if self._found_inf:
            self._bad += 1
            self._good = 0
            if self._bad >= self._decr_every:
                self._scale = max(self._scale * self._decr_ratio, 1.0)
                self._bad = 0
        else:
            self._good += 1
            self._bad = 0
            if self._good >= self._incr_every:
                self._scale *= self._incr_ratio
                self._good = 0

    def minimize(self, optimizer, scaled_loss):
        scaled_loss.backward()
        inv = 1.0 / self._scale if self._enable else 1.0
        if self._enable:
            with torch.no_grad():
                for p in _grads(optimizer):
                    p.grad = p.grad * inv
        self.unscale_guarded_step(optimizer)
        self.update()
        optimizer.clear_grad()

    def unscale_guarded_step(self, optimizer):
        found = not _all_finite([p.grad for p in _grads(optimizer)])
        self._found_inf = found
        if not found:
            optimizer.step()
        else:
            self._found_inf_count += 1
            self._skip_count += 1

    # -- functional core: the guarded step's, on the device ----------------
    @staticmethod
    def functional_init(init_scale=65536.0, device="cpu"):
        """{"scale": f32, "good": int32, "bad": int32} scalars on
        ``device``."""
        return {"scale": torch.tensor(init_scale, dtype=torch.float32,
                                      device=device),
                "good": torch.zeros((), dtype=torch.int32, device=device),
                "bad": torch.zeros((), dtype=torch.int32, device=device)}

    @staticmethod
    def functional_update(state, found_inf, incr_ratio=2.0, decr_ratio=0.5,
                          incr_every=2000, decr_every=1):
        """The next state from ``found_inf`` (a bool scalar tensor), by
        ``torch.where`` as the reference's ``jnp.where``: no host read."""
        zero = torch.zeros_like(state["good"])
        good = torch.where(found_inf, zero, state["good"] + 1)
        bad = torch.where(found_inf, state["bad"] + 1, zero)
        scale = state["scale"]
        scale = torch.where(bad >= decr_every,
                            torch.clamp_min(scale * decr_ratio, 1.0), scale)
        bad = torch.where(bad >= decr_every, zero, bad)
        scale = torch.where(good >= incr_every, scale * incr_ratio, scale)
        good = torch.where(good >= incr_every, zero, good)
        return {"scale": scale, "good": good, "bad": bad}

    def state_dict(self):
        return {"scale": self._scale, "incr_ratio": self._incr_ratio,
                "decr_ratio": self._decr_ratio, "good": self._good,
                "bad": self._bad,
                "found_inf_count": self._found_inf_count,
                "skip_count": self._skip_count}

    def load_state_dict(self, state):
        self._scale = state["scale"]
        self._good = state.get("good", 0)
        self._bad = state.get("bad", 0)
        self._found_inf_count = state.get("found_inf_count", 0)
        self._skip_count = state.get("skip_count", 0)


from . import debugging  # noqa: F401,E402


def is_bfloat16_supported(device=None):
    """ref: paddle.amp.is_bfloat16_supported — the port's kernels take
    bf16 on the card and their twins on the CPU."""
    return True


def is_float16_supported(device=None):
    """ref: paddle.amp.is_float16_supported — every kernel of the port that
    takes a float16 operand on the card runs in float16 there (the flash
    kernels, the decodes, the fused LayerNorms and #11); the flash
    kernels at head_dim 32 refuse it (ROADMAP.md queue 2)."""
    return True
