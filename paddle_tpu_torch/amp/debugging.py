"""Numeric debugging of the port (counterpart of
``paddle_tpu/amp/debugging.py``, ref: python/paddle/amp/debugging.py).

``check_numerics`` checks a tensor, or a nest of dicts, lists and tuples
of them, for NaN and Inf at tensor granularity (the reference's choice,
kept): it counts on the device and reads two integers back a tensor, then
raises ``FloatingPointError`` (abort mode) or warns, naming each offending
path. ``GradNormSpikeDetector`` flags a step whose global gradient norm
exceeds ``factor`` times the trailing window's median.
``collect_operator_stats`` returns an empty context, as the reference's.
"""
from __future__ import annotations

import contextlib
import warnings
from dataclasses import dataclass

import numpy as np
import torch

__all__ = ["check_numerics", "TensorCheckerConfig", "enable_tensor_checker",
           "disable_tensor_checker", "GradNormSpikeDetector",
           "DebugMode", "collect_operator_stats"]


class DebugMode:
    CHECK_NAN_INF_AND_ABORT = "abort"
    CHECK_NAN_INF = "warn"
    CHECK_ALL = "all"


@dataclass
class TensorCheckerConfig:
    enable: bool = True
    debug_mode: str = DebugMode.CHECK_NAN_INF_AND_ABORT
    checked_op_list: tuple = ()
    skipped_op_list: tuple = ()


_checker: TensorCheckerConfig | None = None


def enable_tensor_checker(config: TensorCheckerConfig):
    global _checker
    _checker = config


def disable_tensor_checker():
    global _checker
    _checker = None


def tensor_checker_enabled():
    return _checker is not None and _checker.enable


def _leaves(tree, path=""):
    """(path, leaf) pairs of a nest of dicts, lists and tuples, the paths
    written as the reference's ``jax.tree_util.keystr``."""
    if isinstance(tree, dict):
        for k in sorted(tree, key=str):
            yield from _leaves(tree[k], f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, x in enumerate(tree):
            yield from _leaves(x, f"{path}[{i}]")
    else:
        yield path, tree


def check_numerics(tensor, op_type="", var_name="", debug_mode=None,
                   stack_height_limit=None):
    """ref: paddle.amp.debugging.check_numerics — raise (abort mode) or
    warn on NaN/Inf anywhere in the nest. Returns ``tensor``."""
    mode = debug_mode or (
        _checker.debug_mode if _checker else DebugMode.CHECK_NAN_INF_AND_ABORT)
    bad = []
    for path, x in _leaves(tensor):
        if isinstance(x, (bool, str, bytes)) or x is None:
            continue
        if torch.is_tensor(x):
            if not x.is_floating_point():
                continue
            # counted on the device; one two-value read to the host
            n_nan, n_inf = torch.stack([torch.isnan(x).sum(),
                                        torch.isinf(x).sum()]).tolist()
            shape = tuple(x.shape)
        else:
            try:
                arr = np.asarray(x)
            except Exception:  # noqa: BLE001 — not an array: nothing to check
                continue
            if not np.issubdtype(arr.dtype, np.floating):
                continue
            n_nan = int(np.isnan(arr).sum())
            n_inf = int(np.isinf(arr).sum())
            shape = arr.shape
        if n_nan or n_inf:
            bad.append(f"{var_name or path}: {n_nan} NaN, {n_inf} Inf "
                       f"(shape {shape}, op {op_type or '?'})")
    if bad:
        msg = "check_numerics found non-finite values:\n  " + "\n  ".join(bad)
        if mode == DebugMode.CHECK_NAN_INF_AND_ABORT:
            raise FloatingPointError(msg)
        warnings.warn(msg)
    return tensor


class GradNormSpikeDetector:
    """Failure-detection hook: flags a step whose global grad norm exceeds
    `factor` x the trailing-window median."""

    def __init__(self, window=32, factor=10.0):
        self.window = window
        self.factor = factor
        self._history = []

    def global_norm(self, grads):
        """The global L2 norm (f32) over a nest of gradients, as a host
        float (one read)."""
        leaves = [g for _, g in _leaves(grads) if torch.is_tensor(g)]
        if not leaves:
            return 0.0
        sq = sum(torch.sum(torch.square(g.float())) for g in leaves)
        return float(np.sqrt(float(sq)))

    def check(self, grads) -> bool:
        """Returns True (spike!) when the current norm is anomalous; always
        records the observation."""
        norm = self.global_norm(grads)
        spike = False
        warmup = max(2, min(8, self.window))
        if len(self._history) >= warmup:
            med = float(np.median(self._history))
            spike = med > 0 and norm > self.factor * med
        self._history.append(norm)
        self._history = self._history[-self.window:]
        return spike


class _OpStats:
    def __init__(self):
        self.records = []

    def summary(self):
        return list(self.records)


def collect_operator_stats(*a, **kw):
    """ref: paddle.amp.debugging.collect_operator_stats — per-op dtype
    stats; an empty context, as in the reference."""
    @contextlib.contextmanager
    def cm():
        yield _OpStats()
    return cm()
