"""paddle.Model of the port (counterpart of ``paddle_tpu/hapi/model.py``,
ref: python/paddle/hapi/model.py).

``Model(network).prepare(optimizer, loss, metrics, amp_configs)`` then
``fit`` / ``evaluate`` / ``predict`` over datasets or loaders, as in the
reference, around the port's ``Engine``, which trains the module's own
parameters (so the reference's weight sync-back is a no-op here). The
network's device decides where everything runs: on CUDA, a loader that
``fit``/``evaluate``/``predict`` build collates straight into pinned host
memory and its batches reach the card through ``io.device_prefetch``
(batch N+1's copy runs under step N); on the CPU nothing is copied.
``train_batch`` and ``eval_batch`` return Python floats, as the
reference's do, so a step reads its loss back once (and each metric its
``[B, k]`` hits). On CUDA the Engine records each training step as a CUDA
graph (``prepare(capture=...)`` chooses, see ``hapi.Engine``); its loss
and outputs are the graph's own until the next step, so a step's metrics
and loss are read before the next step runs. ``fit(accumulate_grad_batches
=k)`` applies the accumulated window on every k-th batch and flushes a
tail window at epoch end, early stop or ``num_iters``; the LR scheduler
steps only on real updates, as in the reference.

``save`` writes the reference's files: ``path.pdparams`` (the state dict)
and ``path.pdopt`` with ``engine_step``, ``opt_step``, ``LR_Scheduler``
and ``leaves``, the optimizer state in the reference's order (the JAX
package flattens ``{slot: {name: array}}`` with sorted keys: every slot in
name order, the slots in name order). Both packages read each other's
files for Momentum, Adam and AdamW.

``prepare(guard=TrainGuard(...))`` runs every training step through the
Engine's guarded step: the LR scheduler steps only after a good step
(and the guard re-captures a snapshot's schedule position then),
``fit``'s batch logs carry ``guard.log_scalars()`` (skipped, rollbacks,
found_inf), and ``load`` empties the guard's ring, whose snapshots are no
longer the last good state. ``fit`` consults the ``sigterm`` fault seam at
each batch boundary, as the reference does.

Not ported (each raises NotImplementedError naming its ROADMAP.md item):
``save(training=False)`` (``jit.save``, 8) and ``serve_metrics`` (8). An
exception in ``fit`` propagates without the reference's flight-recorder
dump (8).
"""
from __future__ import annotations

import inspect
import os
import warnings

import numpy as np
import torch

from ..framework import later
from ..io import DataLoader, Dataset, device_prefetch
from ..metric import Metric
from ..optimizer.lr import LRScheduler, ReduceOnPlateau
from ..resilience import faults, preemption
from ..serialization import load as _load
from ..serialization import save as _save
from ..serialization import set_state_dict
from .callbacks import config_callbacks
from .engine import Engine

__all__ = ["Model"]


def _to_list(x):
    if x is None:
        return []
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _to_numpy(x):
    if torch.is_tensor(x):
        x = x.detach()
        return (x.float() if x.dtype == torch.bfloat16 else x).cpu().numpy()
    if isinstance(x, (list, tuple)):
        return type(x)(_to_numpy(t) for t in x)
    if isinstance(x, dict):
        return {k: _to_numpy(v) for k, v in x.items()}
    return x


class Model:
    """ref: paddle.Model(network, inputs=None, labels=None)."""

    def __init__(self, network, inputs=None, labels=None):
        self.network = network
        self._inputs_spec = inputs
        self._labels_spec = labels
        self._optimizer = None
        self._loss = None
        self._metrics = []
        self._engine = None
        self.stop_training = False
        self._amp_dtype = None
        # the last loader of each role ("train", "eval", "predict"), where
        # the reference tags its loaders for the metrics registry: their
        # batch_wait_s and batches readings stay readable after a call
        self._loaders = {}

    # ------------------------------------------------------------------
    def prepare(self, optimizer=None, loss=None, metrics=None,
                amp_configs=None, guard=None, capture=None):
        """ref: Model.prepare; ``guard``: a resilience.TrainGuard, which
        makes every training step the guarded one; ``capture`` (a port
        extension) is the Engine's: None records each training step as a
        CUDA graph on CUDA where the loss allows, True insists, False runs
        eagerly."""
        self._optimizer = optimizer
        self._loss = loss
        ms = _to_list(metrics)
        for m in ms:
            assert isinstance(m, Metric), \
                "metrics must be paddle_tpu_torch.metric.Metric"
        self._metrics = ms
        if amp_configs:
            if isinstance(amp_configs, str):
                level = amp_configs
                self._amp_dtype = "bfloat16" if level in ("O1", "O2") \
                    else None
            elif isinstance(amp_configs, dict):
                level = amp_configs.get("level", "O1")
                dtype = amp_configs.get("dtype", "bfloat16")
                self._amp_dtype = dtype if level != "O0" else None
        self._engine = Engine(self.network, loss=self._loss,
                              optimizer=self._optimizer,
                              amp_dtype=self._amp_dtype, guard=guard,
                              capture=capture)

    def _ensure_engine(self):
        if self._engine is None:
            self._engine = Engine(self.network, loss=self._loss,
                                  optimizer=self._optimizer)
        return self._engine

    # ------------------------------------------------------------------
    def train_batch(self, inputs, labels=None, update=True):
        eng = self._ensure_engine()
        loss_v, outs = eng.train_batch(_to_list(inputs), _to_list(labels))
        metrics_out = self._update_metrics(outs, labels)
        # a guard-skipped step applied no update: the schedule position
        # tracks opt_step
        if eng.guard is None or eng.guard.last_outcome == "ok":
            self._lr_step_after_update()
            if eng.guard is not None:
                eng.guard.note_lr_stepped(eng)
        loss = float(loss_v)
        return ([loss], metrics_out) if metrics_out else [loss]

    def _train_batch_accum(self, inputs, labels, apply):
        """A gradient-accumulation micro-batch (fit's
        ``accumulate_grad_batches`` path): the LR scheduler steps only on
        a real optimizer update."""
        eng = self._ensure_engine()
        loss_v, outs, applied = eng.train_batch_accum(
            _to_list(inputs), _to_list(labels), apply_update=apply)
        if applied:
            self._lr_step_after_update()
        metrics_out = self._update_metrics(outs, labels)
        loss = float(loss_v)
        return ([loss], metrics_out) if metrics_out else [loss]

    def _lr_step_after_update(self):
        lr = self._optimizer._lr
        if isinstance(lr, LRScheduler) and \
                not isinstance(lr, ReduceOnPlateau):
            lr.step()

    def eval_batch(self, inputs, labels=None):
        eng = self._ensure_engine()
        loss_v, outs = eng.eval_batch(_to_list(inputs), _to_list(labels))
        metrics_out = self._update_metrics(outs, labels)
        loss = float(loss_v) if loss_v is not None else None
        return ([loss], metrics_out) if metrics_out else [loss]

    def predict_batch(self, inputs):
        eng = self._ensure_engine()
        return _to_numpy(eng.predict_batch(_to_list(inputs)))

    def _update_metrics(self, outs, labels):
        if not self._metrics:
            return None
        outs_l = outs if isinstance(outs, (list, tuple)) else [outs]
        labels_l = _to_list(labels)
        res = []
        for m in self._metrics:
            stats = m.compute(outs_l[0], *labels_l)
            res.append(m.update(*_to_list(stats)))
        return res

    def _loader(self, data, role, **kw):
        """A DataLoader over a Dataset (collating into pinned memory for a
        network on CUDA), or the caller's own iterable as it is."""
        if isinstance(data, Dataset):
            data = DataLoader(
                data, pin_memory=self._ensure_engine().device.type == "cuda",
                **kw)
        self._loaders[role] = data
        return data

    def _feed(self, loader):
        """The batches of ``loader`` on the network's device."""
        return device_prefetch(loader, self._ensure_engine().device)

    # ------------------------------------------------------------------
    def fit(self, train_data=None, eval_data=None, batch_size=1, epochs=1,
            eval_freq=1, log_freq=10, save_dir=None, save_freq=1, verbose=2,
            drop_last=False, shuffle=True, num_workers=0, callbacks=None,
            accumulate_grad_batches=1, num_iters=None):
        assert train_data is not None
        eng = self._ensure_engine()
        train_loader = self._loader(train_data, "train",
                                    batch_size=batch_size,
                                    shuffle=shuffle, drop_last=drop_last,
                                    num_workers=num_workers)
        eval_loader = None
        if eval_data is not None:
            eval_loader = self._loader(eval_data, "eval",
                                       batch_size=batch_size,
                                       num_workers=num_workers)
        steps = None
        try:
            steps = len(train_loader)
        except TypeError:
            pass
        cbks = config_callbacks(callbacks, model=self, epochs=epochs,
                                steps=steps, log_freq=log_freq,
                                save_freq=save_freq, save_dir=save_dir,
                                verbose=verbose,
                                metrics=self._metrics_name())
        cbks.on_begin("train")
        logs = {}
        for epoch in range(epochs):
            cbks.on_epoch_begin(epoch)
            for m in self._metrics:
                m.reset()
            logs = {}
            for step, batch in enumerate(self._feed(train_loader)):
                if num_iters is not None and step >= num_iters:
                    break
                cbks.on_batch_begin("train", step, logs)
                ins, labs = self._split_batch(batch)
                if accumulate_grad_batches > 1:
                    out = self._train_batch_accum(
                        ins, labs,
                        apply=(step + 1) % accumulate_grad_batches == 0)
                else:
                    out = self.train_batch(ins, labs)
                logs = self._make_logs(out)
                if eng.guard is not None:
                    logs.update(eng.guard.log_scalars())
                logs["batch_size"] = len(ins[0]) if torch.is_tensor(ins[0]) \
                    else batch_size
                # the preemption seam at the step boundary, before the
                # callbacks, as the reference's
                faults.maybe_sigterm(eng._step)
                cbks.on_batch_end("train", step, logs)
                if preemption.requested():
                    self.stop_training = True
                if self.stop_training:
                    break
            if accumulate_grad_batches > 1 and eng.flush_accum():
                # the tail micro-batches (epoch end, early stop,
                # num_iters): applied, neither dropped nor leaked into the
                # next epoch
                self._lr_step_after_update()
            cbks.on_epoch_end(epoch, logs)
            if preemption.requested():
                break
            if eval_loader is not None and (epoch % eval_freq == 0
                                            or epoch == epochs - 1):
                eval_logs = self.evaluate(eval_loader, verbose=0)
                logs.update({f"eval_{k}": v for k, v in eval_logs.items()})
                cbks.on_eval_end(eval_logs)
            if self.stop_training:
                break
        cbks.on_end("train", logs)
        if preemption.requested():
            # serviced: left set, the process-global flag would stop any
            # later fit in this process after one batch
            preemption.clear()
        return self

    def serve_metrics(self, port=0, host="127.0.0.1"):
        raise NotImplementedError(f"Model.serve_metrics {later('8')}")

    def evaluate(self, eval_data, batch_size=1, log_freq=10, verbose=2,
                 num_workers=0, callbacks=None, num_samples=None):
        loader = self._loader(eval_data, "eval", batch_size=batch_size,
                              num_workers=num_workers)
        for m in self._metrics:
            m.reset()
        losses = []
        for batch in self._feed(loader):
            ins, labs = self._split_batch(batch)
            out = self.eval_batch(ins, labs)
            loss = out[0] if isinstance(out, tuple) else out
            if loss and loss[0] is not None:
                losses.append(loss[0])
        logs = {}
        if losses:
            logs["loss"] = [float(np.mean(losses))]
        for m in self._metrics:
            res = m.accumulate()
            names = m.name() if isinstance(m.name(), list) else [m.name()]
            vals = res if isinstance(res, list) else [res]
            for n, v in zip(names, vals):
                logs[n] = v
        return logs

    def predict(self, test_data, batch_size=1, num_workers=0,
                stack_outputs=False, verbose=1, callbacks=None):
        loader = self._loader(test_data, "predict", batch_size=batch_size,
                              num_workers=num_workers)
        outputs = []
        for batch in self._feed(loader):
            ins, _ = self._split_batch(batch, predict=True)
            outputs.append(self.predict_batch(ins))
        if not outputs:
            return []
        first = outputs[0]
        n_out = len(first) if isinstance(first, (list, tuple)) else 1
        if n_out == 1:
            flat = [o if not isinstance(o, (list, tuple)) else o[0]
                    for o in outputs]
            return [np.concatenate(flat, 0)] if stack_outputs else [flat]
        cols = list(zip(*outputs))
        if stack_outputs:
            return [np.concatenate(c, 0) for c in cols]
        return [list(c) for c in cols]

    def _split_batch(self, batch, predict=False):
        """(inputs, labels) of a batch: as many inputs as there are input
        specs, else all but the last field. ``predict`` takes the inputs
        only: the first field, as the reference does, or with several
        input specs that many fields (the reference passes a three-input
        model its first field alone; ERNIE's predict then ran without its
        token types and attention mask). The inputs are bound to the
        network by ``_arranged``."""
        if isinstance(batch, (list, tuple)):
            batch = list(batch)
            n_specs = len(self._inputs_spec) if self._inputs_spec else 0
            if predict:
                if n_specs > 1:
                    return self._arranged(batch[:n_specs]), []
                return _to_list(batch[0]), []
            n_in = n_specs or max(len(batch) - 1, 1)
            return self._arranged(batch[:n_in]), batch[n_in:]
        return [batch], []

    def _arranged(self, ins):
        """The inputs in the order of the network's ``forward``: where
        every input spec is named after one of its positional parameters,
        each input goes to its parameter and the parameters between them
        keep their defaults, so [input_ids, token_type_ids,
        attention_mask] reach ERNIE's forward(input_ids, token_type_ids,
        position_ids, attention_mask) as named. Else the inputs bind in
        order, as the reference binds them all (it would hand ERNIE the
        mask as position_ids)."""
        names = [getattr(spec, "name", None)
                 for spec in self._inputs_spec or ()]
        if len(names) != len(ins) or not all(names):
            return ins
        try:
            sig = inspect.signature(self.network.forward)
            bound = sig.bind(**dict(zip(names, ins)))
        except (TypeError, ValueError):
            return ins
        bound.apply_defaults()
        args = list(bound.args)
        n = 1 + max(list(sig.parameters).index(name) for name in names)
        return args[:n] if len(args) >= n else ins

    def _make_logs(self, out):
        logs = {}
        if isinstance(out, tuple):
            losses, metrics = out
            logs["loss"] = losses
            names = self._metrics_name()[1:]
            for n, v in zip(names, metrics):
                logs[n] = v[0] if isinstance(v, list) and len(v) == 1 else v
        else:
            logs["loss"] = out
        return logs

    def _metrics_name(self):
        names = ["loss"]
        for m in self._metrics:
            n = m.name()
            names.extend(n if isinstance(n, list) else [n])
        return names

    # ------------------------------------------------------------------
    def parameters(self, *args, **kwargs):
        return self.network.parameters(*args, **kwargs)

    def state_dict(self, *args, **kwargs):
        return self.network.state_dict(*args, **kwargs)

    def _trainable_names(self):
        return sorted(n for n, p in self.network.named_parameters()
                      if p.requires_grad)

    def save(self, path, training=True):
        """``path.pdparams`` (weights) and ``path.pdopt`` (optimizer), as
        the reference writes them."""
        if not training:
            raise NotImplementedError(f"Model.save(training=False) "
                                      f"(jit.save) {later('8')}")
        _save(self.network.state_dict(), path + ".pdparams")
        if self._optimizer is not None and self._engine is not None:
            opt = {"engine_step": self._engine._step,
                   "opt_step": self._engine._opt_step}
            state = self._optimizer._state
            names = self._trainable_names()
            if names and all(n in state for n in names):
                opt["leaves"] = [state[n][s] for s in
                                 sorted(self._optimizer._slot_names())
                                 for n in names]
            if isinstance(self._optimizer._lr, LRScheduler):
                opt["LR_Scheduler"] = self._optimizer._lr.state_dict()
            _save(opt, path + ".pdopt")

    def _set_opt_leaves(self, leaves):
        """The reference's ``leaves`` order mapped onto the optimizer's
        per-name state: every slot (sorted) over every trainable parameter
        (sorted)."""
        params = dict(self.network.named_parameters())
        names = self._trainable_names()
        slots = sorted(self._optimizer._slot_names())
        if len(leaves) != len(slots) * len(names):
            raise ValueError(
                f"the checkpoint's optimizer state has {len(leaves)} leaves; "
                f"{type(self._optimizer).__name__} over {len(names)} "
                f"trainable parameters keeps {len(slots) * len(names)} "
                f"(slots {slots})")
        state = {n: {} for n in names}
        it = iter(leaves)
        for s in slots:
            for n in names:
                t = torch.as_tensor(next(it))
                p = params[n]
                if tuple(t.shape) != tuple(p.shape):
                    raise ValueError(f"optimizer slot {s} of {n}: shape "
                                     f"{tuple(t.shape)} vs {tuple(p.shape)}")
                state[n][s] = t.to(device=p.device,
                                   dtype=self._optimizer._slot_dtype(
                                       s, p)).clone()
        self._optimizer._state = state

    def load(self, path, skip_mismatch=False, reset_optimizer=False):
        state = _load(path + ".pdparams") if not path.endswith(".pdparams") \
            else _load(path)
        missing, unexpected = set_state_dict(self.network, state)
        if (missing or unexpected) and not skip_mismatch:
            if missing:
                warnings.warn(f"missing keys: {missing}")
            if unexpected:
                warnings.warn(f"unexpected keys: {unexpected}")
        eng = self._ensure_engine()
        opt_path = path + ".pdopt"
        if not reset_optimizer and os.path.exists(opt_path) and \
                self._optimizer is not None:
            blob = _load(opt_path)
            eng._step = blob.get("engine_step", 0)
            eng._opt_step = blob.get("opt_step", eng._step)
            if eng.guard is not None:
                # snapshots taken before the restore are no longer the
                # last good state: the ring reseeds at the next step
                eng.guard.ring.clear()
            if "leaves" in blob:
                self._set_opt_leaves(blob["leaves"])
            if "LR_Scheduler" in blob and isinstance(self._optimizer._lr,
                                                     LRScheduler):
                self._optimizer._lr.set_state_dict(blob["LR_Scheduler"])
        return self

    def summary(self, input_size=None, dtype=None):
        from .summary import summary as _summary
        if input_size is None and self._inputs_spec:
            input_size = [tuple(s.shape) for s in self._inputs_spec]
        return _summary(self.network, input_size, dtypes=dtype)
