"""Engine of the port: the training step of (model, loss, optimizer)
(counterpart of ``paddle_tpu/hapi/engine.py``).

The reference compiles forward, loss, backward, clip and the optimizer
update into one jitted step with donated buffers. Here the step is one
function over tensors on the model's device: the forward through
``torch.func.functional_call`` (with every floating parameter and input
cast to ``amp_dtype`` inside it, as the reference casts its pytree),
``torch.autograd.grad`` onto the f32 parameters, then the clip and the
optimizer's update, which read the step's learning rate and bias
corrections from the optimizer's device array (``Optimizer.fill_scalars``
writes them before each step; the schedule stays on the host).

On CUDA that function is recorded as a CUDA graph over static buffers
(the inputs and labels; the loss, outputs and grad norm it returns): a
step signature's first call runs it eagerly, a real step that also makes
the optimizer's slots and #10's leaf table; its second call records it
(``torch.cuda.graph``, with every generator the model draws from
registered, the optimizer's too, so each replay draws new dropout masks,
flash seeds and rounding noise) and replays it; every later call copies
its batch into the static inputs and replays. A failed capture raises:
there is no quiet way back to eager.
On the CPU, or with ``capture=False``, the same function runs each time
without recording. A loss or module that reads the device from the host
declares it in a ``host_reads`` attribute (``DETRLoss``): its steps run
eagerly (``eager_reason`` says why), and ``capture=True`` with it raises
``ValueError``.

``step`` counts calls and ``opt_step`` counts optimizer updates (Adam's
bias correction reads ``opt_step``), as in the reference. The loss comes
back as a device tensor: no step waits for the device.

``train_batch_multi`` runs K steps over stacked inputs with no host sync
between them; ``train_batch_accum`` / ``flush_accum`` /
``reset_accum_window`` accumulate gradients in f32 over micro-batches as
two recorded functions (the micro-batch's gradient step, and the apply
step that averages, clips and updates, the 1/n folded into the update's
gradient scale); ``enable_grad_norm`` puts the global gradient norm
(``last_grad_norm``) into the step.

``guard`` (a ``resilience.TrainGuard``; ``attach_guard``, or assign
``engine.guard``) makes ``train_batch`` run the guarded step, the
reference's ``_build_guarded_fn`` as one step function that a CUDA graph
records like the plain one: the loss times the fault seam's scalar and
the GradScaler's scale (both device scalars) before autograd; the finite
flag over the loss and every gradient (from the gradients' global norm,
a read of each gradient that the grad-norm telemetry shares: a non-finite
value makes it non-finite); the clip and the update with the scaler's
1/scale folded into the update's gradient scale and masked by the flag
(#10 reads it; buffers such as BatchNorm statistics are selected back
with ``torch.where``); the scaler's state updated from the flag. Around
it, as the reference's ``_train_batch_guarded``: the fault seams
(``nan_grads``, ``slow_step``, ``dispatch_error`` under
``call_with_retries``), the step's scalars for ``opt_step + 1``, and one
host read of the flag after the step, which commits ``opt_step`` only on
a good step and hands the outcome to the guard (snapshot, skip,
rollback). Gradient accumulation and ``train_batch_multi`` refuse a
guard (``ValueError``), as the reference's do.

Not ported (raises NotImplementedError, see ROADMAP.md): ``mesh``.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.func import functional_call

from ..amp import GradScaler
from ..framework import bind_generator, convert_dtype, generators, later
from ..nn.clip import global_norm
from ..resilience import faults
from ..resilience.retry import call_with_retries, retryable_for

__all__ = ["Engine"]


def _detach(x):
    if isinstance(x, torch.Tensor):
        return x.detach()
    if isinstance(x, (list, tuple)):
        return type(x)(_detach(t) for t in x)
    if isinstance(x, dict):
        return {k: _detach(v) for k, v in x.items()}
    return x


def _host_reads(*parts):
    """The first ``host_reads`` declaration among ``parts`` (losses,
    modules and their submodules), or None: why a step that runs them
    cannot be recorded as a CUDA graph."""
    for part in parts:
        if part is None:
            continue
        mods = part.modules() if isinstance(part, torch.nn.Module) \
            else [part]
        for m in mods:
            why = getattr(m, "host_reads", None)
            if why:
                return why
    return None


def _signature(xs):
    return tuple((tuple(x.shape), x.dtype) if torch.is_tensor(x)
                 else ("value", repr(x)) for x in xs)


class _Recorded:
    """One step function ``fn(engine, *static)`` over static buffers, as a
    CUDA graph: run eagerly at its first call, recorded at its second
    (then replayed), replayed from then on. ``static`` holds its argument
    lists; what the recording returned is rewritten in place by every
    replay. It keeps no reference to its Engine, so an Engine and its
    graphs (and their memory pools) go as soon as the Engine does."""

    def __init__(self, fn, static):
        self.fn, self.static = fn, static
        self.runs = 0
        self.graph = None
        self.out = None

    def load(self, args):
        """Copy a new batch into the static buffers."""
        for dst, src in zip(self.static, args):
            for d, s in zip(dst, src):
                if torch.is_tensor(d) and d is not s:
                    d.copy_(s)

    def __call__(self, engine):
        self.runs += 1
        if self.runs == 1:
            return self.fn(engine, *self.static)
        if self.graph is None:
            self.graph, self.out = engine._record(
                lambda: self.fn(engine, *self.static))
        self.graph.replay()
        return self.out


class Engine:
    """``Engine(network, loss, optimizer, metrics, amp_dtype, mesh,
    donate_params, guard, *, generator=None, capture=None)``, the
    reference's parameters in its order (``metrics`` kept as the
    reference keeps it, ``donate_params`` taken and ignored: the step
    updates the parameters in place). Runs
    where the network's parameters live and creates nothing elsewhere;
    inputs that are numpy arrays or tensors on another device are moved
    there. ``generator`` (a torch.Generator on that device), when given,
    becomes the one every dropout of the network draws from
    (``framework.bind_generator``). ``capture``: None records each step as
    a CUDA graph on CUDA unless the loss or a module declares
    ``host_reads``; True records it and raises ``ValueError`` on such a
    declaration; False runs every step eagerly. A network output that is
    a dict marked ``_loss_only_aux`` (``chunked_ce``) goes to the loss
    only: the step returns no outputs for it, as the reference's."""

    def __init__(self, network, loss=None, optimizer=None, metrics=None,
                 amp_dtype=None, mesh=None, donate_params=True, guard=None,
                 *, generator=None, capture=None):
        if mesh is not None:
            raise NotImplementedError(f"Engine(mesh=...) {later('10')}")
        self.network = network
        self.loss = loss
        self.optimizer = optimizer
        self.metrics = metrics or []
        self.amp_dtype = convert_dtype(amp_dtype)
        self.device = next(network.parameters()).device
        if generator is not None:
            bind_generator(network, generator)
        why = _host_reads(loss, network)
        if capture and why:
            raise ValueError(f"Engine(capture=True): the training step "
                             f"cannot be recorded as a CUDA graph: {why}")
        # None, or why steps on CUDA run eagerly
        self.eager_reason = "capture=False" if capture is False else why
        self._graphs = (self.device.type == "cuda" and capture is not False
                        and why is None)
        self._recorded = {}
        self._state_seen = None
        self._step = 0
        self._opt_step = 0
        self.collect_grad_norm = False
        self.last_grad_norm = None
        # gradient accumulation: f32 sums, kept across windows (the
        # recorded steps read them at fixed addresses), and 1/n on the
        # device for the apply step
        self._acc = None
        self._inv_n = None
        self._micro_count = 0
        # the guarded step's device state: the fault seam's loss factor,
        # the found-inf flag and the GradScaler's {scale, good, bad}
        self._guard = guard
        self._fault = None
        self._found = None
        self._scaler_state = None

    @property
    def guard(self):
        return self._guard

    @guard.setter
    def guard(self, g):
        # the scaler state belongs to the outgoing guard's scaler: a new
        # guard's scaler starts from its own init scale, and the guarded
        # recordings that read the old state go with it
        self._guard = g
        self._scaler_state = None
        self._recorded = {k: r for k, r in self._recorded.items()
                          if k[0][0] != "guarded"}

    def attach_guard(self, guard):
        """Attach (or with None, detach) a resilience.TrainGuard: the next
        train_batch runs the matching step."""
        self.guard = guard
        return guard

    @property
    def captures(self):
        """Whether training steps are recorded as CUDA graphs."""
        return self._graphs

    def enable_grad_norm(self):
        """Put the global gradient L2 norm (f32, over every trainable
        leaf, before the clip) into the training step: ``last_grad_norm``
        after each ``train_batch``, a device scalar (None after
        accumulation and multi steps, as in the reference)."""
        self.collect_grad_norm = True

    def _to_device(self, x):
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(x)
        if isinstance(x, torch.Tensor) and x.device != self.device:
            x = x.to(self.device)
        return x

    def _cast(self, x):
        amp = self.amp_dtype
        if amp is not None and torch.is_tensor(x) and x.is_floating_point():
            return x.to(amp)
        return x

    def _live(self):
        live = [(n, p) for n, p in self.network.named_parameters()
                if p.requires_grad]
        return [n for n, _ in live], [p for _, p in live]

    def _train_mode(self):
        if self.optimizer is None:
            raise ValueError("Engine: training needs an optimizer")
        if not self.network.training:
            self.network.train()

    # -- the step functions (what a CUDA graph records) ---------------------
    def _loss_grads(self, names, params, ins, labs, fault=None,
                    factor=None):
        """Forward, loss and gradients -> (loss, outs, grads): loss an f32
        scalar, outs detached, a zero gradient for an unused leaf.
        ``fault``: None or a device scalar the loss is multiplied by (the
        fault seam's, 1 or NaN); ``factor``: None or one that only the
        differentiated loss is multiplied by (the GradScaler's scale)."""
        # the cast happens inside the differentiated function: grads land
        # on the f32 parameters, and a tied weight is cast once, so its
        # grad sums every use of the one low-precision copy
        outs = functional_call(
            self.network, {n: self._cast(p) for n, p in zip(names, params)},
            tuple(self._cast(x) for x in ins))
        outs_t = outs if isinstance(outs, (list, tuple)) else [outs]
        loss = (self.loss(*outs_t, *labs) if self.loss is not None
                else outs_t[0]).float()
        if isinstance(outs, dict) and outs.get("_loss_only_aux"):
            # the reference's convention: such a dict (a fused head's
            # hidden states and tied weight) feeds only the loss, and is
            # neither returned nor seen by metrics
            outs = ()
        if fault is not None:
            loss = loss * fault
        target = loss if factor is None else loss * factor
        grads = torch.autograd.grad(target, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(params, grads)]
        return loss.detach(), _detach(outs), grads

    def _train_step(self, ins, labs, collect):
        names, params = self._live()
        loss, outs, grads = self._loss_grads(names, params, ins, labs)
        norm = global_norm(grads) if collect else None
        self.optimizer._clip_update(names, params, grads, norm=norm)
        return loss, outs, norm

    def _guarded_step(self, ins, labs, collect):
        """The guarded step (the reference's ``_build_guarded_fn``): the
        loss scaled by the GradScaler's scale, the finite flag into
        ``_found``, the update masked by it, the scaler's state updated
        from it. Buffers the forward writes (BatchNorm statistics) are
        selected back on a bad step. -> (loss, outs, norm)."""
        names, params = self._live()
        bufs = [b for _, b in self.network.named_buffers()]
        saved = [b.clone() for b in bufs]
        st = self._scaler_state
        loss, outs, grads = self._loss_grads(
            names, params, ins, labs, fault=self._fault,
            factor=None if st is None else st["scale"])
        inv = None if st is None else 1.0 / st["scale"]
        # the scaled gradients' global norm: non-finite where any value
        # is (an f32 overflow of the sum of squares would need values
        # near 1e19), and, times 1/scale, the unscaled norm the clip and
        # the telemetry read
        total = global_norm(grads)
        bad = ~(torch.isfinite(loss) & torch.isfinite(total))
        self._found.copy_(bad)
        norm = total if inv is None else total * inv
        self.optimizer._clip_update(names, params, grads, scale=inv,
                                    norm=norm, skip=self._found)
        with torch.no_grad():
            for b, old in zip(bufs, saved):
                b.copy_(torch.where(self._found, old, b))
        if st is not None:
            sc = self._guard.scaler
            new = GradScaler.functional_update(
                st, self._found, incr_ratio=sc._incr_ratio,
                decr_ratio=sc._decr_ratio, incr_every=sc._incr_every,
                decr_every=sc._decr_every)
            for k, t in st.items():
                t.copy_(new[k])
        return loss, outs, norm if collect else None

    def _grad_step(self, ins, labs):
        names, params = self._live()
        loss, outs, grads = self._loss_grads(names, params, ins, labs)
        torch._foreach_add_(self._acc, [g.float() for g in grads])
        return loss, outs

    def _apply_step(self):
        names, params = self._live()
        self.optimizer._clip_update(names, params, self._acc,
                                    scale=self._inv_n)
        torch._foreach_zero_(self._acc)

    # -- running them -------------------------------------------------------
    def generators(self):
        """Every torch.Generator a training step draws from: the network's
        and the loss's (dropout, flash seeds) and the optimizer's (bf16
        moments' rounding noise, made at its first update)."""
        gens = generators(self.network, *(
            [self.loss] if isinstance(self.loss, torch.nn.Module) else []))
        opt_gen = getattr(self.optimizer, "generator", None)
        if opt_gen is not None and all(g is not opt_gen for g in gens):
            gens.append(opt_gen)
        return gens

    def _record(self, fn):
        """(graph, what fn returned) with fn recorded into a new CUDA
        graph, every generator the model draws from registered."""
        # the graph's nodes stay readable (raw_cuda_graph) beside its
        # executable: what chip_smoke.py counts the step's kernels from
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        gens = [g for g in self.generators() if g.device.type == "cuda"]
        if gens and not hasattr(graph, "register_generator_state"):
            raise RuntimeError(
                f"Engine: torch {torch.__version__} cannot register a "
                "torch.Generator with a CUDA graph, and the model draws "
                "from one; capture=False runs its steps eagerly")
        for g in gens:
            graph.register_generator_state(g)
        with torch.cuda.graph(graph):
            out = fn()
        graph.instantiate()
        return graph, out

    def _run(self, kind, fn, *args):
        """fn(self, *args) eagerly, or through the step's recording (one
        per kind and argument signature) on CUDA."""
        if not self._graphs:
            return fn(self, *args)
        if self.optimizer._state is not self._state_seen:
            # the optimizer's slots were replaced (a loaded checkpoint):
            # recordings that read the old ones are stale
            self._recorded.clear()
            self._state_seen = self.optimizer._state
        key = (kind,) + tuple(_signature(a) for a in args)
        rec = self._recorded.get(key)
        if rec is None:
            static = [[x.clone() if torch.is_tensor(x) else x for x in a]
                      for a in args]
            rec = self._recorded[key] = _Recorded(fn, static)
        else:
            rec.load(args)
        return rec(self)

    def _fill(self, lr=None, opt_step=None):
        self.optimizer.fill_scalars(
            self.optimizer.get_lr() if lr is None else lr,
            self._opt_step if opt_step is None else opt_step, self.device)

    def _guard_tensors(self):
        """{key: live tensor} of the state a TrainGuard snapshot holds and
        a rollback copies back in place: every parameter and buffer of the
        network, every optimizer slot, the GradScaler's device state."""
        out = {f"param:{n}": p for n, p in self.network.named_parameters()}
        out.update((f"buffer:{n}", b)
                   for n, b in self.network.named_buffers())
        for n in sorted(self.optimizer._state):
            for s, t in sorted(self.optimizer._state[n].items()):
                out[f"slot:{n}:{s}"] = t
        for k, t in (self._scaler_state or {}).items():
            out[f"scaler:{k}"] = t
        return out

    def _guard_state(self):
        """Make the guarded step's device state, once: the fault factor,
        the found-inf flag, the scaler's state, and every optimizer slot
        (so that the first snapshot holds them)."""
        if self._fault is None:
            self._fault = torch.ones((), dtype=torch.float32,
                                     device=self.device)
            self._found = torch.zeros((), dtype=torch.bool,
                                      device=self.device)
        scaler = self._guard.scaler
        if scaler is not None and self._scaler_state is None:
            self._scaler_state = GradScaler.functional_init(scaler._scale,
                                                            self.device)
        self.optimizer.init_state(*self._live())

    def train_batch(self, inputs, labels):
        """One optimizer step -> (loss, outs): loss an f32 scalar tensor on
        the device, outs the network's outputs (detached). From a
        recorded step (on CUDA, from a signature's second call) both are
        the graph's own tensors: valid until the next step, which
        rewrites them."""
        if self._guard is not None:
            return self._train_batch_guarded(inputs, labels)
        self._train_mode()
        if self._micro_count:
            # a pending accumulation window must not leak into a fused step
            self.flush_accum()
        ins = [self._to_device(x) for x in inputs]
        labs = [self._to_device(x) for x in labels]
        self._step += 1
        self._opt_step += 1
        self._fill()
        collect = self.collect_grad_norm
        loss, outs, norm = self._run(
            ("train", collect),
            lambda eng, i, l: eng._train_step(i, l, collect), ins, labs)
        self.last_grad_norm = norm
        return loss, outs

    def _train_batch_guarded(self, inputs, labels):
        """train_batch through the TrainGuard (the reference's
        ``_train_batch_guarded``): the fault seams, the guarded step with
        injected transient errors retried before it runs, one host read
        of the finite flag, then the guard's bookkeeping. Returns (loss,
        outs) as train_batch; on a skipped step the loss is the
        (non-finite) observed value and the model is unchanged."""
        guard = self._guard
        self._train_mode()
        if self._micro_count:
            self.flush_accum()
        ins = [self._to_device(x) for x in inputs]
        labs = [self._to_device(x) for x in labels]
        self._guard_state()
        guard.before_first_step(self)
        self._step += 1
        step = self._step
        fault = faults.nan_scale(step)
        faults.maybe_sleep("slow_step", step)
        collect = self.collect_grad_norm

        def dispatch():
            # an injected transient fires before the step runs: the
            # update is in place, so only such an error is retried
            faults.maybe_raise("dispatch_error", step)
            self._fill(opt_step=self._opt_step + 1)
            self._fault.fill_(fault)
            return self._run(
                ("guarded", collect),
                lambda eng, i, l: eng._guarded_step(i, l, collect),
                ins, labs)

        loss, outs, norm = call_with_retries(
            dispatch, retries=guard.retries, retryable=retryable_for(True),
            base_delay=guard.retry_base_delay, stats=guard.retry_stats)
        self.last_grad_norm = norm
        # the one host read the guard adds: the step's finite flag; the
        # opt_step + 1 the step used is committed only on a good step
        ok = not bool(self._found)
        if ok:
            self._opt_step += 1
        guard.after_step(self, ok)
        return loss, outs

    def train_batch_multi(self, inputs, labels, lr_values=None):
        """K optimizer steps over stacked inputs and labels ([K, batch,
        ...] each), the same as K ``train_batch`` calls (the same
        counters, generator draws and updates), with no host sync between
        them: each step copies its slice into the static inputs and
        replays. The learning rate is the optimizer's, constant over the
        K steps, unless ``lr_values`` ([K]) gives one a step; the caller
        steps its LR scheduler as usual. A pending accumulation window is
        applied first. Returns (losses [K] on the device, None)."""
        if self._guard is not None:
            raise ValueError(
                "TrainGuard and train_batch_multi are mutually exclusive: "
                "the guarded step reads its finite flag back after every "
                "step. Use train_batch, or detach the guard "
                "(engine.guard = None).")
        self._train_mode()
        ins = [self._to_device(x) for x in inputs]
        labs = [self._to_device(x) for x in labels]
        lead = {x.shape[0] for x in ins + labs
                if torch.is_tensor(x) and x.dim() >= 1}
        if len(lead) != 1:
            # before any counter moves: a failed call must not skew the
            # generator draws or Adam's bias correction
            raise ValueError(
                f"stacked inputs/labels disagree on K: {sorted(lead)}")
        k = lead.pop()
        if lr_values is None:
            lrs = [self.optimizer.get_lr()] * k
        else:
            lrs = np.asarray(lr_values, np.float32)
            if lrs.shape != (k,):
                raise ValueError(f"lr_values must have shape ({k},)")
            lrs = [float(x) for x in lrs]
        if self._micro_count:
            self.flush_accum()
        collect = self.collect_grad_norm
        losses = torch.empty(k, dtype=torch.float32, device=self.device)
        for i in range(k):
            self._step += 1
            self._opt_step += 1
            self._fill(lrs[i])
            loss, _, _ = self._run(
                ("train", collect),
                lambda eng, a, b: eng._train_step(a, b, collect),
                [x[i] if torch.is_tensor(x) else x for x in ins],
                [y[i] if torch.is_tensor(y) else y for y in labs])
            losses[i].copy_(loss)
        self.last_grad_norm = None
        return losses, None

    def train_batch_accum(self, inputs, labels, apply_update):
        """One micro-batch of gradient accumulation: its f32 gradients
        are added to the window's sums; with ``apply_update`` the window
        is applied (averaged, clipped, one optimizer update). Returns
        (loss, outs, applied), graph-owned as ``train_batch``'s."""
        if self._guard is not None:
            raise ValueError(
                "TrainGuard covers the fused train_batch path only: a "
                "half-guarded accumulation window would mask the update "
                "but not the accumulated sums. Detach (engine.guard = "
                "None) or use accumulate_grad_batches=1.")
        self._train_mode()
        ins = [self._to_device(x) for x in inputs]
        labs = [self._to_device(x) for x in labels]
        if self._acc is None:
            _, params = self._live()
            self._acc = [torch.zeros_like(p, dtype=torch.float32)
                         for p in params]
            self._inv_n = torch.ones((), dtype=torch.float32,
                                     device=self.device)
        self._step += 1
        loss, outs = self._run("grad", Engine._grad_step, ins, labs)
        # this path computes no global grad norm
        self.last_grad_norm = None
        self._micro_count += 1
        applied = self._apply_accum() if apply_update else False
        return loss, outs, applied

    def _apply_accum(self):
        if not self._micro_count or self._acc is None:
            return False
        self._opt_step += 1
        self._fill()
        self._inv_n.fill_(1.0 / self._micro_count)
        self._run("apply", Engine._apply_step)
        self._micro_count = 0
        return True

    def flush_accum(self):
        """Apply a partly accumulated window (epoch end, early stop,
        ``num_iters``) so its gradients are neither dropped nor leaked
        into the next fit. Returns True if an update ran. The zeroed sums
        are kept: the recorded steps read them in place."""
        return self._apply_accum()

    def reset_accum_window(self):
        """Drop a half-accumulated window without applying it (after a
        checkpoint restore: gradients of the old parameters must not
        reach the first update after it)."""
        if self._acc is not None:
            torch._foreach_zero_(self._acc)
        self._micro_count = 0

    @torch.no_grad()
    def eval_batch(self, inputs, labels=()):
        """-> (loss or None, outs), in eval mode and without AMP, as the
        reference's eval step."""
        net = self.network
        if net.training:
            net.eval()
        outs = net(*[self._to_device(x) for x in inputs])
        loss = None
        if self.loss is not None and labels:
            outs_t = outs if isinstance(outs, (list, tuple)) else [outs]
            loss = self.loss(*outs_t, *[self._to_device(x)
                                        for x in labels]).float()
        return loss, outs

    def predict_batch(self, inputs):
        return self.eval_batch(inputs, ())[1]
