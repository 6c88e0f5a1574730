"""Optimizers of the port: ``Optimizer``, ``Momentum``, ``Adam`` and
``AdamW`` (counterpart of ``paddle_tpu/optimizer/optimizer.py``, ref:
python/paddle/optimizer/optimizer.py, momentum.py, adam.py, adamw.py).

One update core serves both ways of training, as in the reference:
``step()`` reads ``param.grad`` (eager ``loss.backward(); opt.step()``),
and ``hapi.Engine``'s step hands its grads to ``_clip_update``. Updates are
in place under ``torch.no_grad()``; state is kept per parameter name.

The step's scalars (lr, and Adam's bias corrections 1 - beta ** step) live
in a small f32 array on the parameters' device that the optimizer keeps:
``fill_scalars`` writes the host's values into it with
``fill_`` (no sync, no copy from pageable memory) and the update reads
them there, as the TPU kernel reads its SMEM operand. A step that a CUDA
graph recorded thus takes each replay's learning rate and bias
corrections; the schedule stays on the host.

``parameters`` is an iterable of tensors (named ``param_<i>``) or of
``(name, tensor)`` pairs such as ``model.named_parameters()``; the names
are what ``apply_decay_param_fun`` sees, as the reference's structured
parameter names.

``Adam(fused_kernel=True)`` / ``AdamW(fused_kernel=True)``: every leaf
with f32 p, m and v goes through the one-pass update kernel, all of them in
one launch (``ops.kernels.fused_adamw.fused_adamw_multi_update``; one
launch a ``MAX_LEAVES`` leaves), at any size. The reference sends only
leaves of at least 16384 elements to its kernel (``fused_adamw_supported``:
on the TPU a leaf is a launch, and a small leaf's launch costs more than
it saves); on the card one launch takes the whole set, so the small leaves
cost nothing more there, while each of them on the plain path costs some
20 launches. The same formula either way. With ``ClipGradByGlobalNorm``
the kernel multiplies each gradient by the clip's coefficient (a device
scalar) instead of the clip writing a scaled copy of every gradient.
Leaves of another dtype, every leaf under ``amsgrad``, with bf16 moments
or with master weights, and every leaf of ``fused_kernel=False`` take the
plain path leaf by leaf, as the reference's jnp path (its kernel takes f32
moments only); the CPU runs the plain twin.

``moment_dtype="bfloat16"`` keeps Adam's m and v in bf16 with the
reference's unbiased stochastic rounding: the update's math is f32, and
each store adds 16 bits of uniform noise below bf16's mantissa cut, then
truncates (``sround_bf16``; non-finite values bypass the noise; AMSGrad's
``vhat`` stays f32). The noise comes from the optimizer's ``generator``
(made at the first update on the parameters' device, seeded 0xAD04,
unless the caller set one), one draw a step for each moment over every
leaf
(``rounding_noise``); the reference's keys are JAX PRNG, which the port
cannot reproduce, so the tests feed it the reference's own bits.
``multi_precision=True`` keeps an f32 master copy of every parameter
(slot ``master``): the update reads and writes the master and rounds the
result to the parameter's dtype, and m and v are f32 unless
``moment_dtype`` says bf16. Not ported (NotImplementedError, see
ROADMAP.md): parameter groups.

The guarded step (``resilience.TrainGuard``) hands ``_clip_update`` a
``skip`` flag, a bool scalar on the device that is true when the step's
loss or a gradient was not finite: the update then leaves every parameter
and slot as it was, bit for bit, with no host read. #10 reads the flag
and its blocks write nothing; every plain path (Momentum, bf16 moments,
master weights, AMSGrad, leaves the kernel does not take) selects old
against new with ``torch.where``, as the reference's ``jnp.where``. The
GradScaler's 1/scale rides in ``scale``, as 1/n of an accumulated window
does, so no unscaled copy of a gradient is written.
"""
from __future__ import annotations

import torch

from ..framework import later
from ..nn.clip import ClipGradBase, global_norm
from ..ops.kernels.fused_adamw import (adamw_update_plain,
                                       fused_adamw_multi_update)
from .lr import LRScheduler

__all__ = ["Optimizer", "Momentum", "Adam", "AdamW", "sround_bf16"]

# the reference's key for the rounding noise (PRNGKey(0xAD04)), here the
# seed of the optimizer's generator
NOISE_SEED = 0xAD04


def sround_bf16(x32, noise):
    """Unbiased stochastic rounding f32 -> bf16 (the reference's
    ``_sround_bf16``): ``noise`` (integers whose low 16 bits are uniform,
    x32's shape) is added to x32's bit pattern below the bf16 mantissa
    cut, then the low 16 bits are dropped, so E[result] == x32. Non-finite
    values bypass the noise (inf plus noise would truncate to NaN)."""
    x32 = x32.float()
    bits = x32.view(torch.int32) + (noise.to(torch.int32) & 0xFFFF)
    # a finite pattern plus < 2^16 stays in int32, and its arithmetic shift
    # by 16 fits int16: the high half of the unsigned sum, as a bf16
    rounded = (bits >> 16).to(torch.int16).view(torch.bfloat16)
    return torch.where(torch.isfinite(x32), rounded,
                       x32.to(torch.bfloat16))


def _scaled(g, scale):
    """g times the clip's coefficient ``scale`` (None: g), in g's dtype."""
    return g if scale is None else (g * scale).to(g.dtype)


def _keep_if(skip, old, new):
    """``new``, or ``old`` where the bool device flag ``skip`` is set (None:
    ``new``): the masked update's select, which the caller copies into
    ``old``."""
    return new if skip is None else torch.where(skip, old, new)


class Optimizer:
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 name=None, apply_decay_param_fun=None):
        self._lr = learning_rate
        # Adam keeps f32 master weights with it; Momentum takes it and
        # keeps none, as the reference's
        self._multi_precision = bool(multi_precision)
        self._parameter_list = self._normalize_params(parameters)
        self._weight_decay = float(weight_decay or 0.0)
        self._grad_clip = grad_clip
        self._apply_decay_param_fun = apply_decay_param_fun
        self._step_count = 0
        self._state = {}  # parameter name -> {slot: tensor}
        self._scalars = None  # the step's scalars on the device

    @staticmethod
    def _normalize_params(parameters):
        """[(name, tensor)] from tensors or (name, tensor) pairs."""
        if parameters is None:
            return None
        named = []
        for i, p in enumerate(parameters):
            if isinstance(p, dict):
                raise NotImplementedError(f"parameter groups {later('1.8')}")
            named.append(p if isinstance(p, tuple) else (f"param_{i}", p))
        return named

    # -- lr ----------------------------------------------------------------
    def get_lr(self) -> float:
        if isinstance(self._lr, LRScheduler):
            return float(self._lr())
        return float(self._lr)

    # -- the step's scalars on the device -----------------------------------
    def _scalar_values(self, lr, step):
        """This step's scalars as host floats: [lr] (Adam adds its bias
        corrections)."""
        return (float(lr),)

    def fill_scalars(self, lr, step, device):
        """Write the scalars of optimizer step ``step`` (1-based) at
        learning rate ``lr`` into the f32 array on ``device`` that the
        update reads, one ``fill_`` each, and return the array. The array
        is made once and kept, so a recorded step reads it at one
        address."""
        values = self._scalar_values(lr, step)
        t = self._scalars
        if t is None or t.device != torch.device(device):
            t = self._scalars = torch.zeros(len(values), dtype=torch.float32,
                                            device=device)
        for i, x in enumerate(values):
            t[i].fill_(x)
        return t

    # -- the update core (override per optimizer) ---------------------------
    def _slot_names(self):
        """The names of the state slots kept per parameter (the keys of
        ``_state[name]``, and of the reference's optimizer state)."""
        return ()

    def _slot_dtype(self, slot, p):
        """The dtype slot ``slot`` of parameter ``p`` is kept in."""
        return torch.float32

    def init_state(self, names, params):
        """Make every slot of these parameters that is not there yet (the
        update makes them at its first call otherwise): a snapshot taken
        before the first step then holds them too. An optimizer without
        slots has none to make."""

    def update(self, names, params, grads, scalars, scale=None, skip=None):
        """Update ``params`` in place from ``grads``, reading the step's
        scalars from the device array ``scalars`` (``fill_scalars``);
        ``scale`` (None or an f32 scalar tensor: the clip's coefficient,
        times 1/n over an accumulated window, times the GradScaler's
        1/scale) multiplies every gradient first, as
        ``ClipGradBase.apply`` does; ``skip`` (None or a bool scalar
        tensor) leaves every parameter and slot as it was where set."""
        raise NotImplementedError

    def _clip_update(self, names, params, grads, scale=None, norm=None,
                     skip=None):
        """Clip (if set) and update from the scalars already filled in:
        the part of a step that a CUDA graph can record. ``scale``: None
        or a device scalar every gradient is multiplied by before the clip
        sees it (1/n of an accumulated window, a GradScaler's 1/scale);
        ``norm``: the global norm of the gradients the clip sees, when the
        caller has it (the grad-norm telemetry); ``skip``: None or the
        guarded step's bool flag, which masks the update. The clip gives
        its coefficient, and the update scales the gradients by it."""
        grads = list(grads)
        if isinstance(self._grad_clip, ClipGradBase) and grads:
            if norm is None and scale is not None:
                norm = global_norm(grads) * scale
            coef = self._grad_clip.coefficient(grads, norm=norm)
            scale = coef if scale is None else coef * scale
        with torch.no_grad():
            self.update(list(names), list(params), grads,
                        self._scalars, scale, skip)

    def _apply(self, names, params, grads, lr, step):
        """Fill the scalars of step ``step`` at ``lr``, then clip and
        update: the eager step."""
        params = list(params)
        if params:
            self.fill_scalars(lr, step, params[0].device)
            self._clip_update(names, params, grads)

    def _decays(self, name):
        fn = self._apply_decay_param_fun
        return bool(self._weight_decay) and (fn is None or bool(fn(name)))

    # -- eager API ----------------------------------------------------------
    def step(self):
        """One update over every parameter that has a grad (ref:
        Optimizer.step over Parameter.grad)."""
        live = [(n, p) for n, p in self._parameter_list or []
                if p.requires_grad and p.grad is not None]
        if live:
            self._apply([n for n, _ in live], [p for _, p in live],
                        [p.grad.to(p.dtype) for _, p in live],
                        self.get_lr(), self._step_count + 1)
        self._step_count += 1

    def clear_grad(self, set_to_zero=True):
        for _, p in self._parameter_list or []:
            p.grad = None

    # -- state dict (checkpoint/resume) -------------------------------------
    def state_dict(self):
        out = {"state": {n: dict(s) for n, s in self._state.items()},
               "__step__": self._step_count}
        if isinstance(self._lr, LRScheduler):
            out["LR_Scheduler"] = self._lr.state_dict()
        return out

    def set_state_dict(self, state):
        self._step_count = int(state.get("__step__", 0))
        if "LR_Scheduler" in state and isinstance(self._lr, LRScheduler):
            self._lr.set_state_dict(state["LR_Scheduler"])
        # copies: the slots are updated in place, and the source may still
        # be stepping (another optimizer, a checkpoint held in memory)
        self._state = {n: {k: t.clone() for k, t in s.items()}
                       for n, s in state.get("state", {}).items()}


class Momentum(Optimizer):
    """ref: paddle.optimizer.Momentum — heavy ball, optional Nesterov, with
    coupled L2 decay on every leaf:

        g += wd * p;  v = mu * v + g;  p -= lr * v
        (Nesterov: p -= lr * (g + mu * v))

    The velocity is f32, one per parameter name. Each step is a handful of
    ``torch._foreach_*`` calls over all the leaves, lr read on the
    device."""

    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)
        self._momentum = momentum
        self._nesterov = use_nesterov

    def _slot_names(self):
        return ("velocity",)

    def _slot_dtype(self, slot, p):
        return torch.float32

    def _velocity(self, name, p):
        st = self._state.get(name)
        if st is None:
            st = {"velocity": torch.zeros_like(p, dtype=torch.float32)}
            self._state[name] = st
        return st["velocity"]

    def init_state(self, names, params):
        for n, p in zip(names, params):
            self._velocity(n, p)

    def update(self, names, params, grads, scalars, scale=None, skip=None):
        vel = [self._velocity(n, p) for n, p in zip(names, params)]
        # the masked update's copies: the foreach calls below write in
        # place
        old = None if skip is None else [t.clone() for t in vel + params]
        g = [_scaled(t, scale).float() for t in grads]
        if self._weight_decay:
            g = torch._foreach_add(g, [p.float() for p in params],
                                   alpha=self._weight_decay)
        torch._foreach_mul_(vel, self._momentum)
        torch._foreach_add_(vel, g)
        upd = (torch._foreach_add(g, vel, alpha=self._momentum)
               if self._nesterov else vel)
        # lr is the device scalar: p -= lr * upd
        torch._foreach_sub_(params, torch._foreach_mul(upd, scalars[0]))
        if old is not None:
            for t, o in zip(vel + params, old):
                t.copy_(torch.where(skip, o, t))


class Adam(Optimizer):
    """ref: paddle.optimizer.Adam (bias-corrected, coupled L2 decay)."""

    _decoupled = False

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 name=None, apply_decay_param_fun=None, amsgrad=False,
                 moment_dtype=None, fused_kernel=False):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name, apply_decay_param_fun)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon
        self._amsgrad = amsgrad
        self._fused_kernel = bool(fused_kernel)
        # the kernel's launch table of the fused leaves (built at the first
        # CUDA step, rebuilt when the leaves or their state change)
        self._leaf_table = None
        if moment_dtype not in (None, "float32", torch.float32,
                                "bfloat16", torch.bfloat16):
            raise ValueError(f"moment_dtype={moment_dtype}: only bfloat16 "
                             "(stochastic rounding) or float32 are "
                             "supported")
        self._rounded = moment_dtype in ("bfloat16", torch.bfloat16)
        # the rounding noise's generator (made at the first update; a caller
        # may set its own), and its two draw buffers
        self.generator = None
        self._noise = None

    def _slot_names(self):
        names = ("m", "v", "vhat") if self._amsgrad else ("m", "v")
        return names + ("master",) if self._multi_precision else names

    def _slot_dtype(self, slot, p):
        if slot in ("vhat", "master"):
            return torch.float32
        if self._rounded:
            return torch.bfloat16
        return torch.float32 if self._multi_precision else p.dtype

    def _slots(self, name, p):
        st = self._state.get(name)
        if st is None:
            st = {s: torch.zeros_like(p, dtype=self._slot_dtype(s, p))
                  for s in self._slot_names() if s != "master"}
            if self._multi_precision:
                st["master"] = p.detach().float().clone()
            self._state[name] = st
        return st

    def init_state(self, names, params):
        for n, p in zip(names, params):
            self._slots(n, p)

    def rounding_noise(self, names, params):
        """The rounding noise of this step: for each leaf, (noise of m,
        noise of v), int16 tensors of its shape whose bits are uniform.
        Two draws from ``generator`` a step, each over every leaf at once,
        into buffers kept across steps (a recorded step fills them in
        place)."""
        total = sum(p.numel() for p in params)
        dev = params[0].device
        if self.generator is None:
            self.generator = torch.Generator(device=dev).manual_seed(
                NOISE_SEED)
        if self._noise is None or self._noise[0].numel() != total \
                or self._noise[0].device != dev:
            self._noise = [torch.empty(total, dtype=torch.int16, device=dev)
                           for _ in range(2)]
        for buf in self._noise:
            buf.random_(-2 ** 15, 2 ** 15, generator=self.generator)
        out, at = [], 0
        for p in params:
            n = p.numel()
            out.append(tuple(buf[at:at + n].view(p.shape)
                             for buf in self._noise))
            at += n
        return out

    def _scalar_values(self, lr, step):
        return (float(lr), 1.0 - self._beta1 ** step,
                1.0 - self._beta2 ** step)

    def update(self, names, params, grads, scalars, scale=None, skip=None):
        b1, b2, eps = self._beta1, self._beta2, self._epsilon
        lr, bc1, bc2 = scalars.unbind()
        hyper = dict(beta1=b1, beta2=b2, eps=eps,
                     decoupled=self._decoupled)
        fused = ([], [], [], [], [])  # p, m, v, g, wd
        noise = (self.rounding_noise(names, params) if self._rounded
                 else [(None, None)] * len(params))
        for name, p, g, (nm, nv) in zip(names, params, grads, noise):
            st = self._slots(name, p)
            wd = self._weight_decay if self._decays(name) else 0.0
            if self._amsgrad or self._rounded or self._multi_precision:
                # the reference's kernel takes none of these
                self._general_update(p, st, _scaled(g, scale), lr, bc1,
                                     bc2, wd, nm, nv, skip)
            elif self._fused_kernel and (p.dtype == st["m"].dtype
                                         == st["v"].dtype == torch.float32):
                for lst, x in zip(fused, (p, st["m"], st["v"], g, wd)):
                    lst.append(x)
            else:
                adamw_update_plain(p, st["m"], st["v"], _scaled(g, scale),
                                   lr, bc1, bc2, weight_decay=wd,
                                   skip=skip, **hyper)
        if fused[0]:
            ps, ms, vs, gs, wds = fused
            table = self._leaf_table
            if table is not None and not table.fits(ps, ms, vs):
                table = None
            self._leaf_table = fused_adamw_multi_update(
                ps, ms, vs, gs, scalars, weight_decays=wds,
                scale=scale, table=table, skip=skip, **hyper)

    def _general_update(self, p, st, g, lr, bc1, bc2, wd, noise_m=None,
                        noise_v=None, skip=None):
        """One leaf's update in plain PyTorch, the reference's jnp path:
        f32 math from the master (``multi_precision``) or p; m and v stored
        in their dtype, stochastically rounded with ``noise_m``/``noise_v``
        when they are bf16; AMSGrad's vhat in f32. Where ``skip`` is set,
        every tensor keeps its old value."""
        b1, b2 = self._beta1, self._beta2
        g32 = g.float()
        p32 = st["master"] if "master" in st else p.float()
        if wd and not self._decoupled:
            g32 = g32 + wd * p32
        m = b1 * st["m"].float() + (1.0 - b1) * g32
        v = b2 * st["v"].float() + (1.0 - b2) * (g32 * g32)
        vh = v
        if self._amsgrad:
            # vhat stays f32: the monotone max would ratchet rounding noise
            vh = torch.maximum(st["vhat"], v)
            st["vhat"].copy_(_keep_if(skip, st["vhat"], vh))
        step = lr * (m / bc1) / (torch.sqrt(vh / bc2) + self._epsilon)
        if wd and self._decoupled:
            step = step + lr * wd * p32
        p_new = p32 - step
        if "master" in st:
            st["master"].copy_(_keep_if(skip, st["master"], p_new))
        p.copy_(_keep_if(skip, p, p_new))
        if noise_m is not None:
            m, v = sround_bf16(m, noise_m), sround_bf16(v, noise_v)
        st["m"].copy_(_keep_if(skip, st["m"], m))
        st["v"].copy_(_keep_if(skip, st["v"], v))


class AdamW(Adam):
    """ref: paddle.optimizer.AdamW — decoupled weight decay."""

    _decoupled = True

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, name=None,
                 amsgrad=False, moment_dtype=None, fused_kernel=False):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip, lazy_mode, multi_precision,
                         name, apply_decay_param_fun, amsgrad,
                         moment_dtype=moment_dtype,
                         fused_kernel=fused_kernel)
