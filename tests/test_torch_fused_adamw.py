"""One-pass AdamW of the PyTorch port vs the JAX package.

The port's plain twin of the AdamW kernel (what the CPU runs, and the
optimizer's own math) is held against the Pallas kernel in interpret mode
and against the reference optimizer's jnp update, on the same numpy
leaves, over two steps: coupled (Adam) and decoupled (AdamW) decay, weight
decay 0 and 0.01, within 1e-6. At the optimizer level, leaves on both
sides of the eligibility rule (f32, at least 16384 elements) update as
the reference's do, and on the CPU nothing is launched or built.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.nn.clip import ClipGradByGlobalNorm as JaxClip
from paddle_tpu.optimizer import Adam as JaxAdam
from paddle_tpu.optimizer import AdamW as JaxAdamW
from paddle_tpu.ops.pallas.fused_adamw import \
    fused_adamw_update as jax_fused_adamw
from paddle_tpu_torch.nn import ClipGradByGlobalNorm
from paddle_tpu_torch.ops import _build
from paddle_tpu_torch.ops.kernels import fused_adamw as port_adamw
from paddle_tpu_torch.optimizer import Adam, AdamW

_HYPER = dict(beta1=0.9, beta2=0.999, eps=1e-8)


def _leaf(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape).astype(np.float32),
            (rng.standard_normal(shape) * 0.1).astype(np.float32),
            np.abs(rng.standard_normal(shape) * 0.01).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


@pytest.mark.parametrize("decoupled,wd", [(False, 0.0), (False, 0.01),
                                          (True, 0.0), (True, 0.01)])
def test_plain_matches_pallas_interpret(decoupled, wd):
    p, m, v, g = _leaf((128, 128), seed=int(decoupled) * 10 + int(wd * 100))
    jp, jm, jv = (jnp.asarray(x) for x in (p, m, v))
    tp, tm, tv = (torch.from_numpy(x.copy()) for x in (p, m, v))
    tg = torch.from_numpy(g)
    for step in (1, 2):
        bc1, bc2 = 1 - 0.9 ** step, 1 - 0.999 ** step
        jp, jm, jv = jax_fused_adamw(jp, jm, jv, jnp.asarray(g), 1e-3, bc1,
                                     bc2, weight_decay=wd,
                                     decoupled=decoupled, interpret=True,
                                     **_HYPER)
        out = port_adamw.fused_adamw_update(tp, tm, tv, tg, 1e-3, bc1, bc2,
                                            weight_decay=wd,
                                            decoupled=decoupled, **_HYPER)
        assert all(a is b for a, b in zip(out, (tp, tm, tv))), "in place"
        for name, a, b in (("p", tp, jp), ("m", tm, jm), ("v", tv, jv)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6,
                                       rtol=0, err_msg=f"{name} step {step}")


def _named(arrays):
    return [(k, torch.nn.Parameter(torch.from_numpy(a.copy())))
            for k, a in arrays.items()]


class _JaxLeaf:
    """What the reference optimizer's eager step needs of a parameter."""

    def __init__(self, name, value):
        from paddle_tpu.tensor import Tensor
        self.name = name
        self.trainable = True
        self.need_clip = True
        self.optimize_attr = {}
        self._value = jnp.asarray(value)
        self.grad = None
        self._tensor = Tensor

    def set_grad(self, g):
        self.grad = self._tensor(jnp.asarray(g))

    def clear_grad(self):
        self.grad = None


@pytest.mark.parametrize("cls,jcls,wd", [(AdamW, JaxAdamW, 0.01),
                                         (AdamW, JaxAdamW, 0.0),
                                         (Adam, JaxAdam, 0.01)])
def test_optimizer_matches_reference(cls, jcls, wd, monkeypatch):
    """Leaves of 16384 elements and more take the kernel's path, smaller
    ones the plain path; after three steps every leaf equals the
    reference optimizer's (its fused path for the same leaves, Pallas in
    interpret mode), and the CPU run launched and built nothing."""
    def no_build(name, *args):
        raise AssertionError(f"CPU step reached the kernel build ({name})")
    monkeypatch.setattr(_build, "load", no_build)
    arrays = {"big.weight": _leaf((128, 128), 1)[0],        # eligible
              "wide.weight": _leaf((64, 512), 2)[0],        # eligible
              "small.weight": _leaf((64, 64), 3)[0],        # below the floor
              "bias": _leaf((128,), 4)[0]}
    decay = lambda n: not n.endswith("bias")  # noqa: E731
    named = _named(arrays)
    opt = cls(1e-3, parameters=named, weight_decay=wd,
              apply_decay_param_fun=decay, fused_kernel=True)
    leaves = [_JaxLeaf(k, a) for k, a in arrays.items()]
    jopt = jcls(1e-3, parameters=leaves, weight_decay=wd,
                apply_decay_param_fun=decay, fused_kernel=True)
    before = port_adamw.fused_adamw_update.launches
    rng = np.random.default_rng(9)
    for _ in range(3):
        for (name, p), leaf in zip(named, leaves):
            g = rng.standard_normal(p.shape).astype(np.float32)
            p.grad = torch.from_numpy(g)
            leaf.set_grad(g)
        opt.step()
        opt.clear_grad()
        jopt.step()
    assert all(p.grad is None for _, p in named)
    assert port_adamw.fused_adamw_update.launches == before
    for (name, p), leaf in zip(named, leaves):
        np.testing.assert_allclose(p.detach().numpy(),
                                   np.asarray(leaf._value), atol=1e-6,
                                   rtol=0, err_msg=name)


def test_eligibility_rule():
    f32 = torch.zeros(1 << 14)
    assert port_adamw.fused_adamw_supported(f32, f32, f32)
    small = torch.zeros((1 << 14) - 1)
    assert not port_adamw.fused_adamw_supported(small, small, small)
    # any length at or above the floor: no size % 4096 rule on CUDA
    odd = torch.zeros(16411)
    assert port_adamw.fused_adamw_supported(odd, odd, odd)
    bf = torch.zeros(1 << 14, dtype=torch.bfloat16)
    assert not port_adamw.fused_adamw_supported(f32, bf, f32)


def test_unported_options_raise():
    p = [torch.nn.Parameter(torch.zeros(4))]
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        AdamW(parameters=p, moment_dtype="bfloat16")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        AdamW(parameters=p, multi_precision=True)


def test_amsgrad_matches_reference():
    arrays = {"w": _leaf((32, 32), 5)[0]}
    named = _named(arrays)
    opt = AdamW(1e-3, parameters=named, amsgrad=True, fused_kernel=True)
    leaf = _JaxLeaf("w", arrays["w"])
    jopt = JaxAdamW(1e-3, parameters=[leaf], amsgrad=True)
    rng = np.random.default_rng(3)
    for _ in range(3):
        g = rng.standard_normal((32, 32)).astype(np.float32)
        named[0][1].grad = torch.from_numpy(g)
        leaf.set_grad(g)
        opt.step()
        jopt.step()
    np.testing.assert_allclose(named[0][1].detach().numpy(),
                               np.asarray(leaf._value), atol=1e-6, rtol=0)


def test_grad_clip_and_state_dict_resume():
    """grad_clip runs inside the step as the reference's does; a state_dict
    taken mid-run and loaded into a fresh optimizer continues the run
    exactly."""
    arrays = {"w": _leaf((128, 128), 6)[0], "b": _leaf((16,), 7)[0]}
    rng = np.random.default_rng(8)
    grads = [{k: rng.standard_normal(a.shape).astype(np.float32)
              for k, a in arrays.items()} for _ in range(3)]
    named = _named(arrays)
    opt = AdamW(1e-3, parameters=named, fused_kernel=True,
                grad_clip=ClipGradByGlobalNorm(1.0))
    leaves = [_JaxLeaf(k, a) for k, a in arrays.items()]
    jopt = JaxAdamW(1e-3, parameters=leaves, fused_kernel=True,
                    grad_clip=JaxClip(1.0))

    def step(o, params, g):
        for (k, p) in params:
            p.grad = torch.from_numpy(g[k])
        o.step()
        o.clear_grad()

    for g in grads[:2]:
        step(opt, named, g)
        for leaf in leaves:
            leaf.set_grad(g[leaf.name])
        jopt.step()
    for (k, p), leaf in zip(named, leaves):
        np.testing.assert_allclose(p.detach().numpy(),
                                   np.asarray(leaf._value), atol=1e-6,
                                   rtol=0, err_msg=k)
    resumed = [(k, torch.nn.Parameter(p.detach().clone()))
               for k, p in named]
    opt2 = AdamW(1e-3, parameters=resumed, fused_kernel=True,
                 grad_clip=ClipGradByGlobalNorm(1.0))
    opt2.set_state_dict(opt.state_dict())
    step(opt, named, grads[2])
    step(opt2, resumed, grads[2])
    for (k, a), (_, b) in zip(named, resumed):
        torch.testing.assert_close(a, b, atol=0, rtol=0, msg=k)
