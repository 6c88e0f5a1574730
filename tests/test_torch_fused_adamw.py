"""One-pass AdamW of the PyTorch port vs the JAX package.

The port's plain twin of the AdamW kernel (what the CPU runs, and the
optimizer's own math) is held against the Pallas kernel in interpret mode
and against the reference optimizer's jnp update, on the same numpy
leaves, over two steps: coupled (Adam) and decoupled (AdamW) decay, weight
decay 0 and 0.01, within 1e-6. At the optimizer level, leaves on both
sides of the reference's eligibility rule (f32, at least 16384 elements)
update as the reference's do, and on the CPU nothing is launched or built.

The multi-leaf kernel: its launch plan (``multi_plan``), read as the
kernel reads it (each block's binary search for its leaf, its chunk, its
float4 part and scalar tail, every thread's indices), covers every value
of every leaf exactly once, for 1-value leaves, ragged tails, views off a
16-byte boundary, a 103 M-value leaf (sizes only) and more leaves than a
launch takes; the multi-leaf twin over GPT-tiny's 36 leaves (sizes below
and above 16384, biases and LayerNorm weights excluded from decay), alone
and under ``ClipGradByGlobalNorm``, equals the reference optimizer over
two steps within 1e-6 (the clip's norm within 1e-6 relative).
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
from paddle_tpu_torch.nlp.gpt import GPTForCausalLM, _resolve_config
from paddle_tpu_torch.optimizer import Adam, AdamW
from torch_threads import one_torch_thread  # noqa: F401

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
        port_adamw.fused_adamw_multi_update([tp], [tm], [tv], [tg], 1e-3,
                                            bc1, bc2, weight_decays=[wd],
                                            decoupled=decoupled, **_HYPER)
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
    """Leaves on both sides of the reference's 16384-element rule (its
    Pallas kernel in interpret mode for the large ones, its jnp path for
    the small ones); after three steps every leaf equals the reference
    optimizer's, and the CPU run launched and built nothing."""
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
    w = port_adamw.fused_adamw_multi_update
    before = (w.launches, w.leaves)
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
    assert (w.launches, w.leaves) == before
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
    # bf16 moments and master weights are ported (item 1.1); parameter
    # groups are not, and float16 moments are no option of the reference
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        AdamW(parameters=[{"params": p}])
    with pytest.raises(ValueError, match="float16"):
        AdamW(parameters=p, moment_dtype="float16")


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


# -- the multi-leaf kernel's launch plan --------------------------------------

_THREADS, _UNROLL = 256, 4  # csrc/fused_adamw.cu kThreads, kUnroll


def _block_leaf(first, chunk):
    """csrc/fused_adamw.cu's search: the last leaf whose first chunk is at
    or before ``chunk``."""
    lo, hi = 0, len(first) - 2
    while lo < hi:
        mid = (lo + hi + 1) >> 1
        if first[mid] <= chunk:
            lo = mid
        else:
            hi = mid - 1
    return lo


def _block_indices(begin, end, aligned):
    """Every value index one block updates, thread by thread, as the
    kernel's loops walk them: the float4 loop (kUnroll at a time, then one
    at a time) where the leaf is aligned, then the scalar tail."""
    out = []
    scalar_from = begin
    if aligned:
        q0, q1 = begin // 4, end // 4
        for tid in range(_THREADS):
            i = q0 + tid
            while i + (_UNROLL - 1) * _THREADS < q1:
                for u in range(_UNROLL):
                    j = i + u * _THREADS
                    out.extend(range(4 * j, 4 * j + 4))
                i += _UNROLL * _THREADS
            while i < q1:
                out.extend(range(4 * i, 4 * i + 4))
                i += _THREADS
        scalar_from = 4 * q1
    for tid in range(_THREADS):
        out.extend(range(scalar_from + tid, end, _THREADS))
    return out


def _covered(sizes, max_leaves, offsets=None, threads=True):
    """Run the plan as the kernel does and count each value's visits; a
    leaf is aligned when its offset (in values, for all four arrays) is a
    multiple of 4. With ``threads`` False, only the blocks' spans."""
    plan = port_adamw.multi_plan(sizes, max_leaves=max_leaves)
    seen = [np.zeros(n, np.int64) for n in sizes]
    for lo, hi, first in plan:
        assert first[0] == 0 and len(first) == hi - lo + 1
        assert first.dtype == np.int32
        for c in range(int(first[-1])):
            k = _block_leaf(first, c)
            leaf = lo + k
            begin = (c - int(first[k])) * port_adamw.CHUNK
            end = min(sizes[leaf], begin + port_adamw.CHUNK)
            assert 0 <= begin < end, (leaf, c)
            if threads:
                aligned = offsets is None or offsets[leaf] % 4 == 0
                idx = np.asarray(_block_indices(begin, end, aligned))
                np.add.at(seen[leaf], idx, 1)
            else:
                seen[leaf][begin:end] += 1
    return plan, seen


@pytest.mark.parametrize("case", ["ones", "ragged", "unaligned", "many"])
def test_multi_plan_covers_every_value_once(case):
    chunk = port_adamw.CHUNK
    offsets = None
    max_leaves = port_adamw.MAX_LEAVES
    if case == "ones":
        sizes = [1, 1, 3, 1, 2 * chunk + 1, 1]
    elif case == "ragged":  # float4 tails of 1-3 values, chunk edges
        sizes = [5, 4 * 1024 + 3, chunk - 1, chunk, chunk + 2, 16411, 7]
    elif case == "unaligned":  # views 1-3 values into a buffer
        sizes = [20000, 5, chunk + 6, 4 * 1024]
        offsets = [1, 2, 3, 0]
    else:  # more leaves than a launch takes: three launches
        max_leaves = 7
        sizes = [1 + (i * 37) % 300 for i in range(17)] + [chunk + 9]
    plan, seen = _covered(sizes, max_leaves, offsets)
    assert len(plan) == -(-len(sizes) // max_leaves)
    assert [hi - lo for lo, hi, _ in plan][:-1] == \
        [max_leaves] * (len(plan) - 1)
    for i, s in enumerate(seen):
        assert (s == 1).all(), f"leaf {i}: visits {np.unique(s)}"


def test_multi_plan_sizes_only():
    """A 103 M-value leaf (GPT-1.3B's 50304 x 2048 embedding) between
    small ones, and 1100 leaves (three launches at 512): nothing is
    allocated, every value is in one chunk of one block."""
    big = 50304 * 2048
    sizes = [3, big, 1]
    plan, seen = _covered(sizes, port_adamw.MAX_LEAVES, threads=False)
    assert len(plan) == 1
    assert plan[0][2].tolist() == [0, 1, 1 + -(-big // port_adamw.CHUNK),
                                   2 + -(-big // port_adamw.CHUNK)]
    assert all((s == 1).all() for s in seen)
    sizes = [1 + i % 5000 for i in range(1100)]
    plan = port_adamw.multi_plan(sizes)
    assert [(lo, hi) for lo, hi, _ in plan] == [(0, 512), (512, 1024),
                                                (1024, 1100)]
    for lo, hi, first in plan:
        want = np.cumsum([0] + [-(-n // port_adamw.CHUNK)
                                for n in sizes[lo:hi]])
        assert first.tolist() == want.tolist()
    with pytest.raises(ValueError):
        port_adamw.multi_plan([4, 0])


def test_leaf_table_layout():
    """The host table a launch hands the kernel: p, m, v, g pointers leaf
    by leaf, lengths and weight decays; rebuilt when a slot or a
    parameter's storage changes."""
    ps = [torch.zeros(n) for n in (3, 700)]
    ms = [torch.zeros_like(p) for p in ps]
    vs = [torch.zeros_like(p) for p in ps]
    table = port_adamw.LeafTable(ps, ms, vs, [0.0, 0.01])
    (lt,) = table.launches
    assert lt["ptrs"][:, :3].tolist() == [
        [p.data_ptr(), m.data_ptr(), v.data_ptr()]
        for p, m, v in zip(ps, ms, vs)]
    assert lt["n"].tolist() == [3, 700]
    assert lt["wd"].tolist() == [0.0, np.float32(0.01)]
    assert table.fits(ps, ms, vs)
    assert not table.fits(ps, [ms[0], ms[1].clone()], vs)
    ps[1].data = torch.zeros(700)
    assert not table.fits(ps, ms, vs)


# -- the multi-leaf update on the optimizer, GPT-tiny's leaves ----------------

@pytest.fixture(scope="module")
def gpt_tiny_leaves():
    """GPT-tiny's 36 leaves (5 of at least 16384 values, which the
    reference sends to its Pallas kernel) with values and two steps of
    gradients from numpy."""
    model = GPTForCausalLM(_resolve_config("gpt-tiny"), device="cpu")
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    rng = np.random.default_rng(21)
    arrays = {n: (rng.standard_normal(s) * 0.05).astype(np.float32)
              for n, s in shapes.items()}
    grads = [{n: rng.standard_normal(s).astype(np.float32)
              for n, s in shapes.items()} for _ in range(2)]
    return arrays, grads


def _decay(name):
    return not (name.endswith("bias") or ".ln_" in name or "ln_f" in name)


@pytest.mark.parametrize("clip", [None, 0.5])
def test_multi_update_gpt_tiny_matches_reference(gpt_tiny_leaves, clip,
                                                 monkeypatch):
    """AdamW(fused_kernel=True) over GPT-tiny's leaves runs the multi-leaf
    twin once a step over all 36 (the CPU: no launch, no build), and after
    two steps every leaf equals the reference's AdamW(fused_kernel=True)
    (its Pallas kernel in interpret mode for the 5 large leaves), with and
    without the global-norm clip, within 1e-6."""
    def no_build(name, *args):
        raise AssertionError(f"CPU step reached the kernel build ({name})")
    monkeypatch.setattr(_build, "load", no_build)
    calls = []
    twin = port_adamw.adamw_multi_update_plain

    def spy(ps, *args, **kw):
        calls.append((len(ps), kw["scale"] is not None))
        return twin(ps, *args, **kw)
    monkeypatch.setattr(port_adamw, "adamw_multi_update_plain", spy)
    arrays, grads = gpt_tiny_leaves
    named = _named(arrays)
    leaves = [_JaxLeaf(k, a) for k, a in arrays.items()]
    kw = dict(weight_decay=0.01, apply_decay_param_fun=_decay,
              fused_kernel=True)
    opt = AdamW(1e-3, parameters=named, **kw,
                grad_clip=None if clip is None else ClipGradByGlobalNorm(clip))
    jopt = JaxAdamW(1e-3, parameters=leaves, **kw,
                    grad_clip=None if clip is None else JaxClip(clip))
    before = (port_adamw.fused_adamw_multi_update.launches,
              port_adamw.fused_adamw_multi_update.leaves)
    for g in grads:
        for (name, p), leaf in zip(named, leaves):
            p.grad = torch.from_numpy(g[name])
            leaf.set_grad(g[name])
        opt.step()
        opt.clear_grad()
        jopt.step()
    assert calls == [(36, clip is not None)] * 2
    assert (port_adamw.fused_adamw_multi_update.launches,
            port_adamw.fused_adamw_multi_update.leaves) == before
    for (name, p), leaf in zip(named, leaves):
        np.testing.assert_allclose(p.detach().numpy(),
                                   np.asarray(leaf._value), atol=1e-6,
                                   rtol=0, err_msg=name)


def test_clip_coefficient_matches_reference(gpt_tiny_leaves):
    """The global-norm clip's coefficient from one multi-tensor norm is the
    reference clip's factor within 1e-6 relative, at a norm above and
    below clip_norm."""
    arrays, grads = gpt_tiny_leaves
    gs = list(grads[0].values())
    norm = float(np.sqrt(sum(np.sum(g.astype(np.float64) ** 2)
                             for g in gs)))
    for clip_norm in (norm / 3, norm * 2):
        want = JaxClip(clip_norm).apply([jnp.asarray(g) for g in gs])
        factor = float(np.asarray(want[0]).ravel()[0] / gs[0].ravel()[0])
        got = ClipGradByGlobalNorm(clip_norm).coefficient(
            [torch.from_numpy(g) for g in gs])
        assert got.dtype == torch.float32 and got.dim() == 0
        np.testing.assert_allclose(got.item(), factor, rtol=1e-6)
        np.testing.assert_allclose(got.item(), min(clip_norm / norm, 1.0),
                                   rtol=1e-6)
