"""Global-norm gradient clipping and LR schedulers of the PyTorch port vs
the JAX package: the same numpy grads clip to the same values (1e-6), and
each scheduler walks the same learning rates step by step (``get_lr``,
1e-12 relative) and as a pure function of the step (``value_at``, 1e-6:
the reference computes it in f32 on a traced counter, the port's copy in
Python floats).
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from paddle_tpu.nn import clip as jax_clip
from paddle_tpu.optimizer import lr as jax_lr
from paddle_tpu_torch.nn import clip as port_clip
from paddle_tpu_torch.optimizer import lr as port_lr
from torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("clip_norm", [1.0, 100.0])
def test_global_norm_clip_matches_jax(clip_norm):
    rng = np.random.default_rng(1)
    grads = [rng.standard_normal(s).astype(np.float32)
             for s in ((16, 8), (8,), (4, 4, 4))]
    want = jax_clip.ClipGradByGlobalNorm(clip_norm).apply(
        [jnp.asarray(g) for g in grads])
    got = port_clip.ClipGradByGlobalNorm(clip_norm).apply(
        [torch.from_numpy(g) for g in grads])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6,
                                   rtol=0)


def test_clip_eager_pairs():
    p = torch.nn.Parameter(torch.zeros(3))
    pairs = [(p, torch.full((3,), 4.0)), (p, None)]
    out = port_clip.ClipGradByGlobalNorm(1.0)(pairs)
    assert out[1] == (p, None)
    np.testing.assert_allclose(out[0][1].norm().item(), 1.0, rtol=1e-6)


SCHEDULES = [
    ("NoamDecay", dict(d_model=64, warmup_steps=4, learning_rate=1.0)),
    ("PolynomialDecay", dict(learning_rate=0.1, decay_steps=5,
                             end_lr=0.01, power=2.0)),
    ("PolynomialDecay", dict(learning_rate=0.1, decay_steps=3, cycle=True)),
    ("LinearWarmup", dict(learning_rate=0.5, warmup_steps=4, start_lr=0.0,
                          end_lr=0.5)),
    ("CosineAnnealingDecay", dict(learning_rate=0.2, T_max=6)),
    ("StepDecay", dict(learning_rate=0.1, step_size=3, gamma=0.5)),
    ("MultiStepDecay", dict(learning_rate=0.1, milestones=[2, 5])),
    ("ExponentialDecay", dict(learning_rate=0.1, gamma=0.9)),
    ("InverseTimeDecay", dict(learning_rate=0.1, gamma=0.5)),
]


@pytest.mark.parametrize("name,kw", SCHEDULES,
                         ids=[f"{n}-{i}" for i, (n, _) in
                              enumerate(SCHEDULES)])
def test_scheduler_matches_jax(name, kw):
    js, ps = getattr(jax_lr, name)(**kw), getattr(port_lr, name)(**kw)
    for step in range(9):
        np.testing.assert_allclose(ps(), js(), rtol=1e-12, atol=0,
                                   err_msg=f"step {step}")
        if type(js).value_at is not jax_lr.LRScheduler.value_at:
            np.testing.assert_allclose(
                float(ps.value_at(step)),
                float(js.value_at(jnp.asarray(step, jnp.int32))),
                rtol=1e-6, atol=1e-9, err_msg=f"value_at {step}")
        js.step()
        ps.step()
    assert ps.state_dict() == js.state_dict()
