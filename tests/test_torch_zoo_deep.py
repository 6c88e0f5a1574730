"""The deep families of the classification zoo on the PyTorch port vs the
JAX package: DenseNet, GoogLeNet and Inception v3.

As tests/test_torch_zoo.py (whose helpers this module shares): the
reference's weights, with every BatchNorm statistic, affine parameter and
bias drawn at random, cross into the port through numpy; each reference
model is built once a module (DenseNet-121 ~17 s, GoogLeNet ~37 s,
Inception v3 ~47 s of eager initializer compiles) and run through
``tests.conftest.jit_forward``. On the CPU, batch 2:

- eval: ``densenet121`` and ``googlenet`` at 32 x 32 (every stride still
  passes; GoogLeNet's aux pool 4 then reads a 2 x 2 map, the main pool a
  1 x 1 one) and ``inception_v3`` at 75 x 75, the smallest input its
  unpadded stem and grid reductions take (the reference's test runs 128):
  logits within 1e-5 of max(1, |reference|) (measured 1.6e-7, 1.5e-7 and
  2.7e-7);
- train mode (batch statistics), every ``Dropout``'s ``p`` set to 0 on
  both sides (the packages draw masks from different generators), at 96 x
  96: ``googlenet``'s three outputs (main, aux1, aux2) within 1e-5 of
  max(1, |reference|), and in eval the main logits alone; ``densenet121``
  within 1e-4, the bar of a whole deep model: its last BatchNorms take
  batch statistics over 3 x 3 maps, which magnify rounding (each package
  measured ~3e-6 and ~9e-6 from a float64 forward, 9.5e-6 apart).

The deep families are in a file of their own so that xdist's ``--dist
loadfile`` runs them on another worker than the shallow ones.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests.conftest import jit_forward
from tests.test_torch_zoo import (DEEP_TOL, F32_TOL, _close, _x,
                                  port_model, zero_dropout)
from tests.test_torch_zoo import zoo  # noqa: F401  (the module fixture)
from torch_threads import one_torch_thread  # noqa: F401

DEEP = {
    "densenet121": (32, {}),
    "googlenet": (32, {}),
    "inception_v3": (75, {}),
}
TRAIN_HW = 96


@pytest.mark.parametrize("name", sorted(DEEP))
def test_eval_forward_matches(zoo, name):
    jm, state = zoo(name, DEEP)
    hw = DEEP[name][0]
    x = _x((2, 3, hw, hw))
    want = jit_forward(jm, jnp.asarray(x))
    pm = port_model(name, state, DEEP)
    with torch.no_grad():
        got = pm(torch.from_numpy(x))
    _close(got, want, F32_TOL, name)


@pytest.mark.parametrize("name", ["densenet121", "googlenet"])
def test_train_forward_matches(zoo, name):
    jm, state = zoo(name, DEEP)
    pm = port_model(name, state, DEEP)
    zero_dropout(jm, pm)
    jm.train()
    pm.train()
    try:
        x = _x((2, 3, TRAIN_HW, TRAIN_HW), seed=5)
        want = jit_forward(jm, jnp.asarray(x))
        with torch.no_grad():
            got = pm(torch.from_numpy(x))
    finally:
        jm.eval()
    if name == "googlenet":
        assert isinstance(got, tuple) and len(got) == len(want) == 3
        for what, g, w in zip(("main", "aux1", "aux2"), got, want):
            _close(g, w, F32_TOL, f"googlenet train {what}")
        pm.eval()
        with torch.no_grad():
            main = pm(torch.from_numpy(x))
        assert torch.is_tensor(main) and tuple(main.shape) == (2, 10)
    else:
        _close(got, want, DEEP_TOL, f"{name} train")
