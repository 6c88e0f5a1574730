"""``paddle.static`` of the port: ``InputSpec`` (counterpart of the JAX
package's ``paddle_tpu.jit.InputSpec``, which its ``static`` module
re-exports).

An ``InputSpec`` describes one input of a network — its shape (``None``
or a negative size for a dimension that varies), dtype and name — as
``paddle.Model(network, inputs=[...], labels=[...])`` takes it: the
Model feeds a batch's first ``len(inputs)`` fields to the network and the
rest to the loss, and ``summary`` reads the shapes. The rest of the
reference's ``static`` and ``jit`` (``to_static``, ``Program``,
``Executor``, ``jit.save``) is not ported (ROADMAP.md queue 1 items 8 and
11).
"""
from __future__ import annotations

__all__ = ["InputSpec"]


class InputSpec:
    """ref: paddle.static.InputSpec."""

    def __init__(self, shape, dtype="float32", name=None):
        self.shape = tuple(shape)
        self.dtype = dtype
        self.name = name

    @classmethod
    def from_tensor(cls, t, name=None):
        return cls(tuple(t.shape), str(t.dtype), name)

    def __repr__(self):
        return (f"InputSpec(shape={self.shape}, dtype={self.dtype}, "
                f"name={self.name})")
