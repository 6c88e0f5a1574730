"""paddle.save / paddle.load of the port (counterpart of
``paddle_tpu/serialization.py``, ref: python/paddle/framework/io.py).

The file format is the reference's, byte for byte in layout: the magic
line ``PTPU1``, a pickled structure skeleton, the separator ``__NPZ__``
and an npz of the arrays. A ``.pdparams`` written by either package loads
in the other. The skeleton holds only dicts, lists, tuples and plain
leaves; its unpickler refuses any class of the JAX package (or of jax), so
loading a file never imports either.

Tensors are stored as numpy arrays (``__tensor__``) and load back as CPU
torch tensors; numpy arrays (``__ndarray__``) load back as numpy. A dtype
numpy cannot hold (bfloat16, the float8 types) is stored as its bits
under a same-width unsigned integer view plus a dtype tag, as the
reference stores ml_dtypes arrays, so the two packages read each other's
bf16 arrays bit for bit.

Not ported: the plain-pickle branch that reads reference-framework
checkpoints (``compat.load_pdparams``); such a file raises naming
ROADMAP.md queue 1 item 11.
"""
from __future__ import annotations

import io
import os
import pickle

import numpy as np
import torch

from .framework import later

__all__ = ["save", "load", "load_into"]

_MAGIC = b"PTPU1\n"
_SEP = b"\n__NPZ__\n"

# dtype tag -> (torch dtype, same-width torch integer, numpy unsigned view)
_EXT = {"bfloat16": (torch.bfloat16, torch.int16, np.uint16),
        "float8_e4m3fn": (torch.float8_e4m3fn, torch.int8, np.uint8),
        "float8_e5m2": (torch.float8_e5m2, torch.int8, np.uint8)}
_EXT_BY_TORCH = {t: name for name, (t, _, _) in _EXT.items()}
_BANNED_MODULES = ("jax", "jaxlib", "paddle_tpu")


def _store(arr, arrays):
    """Put one numpy array or torch tensor into ``arrays``; returns its key
    and the dtype tag (None for a dtype numpy holds)."""
    key = f"t{len(arrays)}"
    if torch.is_tensor(arr):
        t = arr.detach().cpu()
        ext = _EXT_BY_TORCH.get(t.dtype)
        if ext is not None:
            _, as_int, as_np = _EXT[ext]
            arrays[key] = t.contiguous().view(as_int).numpy().view(as_np)
            return key, ext
        arrays[key] = t.numpy()
        return key, None
    if arr.dtype.name in _EXT:  # an ml_dtypes array (a JAX state)
        bits = np.dtype(f"uint{8 * arr.dtype.itemsize}")
        arrays[key] = np.ascontiguousarray(arr).view(bits).reshape(arr.shape)
        return key, arr.dtype.name
    arrays[key] = arr
    return key, None


def _restore(arr, tag, as_tensor):
    """A stored array back as a CPU tensor (``as_tensor``) or numpy."""
    if tag is None:
        return torch.from_numpy(np.array(arr)) if as_tensor else arr
    if as_tensor:
        dt, as_int, _ = _EXT[tag]
        return torch.from_numpy(np.array(arr)).view(as_int).view(dt)
    try:
        import ml_dtypes
    except ImportError as e:  # pragma: no cover - numpy cannot hold it
        raise ValueError(f"a {tag} array needs ml_dtypes to load as numpy; "
                         "load it with return_numpy=False") from e
    return arr.view(np.dtype(getattr(ml_dtypes, tag))).reshape(arr.shape)


def _pack(obj, arrays):
    if torch.is_tensor(obj):
        key, ext = _store(obj, arrays)
        spec = {"__tensor__": key, "stop_gradient": not obj.requires_grad}
        if ext:
            spec["dtype"] = ext
        return spec
    if isinstance(obj, np.ndarray):
        key, ext = _store(obj, arrays)
        spec = {"__ndarray__": key}
        if ext:
            spec["dtype"] = ext
        return spec
    if isinstance(obj, dict):
        return {"__dict__": {k: _pack(v, arrays) for k, v in obj.items()}}
    if isinstance(obj, (list, tuple)):
        return {"__seq__": [_pack(v, arrays) for v in obj],
                "tuple": isinstance(obj, tuple)}
    return {"__leaf__": obj}


def _unpack(spec, arrays, return_numpy=False):
    if "__tensor__" in spec:
        return _restore(arrays[spec["__tensor__"]], spec.get("dtype"),
                        not return_numpy)
    if "__ndarray__" in spec:
        return _restore(arrays[spec["__ndarray__"]], spec.get("dtype"),
                        False)
    if "__dict__" in spec:
        return {k: _unpack(v, arrays, return_numpy)
                for k, v in spec["__dict__"].items()}
    if "__seq__" in spec:
        seq = [_unpack(v, arrays, return_numpy) for v in spec["__seq__"]]
        return tuple(seq) if spec.get("tuple") else seq
    return spec["__leaf__"]


class _SpecUnpickler(pickle.Unpickler):
    """The skeleton's unpickler: any class of jax or of the JAX package is
    refused instead of imported."""

    def find_class(self, module, name):
        if module.split(".")[0] in _BANNED_MODULES:
            raise pickle.UnpicklingError(
                f"checkpoint names {module}.{name}; the port never imports "
                "jax or the JAX package")
        return super().find_class(module, name)


def save(obj, path, protocol=4, **configs):
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    arrays = {}
    spec = _pack(obj, arrays)
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    with open(path, "wb") as f:
        f.write(_MAGIC)
        f.write(pickle.dumps(spec, protocol=protocol))
        f.write(_SEP)
        f.write(buf.getvalue())


def load(path, return_numpy=False, **configs):
    with open(path, "rb") as f:
        head = f.read(len(_MAGIC))
        if not head.startswith(_MAGIC):
            if head[:1] == b"\x80":
                raise NotImplementedError(
                    f"{path} is a plain pickle (a reference-framework "
                    f".pdparams/.pdopt): compat.load_pdparams {later('11')}")
            raise ValueError(f"{path} is not a paddle_tpu checkpoint")
        body = f.read()
    idx = body.index(_SEP)
    spec = _SpecUnpickler(io.BytesIO(body[:idx])).load()
    arrays = dict(np.load(io.BytesIO(body[idx + len(_SEP):]),
                          allow_pickle=False))
    return _unpack(spec, arrays, return_numpy=return_numpy)


def load_into(model, path, strict=True):
    """Load a checkpoint file into a module. ``strict`` refuses a partial
    load before anything is copied (missing parameters would silently keep
    their prior values). Returns (missing, unexpected) key lists."""
    state = load(str(path))
    if isinstance(state, dict) and set(state) >= {"params"} and \
            all(k in ("params", "buffers", "specs") for k in state):
        state = {**state.get("params", {}), **state.get("buffers", {})}
    if strict:
        missing = [k for k in model.state_dict() if k not in state]
        if missing:
            raise ValueError(
                f"checkpoint {path} is missing parameters "
                f"{missing[:8]}{'...' if len(missing) > 8 else ''} — "
                "refusing a partial load (it would silently mix prior "
                "and pretrained weights); pass strict=False to allow")
    return set_state_dict(model, state)


def set_state_dict(model, state):
    """The reference's ``Layer.set_state_dict`` on a torch module: copies
    every entry of ``state`` (tensors or numpy arrays) whose key the module
    has into it, casting to the module's dtype and device. Returns
    (missing, unexpected) key lists."""
    own = model.state_dict()
    missing = [k for k in own if k not in state]
    unexpected = [k for k in state if k not in own]
    with torch.no_grad():
        for k, v in state.items():
            if k not in own:
                continue
            t = v if torch.is_tensor(v) else torch.as_tensor(np.asarray(v))
            if tuple(t.shape) != tuple(own[k].shape):
                raise ValueError(f"set_state_dict: shape mismatch for {k}: "
                                 f"{tuple(t.shape)} vs "
                                 f"{tuple(own[k].shape)}")
            own[k].copy_(t)
    return missing, unexpected
