"""Boundaries of the PyTorch port.

- No module of ``paddle_tpu_torch/``, and not ``chip_smoke.py``, imports
  ``jax`` or anything of ``paddle_tpu`` (an AST scan of every import).
- Entry points default to CUDA: with no GPU and no ``device`` they raise
  instead of running on the CPU.
- Importing the port builds nothing.
"""
import ast
import os

import pytest
import torch

import paddle_tpu_torch
from paddle_tpu_torch.framework import seed
from paddle_tpu_torch.nlp.gpt import GPTForCausalLM, _resolve_config
from paddle_tpu_torch.nlp.serving import ServingEngine
from paddle_tpu_torch.ops import _build

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_PKG = os.path.dirname(os.path.abspath(paddle_tpu_torch.__file__))
_BANNED = ("jax", "jaxlib", "paddle_tpu")


def _port_files():
    files = [os.path.join(_ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(_PKG):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _imported_roots(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_files_found():
    files = _port_files()
    assert os.path.exists(files[0]), "chip_smoke.py missing"
    assert len(files) > 15


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, _ROOT))
def test_no_jax_or_reference_imports(path):
    bad = sorted({r for r in _imported_roots(path) if r in _BANNED})
    assert not bad, f"{os.path.relpath(path, _ROOT)} imports {bad}"


def test_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _resolve_config("gpt-tiny")
    with pytest.raises(RuntimeError, match="no GPU"):
        GPTForCausalLM(cfg)
    model = GPTForCausalLM(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no GPU"):
        ServingEngine(model)
    with pytest.raises(RuntimeError, match="no GPU"):
        ServingEngine(model, device="cuda")
    eng = ServingEngine(model, device="cpu", max_seq_len=64)
    assert eng.device.type == "cpu"
    with pytest.raises(RuntimeError, match="no GPU"):
        seed(0)
    assert seed(0, device="cpu").device.type == "cpu"


def test_import_builds_nothing():
    assert not _build._libs
