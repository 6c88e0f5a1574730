"""Boundaries of the PyTorch port.

- No module of ``paddle_tpu_torch/``, and not ``chip_smoke.py``, imports
  ``jax`` or anything of ``paddle_tpu`` (an AST scan of every import).
- Entry points default to CUDA: with no GPU and no ``device`` they raise
  instead of running on the CPU. ``Engine`` and the optimizers follow the
  model's device and create nothing on another one.
- A kernel wrapper given a tensor on neither the CPU nor CUDA raises; it
  never falls back to its plain twin. On the card head_dim 32 goes to the
  f32 forward only: a bf16 forward or a backward there raises, naming
  ROADMAP.md queue 2. ``ops.kernels.WRAPPERS`` holds all
  eleven wrappers, the fused 1x1-conv + BatchNorm one and the multi-leaf
  AdamW one (which replaced the one-leaf AdamW wrapper) included.
- Importing the port builds nothing.
"""
import ast
import os

import pytest
import torch

import paddle_tpu_torch
from paddle_tpu_torch.framework import seed
from paddle_tpu_torch.hapi import Engine
from paddle_tpu_torch.nlp.ernie import ErnieForPretraining, ErnieModel
from paddle_tpu_torch.nlp.gpt import (GPTForCausalLM,
                                      GPTPretrainingCriterion,
                                      _resolve_config)
from paddle_tpu_torch.nlp.llama import LlamaForCausalLM, LlamaModel
from paddle_tpu_torch.nlp.serving import ServingEngine
from paddle_tpu_torch.ops import _build
from paddle_tpu_torch.ops.kernels import conv_bn_act as kcba
from paddle_tpu_torch.ops.kernels import flash_attention as kfa
from paddle_tpu_torch.ops.kernels import fused_adamw as kadam
from paddle_tpu_torch.ops.kernels import fused_ln as kln
from paddle_tpu_torch.optimizer import Adam, AdamW
from torch_threads import one_torch_thread  # noqa: F401

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
    vision = [f for f in files if os.sep + "vision" + os.sep in f]
    assert {os.path.basename(f) for f in vision} >= {
        "__init__.py", "resnet.py", "lenet.py", "datasets.py",
        "transforms.py"}
    rel = {os.path.relpath(f, _PKG) for f in files}
    assert rel >= {os.path.join("hapi", "model.py"),
                   os.path.join("hapi", "callbacks.py"),
                   os.path.join("hapi", "summary.py"),
                   os.path.join("io", "dataloader.py"),
                   os.path.join("io", "process_worker.py"),
                   os.path.join("metric", "__init__.py"),
                   os.path.join("resilience", "preemption.py"),
                   "serialization.py"}


def test_high_level_path_imports_no_jax():
    """Model.fit, save and load in a fresh interpreter leave jax and the
    JAX package out of sys.modules."""
    import subprocess
    import sys
    code = (
        "import sys, os, tempfile, numpy as np\n"
        "import paddle_tpu_torch as pt\n"
        "from paddle_tpu_torch.vision.models import LeNet\n"
        "net = LeNet(device='cpu')\n"
        "m = pt.Model(net)\n"
        "m.prepare(pt.optimizer.Adam(1e-3), pt.nn.CrossEntropyLoss(),\n"
        "          pt.metric.Accuracy())\n"
        "ds = pt.vision.datasets.MNIST(mode='test')\n"
        "m.fit(pt.io.Subset(ds, range(64)), batch_size=32, verbose=0)\n"
        "d = tempfile.mkdtemp()\n"
        "m.save(os.path.join(d, 'x')); m.load(os.path.join(d, 'x'))\n"
        "bad = sorted(k for k in sys.modules\n"
        "             if k.split('.')[0] in ('jax', 'jaxlib', 'paddle_tpu'))\n"
        "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=_ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]


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
    for cls, name in ((ErnieModel, "ernie-tiny"),
                      (ErnieForPretraining, "ernie-tiny"),
                      (LlamaModel, "llama-tiny"),
                      (LlamaForCausalLM, "llama-tiny")):
        with pytest.raises(RuntimeError, match="no GPU"):
            cls.from_config_name(name)
        m = cls.from_config_name(name, device="cpu")
        assert {p.device.type for p in m.parameters()} == {"cpu"}
    from paddle_tpu_torch.vision.models import DETR, PPYOLOE
    for cls in (DETR, PPYOLOE):
        with pytest.raises(RuntimeError, match="no GPU"):
            cls()
    # generate() follows the model: the tokens and the sampler's
    # generator live on the CPU
    out = model.generate(torch.zeros(1, 3, dtype=torch.int64),
                         max_new_tokens=2, top_k=3, seed=1)
    assert out.device.type == "cpu"


def test_import_builds_nothing():
    assert not _build._libs


def test_wrappers_are_the_kernel_wrappers():
    # every entry resets and reads a real counter: a module that shadowed
    # a wrapper's name would take the reset silently and count nothing
    import importlib
    from paddle_tpu_torch.ops import kernels
    kpaged = importlib.import_module("paddle_tpu_torch.ops.kernels."
                                     "flash_decode")
    for w in kernels.WRAPPERS:
        assert callable(w) and not isinstance(w, type(os)), w
        assert isinstance(w.launches, int), w
    assert len({w.__name__ for w in kernels.WRAPPERS}) == 11
    assert kernels.flash_decode is kfa.flash_decode
    assert kadam.fused_adamw_multi_update in kernels.WRAPPERS
    assert kcba.fused_conv1x1_bn_act in kernels.WRAPPERS
    assert kpaged.paged_flash_decode in kernels.WRAPPERS


def test_engine_and_optimizers_follow_the_model(monkeypatch):
    """With no GPU, an Engine and optimizers over a CPU model run on the
    CPU without being told, and every tensor they make lives there."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _resolve_config("gpt-tiny", hidden_dropout_prob=0.1)
    model = GPTForCausalLM(cfg, device="cpu")
    assert model.gpt.embeddings.dropout.generator.device.type == "cpu"
    ids = torch.zeros(1, 8, dtype=torch.int64)
    for opt in (AdamW(1e-3, fused_kernel=True), Adam(1e-3, amsgrad=True)):
        eng = Engine(model, loss=GPTPretrainingCriterion(), optimizer=opt,
                     amp_dtype="bfloat16")
        loss, logits = eng.train_batch([ids.numpy()], [ids])
        assert eng.device.type == loss.device.type == "cpu"
        assert logits.device.type == "cpu"
        assert {t.device.type for s in opt._state.values()
                for t in s.values()} == {"cpu"}
    eager = AdamW(1e-3, parameters=model.parameters())
    GPTPretrainingCriterion()(model(ids), ids).backward()
    eager.step()
    assert {t.device.type for s in eager._state.values()
            for t in s.values()} == {"cpu"}


def test_kernel_wrappers_never_fall_back(monkeypatch):
    """A tensor off the CPU goes to the kernel or raises: on the meta
    device (standing in for a device with no kernel) every wrapper raises
    before it builds anything."""
    def no_build(name, *args):
        raise AssertionError(f"reached the kernel build ({name})")
    monkeypatch.setattr(_build, "load", no_build)
    t = torch.empty(2, 8, 64, device="meta")
    st = torch.empty(2, 8, device="meta")
    rows = torch.empty(16, 64, device="meta")
    vec = torch.empty(64, device="meta")
    stat = torch.empty(16, device="meta")
    calls = [
        lambda: kfa.flash_attention_fwd(t, t, t),
        lambda: kfa.flash_attention_bwd_dq(t, t, t, t, t, st),
        lambda: kfa.flash_attention_bwd_dkv(t, t, t, t, st, st),
        lambda: kadam.fused_adamw_multi_update(
            [t], [t], [t], [t], 1e-3, 0.1, 0.001, weight_decays=[0.0],
            beta1=0.9, beta2=0.999, eps=1e-8, decoupled=True),
        lambda: kln.fused_add_layer_norm_fwd(rows, rows, vec, vec),
        lambda: kln.fused_add_layer_norm_bwd(rows, rows, rows, stat, stat,
                                             vec),
        lambda: kln.fused_add_layer_norm_y_fwd(rows, rows, vec, vec),
        lambda: kln.fused_add_layer_norm_y_bwd(rows, rows, rows, stat, stat,
                                               vec),
        lambda: kln.fused_add_layer_norm(rows, rows, vec, vec),
        lambda: kln.fused_add_layer_norm_y(rows, rows, vec, vec),
        lambda: kfa.flash_decode(
            torch.empty(2, 1, 4, 64, device="meta"),
            torch.empty(2, 8, 4, 64, device="meta"),
            torch.empty(2, 8, 4, 64, device="meta"),
            torch.empty(2, dtype=torch.int32, device="meta")),
        lambda: kcba.fused_conv1x1_bn_act(rows, rows.t(), vec, vec),
    ]
    for call in calls:
        with pytest.raises(ValueError, match="unsupported device"):
            call()


def test_head_dim_32_is_the_f32_kernels_only(monkeypatch):
    """With the meta device standing in for the card (the device check
    passed over), the f32 forward and both f32 backward kernels at
    head_dim 32 go on to their kernel's build, while the bf16 forward and
    backward raise before any build, naming ROADMAP.md queue 2: none runs
    its plain twin."""
    def no_build(name, argtypes, symbol=None):
        raise AssertionError(f"reached the kernel build ({symbol or name})")
    monkeypatch.setattr(_build, "load", no_build)
    monkeypatch.setattr(kfa, "_on_cuda", lambda fn, q: None)
    f32 = torch.empty(2, 8, 32, device="meta")
    bf16 = torch.empty(2, 8, 32, device="meta", dtype=torch.bfloat16)
    st = torch.empty(2, 8, device="meta")
    builds = {
        "flash_attention_fwd": lambda: kfa.flash_attention_fwd(f32, f32,
                                                               f32),
        "flash_attention_bwd_dq": lambda: kfa.flash_attention_bwd_dq(
            f32, f32, f32, f32, f32, st),
        "flash_attention_bwd_dkv": lambda: kfa.flash_attention_bwd_dkv(
            f32, f32, f32, f32, st, st),
    }
    for name, call in builds.items():
        with pytest.raises(AssertionError, match=f"build \\({name}\\)"):
            call()
    calls = [
        lambda: kfa.flash_attention_fwd(bf16, bf16, bf16),
        lambda: kfa.flash_attention_bwd_dq(bf16, bf16, bf16, bf16, bf16, st),
        lambda: kfa.flash_attention_bwd_dkv(bf16, bf16, bf16, bf16, st, st),
    ]
    for call in calls:
        with pytest.raises(ValueError, match="ROADMAP.md queue 2"):
            call()
    assert kfa.F32_HEAD_DIMS == (32, 64, 128, 256)
    assert kfa.head_dims(torch.float32) == kfa.F32_HEAD_DIMS
    assert kfa.head_dims(torch.bfloat16) == kfa.HEAD_DIMS == (64, 128, 256)
