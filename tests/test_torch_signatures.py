"""The port's public signatures against the JAX package's.

Every name that both packages export from ``nn``, ``nn.functional``,
``vision.ops``, ``vision.models``, ``optimizer``, ``metric``, ``io``,
``hapi``, ``nlp``, ``incubate``, ``amp`` and ``resilience`` (each
module's own names, and those in the ``__all__`` of its submodules that
both packages have) takes the reference's parameters under the
reference's names, the positional ones in the reference's order: a reference call binds each argument to the same
parameter in the port, or raises NotImplementedError naming its item. The
port's own parameters come after them or are keyword-only. A port callable
that takes only ``*args, **kwargs`` where the reference names parameters
is a refusal, and calling it raises NotImplementedError naming its
ROADMAP.md item.

``ALLOWED`` lists the deliberate differences, each with its reason.
"""
import importlib
import inspect
import pkgutil

import numpy as np
import pytest
import torch

from tests.torch_threads import one_torch_thread  # noqa: F401

MODULES = ("nn", "nn.functional", "vision.ops", "vision.models",
           "optimizer", "metric", "io", "hapi", "nlp", "incubate", "amp",
           "resilience")

_SHARDING = ("one card: the port prefetches onto a torch device, and has "
             "no JAX sharding to place batches by")
_BERT_HEAD = ("the port's head reads the tied decoder weight from the model "
              "at forward time (nlp/bert.py), so the embedding weights are "
              "not a constructor argument")
ALLOWED = {
    "io.device_prefetch": _SHARDING,
    "io.dataloader.device_prefetch": _SHARDING,
    "nlp.bert.BertLMPredictionHead": _BERT_HEAD,
    "nlp.bert.BertPretrainingHeads": _BERT_HEAD,
    "nlp.serving.ServeRequest": (
        "built by ServingEngine.submit, whose deadline, priority, trace and "
        "tenant keywords item 7 refuses; a caller never constructs one"),
}

_POSITIONAL = (inspect.Parameter.POSITIONAL_ONLY,
               inspect.Parameter.POSITIONAL_OR_KEYWORD)
_VAR = (inspect.Parameter.VAR_POSITIONAL, inspect.Parameter.VAR_KEYWORD)


def _module_pairs():
    for mod in MODULES:
        ref = importlib.import_module("paddle_tpu." + mod)
        port = importlib.import_module("paddle_tpu_torch." + mod)
        yield mod, ref, port, [n for n in dir(port) if not n.startswith("_")]
        for info in pkgutil.iter_modules(getattr(port, "__path__", [])):
            sub = f"{mod}.{info.name}"
            try:
                sref = importlib.import_module("paddle_tpu." + sub)
            except ImportError:
                continue
            sport = importlib.import_module("paddle_tpu_torch." + sub)
            yield sub, sref, sport, list(getattr(sport, "__all__", []))


def _params(obj):
    try:
        if inspect.isclass(obj):
            params = inspect.signature(obj.__init__).parameters
            return list(params.values())[1:]
        return list(inspect.signature(obj).parameters.values())
    except (TypeError, ValueError):
        return None


def _cases():
    out = {}
    for mod, ref, port, names in _module_pairs():
        for name in names:
            if not hasattr(ref, name):
                continue
            r, p = getattr(ref, name), getattr(port, name)
            if (not callable(r) or not callable(p) or inspect.ismodule(p)
                    or not getattr(p, "__module__", "").startswith(
                        "paddle_tpu_torch")):
                continue
            if _params(r) is None or _params(p) is None:
                continue
            out[f"{mod}.{name}"] = (r, p)
    return out


CASES = _cases()


def _takes_anything(params):
    return len(params) == 2 and all(p.kind in _VAR for p in params)


def _refusal(ref, port):
    """A port callable that takes anything where the reference names its
    parameters: a refusal stub."""
    return _takes_anything(_params(port)) and not _takes_anything(
        _params(ref))


def _difference(ref, port):
    """None where a reference call binds as it does in the reference, else
    what differs."""
    pr, pp = _params(ref), _params(port)
    if _refusal(ref, port):
        return None  # test_refusals_name_their_item calls it
    rpos = [p.name for p in pr if p.kind in _POSITIONAL]
    ppos = [p.name for p in pp if p.kind in _POSITIONAL]
    if ppos[:len(rpos)] != rpos:
        return f"positional {rpos} vs the port's {ppos}"
    names = {p.name for p in pp}
    missing = [p.name for p in pr
               if p.kind == p.KEYWORD_ONLY and p.name not in names]
    if missing:
        return f"keyword-only {missing} missing"
    return None


def test_the_comparison_covers_the_modules():
    """The walk finds the names the repair is about (a walk that found
    nothing would pass every case)."""
    for key in ("nn.Linear", "nn.LayerNorm", "nn.Embedding", "nn.Dropout",
                "nn.LayerList", "nn.functional.cross_entropy",
                "nn.functional.dropout", "nn.functional.embedding",
                "nn.functional.scaled_dot_product_attention",
                "vision.ops.nms", "hapi.Engine", "nlp.GPTForCausalLM",
                "optimizer.AdamW", "io.DataLoader"):
        assert key in CASES, key
    assert len(CASES) > 200


@pytest.mark.parametrize("key", sorted(CASES))
def test_signature_matches_the_reference(key):
    diff = _difference(*CASES[key])
    if key in ALLOWED:
        assert diff is not None, f"{key} no longer differs: drop it from " \
            "ALLOWED"
        return
    assert diff is None, f"{key}: {diff}"


def test_allow_list_names_compared_entries():
    assert set(ALLOWED) <= set(CASES)
    assert all(reason.strip() for reason in ALLOWED.values())


def test_refusals_name_their_item():
    """Each ``*args, **kwargs`` callable of the walk raises
    NotImplementedError naming ROADMAP.md."""
    stubs = [k for k, (r, p) in CASES.items() if _refusal(r, p)]
    assert stubs
    for key in stubs:
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            CASES[key][1]()


# -- what the repair computes ----------------------------------------------

def test_linear_bias_attr_false_and_param_attr():
    from paddle_tpu_torch import nn
    lin = nn.Linear(4, 3, None, False, device="cpu")
    assert lin.bias is None and "bias" not in dict(lin.named_parameters())
    x = torch.randn(2, 4)
    torch.testing.assert_close(lin(x), x @ lin.weight, rtol=0, atol=0)
    assert nn.Linear(4, 3, bias_attr=None, device="cpu").bias is not None
    with pytest.raises(NotImplementedError, match="item 1.6"):
        nn.Linear(4, 3, weight_attr=object(), device="cpu")
    with pytest.raises(NotImplementedError, match="item 1.6"):
        nn.Linear(4, 3, bias_attr=object(), device="cpu")
    ln = nn.LayerNorm(4, 1e-5, False, False, device="cpu")
    assert ln.weight is None and ln.bias is None
    xs = torch.randn(3, 4)
    torch.testing.assert_close(
        ln(xs), torch.nn.functional.layer_norm(xs, (4,), eps=1e-5))
    with pytest.raises(NotImplementedError, match="item 1.6"):
        nn.LayerNorm(4, weight_attr=object(), device="cpu")


def test_embedding_padding_idx_matches_the_reference():
    """The padding row reads zero and gets no gradient, as the
    reference's ``F.embedding``; ``sparse=True`` refuses."""
    import jax
    import jax.numpy as jnp

    from paddle_tpu.nn import functional as RF
    from paddle_tpu.tensor import Tensor
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.nn import functional as F
    rng = np.random.default_rng(0)
    w = rng.standard_normal((7, 5)).astype(np.float32)
    ids = np.array([[0, 3, 6, 3], [3, 1, 2, 0]])
    want = np.asarray(RF.embedding(Tensor(jnp.asarray(ids)),
                                   Tensor(jnp.asarray(w)),
                                   padding_idx=3)._value)
    wt = torch.tensor(w, requires_grad=True)
    got = F.embedding(torch.tensor(ids), wt, 3)
    np.testing.assert_array_equal(got.detach().numpy(), want)
    got.sum().backward()
    gref = jax.grad(lambda a: jnp.sum(jnp.where(
        (jnp.asarray(ids) == 3)[..., None], 0.0,
        jnp.take(a, jnp.asarray(ids), axis=0))))(jnp.asarray(w))
    np.testing.assert_array_equal(wt.grad.numpy(), np.asarray(gref))
    assert not wt.grad[3].any()
    emb = nn.Embedding(7, 5, padding_idx=2, device="cpu")
    assert not emb.weight[2].any()
    assert not emb(torch.tensor([[2, 2]])).any()
    with pytest.raises(NotImplementedError, match="sparse.*item 1.6"):
        nn.Embedding(7, 5, None, True, device="cpu")
    with pytest.raises(NotImplementedError, match="sparse.*item 1.6"):
        F.embedding(torch.tensor([1]), wt, None, True)


def test_dropout_axis_and_mode():
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.nn import functional as F
    x = torch.randn(6, 40) + 3.0
    g = torch.Generator().manual_seed(0)
    # the third positional argument is axis, as in the reference
    y = F.dropout(x, 0.5, 0, generator=g)
    rows = (y == 0).all(dim=1)
    assert rows.any() and (~rows).any()
    kept = ~rows
    torch.testing.assert_close(y[kept], x[kept] * 2.0)
    y = F.dropout(x, 0.5, [1], training=True, mode="downscale_in_infer",
                  generator=g)
    cols = (y == 0).all(dim=0)
    assert cols.any() and (~cols).any()
    torch.testing.assert_close(y[:, ~cols], x[:, ~cols])
    torch.testing.assert_close(
        F.dropout(x, 0.25, training=False, mode="downscale_in_infer"),
        x * 0.75)
    assert F.dropout(x, 0.25, training=False) is x
    d = nn.Dropout(0.5, None, "downscale_in_infer", generator=g).eval()
    torch.testing.assert_close(d(x), x * 0.5)
    with pytest.raises(ValueError, match="mode"):
        F.dropout(x, 0.5, mode="scale", generator=g)


def test_loss_and_attention_options_refuse():
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.nn import functional as F
    logits, labels = torch.randn(4, 5), torch.tensor([0, 1, 2, 3])
    # the third positional argument is weight, as in the reference
    torch.testing.assert_close(
        F.cross_entropy(logits, labels, None, -100, "sum"),
        torch.nn.functional.cross_entropy(logits, labels, reduction="sum"))
    for kw in (dict(weight=torch.ones(5)), dict(soft_label=True),
               dict(use_softmax=False), dict(label_smoothing=0.1)):
        with pytest.raises(NotImplementedError, match="item 1.6"):
            F.cross_entropy(logits, labels, **kw)
        with pytest.raises(NotImplementedError, match="item 1.6"):
            nn.CrossEntropyLoss(**kw)
    q = torch.randn(1, 8, 2, 16)
    with pytest.raises(NotImplementedError, match="use_flash=False"):
        F.scaled_dot_product_attention(q, q, q, None, 0.0, True, False, False)
    torch.testing.assert_close(
        F.scaled_dot_product_attention(q, q, q, None, 0.0, True, False, True,
                                       None),
        F.scaled_dot_product_attention(q, q, q, is_causal=True,
                                       training=False))


def test_layer_list_engine_and_paged_keywords():
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.hapi import Engine
    from paddle_tpu_torch.nlp.paged_cache import (PagedLayerCache,
                                                  paged_update_and_attend)
    ll = nn.LayerList(sublayers=[nn.ReLU(), nn.Sigmoid(None)])
    assert len(ll) == 2 and len(nn.LayerList()) == 0
    net = nn.Linear(3, 2, device="cpu")
    metric = object()
    # metrics is the fourth positional argument, amp_dtype the fifth
    eng = Engine(net, None, None, [metric], "bfloat16", None, False)
    assert eng.metrics == [metric] and eng.amp_dtype == torch.bfloat16
    with pytest.raises(NotImplementedError, match="use_flash=False"):
        PagedLayerCache(None, None, None, None, use_flash=False)
    # rope_theta is the sixth positional argument, as in the reference
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 1, 2, 64, generator=gen) for _ in range(3))
    pool = torch.randn(2, 2, 16, 64, generator=gen)

    def cache():   # keys at positions 0-2 before the new one at 3
        return PagedLayerCache(pool.clone(), pool.clone(),
                               torch.tensor([[1]], dtype=torch.int32),
                               torch.tensor([3], dtype=torch.int32))
    positional = paged_update_and_attend(q, k, v, cache(), 1, 10000.0)
    keyword = paged_update_and_attend(q, k, v, cache(), groups=1,
                                      rope_theta=10000.0)
    assert torch.equal(positional, keyword)
    assert not torch.equal(positional,
                           paged_update_and_attend(q, k, v, cache(), 1))
    assert nn.Identity("scope", "float32")(net.weight) is net.weight
