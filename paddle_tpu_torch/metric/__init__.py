"""Metrics of the port (counterpart of ``paddle_tpu/metric``, ref:
python/paddle/metric/metrics.py).

A copy of the reference over numpy on the host, with one change where the
data lives on the card: ``Accuracy.compute`` of a torch tensor takes the
top k on the tensor's device (``torch.topk``) and returns the ``[B, k]``
hit matrix there, so ``update`` brings back ``B * k`` values, not the
whole ``[B, classes]`` array the reference argsorts on the host. Without
ties among the top k scores the counts equal the reference's.
"""
from __future__ import annotations

import numpy as np

import torch

__all__ = ["Metric", "Accuracy", "Precision", "Recall", "Auc", "accuracy"]


def _np(x):
    if torch.is_tensor(x):
        x = x.detach()
        return (x.float() if x.dtype == torch.bfloat16 else x).cpu().numpy()
    return np.asarray(x)


class Metric:
    def __init__(self):
        pass

    def reset(self):
        raise NotImplementedError

    def update(self, *args):
        raise NotImplementedError

    def accumulate(self):
        raise NotImplementedError

    def name(self):
        raise NotImplementedError

    def compute(self, *args):
        return args


class Accuracy(Metric):
    def __init__(self, topk=(1,), name=None, *args, **kwargs):
        super().__init__()
        self.topk = topk if isinstance(topk, (tuple, list)) else (topk,)
        self.maxk = max(self.topk)
        self._name = name or "acc"
        self.reset()

    def compute(self, pred, label, *args):
        if torch.is_tensor(pred):
            p = pred.detach()
            lab = torch.as_tensor(label, device=p.device)
            idx = torch.topk(p, min(self.maxk, p.shape[-1]), dim=-1).indices
            if lab.dim() == p.dim() and lab.shape[-1] == 1:
                lab = lab[..., 0]
            return (idx == lab[..., None]).float()
        p = _np(pred)
        l = _np(label)
        idx = np.argsort(-p, axis=-1)[..., : self.maxk]
        if l.ndim == p.ndim and l.shape[-1] == 1:
            l = l[..., 0]
        correct = idx == l[..., None]
        return correct.astype(np.float32)

    def update(self, correct, *args):
        c = _np(correct)
        accs = []
        for k in self.topk:
            num = c[..., :k].sum()
            accs.append(num)
        total = int(np.prod(c.shape[:-1]))
        self.total = [t + a for t, a in zip(self.total, accs)]
        self.count = [c_ + total for c_ in self.count]
        return [t / max(c_, 1) for t, c_ in zip(self.total, self.count)]

    def reset(self):
        self.total = [0.0] * len(self.topk)
        self.count = [0] * len(self.topk)

    def accumulate(self):
        res = [t / max(c, 1) for t, c in zip(self.total, self.count)]
        return res[0] if len(res) == 1 else res

    def name(self):
        if len(self.topk) == 1:
            return [self._name]
        return [f"{self._name}_top{k}" for k in self.topk]


class Precision(Metric):
    def __init__(self, name="precision", *args, **kwargs):
        super().__init__()
        self._name = name
        self.reset()

    def update(self, preds, labels):
        p = (_np(preds) > 0.5).astype(np.int64).reshape(-1)
        l = _np(labels).astype(np.int64).reshape(-1)
        self.tp += int(((p == 1) & (l == 1)).sum())
        self.fp += int(((p == 1) & (l == 0)).sum())

    def reset(self):
        self.tp = 0
        self.fp = 0

    def accumulate(self):
        denom = self.tp + self.fp
        return self.tp / denom if denom else 0.0

    def name(self):
        return self._name


class Recall(Metric):
    def __init__(self, name="recall", *args, **kwargs):
        super().__init__()
        self._name = name
        self.reset()

    def update(self, preds, labels):
        p = (_np(preds) > 0.5).astype(np.int64).reshape(-1)
        l = _np(labels).astype(np.int64).reshape(-1)
        self.tp += int(((p == 1) & (l == 1)).sum())
        self.fn += int(((p == 0) & (l == 1)).sum())

    def reset(self):
        self.tp = 0
        self.fn = 0

    def accumulate(self):
        denom = self.tp + self.fn
        return self.tp / denom if denom else 0.0

    def name(self):
        return self._name


class Auc(Metric):
    def __init__(self, curve="ROC", num_thresholds=4095, name="auc", *args,
                 **kwargs):
        super().__init__()
        self.num_thresholds = num_thresholds
        self._name = name
        self.reset()

    def update(self, preds, labels):
        p = _np(preds)
        if p.ndim == 2 and p.shape[1] == 2:
            p = p[:, 1]
        l = _np(labels).reshape(-1)
        bins = np.clip((p.reshape(-1) * self.num_thresholds).astype(np.int64),
                       0, self.num_thresholds)
        for b, y in zip(bins, l):
            if y:
                self._stat_pos[b] += 1
            else:
                self._stat_neg[b] += 1

    def reset(self):
        self._stat_pos = np.zeros(self.num_thresholds + 1)
        self._stat_neg = np.zeros(self.num_thresholds + 1)

    def accumulate(self):
        tot_pos = self._stat_pos.sum()
        tot_neg = self._stat_neg.sum()
        if not tot_pos or not tot_neg:
            return 0.0
        # trapezoidal AUC over thresholds (descending), anchored at (0,0)
        pos = np.concatenate([[0.0], self._stat_pos[::-1].cumsum()])
        neg = np.concatenate([[0.0], self._stat_neg[::-1].cumsum()])
        tpr = pos / tot_pos
        fpr = neg / tot_neg
        return float(np.trapezoid(tpr, fpr))

    def name(self):
        return self._name


def accuracy(input, label, k=1, correct=None, total=None, name=None):
    p = _np(input)
    l = _np(label).reshape(-1)
    idx = np.argsort(-p, axis=-1)[:, :k]
    correct_ = (idx == l[:, None]).any(axis=1).mean()
    return torch.tensor(np.float32(correct_))
