"""Metrics (counterpart of paddle_tpu/metric/__init__.py): ``Metric``,
``Accuracy`` (top-k), ``Precision``, ``Recall``, ``Auc`` and
``accuracy``.

As in the reference, the metrics accumulate on the host in numpy: each
``compute`` / ``update`` reads its tensors back from the card (bfloat16
and float16 ones widened to float32, which orders them alike), so a
training loop that updates a metric every step syncs every step.
``Auc``'s ``curve`` is accepted only at its default: the reference never
applies it ("Faults of the reference" 20 in ROADMAP.md).
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device


def _np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype in (torch.bfloat16, torch.float16):
            x = x.float()
        return x.cpu().numpy()
    return np.asarray(x)


class Metric:
    def reset(self):
        raise NotImplementedError

    def update(self, *args):
        raise NotImplementedError

    def accumulate(self):
        raise NotImplementedError

    def name(self):
        return self.__class__.__name__.lower()

    def compute(self, *args):
        return args


class Accuracy(Metric):
    def __init__(self, topk=(1,), name=None):
        self.topk = topk if isinstance(topk, (list, tuple)) else (topk,)
        self._name = name or "acc"
        self.reset()

    def reset(self):
        self.total = [0.0] * len(self.topk)
        self.count = [0] * len(self.topk)

    def compute(self, pred, label):
        pred = _np(pred)
        label = _np(label)
        if label.ndim == pred.ndim and label.shape[-1] > 1:
            label = np.argmax(label, -1)
        label = label.reshape(label.shape[0], -1)
        maxk = max(self.topk)
        idx = np.argsort(-pred, axis=-1)[..., :maxk]
        correct = idx == label[..., :1]
        return correct

    def update(self, correct, *args):
        correct = _np(correct)
        accs = []
        for i, k in enumerate(self.topk):
            num = correct[..., :k].sum()
            self.total[i] += float(num)
            self.count[i] += int(correct.shape[0])
            accs.append(float(num) / max(correct.shape[0], 1))
        return accs[0] if len(accs) == 1 else accs

    def accumulate(self):
        res = [t / max(c, 1) for t, c in zip(self.total, self.count)]
        return res[0] if len(res) == 1 else res

    def name(self):
        return self._name


class Precision(Metric):
    def __init__(self, name=None):
        self._name = name or "precision"
        self.reset()

    def reset(self):
        self.tp = 0
        self.fp = 0

    def update(self, preds, labels):
        p = (_np(preds) > 0.5).astype(np.int32).reshape(-1)
        l = _np(labels).astype(np.int32).reshape(-1)
        self.tp += int(np.sum((p == 1) & (l == 1)))
        self.fp += int(np.sum((p == 1) & (l == 0)))

    def accumulate(self):
        denom = self.tp + self.fp
        return self.tp / denom if denom else 0.0

    def name(self):
        return self._name


class Recall(Metric):
    def __init__(self, name=None):
        self._name = name or "recall"
        self.reset()

    def reset(self):
        self.tp = 0
        self.fn = 0

    def update(self, preds, labels):
        p = (_np(preds) > 0.5).astype(np.int32).reshape(-1)
        l = _np(labels).astype(np.int32).reshape(-1)
        self.tp += int(np.sum((p == 1) & (l == 1)))
        self.fn += int(np.sum((p == 0) & (l == 1)))

    def accumulate(self):
        denom = self.tp + self.fn
        return self.tp / denom if denom else 0.0

    def name(self):
        return self._name


class Auc(Metric):
    """Streaming AUC via thresholded confusion bins (reference
    framework/fleet/metrics.cc distributed AUC uses the same binning)."""

    def __init__(self, curve="ROC", num_thresholds=4095, name=None):
        if curve != "ROC":
            raise NotImplementedError(
                "Auc(curve=%r): the reference accepts it and computes the "
                "ROC AUC whatever it says (\"Faults of the reference\" 20 "
                "in ROADMAP.md)" % (curve,))
        self._name = name or "auc"
        self.num_thresholds = num_thresholds
        self.reset()

    def reset(self):
        self._stat_pos = np.zeros(self.num_thresholds + 1)
        self._stat_neg = np.zeros(self.num_thresholds + 1)

    def update(self, preds, labels):
        preds = _np(preds)
        labels = _np(labels).reshape(-1)
        if preds.ndim == 2 and preds.shape[1] == 2:
            pos_prob = preds[:, 1]
        else:
            pos_prob = preds.reshape(-1)
        idx = np.clip((pos_prob * self.num_thresholds).astype(np.int64), 0,
                      self.num_thresholds)
        for i, l in zip(idx, labels):
            if l:
                self._stat_pos[i] += 1
            else:
                self._stat_neg[i] += 1

    def accumulate(self):
        tot_pos = 0.0
        tot_neg = 0.0
        auc = 0.0
        for i in range(self.num_thresholds, -1, -1):
            p, n = self._stat_pos[i], self._stat_neg[i]
            auc += n * tot_pos + p * n / 2.0
            tot_pos += p
            tot_neg += n
        denom = tot_pos * tot_neg
        return auc / denom if denom else 0.0

    def name(self):
        return self._name


def accuracy(input, label, k=1):
    """The top-``k`` accuracy as a float32 scalar tensor on ``input``'s
    device (the card for numpy input)."""
    pred = _np(input)
    lbl = _np(label).reshape(-1)
    idx = np.argsort(-pred, axis=-1)[:, :k]
    correct = (idx == lbl[:, None]).any(axis=1)
    device = input.device if isinstance(input, torch.Tensor) \
        else resolve_device(None)
    return torch.tensor(float(correct.mean()), dtype=torch.float32,
                        device=device)


__all__ = ["Metric", "Accuracy", "Precision", "Recall", "Auc", "accuracy"]
