"""``paddle.metric``: the counterpart of ``paddle_tpu/metric/__init__.py``
— ``Metric``, ``Accuracy`` (:31), ``Precision``, ``Recall``, ``Auc`` and
``accuracy`` (:167). The metrics accumulate on the host in numpy, as in
JAX: a tensor argument is read back (``.cpu()``) once per call.
"""

from __future__ import annotations

import numpy as np
import torch


def _np(v):
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


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
    """Top-k accuracy for each k of `topk`: ``compute`` gives the
    [N, max k] hits of the ranked predictions, ``update`` the batch's
    accuracies, ``accumulate`` the running ones."""

    def __init__(self, topk=(1,), name=None):
        super().__init__()
        self.topk = topk if isinstance(topk, (list, tuple)) else (topk,)
        self.maxk = max(self.topk)
        self._name = name or "acc"
        self.reset()

    def compute(self, pred, label, *args):
        pred_np, label_np = _np(pred), _np(label)
        if label_np.ndim == pred_np.ndim and label_np.shape[-1] == 1:
            label_np = label_np[..., 0]
        topk_idx = np.argsort(-pred_np, axis=-1)[..., :self.maxk]
        return topk_idx == label_np[..., None]

    def update(self, correct, *args):
        correct = _np(correct)
        accs = []
        num = correct.shape[0] if correct.ndim else 1
        for i, k in enumerate(self.topk):
            c = float(correct[..., :k].sum())
            accs.append(c / max(num, 1))
            self.total[i] += c
            self.count[i] += num
        return accs[0] if len(accs) == 1 else accs

    def reset(self):
        self.total = [0.0] * len(self.topk)
        self.count = [0] * len(self.topk)

    def accumulate(self):
        res = [t / max(c, 1) for t, c in zip(self.total, self.count)]
        return res[0] if len(res) == 1 else res

    def name(self):
        if len(self.topk) == 1:
            return self._name
        return [f"{self._name}_top{k}" for k in self.topk]


class Precision(Metric):
    """Binary precision at threshold 0.5."""

    def __init__(self, name="precision"):
        super().__init__()
        self._name = name
        self.reset()

    def update(self, preds, labels):
        pred_cls = (_np(preds) > 0.5).astype(int).reshape(-1)
        labels = _np(labels).astype(int).reshape(-1)
        self.tp += int(((pred_cls == 1) & (labels == 1)).sum())
        self.fp += int(((pred_cls == 1) & (labels == 0)).sum())

    def reset(self):
        self.tp = 0
        self.fp = 0

    def accumulate(self):
        return self.tp / max(self.tp + self.fp, 1)

    def name(self):
        return self._name


class Recall(Metric):
    """Binary recall at threshold 0.5."""

    def __init__(self, name="recall"):
        super().__init__()
        self._name = name
        self.reset()

    def update(self, preds, labels):
        pred_cls = (_np(preds) > 0.5).astype(int).reshape(-1)
        labels = _np(labels).astype(int).reshape(-1)
        self.tp += int(((pred_cls == 1) & (labels == 1)).sum())
        self.fn += int(((pred_cls == 0) & (labels == 1)).sum())

    def reset(self):
        self.tp = 0
        self.fn = 0

    def accumulate(self):
        return self.tp / max(self.tp + self.fn, 1)

    def name(self):
        return self._name


class Auc(Metric):
    """ROC AUC from num_thresholds bins of the positive-class score."""

    def __init__(self, curve="ROC", num_thresholds=4095, name="auc"):
        super().__init__()
        self.num_thresholds = num_thresholds
        self._name = name
        self.reset()

    def update(self, preds, labels):
        preds, labels = _np(preds), _np(labels)
        if preds.ndim == 2:
            preds = preds[:, 1]
        preds = preds.reshape(-1)
        labels = labels.reshape(-1)
        bins = np.clip((preds * self.num_thresholds).astype(int), 0,
                       self.num_thresholds - 1)
        for b, lab in zip(bins, labels):
            if lab:
                self._stat_pos[b] += 1
            else:
                self._stat_neg[b] += 1

    def reset(self):
        self._stat_pos = np.zeros(self.num_thresholds)
        self._stat_neg = np.zeros(self.num_thresholds)

    def accumulate(self):
        tot_pos = self._stat_pos.sum()
        tot_neg = self._stat_neg.sum()
        if tot_pos == 0 or tot_neg == 0:
            return 0.0
        # integrate TPR over FPR from the highest threshold down
        tpr = self._stat_pos[::-1].cumsum() / tot_pos
        fpr = self._stat_neg[::-1].cumsum() / tot_neg
        trapezoid = getattr(np, "trapezoid", None) or np.trapz
        return float(trapezoid(tpr, fpr))

    def name(self):
        return self._name


def accuracy(input, label, k=1):  # noqa: A002
    """The share of rows whose label is among the top k predictions, a
    0-dim float32 tensor on the input's device."""
    pred, lbl = _np(input), _np(label)
    if lbl.ndim == 2 and lbl.shape[1] == 1:
        lbl = lbl[:, 0]
    topk = np.argsort(-pred, axis=-1)[:, :k]
    correct = (topk == lbl[:, None]).any(1).mean()
    dev = input.device if isinstance(input, torch.Tensor) else None
    return torch.tensor(float(correct), dtype=torch.float32, device=dev)
