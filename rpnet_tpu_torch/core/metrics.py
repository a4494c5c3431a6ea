"""Segmentation and registration metrics.

The counterparts of ``rpnet_tpu/core/metrics.py``:
  * ``dice_score`` / ``dice_score_seperate`` — the host metrics, numpy, the
    reference's conventions (utils/util.py:365-390: rounded to ``decimal``,
    None for a class with empty ground truth);
  * ``dice`` — ``dice_jax``: Dice over the whole array with optional slice
    weights, returned with a ``valid`` flag (False for empty ground truth,
    where the host metric returns None);
  * ``ncc`` — negative normalized cross-correlation
    (net/registration.py:157-160), global or per slice, optionally over
    weighted elements only;
  * ``mse`` (net/registration.py:147-154) and ``precision_and_recall``
    (utils/util.py:393-403, numpy).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch


def dice_score(y_pred, y_true, num_class: int = 1, decimal: int = 4) -> List[Optional[float]]:
    """Dice of each label value i in 0..num_class-1 (utils/util.py:365-376)."""
    res: List[Optional[float]] = []
    for i in range(num_class):
        target = y_true == i
        pred = y_pred == i
        if target.sum():
            score = 2 * (target * pred).sum() / float(target.sum() + pred.sum())
            res.append(round(score, decimal))
        else:
            res.append(None)
    return res


def dice_score_seperate(y_pred, y_true, num_class: int = 1,
                        decimal: int = 4) -> List[Optional[float]]:
    """Per-channel Dice; channel i of pred vs channel i of truth
    (utils/util.py:379-390)."""
    res: List[Optional[float]] = []
    for i in range(num_class):
        target = y_true[i]
        pred = y_pred[i]
        if target.sum():
            score = 2 * (target * pred).sum() / float(target.sum() + pred.sum())
            res.append(round(score, decimal))
        else:
            res.append(None)
    return res


def dice(pred, target, weight=None):
    """Dice over the full array → (dice, valid), both 0-d tensors.

    ``weight`` (leading axes of pred, 1 = real slice, 0 = excluded)
    broadcasts over the trailing axes."""
    pred = pred.float()
    target = target.float()
    if weight is not None:
        w = weight.float().reshape(weight.shape + (1,) * (pred.dim() - weight.dim()))
        pred = pred * w
        target = target * w
    inter = torch.sum(pred * target)
    tsum = torch.sum(target)
    psum = torch.sum(pred)
    return 2.0 * inter / torch.clamp(tsum + psum, min=1e-12), tsum > 0


def mse(y_pred, y_true):
    """Mean squared error (net/registration.py:147-154, mask=None path)."""
    return torch.mean((y_true - y_pred) ** 2)


def ncc(moving, fixed, weight=None, dims=None):
    """Negative NCC over the axes ``dims`` (default: all, one global NCC;
    ``(1, 2, 3)`` gives one per slice of an (S, H, W, C) batch); with
    ``weight`` (broadcastable 0/1), means and variances run over the
    weighted elements only."""
    if dims is None:
        dims = tuple(range(fixed.dim()))
    if weight is None:
        fc = fixed - fixed.mean(dim=dims, keepdim=True)
        mc = moving - moving.mean(dim=dims, keepdim=True)
    else:
        w = torch.broadcast_to(weight, fixed.shape).to(fixed.dtype)
        n = torch.clamp(w.sum(dim=dims, keepdim=True), min=1.0)
        fc = (fixed - (fixed * w).sum(dim=dims, keepdim=True) / n) * w
        mc = (moving - (moving * w).sum(dim=dims, keepdim=True) / n) * w
    num = torch.sum(fc * mc, dim=dims)
    den = torch.sqrt(torch.sum(fc ** 2, dim=dims) * torch.sum(mc ** 2, dim=dims) + 1e-10)
    return -1.0 * num / den


def precision_and_recall(label_gt, label_pred, n_class: int):
    """Per-class precision/recall (utils/util.py:393-403) without sklearn."""
    gt = np.asarray(label_gt, dtype=np.int64).ravel()
    pr = np.asarray(label_pred, dtype=np.int64).ravel()
    precision = np.zeros(n_class, dtype=np.float32)
    recall = np.zeros(n_class, dtype=np.float32)
    for c in range(n_class):
        tp = np.sum((pr == c) & (gt == c))
        precision[c] = tp / max(np.sum(pr == c), 1)
        recall[c] = tp / max(np.sum(gt == c), 1)
    return precision, recall
