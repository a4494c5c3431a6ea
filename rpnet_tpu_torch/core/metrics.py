"""Segmentation and registration metrics as torch functions.

The counterparts of ``rpnet_tpu/core/metrics.py``'s device metrics:
  * ``dice`` — ``dice_jax``: Dice over the whole array with optional slice
    weights, returned with a ``valid`` flag (False for empty ground truth,
    where the reference's host metric returns None, utils/util.py:388-389);
  * ``ncc`` — negative global normalized cross-correlation
    (net/registration.py:157-160), optionally over weighted elements only.
"""

from __future__ import annotations

import torch


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


def ncc(moving, fixed, weight=None):
    """Negative global NCC; with ``weight`` (broadcastable 0/1), means and
    variances run over the weighted elements only."""
    if weight is None:
        fc = fixed - fixed.mean()
        mc = moving - moving.mean()
    else:
        w = torch.broadcast_to(weight, fixed.shape).to(fixed.dtype)
        n = torch.clamp(w.sum(), min=1.0)
        fc = (fixed - (fixed * w).sum() / n) * w
        mc = (moving - (moving * w).sum() / n) * w
    num = torch.sum(fc * mc)
    den = torch.sqrt(torch.sum(fc ** 2) * torch.sum(mc ** 2) + 1e-10)
    return -1.0 * num / den
