"""Loss zoo (net/rp_net.py:87-127 and net/unet.py:39-348).

The port's copy of ``rpnet_tpu/models/losses.py``, the whole registry, in
PyTorch on channels-last tensors. The JAX package's vectorized forms of the
reference's loops (GHM bin loops, ``g0.sum() == 0`` zeroing, top-k slicing)
are kept as they are, so both packages give the same values and gradients.
Integer labels may come as any integer or float dtype holding class ids.
"""

from __future__ import annotations

from typing import Optional

import torch


def one_hot(labels: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """One-hot over a new last axis, as ``jax.nn.one_hot`` (an id outside
    0..n-1 gives zeros). Unlike ``F.one_hot`` it does not check its ids on
    the host, so it never waits for the device."""
    classes = torch.arange(n, device=labels.device)
    return (labels.long()[..., None] == classes).to(dtype)


def softmax_cross_entropy(logits, labels, ignore_index: Optional[int] = None):
    """torch F.cross_entropy on (B, H, W, C) logits / (B, H, W) int labels."""
    logp = torch.log_softmax(logits, dim=-1)
    labels = labels.long()
    if ignore_index is not None:
        valid = labels != ignore_index
        safe = torch.where(valid, labels, torch.zeros_like(labels))
        nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
        return torch.sum(nll * valid) / torch.clamp(torch.sum(valid), min=1)
    nll = -torch.gather(logp, -1, labels[..., None])[..., 0]
    return torch.mean(nll)


def dice_loss_softmax(logits, true, eps: float = 1e-7):
    """Sørensen–Dice loss (dice_loss_softmax, net/rp_net.py:87-120).

    logits (B, H, W, C); true (B, H, W) integer labels. C > 1: softmax
    probabilities vs one-hot, dice per class averaged; C == 1: the
    reference's sigmoid path with its swapped one-hot channels.
    """
    num_classes = logits.shape[-1]
    if num_classes == 1:
        pos = torch.sigmoid(logits[..., 0])
        probas = torch.stack([pos, 1.0 - pos], dim=-1)
        t = one_hot(true, 2, logits.dtype)
        true_1_hot = torch.stack([t[..., 1], t[..., 0]], dim=-1)
    else:
        probas = torch.softmax(logits, dim=-1)
        true_1_hot = one_hot(true, num_classes, logits.dtype)
    dims = (0, 1, 2)
    intersection = torch.sum(probas * true_1_hot, dim=dims)
    cardinality = torch.sum(probas + true_1_hot, dim=dims)
    dice = torch.mean(2.0 * intersection / (cardinality + eps))
    return 1.0 - dice


def dice_ce(logits, true, eps: float = 1e-7):
    """dice + cross-entropy (dice_ce, net/rp_net.py:123-127), the YAML's
    default training loss (example.yml:115)."""
    return dice_loss_softmax(logits, true, eps) + softmax_cross_entropy(logits, true)


def dice_loss_per_class(pred, target):
    """Per-class sigmoid Tversky-style dice (dice_loss, net/unet.py:191-213).

    pred, target (N, C) → (C,) per-class losses; classes with empty ground
    truth contribute 0.
    """
    p0 = torch.sigmoid(pred)
    g0 = target
    num = torch.sum(p0 * g0, dim=0)
    den = num + 0.5 * torch.sum(p0 * (1 - g0), dim=0) + 0.5 * torch.sum((1 - p0) * g0, dim=0)
    loss = 1.0 - num / (den + 1e-5)
    nonempty = (torch.sum(g0, dim=0) > 0).to(pred.dtype)
    return loss * nonempty


def binary_dice_loss(pred, target):
    """Foreground + background dice (binary_dice_loss, net/unet.py:216-249)."""
    p0 = torch.sigmoid(pred)
    g0 = target
    num = torch.sum(p0 * g0, dim=0)
    den = torch.sum(p0, dim=0) + torch.sum(g0, dim=0) + 1e-5
    loss_fore = 1.0 - num / (den + 1e-5)
    loss_back = -torch.sum((1 - p0) * (1 - g0), dim=0) / (
        torch.sum(1 - p0, dim=0) + torch.sum(1 - g0, dim=0) + 1e-5)
    loss = loss_fore + loss_back
    nonempty = (torch.sum(g0, dim=0) > 0).to(pred.dtype)
    return loss * nonempty


def nll_neg_bootstrap_loss(p, g):
    """Bootstrapped negative log-likelihood (net/unet.py:341-348). The
    reference sigmoids its input a second time (its caller already applied
    sigmoid); kept."""
    p = torch.sigmoid(p)
    return -torch.mean((1 - g) * torch.log(torch.clamp(1 - p, min=1e-8)))


def dice_loss_bootstrap(pred, target):
    """dice + bootstrapped negative loss (net/unet.py:312-338); (N, C) → (C,)."""
    p0 = torch.sigmoid(pred)
    g0 = target
    num = torch.sum(p0 * g0, dim=0)
    den = num + 0.5 * torch.sum(p0 * (1 - g0), dim=0) + 0.5 * torch.sum((1 - p0) * g0, dim=0)
    dice = (1.0 - num / (den + 1e-5)) * (torch.sum(g0, dim=0) > 0)
    neg = torch.stack([nll_neg_bootstrap_loss(p0[:, c], g0[:, c])
                       for c in range(p0.shape[1])])
    return dice + neg


def _ghm_bin_weights(g, valid, bins, dtype, momentum, acc_sum):
    """GHM binning: gradient-length histogram → per-element weights.

    momentum > 0 keeps an EMA of bin counts (net/unet.py:99-104): bins seen
    this step update ``acc = mmt·acc + (1−mmt)·count`` and weight by the
    updated acc; unseen bins keep their old acc. Returns
    (weights, tot, new_acc_sum). No gradient flows through the weights.
    """
    valid_f = valid.to(dtype)
    tot = torch.clamp(torch.sum(valid_f), min=1.0)
    edges = torch.arange(bins + 1, dtype=dtype, device=g.device) / bins
    edges[-1] += 1e-6
    idx = torch.clamp(torch.searchsorted(edges, g.detach(), right=True) - 1, 0, bins - 1)
    counts = torch.zeros((bins,), dtype=dtype, device=g.device).index_add_(0, idx, valid_f)
    n_valid_bins = torch.sum(counts > 0)
    zero = torch.zeros((), dtype=dtype, device=g.device)
    if momentum > 0:
        if acc_sum is None:
            acc_sum = torch.zeros((bins,), dtype=dtype, device=g.device)
        new_acc = torch.where(counts > 0, momentum * acc_sum + (1 - momentum) * counts,
                              acc_sum)
        w_per_bin = torch.where(counts > 0, tot / torch.clamp(new_acc, min=1e-12), zero)
    else:
        new_acc = acc_sum
        w_per_bin = torch.where(counts > 0, tot / torch.clamp(counts, min=1.0), zero)
    weights = w_per_bin[idx] * valid_f / torch.clamp(n_valid_bins, min=1)
    return weights, tot, new_acc


def ghm_c_loss(pred, target, label_weight, bins: int = 10,
               loss_weight: float = 1.0, momentum: float = 0.0, acc_sum=None):
    """Gradient-harmonized BCE (GHMC, net/unet.py:39-111).

    With momentum > 0 the EMA bin counts are carried state: returns
    (loss, new_acc_sum) instead of loss.
    """
    pred = pred.reshape(-1)
    target = target.reshape(-1).to(pred.dtype)
    valid = label_weight.reshape(-1) > 0
    g = torch.abs(torch.sigmoid(pred) - target)
    weights, tot, new_acc = _ghm_bin_weights(g, valid, bins, pred.dtype,
                                             momentum, acc_sum)
    bce = torch.clamp(pred, min=0) - pred * target + torch.log1p(torch.exp(-torch.abs(pred)))
    loss = torch.sum(bce * weights) / tot * loss_weight
    return (loss, new_acc) if momentum > 0 else loss


def ghm_dice_loss(pred, target, label_weight, bins: int = 10,
                  loss_weight: float = 1.0, momentum: float = 0.0, acc_sum=None):
    """Gradient-harmonized dice (GHMDice, net/unet.py:114-188); momentum > 0
    carries EMA bin counts as :func:`ghm_c_loss` does."""
    pred = pred.reshape(-1)
    target = target.reshape(-1).to(pred.dtype)
    valid = label_weight.reshape(-1) > 0
    I = torch.sum(pred * target)
    S = torch.sum(pred) + torch.sum(target)
    g = torch.abs(2 * I / S * pred.detach() - target)
    weights, tot, new_acc = _ghm_bin_weights(g, valid, bins, pred.dtype,
                                             momentum, acc_sum)
    loss = (1.0 - torch.sum(2 * pred * target * weights) / S) * loss_weight
    return (loss, new_acc) if momentum > 0 else loss


# the reference's topk_dice_loss (net/unet.py:252-285) is a verbatim duplicate
# of binary_dice_loss (its topk_neg pruning is commented out)
topk_dice_loss = binary_dice_loss


def topk_neg(pred, target, k: int = 5, base: int = 1000):
    """Hard-negative/positive selection (topk_neg, net/unet.py:288-309): the
    base·k highest-scoring negatives and the base lowest positives. Where
    fewer exist, the overflow entries get weight 0: returns
    (pred, target, weight)."""
    pred = pred.reshape(-1)
    target = target.reshape(-1)
    inf = torch.tensor(float("inf"), dtype=pred.dtype, device=pred.device)
    neg_scores = torch.where(target == 0, pred, -inf)
    pos_scores = torch.where(target == 1, pred, inf)
    n = pred.shape[0]
    neg_vals, neg_idx = torch.topk(neg_scores, min(int(base * k), n))
    pos_vals, pos_idx = torch.topk(-pos_scores, min(base, n))
    keep = torch.cat([pos_idx, neg_idx])
    valid = torch.cat([torch.isfinite(pos_vals), torch.isfinite(neg_vals)])
    return pred[keep], target[keep], valid.to(pred.dtype)


LOSS_REGISTRY = {
    "dice_ce": dice_ce,
    "dice_softmax": dice_loss_softmax,
    "dice": dice_loss_per_class,
    "binary_dice": binary_dice_loss,
    "dice_bootstrap": dice_loss_bootstrap,
    "ghm_c": ghm_c_loss,
    "ghm_dice": ghm_dice_loss,
}


def make_seg_loss(name: str):
    """Adapt any registry loss to the RP_Net training contract:
    (B, H, W, 2) softmax logits + (B, H, W) int labels → scalar.

    The per-class and binary losses take (N, C) sigmoid scores; for a 2-way
    softmax the equivalent binary logit is ``logits[..., 1] − logits[..., 0]``.
    GHM losses get an all-ones validity weight. An unknown name falls back
    to dice_ce, as in the JAX package.
    """
    if name not in LOSS_REGISTRY and name is not None:
        print(f"[loss {name!r} unknown — falling back to dice_ce]")
        return dice_ce
    fn = LOSS_REGISTRY.get(name, dice_ce)
    if name in ("dice_ce", "dice_softmax", None):
        return fn

    def adapted(logits, labels):
        score = (logits[..., 1] - logits[..., 0]).reshape(-1, 1)
        target = labels.to(logits.dtype).reshape(-1, 1)
        if name in ("ghm_c", "ghm_dice"):
            pred = score[:, 0] if name == "ghm_c" else torch.sigmoid(score[:, 0])
            return fn(pred, target[:, 0], torch.ones_like(target[:, 0]))
        return torch.sum(fn(score, target))        # per-class vector → scalar
    return adapted
