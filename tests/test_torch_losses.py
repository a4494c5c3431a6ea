"""rpnet_tpu_torch's loss registry vs the JAX package's, values and gradients.

Every ``LOSS_REGISTRY`` entry on its native contract, and every name through
``make_seg_loss`` on the RP_Net contract ((B, H, W, 2) logits, (B, H, W)
labels), on the same numpy inputs in f32: values to 1e-5 relative and the
gradient with respect to the scores to 1e-5 of its largest entry (sums in
another order). Also ``topk_neg`` and the GHM losses' carried EMA state.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rpnet_tpu.models import losses as J
from rpnet_tpu_torch.models import losses as P

torch.set_num_threads(2)   # small shapes; the suite runs several workers on one machine


def _grad_pair(jfn, pfn, x, *rest):
    """(value, d value / d x) from both packages for x and fixed ``rest``."""
    jv, jg = jax.value_and_grad(lambda a: jfn(a, *[jnp.asarray(r) for r in rest]))(
        jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    pv = pfn(xt, *[torch.from_numpy(r) for r in rest])
    pv.backward()
    return float(jv), np.asarray(jg), float(pv.detach()), xt.grad.numpy()


def _close(jv, jg, pv, pg):
    np.testing.assert_allclose(pv, jv, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(pg, jg, atol=1e-5 * max(np.abs(jg).max(), 1e-6))


def _nc_inputs(seed, n=300, c=3):
    rng = np.random.RandomState(seed)
    pred = rng.randn(n, c).astype(np.float32)
    target = (rng.rand(n, c) > 0.6).astype(np.float32)
    target[:, -1] = 0.0   # one class with empty ground truth
    return pred, target


@pytest.mark.parametrize("name", sorted(J.LOSS_REGISTRY))
def test_registry_entry_matches(name):
    """Each registry function on its own contract."""
    rng = np.random.RandomState(1)
    if name in ("dice_ce", "dice_softmax"):
        logits = rng.randn(2, 6, 7, 3).astype(np.float32)
        labels = rng.randint(0, 3, (2, 6, 7)).astype(np.int32)
        _close(*_grad_pair(J.LOSS_REGISTRY[name], P.LOSS_REGISTRY[name], logits, labels))
    elif name in ("ghm_c", "ghm_dice"):
        pred = rng.randn(500).astype(np.float32)
        if name == "ghm_dice":
            pred = 1 / (1 + np.exp(-pred))
        target = (rng.rand(500) > 0.5).astype(np.float32)
        weight = (rng.rand(500) > 0.1).astype(np.float32)
        _close(*_grad_pair(J.LOSS_REGISTRY[name], P.LOSS_REGISTRY[name], pred, target, weight))
    else:
        pred, target = _nc_inputs(2)
        _close(*_grad_pair(lambda a, t: jnp.sum(J.LOSS_REGISTRY[name](a, t)),
                           lambda a, t: torch.sum(P.LOSS_REGISTRY[name](a, t)),
                           pred, target))


@pytest.mark.parametrize("name", sorted(J.LOSS_REGISTRY) + ["unknown_loss"])
def test_make_seg_loss_matches(name):
    """The RP_Net training contract: 2-way logits, integer labels."""
    rng = np.random.RandomState(3)
    logits = (rng.randn(2, 8, 9, 2) * 2).astype(np.float32)
    labels = (rng.rand(2, 8, 9) > 0.6).astype(np.int32)
    _close(*_grad_pair(J.make_seg_loss(name), P.make_seg_loss(name), logits, labels))


def test_single_channel_dice_and_ignore_index_match():
    rng = np.random.RandomState(4)
    logits = rng.randn(2, 5, 5, 1).astype(np.float32)
    labels = rng.randint(0, 2, (2, 5, 5)).astype(np.int32)
    _close(*_grad_pair(J.dice_loss_softmax, P.dice_loss_softmax, logits, labels))
    logits3 = rng.randn(2, 5, 5, 3).astype(np.float32)
    labels3 = rng.randint(0, 4, (2, 5, 5)).astype(np.int32)   # 3 = ignored
    _close(*_grad_pair(lambda a, t: J.softmax_cross_entropy(a, t, ignore_index=3),
                       lambda a, t: P.softmax_cross_entropy(a, t, ignore_index=3),
                       logits3, labels3))


@pytest.mark.parametrize("name", ["ghm_c", "ghm_dice"])
def test_ghm_momentum_state_matches(name):
    """With momentum the EMA bin counts are carried from call to call."""
    rng = np.random.RandomState(5)
    jacc = pacc = None
    for _ in range(3):
        pred = (1 / (1 + np.exp(-rng.randn(400)))).astype(np.float32)
        target = (rng.rand(400) > 0.5).astype(np.float32)
        w = np.ones(400, np.float32)
        jl, jacc = J.LOSS_REGISTRY[name](jnp.asarray(pred), jnp.asarray(target),
                                         jnp.asarray(w), momentum=0.75, acc_sum=jacc)
        pl, pacc = P.LOSS_REGISTRY[name](torch.from_numpy(pred), torch.from_numpy(target),
                                         torch.from_numpy(w), momentum=0.75, acc_sum=pacc)
        np.testing.assert_allclose(float(pl), float(jl), rtol=1e-5)
        np.testing.assert_allclose(pacc.numpy(), np.asarray(jacc), rtol=1e-6)


def test_topk_neg_matches():
    """The selected entries and their validity; where fewer than base·k
    negatives exist, the overflow entries (weight 0) are not compared."""
    rng = np.random.RandomState(6)
    pred = rng.randn(40).astype(np.float32)
    target = (rng.rand(40) > 0.7).astype(np.float32)
    jp, jt, jw = (np.asarray(a) for a in J.topk_neg(jnp.asarray(pred), jnp.asarray(target),
                                                    k=2, base=5))
    pp, pt, pw = (a.numpy() for a in P.topk_neg(torch.from_numpy(pred),
                                                torch.from_numpy(target), k=2, base=5))
    np.testing.assert_array_equal(pw, jw)
    keep = jw > 0
    np.testing.assert_array_equal(pp[keep], jp[keep])
    np.testing.assert_array_equal(pt[keep], jt[keep])
