"""Affine registration as a batched Adam fit (net/registration.py:316-357).

The counterpart of ``rpnet_tpu/registration/affine.py``: a 2×3 theta per
slice warps the moving image through ``F.affine_grid`` + ``F.grid_sample``
(both align_corners=False, the torch defaults) and is fitted by ``iters``
Adam steps on the MSE. The S slices of an episode are fitted together: the
loss is the SUM of the per-slice means, so each slice's gradient is its own,
and Adam is elementwise, so each slice follows its own trajectory (the
reference runs one fit per slice, dataset/few_shot_reader.py:122-162).
"""

from __future__ import annotations

import torch

from rpnet_tpu_torch.ops.sampling import affine_grid, grid_sample


def affine_warp(x, theta):
    """Warp x (S, H, W, C) by theta (S, 2, 3) → (S, H, W, C)."""
    S, H, W, C = x.shape
    grid = affine_grid(theta, (S, C, H, W), align_corners=False)
    return grid_sample(x, grid, align_corners=False)


ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8   # torch.optim.Adam defaults


def fit_affine(moving, fixed, iters: int = 50, lr: float = 0.01):
    """Fit theta by Adam. moving/fixed: (S, H, W, C) → (theta (S, 2, 3),
    losses (iters, S)).

    torch.optim.Adam's defaults and update order (dataset/few_shot_reader.py:148):
    the loss recorded at step i is evaluated at theta_i before the update.
    The update is written out in optax's form, as the JAX package runs it.
    """
    S = moving.shape[0]
    theta = torch.tensor([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]], dtype=moving.dtype,
                         device=moving.device).repeat(S, 1, 1)
    mu = torch.zeros_like(theta)
    nu = torch.zeros_like(theta)
    losses = []
    with torch.enable_grad():
        for t in range(1, iters + 1):
            th = theta.detach().requires_grad_(True)
            per_slice = torch.mean((fixed - affine_warp(moving, th)) ** 2, dim=(1, 2, 3))
            (g,) = torch.autograd.grad(per_slice.sum(), th)
            losses.append(per_slice.detach())
            mu = (1 - ADAM_B1) * g + ADAM_B1 * mu
            nu = (1 - ADAM_B2) * g * g + ADAM_B2 * nu
            mu_hat = mu / (1 - ADAM_B1 ** t)
            nu_hat = nu / (1 - ADAM_B2 ** t)
            theta = theta - lr * (mu_hat / (torch.sqrt(nu_hat) + ADAM_EPS))
    return theta.detach(), torch.stack(losses)
