"""Demons (dense deformable) registration with diffeomorphic integration.

The counterpart of ``rpnet_tpu/registration/demons.py`` (the reference's
``DemonsRegistration`` + ``Diffeomorphic``, net/registration.py:190-312),
batched over slices: a dense flow (S, H, W, 2), channels (x, y) in
normalized coordinates, is integrated by scaling and squaring and warps
``grid_sample(x, grid + flow)``. The fit takes ``iters`` Adam steps on the
negative NCC, then smooths the raw flow with a Gaussian (no gradient
through the smoothing), in that order.

The S slices are fitted together. The loss is the SUM of per-slice NCCs,
so each slice's gradient is its own; Adam is elementwise and the blur is
per slice, so the batched fit is S separate fits. A global NCC over the
batch would couple them.

Conventions kept from the reference (do NOT "fix"): the identity grid is
built with (S-1) denominators (``compute_grid``) but sampled with
align_corners=False (net/registration.py:258); every integration step is
``grid_sample(d, grid + d)``.
"""

from __future__ import annotations

from typing import Sequence

import torch

from rpnet_tpu_torch.core.metrics import ncc
from rpnet_tpu_torch.ops.sampling import compute_grid, grid_sample
from rpnet_tpu_torch.registration.affine import adam_update
from rpnet_tpu_torch.registration.gaussian import gaussian_blur_flow


def zero_flow(n: int, img_size, dtype=torch.float32, device=None):
    H, W = img_size
    return torch.zeros((n, H, W, 2), dtype=dtype, device=device)


def identity_grid(img_size, dtype=torch.float32, device=None):
    """The reference's identity grid as (H, W, 2), channels (x, y)."""
    return compute_grid(img_size, dtype, device)[0].permute(1, 2, 0)


def diffeomorphic_2d(displacement, grid, scaling: int = 10):
    """Scaling and squaring (net/registration.py:202-211), straight-line
    code: displacement (S, H, W, 2), grid (H, W, 2) → the integrated
    displacement (S, H, W, 2)."""
    d = displacement / (2.0 ** scaling)
    for _ in range(scaling):
        d = d + grid_sample(d, d + grid, align_corners=False)
    return d


def demons_warp(x, flow, grid, scaling: int = 10):
    """Warp x (S, H, W, C) by the integrated ``flow`` (S, H, W, 2)."""
    return grid_sample(x, grid + diffeomorphic_2d(flow, grid, scaling),
                       align_corners=False)


def fit_demons(moving, fixed, iters: int, lr: float = 0.01,
               sigma: Sequence[float] = (2.0, 2.0), scaling: int = 10):
    """Fit the dense flow. moving/fixed: (S, H, W, C) → (flow (S, H, W, 2),
    losses (iters, S)).

    Step order of DemonsRegistration.train_registraion
    (net/registration.py:291-312): loss at the current flow → Adam update →
    Gaussian smoothing of the raw flow parameter.
    """
    S, H, W, _ = moving.shape
    grid = identity_grid((H, W), moving.dtype, moving.device)
    flow = zero_flow(S, (H, W), moving.dtype, moving.device)
    mu = torch.zeros_like(flow)
    nu = torch.zeros_like(flow)
    losses = []
    with torch.enable_grad():
        for t in range(1, iters + 1):
            f = flow.detach().requires_grad_(True)
            per_slice = ncc(demons_warp(moving, f, grid, scaling), fixed, dims=(1, 2, 3))
            (g,) = torch.autograd.grad(per_slice.sum(), f)
            losses.append(per_slice.detach())
            flow, mu, nu = adam_update(flow, g, mu, nu, t, lr)
            flow = gaussian_blur_flow(flow, sigma)
    losses = torch.stack(losses) if losses else moving.new_zeros((0, S))
    return flow.detach(), losses
