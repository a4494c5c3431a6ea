"""DEEDS-style discrete displacement registration (net/registration.py:360-524).

The counterpart of ``rpnet_tpu/registration/deeds.py``, batched over slices.
Single shot, no gradient descent: a cost volume of displacement_width²
candidate shifts on a coarse control grid, an approximate min-convolution
by max and average pools, one mean-field pass over the grid, a second
min-convolution of the re-weighted cost, then a soft-argmin over the shifts
gives a dense sampling grid. No path of either package calls it.
"""

from __future__ import annotations

import torch

from rpnet_tpu_torch.ops.sampling import (affine_grid, avg_pool2d, grid_sample,
                                          interpolate_bilinear, max_pool2d,
                                          replication_pad2d)
from rpnet_tpu_torch.registration.affine import affine_warp, fit_affine

# learnable-in-principle weights, fixed init in the reference (registration.py:369)
DEFAULT_ALPHA = (1.0, 0.1, 1.0, 0.0, 0.1, 10.0)


def _min_conv(cost):
    """avg1(avg1(-max1(-pad1(cost)))) — approximate min-convolution."""
    c = replication_pad2d(cost, 3)
    c = -max_pool2d(-c, 3, 1)
    return avg_pool2d(avg_pool2d(c, 3, 1), 3, 1)


def _grid_mean(cost, n: int, grid_size: int, dw: int):
    """Average of each shift's cost over the 5×5 control-grid neighbourhood
    (two 3×3 means, replication padded) → (n·g², dw, dw, 1)."""
    c = cost.reshape(n, grid_size, grid_size, dw * dw)
    c = avg_pool2d(avg_pool2d(replication_pad2d(c, 2), 3, 1), 3, 1)
    return c.reshape(-1, dw, dw, 1)


def deeds_fit(moving, fixed, grid_size: int = 128, disp_range: float = 0.1,
              displacement_width: int = 15, alpha=DEFAULT_ALPHA, mode: str = "nearest"):
    """The dense sampling grid registering moving→fixed.

    moving/fixed: (N, H, W, 1). Returns the sample grid (N, H, W, 2) for
    :func:`deeds_warp`."""
    N, H, W, _ = moving.shape
    a0, a1, a2, a3, a4, a5 = (float(a) for a in alpha)
    g, dw = grid_size, displacement_width
    eye = torch.eye(2, 3, dtype=moving.dtype, device=moving.device)[None]
    grid_xyz = affine_grid(eye, (1, 1, g, g))                           # (1, g, g, 2)
    shift_xyz = affine_grid(disp_range * eye, (1, 1, dw, dw))           # (1, dw, dw, 2)

    new_grid = grid_xyz.reshape(1, -1, 1, 2) + shift_xyz.reshape(1, 1, -1, 2)
    moving_grid = grid_sample(moving, new_grid.expand(N, -1, -1, -1))   # (N, g², dw², 1)
    fixed_grid = grid_sample(fixed, grid_xyz.reshape(1, -1, 1, 2).expand(N, -1, -1, -1))
    deeds_cost = (a1 + a0 * (fixed_grid - moving_grid) ** 2).reshape(-1, dw, dw, 1)

    cost = _min_conv(deeds_cost)
    # the second path re-weights the raw cost with the mean-field message
    cost = _min_conv(a4 + a2 * deeds_cost + a3 * _grid_mean(cost, N, g, dw))
    cost_avg = _grid_mean(cost, N, g, dw).reshape(N, g * g, dw * dw)

    cost_soft = torch.softmax(-a5 * cost_avg, dim=-1)
    pred_xyz = torch.sum(cost_soft[..., None] * shift_xyz.reshape(1, 1, -1, 2), dim=2)
    coarse = grid_xyz + pred_xyz.reshape(N, g, g, 2)                    # (N, g, g, 2)
    if mode == "nearest":
        ry = torch.arange(H, device=moving.device) * g // H
        rx = torch.arange(W, device=moving.device) * g // W
        return coarse[:, ry][:, :, rx]
    return interpolate_bilinear(coarse, (H, W))


def deeds_warp(x, sample_grid):
    """Apply a DEEDS grid: x (N, H, W, C), sample_grid (N, H, W, 2)."""
    return grid_sample(x, sample_grid)


def affine_deeds_fit(moving, fixed, *, affine_iters: int = 50, lr: float = 0.01,
                     **deeds_kw):
    """Affine fit, then DEEDS on the affine-warped image
    (AffineDEEDSRegistration.train_registraion, net/registration.py:505-524).
    moving/fixed: (N, H, W, 1) → (theta (N, 2, 3), sample grid (N, H, W, 2))."""
    theta, _ = fit_affine(moving, fixed, iters=affine_iters, lr=lr)
    return theta, deeds_fit(affine_warp(moving, theta), fixed, **deeds_kw)


def affine_deeds_warp(x, theta, sample_grid):
    """Apply the combined transform (affine then DEEDS), x (N, H, W, C)."""
    return deeds_warp(affine_warp(x, theta), sample_grid)
