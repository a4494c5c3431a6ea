"""The registration stage of an episode (dataset/few_shot_reader.py:109-198).

The counterpart of ``rpnet_tpu/registration/fit.py::register_episode`` for
``demons_iters == 0`` (``do_deformable: False``, the eval main path):

  * images enter in [-1, 1]; fitting happens in [0, 1] ((x+1)/2,
    few_shot_reader.py:111-115), on an image avg-pooled by ``fit_scale``
    (theta in normalized coordinates is resolution-invariant);
  * affine: 50 Adam steps on the MSE, batched over the S slices;
  * the label and image are warped at full resolution, then resampled once
    more through the reference's zero-flow identity grid — built with the
    (S-1) denominator but sampled align_corners=False, replicated for Dice
    parity;
  * labels are thresholded > 0.1 and images mapped back to [-1, 1].

The deformable (demons) branch is not ported yet (ROADMAP.md).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from rpnet_tpu_torch.ops.sampling import avg_pool2d, compute_grid, grid_sample
from rpnet_tpu_torch.registration.affine import affine_warp, fit_affine


class RegistrationResult(NamedTuple):
    """Per-slice registration outputs (leading axis = query slices)."""
    theta: torch.Tensor          # (S, 2, 3) fitted affine params
    warped_label: torch.Tensor   # (S, H, W) resampled affine label > 0.1
    affine_label: torch.Tensor   # (S, H, W) affine-only label > 0.1
    warped_src: torch.Tensor     # (S, H, W) resampled affine image, in [-1, 1]
    affine_src: torch.Tensor     # (S, H, W) affine-only image, in [-1, 1]


def register_episode(support_imgs, query_imgs, support_labels, *,
                     affine_iters: int = 50, lr: float = 0.01,
                     fit_scale: int = 1) -> RegistrationResult:
    """Register every support slice onto its query slice, batched.

    support_imgs, query_imgs: (S, H, W) in [-1, 1]; support_labels: (S, H, W).
    """
    S, H, W = support_imgs.shape
    src01 = ((support_imgs + 1.0) * 0.5)[..., None]       # (S, H, W, 1)
    dst01 = ((query_imgs + 1.0) * 0.5)[..., None]
    if fit_scale > 1:
        src_fit, dst_fit = avg_pool2d(src01, fit_scale), avg_pool2d(dst01, fit_scale)
    else:
        src_fit, dst_fit = src01, dst01
    theta, _ = fit_affine(src_fit, dst_fit, iters=affine_iters, lr=lr)

    # one 2-channel full-res warp (label + image), then the identity resample
    both = torch.cat([support_labels[..., None], src01], dim=-1)
    affine_both = affine_warp(both, theta)
    grid = compute_grid((H, W), both.dtype, both.device)[0].permute(1, 2, 0)
    warped_both = grid_sample(affine_both, grid.expand(S, H, W, 2),
                              align_corners=False)

    dt = support_imgs.dtype
    return RegistrationResult(
        theta=theta,
        warped_label=(warped_both[..., 0] > 0.1).to(dt),
        affine_label=(affine_both[..., 0] > 0.1).to(dt),
        warped_src=warped_both[..., 1] * 2.0 - 1.0,
        affine_src=affine_both[..., 1] * 2.0 - 1.0,
    )
