"""The registration stage of an episode (dataset/few_shot_reader.py:109-198).

The counterpart of ``rpnet_tpu/registration/fit.py::register_episode``,
batched over the S slices:

  * images enter in [-1, 1]; fitting happens in [0, 1] ((x+1)/2,
    few_shot_reader.py:111-115);
  * affine: 50 Adam steps on the MSE, on an image avg-pooled by
    ``fit_scale`` (theta in normalized coordinates is resolution-invariant);
    the label and image are warped at full resolution;
  * demons (``demons_iters`` > 0): NCC Adam fit of a flow, Gaussian σ
    smoothing after every step, integrated by ``diffeo_scaling``
    squarings; the label and image warp through it. ``sampler`` selects
    the STRUCTURE, as the JAX package's ``reg_sampler`` does (the port
    always samples with ``F.grid_sample``):
      - ``matmul`` (the JAX default): the fit and the integration run on
        the affine-warped source and the query pooled by ``fit_scale``,
        with σ' = max(0.5, σ/fit_scale); the integrated displacement
        upsamples bilinearly to full resolution, and one full-resolution
        warp moves label and image (``fit.py:210-247``); the raw flow is
        returned at the fit's resolution;
      - ``gather``: the reference structure of ``register_slice``: fit and
        warp at full resolution with σ;
  * with no demons steps the label and image are resampled once more
    through the reference's zero-flow identity grid — built with the (S-1)
    denominator but sampled align_corners=False, replicated for Dice
    parity;
  * labels are thresholded > 0.1 and images mapped back to [-1, 1].
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from rpnet_tpu_torch.ops.sampling import avg_pool2d, grid_sample, interpolate_bilinear
from rpnet_tpu_torch.registration.affine import affine_warp, fit_affine
from rpnet_tpu_torch.registration.demons import (demons_warp, diffeomorphic_2d,
                                                 fit_demons, identity_grid)
from rpnet_tpu_torch.utils.profiling import span

SAMPLERS = ("matmul", "gather")


class RegistrationResult(NamedTuple):
    """Per-slice registration outputs (leading axis = query slices)."""
    theta: torch.Tensor          # (S, 2, 3) fitted affine params
    flow: Optional[torch.Tensor]  # (S, 2, h, w) fitted demons flow (raw parameter)
                                  # at the fit's resolution; None with no demons steps
    warped_label: torch.Tensor   # (S, H, W) demons∘affine label > 0.1
    affine_label: torch.Tensor   # (S, H, W) affine-only label > 0.1
    warped_src: torch.Tensor     # (S, H, W) demons∘affine image, in [-1, 1]
    affine_src: torch.Tensor     # (S, H, W) affine-only image, in [-1, 1]


def _pooled(x, s: int):
    return avg_pool2d(x, s) if s > 1 else x


def register_episode(support_imgs, query_imgs, support_labels, *,
                     affine_iters: int = 50, demons_iters: int = 0,
                     lr: float = 0.01, sigma: float = 2.0,
                     diffeo_scaling: int = 10, fit_scale: int = 1,
                     sampler: str = "matmul") -> RegistrationResult:
    """Register every support slice onto its query slice, batched.

    support_imgs, query_imgs: (S, H, W) in [-1, 1]; support_labels: (S, H, W).
    """
    with span("registration", support_imgs.device):
        if sampler not in SAMPLERS:
            raise ValueError(f"reg_sampler {sampler!r}: one of {SAMPLERS}")
        S, H, W = support_imgs.shape
        src01 = ((support_imgs + 1.0) * 0.5)[..., None]       # (S, H, W, 1)
        dst01 = ((query_imgs + 1.0) * 0.5)[..., None]
        theta, _ = fit_affine(_pooled(src01, fit_scale), _pooled(dst01, fit_scale),
                              iters=affine_iters, lr=lr)

        # one 2-channel full-res warp (label + image)
        both = torch.cat([support_labels[..., None], src01], dim=-1)
        affine_both = affine_warp(both, theta)
        affine_src01 = affine_both[..., 1:]
        grid = identity_grid((H, W), both.dtype, both.device)
        if demons_iters == 0:
            flow = None
            warped_both = grid_sample(affine_both, grid.expand(S, H, W, 2),
                                      align_corners=False)
        elif sampler == "gather":
            flow, _ = fit_demons(affine_src01, dst01, demons_iters, lr, (sigma, sigma),
                                 diffeo_scaling)
            warped_both = demons_warp(affine_both, flow, grid, diffeo_scaling)
        else:
            s = max(1, fit_scale)
            sig = max(0.5, sigma / s)
            flow, _ = fit_demons(_pooled(affine_src01, s), _pooled(dst01, s),
                                 demons_iters, lr, (sig, sig), diffeo_scaling)
            grid_low = identity_grid((H // s, W // s), both.dtype, both.device)
            disp = interpolate_bilinear(diffeomorphic_2d(flow, grid_low, diffeo_scaling),
                                        (H, W))
            warped_both = grid_sample(affine_both, grid + disp, align_corners=False)

        dt = support_imgs.dtype
        return RegistrationResult(
            theta=theta,
            flow=None if flow is None else flow.permute(0, 3, 1, 2),
            warped_label=(warped_both[..., 0] > 0.1).to(dt),
            affine_label=(affine_both[..., 0] > 0.1).to(dt),
            warped_src=warped_both[..., 1] * 2.0 - 1.0,
            affine_src=affine_both[..., 1] * 2.0 - 1.0,
        )
