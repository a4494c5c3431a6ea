"""Gaussian kernels and the flow-field regulariser (net/registration.py:16-168).

The counterpart of ``rpnet_tpu/registration/gaussian.py``. The demons fit
smooths its 2-channel flow with a fixed Gaussian after every Adam step (no
gradient through the smoothing): a depthwise ``F.conv2d`` with zero padding.
The JAX package runs it at ``Precision.HIGHEST``; cuDNN would run an f32
convolution in TF32 unless told otherwise, so the blur turns TF32 off for
its own call whatever the network's setting.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def gaussian_kernel_1d(sigma: float) -> np.ndarray:
    """Normalized 1-D Gaussian with the reference's size rule
    (kernel_size = 2*ceil(2*sigma)+1, net/registration.py:16-31)."""
    kernel_size = int(2 * np.ceil(sigma * 2) + 1)
    x = np.linspace(-(kernel_size - 1) // 2, (kernel_size - 1) // 2, num=kernel_size)
    k = 1.0 / (sigma * np.sqrt(2 * np.pi)) * np.exp(-(x ** 2) / (2 * sigma ** 2))
    return k / np.sum(k)


def gaussian_kernel_2d(sigma: Sequence[float]) -> np.ndarray:
    k = np.tensordot(gaussian_kernel_1d(sigma[0]), gaussian_kernel_1d(sigma[1]), 0)
    return k / np.sum(k)


@functools.lru_cache(maxsize=None)
def _blur_weight(sigma: Tuple[float, float], channels: int, device: torch.device,
                 dtype: torch.dtype) -> torch.Tensor:
    """The depthwise (channels, 1, kh, kw) kernel on ``device``, made once: a
    copy from host memory on each call would block the host until the
    device is idle."""
    k2 = torch.from_numpy(gaussian_kernel_2d(sigma).astype(np.float32))
    return k2[None, None].repeat(channels, 1, 1, 1).to(device, dtype)


@contextlib.contextmanager
def no_tf32():
    """cuDNN convolutions in full f32 inside the block, then as before."""
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = saved


def gaussian_blur_flow(flow, sigma: Sequence[float] = (2.0, 2.0)):
    """Depthwise Gaussian smoothing of a flow field (N, H, W, C), channels
    last, zero padding (the reference's F.conv2d(padding=(k-1)/2, groups=2),
    net/registration.py:128-131). ``sigma`` sets a kernel size: a shape."""
    C = flow.shape[-1]
    weight = _blur_weight((float(sigma[0]), float(sigma[1])), C, flow.device, flow.dtype)
    kh, kw = weight.shape[-2:]
    with no_tf32():
        out = F.conv2d(flow.permute(0, 3, 1, 2), weight, padding=(kh // 2, kw // 2),
                       groups=C)
    return out.permute(0, 2, 3, 1)


def l2_regulariser_2d(displacement, pixel_spacing=(1.0, 1.0)):
    """``_l2_regulariser_2d`` (net/registration.py:163-168) per slice:
    displacement (..., H, W, 2) channels last → (...,).

    The reference's quirk is kept, as the JAX package keeps it: on its
    channels-first (2, H, W) flow, ``[1:] - [:-1]`` on dim 0 is a CHANNEL
    difference (flow_y − flow_x on rows 1:), and the zero pad to
    (1, H, W+1) before the mean divides the sum by H·(W+1).
    """
    H, W = displacement.shape[-3:-1]
    fx, fy = displacement[..., 0], displacement[..., 1]
    dx = (fy[..., 1:, :] - fx[..., 1:, :]) ** 2 * pixel_spacing[0]
    dy = (fy[..., 1:, :] - fy[..., :-1, :]) ** 2 * pixel_spacing[1]
    return (dx + dy).sum(dim=(-2, -1)) / (H * (W + 1))
