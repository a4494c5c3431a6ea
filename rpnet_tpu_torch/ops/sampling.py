"""Grid sampling / resampling ops on channels-last tensors.

PyTorch counterparts of ``rpnet_tpu/ops/sampling.py``. The JAX package
rewrites the torch ops as matmuls for the TPU (its module docstring); here
they are the torch ops themselves, so only the layout is adapted: every
function takes and returns the JAX package's channels-last (N, H, W, C)
tensors. ``x.permute(0, 3, 1, 2)`` of a contiguous NHWC tensor is an NCHW
view in ``torch.channels_last`` memory format, so the ops run without copies.

Boundary conventions (SURVEY.md §7 hard part 1):
  * ``F.grid_sample`` bilinear, zero padding — align_corners=False in
    registration, align_corners=True inside the reference's correlation
    sampler;
  * ``F.affine_grid`` align_corners=False;
  * ``F.interpolate(mode='bilinear')`` align_corners=False;
  * ``compute_grid`` keeps the reference's (S-1)-denominator identity grid,
    later sampled with align_corners=False — the mismatch is deliberate.
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from rpnet_tpu_torch.utils.tensor_cache import device_tensor_cache


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def grid_sample(x, grid, align_corners: bool = False):
    """Bilinear sample ``x`` (N, H, W, C) at normalized (x, y) coords ``grid``
    (N, Hg, Wg, 2) with zero padding → (N, Hg, Wg, C)."""
    return _nhwc(F.grid_sample(_nchw(x), grid, mode="bilinear",
                               padding_mode="zeros",
                               align_corners=align_corners))


def affine_grid(theta, size: Sequence[int], align_corners: bool = False):
    """``F.affine_grid``: theta (N, 2, 3), size (N, C, H, W) → (N, H, W, 2)."""
    return F.affine_grid(theta, list(size), align_corners=align_corners)


def compute_grid(img_size: Tuple[int, int], dtype=torch.float32, device=None):
    """The reference's normalized identity grid (net/registration.py:171-187),
    built with the (S-1) denominator. Returns (1, 2, H, W), channels (x, y)."""
    H, W = img_size
    ys, xs = torch.meshgrid(torch.arange(H, dtype=dtype, device=device),
                            torch.arange(W, dtype=dtype, device=device),
                            indexing="ij")
    gx = 2.0 * (xs / (W - 1) - 0.5)
    gy = 2.0 * (ys / (H - 1) - 0.5)
    return torch.stack([gx, gy], dim=0)[None]


@functools.lru_cache(maxsize=None)
def _resize_weights(src: int, dst: int, align_corners: bool) -> np.ndarray:
    """Dense (dst, src) bilinear interpolation matrix (torch upsample rules)."""
    if src == dst:
        return np.eye(src, dtype=np.float32)
    out = np.zeros((dst, src), dtype=np.float64)
    for i in range(dst):
        if align_corners:
            s = i * (src - 1) / (dst - 1) if dst > 1 else 0.0
        else:
            s = (i + 0.5) * src / dst - 0.5
            s = max(s, 0.0)  # torch clamps the low side; high side via i1 clamp
        i0 = min(int(np.floor(s)), src - 1)
        i1 = min(i0 + 1, src - 1)
        w1 = s - i0
        out[i, i0] += 1.0 - w1
        out[i, i1] += w1
    return out.astype(np.float32)


@device_tensor_cache
def _resize_matrix(src: int, dst: int, align_corners: bool, device: torch.device,
                   dtype: torch.dtype) -> torch.Tensor:
    """:func:`_resize_weights` as a tensor on ``device``, made once."""
    return torch.from_numpy(_resize_weights(src, dst, align_corners)).to(device, dtype)


def interpolate_bilinear(x, size: Tuple[int, int], align_corners: bool = False):
    """``F.interpolate(x, size, mode='bilinear')`` on (N, H, W, C) input.

    Below f32 (the bf16 eval network) it is the JAX package's two resize
    products, each rounded to the input dtype
    (``rpnet_tpu/ops/sampling.py:152-163``): one ``F.interpolate`` rounds
    once and differs from it by one ulp on about a third of the entries.
    """
    if x.dtype in (torch.float32, torch.float64):
        return _nhwc(F.interpolate(_nchw(x), size=tuple(size), mode="bilinear",
                                   align_corners=align_corners))
    _, H, W, _ = x.shape
    Ay = _resize_matrix(H, size[0], align_corners, x.device, x.dtype)
    Ax = _resize_matrix(W, size[1], align_corners, x.device, x.dtype)
    out = torch.einsum("oh,nhwc->nowc", Ay, x)
    return torch.einsum("ow,nhwc->nhoc", Ax, out)


def resize_transpose(cot, src_size: Tuple[int, int], align_corners: bool = False):
    """The TRANSPOSE of bilinear upsampling: (N, Ho, Wo, C) → (N, H, W, C).

    Exact adjoint of :func:`interpolate_bilinear`; pulls full-resolution masks
    down to feature resolution without materializing upsampled features.
    """
    _, Ho, Wo, _ = cot.shape
    H, W = src_size
    Ay = _resize_matrix(H, Ho, align_corners, cot.device, cot.dtype)
    Ax = _resize_matrix(W, Wo, align_corners, cot.device, cot.dtype)
    out = torch.einsum("oh,nowc->nhwc", Ay, cot)
    return torch.einsum("ow,nhoc->nhwc", Ax, out)


def avg_pool2d(x, kernel: int, stride: int | None = None):
    """``F.avg_pool2d`` (no padding) on (N, H, W, C) input."""
    return _nhwc(F.avg_pool2d(_nchw(x), kernel, stride or kernel))


def max_pool2d(x, kernel: int, stride: int | None = None, padding: int = 0):
    """``F.max_pool2d`` on (N, H, W, C) input; ``padding`` pads with -inf,
    as ``rpnet_tpu/ops/sampling.py:max_pool2d`` does."""
    return _nhwc(F.max_pool2d(_nchw(x), kernel, stride or kernel, padding))


class MaxPool2d(torch.nn.Module):
    """:func:`max_pool2d` as a module (a stage of a ``Sequential``)."""

    def __init__(self, kernel: int, stride: int, padding: int = 0):
        super().__init__()
        self.kernel, self.stride, self.padding = kernel, stride, padding

    def forward(self, x):
        return max_pool2d(x, self.kernel, self.stride, self.padding)


def replication_pad2d(x, pad: int):
    """``nn.ReplicationPad2d(pad)`` on (N, H, W, C) input."""
    return _nhwc(F.pad(_nchw(x), (pad, pad, pad, pad), mode="replicate"))


def upsample_nearest2x(x):
    """``nn.Upsample(scale_factor=2)`` (nearest) on (N, H, W, C) input."""
    return _nhwc(F.interpolate(_nchw(x), scale_factor=2, mode="nearest"))
