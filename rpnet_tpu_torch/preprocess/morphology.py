"""Body-region masking: Otsu + morphology + connected components.

The port's copy of ``rpnet_tpu/preprocess/morphology.py``. Replaces the
SimpleITK chain of utils/preprocess_abd_110.py:23-48 (OtsuThreshold →
BinaryMorphologicalClosing/Opening → ConnectedThreshold from the image
center → BinaryFillhole) with scipy/numpy host code (a copy of the JAX
module's), plus torch twins of the per-slice ops on any device (the JAX
module's ``*_jax`` twins, which are XLA code): ``otsu_threshold_torch``
(an ``index_add_`` histogram, the same float32 arithmetic) and
``dilate_torch`` … ``opening_torch`` (``F.max_pool2d`` with a square
window; its -inf padding equals ``reduce_window``'s 0 init on masks in
[0, 1], because the window always holds its centre).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F


# --------------------------------------------------------------------------
# Otsu threshold
# --------------------------------------------------------------------------

def otsu_threshold(img: np.ndarray, nbins: int = 256) -> float:
    """Classic Otsu: maximize between-class variance over the histogram."""
    img = np.asarray(img, dtype=np.float64)
    lo, hi = img.min(), img.max()
    if hi <= lo:
        return float(lo)
    hist, edges = np.histogram(img.ravel(), bins=nbins, range=(lo, hi))
    hist = hist.astype(np.float64)
    centers = (edges[:-1] + edges[1:]) / 2
    w0 = np.cumsum(hist)
    w1 = w0[-1] - w0
    m0 = np.cumsum(hist * centers)
    mu0 = np.where(w0 > 0, m0 / np.maximum(w0, 1), 0)
    mu1 = np.where(w1 > 0, (m0[-1] - m0) / np.maximum(w1, 1), 0)
    between = w0 * w1 * (mu0 - mu1) ** 2
    return float(centers[int(np.argmax(between[:-1]))])


def otsu_threshold_torch(img: torch.Tensor, nbins: int = 256) -> torch.Tensor:
    """Device twin of :func:`otsu_threshold` (``otsu_threshold_jax``):
    float32 histogram of ``nbins`` bins over [min, max] → the bin centre
    maximizing the between-class variance, a 0-d tensor on ``img``'s
    device. ``torch.argmax`` takes the first maximum, as ``jnp.argmax``."""
    img = img.float()
    lo = img.min()
    hi = img.max()
    scaled = (img - lo) / torch.clamp(hi - lo, min=1e-12)
    idx = torch.clamp((scaled * nbins).to(torch.int32), 0, nbins - 1)
    hist = torch.zeros(nbins, dtype=torch.float32, device=img.device)
    hist.index_add_(0, idx.reshape(-1), torch.ones(idx.numel(), device=img.device))
    centers = lo + (torch.arange(nbins, dtype=torch.float32, device=img.device)
                    + 0.5) / nbins * (hi - lo)
    w0 = torch.cumsum(hist, 0)
    w1 = w0[-1] - w0
    m0 = torch.cumsum(hist * centers, 0)
    mu0 = torch.where(w0 > 0, m0 / torch.clamp(w0, min=1), 0.0)
    mu1 = torch.where(w1 > 0, (m0[-1] - m0) / torch.clamp(w1, min=1), 0.0)
    between = w0 * w1 * (mu0 - mu1) ** 2
    return centers[torch.argmax(between[:-1])]


# --------------------------------------------------------------------------
# binary morphology (disk structuring element, like sitk radius semantics)
# --------------------------------------------------------------------------

def _disk(radius: int) -> np.ndarray:
    y, x = np.ogrid[-radius:radius + 1, -radius:radius + 1]
    return (x * x + y * y <= radius * radius).astype(np.uint8)


def binary_closing(mask: np.ndarray, radius: int = 7) -> np.ndarray:
    from scipy.ndimage import binary_closing as _c
    return _c(mask.astype(bool), structure=_disk(radius)).astype(np.uint8)


def binary_opening(mask: np.ndarray, radius: int = 7) -> np.ndarray:
    from scipy.ndimage import binary_opening as _o
    return _o(mask.astype(bool), structure=_disk(radius)).astype(np.uint8)


def _max_pool(x: torch.Tensor, radius: int) -> torch.Tensor:
    """Square (2r+1)² max over the last two axes of an (H, W) or (..., H, W)
    tensor, same size."""
    k = 2 * radius + 1
    shape = x.shape
    y = F.max_pool2d(x.reshape(-1, 1, *shape[-2:]), k, stride=1, padding=radius)
    return y.reshape(shape)


def dilate_torch(mask: torch.Tensor, radius: int) -> torch.Tensor:
    """Device binary dilation via max-pool (box element — conservative),
    per (H, W) slice of a mask in [0, 1]; float32 (``dilate_jax``)."""
    return _max_pool(mask.float(), radius)


def erode_torch(mask: torch.Tensor, radius: int) -> torch.Tensor:
    return 1.0 - _max_pool(1.0 - mask.float(), radius)


def closing_torch(mask: torch.Tensor, radius: int) -> torch.Tensor:
    return erode_torch(dilate_torch(mask, radius), radius)


def opening_torch(mask: torch.Tensor, radius: int) -> torch.Tensor:
    return dilate_torch(erode_torch(mask, radius), radius)


# --------------------------------------------------------------------------
# connected components / hole filling
# --------------------------------------------------------------------------

def connected_from_seed(mask: np.ndarray, seed: Tuple[int, int]) -> np.ndarray:
    """Connected component of `mask` containing `seed` (sitk ConnectedThreshold)."""
    from scipy.ndimage import label
    labels, _ = label(mask > 0)
    lab = labels[seed]
    if lab == 0:
        return np.zeros_like(mask, dtype=np.uint8)
    return (labels == lab).astype(np.uint8)


def fill_holes(mask: np.ndarray) -> np.ndarray:
    from scipy.ndimage import binary_fill_holes
    return binary_fill_holes(mask > 0).astype(np.uint8)


# --------------------------------------------------------------------------
# the full body-mask chain (per slice)
# --------------------------------------------------------------------------

def body_mask_slice(slice_hu: np.ndarray, radius: int = 7) -> np.ndarray:
    """Per-slice body mask (preprocess_abd_110.morphology_process semantics):
    invert Otsu (body is the bright class), close+open with a disk, keep the
    component under the image center, fill holes."""
    t = otsu_threshold(slice_hu)
    body = (slice_hu > t).astype(np.uint8)    # 1 - OtsuThreshold == above class
    body = binary_closing(body, radius)
    body = binary_opening(body, radius)
    H, W = body.shape
    comp = connected_from_seed(body, (H // 2, W // 2))
    return fill_holes(comp)


def body_mask_volume(volume_hu: np.ndarray, radius: int = 7) -> np.ndarray:
    """Slice-wise body mask of a (D, H, W) volume
    (preprocess_abd_110.preprocess_image)."""
    return np.stack([body_mask_slice(volume_hu[i], radius)
                     for i in range(volume_hu.shape[0])])
