"""Host (numpy) array transforms of the CT preprocessing chain.

The port's copy of the numpy half of ``rpnet_tpu/core/transforms.py``, cut to
what the samplers run:
  * ``normalize``       — utils/util.py:455-467 (HU clip + 99.5-percentile clip → [-1,1])
  * ``pad2factor``      — utils/util.py:406-419
  * ``truncate_image``  — dataset/few_shot_reader.py:385-398
  * ``keep_only_annotation_z_slices`` — dataset/few_shot_reader.py:17-24
  * ``crop``            — dataset/few_shot_reader.py:63-75
  * ``gamma_transform`` — dataset/few_shot_reader.py:201-211 (train only)
  * ``truncate_HU_uint8``, ``pad2same_size(_3d)``, ``resample`` and
    ``onehot2multi_mask`` — for the preprocessing and visualization modules
    (``rpnet_tpu/core/transforms.py:64-164``)
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import numpy as np


def normalize(img: np.ndarray, minimum: float = -1024, maximum: float = 3076) -> np.ndarray:
    """HU windowing + robust upper clip, output in [-1, 1].

    Order of operations matches utils/util.py:455-467 exactly: clip above the
    99.5th percentile, clip to [minimum, maximum], then affine map to [-1, 1].
    """
    img = np.array(img, dtype=np.float32, copy=True)
    hir = float(np.percentile(img, 100.0 - 0.5))
    np.copyto(img, img.dtype.type(hir), where=img > hir)
    np.clip(img, minimum, maximum, out=img)
    np.subtract(img, minimum, out=img)
    np.divide(img, max(1, (maximum - minimum)), out=img)
    np.multiply(img, 2, out=img)
    np.subtract(img, 1, out=img)
    return img


def truncate_HU_uint8(img: np.ndarray) -> np.ndarray:
    """Window HU to [-1200, 600] and quantize to uint8 (utils/util.py:879-887)."""
    scaled = (np.asarray(img, np.float64) + 1200.0) / 1800.0
    return (np.clip(scaled, 0.0, 1.0) * 255).astype("uint8")


def pad2factor(image: np.ndarray, factor: int = 16, pad_value: float = 0) -> np.ndarray:
    """Pad a (D, H, W) volume at the high end so each dim divides ``factor``."""
    depth, height, width = image.shape
    d = int(math.ceil(depth / float(factor))) * factor
    h = int(math.ceil(height / float(factor))) * factor
    w = int(math.ceil(width / float(factor))) * factor
    pad = [[0, d - depth], [0, h - height], [0, w - width]]
    return np.pad(image, pad, "constant", constant_values=pad_value)


def pad2same_size(imgs: Sequence[np.ndarray]) -> List[np.ndarray]:
    H = max(im.shape[0] for im in imgs)
    W = max(im.shape[1] for im in imgs)
    return [np.pad(im, [[0, H - im.shape[0]], [0, W - im.shape[1]]]) for im in imgs]


def pad2same_size_3d(imgs: Sequence[np.ndarray]) -> List[np.ndarray]:
    D = max(im.shape[0] for im in imgs)
    H = max(im.shape[1] for im in imgs)
    W = max(im.shape[2] for im in imgs)
    return [
        np.pad(im, [[0, D - im.shape[0]], [0, H - im.shape[1]], [0, W - im.shape[2]]])
        for im in imgs
    ]


def truncate_image(image: np.ndarray, num_slice: int, num_x: int, num_y: int) -> np.ndarray:
    """Center-crop (H, W) to at most (num_y, num_x) and keep first num_slice z."""
    D, H, W = image.shape
    x1 = max(0, W // 2 - num_x // 2)
    x2 = min(W, W // 2 + num_x // 2)
    y1 = max(0, H // 2 - num_y // 2)
    y2 = min(H, H // 2 + num_y // 2)
    return image[:num_slice, y1:y2, x1:x2]


def keep_only_annotation_z_slices(img: np.ndarray, mask: np.ndarray):
    """Crop z to the annotated organ range [d_min, d_max).

    Faithful to dataset/few_shot_reader.py:17-24 including its half-open upper
    bound (the slice at d_max is dropped).
    """
    cc, dd, hh, ww = np.where(mask)
    d_max, d_min = dd.max(), dd.min()
    return img[:, d_min:d_max, :, :], mask[:, d_min:d_max, :, :]


def crop(img: np.ndarray, mask: np.ndarray, crop_size: Sequence[int],
         img_pad_value: float, mask_pad_value: float = 0):
    """Center-crop (H, W) to ``crop_size`` then pad back symmetrically."""
    c, d, h, w = mask.shape
    ch, cw = crop_size
    rh, rw = min(ch, h), min(cw, w)
    cx, cy = w // 2, h // 2
    img_crop = img[..., cy - rh // 2:cy + rh - rh // 2, cx - rw // 2:cx + rw - rw // 2]
    mask_crop = mask[..., cy - rh // 2:cy + rh - rh // 2, cx - rw // 2:cx + rw - rw // 2]
    pad_width = [(0, 0), (0, 0),
                 ((ch - rh) // 2, (ch - rh) - (ch - rh) // 2),
                 ((cw - rw) // 2, (cw - rw) - (cw - rw) // 2)]
    img_pad = np.pad(img_crop, pad_width, mode="constant", constant_values=img_pad_value)
    mask_pad = np.pad(mask_crop, pad_width, mode="constant", constant_values=mask_pad_value)
    return img_pad, mask_pad


def resample(image: np.ndarray, spacing, new_spacing=(1.0, 1.0, 1.0), order: int = 1):
    """Resample to ``new_spacing`` (utils/util.py:37-60). Returns (image, actual_spacing)."""
    import scipy.ndimage

    spacing = np.asarray(spacing, dtype=np.float64)
    new_spacing = np.asarray(new_spacing, dtype=np.float64)
    new_shape = np.round(np.asarray(image.shape) * spacing / new_spacing)
    resample_spacing = spacing * np.asarray(image.shape) / new_shape
    resize_factor = new_shape / np.asarray(image.shape)
    image_new = scipy.ndimage.zoom(image, resize_factor, mode="nearest", order=order)
    return image_new, resample_spacing


def onehot2multi_mask(onehot: np.ndarray) -> np.ndarray:
    num_class, D, H, W = onehot.shape
    multi_mask = np.zeros((D, H, W))
    for i in range(1, num_class):
        multi_mask[onehot[i] > 0] = i
    return multi_mask


def gamma_transform(img: np.ndarray, gamma_range: Sequence[float],
                    rng: Optional[np.random.RandomState] = None):
    """Random gamma jitter on a [-1, 1] image (few_shot_reader.py:201-211);
    draws one ``rand()`` from ``rng`` or the global numpy stream."""
    rand = rng.rand() if rng is not None else np.random.rand()
    img = (img + 1) / 2.0
    gamma = rand * (gamma_range[1] - gamma_range[0]) + gamma_range[0]
    cmin = img.min()
    irange = img.max() - cmin + 1e-5
    img = img - cmin + 1e-5
    img = irange * np.power(img * 1.0 / irange, gamma)
    img = img + cmin
    return img * 2 - 1
