"""3D bounding-box utilities + NMS (rebuild of utils/util.py:91-362).

The port's copy of ``rpnet_tpu/core/boxes.py``; the port imports nothing
of the JAX package.

Boxes use the reference's two representations:
  * center boxes ``[cz, cy, cx, D, H, W]``
  * coordinate boxes ``[z0, y0, x0, z1, y1, x1]``
NMS detections are ``[score, z, y, x, d, h, w]`` (utils/util.py:92-127).

The reference's ``annotation2masks`` forgets its return statement
(utils/util.py:277-283, a known defect — SURVEY.md §2.1); fixed here.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np


def py_nms(dets: np.ndarray, thresh: float) -> List[int]:
    """Greedy 3D NMS on [score, z, y, x, d, h, w] rows; returns kept indices."""
    dets = np.asarray(dets, dtype=np.float64)
    z, y, x = dets[:, 1], dets[:, 2], dets[:, 3]
    d, h, w = dets[:, 4], dets[:, 5], dets[:, 6]
    scores = dets[:, 0]
    areas = d * h * w
    order = scores.argsort()[::-1]
    keep = []
    while order.size > 0:
        i = order[0]
        keep.append(int(i))
        xx0 = np.maximum(x[i] - w[i] / 2.0, x[order[1:]] - w[order[1:]] / 2.0)
        yy0 = np.maximum(y[i] - h[i] / 2.0, y[order[1:]] - h[order[1:]] / 2.0)
        zz0 = np.maximum(z[i] - d[i] / 2.0, z[order[1:]] - d[order[1:]] / 2.0)
        xx1 = np.minimum(x[i] + w[i] / 2.0, x[order[1:]] + w[order[1:]] / 2.0)
        yy1 = np.minimum(y[i] + h[i] / 2.0, y[order[1:]] + h[order[1:]] / 2.0)
        zz1 = np.minimum(z[i] + d[i] / 2.0, z[order[1:]] + d[order[1:]] / 2.0)
        inter = (np.maximum(0.0, xx1 - xx0) * np.maximum(0.0, yy1 - yy0)
                 * np.maximum(0.0, zz1 - zz0))
        ovr = inter / (areas[i] + areas[order[1:]] - inter)
        order = order[1:][ovr < thresh]
    return keep


def py_box_overlap(boxes1: np.ndarray, boxes2: np.ndarray) -> np.ndarray:
    """Pairwise IoU of center boxes [z, y, x, d, h, w] (utils/util.py:130-156)."""
    b1 = np.asarray(boxes1, np.float64)
    b2 = np.asarray(boxes2, np.float64)
    lo1, hi1 = b1[:, :3] - b1[:, 3:] / 2, b1[:, :3] + b1[:, 3:] / 2
    lo2, hi2 = b2[:, :3] - b2[:, 3:] / 2, b2[:, :3] + b2[:, 3:] / 2
    lo = np.maximum(lo1[:, None], lo2[None])
    hi = np.minimum(hi1[:, None], hi2[None])
    inter = np.prod(np.maximum(0.0, hi - lo), axis=-1)
    a1 = np.prod(b1[:, 3:], axis=-1)
    a2 = np.prod(b2[:, 3:], axis=-1)
    return inter / (a1[:, None] + a2[None] - inter)


def center_box_to_coord_box(bboxes: np.ndarray) -> np.ndarray:
    b = np.asarray(bboxes, np.float64)
    res = np.zeros_like(b)
    res[:, :3] = b[:, :3] - b[:, 3:] / 2.0
    res[:, 3:] = b[:, :3] + b[:, 3:] / 2.0
    return res


def coord_box_to_center_box(bboxes: np.ndarray) -> np.ndarray:
    b = np.asarray(bboxes, np.float64)
    res = np.zeros_like(b)
    res[:, 3:] = b[:, 3:] - b[:, :3]
    res[:, :3] = b[:, :3] + res[:, 3:] / 2.0
    return res


def ext2factor(bboxes: np.ndarray, factor: int = 8) -> np.ndarray:
    """Extend coordinate boxes outward to factor-aligned bounds."""
    b = np.asarray(bboxes).copy()
    b[:, :3] = b[:, :3] // factor * factor
    b[:, 3:] = (b[:, 3:] // factor * factor
                + (b[:, 3:] % factor != 0).astype(np.int64) * factor)
    return b


def clip_boxes(boxes: np.ndarray, img_size: Sequence[int]) -> np.ndarray:
    b = np.asarray(boxes).copy()
    for axis, size in enumerate(img_size):
        b[:, axis] = np.clip(b[:, axis], 0, size)
        b[:, axis + 3] = np.clip(b[:, axis + 3], 0, size)
    return b


def annotation2masks(mask: Dict[str, np.ndarray],
                     roi_names: Sequence[str]) -> np.ndarray:
    """Per-ROI mask dict → (num_class, D, H, W) stack.

    (The reference version returns None by accident; fixed.)"""
    first = mask[list(mask.keys())[0]]
    D, H, W = first.shape
    masks = np.zeros([len(roi_names), D, H, W], dtype=np.float32)
    for i, roi in enumerate(roi_names):
        if roi in mask:
            masks[i][mask[roi] > 0] = 1
    return masks


def masks2bboxes_masks(masks: np.ndarray, border: float):
    """Mask stack → center bboxes [cz, cy, cx, d, h, w, class] + kept masks
    (utils/util.py:285-303, including its asymmetric z border of border/2)."""
    num_class = masks.shape[0]
    bboxes, truth_masks = [], []
    for i in range(num_class):
        m = masks[i]
        if np.any(m):
            zz, yy, xx = np.where(m)
            bboxes.append([(zz.max() + zz.min()) / 2.0,
                           (yy.max() + yy.min()) / 2.0,
                           (xx.max() + xx.min()) / 2.0,
                           zz.max() - zz.min() + 1 + border / 2,
                           yy.max() - yy.min() + 1 + border,
                           xx.max() - xx.min() + 1 + border, i + 1])
            truth_masks.append(m)
    return bboxes, truth_masks


def get_contours_from_masks(masks: np.ndarray) -> np.ndarray:
    """Per-organ boundary maps, (num_class, D, H, W) → same-shape uint8.

    Rebuild of utils/util.py:306-330. The reference walks every (organ, slice)
    pair through ``skimage.measure.find_contours`` and rounds the subpixel
    points to ints; the result is the set of foreground pixels on the mask
    boundary. Here the boundary is computed directly as the morphological
    inner gradient (foreground pixels with at least one 4-neighbour outside
    the mask), fully vectorized over all organs and slices at once.
    """
    m = (np.asarray(masks) > 0)
    p = np.pad(m, [(0, 0), (0, 0), (1, 1), (1, 1)])
    interior = (p[..., :-2, 1:-1] & p[..., 2:, 1:-1]
                & p[..., 1:-1, :-2] & p[..., 1:-1, 2:])
    return (m & ~interior).astype(np.uint8)


def _merge_label_stack(stack: np.ndarray) -> np.ndarray:
    """(num_class, D, H, W) binary stack → (D, H, W) labels, later class wins."""
    s = np.asarray(stack) > 0
    num_class = s.shape[0]
    # argmax over reversed channels finds the LAST positive class per voxel
    # (reference semantics: later class overrides, utils/util.py:343-344).
    rev_first = np.argmax(s[::-1], axis=0)
    label = np.where(s.any(axis=0), num_class - rev_first, 0)
    return label.astype(np.uint8)


def merge_contours(contours: np.ndarray) -> np.ndarray:
    """Merge per-organ contour maps into one labeled (D, H, W) volume
    (utils/util.py:333-346; overlaps resolved in favor of the later class)."""
    return _merge_label_stack(contours)


def merge_masks(masks: np.ndarray) -> np.ndarray:
    """Merge per-organ masks into one labeled (D, H, W) volume
    (utils/util.py:349-362; overlaps resolved in favor of the later class)."""
    return _merge_label_stack(masks)


def detections2mask(detections, masks, img_reso, num_class: int = 28):
    """Paste per-detection mask crops back into a volume (utils/util.py:223-250)."""
    from scipy.ndimage import zoom

    D, H, W = img_reso
    out = np.zeros((num_class, D, H, W))
    for det, m in zip(detections, masks):
        z, y, x, d, h, w, cat = det
        cat = int(cat)
        z0, y0, x0 = (max(0, int(np.floor(c - s / 2.0)))
                      for c, s in ((z, d), (y, h), (x, w)))
        z1 = min(D, int(np.ceil(z + d / 2.0)))
        y1 = min(H, int(np.ceil(y + h / 2.0)))
        x1 = min(W, int(np.ceil(x + w / 2.0)))
        Dc, Hc, Wc = m.shape
        zoomed = zoom(m, ((z1 - z0) / Dc, (y1 - y0) / Hc, (x1 - x0) / Wc), order=2)
        out[cat - 1][z0:z1, y0:y1, x0:x1] = (zoomed > 0.5).astype(np.uint8)
    return out


def crop_boxes2mask(crop_boxes, masks, img_reso, num_class: int = 28):
    """Paste thresholded mask crops at coordinate boxes (utils/util.py:253-271)."""
    D, H, W = img_reso
    out = np.zeros((num_class, D, H, W))
    for box, m in zip(crop_boxes, masks):
        z0, y0, x0, z1, y1, x1, cat = [int(v) for v in box]
        out[cat - 1][z0:z1, y0:y1, x0:x1] = (m > 0.5).astype(np.uint8)
    return out
