"""Brain MRI/CT volume dataset + elastic augmentation (rebuild of
dataset/brain_reader.py).

The port's copy of ``rpnet_tpu/episode/brain.py``; the port imports nothing
of the JAX package.

Non-few-shot volume reader used for the cross-modality generalization path
(BASELINE.json config 4): loads ``{pid}_clean.nrrd`` + per-ROI masks, crops
around the annotated region with jitter, HU-normalizes, optionally applies
Simard-style elastic augmentation, and converts masks to bounding boxes.

Host-side numpy/cv2/scipy — this is offline-ish data plumbing, not the
compiled compute path.
"""

from __future__ import annotations

import math
import os
from typing import Dict

import numpy as np

from rpnet_tpu_torch.core import nrrd_io
from rpnet_tpu_torch.core.boxes import annotation2masks, masks2bboxes_masks
from rpnet_tpu_torch.core.transforms import normalize, pad2factor, truncate_image


def keep_only_annotation_region(img, mask, margin: int = 20):
    """Crop img+mask to the annotated bbox, with (h, w) margins
    (brain_reader.py:20-37: z gets no margin)."""
    c, d, h, w = mask.shape
    cc, dd, hh, ww = np.where(mask)
    d_min, d_max = dd.min(), dd.max()
    h_min = max(hh.min() - margin, 0)
    h_max = min(hh.max() + margin, h)
    w_min = max(ww.min() - margin, 0)
    w_max = min(ww.max() + margin, w)
    sel = (slice(d_min, d_max), slice(h_min, h_max), slice(w_min, w_max))
    if img.ndim == 3:
        return img[sel], mask[(slice(None),) + sel]
    return img[(slice(None),) + sel], mask[(slice(None),) + sel]


def _affine_from_triangle(src_pts, dst_pts):
    """Solve the 2×3 affine M with M @ [x, y, 1]ᵀ = dst for 3 point pairs
    (what cv2.getAffineTransform computes)."""
    A = np.concatenate([src_pts, np.ones((3, 1), np.float64)], axis=1)
    return np.linalg.solve(A, dst_pts).T.astype(np.float64)     # (2, 3)


def _invert_affine(M):
    A = np.eye(3, dtype=np.float64)
    A[:2] = M
    return np.linalg.inv(A)[:2]


def _bilinear_stack(stack, ys, xs, cval, hard_boundary=False):
    """Bilinear-sample a (Z, H, W) stack at float coords (H, W), constant
    border. Vectorized over z — every slice shares the sampling grid.

    hard_boundary=False blends border taps with cval (cv2 BORDER_CONSTANT
    semantics); True sets any coordinate outside [0, n-1] to cval outright
    (scipy map_coordinates mode='constant' semantics).
    """
    Z, H, W = stack.shape
    y0 = np.floor(ys).astype(np.int64)
    x0 = np.floor(xs).astype(np.int64)
    fy = (ys - y0).astype(stack.dtype)
    fx = (xs - x0).astype(stack.dtype)

    def tap(yi, xi):
        inside = (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
        v = stack[:, np.clip(yi, 0, H - 1), np.clip(xi, 0, W - 1)]
        return np.where(inside, v, cval)

    out = ((1 - fy) * (1 - fx) * tap(y0, x0) + (1 - fy) * fx * tap(y0, x0 + 1)
           + fy * (1 - fx) * tap(y0 + 1, x0) + fy * fx * tap(y0 + 1, x0 + 1))
    if hard_boundary:
        ok = (ys >= 0) & (ys <= H - 1) & (xs >= 0) & (xs <= W - 1)
        out = np.where(ok, out, cval)
    return out


def _nearest_stack(stack, ys, xs, cval, hard_boundary=False):
    """Nearest-neighbor sample of a (Z, H, W) stack (round-half-up, the
    scipy order-0 convention). hard_boundary as in :func:`_bilinear_stack`."""
    Z, H, W = stack.shape
    yi = np.floor(ys + 0.5).astype(np.int64)
    xi = np.floor(xs + 0.5).astype(np.int64)
    inside = (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
    if hard_boundary:
        inside = (ys >= 0) & (ys <= H - 1) & (xs >= 0) & (xs <= W - 1)
    v = stack[:, np.clip(yi, 0, H - 1), np.clip(xi, 0, W - 1)]
    return np.where(inside, v, cval)


def elastic_transform(image, mask, alpha=1000, sigma=30, alpha_affine=0.04,
                      padding_value=-1.0, random_state=None):
    """Simard-style elastic deformation (semantics of brain_reader.py:248-294,
    which ports the public gist erniejunior/601cdf56d2b424757de5): a random
    small affine followed by a Gaussian-smoothed random displacement field,
    shared across z; masks sample nearest-neighbor, images bilinear.

    Own implementation: the affine is solved/inverted in closed form and both
    warp stages are numpy samplers vectorized over the whole (z, class)
    stack — no cv2, no per-slice Python loop. RNG draw order matches the
    original (affine jitter, then dx, then dy) so seeded augmentation streams
    are preserved.
    """
    from scipy.ndimage import gaussian_filter

    if random_state is None:
        random_state = np.random.RandomState(None)

    H, W = image.shape[2:]
    num_class, z = mask.shape[0], mask.shape[1]

    # random affine: jitter an equilateral-ish triangle about the center
    center = np.float32([H, W]) // 2
    half = min(H, W) // 3
    tri_src = np.float64([center + half,
                          [center[0] + half, center[1] - half],
                          center - half])
    tri_dst = tri_src + random_state.uniform(
        -alpha_affine, alpha_affine, size=tri_src.shape).astype(np.float32)
    inv = _invert_affine(_affine_from_triangle(tri_src, tri_dst))

    # smoothed random displacement field, shared by every slice and class
    dx = gaussian_filter(random_state.rand(H, W) * 2 - 1, sigma) * alpha
    dy = gaussian_filter(random_state.rand(H, W) * 2 - 1, sigma) * alpha
    xs, ys = np.meshgrid(np.arange(W), np.arange(H))

    # stage 1 coords: output pixel → affine source position
    ax = inv[0, 0] * xs + inv[0, 1] * ys + inv[0, 2]
    ay = inv[1, 0] * xs + inv[1, 1] * ys + inv[1, 2]
    # stage 2 coords: displacement resample of the affine-warped result
    ex, ey = xs + dx, ys + dy

    # stage 1 blends the border (cv2 semantics); stage 2 cuts hard at the
    # extent (scipy map_coordinates mode='constant' semantics) — matching
    # the reference's two-library pipeline
    img_stack = image.reshape(-1, H, W)
    warped = _bilinear_stack(img_stack, ay, ax, padding_value)
    new_img = _bilinear_stack(warped, ey, ex, padding_value, hard_boundary=True)

    mask_stack = mask.reshape(-1, H, W)
    wm = _nearest_stack(mask_stack, ay, ax, 0)
    new_mask = _nearest_stack(wm, ey, ex, 0, hard_boundary=True)

    return (new_img.reshape(image.shape).astype(image.dtype),
            new_mask.reshape(mask.shape).astype(mask.dtype))


def elastic_transform_all(image, mask, alpha=1000, sigma=30, alpha_affine=0.04,
                          padding_value=-1.0, random_state=None):
    """xy-plane elastic transform wrapper (brain_reader.py:208-245)."""
    return elastic_transform(image, mask, alpha, sigma, alpha_affine,
                             padding_value, random_state)


class Crop:
    """Center crop with jitter, limited by train_max_crop_size
    (brain_reader.py:297-358)."""

    def __init__(self, config):
        self.max_crop_size = config["train_max_crop_size"]
        self.pad_value = config["pad_value"]
        self.jitter = config["jitter_range"]

    def __call__(self, imgs, mask, do_jitter: bool = True):
        max_crop_size = self.max_crop_size
        img_crop_size = [int(math.ceil(d / 16.0) * 16) for d in imgs.shape[1:]]
        crop_size = [min(max_crop_size[i], img_crop_size[i]) for i in range(3)]
        target = np.array(imgs.shape[1:]) / 2 - np.array(crop_size) / 2

        start, shifts = [], []
        for i in range(3):
            if do_jitter:
                shift = np.random.randint(-self.jitter[i], self.jitter[i] + 1)
                s = target[i] + shift
                shifts.append(shift)
            else:
                s = target[i]
            start.append(int(min(s, imgs.shape[i + 1] - 1)))

        pad = [[0, 0]]
        for i in range(3):
            pad.append([max(0, -start[i]),
                        max(0, start[i] + crop_size[i] - imgs.shape[i + 1])])
        sel = tuple(slice(max(start[i], 0),
                          min(start[i] + crop_size[i], imgs.shape[i + 1]))
                    for i in range(3))
        crop = np.pad(imgs[(slice(None),) + sel], pad, "constant",
                      constant_values=self.pad_value)
        mask = np.pad(mask[(slice(None),) + sel], pad, "constant",
                      constant_values=0)
        return crop, mask, shifts


class BrainReader:
    """Volume dataset with train/eval/test modes (brain_reader.py:40-205).

    __getitem__ returns (train): [input (1,D,H,W), truth_bboxes, truth_labels,
    truth_masks, masks]; (eval) adds the original image and crop shifts.
    """

    def __init__(self, data_dir: str, set_name: str, config, mode: str = "train"):
        self.data_dir = data_dir
        self.mode = mode
        self.config = config
        if set_name.endswith(".csv"):
            names = np.genfromtxt(set_name, dtype=str, delimiter="\n")
            self.filenames = [str(n) for n in np.atleast_1d(names)]
        elif set_name.endswith(".npy"):
            self.filenames = [str(n) for n in np.load(set_name)]
        else:
            raise ValueError(set_name)
        self.crop = Crop(config)

    def __len__(self):
        return len(self.filenames)

    def _truncate(self, image):
        cfg = self.config
        return truncate_image(image, cfg["num_slice"], cfg["num_x"], cfg["num_y"])

    def load_mask(self, filename: str) -> np.ndarray:
        mask: Dict[str, np.ndarray] = {}
        for roi in self.config["roi_names"]:
            p = os.path.join(self.data_dir, f"{filename}_{roi}.nrrd")
            if os.path.isfile(p):
                m, _ = nrrd_io.read(p)
                if self.mode in ("train", "val", "eval"):
                    m = self._truncate(m)
                mask[roi] = m
        return annotation2masks(mask, roi_names=self.config["roi_names"])

    def __getitem__(self, idx: int):
        cfg = self.config
        filename = self.filenames[idx]

        if self.mode in ("train", "val", "eval"):
            mask = self.load_mask(filename).astype(np.float32)
            imgs, _ = nrrd_io.read(os.path.join(self.data_dir,
                                                f"{filename}_clean.nrrd"))
            imgs = self._truncate(imgs)[np.newaxis].astype(np.float32)
            imgs, mask = keep_only_annotation_region(imgs, mask)
            input_, masks, shifts = self.crop(imgs, mask, do_jitter=True)
            original_img = input_[0].copy()
            input_ = normalize(input_, minimum=cfg["HU_range"][0],
                               maximum=cfg["HU_range"][1])

            if (self.mode == "train" and cfg["do_elastic"]
                    and np.random.randint(2, size=1).item()):
                input_, masks = elastic_transform_all(input_, masks)

            bboxes, truth_masks = masks2bboxes_masks(masks,
                                                     border=cfg["bbox_border"])
            truth_masks = np.array(truth_masks).astype(np.uint8)
            bboxes = np.array(bboxes)
            truth_labels = bboxes[:, -1]
            truth_bboxes = bboxes[:, :-1]
            if self.mode == "eval":
                return [input_.astype(np.float32), truth_bboxes, truth_labels,
                        truth_masks, masks, original_img, shifts]
            return [input_.astype(np.float32), truth_bboxes, truth_labels,
                    truth_masks, masks]

        # test: whole padded volume, no labels
        imgs, _ = nrrd_io.read(os.path.join(self.data_dir,
                                            f"{filename}_clean.nrrd"))
        original_img = imgs.copy()
        imgs = pad2factor(imgs.astype(np.float32))[np.newaxis]
        input_ = normalize(imgs, minimum=cfg["HU_range"][0],
                           maximum=cfg["HU_range"][1])
        return [input_.astype(np.float32), original_img]
