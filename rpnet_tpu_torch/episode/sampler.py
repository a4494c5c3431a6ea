"""Host-side episodic sampler: volumes → fixed-shape slice episodes.

The port's copy of ``rpnet_tpu/episode/sampler.py``
(dataset/few_shot_reader.py):

  * volume loading + preprocessing  — FewshotVolumeReader.load_image_and_mask
    (few_shot_reader.py:324-345): NRRD read → truncate → pad2factor(16) →
    z-crop to annotation → center-crop → HU normalize;
  * episode index & support sampling — (class, volume) pairs, supports drawn
    by ``random.choices`` excluding the query (few_shot_reader.py:255-283).
    Stdlib ``random`` is kept on purpose: both packages consume the same
    stream, so a seed draws the same supports in either CLI;
  * slice binning — k evenly spaced support slices matched to query-slice
    bins (few_shot_reader.py:465-545), with the eval-mode ``test_shot``
    shot-offset expansion, or with ``use_all_supports`` one shot per
    support volume;
  * the index-only eval episode — :meth:`EpisodeSampler.sample_spec` gives
    an :class:`EpisodeSpec` (volume keys and slice rows) that the runner
    assembles on the device from its volume cache;
  * train-mode augmentation — gamma jitter + random affine + shuffle
    (few_shot_reader.py:482-515), drawing from stdlib ``random`` and the
    global numpy stream in the JAX package's order, so both samplers give
    identical training episodes from one seed. The affine warp is numpy
    (:func:`warp_affine_nearest`), value for value OpenCV's.

Volumes are read through the native raw cache (``core/native_cache.py``,
a C++ decoder and a ``.rawcache`` beside each NRRD or under
``io_cache_dir``) when ``use_native_io`` is on, the default, and through the
port's Python NRRD codec otherwise; ``EpisodeSampler.io_reads`` counts the
files each path read. Split files are ``.csv`` (one pid per line) or
``.npy`` (an array of pids).

Reference defects kept as the JAX package keeps them: the eval support loop
overwrites across supports, so only the LAST sampled support volume is used
(unless ``use_all_supports``).
"""

from __future__ import annotations

import csv
import dataclasses
import os
import random
import threading
from collections import Counter, OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from rpnet_tpu_torch.core import native_cache, nrrd_io
from rpnet_tpu_torch.core.transforms import (crop, gamma_transform,
                                             keep_only_annotation_z_slices,
                                             normalize, pad2factor,
                                             truncate_image)


@dataclasses.dataclass
class Episode:
    """One eval or train episode, fixed shapes, slice axis leading, all float32.

      support_images: (test_shot, Dq, H, W) in [-1, 1]
      support_labels: (test_shot, Dq, H, W) binary
      query_images:   (Dq, H, W) in [-1, 1]
      query_labels:   (Dq, H, W) binary
    """
    support_images: np.ndarray
    support_labels: np.ndarray
    query_images: np.ndarray
    query_labels: np.ndarray
    class_id: int
    pid: str
    supp_pids: List[Tuple[int, int]]

    @property
    def n_slices(self) -> int:
        return self.query_images.shape[0]


@dataclasses.dataclass
class EpisodeSpec:
    """An eval episode as volume keys and slice indices (the JAX package's
    ``EpisodeSpec``): eval assembly is pure indexing (support slices repeat
    per query bin, the query volume feeds through whole), so the runner
    gathers the rows on the device from volumes it uploaded once.
    """
    supp_key: Tuple[str, str]       # (pid, roi) of the last support volume
    qry_key: Tuple[str, str]
    supp_rows: np.ndarray           # (test_shot, Dq) int32 rows into support
    n_slices: int                   # Dq
    class_id: int
    pid: str
    supp_pids: List[Tuple[int, int]]
    qry_rows: Optional[np.ndarray] = None   # (Dq,) query rows; None: 0..Dq-1


def slice_bins(num_support_slices: Sequence[int], num_query_slices: int, k: int):
    """Support/query slice binning (few_shot_reader.py:465-473).

    Returns (k, support_indices per support, query_bin_edges).
    """
    nums = list(num_support_slices) + [num_query_slices]
    k = min([k] + nums)
    support_idx = [
        np.floor(np.arange(n / k / 2, n, n / k)).astype(np.int32)[:k]
        for n in num_support_slices
    ]
    edges = np.arange(0, num_query_slices, num_query_slices / k).tolist() + [num_query_slices]
    edges = np.floor(np.array(edges)).astype(np.int32)[:k + 1]
    edges[-1] = num_query_slices
    return k, support_idx, edges


class EpisodeSampler:
    """Episodic dataset over a preprocessed NRRD directory; ``mode`` is
    "eval" (eval_classes) or "train" (train_classes, augmented episodes)."""

    def __init__(self, data_dir: str, set_name: str, config, mode: str = "eval"):
        if mode not in ("eval", "train"):
            raise ValueError(f"mode {mode!r}: 'eval' or 'train'")
        self.data_dir = data_dir
        self.cfg = config
        self.mode = mode
        self.class_csv_dir = config["class_csv_dir"]

        if set_name.endswith(".csv"):
            names = np.genfromtxt(set_name, dtype=str, delimiter="\n")
            self.filenames = [str(n) for n in np.atleast_1d(names)]
        elif set_name.endswith(".npy"):
            self.filenames = [str(n) for n in np.load(set_name)]
        else:
            raise ValueError(f"unsupported split file {set_name} (.csv or .npy)")

        self.classes = (config["train_classes"] if mode == "train"
                        else config["eval_classes"])
        self._read_data_meta()
        self.indices: List[Tuple[int, int]] = [
            (ci, di) for ci in range(len(self.classes))
            for di in range(len(self.data_info[ci]))
        ]
        # LRU over load_image_and_mask results: every eval run revisits the
        # same volumes, and the chain is deterministic given the config.
        # Entries are returned read-only. ``volume_cache: 0`` disables.
        self._vol_cache: "OrderedDict[Tuple[str, str], Tuple[np.ndarray, np.ndarray]]" = OrderedDict()
        self._vol_cache_max = int(config.get("volume_cache", 8))
        self._vol_lock = threading.Lock()   # prefetch threads share the LRU
        # files read by each path: "rawcache" and "native" (the C++ decoder),
        # "nrrd_io" (the Python codec)
        self.io_reads: Counter = Counter()

    def _read_data_meta(self):
        self.data_info: List[List[Dict]] = []
        names = set(self.filenames)
        for roi in self.classes:
            rows = []
            with open(os.path.join(self.class_csv_dir, f"{roi}.csv")) as f:
                for row in csv.DictReader(f):
                    if row["pid"] in names:
                        rows.append({"pid": row["pid"],
                                     "z_start": row["z_start"],
                                     "z_end": row["z_end"]})
            self.data_info.append(rows)

    def __len__(self):
        return len(self.indices)

    def _read_volume(self, path: str) -> np.ndarray:
        """An NRRD volume, through the native raw cache when
        ``use_native_io`` is on (``rpnet_tpu/episode/sampler.py:159-170``)."""
        if self.cfg.get("use_native_io", True):
            arr, meta = native_cache.read_cached(path, cache_dir=self.cfg.get("io_cache_dir"))
            how = ("rawcache" if meta.get("cached") else "native") if meta["native"] \
                else "nrrd_io"
        else:
            arr, _ = nrrd_io.read(path)
            how = "nrrd_io"
        with self._vol_lock:
            self.io_reads[how] += 1
        return arr

    def load_image_and_mask(self, pid: str, roi: str):
        """The per-volume preprocessing chain (few_shot_reader.py:324-345)."""
        key = (pid, roi)
        with self._vol_lock:
            hit = self._vol_cache.get(key)
            if hit is not None:
                self._vol_cache.move_to_end(key)
                return hit
        cfg = self.cfg
        pad_factor = 16
        mask = self._read_volume(os.path.join(self.data_dir, f"{pid}_{roi}.nrrd"))
        mask = mask.astype(np.float32)
        mask = truncate_image(mask, cfg["num_slice"], cfg["num_x"], cfg["num_y"])
        mask = pad2factor(mask, factor=pad_factor, pad_value=0)[None]

        imgs = self._read_volume(os.path.join(self.data_dir, f"{pid}_clean.nrrd"))
        imgs = truncate_image(imgs.astype(np.float32), cfg["num_slice"],
                              cfg["num_x"], cfg["num_y"])
        imgs = pad2factor(imgs, factor=pad_factor, pad_value=cfg["pad_value"])[None]

        imgs, mask = keep_only_annotation_z_slices(imgs, mask)
        imgs, mask = crop(imgs, mask, cfg.get("crop_size", [256, 256]),
                          cfg.get("pad_value", -1024), 0)
        imgs = normalize(imgs, minimum=cfg["HU_range"][0], maximum=cfg["HU_range"][1])
        imgs, mask = imgs[0], mask[0]   # (D, H, W) each
        if self._vol_cache_max > 0:
            imgs.flags.writeable = False   # cache entries are shared views
            mask.flags.writeable = False
            with self._vol_lock:
                self._vol_cache[key] = (imgs, mask)
                if len(self._vol_cache) > self._vol_cache_max:
                    self._vol_cache.popitem(last=False)
        return imgs, mask

    def draw_supports(self, idx: int) -> List[int]:
        """Draw the support picks for episode ``idx`` from the stdlib RNG
        (the few_shot_reader.py:255-283 sequence). Callers pre-draw all
        episodes of a pass, as the JAX CLI does."""
        ci, di = self.indices[idx]
        pool = [i for i in range(len(self.data_info[ci])) if i != di]
        return random.choices(pool, k=self.cfg["n_shot"])

    def sample(self, idx: int, picks: Optional[List[int]] = None) -> Episode:
        ci, di = self.indices[idx]
        pid = self.data_info[ci][di]["pid"]
        if picks is None:
            picks = self.draw_supports(idx)
        supports = [self.load_image_and_mask(self.data_info[ci][i]["pid"],
                                             self.classes[ci]) for i in picks]
        qry_img, qry_mask = self.load_image_and_mask(pid, self.classes[ci])
        if self.mode == "train":
            ep = self._assemble_train(supports, qry_img, qry_mask)
        else:
            ep = self._assemble_eval(supports, qry_img, qry_mask)
        return dataclasses.replace(ep, class_id=ci, pid=pid,
                                   supp_pids=[(ci, i) for i in picks])

    def sample_spec(self, idx: int,
                    picks: Optional[List[int]] = None) -> Optional[EpisodeSpec]:
        """The index-only twin of :meth:`sample` for the reference eval
        semantics (eval mode, last support wins). ``None`` where the episode
        needs host assembly: train mode, ``use_all_supports``,
        ``multishot_fusion``, or support and query crops of different
        shapes; callers then use :meth:`sample`. Draws from the same
        support stream as :meth:`sample`."""
        cfg = self.cfg
        if (self.mode != "eval" or cfg.get("use_all_supports")
                or cfg.get("multishot_fusion")):
            return None
        ci, di = self.indices[idx]
        pid = self.data_info[ci][di]["pid"]
        if picks is None:
            picks = self.draw_supports(idx)
        roi = self.classes[ci]
        supp_pid = self.data_info[ci][picks[-1]]["pid"]   # last support wins
        s_img, _ = self.load_image_and_mask(supp_pid, roi)
        q_img, _ = self.load_image_and_mask(pid, roi)
        if s_img.shape[1:] != q_img.shape[1:]:
            return None
        nq = q_img.shape[0]
        test_shot = cfg.get("test_shot", cfg["n_shot"])
        return EpisodeSpec((supp_pid, roi), (pid, roi),
                           _shot_rows(s_img.shape[0], nq, cfg["k"], test_shot),
                           nq, ci, pid, [(ci, i) for i in picks])

    def _assemble_eval(self, supports, qry_img, qry_mask) -> Episode:
        cfg = self.cfg
        nq = qry_img.shape[0]
        if cfg.get("use_all_supports", False):
            # one shot per support volume, each matched to the query bins
            k, supp_idx, edges = slice_bins([s[0].shape[0] for s in supports], nq,
                                            cfg["k"])
            bins = np.repeat(np.arange(k), np.diff(edges))
            support_images = np.stack([img[supp_idx[i][bins]]
                                       for i, (img, _) in enumerate(supports)])
            support_labels = np.stack([lab[supp_idx[i][bins]]
                                       for i, (_, lab) in enumerate(supports)])
        else:
            # reference defect replicated: only the last support volume
            # survives the loop (few_shot_reader.py:521-545); its slice-offset
            # "shots"
            s_img, s_lab = supports[-1]
            rows = _shot_rows(s_img.shape[0], nq, cfg["k"],
                              cfg.get("test_shot", cfg["n_shot"]))
            support_images = s_img[rows]               # (shots, Dq, H, W)
            support_labels = s_lab[rows]

        support_images, support_labels, qry_img, qry_mask = _pad_same_hw(
            support_images, support_labels, qry_img, qry_mask)
        return Episode(support_images.astype(np.float32),
                       support_labels.astype(np.float32),
                       qry_img.astype(np.float32), qry_mask.astype(np.float32),
                       -1, "", [])


    def _assemble_train(self, supports, qry_img, qry_mask) -> Episode:
        """k support slices per support volume and one random query slice
        per bin, each gamma-jittered (``do_intaug``, half the time) and
        randomly warped, then shuffled together."""
        cfg = self.cfg
        nq = qry_img.shape[0]
        k, supp_idx, edges = slice_bins([s[0].shape[0] for s in supports], nq, cfg["k"])

        s_img = np.stack([supports[i][0][supp_idx[i]] for i in range(len(supports))])
        s_lab = np.stack([supports[i][1][supp_idx[i]] for i in range(len(supports))])

        q_imgs, q_labs = [], []
        for j in range(k):
            s, e = int(edges[j]), int(edges[j + 1])
            ind = random.randint(s, max(e - 1, s))
            q = qry_img[ind]
            l = qry_mask[ind]
            if cfg["do_intaug"] and np.random.randint(2, size=1).item():
                q = gamma_transform(q, cfg.get("gamma_range", [0.5, 1.5]))
            q, l = random_affine_2d(q, l)
            q_imgs.append(q)
            q_labs.append(l)
        q_imgs = np.stack(q_imgs)
        q_labs = np.stack(q_labs)

        shuffle = np.arange(k)
        np.random.shuffle(shuffle)
        s_img = s_img[:, shuffle]
        s_lab = s_lab[:, shuffle]
        q_imgs = q_imgs[shuffle]
        q_labs = q_labs[shuffle]

        s_img, s_lab, q_imgs, q_labs = _pad_same_hw(s_img, s_lab, q_imgs, q_labs)
        return Episode(s_img.astype(np.float32), s_lab.astype(np.float32),
                       q_imgs.astype(np.float32), q_labs.astype(np.float32),
                       -1, "", [])


def _shot_rows(n_support: int, nq: int, k: int, test_shot: int) -> np.ndarray:
    """(test_shot, nq) int32 support rows of the eval episode: shot m takes
    bin j's support slice from bin j + m (bin j itself where j + m runs past
    the last bin), repeated over the query slices of bin j
    (few_shot_reader.py:516-545)."""
    k, supp_idx, edges = slice_bins([n_support], nq, k)
    rows = np.zeros((test_shot, nq), np.int32)
    for m in range(test_shot):
        for j in range(k):
            offset = 0 if j + m >= k else m
            rows[m, edges[j]:edges[j + 1]] = supp_idx[0][j + offset]
    return rows


def _pad_same_hw(s_img, s_lab, q_img, q_lab):
    """Pad support & query to a common (H, W) (few_shot_reader.py:78-106)."""
    H = max(s_img.shape[-2], q_img.shape[-2])
    W = max(s_img.shape[-1], q_img.shape[-1])

    def pad_to(a, fill):
        pads = [(0, 0)] * (a.ndim - 2) + [(0, H - a.shape[-2]), (0, W - a.shape[-1])]
        return np.pad(a, pads, constant_values=fill)

    return (pad_to(s_img, s_img.min()), pad_to(s_lab, 0),
            pad_to(q_img, q_img.min()), pad_to(q_lab, 0))


def rotation_matrix_2d(center, angle: float, scale: float) -> np.ndarray:
    """``cv2.getRotationMatrix2D``: the (2, 3) float64 matrix that rotates by
    ``angle`` degrees (counter-clockwise) and scales about ``center`` (x, y)."""
    a = angle * (np.pi / 180)
    alpha, beta = np.cos(a) * scale, np.sin(a) * scale
    cx, cy = center
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]])


def invert_affine(M: np.ndarray) -> np.ndarray:
    """``cv2.invertAffineTransform`` in float64, OpenCV's operation order."""
    m = np.asarray(M, np.float64).ravel()
    D = m[0] * m[4] - m[1] * m[3]
    D = 1.0 / D if D != 0 else 0.0
    a11, a22, a12, a21 = m[4] * D, m[0] * D, -m[1] * D, -m[3] * D
    b1 = -a11 * m[2] - a12 * m[5]
    b2 = -a21 * m[2] - a22 * m[5]
    return np.array([[a11, a12, b1], [a21, a22, b2]])


def _fma32(a, b, c) -> np.ndarray:
    """float32 fused multiply-add (the product of two float32 is exact in
    float64; the sum is rounded once more to float32)."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(np.float32)


def warp_affine_nearest(src: np.ndarray, M: np.ndarray, fill: float = 0.0) -> np.ndarray:
    """``cv2.warpAffine(src, M, (W, H), flags=INTER_NEAREST, borderValue=fill)``
    in numpy, for a 2-D float image.

    OpenCV 5 maps output pixel (x, y) through the inverse of M held in
    float32: the row term ``y·m1 + m2`` is a float32 product and sum, the
    column term a float32 fused multiply-add ``m0·x + row``; the source pixel
    is that coordinate rounded half to even, and pixels mapped outside the
    image take ``fill``. (OpenCV 4's fixed-point coordinates, 10 fractional
    bits, round differently on about 0.1% of pixels.)
    """
    H, W = src.shape
    m = invert_affine(M).astype(np.float32).ravel()
    y = np.arange(H, dtype=np.float32)[:, None]
    x = np.arange(W, dtype=np.float32)[None, :]
    sx = np.rint(_fma32(m[0], x, y * m[1] + m[2]))
    sy = np.rint(_fma32(m[3], x, y * m[4] + m[5]))
    inside = (sx >= 0) & (sx < W) & (sy >= 0) & (sy < H)
    out = np.full((H, W), fill, dtype=src.dtype)
    out[inside] = src[sy[inside].astype(np.int64), sx[inside].astype(np.int64)]
    return out


def random_affine_2d(img: np.ndarray, label: np.ndarray,
                     degrees: float = 5.0, translate: float = 0.2,
                     scale_range=(0.7, 1.5)):
    """Train-time random affine (random_transform, few_shot_reader.py:27-47):
    torchvision RandomAffine semantics with nearest interpolation; empty
    (fill) pixels take the image minimum (few_shot_reader.py:44). Draws four
    ``np.random.uniform`` in the JAX package's order."""
    H, W = img.shape
    ang = np.random.uniform(-degrees, degrees)
    tx = np.random.uniform(-translate, translate) * W
    ty = np.random.uniform(-translate, translate) * H
    sc = np.random.uniform(*scale_range)
    M = rotation_matrix_2d((W / 2, H / 2), ang, sc)
    M[0, 2] += tx
    M[1, 2] += ty
    img01 = (img + 1) / 2
    warped = warp_affine_nearest(img01, M)
    lab = warp_affine_nearest(label, M)
    warped[warped == 0] = img01.min()
    return warped * 2 - 1, lab
