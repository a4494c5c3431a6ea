"""Volume + slices data path for LGCANet_V3.

The port's copy of ``rpnet_tpu/episode/lgca_data.py`` (numpy only; it reads
through the port's own NRRD codec and transforms). The reference defines the
consumption contract — LGCANet_V3.forward reads ``data['volume'/'slice']``
and its loss ``target['mask'/'downsampled_volume_mask']``
(lgca_net_v3.py:593-607, :629-649) — but ships no dataset that produces
those keys; this module is that producer:

  * volume: (1, D/s, H/s, W/s, 1), the whole CT strided by
    ``context_net_downsample_scale`` (``[::sz, ::sy, ::sx]``, not pooled);
  * slices: (B, H, W, 1) full-resolution z-slices (``lgca_slices`` drawn in
    train mode, biased toward annotated z; every slice in eval mode);
  * mask: (B, H, W, K) per-ROI binary masks of those slices;
  * downsampled_volume_mask: (1, D/s, H/s, W/s, K).

The volume is truncated (centre crop) and padded with ``pad_value`` before
HU normalization to one static working shape: (``num_slice``, ``num_y``,
``num_x``) rounded up to 16 × the downsample scale. A train sample draws
from the caller's ``np.random.RandomState`` in the JAX package's order
(``rng.choice``, then ``rng.randint``), so both samplers give the same slices
from the same stream.
"""

from __future__ import annotations

import os
from collections import OrderedDict
from typing import Dict, List, Optional

import numpy as np

from rpnet_tpu_torch.core import nrrd_io
from rpnet_tpu_torch.core.transforms import normalize, truncate_image


def _pad_to(vol: np.ndarray, shape, value=0.0) -> np.ndarray:
    pads = [(0, max(0, t - s)) for s, t in zip(vol.shape, shape)]
    out = np.pad(vol, pads, "constant", constant_values=value)
    return out[tuple(slice(0, t) for t in shape)]


class LGCAVolumeSampler:
    """Whole-volume samples for LGCA training and eval."""

    def __init__(self, data_dir: str, set_name: str, config, mode: str = "train"):
        self.data_dir = data_dir
        self.mode = mode
        names = np.genfromtxt(set_name, dtype=str, delimiter="\n")
        self.filenames: List[str] = [str(n) for n in np.atleast_1d(names)]
        self.roi_names: List[str] = list(config["roi_names"])
        self.ds = tuple(int(d) for d in config.get("context_net_downsample_scale", [2, 2, 2]))
        # static working shape: a multiple of 16 for the 2D U-Net, and of the
        # downsample scale for the 3D pyramid
        D = int(config.get("num_slice", 64))
        H = int(config.get("num_y", 256))
        W = int(config.get("num_x", 256))
        rnd = lambda v, f: -(-v // f) * f
        self.shape = (rnd(D, 16 * self.ds[0]), rnd(H, 16 * self.ds[1]),
                      rnd(W, 16 * self.ds[2]))
        self.slices_per_step = int(config.get("lgca_slices", 8))
        self.pad_value = float(config.get("pad_value", -1024))
        self.hu = config.get("HU_range", [-1024, 3072])
        # volume LRU (``volume_cache`` entries, 0 disables): loading is
        # config-deterministic and training revisits every volume each epoch;
        # entries are read-only
        self._vol_cache: "OrderedDict[str, tuple]" = OrderedDict()
        self._vol_cache_max = int(config.get("volume_cache", 8))

    def __len__(self) -> int:
        return len(self.filenames)

    def _load(self, pid: str):
        hit = self._vol_cache.get(pid)
        if hit is not None:
            self._vol_cache.move_to_end(pid)
            return hit
        crop = (self.shape[0], self.shape[2], self.shape[1])   # num_slice, num_x, num_y
        vol, _ = nrrd_io.read(os.path.join(self.data_dir, f"{pid}_clean.nrrd"))
        vol = _pad_to(truncate_image(np.asarray(vol, np.float32), *crop), self.shape,
                      self.pad_value)
        masks = np.zeros(self.shape + (len(self.roi_names),), np.float32)
        for ki, roi in enumerate(self.roi_names):
            p = os.path.join(self.data_dir, f"{pid}_{roi}.nrrd")
            if os.path.isfile(p):
                m, _ = nrrd_io.read(p)
                masks[..., ki] = _pad_to(truncate_image(np.asarray(m, np.float32), *crop),
                                         self.shape, 0.0)
        vol = normalize(vol, minimum=self.hu[0], maximum=self.hu[1]).astype(np.float32)
        if self._vol_cache_max > 0:
            vol.flags.writeable = False
            masks.flags.writeable = False
            self._vol_cache[pid] = (vol, masks)
            if len(self._vol_cache) > self._vol_cache_max:
                self._vol_cache.popitem(last=False)
        return vol, masks

    def sample(self, idx: int, rng: Optional[np.random.RandomState] = None
               ) -> Dict[str, np.ndarray]:
        """One training sample, or in eval mode the whole volume's slices."""
        pid = self.filenames[idx]
        vol, masks = self._load(pid)
        sz, sy, sx = self.ds
        volume = vol[::sz, ::sy, ::sx][None, ..., None]
        vmask = masks[::sz, ::sy, ::sx][None]

        if self.mode == "train":
            rng = rng or np.random.RandomState()
            # bias the slice draw toward annotated z (class imbalance)
            has_fg = masks.reshape(masks.shape[0], -1).max(axis=1) > 0
            pool = np.flatnonzero(has_fg)
            if pool.size == 0:
                pool = np.arange(vol.shape[0])
            n_fg = min(self.slices_per_step - self.slices_per_step // 4, pool.size)
            pick_fg = rng.choice(pool, size=n_fg, replace=pool.size < n_fg)
            pick_any = rng.randint(0, vol.shape[0], size=self.slices_per_step - n_fg)
            zidx = np.concatenate([pick_fg, pick_any])
        else:
            zidx = np.arange(vol.shape[0])

        return {
            "pid": pid,
            "volume": volume.astype(np.float32),
            "downsampled_volume_mask": vmask.astype(np.float32),
            "slices": vol[zidx][..., None].astype(np.float32),
            "mask": masks[zidx].astype(np.float32),
            "slice_idx": zidx.astype(np.int32),
        }
