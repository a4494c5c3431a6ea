"""Whole-volume sliding-window episodic eval (``eval_3d``, BASELINE config 5).

The counterpart of ``rpnet_tpu/episode/volume3d.py``. Every query slice gets
the support slice at the nearest normalized z-position, and the volume runs
in overlapping z-windows of the episode function:

  * the window is the runner's ``bucket`` (``slice_bucket``, rounded up
    to the data axis of a sharded runner, as the JAX runner rounds its
    bucket), the overlap min(``overlap_3d``, window // 2), and the last
    window is clamped inside the volume;
  * a sharded runner (``EpisodeRunner(mesh=...)``) splits each window's
    slices over its data devices;
  * window i + 1 is queued before window i is settled;
  * with a device volume cache the windows go as :class:`EpisodeSpec` row
    indices into volumes held on the device;
  * the overlapping windows' last-refinement masks and priors average, then
    threshold at 0.5. They are the THRESHOLDED masks (the JAX runner's
    ``prediction``), not probabilities, whatever the JAX docstrings say.
"""

from __future__ import annotations

import dataclasses
import random
from typing import List, Optional

import numpy as np

from rpnet_tpu_torch.core.metrics import dice_score_seperate
from rpnet_tpu_torch.episode.pipeline import EpisodeRunner
from rpnet_tpu_torch.episode.sampler import Episode, EpisodeSampler, EpisodeSpec


def match_support_slices(n_support: int, n_query: int) -> np.ndarray:
    """Nearest normalized-z support index for each query slice."""
    if n_query == 1:
        return np.zeros((1,), np.int32)
    q = np.arange(n_query) / (n_query - 1)
    return np.clip(np.round(q * (n_support - 1)), 0, n_support - 1).astype(np.int32)


def window_starts(n_slices: int, window: int, overlap: int) -> List[int]:
    """The first slice of each window; the last clamped inside the volume."""
    starts = range(0, max(n_slices - overlap, 1), window - overlap)
    return sorted({min(s, max(n_slices - window, 0)) for s in starts})


@dataclasses.dataclass
class VolumeResult:
    prediction: np.ndarray       # (Dq, H, W) binary
    appr_label: np.ndarray       # (Dq, H, W) registration prior
    dsc_affine: Optional[float]
    dsc_fewshot: Optional[float]
    n_windows: int


class Volume3DRunner:
    """Sliding-window whole-volume eval on top of :class:`EpisodeRunner`."""

    def __init__(self, runner: EpisodeRunner, window: int = 32, overlap: int = 8):
        self.runner = runner
        self.window = window
        self.overlap = min(overlap, window // 2)

    def run_volume(self, support_vol: np.ndarray, support_lab: np.ndarray,
                   query_vol: np.ndarray, query_lab: np.ndarray,
                   sampler=None, supp_key=None, qry_key=None) -> VolumeResult:
        """support_vol/lab: (Ds, H, W); query_vol/lab: (Dq, H, W). With
        ``sampler`` and both volume keys, on a runner with a device volume
        cache, each window is an :class:`EpisodeSpec` (the same values as the
        host slices)."""
        Dq, H, W = query_vol.shape
        match = match_support_slices(support_vol.shape[0], Dq)
        use_spec = (sampler is not None and supp_key is not None
                    and qry_key is not None and self.runner.supports_spec)
        if not use_spec:
            supp_img = support_vol[match]
            supp_lab = support_lab[match]

        starts = window_starts(Dq, self.window, self.overlap)
        pred_sum = np.zeros((Dq, H, W), np.float64)
        prior_sum = np.zeros((Dq, H, W), np.float64)
        counts = np.zeros((Dq, 1, 1), np.float64)
        pending = None
        for s in starts + [None]:
            queued = None
            if s is not None:
                e = min(s + self.window, Dq)
                if use_spec:
                    spec = EpisodeSpec(supp_key, qry_key, match[None, s:e], e - s, 0, "",
                                       [(0, 0)], qry_rows=np.arange(s, e, dtype=np.int32))
                    queued = (s, e, self.runner.dispatch_spec(spec, sampler, arrays=True))
                else:
                    ep = Episode(
                        support_images=supp_img[None, s:e].astype(np.float32),
                        support_labels=supp_lab[None, s:e].astype(np.float32),
                        query_images=query_vol[s:e].astype(np.float32),
                        query_labels=query_lab[s:e].astype(np.float32),
                        class_id=0, pid="", supp_pids=[(0, 0)])
                    queued = (s, e, self.runner.dispatch(ep, arrays=True))
            if pending is not None:
                ps, pe, d = pending
                res = self.runner.finalize(d)
                pred_sum[ps:pe] += res["prediction"][:pe - ps]
                prior_sum[ps:pe] += res["appr_label"][:pe - ps]
                counts[ps:pe] += 1.0
            pending = queued

        pred = (pred_sum / np.maximum(counts, 1) > 0.5).astype(np.float32)
        prior = (prior_sum / np.maximum(counts, 1) > 0.5).astype(np.float32)
        dsc_few = dice_score_seperate(pred[None], query_lab[None], num_class=1)[0]
        dsc_aff = dice_score_seperate(prior[None], query_lab[None], num_class=1)[0]
        return VolumeResult(prediction=pred, appr_label=prior, dsc_affine=dsc_aff,
                            dsc_fewshot=dsc_few, n_windows=len(starts))


class Volume3DSampler:
    """Whole-volume episodes (the reference's Fewshot3DReader intent):
    ``sample(idx)`` → (support_vol, support_lab, query_vol, query_lab, meta).
    The support volume is drawn by stdlib ``random.choices``, as the JAX
    sampler draws it, so one seed picks the same support in both. A caller
    that samples only some volumes (a process's shard) draws every volume's
    support first (:meth:`draw_support`), in order, and passes its own
    ``pick``: then a shard sees the supports of a single-process run."""

    def __init__(self, sampler: EpisodeSampler):
        self.sampler = sampler

    def __len__(self):
        return len(self.sampler)

    def draw_support(self, idx: int) -> int:
        """The support volume of volume ``idx``, from the stdlib stream."""
        s = self.sampler
        ci, di = s.indices[idx]
        pool = [i for i in range(len(s.data_info[ci])) if i != di]
        return random.choices(pool, k=1)[0]

    def sample(self, idx: int, pick: Optional[int] = None):
        s = self.sampler
        ci, di = s.indices[idx]
        pid = s.data_info[ci][di]["pid"]
        if pick is None:
            pick = self.draw_support(idx)
        supp_pid = s.data_info[ci][pick]["pid"]
        supp_img, supp_lab = s.load_image_and_mask(supp_pid, s.classes[ci])
        qry_img, qry_lab = s.load_image_and_mask(pid, s.classes[ci])
        return (supp_img, supp_lab, qry_img, qry_lab,
                {"pid": pid, "supp_pid": supp_pid, "class_id": ci,
                 "supp_key": (supp_pid, s.classes[ci]),
                 "qry_key": (pid, s.classes[ci])})
