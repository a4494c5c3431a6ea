"""Offline registration helpers (rebuild of utils/registration.py).

The counterpart of ``rpnet_tpu/preprocess/offline_registration.py``. The
reference uses SimpleITK for offline nearest-neighbor support selection and
rigid/affine pre-registration (utils/registration.py:55-233). This rebuild
is SimpleITK-free:

  * :func:`histogram_distance` / :func:`find_nearest_patient` — pick the most
    similar support volume by intensity-histogram distance
    (utils/registration.py:55); copies of the JAX module's;
  * :func:`affine_register_volumes` — volume-level affine pre-registration
    on the port's own fit (``registration/affine.fit_affine``, every fitted
    slice in one batch, then the median theta), replacing sitk's
    rigid/affine optimizer (utils/registration.py:177). The fit samples
    with ``F.grid_sample``, as the JAX fit's ``sampler="gather"`` does; the
    JAX function fits with its default matmul sampler, which takes another
    trajectory from the identity theta (every sample point on a knife edge);
  * :func:`resample_to_reference` — shape-matching resample
    (utils/registration.py:214); a copy.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch


def histogram_distance(vol_a: np.ndarray, vol_b: np.ndarray,
                       bins: int = 64, lo: float = -1024, hi: float = 3072) -> float:
    """L1 distance between normalized intensity histograms."""
    ha, _ = np.histogram(vol_a, bins=bins, range=(lo, hi))
    hb, _ = np.histogram(vol_b, bins=bins, range=(lo, hi))
    ha = ha / max(ha.sum(), 1)
    hb = hb / max(hb.sum(), 1)
    return float(np.abs(ha - hb).sum())


def find_nearest_patient(query_vol: np.ndarray,
                         candidates: Dict[str, np.ndarray],
                         bins: int = 64) -> Tuple[str, float]:
    """Nearest support patient by histogram distance
    (utils/registration.py:55 semantics)."""
    best, best_d = None, np.inf
    for pid, vol in candidates.items():
        d = histogram_distance(query_vol, vol, bins=bins)
        if d < best_d:
            best, best_d = pid, d
    return best, best_d


def _norm01(v: np.ndarray) -> np.ndarray:
    lo, hi = np.percentile(v, [1, 99])
    return np.clip((v - lo) / max(hi - lo, 1e-6), 0, 1).astype(np.float32)


def affine_register_volumes(moving: np.ndarray, fixed: np.ndarray,
                            iters: int = 50, n_slices: int = 5, device=None):
    """Volume-level 2D-affine pre-registration.

    Fits per-slice affines on ``n_slices`` evenly spaced slices (both
    volumes mapped to [0, 1] by their 1st and 99th percentiles), in one
    batch, takes the median theta, and warps every moving slice with it.
    Runs on ``device``: the card by default (raises without one), or the
    CPU. Returns (warped_volume, theta (2, 3)) as numpy."""
    from rpnet_tpu_torch.registration.affine import affine_warp, fit_affine

    device = torch.device(device if device is not None else "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("affine_register_volumes: no CUDA device is available "
                           "(pass device='cpu' to run on the CPU)")
    D = min(moving.shape[0], fixed.shape[0])
    ids = np.linspace(0, D - 1, min(n_slices, D)).astype(int)
    mv = torch.from_numpy(_norm01(moving)[ids][..., None]).to(device)
    fx = torch.from_numpy(_norm01(fixed)[ids][..., None]).to(device)
    thetas, _ = fit_affine(mv, fx, iters=iters)
    theta = np.median(thetas.cpu().numpy(), axis=0)

    vol = torch.from_numpy(np.ascontiguousarray(moving, np.float32))[..., None].to(device)
    th = torch.from_numpy(theta.astype(np.float32)).to(device).expand(vol.shape[0], 2, 3)
    warped = affine_warp(vol, th)[..., 0].cpu().numpy()
    return warped, theta


def resample_to_reference(moving: np.ndarray, reference_shape: Sequence[int],
                          order: int = 1) -> np.ndarray:
    """Zoom a volume to a reference shape (utils/registration.py:214)."""
    import scipy.ndimage

    factors = [r / s for r, s in zip(reference_shape, moving.shape)]
    return scipy.ndimage.zoom(moving, factors, order=order, mode="nearest")
