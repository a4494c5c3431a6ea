"""Synthetic CT volumes for the benchmark, made from the seed on the device.

The benchmark's own copy of the 4-organ generator in
``rpnet_tpu_torch/core/synthetic.py`` (ellipsoid organs inside an elliptical
body, the organs' centres and radii as fractions of the volume, HU-like
intensities), rewritten in torch so that a run makes its volumes on the card
in a few large calls, with one change: an organ may be given an exact z
extent, so that a cell's queries have the lengths its traffic file states.
Every draw comes from one ``torch.Generator`` seeded by the caller; the same
seed on the same device gives the same volumes.

The files are written in the layout of the program's episodic readers:
``data/{pid}_clean.nrrd`` (int16, raw encoding) and ``data/{pid}_{roi}.nrrd``
(uint8, gzip level 1: the masks are mostly zeros), ``split/<name>.csv`` (one
pid a line) and ``split/classes/{roi}.csv`` (``pid,z_start,z_end,path``).
"""

from __future__ import annotations

import gzip
import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

# centre (z, y, x) and radii (z, y, x) as fractions of the volume
# (``core/synthetic.ORGANS``), and each organ's HU mean and spread
ORGANS = {
    "Liver": (0.45, 0.45, 0.38, 0.30, 0.16, 0.22),
    "Spleen": (0.55, 0.55, 0.68, 0.18, 0.10, 0.12),
    "Kidney L": (0.60, 0.62, 0.62, 0.16, 0.09, 0.10),
    "Kidney R": (0.60, 0.62, 0.30, 0.16, 0.09, 0.10),
}
HU = {"Liver": (65.0, 6.0), "Spleen": (52.0, 6.0), "Kidney L": (35.0, 5.0),
      "Kidney R": (35.0, 5.0)}


def _ellipsoid(grid, center, radii):
    z, y, x = grid
    return (((z - center[0]) / radii[0]) ** 2 + ((y - center[1]) / radii[1]) ** 2
            + ((x - center[2]) / radii[2]) ** 2) <= 1.0


def make_volume(shape: Tuple[int, int, int], rois: Sequence[str],
                extents: Optional[Dict[str, int]], gen: torch.Generator, device
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One CT (int16, HU) and a uint8 mask per ROI, on ``device``.

    ``extents[roi]`` = e makes the ROI's annotated z range exactly e + 1
    slices (``z_end - z_start`` = e, the readers' query length): the
    ellipsoid's z radius is (e + 1)/2 + 0.5 about the range's centre and the
    mask is cut to the range, so every slice of it holds organ voxels."""
    D, H, W = shape
    f32 = dict(dtype=torch.float32, device=device)
    grid = (torch.arange(D, **f32)[:, None, None], torch.arange(H, **f32)[None, :, None],
            torch.arange(W, **f32)[None, None, :])
    u = torch.rand(2 + 7 * len(ORGANS), generator=gen, **f32).cpu().numpy()
    noise = torch.randn(shape, generator=gen, **f32)
    body = _ellipsoid(grid, (D / 2, H / 2, W / 2),
                      (D * 0.7, H * 0.42 + 4 * u[0] - 2, W * 0.45 + 4 * u[1] - 2))
    vol = torch.where(body, 20.0 + 30.0 * noise, torch.full((), -1000.0, **f32))
    masks: Dict[str, torch.Tensor] = {}
    for i, (roi, (cz, cy, cx, rz, ry, rx)) in enumerate(ORGANS.items()):
        j = u[2 + 7 * i: 9 + 7 * i]
        center = [(cz + 0.08 * j[0] - 0.04) * D, (cy + 0.08 * j[1] - 0.04) * H,
                  (cx + 0.08 * j[2] - 0.04) * W]
        radii = [max(rz * D * (0.8 + 0.4 * j[3]), 2.0), max(ry * H * (0.8 + 0.4 * j[4]), 3.0),
                 max(rx * W * (0.8 + 0.4 * j[5]), 3.0)]
        m = body.clone()
        e = (extents or {}).get(roi)
        if e is not None:
            if e + 1 > D:
                raise ValueError(f"{roi}: an extent of {e} needs more than {D} slices")
            z0 = int(np.clip(round(center[0] - (e + 1) / 2), 0, D - e - 1))
            center[0], radii[0] = z0 + e / 2, (e + 1) / 2 + 0.5
            m &= (grid[0] >= z0) & (grid[0] <= z0 + e)
        m &= _ellipsoid(grid, center, radii)
        mu, sd = HU[roi]
        vol = torch.where(m, mu + sd * noise, vol)
        if roi in rois:
            masks[roi] = m.to(torch.uint8)
    return vol.round().clamp(-1024, 3072).to(torch.int16), masks


def write_nrrd(path: str, data: np.ndarray, encoding: str = "raw") -> None:
    """``data`` as NRRD, the first listed size the fastest axis on disk (the
    layout the program's readers take back to ``data.shape``)."""
    names = {"int16": "int16", "uint8": "uint8"}
    lines = ["NRRD0004", f"type: {names[data.dtype.name]}", f"dimension: {data.ndim}",
             f"sizes: {' '.join(str(s) for s in data.shape)}", f"encoding: {encoding}"]
    if data.dtype.itemsize > 1:
        lines.append("endian: little")
    raw = np.ascontiguousarray(data.T).astype(data.dtype.newbyteorder("<"), copy=False)
    payload = gzip.compress(raw.tobytes(), compresslevel=1) if encoding == "gzip" \
        else raw.tobytes()
    with open(path, "wb") as f:
        f.write(("\n".join(lines) + "\n\n").encode("ascii"))
        f.write(payload)


def write_dataset(root: str, volumes, splits: Dict[str, Sequence[str]],
                  rois: Sequence[str]) -> Dict[str, str]:
    """Write ``volumes`` ((pid, CT, {roi: mask}) with numpy arrays) and the
    split and class files under ``root`` → the paths a reader's config
    takes: ``data_dir``, ``class_csv_dir`` and ``<split>_csv`` per split."""
    data_dir = os.path.join(root, "data")
    class_dir = os.path.join(root, "split", "classes")
    os.makedirs(data_dir, exist_ok=True)
    os.makedirs(class_dir, exist_ok=True)
    rows = {roi: [] for roi in rois}
    for pid, vol, masks in volumes:
        write_nrrd(os.path.join(data_dir, f"{pid}_clean.nrrd"), vol)
        for roi in rois:
            path = os.path.join(data_dir, f"{pid}_{roi}.nrrd")
            write_nrrd(path, masks[roi], "gzip")
            zz = np.flatnonzero(masks[roi].any(axis=(1, 2)))
            rows[roi].append(f"{pid},{zz.min()},{zz.max()},{path}")
    out = {"data_dir": data_dir, "class_csv_dir": class_dir}
    for name, pids in splits.items():
        out[f"{name}_csv"] = os.path.join(root, "split", f"{name}.csv")
        with open(out[f"{name}_csv"], "w") as f:
            f.write("\n".join(pids) + "\n")
    for roi, rr in rows.items():
        with open(os.path.join(class_dir, f"{roi}.csv"), "w") as f:
            f.write("pid,z_start,z_end,path\n" + "\n".join(rr) + "\n")
    return out
