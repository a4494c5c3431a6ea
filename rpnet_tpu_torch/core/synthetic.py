"""Synthetic NRRD dataset generator (the port's copy of
``rpnet_tpu/core/synthetic.py``; same files for the same seed).

Creates an Abd-110-shaped directory: per patient a ``{pid}_clean.nrrd`` CT
volume and ``{pid}_{roi}.nrrd`` organ masks (ellipsoid "organs" inside an
elliptical "body", HU-realistic ranges), plus split CSVs and per-class
``{roi}.csv`` z-range files matching the layout consumed by the episodic
reader (split/abd_110_classes/*.csv: pid,z_start,z_end,path).

Deterministic per (seed, pid) so tests and benches are reproducible.
"""

from __future__ import annotations

import os
from typing import Dict, Sequence, Tuple

import numpy as np

from rpnet_tpu_torch.core import nrrd_io

DEFAULT_CLASSES = ("Liver", "Spleen")

#: Organ ellipsoids: centre (z, y, x) and radii (z, y, x) as fractions of the
#: volume. The JAX package draws an 11-class Abd-110 proxy for other class
#: sets; the port has only these (ROADMAP.md).
ORGANS = {
    "Liver": (0.45, 0.45, 0.38, 0.30, 0.16, 0.22),
    "Spleen": (0.55, 0.55, 0.68, 0.18, 0.10, 0.12),
    "Kidney L": (0.60, 0.62, 0.62, 0.16, 0.09, 0.10),
    "Kidney R": (0.60, 0.62, 0.30, 0.16, 0.09, 0.10),
}


def _ellipsoid(shape, center, radii):
    zz, yy, xx = np.meshgrid(*[np.arange(s) for s in shape], indexing="ij")
    return (((zz - center[0]) / radii[0]) ** 2
            + ((yy - center[1]) / radii[1]) ** 2
            + ((xx - center[2]) / radii[2]) ** 2) <= 1.0


def make_patient(shape, seed: int):
    """One synthetic CT: body + per-class organ masks. Returns (vol, masks)."""
    rng = np.random.RandomState(seed)
    D, H, W = shape
    vol = np.full(shape, -1000.0, np.float32)
    body = _ellipsoid(shape, (D / 2, H / 2, W / 2),
                      (D * 0.7, H * 0.42 + rng.uniform(-2, 2), W * 0.45))
    vol[body] = rng.normal(20, 30, size=int(body.sum())).astype(np.float32)

    masks: Dict[str, np.ndarray] = {}
    for roi, (cz, cy, cx, rz, ry, rx) in ORGANS.items():
        jitter = rng.uniform(-0.04, 0.04, size=3)
        center = ((cz + jitter[0]) * D, (cy + jitter[1]) * H, (cx + jitter[2]) * W)
        radii = (max(rz * D * rng.uniform(0.8, 1.2), 2),
                 max(ry * H * rng.uniform(0.8, 1.2), 3),
                 max(rx * W * rng.uniform(0.8, 1.2), 3))
        m = _ellipsoid(shape, center, radii) & body
        masks[roi] = m.astype(np.uint8)
        vol[m] = rng.normal(70, 10, size=int(m.sum())).astype(np.float32)
    return vol.astype(np.int16), masks


def generate_dataset(root: str, n_train: int = 4, n_test: int = 3,
                     shape: Tuple[int, int, int] = (24, 64, 64),
                     classes: Sequence[str] = DEFAULT_CLASSES,
                     seed: int = 0) -> Dict[str, str]:
    """Write a full synthetic dataset. Returns paths dict.

    Layout:
      root/data/{pid}_clean.nrrd, {pid}_{roi}.nrrd
      root/split/train.csv, test.csv              (one pid per line)
      root/split/classes/{roi}.csv                (pid,z_start,z_end,path)
    """
    data_dir = os.path.join(root, "data")
    split_dir = os.path.join(root, "split")
    class_dir = os.path.join(split_dir, "classes")
    os.makedirs(data_dir, exist_ok=True)
    os.makedirs(class_dir, exist_ok=True)

    unknown = set(classes) - set(ORGANS)
    if unknown:
        raise ValueError(f"no synthetic organ for {sorted(unknown)}; the port "
                         f"generates {', '.join(ORGANS)}")
    pids = [f"syn{i:03d}" for i in range(n_train + n_test)]
    rows = {roi: [] for roi in classes}
    for i, pid in enumerate(pids):
        vol, masks = make_patient(shape, seed * 1000 + i)
        nrrd_io.write(os.path.join(data_dir, f"{pid}_clean.nrrd"), vol)
        for roi in classes:
            m = masks[roi]
            nrrd_io.write(os.path.join(data_dir, f"{pid}_{roi}.nrrd"), m)
            zz = np.where(m.any(axis=(1, 2)))[0]
            rows[roi].append((pid, int(zz.min()), int(zz.max()),
                              os.path.join(data_dir, f"{pid}_{roi}.nrrd")))

    with open(os.path.join(split_dir, "train.csv"), "w") as f:
        f.write("\n".join(pids[:n_train]) + "\n")
    with open(os.path.join(split_dir, "test.csv"), "w") as f:
        f.write("\n".join(pids[n_train:]) + "\n")
    for roi, rr in rows.items():
        with open(os.path.join(class_dir, f"{roi}.csv"), "w") as f:
            f.write("pid,z_start,z_end,path\n")
            for pid, z0, z1, p in rr:
                f.write(f"{pid},{z0},{z1},{p}\n")

    return {"data_dir": data_dir, "train_csv": os.path.join(split_dir, "train.csv"),
            "test_csv": os.path.join(split_dir, "test.csv"), "class_dir": class_dir}
