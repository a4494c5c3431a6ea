"""Synthetic NRRD dataset generator (the port's copy of
``rpnet_tpu/core/synthetic.py``; same files for the same seed): the 4-organ
generator and the 11-class Abd-110 proxy.

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

#: The full Abd-110 class inventory (split/abd_110_classes/*.csv — 11 organ
#: CSVs consumed at few_shot_reader.py:352-371). The multi-class proxy
#: generates all of them with distinct shape families and HU signatures.
ABD110_CLASSES = (
    "Liver", "Spleen", "Kidney L", "Kidney R", "Stomach", "Pancreas",
    "Gallbladder", "Duodenum", "Large Bowel", "Small Bowel", "Spinal Cord",
)

#: Few-shot protocol mirroring example.yml:87-92 (train on some organs, eval
#: on held-out organs), widened to the VERDICT r3 study spec: >=5 train
#: classes, >=2 eval classes, disjoint.
PROXY_TRAIN_CLASSES = ("Spleen", "Kidney L", "Kidney R", "Stomach",
                       "Pancreas", "Gallbladder")
PROXY_EVAL_CLASSES = ("Liver", "Duodenum")


#: The 4-organ generator's ellipsoids: centre (z, y, x) and radii (z, y, x)
#: as fractions of the volume. Any other class set draws from the 11-class
#: Abd-110 proxy (:func:`make_patient_multiclass`), as in the JAX package.
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


def _tube(shape, pts, radii, out=None):
    """Voxels within an (anisotropic) ellipsoidal radius of a sampled
    polyline — the shape family for hollow/curved organs (stomach, bowel,
    pancreas, duodenum). Marks only local bounding boxes per sample point."""
    D, H, W = shape
    m = np.zeros(shape, bool) if out is None else out
    rz, ry, rx = radii
    for p in np.asarray(pts, np.float64):
        z0, z1 = max(0, int(p[0] - rz - 1)), min(D, int(p[0] + rz + 2))
        y0, y1 = max(0, int(p[1] - ry - 1)), min(H, int(p[1] + ry + 2))
        x0, x1 = max(0, int(p[2] - rx - 1)), min(W, int(p[2] + rx + 2))
        if z0 >= z1 or y0 >= y1 or x0 >= x1:
            continue
        zz, yy, xx = np.meshgrid(np.arange(z0, z1), np.arange(y0, y1),
                                 np.arange(x0, x1), indexing="ij")
        m[z0:z1, y0:y1, x0:x1] |= (((zz - p[0]) / rz) ** 2
                                   + ((yy - p[1]) / ry) ** 2
                                   + ((xx - p[2]) / rx) ** 2) <= 1.0
    return m


def _arc(center_yx, radius, th0, th1, z0, z1, n=48):
    """Sample points along a circular arc in the y-x plane with linear z
    drift — stomach/duodenum/bowel centerlines."""
    t = np.linspace(0.0, 1.0, n)
    th = np.deg2rad(th0 + (th1 - th0) * t)
    return np.stack([z0 + (z1 - z0) * t,
                     center_yx[0] + radius * np.sin(th),
                     center_yx[1] + radius * np.cos(th)], axis=1)


def make_patient_multiclass(shape, seed: int, classes: Sequence[str] = ABD110_CLASSES):
    """One synthetic abdominal CT with ALL 11 Abd-110 organ classes
    (split/abd_110_classes/*.csv inventory), each with a distinct shape
    family, size, z-extent and HU signature:

      ellipsoids (liver two-lobe union, spleen, gallbladder), notched beans
      (kidneys), arc tubes with hollow lumen (stomach), slender S-tubes
      (pancreas), C-arcs (duodenum), a Pi-shaped colonic frame (large
      bowel), a multi-ball cluster (small bowel), and a full-z cylinder in
      a bright vertebral ring (spinal cord).

    Geometry for every class is always drawn (fixed RNG consumption order)
    so the image is identical regardless of which subset of `classes` a
    dataset requests. Returns (vol_int16, {roi: uint8 mask}).
    """
    rng = np.random.RandomState(seed)
    D, H, W = shape
    vol = np.full(shape, -1000.0, np.float32)
    body = _ellipsoid(shape, (D / 2, H / 2, W / 2),
                      (D * 0.75, H * 0.42 + rng.uniform(-3, 3),
                       W * 0.45 + rng.uniform(-3, 3)))
    vol[body] = rng.normal(20, 25, size=int(body.sum())).astype(np.float32)

    def j(s):  # fractional jitter
        return rng.uniform(-s, s)

    def u(lo=0.85, hi=1.15):
        return rng.uniform(lo, hi)

    masks: Dict[str, np.ndarray] = {}

    # Liver: two-lobe union of ellipsoids (the one organ big enough to
    # dominate its crop — also the reference's eval class, example.yml:91).
    c = ((0.45 + j(.04)) * D, (0.44 + j(.03)) * H, (0.36 + j(.03)) * W)
    r = (0.33 * D * u(), 0.165 * H * u(), 0.21 * W * u())
    liver = _ellipsoid(shape, c, r)
    lobe_c = (c[0] + 0.04 * D, c[1] + 0.07 * H, c[2] + 0.13 * W)
    liver |= _ellipsoid(shape, lobe_c, (r[0] * .6, r[1] * .6, r[2] * .6))
    masks["Liver"] = liver

    # Spleen: medium ellipsoid, left-posterior.
    masks["Spleen"] = _ellipsoid(
        shape, ((0.52 + j(.05)) * D, (0.50 + j(.03)) * H, (0.72 + j(.02)) * W),
        (0.20 * D * u(), 0.095 * H * u(), 0.10 * W * u()))

    # Kidneys: notched beans (ellipsoid minus a hilum sphere toward midline).
    for roi, cx, sgn in (("Kidney L", 0.66, -1.0), ("Kidney R", 0.34, 1.0)):
        c = ((0.62 + j(.04)) * D, (0.60 + j(.02)) * H, (cx + j(.02)) * W)
        r = (0.18 * D * u(), 0.085 * H * u(), 0.075 * W * u())
        bean = _ellipsoid(shape, c, r)
        bean &= ~_ellipsoid(shape, (c[0], c[1], c[2] + sgn * r[2] * 0.9),
                            (r[0] * .5, r[1] * .45, r[2] * .55))
        masks[roi] = bean

    # Stomach: thick arc tube, hollow lumen painted later (mask = full wall).
    sz = (0.42 + j(.05)) * D
    st_pts = _arc(((0.42 + j(.02)) * H, (0.47 + j(.02)) * W),
                  0.13 * W * u(), 150, 330, sz, sz + 0.12 * D)
    st_r = (0.11 * D * u(), 0.045 * H * u(), 0.045 * W * u())
    masks["Stomach"] = _tube(shape, st_pts, st_r)
    st_lumen = _tube(shape, st_pts, (st_r[0] * .55, st_r[1] * .55, st_r[2] * .55))

    # Pancreas: slender S-curved horizontal tube.
    t = np.linspace(0, 1, 40)
    pz, py = (0.52 + j(.05)) * D, (0.52 + j(.02)) * H
    pa_pts = np.stack([pz + 0.08 * D * np.sin(np.pi * t),
                       py + 0.04 * H * np.sin(2 * np.pi * t),
                       (0.35 + 0.27 * t) * W], axis=1)
    masks["Pancreas"] = _tube(shape, pa_pts,
                              (0.08 * D * u(), 0.030 * H * u(), 0.030 * W * u()))

    # Gallbladder: small hypodense ellipsoid at the liver's inferior edge.
    masks["Gallbladder"] = _ellipsoid(
        shape, ((0.52 + j(.05)) * D, (0.52 + j(.02)) * H, (0.30 + j(.02)) * W),
        (0.10 * D * u(), 0.045 * H * u(), 0.040 * W * u()))

    # Hollow organs must not swallow the solid ones — their masks exclude
    # previously-placed solid organs so every mask's image signal is its own.
    solids = np.zeros(shape, bool)
    for roi in ("Liver", "Spleen", "Kidney L", "Kidney R", "Stomach",
                "Pancreas", "Gallbladder"):
        solids |= masks[roi]

    # Duodenum: C-shaped arc.
    dz = (0.55 + j(.04)) * D
    du_pts = _arc(((0.55 + j(.02)) * H, (0.42 + j(.02)) * W),
                  0.075 * W * u(), -60, 120, dz, dz + 0.05 * D)
    masks["Duodenum"] = _tube(shape, du_pts,
                              (0.09 * D * u(), 0.032 * H * u(), 0.032 * W * u())) \
        & ~solids

    # Large bowel: Pi-shaped colonic frame (ascending, transverse, descending).
    lz = (0.50 + j(.05)) * D
    xl, xr, yt, yb = (0.28 + j(.015)) * W, (0.72 + j(.015)) * W, \
        (0.40 + j(.015)) * H, (0.70 + j(.015)) * H
    seg = np.linspace(0, 1, 20)[:, None]
    lb_pts = np.concatenate([
        np.stack([np.full(20, lz), yb + (yt - yb) * seg[:, 0],
                  np.full(20, xl)], axis=1),
        np.stack([np.full(20, lz + 0.06 * D), np.full(20, yt),
                  xl + (xr - xl) * seg[:, 0]], axis=1),
        np.stack([np.full(20, lz), yt + (yb - yt) * seg[:, 0],
                  np.full(20, xr)], axis=1)])
    masks["Large Bowel"] = _tube(shape, lb_pts,
                                 (0.12 * D * u(), 0.040 * H * u(), 0.040 * W * u())) \
        & ~solids

    # Small bowel: cluster of loops (balls) in the central lower abdomen.
    sb = np.zeros(shape, bool)
    for _ in range(6):
        c = ((0.50 + j(.10)) * D, (0.62 + j(.06)) * H, (0.50 + j(.08)) * W)
        _tube(shape, [c], (0.10 * D * u(), 0.035 * H * u(), 0.035 * W * u()),
              out=sb)
    masks["Small Bowel"] = sb & ~solids & ~masks["Large Bowel"]

    # Spinal cord: thin full-z posterior cylinder inside a bright vertebral
    # ring (the ring is image-only context, not part of the mask).
    cy, cx = (0.80 + j(.01)) * H, (0.50 + j(.01)) * W
    cord = _ellipsoid(shape, (D / 2, cy, cx), (D, 0.022 * H * u(), 0.022 * W * u()))
    vertebra = _ellipsoid(shape, (D / 2, cy, cx), (D, 0.050 * H, 0.050 * W))

    # Paint HU signatures in fixed order (small/hypodense organs last so
    # they stay visible where they overlap bigger ones).
    def paint(m, mu, sd):
        mm = m & body
        vol[mm] = rng.normal(mu, sd, size=int(mm.sum())).astype(np.float32)

    paint(masks["Liver"], 65, 6)
    paint(masks["Spleen"], 52, 6)
    paint(masks["Kidney L"], 35, 5)
    paint(masks["Kidney R"], 35, 5)
    paint(masks["Stomach"], 40, 6)
    paint(st_lumen, -150, 60)
    paint(masks["Pancreas"], 45, 5)
    paint(masks["Small Bowel"], 20, 10)
    paint(masks["Large Bowel"], -60, 40)
    paint(masks["Duodenum"], 25, 8)
    paint(masks["Gallbladder"], 15, 4)
    paint(vertebra, 300, 60)
    paint(cord, 40, 3)
    masks["Spinal Cord"] = cord

    out = {}
    for roi in classes:
        m = masks[roi] & body
        if not m.any():  # pathological jitter — keep the raw geometry
            m = masks[roi]
        out[roi] = m.astype(np.uint8)
    return np.clip(vol, -1024, 3072).astype(np.int16), out


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

    unknown = set(classes) - set(ABD110_CLASSES)
    if unknown:
        raise ValueError(f"no synthetic organ for {sorted(unknown)}; the generators "
                         f"draw {', '.join(ABD110_CLASSES)}")
    pids = [f"syn{i:03d}" for i in range(n_train + n_test)]
    rows = {roi: [] for roi in classes}
    # the 4-organ generator for a subset of its organs (the files the JAX
    # package writes for them), the 11-class Abd-110 proxy otherwise
    legacy = set(classes) <= set(ORGANS)
    for i, pid in enumerate(pids):
        if legacy:
            vol, masks = make_patient(shape, seed * 1000 + i)
        else:
            vol, masks = make_patient_multiclass(shape, seed * 1000 + i, classes)
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
