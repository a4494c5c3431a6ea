"""Offline preprocessing: standard NRRD layout → model-ready volumes.

The port's copy of ``rpnet_tpu/preprocess/abd110.py``; the port imports nothing
of the JAX package.

Rebuild of utils/preprocess_abd_110.py (the reference version has broken
imports — `annotation2multi_mask` / `utils.preprocess_pancreas` don't exist,
preprocess_abd_110.py:10-11 — this one actually runs):

per patient directory ``{pid}/img.nrrd`` + ``{pid}/structures/{roi}.nrrd``:
  1. optional isotropic resample (2 mm default);
  2. body mask (Otsu + morphology + center component, preprocess/morphology.py)
     and set everything outside the body to -1024 HU;
  3. crop to the body bounding box;
  4. write ``{pid}_clean.nrrd``, per-ROI ``{pid}_{roi}.nrrd``, a stacked
     ``{pid}_masks.nrrd`` and the crop bbox ``{pid}_bbox.npy``.

Multiprocessing Pool mirrors the reference's host-side parallelism
(preprocess_abd_110.py:55).
"""

from __future__ import annotations

import argparse
import os
from multiprocessing import Pool
from typing import Dict, List, Sequence

import numpy as np

from rpnet_tpu_torch.core import nrrd_io
from rpnet_tpu_torch.core.boxes import annotation2masks
from rpnet_tpu_torch.core.transforms import resample
from rpnet_tpu_torch.preprocess.morphology import body_mask_volume

ABD110_ROI_NAMES = ['Large Bowel', 'Duodenum', 'Spinal Cord', 'Liver',
                    'Spleen', 'Small Bowel', 'Pancreas', 'Kidney L',
                    'Kidney R', 'Stomach', 'Gallbladder']


def preprocess_patient(pid: str, data_dir: str, save_dir: str,
                       roi_names: Sequence[str] = ABD110_ROI_NAMES,
                       spacing=None, new_spacing=(2.0, 2.0, 2.0),
                       do_resample: bool = False, z_start: int = 0,
                       axes_swapped: bool = True) -> Dict:
    """Process one patient; returns a summary dict."""
    img_path = os.path.join(data_dir, pid, "img.nrrd")
    image, _ = nrrd_io.read(img_path)
    if axes_swapped:   # standard layout stores (x, y, z); model wants (z, y, x)
        image = np.swapaxes(image, 0, -1)
    image = image.astype(np.float32)

    if do_resample and spacing is not None:
        image, _ = resample(image, spacing, new_spacing)

    processed = image[z_start:].copy()

    mask = body_mask_volume(processed)
    processed[mask == 0] = -1024

    _, yy, xx = np.where(processed > -1024)
    y0, y1 = yy.min(), yy.max()
    x0, x1 = xx.min(), xx.max()
    processed = processed[:, y0:y1, x0:x1]

    bbox = np.array([[z_start, y0, x0],
                     [z_start + image.shape[0], y1, x1]])
    os.makedirs(save_dir, exist_ok=True)
    np.save(os.path.join(save_dir, f"{pid}_bbox.npy"), bbox)
    nrrd_io.write(os.path.join(save_dir, f"{pid}_clean.nrrd"),
                  processed.astype(np.int16))

    masks: Dict[str, np.ndarray] = {}
    for roi in roi_names:
        p = os.path.join(data_dir, pid, "structures", f"{roi}.nrrd")
        if os.path.isfile(p):
            m, _ = nrrd_io.read(p)
            if axes_swapped:
                m = np.swapaxes(m, 0, -1)
            if do_resample and spacing is not None:
                m, _ = resample(m.astype(np.float32), spacing, new_spacing)
                m = m > 0.5
            m = m[z_start:, y0:y1, x0:x1].astype(np.uint8)
            masks[roi] = m
            nrrd_io.write(os.path.join(save_dir, f"{pid}_{roi}.nrrd"), m)

    if masks:
        stacked = annotation2masks(masks, roi_names=list(roi_names)).astype(np.uint8)
        nrrd_io.write(os.path.join(save_dir, f"{pid}_masks.nrrd"), stacked)
    return {"pid": pid, "shape": processed.shape, "n_rois": len(masks)}


def write_class_csvs(save_dir: str, csv_dir: str,
                     roi_names: Sequence[str] = ABD110_ROI_NAMES):
    """Per-organ z-range CSVs (pid,z_start,z_end,path) — the output of the
    reference's absent notebook, consumed by the episodic reader
    (few_shot_reader.py:352-371).

    Pids come from the ``{pid}_clean.nrrd`` stems verbatim, so pids may
    contain underscores (brain datasets like ``sub_01``) — never derived by
    splitting on '_'.
    """
    os.makedirs(csv_dir, exist_ok=True)
    pids = sorted({f[: -len("_clean.nrrd")] for f in os.listdir(save_dir)
                   if f.endswith("_clean.nrrd")})
    for roi in roi_names:
        rows: List[str] = ["pid,z_start,z_end,path"]
        for pid in pids:
            p = os.path.join(save_dir, f"{pid}_{roi}.nrrd")
            if not os.path.isfile(p):
                continue
            m, _ = nrrd_io.read(p)
            zz = np.where(m.reshape(m.shape[0], -1).any(axis=1))[0]
            if len(zz):
                rows.append(f"{pid},{zz.min()},{zz.max()},{p}")
        with open(os.path.join(csv_dir, f"{roi}.csv"), "w") as f:
            f.write("\n".join(rows) + "\n")


def main(argv=None):
    ap = argparse.ArgumentParser(description="Abd-110 offline preprocessing")
    ap.add_argument("--data-dir", required=True)
    ap.add_argument("--save-dir", required=True)
    ap.add_argument("--class-csv-dir", default=None)
    ap.add_argument("--processes", type=int, default=4)
    ap.add_argument("--resample", action="store_true")
    args = ap.parse_args(argv)

    pids = sorted(os.listdir(args.data_dir))
    work = [(pid, args.data_dir, args.save_dir) for pid in pids]
    with Pool(processes=args.processes) as pool:
        results = pool.starmap(preprocess_patient, work)
    for r in results:
        print(r["pid"], r["shape"], f"{r['n_rois']} rois")
    if args.class_csv_dir:
        write_class_csvs(args.save_dir, args.class_csv_dir)


if __name__ == "__main__":
    main()
