"""DICOM ingest: CT series + RTSTRUCT contour rasterization.

The port's copy of ``rpnet_tpu/preprocess/dicom.py``; the port imports nothing
of the JAX package.

Rebuild of the reference's pydicom/SimpleITK ingest layer
(utils/util.py:479-876: load_dicom_image, coord2pixels, ctrdata2pixels,
fill_contour, get_patient_data_v2) without SimpleITK:

  * series loading sorts pydicom slices by ImagePositionPatient-z and applies
    RescaleSlope/Intercept → (D, H, W) HU volume + (z, y, x) spacing;
  * contour rasterization converts patient-space mm points to pixel indices
    and fills polygons with cv2.fillPoly (replacing the reference's
    flood-fill `fill_contour`, utils/util.py:721-733 — same result, no seed
    fragility on touching contours).

pydicom (and cv2 for the polygon fill) are imported lazily; the
pure-geometry :func:`contour_mm_to_pixels` needs neither.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def _require_pydicom():
    try:
        import pydicom  # noqa: F401
        return pydicom
    except ImportError as e:  # pragma: no cover
        raise ImportError(
            "DICOM ingest requires pydicom, which is not installed. Convert "
            "your data to the standard NRRD layout (see "
            "rpnet_tpu_torch/preprocess/abd110.py) on a machine with pydicom.") from e


# --------------------------------------------------------------------------
# pure geometry (testable without pydicom)
# --------------------------------------------------------------------------

def contour_mm_to_pixels(points_mm: np.ndarray, origin: Sequence[float],
                         spacing: Sequence[float]) -> np.ndarray:
    """Patient-space (x, y, z) mm triplets → integer pixel (col, row) pairs.

    Assumes axial orientation (ImageOrientationPatient 1\\0\\0\\0\\1\\0),
    which holds for the CT series this pipeline ingests.
    """
    pts = np.asarray(points_mm, dtype=np.float64).reshape(-1, 3)
    cols = np.round((pts[:, 0] - origin[0]) / spacing[0]).astype(np.int32)
    rows = np.round((pts[:, 1] - origin[1]) / spacing[1]).astype(np.int32)
    return np.stack([cols, rows], axis=1)


def rasterize_contours(contours_px: Sequence[np.ndarray],
                       shape: Tuple[int, int]) -> np.ndarray:
    """Fill closed polygon contours into a binary (H, W) mask."""
    import cv2

    mask = np.zeros(shape, dtype=np.uint8)
    polys = [np.asarray(c, dtype=np.int32).reshape(-1, 1, 2)
             for c in contours_px if len(c) >= 3]
    if polys:
        cv2.fillPoly(mask, polys, 1)
    return mask


# --------------------------------------------------------------------------
# pydicom-backed ingest
# --------------------------------------------------------------------------

def load_dicom_series(folder: str):
    """Load a CT series → (volume_hu (D, H, W), origin_mm (x, y, z),
    spacing (z, y, x) mm). Replaces sitk.ImageSeriesReader (utils/util.py:479-489)."""
    pydicom = _require_pydicom()

    files = [os.path.join(folder, f) for f in os.listdir(folder)
             if not f.startswith(".")]
    slices = []
    for f in files:
        try:
            ds = pydicom.dcmread(f, stop_before_pixels=False)
        except Exception:
            continue
        if hasattr(ds, "ImagePositionPatient") and hasattr(ds, "pixel_array"):
            slices.append(ds)
    if not slices:
        raise ValueError(f"no CT slices found in {folder}")
    slices.sort(key=lambda ds: float(ds.ImagePositionPatient[2]))

    first = slices[0]
    px_spacing = [float(v) for v in first.PixelSpacing]   # (row, col)
    if len(slices) > 1:
        dz = abs(float(slices[1].ImagePositionPatient[2])
                 - float(first.ImagePositionPatient[2]))
    else:
        dz = float(getattr(first, "SliceThickness", 1.0) or 1.0)

    vol = np.stack([s.pixel_array.astype(np.float32) for s in slices])
    slope = float(getattr(first, "RescaleSlope", 1.0) or 1.0)
    intercept = float(getattr(first, "RescaleIntercept", 0.0) or 0.0)
    vol = vol * slope + intercept

    origin = [float(v) for v in first.ImagePositionPatient]
    spacing = (dz, px_spacing[0], px_spacing[1])
    z_positions = [float(s.ImagePositionPatient[2]) for s in slices]
    return vol, origin, spacing, z_positions


def load_rtstruct_masks(rs_path: str, volume_shape, origin, spacing,
                        z_positions) -> Tuple[Dict[str, np.ndarray], Dict[str, int]]:
    """RTSTRUCT → per-ROI binary volumes (get_patient_data_v2 semantics,
    utils/util.py:838-876)."""
    pydicom = _require_pydicom()

    rs = pydicom.dcmread(rs_path)
    roi_names: Dict[str, int] = {}
    for i, roi in enumerate(getattr(rs, "StructureSetROISequence", [])):
        roi_names[str(roi.ROIName)] = i

    D, H, W = volume_shape
    z_index = {round(z, 2): i for i, z in enumerate(z_positions)}
    masks: Dict[str, np.ndarray] = {}

    for roi_contour in getattr(rs, "ROIContourSequence", []):
        number = int(roi_contour.ReferencedROINumber)
        name = None
        for roi in rs.StructureSetROISequence:
            if int(roi.ROINumber) == number:
                name = str(roi.ROIName)
                break
        if name is None or not hasattr(roi_contour, "ContourSequence"):
            continue
        vol = np.zeros((D, H, W), dtype=np.uint8)
        per_slice: Dict[int, List[np.ndarray]] = {}
        for contour in roi_contour.ContourSequence:
            pts = np.asarray(contour.ContourData, np.float64).reshape(-1, 3)
            zi = z_index.get(round(pts[0, 2], 2))
            if zi is None:
                zi = int(np.argmin([abs(z - pts[0, 2]) for z in z_positions]))
            px = contour_mm_to_pixels(pts, origin, (spacing[2], spacing[1]))
            per_slice.setdefault(zi, []).append(px)
        for zi, contours in per_slice.items():
            vol[zi] = np.maximum(vol[zi], rasterize_contours(contours, (H, W)))
        masks[name] = vol
    return masks, roi_names


def get_patient_data(ct_dir: str, rs_path: str, roi_match: Optional[Dict] = None):
    """CT + RTSTRUCT → (volume, masks, roi_names) — the to_standard.py unit."""
    vol, origin, spacing, z_pos = load_dicom_series(ct_dir)
    masks, roi_names = load_rtstruct_masks(rs_path, vol.shape, origin, spacing, z_pos)
    return vol, masks, roi_names


def merge_roi_masks(roi_name: str, masks: Dict[str, np.ndarray],
                    shape) -> np.ndarray:
    """Case-insensitive substring merge, skipping PRV structures
    (to_standard.get_roi_mask, to_standard.py:26-37)."""
    res = np.zeros(shape, dtype=bool)
    for name, m in masks.items():
        if "prv" in name.lower():
            continue
        if roi_name.lower() in name.lower():
            res |= m.astype(bool)
    return res.astype(np.uint8)


def to_standard_patient(ct_dir: str, rs_path: str, out_dir: str,
                        roi_names: Sequence[str]):
    """DICOM patient → standard layout (img.nrrd + structures/{roi}.nrrd),
    mirroring to_standard.process_patient (to_standard.py:37-59)."""
    from rpnet_tpu_torch.core import nrrd_io

    vol, masks, _ = get_patient_data(ct_dir, rs_path)
    os.makedirs(os.path.join(out_dir, "structures"), exist_ok=True)
    nrrd_io.write(os.path.join(out_dir, "img.nrrd"),
                  np.swapaxes(vol, 0, -1).astype(np.float32))
    for roi in roi_names:
        m = merge_roi_masks(roi, masks, vol.shape)
        if np.any(m):
            nrrd_io.write(os.path.join(out_dir, "structures", f"{roi}.nrrd"),
                          np.swapaxes(m, 0, -1))
