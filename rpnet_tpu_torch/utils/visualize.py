"""Visualization utilities (rebuild of utils/visualize.py).

The port's copy of ``rpnet_tpu/utils/visualize.py``; the port imports nothing
of the JAX package.

The reference module is notebook-oriented (IPython slider widgets) and broken
as shipped (`from config import config`, visualize.py:15 — no config.py
exists). This rebuild keeps the same capabilities as importable, headless-safe
functions (matplotlib Agg), with the interactive paths degrading gracefully
outside notebooks:

  * interactive 3D browsing w/ HU window   (show3dimg — visualize.py:85-163)
  * slice animation across z               (generate_image_anim — :323-346)
  * paper comparison figures               (plot_compare_figure / save_one_slice
                                            / show3d_comparison — :347-556)
  * mask contour & bbox overlays           (draw_contours / draw_bboxes)
  * volume mosaics, per-slice PNG export   (volume_grid / generate_image_pngs)
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def _plt():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def normalize_for_display(img: np.ndarray, lo_pct: float = 1, hi_pct: float = 99):
    lo, hi = np.percentile(img, [lo_pct, hi_pct])
    return np.clip((img - lo) / max(hi - lo, 1e-6), 0, 1)


def draw_contours(slice_img: np.ndarray, masks: Dict[str, np.ndarray],
                  colors: Optional[Dict[str, Tuple[int, int, int]]] = None,
                  thickness: int = 1) -> np.ndarray:
    """Overlay mask contours on a grayscale slice → RGB uint8."""
    import cv2

    rgb = (normalize_for_display(slice_img) * 255).astype(np.uint8)
    rgb = np.stack([rgb] * 3, axis=-1)
    palette = [(255, 80, 80), (80, 255, 80), (80, 120, 255), (255, 255, 80),
               (255, 80, 255), (80, 255, 255)]
    for i, (name, m) in enumerate(masks.items()):
        color = (colors or {}).get(name, palette[i % len(palette)])
        contours, _ = cv2.findContours(m.astype(np.uint8), cv2.RETR_EXTERNAL,
                                       cv2.CHAIN_APPROX_SIMPLE)
        cv2.drawContours(rgb, contours, -1, color, thickness)
    return rgb


def draw_bboxes(slice_img: np.ndarray, bboxes_yx: Sequence[Sequence[float]],
                color=(255, 200, 0), thickness: int = 1) -> np.ndarray:
    """Overlay [y0, x0, y1, x1] boxes on a slice → RGB uint8."""
    import cv2

    rgb = (normalize_for_display(slice_img) * 255).astype(np.uint8)
    rgb = np.stack([rgb] * 3, axis=-1)
    for y0, x0, y1, x1 in bboxes_yx:
        cv2.rectangle(rgb, (int(x0), int(y0)), (int(x1), int(y1)),
                      color, thickness)
    return rgb


def plot2dcontour(img_arr: np.ndarray, contour_arr: np.ndarray,
                  figsize=(20, 20), save_path: Optional[str] = None):
    """Side-by-side slice view: raw image | image + contour overlay
    (utils/visualize counterpart of utils/util.py:624-639). Headless-safe:
    returns the figure and optionally saves instead of plt.show()."""
    plt = _plt()
    masked = np.ma.masked_where(np.asarray(contour_arr) == 0, contour_arr)
    fig, axes = plt.subplots(1, 2, figsize=figsize)
    axes[0].imshow(img_arr, cmap="gray", interpolation="none")
    axes[1].imshow(img_arr, cmap="gray", interpolation="none")
    axes[1].imshow(masked, cmap="cool", interpolation="none", alpha=0.7)
    for ax in axes:
        ax.axis("off")
    if save_path:
        fig.savefig(save_path, bbox_inches="tight")
        plt.close(fig)
    return fig


def create_image_mask_files(ct_dir: str, rs_path: str, roi_name: str,
                            out_dir: Optional[str] = None,
                            img_format: str = "png") -> int:
    """Export a DICOM patient as per-slice image/mask PNG pairs under
    ``out_dir/images`` and ``out_dir/masks`` (utils/util.py:736-756).

    The reference resolved the ROI by positional index into the RTSTRUCT and
    flood-filled contours per slice; here the ROI is matched by name through
    :mod:`rpnet_tpu_torch.preprocess.dicom` (polygon fill) — same outputs, stable
    against ROI reordering. Returns the number of slices written.
    """
    from rpnet_tpu_torch.preprocess.dicom import get_patient_data, merge_roi_masks

    plt = _plt()
    vol, masks, _ = get_patient_data(ct_dir, rs_path)
    mask = merge_roi_masks(roi_name, masks, vol.shape)
    out_dir = out_dir or os.path.dirname(os.path.abspath(ct_dir))
    os.makedirs(os.path.join(out_dir, "images"), exist_ok=True)
    os.makedirs(os.path.join(out_dir, "masks"), exist_ok=True)
    for i in range(vol.shape[0]):
        plt.imsave(os.path.join(out_dir, "images", f"image_{i}.{img_format}"),
                   vol[i], cmap="gray")
        plt.imsave(os.path.join(out_dir, "masks", f"mask_{i}.{img_format}"),
                   mask[i], cmap="gray")
    return int(vol.shape[0])


def volume_grid(volume: np.ndarray, n_cols: int = 8,
                max_slices: Optional[int] = None) -> np.ndarray:
    """Tile a (D, H, W) volume into one 2D mosaic for quick inspection."""
    D = volume.shape[0] if max_slices is None else min(volume.shape[0], max_slices)
    n_rows = -(-D // n_cols)
    H, W = volume.shape[1:]
    canvas = np.zeros((n_rows * H, n_cols * W), volume.dtype)
    for i in range(D):
        r, c = divmod(i, n_cols)
        canvas[r * H:(r + 1) * H, c * W:(c + 1) * W] = volume[i]
    return canvas


def show3d_comparison(image: np.ndarray, gt_mask: np.ndarray,
                      pred_mask: np.ndarray, out_path: str,
                      slice_ids: Optional[Sequence[int]] = None,
                      title: str = ""):
    """Side-by-side GT vs prediction contour figure (show3D_comparison,
    visualize.py:471) saved to ``out_path``."""
    plt = _plt()
    if slice_ids is None:
        annotated = np.where(gt_mask.reshape(gt_mask.shape[0], -1).any(axis=1))[0]
        pool = annotated if len(annotated) else np.arange(image.shape[0])
        slice_ids = pool[np.linspace(0, len(pool) - 1,
                                     min(4, len(pool))).astype(int)]
    n = len(slice_ids)
    fig, axes = plt.subplots(n, 2, figsize=(8, 4 * n), squeeze=False)
    for row, z in enumerate(slice_ids):
        axes[row][0].imshow(draw_contours(image[z], {"gt": gt_mask[z]},
                                          {"gt": (80, 255, 80)}))
        axes[row][0].set_title(f"z={z} ground truth")
        axes[row][1].imshow(draw_contours(image[z], {"pred": pred_mask[z]},
                                          {"pred": (255, 80, 80)}))
        axes[row][1].set_title(f"z={z} prediction")
        for ax in axes[row]:
            ax.axis("off")
    if title:
        fig.suptitle(title)
    fig.tight_layout()
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    fig.savefig(out_path, dpi=100)
    plt.close(fig)
    return out_path


def generate_image_pngs(image: np.ndarray, masks: Dict[str, np.ndarray],
                        out_dir: str, prefix: str = "slice") -> List[str]:
    """Export every slice as a contour-overlaid PNG (generate_image_pngs,
    visualize.py:558)."""
    import cv2

    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for z in range(image.shape[0]):
        rgb = draw_contours(image[z], {k: m[z] for k, m in masks.items()})
        p = os.path.join(out_dir, f"{prefix}_{z:03d}.png")
        cv2.imwrite(p, rgb[..., ::-1])
        paths.append(p)
    return paths


# ---------------------------------------------------------------------------
# HU windowing + label overlays (the reference's level/width + custom_cmap
# mechanics, visualize.py:39-75,124-131)
# ---------------------------------------------------------------------------

_PALETTE = np.array([(255, 80, 80), (80, 255, 80), (80, 120, 255),
                     (255, 255, 80), (255, 80, 255), (80, 255, 255),
                     (255, 160, 80), (160, 80, 255), (80, 255, 160),
                     (200, 200, 200), (120, 60, 60)], np.float32) / 255.0


def hu_window(img: np.ndarray, level: float = 0, width: float = 1000):
    """CT display windowing: map [level-width/2, level+width/2] → [0, 1]."""
    lo = level - width / 2.0
    return np.clip((img - lo) / max(width, 1e-6), 0, 1)


def label_overlay_rgba(label_slice: np.ndarray, alpha: float = 0.5):
    """Integer-labeled slice → RGBA overlay (0 = transparent), the
    NaN-masked custom_cmap imshow of the reference (visualize.py:128-131)."""
    lab = np.asarray(label_slice).astype(np.int32)
    rgba = np.zeros(lab.shape + (4,), np.float32)
    fg = lab > 0
    rgba[fg, :3] = _PALETTE[(lab[fg] - 1) % len(_PALETTE)]
    rgba[fg, 3] = alpha
    return rgba


def class_legend_handles(names):
    """Legend patches per class (the reference's patches1, visualize.py:60-66)."""
    import matplotlib.patches as mpatches

    return [mpatches.Patch(color=_PALETTE[i % len(_PALETTE)], label=n)
            for i, n in enumerate(names)]


# ---------------------------------------------------------------------------
# interactive 3D browsing (show3Dimg / show3Dimg2, visualize.py:85-163)
# ---------------------------------------------------------------------------

def render_slice(image: np.ndarray, masks=(), z: int = 0, level: float = 0,
                 width: float = 1000, show_mask: bool = True,
                 class_names=None, ax=None):
    """Render ONE browsed view: windowed CT slice + stacked label overlays.
    This is the plot_figure body of show3Dimg2 as a pure function — the
    interactive wrapper and tests share it."""
    plt = _plt()
    if ax is None:
        fig, ax = plt.subplots(figsize=(6, 6))
    else:
        fig = ax.figure
    ax.imshow(hu_window(image[z], level, width), cmap="gray", vmin=0, vmax=1)
    if show_mask:
        for i, m in enumerate(m for m in masks if m is not None):
            ax.imshow(label_overlay_rgba(m[z], alpha=0.5 * (i + 1) / max(len(masks), 1)))
    ax.axis("off")
    if class_names:
        ax.legend(handles=class_legend_handles(class_names),
                  bbox_to_anchor=(1.01, 1), loc=2, borderaxespad=0.0)
    return fig


def show3dimg(image: np.ndarray, *masks, class_names=None):
    """Interactive z/level/width/mask browser (show3Dimg2, visualize.py:99).

    In a notebook (ipywidgets importable) this displays live sliders; in a
    headless session it returns the ``render_slice`` closure so callers can
    still browse programmatically — same controls, no widget dependency.
    """
    def view(z=0, level=0, width=1000, show_mask=True):
        return render_slice(image, masks, z=int(z), level=level, width=width,
                            show_mask=show_mask, class_names=class_names)

    try:
        import ipywidgets as w
        from IPython.display import display
    except Exception:
        return view

    z_s = w.IntSlider(min=0, max=image.shape[0] - 1, value=0, description="z")
    lev = w.IntSlider(min=-1024, max=1000, value=0, description="level")
    wid = w.IntSlider(min=1, max=2000, value=1000, description="width")
    chk = w.Checkbox(value=True, description="show mask")
    out = w.interactive_output(
        lambda z, level, width, show_mask: view(z, level, width, show_mask),
        {"z": z_s, "level": lev, "width": wid, "show_mask": chk})
    display(z_s, lev, wid, chk, out)
    return view


# alias matching the reference's single-volume browser (visualize.py:85)
show3dimg2 = show3dimg


# ---------------------------------------------------------------------------
# animation (generate_image_anim, visualize.py:323-346)
# ---------------------------------------------------------------------------

def generate_image_anim(img: np.ndarray, interval: int = 200,
                        save_path: Optional[str] = None):
    """Animate across axial slices; [D,H,W] or [D,H,W,3]. Saves with ffmpeg
    when available, else pillow (gif) — returns the Animation."""
    plt = _plt()
    from matplotlib import animation

    fig = plt.figure()
    ims = []
    for i in range(len(img)):
        frame = img[i] if img.ndim == 4 else hu_window(img[i], 0, 1000)
        kw = {} if img.ndim == 4 else {"cmap": "gray", "vmin": 0, "vmax": 1}
        ims.append([plt.imshow(frame, animated=True, **kw)])
    anim = animation.ArtistAnimation(fig, ims, interval=interval, blit=True,
                                     repeat_delay=1000)
    if save_path:
        try:
            writer = animation.writers["ffmpeg"](fps=30, bitrate=1800)
        except Exception:
            writer = animation.PillowWriter(fps=max(1, 1000 // interval))
            if not save_path.endswith(".gif"):
                save_path += ".gif"
        anim.save(save_path, writer=writer)
    plt.close(fig)
    return anim


# ---------------------------------------------------------------------------
# paper comparison figures (plot_compare_figure / save_one_slice /
# generate PNG batches, visualize.py:347-556)
# ---------------------------------------------------------------------------

def plot_compare_figure(image: np.ndarray, gt, pred, params: Dict,
                        save_dir: str, show_all_legend: bool = False,
                        fmt: Sequence[str] = ("png",), class_names=None):
    """The paper figure row (visualize.py:347-470): full CT slice with the
    HU window annotated and the crop rectangle drawn, then GT-overlay and
    prediction-overlay crops side by side.

    params: {'z', 'level', 'width', 'show_mask', 'start': (z0,y0,x0),
    'end': (z1,y1,x1)} — start/end bound the crop (z entries ignored, same
    as the reference). gt/pred: lists of (D,H,W) label masks. Saves
    ``{save_dir}/compare_z{z}.{fmt}`` per format; returns the paths.
    """
    plt = _plt()
    from matplotlib import gridspec
    from matplotlib import patches as mpatches

    z, level, width = params["z"], params["level"], params["width"]
    show_mask = params.get("show_mask", True)
    y0, x0 = params["start"][1:]
    y1, x1 = params["end"][1:]

    fig = plt.figure(figsize=(12, 4))
    gs = gridspec.GridSpec(1, 3, wspace=0.01, hspace=0.01)

    ax = fig.add_subplot(gs[0, 0])
    ax.imshow(hu_window(image[z], level, width), cmap="gray", vmin=0, vmax=1,
              interpolation="spline36")
    ax.text(0.95, 0.95, f"W: {width}, L: {level}", va="bottom", ha="right",
            transform=ax.transAxes, color="white", fontsize=15)
    ax.add_patch(mpatches.Rectangle((x0, y0), x1 - x0, y1 - y0, linewidth=1,
                                    edgecolor="white", facecolor="none"))
    ax.set_xticks([]), ax.set_yticks([])

    crop_img = image[:, y0:y1, x0:x1]
    for col, masks in ((1, gt), (2, pred)):
        ax = fig.add_subplot(gs[0, col])
        ax.imshow(hu_window(crop_img[z], level, width), cmap="gray",
                  vmin=0, vmax=1, interpolation="spline36")
        if show_mask:
            for i, m in enumerate(masks):
                ax.imshow(label_overlay_rgba(m[z, y0:y1, x0:x1],
                                             alpha=0.5 * (i + 1) / max(len(masks), 1)))
        ax.set_xticks([]), ax.set_yticks([])
    if show_all_legend and class_names:
        fig.legend(handles=class_legend_handles(class_names),
                   loc="lower center", ncol=min(len(class_names), 6))

    os.makedirs(save_dir, exist_ok=True)
    paths = []
    for f in fmt:
        p = os.path.join(save_dir, f"compare_z{z}.{f}")
        fig.savefig(p, dpi=120, bbox_inches="tight")
        paths.append(p)
    plt.close(fig)
    return paths


def save_one_slice(image: np.ndarray, masks, params: Dict, save_dir: str,
                   show_all_legend: bool = False, class_names=None):
    """Single windowed slice + overlays → PNG (save_one_slice,
    visualize.py:527-556)."""
    plt = _plt()
    fig = render_slice(image, masks, z=params["z"], level=params["level"],
                       width=params["width"],
                       show_mask=params.get("show_mask", True),
                       class_names=class_names if show_all_legend else None)
    os.makedirs(save_dir, exist_ok=True)
    p = os.path.join(save_dir, f"slice_z{params['z']}.png")
    fig.savefig(p, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return p
