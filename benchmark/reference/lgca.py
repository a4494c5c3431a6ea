"""Plain reference of LGCANet_V3 (net/lgca_net_v3.py:579-658), for
deciding ``correct``.

Straight PyTorch (NCHW / NCDHW, ``torch.nn.functional``), f32, over a dict
of the model's tensors under the upstream ``state_dict`` names: the 3D
context net (ResBlock3d stages with instance norm, the trilinear ×8
deep-supervision head), the 2D U-Net fused with the pyramid through
multi-head slice attention at four levels and a globally pooled d4 feature
at its last decoder stage, batch norms (running statistics in eval, the
whole slice batch's statistics in training), the per-class 2D + 3D Dice
loss, and AdamW. It also holds the sampler's preparation of a volume
(truncate, pad, HU normalize, the stride-2 context volume, the slice draw).

The slice attention pairs the two embeddings flattened as the port and the
JAX package flatten them: the 2D one in (E, E, F) order, the 3D one in
(F, E, E) order. It imports nothing of the program; ``quant`` rounds every
input and weight of a convolution or matrix product (the control).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

Quant = Optional[Callable[[torch.Tensor], torch.Tensor]]
P_NUM = (24, 32, 64, 64)
ATT_SPEC = ((2, 2, 16), (2, 2, 8), (4, 4, 4), (4, 4, 4))   # heads, features, embedding


def _q(quant: Quant, x):
    return x if quant is None else quant(x)


# ----------------------------------------------------------------- sampler

def prepare_volume(ct: np.ndarray, masks, cfg) -> tuple:
    """(CT, {roi: mask}) → the normalized volume and the per-ROI masks at
    the static working shape (each axis rounded up to 16 × the context
    stride): centre crop, pad (CT with ``pad_value``), clip above the 99.5th
    percentile and to ``HU_range``, map to [-1, 1]."""
    ds = cfg["context_net_downsample_scale"]
    rnd = lambda v, f: -(-v // f) * f
    shape = (rnd(cfg["num_slice"], 16 * ds[0]), rnd(cfg["num_y"], 16 * ds[1]),
             rnd(cfg["num_x"], 16 * ds[2]))

    def fit(a, value):
        D, H, W = a.shape
        x1, x2 = max(0, W // 2 - shape[2] // 2), min(W, W // 2 + shape[2] // 2)
        y1, y2 = max(0, H // 2 - shape[1] // 2), min(H, H // 2 + shape[1] // 2)
        a = a[:shape[0], y1:y2, x1:x2].astype(np.float32)
        a = np.pad(a, [(0, max(0, t - s)) for s, t in zip(a.shape, shape)],
                   constant_values=value)
        return a[:shape[0], :shape[1], :shape[2]]

    vol = fit(ct, cfg["pad_value"])
    top = np.float32(np.percentile(vol, 99.5))
    lo, hi = cfg["HU_range"]
    vol = ((np.clip(np.where(vol > top, top, vol), lo, hi) - lo) / max(1, hi - lo) * 2 - 1)
    m = np.stack([fit(masks[roi], 0) if roi in masks else np.zeros(shape, np.float32)
                  for roi in cfg["roi_names"]], -1)
    return vol.astype(np.float32), m


def draw_slices(masks: np.ndarray, n: int, rng: np.random.RandomState) -> np.ndarray:
    """A training step's slice indices: three quarters drawn among the
    annotated slices, the rest anywhere."""
    pool = np.flatnonzero(masks.reshape(masks.shape[0], -1).max(axis=1) > 0)
    if pool.size == 0:
        pool = np.arange(masks.shape[0])
    n_fg = min(n - n // 4, pool.size)
    fg = rng.choice(pool, size=n_fg, replace=pool.size < n_fg)
    return np.concatenate([fg, rng.randint(0, masks.shape[0], size=n - n_fg)])


# ------------------------------------------------------------------ network

def _conv3(x, p, name, quant, pad=1):
    return F.conv3d(_q(quant, x), _q(quant, p[name + ".weight"]), p.get(name + ".bias"),
                    padding=pad)


def _conv2(x, p, name, quant, pad=0):
    return F.conv2d(_q(quant, x), _q(quant, p[name + ".weight"]), p.get(name + ".bias"),
                    padding=pad)


def _inorm(x):
    return F.instance_norm(x, eps=1e-5)


def _bn(x, p, name, train: bool):
    w, b = p[name + ".weight"], p[name + ".bias"]
    if not train:
        return F.batch_norm(x, p[name + ".running_mean"], p[name + ".running_var"], w, b,
                            False, 0.0, 1e-5)
    mean = x.mean(dim=(0, 2, 3), keepdim=True)
    var = ((x - mean) ** 2).mean(dim=(0, 2, 3), keepdim=True)
    return (x - mean) / torch.sqrt(var + 1e-5) * w[:, None, None] + b[:, None, None]


def _res3d(x, p, name, quant):
    res = x
    if name + ".shortcut.0.weight" in p:
        res = _inorm(_conv3(x, p, name + ".shortcut.0", quant, 0))
    out = torch.relu(_inorm(_conv3(x, p, name + ".conv1", quant)))
    return torch.relu(_inorm(_conv3(out, p, name + ".conv2", quant)) + res)


def context_net(x, p, quant: Quant = None) -> Dict[str, torch.Tensor]:
    """(1, 1, D, H, W) → the pyramid d1..d4 and ``dsv``."""
    c = "context_net"
    d1 = torch.relu(_inorm(_conv3(x, p, f"{c}.preBlock.0", quant)))
    d1 = torch.relu(_inorm(_conv3(d1, p, f"{c}.preBlock.3", quant)))
    d2 = F.max_pool3d(d1, 2)
    for i in range(2):
        d2 = _res3d(d2, p, f"{c}.forw1.{i}", quant)
    d3 = F.max_pool3d(d2, 2)
    for i in range(2):
        d3 = _res3d(d3, p, f"{c}.forw2.{i}", quant)
    d4 = F.max_pool3d(d3, 2)
    for i in range(3):
        d4 = _res3d(d4, p, f"{c}.forw3.{i}", quant)
    up = F.interpolate(d4, scale_factor=8, mode="trilinear", align_corners=False)
    return {"d1": d1, "d2": d2, "d3": d3, "d4": d4, "dsv": _conv3(up, p, f"{c}.dsv.1", quant)}


def _attention(feat2d, feat3d, p, name, quant, embed: int):
    """One head: (B, C2, H, W), (1, C3, D, H3, W3) → fused (B, C3, H3, W3)."""
    e2 = F.adaptive_max_pool2d(_conv2(feat2d, p, name + ".global_pooling_2D.0", quant), embed)
    e3 = _conv3(feat3d, p, name + ".global_pooling_3D.0", quant, 0)
    D = feat3d.shape[2]
    e3 = F.adaptive_max_pool3d(e3, (D, embed, embed))
    sig2 = e2.permute(0, 2, 3, 1).reshape(e2.shape[0], -1)            # (B, E·E·F)
    sig3 = e3[0].permute(0, 2, 3, 1).reshape(-1, D)                   # (F·E·E, D)
    att = torch.softmax(_q(quant, sig2) @ _q(quant, sig3) / math.sqrt(sig2.shape[1]), dim=1)
    C3, H3, W3 = feat3d.shape[1], feat3d.shape[3], feat3d.shape[4]
    vals = feat3d[0].permute(1, 2, 3, 0).reshape(D, -1)               # (D, H3·W3·C3)
    fused = _q(quant, att) @ _q(quant, vals)
    return fused.reshape(-1, H3, W3, C3).permute(0, 3, 1, 2)


def _cbr(x, p, conv, bn, quant, train, pad=1):
    return torch.relu(_bn(_conv2(x, p, conv, quant, pad), p, bn, train))


def _block(x, p, name, quant, train):
    x = _cbr(x, p, f"{name}.conv.0", f"{name}.conv.1", quant, train)
    return _cbr(x, p, f"{name}.conv.3", f"{name}.conv.4", quant, train)


def lgca(p, volume, slices, quant: Quant = None, train: bool = False, feats=None) -> Dict:
    """volume (1, 1, D, Hv, Wv), slices (B, 1, H, W) → seg_2d (B, K, H, W),
    dsv (1, K, D, Hv, Wv) and ``decoder``, the last decoder stage's features
    (B, 64, H, W). ``feats``: the context net's outputs on this volume, where
    they are at hand (eval computes them once a volume)."""
    feats = context_net(volume, p, quant) if feats is None else feats
    pyr = [feats[k] for k in ("d1", "d2", "d3", "d4")]
    B, _, H, W = slices.shape
    glob = feats["d4"].mean(dim=(2, 3, 4))[:, :, None, None].expand(B, -1, H, W)
    u = "unet"
    skips = [_block(slices, p, f"{u}.Conv1", quant, train)]
    cur = skips[0]
    for lvl, (heads, _, embed) in enumerate(ATT_SPEC):
        cur = F.max_pool2d(cur, 2)
        sa = f"{u}.self_attention{lvl + 1}"
        fused = torch.cat([_attention(cur, pyr[lvl], p, f"{sa}.att_layer_{i}", quant, embed)
                           for i in range(heads)], 1)
        att = _cbr(fused, p, f"{sa}.conv.0", f"{sa}.conv.1", quant, train, 0)
        cur = _block(torch.cat([cur, att], 1), p, f"{u}.Conv{lvl + 2}", quant, train)
        skips.append(cur)
    d = skips[4]
    for lvl in (5, 4, 3, 2):
        d = F.interpolate(d, scale_factor=2, mode="nearest")
        d = _cbr(d, p, f"{u}.Up{lvl}.up.1", f"{u}.Up{lvl}.up.2", quant, train)
        parts = [skips[lvl - 2], d] + ([glob] if lvl == 2 else [])
        d = _block(torch.cat(parts, 1), p, f"{u}.Up_conv{lvl}", quant, train)
    return {"seg_2d": _conv2(d, p, f"{u}.Conv_1x1", quant), "dsv": feats["dsv"], "decoder": d}


def dice_per_class(pred, target):
    """(N, K) logits and {0, 1} targets → (K,) Tversky-style Dice losses of
    the sigmoid, 0 for a class with no foreground."""
    p0 = torch.sigmoid(pred)
    num = (p0 * target).sum(0)
    den = num + 0.5 * (p0 * (1 - target)).sum(0) + 0.5 * ((1 - p0) * target).sum(0)
    return (1 - num / (den + 1e-5)) * (target.sum(0) > 0).to(pred.dtype)


def loss(out, mask, vmask):
    """Mean over classes of the 2D and the 3D Dice losses. mask (B, H, W, K),
    vmask (1, D, Hv, Wv, K)."""
    K = mask.shape[-1]
    seg = out["seg_2d"].permute(0, 2, 3, 1).reshape(-1, K)
    dsv = out["dsv"].permute(0, 2, 3, 4, 1).reshape(-1, K)
    return (dice_per_class(seg, mask.reshape(-1, K))
            + dice_per_class(dsv, vmask.reshape(-1, K))).mean()
