"""Plain reference of an RP_Net episode, for deciding ``correct``.

Straight PyTorch (NCHW, ``torch.nn.functional``), f32, from the weights the
benchmark drew: the reader's preprocessing and slice binning
(few_shot_reader.py), the affine registration (a 50-step Adam fit of a 2×3
theta on the MSE, on images pooled by ``reg_fit_scale``), the network of
upstream RP-Net (U-Net encoder to 'd4', the context relation encoder with a
radius-r local correlation computed as shifted products, masked average
pooling of bilinearly upsampled features, cosine distance × 20, the
recurrent hard-mask refinement), its training loss (dice + cross-entropy
and the PANet align loss, batch norms on each episode's own statistics),
and the Dice and NCC of an episode.

It imports nothing of the program. ``quant`` is applied to every input and
weight of a convolution, to the correlation's inputs, to the head's
products (the masked pooling, the cosine) and to the logits it outputs:
the identity for the reference, a lower precision for the control.
"""

from __future__ import annotations

import math
import random
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

Quant = Optional[Callable[[torch.Tensor], torch.Tensor]]
BN_EPS = 1e-5


def _q(quant: Quant, x):
    return x if quant is None else quant(x)


# --------------------------------------------------------------- the reader

def truncate(image, num_slice, num_x, num_y):
    D, H, W = image.shape
    x1, x2 = max(0, W // 2 - num_x // 2), min(W, W // 2 + num_x // 2)
    y1, y2 = max(0, H // 2 - num_y // 2), min(H, H // 2 + num_y // 2)
    return image[:num_slice, y1:y2, x1:x2]


def pad16(image, value):
    pads = [(0, -(-s // 16) * 16 - s) for s in image.shape]
    return np.pad(image, pads, "constant", constant_values=value)


def normalize_hu(img, lo, hi):
    """Clip above the 99.5th percentile, clip to [lo, hi], map to [-1, 1]."""
    img = np.array(img, dtype=np.float32, copy=True)
    top = np.float32(np.percentile(img, 99.5))
    img = np.where(img > top, top, img)
    img = np.clip(img, lo, hi)
    return ((img - lo) / max(1, hi - lo) * 2 - 1).astype(np.float32)


def preprocess(ct: np.ndarray, mask: np.ndarray, cfg) -> tuple:
    """The episodic reader's chain for one (CT, mask) pair: truncate, pad to
    16, keep the annotated z range [first, last) (upstream drops the last
    annotated slice), centre-crop to ``crop_size``, normalize the HU."""
    m = pad16(truncate(mask.astype(np.float32), cfg["num_slice"], cfg["num_x"], cfg["num_y"]), 0)
    img = pad16(truncate(ct.astype(np.float32), cfg["num_slice"], cfg["num_x"], cfg["num_y"]),
                cfg["pad_value"])
    zz = np.flatnonzero(m.any(axis=(1, 2)))
    img, m = img[zz.min():zz.max()], m[zz.min():zz.max()]
    ch, cw = cfg["crop_size"]
    _, h, w = m.shape
    rh, rw = min(ch, h), min(cw, w)
    cy, cx = h // 2, w // 2
    sl = (slice(None), slice(cy - rh // 2, cy + rh - rh // 2), slice(cx - rw // 2, cx + rw - rw // 2))
    pad = [(0, 0), ((ch - rh) // 2, (ch - rh) - (ch - rh) // 2),
           ((cw - rw) // 2, (cw - rw) - (cw - rw) // 2)]
    img = np.pad(img[sl], pad, constant_values=cfg["pad_value"])
    m = np.pad(m[sl], pad, constant_values=0)
    return normalize_hu(img, *cfg["HU_range"]), m


def slice_bins(n_support: int, nq: int, k: int):
    """k support slices evenly spaced, and the k query bins' edges."""
    k = min(k, n_support, nq)
    idx = np.floor(np.arange(n_support / k / 2, n_support, n_support / k)).astype(np.int32)[:k]
    edges = np.floor(np.array(np.arange(0, nq, nq / k).tolist() + [nq])).astype(np.int32)[:k + 1]
    edges[-1] = nq
    return k, idx, edges


def support_rows(n_support: int, nq: int, k: int) -> np.ndarray:
    """(nq,) the support slice matched to each query slice: k support slices
    evenly spaced, each repeated over one of k query bins."""
    _, idx, edges = slice_bins(n_support, nq, k)
    return np.repeat(idx, np.diff(edges))


# ------------------------------------------------------------- registration

def _warp(x, theta):
    grid = F.affine_grid(theta, list(x.shape), align_corners=False)
    return F.grid_sample(x, grid, mode="bilinear", padding_mode="zeros", align_corners=False)


def register(supp, qry, lab, iters: int = 50, lr: float = 0.01, fit_scale: int = 1,
             quant: Quant = None) -> Dict:
    """Affine registration of each support slice onto its query slice.
    supp, qry in [-1, 1], lab {0, 1}: (S, H, W) → prior (S, H, W) {0, 1},
    the affine-warped support in [-1, 1] and its label {0, 1}, and the
    support after the reference's identity resampling, in [-1, 1]. With
    ``quant`` every warp's image and theta are rounded by it."""
    S, H, W = supp.shape
    q = lambda x: _q(quant, x)
    src, dst = ((supp + 1) / 2)[:, None], ((qry + 1) / 2)[:, None]
    ms, fs = (F.avg_pool2d(src, fit_scale), F.avg_pool2d(dst, fit_scale)) if fit_scale > 1 \
        else (src, dst)
    theta = torch.eye(2, 3, dtype=supp.dtype, device=supp.device).repeat(S, 1, 1)
    mu, nu = torch.zeros_like(theta), torch.zeros_like(theta)
    b1, b2, eps = 0.9, 0.999, 1e-8
    for t in range(1, iters + 1):
        th = theta.detach().requires_grad_(True)
        with torch.enable_grad():
            loss = ((q(fs) - q(_warp(q(ms), q(th)))) ** 2).mean(dim=(1, 2, 3)).sum()
            (g,) = torch.autograd.grad(loss, th)
        mu = b1 * mu + (1 - b1) * g
        nu = b2 * nu + (1 - b2) * g * g
        theta = theta - lr * (mu / (1 - b1 ** t)) / (torch.sqrt(nu / (1 - b2 ** t)) + eps)
    both = q(_warp(q(torch.cat([lab[:, None], src], dim=1)), q(theta.detach())))
    # the upstream zero-flow resampling: an identity grid built with (S - 1)
    # denominators, sampled with align_corners=False
    ys, xs = torch.meshgrid(torch.arange(H, dtype=supp.dtype, device=supp.device),
                            torch.arange(W, dtype=supp.dtype, device=supp.device), indexing="ij")
    grid = torch.stack([2 * (xs / (W - 1) - 0.5), 2 * (ys / (H - 1) - 0.5)], -1)
    warped = q(F.grid_sample(both, q(grid[None].expand(S, H, W, 2)), mode="bilinear",
                             padding_mode="zeros", align_corners=False))
    return {"prior": (warped[:, 0] > 0.1).float(), "warped_src": warped[:, 1] * 2 - 1,
            "affine_src": both[:, 1] * 2 - 1, "affine_label": (both[:, 0] > 0.1).float()}


# ------------------------------------------------------------------ network

def _bn(x, sd, name, train: bool, groups: int = 1):
    """Batch norm: running statistics in eval; in training each of
    ``groups`` leading blocks of the batch on its own statistics."""
    w, b = sd[name + ".weight"], sd[name + ".bias"]
    if not train:
        return F.batch_norm(x, sd[name + ".running_mean"], sd[name + ".running_var"], w, b,
                            False, 0.0, BN_EPS)
    xg = x.reshape(groups, -1, *x.shape[1:])
    mean = xg.mean(dim=(1, 3, 4), keepdim=True)
    var = ((xg - mean) ** 2).mean(dim=(1, 3, 4), keepdim=True)
    y = (xg - mean) / torch.sqrt(var + BN_EPS)
    return (y * w[:, None, None] + b[:, None, None]).reshape(x.shape)


def _conv(x, sd, name, quant: Quant, pad: int):
    return F.conv2d(_q(quant, x), _q(quant, sd[name + ".weight"]), sd[name + ".bias"],
                    padding=pad)


def _cbr(x, sd, conv, bn, quant, train, groups, k=3):
    return torch.relu(_bn(_conv(x, sd, conv, quant, k // 2), sd, bn, train, groups))


def _block(x, sd, name, quant, train, groups):
    x = _cbr(x, sd, f"{name}.conv.0", f"{name}.conv.1", quant, train, groups)
    return _cbr(x, sd, f"{name}.conv.3", f"{name}.conv.4", quant, train, groups)


def _up(x, sd, name, quant, train, groups):
    x = F.interpolate(x, scale_factor=2, mode="nearest")
    return _cbr(x, sd, f"{name}.up.1", f"{name}.up.2", quant, train, groups)


def unet(x, sd, quant: Quant = None, train: bool = False, groups: int = 1):
    """The U-Net encoder to 'd4': (N, 1, H, W) → (N, 256, H/4, W/4)."""
    e = lambda n, a: _block(a, sd, f"encoder.{n}", quant, train, groups)
    x1 = e("Conv1", x)
    x2 = e("Conv2", F.max_pool2d(x1, 2))
    x3 = e("Conv3", F.max_pool2d(x2, 2))
    x4 = e("Conv4", F.max_pool2d(x3, 2))
    x5 = e("Conv5", F.max_pool2d(x4, 2))
    d5 = e("Up_conv5", torch.cat([x4, _up(x5, sd, "encoder.Up5", quant, train, groups)], 1))
    return e("Up_conv4", torch.cat([x3, _up(d5, sd, "encoder.Up4", quant, train, groups)], 1))


def local_correlation(fm1, fm2, r: int, quant: Quant = None):
    """(B, C, H, W) × 2 → (B, (2r+1)², H, W): channel dx·(2r+1) + dy holds
    Σ_c fm1[y, x]·fm2[y + dy − r, x + dx − r] / √C (zero outside the image;
    the horizontal shift is the slow axis, as upstream orders it)."""
    B, C, H, W = fm1.shape
    d = 2 * r + 1
    a, p = _q(quant, fm1), F.pad(_q(quant, fm2), (r, r, r, r))
    scale = float(np.float32(1.0 / math.sqrt(C)))
    return torch.stack([(a * p[:, :, dy:dy + H, dx:dx + W]).sum(1)
                        for dx in range(d) for dy in range(d)], 1) * scale


def cre(fm1, fm2, sd, r: int, quant: Quant = None, train: bool = False, groups: int = 1):
    """The context relation encoder on fg- and bg-masked features."""
    fm1 = _cbr(fm1, sd, "cre.w_k.0", "cre.w_k.1", quant, train, groups)
    fm2 = _cbr(fm2, sd, "cre.w_q.0", "cre.w_q.1", quant, train, groups)
    corr = local_correlation(fm1, fm2, r, quant)
    return _cbr(torch.cat([corr, fm1], 1), sd, "cre.q.0", "cre.q.1", quant, train, groups, k=1)


def masked_pool(fts, mask, quant: Quant = None):
    """getFeatures: features upsampled to the mask, averaged over it → (B, C)."""
    up = F.interpolate(fts, size=mask.shape[-2:], mode="bilinear", align_corners=False)
    return (_q(quant, up) * mask[:, None]).sum((2, 3)) / (mask.sum((1, 2))[:, None] + 1e-5)


def cos20(fts, proto, quant: Quant = None):
    """Cosine similarity × 20, each norm clamped at 1e-8: (B, C, h, w), (B, C) → (B, h, w)."""
    fts, p = _q(quant, fts), _q(quant, proto)[:, :, None, None]
    return (fts * p).sum(1) / (fts.norm(dim=1).clamp_min(1e-8) * p.norm(dim=1).clamp_min(1e-8)) * 20


def head(inter, fg, bg, size, quant: Quant = None):
    """The refinement head: the query's CRE output scored against the
    support's prototypes → the distances (B, 2, h, w) and the logits
    upsampled to ``size`` (the network's output, rounded by ``quant``)."""
    dist = torch.stack([cos20(inter, bg, quant), cos20(inter, fg, quant)], 1)
    return dist, _q(quant, F.interpolate(dist, size=size, mode="bilinear", align_corners=False))


def rpnet(sd, supp, fore, back, qry, appr, num_iter: int, radius: int = 5, scale: int = 4,
          quant: Quant = None, train: bool = False, episodes: int = 1, masks=None) -> Dict:
    """RP_Net, one way and one shot. supp, fore, back, qry, appr: (B, H, W)
    (the B slices of ``episodes`` episodes, episode-major) → the refinement
    logits (T, B, 2, H, W), every CRE output (the support's, then each
    iteration's), and the last iteration's features and prototypes for the
    align loss. ``masks`` (T - 1, B, H, W): the hard masks that iterations
    1.. start from, in place of the previous iteration's own (to follow
    another run's refinement chain)."""
    B, H, W = qry.shape
    if train:   # two encoder passes, batch norms per pass and per episode
        supp_fts = unet(supp[:, None], sd, quant, True, episodes)
        qry_fts = unet(qry[:, None], sd, quant, True, episodes)
    else:
        fts = unet(torch.cat([supp, qry])[:, None], sd, quant)
        supp_fts, qry_fts = fts[:B], fts[B:]
    kw = dict(r=radius, quant=quant, train=train, groups=episodes)
    smask = F.avg_pool2d(fore[:, None], scale)
    sf = cre(supp_fts * smask, supp_fts * (1 - smask), sd, **kw)
    fg, bg = masked_pool(sf, fore, quant), masked_pool(sf, back, quant)
    qmask = F.avg_pool2d(appr[:, None], scale)
    logits, cres = [], [sf]
    for it in range(num_iter):
        inter = cre(qry_fts * qmask, qry_fts * (1 - qmask), sd, **kw)
        dist, lg = head(inter, fg, bg, (H, W), quant)
        hard = (torch.softmax(lg, 1)[:, 1] > 0.5).float() if masks is None or it + 1 >= num_iter \
            else masks[it]
        qmask = F.avg_pool2d(hard[:, None], scale)
        logits.append(lg)
        cres.append(inter)
    return {"refinement": torch.stack(logits), "cre": cres, "inter": inter, "dist": dist,
            "fg": fg, "bg": bg, "supp_feat": sf}


# --------------------------------------------------------- losses, metrics

def dice_ce(logits, labels):
    """Dice over softmax probabilities + cross-entropy: (N, 2, H, W), (N, H, W)."""
    probs = torch.softmax(logits, 1)
    onehot = torch.stack([1 - labels, labels], 1)
    inter = (probs * onehot).sum((0, 2, 3))
    card = (probs + onehot).sum((0, 2, 3))
    dice = 1 - (2 * inter / (card + 1e-7)).mean()
    return dice + F.cross_entropy(logits, labels.long())


def align_loss(out, fore, back, episodes: int):
    """PANet prototype alignment (rp_net.py:394-440), per episode → (E,):
    query prototypes over each episode's slices from the argmax of the last
    iteration's feature-resolution distances, the support features scored
    against them, upsampled, cross-entropy over the support's labels."""
    inter, dist, sf = out["inter"], out["dist"], out["supp_feat"]
    B, C, h, w = inter.shape
    E, (H, W) = episodes, fore.shape[-2:]
    pred = F.one_hot(dist.argmax(1), 2).permute(0, 3, 1, 2).to(inter.dtype)   # (B, 2, h, w)
    fts = inter.reshape(E, B // E, C, h * w)
    bin_ = pred.reshape(E, B // E, 2, h * w)
    qsum = torch.einsum("escn,eskn->ekc", fts, bin_)
    qcnt = bin_.sum((1, 3))                                          # (E, 2)
    protos = (qsum / (qcnt[..., None] + 1e-5)).repeat_interleave(B // E, 0)   # (B, 2, C)
    lg = torch.stack([cos20(sf, protos[:, 0]), cos20(sf, protos[:, 1])], 1)
    logp = torch.log_softmax(F.interpolate(lg, size=(H, W), mode="bilinear",
                                           align_corners=False), 1)
    fg = fore * (1 - back)
    ce = -(fg * logp[:, 1] + back * logp[:, 0])
    valid = (fg + back).reshape(E, -1).sum(1)
    per_ep = ce.reshape(E, -1).sum(1) / valid.clamp_min(1.0)
    return (qcnt[:, 1] > 0).to(inter.dtype) * per_ep


def dice(pred, target):
    inter = (pred * target).sum()
    return float(2 * inter / (target.sum() + pred.sum()).clamp_min(1e-12))


def ncc(a, b):
    a, b = a - a.mean(), b - b.mean()
    return float(-(a * b).sum() / torch.sqrt((a * a).sum() * (b * b).sum() + 1e-10))


def episode_metrics(reg: Dict, masks, supp, qry, qry_lab) -> Dict[str, float]:
    """The episode's Dice and NCC: prior and each refinement's hard mask
    against the query's label, the registered and the raw support against
    the query image."""
    out = {"dsc_affine": dice(reg["prior"], qry_lab), "ncc_warped": ncc(reg["warped_src"], qry),
           "ncc_raw": ncc(supp, qry)}
    for t, m in enumerate(masks):
        out[f"ref_{t}"] = dice(m, qry_lab)
    out["dsc_fewshot"] = out[f"ref_{len(masks) - 1}"]
    return out


# ------------------------------------------------------ the train sampler

def gamma(img, lo, hi):
    """Gamma jitter of a [-1, 1] image; one ``np.random.rand()``."""
    g = np.random.rand() * (hi - lo) + lo
    img = (img + 1) / 2.0
    cmin = img.min()
    rng = img.max() - cmin + 1e-5
    img = rng * np.power((img - cmin + 1e-5) / rng, g) + cmin
    return img * 2 - 1


def warp_nearest(src, M):
    """OpenCV's ``warpAffine`` with nearest sampling (OpenCV 5's float32
    coordinate arithmetic), pixels from outside 0."""
    H, W = src.shape
    m = np.asarray(M, np.float64).ravel()
    det = m[0] * m[4] - m[1] * m[3]
    det = 1.0 / det if det != 0 else 0.0
    a11, a22, a12, a21 = m[4] * det, m[0] * det, -m[1] * det, -m[3] * det
    inv = np.array([a11, a12, -a11 * m[2] - a12 * m[5],
                    a21, a22, -a21 * m[2] - a22 * m[5]]).astype(np.float32)
    y = np.arange(H, dtype=np.float32)[:, None]
    x = np.arange(W, dtype=np.float32)[None, :]
    fma = lambda a, b, c: (np.float64(a) * b.astype(np.float64) + c.astype(np.float64)).astype(np.float32)
    sx = np.rint(fma(inv[0], x, y * inv[1] + inv[2]))
    sy = np.rint(fma(inv[3], x, y * inv[4] + inv[5]))
    ok = (sx >= 0) & (sx < W) & (sy >= 0) & (sy < H)
    out = np.zeros((H, W), src.dtype)
    out[ok] = src[sy[ok].astype(np.int64), sx[ok].astype(np.int64)]
    return out


def random_affine(img, lab):
    """Rotation ±5°, translation ±20%, scale 0.7–1.5 about the centre (four
    ``np.random.uniform``), nearest; empty pixels take the image minimum."""
    H, W = img.shape
    ang = np.random.uniform(-5.0, 5.0)
    tx = np.random.uniform(-0.2, 0.2) * W
    ty = np.random.uniform(-0.2, 0.2) * H
    sc = np.random.uniform(0.7, 1.5)
    a = ang * (np.pi / 180)
    al, be = np.cos(a) * sc, np.sin(a) * sc
    cx, cy = W / 2, H / 2
    M = np.array([[al, be, (1 - al) * cx - be * cy + tx], [-be, al, be * cx + (1 - al) * cy + ty]])
    img01 = (img + 1) / 2
    out = warp_nearest(img01, M)
    out[out == 0] = img01.min()
    return out * 2 - 1, warp_nearest(lab, M)


def train_episode(support, query, cfg):
    """A training episode from one support (image, label) and the query
    volume: the support's k evenly spaced slices, one random query slice
    from each bin (``random.randint``), each gamma-jittered half the time
    and randomly warped, all shuffled together (numpy's global stream)."""
    (s_img, s_lab), (q_img, q_lab) = support, query
    k, idx, edges = slice_bins(s_img.shape[0], q_img.shape[0], cfg["k"])
    qi, ql = [], []
    for j in range(k):
        a, b = int(edges[j]), int(edges[j + 1])
        ind = random.randint(a, max(b - 1, a))
        q, l = q_img[ind], q_lab[ind]
        if cfg["do_intaug"] and np.random.randint(2, size=1).item():
            q = gamma(q, *cfg["gamma_range"])
        q, l = random_affine(q, l)
        qi.append(q)
        ql.append(l)
    order = np.arange(k)
    np.random.shuffle(order)
    return (s_img[idx][order][None].astype(np.float32), s_lab[idx][order][None].astype(np.float32),
            np.stack(qi)[order].astype(np.float32), np.stack(ql)[order].astype(np.float32))
