"""Plain reference of RP_Net on SAM's ViT image encoder, for deciding
``correct``.

SAM's ``ImageEncoderViT`` (arXiv:2304.02643; segment_anything/modeling/
image_encoder.py, as ``build_sam_vit_b`` builds it) written from its
published equations in straight PyTorch, f32, from the weights the
benchmark drew under SAM's names (``encoder.`` before them): the patch
embedding conv and ``pos_embed``; pre-LN blocks (LayerNorm eps 1e-6), the
windowed ones on the map zero-padded to whole windows after ``norm1``, the
padded tokens attended unmasked and cropped after ``proj``; attention
``softmax(q·kᵀ/√d + rel_h + rel_w)·v`` with the decomposed relative-position
bias from the unscaled q; the MLP with exact GELU; the neck (1×1 conv,
LayerNorm over channels, 3×3 conv, LayerNorm over channels). Then RP_Net's
eval after the encoder, from ``reference/rpnet.py``'s CRE, masked pooling
and head. Departures from SAM: its relative-position tables are indexed
without the interpolation SAM applies only where a table's length differs
from 2·size − 1 (never here); RP_Net's glue resizes the crop bilinearly to
``img_size`` and broadcasts it to 3 channels (MedSAM resizes on the host,
cubic, after min–max scaling).

A global attention's f32 scores are computed :data:`Q_BLOCK` query rows at a
time, and the encoder runs :data:`SLICES` slices a pass, so that a whole
episode's 1024² slices fit on one card. It imports nothing of the program.
``quant`` is applied as ``reference/rpnet.py`` applies it: to every input and
weight of a convolution or linear layer, to q, k, v, the relative-position
tables and the probabilities of the attention's products, and then
everywhere the RP_Net reference applies it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from reference import rpnet as ref

LN_EPS = 1e-6
Q_BLOCK = 1024   # query rows of a global attention's scores at a time
SLICES = 2       # slices an encoder pass

_q = ref._q


def _lin(x, sd, name, quant):
    return F.linear(_q(quant, x), _q(quant, sd[name + ".weight"]), sd[name + ".bias"])


def layer_norm(x, w, b):
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + LN_EPS) * w + b


def rel_table(rel_pos, size):
    """R[i, j] = rel_pos[i − j + size − 1]: (size, size, C)."""
    i = torch.arange(size, device=rel_pos.device)
    return rel_pos[i[:, None] - i[None, :] + size - 1]


def attention(x, sd, p, heads, quant=None):
    """x (B, H, W, D) → (B, H, W, D)."""
    B, H, W, D = x.shape
    c, L = D // heads, H * W
    qkv = _lin(x, sd, p + "qkv", quant).reshape(B, L, 3, heads, c).permute(2, 0, 3, 1, 4)
    q, k, v = (_q(quant, t) for t in qkv.unbind(0))                   # (B, n, L, c)
    rq = q.reshape(B, heads, H, W, c)
    rel_h = torch.einsum("bnhwc,hkc->bnhwk", rq, _q(quant, rel_table(sd[p + "rel_pos_h"], H)))
    rel_w = torch.einsum("bnhwc,wkc->bnhwk", rq, _q(quant, rel_table(sd[p + "rel_pos_w"], W)))
    rel_h, rel_w = rel_h.reshape(B, heads, L, H), rel_w.reshape(B, heads, L, W)
    out = torch.empty(B, heads, L, c, dtype=x.dtype, device=x.device)
    for a in range(0, L, Q_BLOCK):
        b = min(a + Q_BLOCK, L)
        s = (q[:, :, a:b] * c ** -0.5) @ k.transpose(-2, -1)
        s = (s.reshape(B, heads, b - a, H, W) + rel_h[:, :, a:b, :, None]
             + rel_w[:, :, a:b, None, :])
        probs = torch.softmax(s.reshape(B, heads, b - a, L), -1)
        out[:, :, a:b] = _q(quant, probs) @ v
    return _lin(out.permute(0, 2, 1, 3).reshape(B, H, W, D), sd, p + "proj", quant)


def block(x, sd, p, heads, window, quant=None):
    shortcut = x
    x = layer_norm(x, sd[p + "norm1.weight"], sd[p + "norm1.bias"])
    if window:
        B, H, W, D = x.shape
        ph, pw = -H % window, -W % window
        xp = F.pad(x, (0, 0, 0, pw, 0, ph))
        nh, nw = (H + ph) // window, (W + pw) // window
        win = xp.reshape(B, nh, window, nw, window, D).permute(0, 1, 3, 2, 4, 5)
        out = attention(win.reshape(-1, window, window, D), sd, p + "attn.", heads, quant)
        out = out.reshape(B, nh, nw, window, window, D).permute(0, 1, 3, 2, 4, 5)
        x = out.reshape(B, H + ph, W + pw, D)[:, :H, :W]
    else:
        x = attention(x, sd, p + "attn.", heads, quant)
    x = shortcut + x
    h = layer_norm(x, sd[p + "norm2.weight"], sd[p + "norm2.bias"])
    return x + _lin(F.gelu(_lin(h, sd, p + "mlp.lin1", quant)), sd, p + "mlp.lin2", quant)


def _encode(x, sd, widths, quant):
    """x (N, 3, S, S) → (N, out_chans, S/patch, S/patch)."""
    p = "encoder."
    x = F.conv2d(_q(quant, x), _q(quant, sd[p + "patch_embed.proj.weight"]),
                 sd[p + "patch_embed.proj.bias"], stride=widths["patch_size"])
    x = x.permute(0, 2, 3, 1) + sd[p + "pos_embed"]
    for i in range(widths["depth"]):
        window = 0 if i in widths["global_attn_indexes"] else widths["window_size"]
        x = block(x, sd, f"{p}blocks.{i}.", widths["num_heads"], window, quant)
    x = F.linear(_q(quant, x), _q(quant, sd[p + "neck.0.weight"].flatten(1)))
    x = layer_norm(x, sd[p + "neck.1.weight"], sd[p + "neck.1.bias"]).permute(0, 3, 1, 2)
    x = F.conv2d(_q(quant, x), _q(quant, sd[p + "neck.2.weight"]), padding=1)
    return layer_norm(x.permute(0, 2, 3, 1), sd[p + "neck.3.weight"],
                      sd[p + "neck.3.bias"]).permute(0, 3, 1, 2)


def encoder(imgs, sd, widths, quant=None):
    """RP_Net's images (N, 1, H, W) → features (N, out_chans, h, w): each
    crop resized bilinearly to ``img_size`` (align_corners False, no
    antialias), broadcast to 3 channels, encoded :data:`SLICES` at a time."""
    S = widths["img_size"]
    outs = []
    for a in range(0, imgs.shape[0], SLICES):
        x = F.interpolate(imgs[a:a + SLICES], size=(S, S), mode="bilinear", align_corners=False)
        outs.append(_encode(x.expand(-1, 3, -1, -1), sd, widths, quant))
    return torch.cat(outs)


def rpnet(sd, supp, fore, back, qry, appr, num_iter: int, radius: int = 5, scale: int = 4,
          quant=None, masks=None, *, widths, features=None):
    """RP_Net's eval, one way and one shot, on the ViT encoder (the
    arguments and outputs of ``reference.rpnet.rpnet``'s eval): the
    refinement logits (T, B, 2, H, W) and every CRE output. ``features``:
    the encoder's output for ``cat([supp, qry])``, where already computed."""
    B, H, W = qry.shape
    fts = features if features is not None else encoder(torch.cat([supp, qry])[:, None], sd,
                                                        widths, quant)
    supp_fts, qry_fts = fts[:B], fts[B:]
    kw = dict(r=radius, quant=quant)
    smask = F.avg_pool2d(fore[:, None], scale)
    sf = ref.cre(supp_fts * smask, supp_fts * (1 - smask), sd, **kw)
    fg, bg = ref.masked_pool(sf, fore, quant), ref.masked_pool(sf, back, quant)
    qmask = F.avg_pool2d(appr[:, None], scale)
    logits, cres = [], [sf]
    for it in range(num_iter):
        inter = ref.cre(qry_fts * qmask, qry_fts * (1 - qmask), sd, **kw)
        _, lg = ref.head(inter, fg, bg, (H, W), quant)
        hard = (torch.softmax(lg, 1)[:, 1] > 0.5).float() if masks is None or it + 1 >= num_iter \
            else masks[it]
        qmask = F.avg_pool2d(hard[:, None], scale)
        logits.append(lg)
        cres.append(inter)
    return {"refinement": torch.stack(logits), "cre": cres}
