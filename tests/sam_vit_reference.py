"""Plain reference of SAM's ViT image encoder, for the port's CPU tests.

SAM's ``ImageEncoderViT`` (arXiv:2304.02643; segment_anything/modeling/
image_encoder.py) written from its published equations in plain ``torch``,
f32, NCHW images in, on a ``state_dict`` under SAM's names; it imports no
module of the port and no JAX. Departures: none in the arithmetic; the
relative-position tables are indexed without SAM's interpolation, which
applies only where a table's length differs from 2·size − 1 (never here),
and ``rpnet_input`` is RP_Net's glue, not SAM's (the crop resized
bilinearly to ``img_size`` and broadcast to 3 channels, where MedSAM
resizes on the host with a cubic filter after min–max scaling).

Importing it turns TF32 off for matrix products and cuDNN, so that an f32
product on a card is f32.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

LN_EPS = 1e-6


def layer_norm(x, w, b):
    """Over the last axis: (x − mean) / √(var + eps) · w + b."""
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + LN_EPS) * w + b


def rel_table(rel_pos, size):
    """R[i, j] = rel_pos[i − j + size − 1]: (size, size, C)."""
    i = torch.arange(size)
    return rel_pos[i[:, None] - i[None, :] + size - 1]


def attention(x, sd, p, heads):
    """x (B, H, W, D) → (B, H, W, D): softmax(q·scale·kᵀ + rel_h + rel_w)·v, proj."""
    B, H, W, D = x.shape
    c = D // heads
    qkv = x @ sd[p + "qkv.weight"].T + sd[p + "qkv.bias"]
    qkv = qkv.reshape(B, H * W, 3, heads, c).permute(2, 0, 3, 1, 4)     # (3, B, n, HW, c)
    q, k, v = qkv[0], qkv[1], qkv[2]
    attn = (q * (c ** -0.5)) @ k.transpose(-2, -1)                    # (B, n, HW, HW)
    rq = q.reshape(B, heads, H, W, c)
    rel_h = torch.einsum("bnhwc,hkc->bnhwk", rq, rel_table(sd[p + "rel_pos_h"], H))
    rel_w = torch.einsum("bnhwc,wkc->bnhwk", rq, rel_table(sd[p + "rel_pos_w"], W))
    attn = (attn.reshape(B, heads, H, W, H, W) + rel_h[..., :, None] + rel_w[..., None, :])
    attn = torch.softmax(attn.reshape(B, heads, H * W, H * W), -1)
    out = (attn @ v).permute(0, 2, 1, 3).reshape(B, H, W, D)
    return out @ sd[p + "proj.weight"].T + sd[p + "proj.bias"]


def block(x, sd, p, heads, window):
    """A pre-LN block; windowed where ``window`` > 0: the normed map padded
    with zeros at the bottom and right to whole windows, every window
    attended on its own (the padded tokens included, unmasked), the padding
    cropped."""
    shortcut = x
    x = layer_norm(x, sd[p + "norm1.weight"], sd[p + "norm1.bias"])
    if window:
        B, H, W, D = x.shape
        Hp, Wp = math.ceil(H / window) * window, math.ceil(W / window) * window
        xp = torch.zeros(B, Hp, Wp, D, dtype=x.dtype)
        xp[:, :H, :W] = x
        out = torch.zeros_like(xp)
        for i in range(0, Hp, window):
            for j in range(0, Wp, window):
                out[:, i:i + window, j:j + window] = attention(
                    xp[:, i:i + window, j:j + window], sd, p + "attn.", heads)
        x = out[:, :H, :W]
    else:
        x = attention(x, sd, p + "attn.", heads)
    x = shortcut + x
    h = layer_norm(x, sd[p + "norm2.weight"], sd[p + "norm2.bias"])
    h = F.gelu(h @ sd[p + "mlp.lin1.weight"].T + sd[p + "mlp.lin1.bias"])
    return x + h @ sd[p + "mlp.lin2.weight"].T + sd[p + "mlp.lin2.bias"]


def image_encoder(x, sd, widths, prefix="encoder."):
    """x (N, 3, img_size, img_size) → (N, out_chans, img_size/patch, img_size/patch)."""
    p = prefix
    ps = widths["patch_size"]
    x = F.conv2d(x, sd[p + "patch_embed.proj.weight"], sd[p + "patch_embed.proj.bias"],
                 stride=ps).permute(0, 2, 3, 1)
    x = x + sd[p + "pos_embed"]
    for i in range(widths["depth"]):
        window = 0 if i in widths["global_attn_indexes"] else widths["window_size"]
        x = block(x, sd, f"{p}blocks.{i}.", widths["num_heads"], window)
    x = F.conv2d(x.permute(0, 3, 1, 2), sd[p + "neck.0.weight"])
    x = layer_norm(x.permute(0, 2, 3, 1), sd[p + "neck.1.weight"], sd[p + "neck.1.bias"])
    x = F.conv2d(x.permute(0, 3, 1, 2), sd[p + "neck.2.weight"], padding=1)
    x = layer_norm(x.permute(0, 2, 3, 1), sd[p + "neck.3.weight"], sd[p + "neck.3.bias"])
    return x.permute(0, 3, 1, 2)


def rpnet_input(imgs, img_size):
    """RP_Net's (N, H, W) crops → (N, 3, img_size, img_size)."""
    x = F.interpolate(imgs[:, None], size=(img_size, img_size), mode="bilinear",
                      align_corners=False)
    return x.expand(-1, 3, -1, -1)
