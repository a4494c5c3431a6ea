"""SAM's ViT image encoder as RP_Net's backbone (``backbone: sam_vit``).

The image encoder of Segment Anything (arXiv:2304.02643;
``segment_anything/modeling/image_encoder.py::ImageEncoderViT`` as
``build_sam.py::build_sam_vit_b`` builds it), the encoder MedSAM fine-tunes
for CT and MRI, on channels-last tensors:

  * patch embedding: a conv of kernel and stride ``patch_size`` (3 →
    ``embed_dim``, with bias), computed as one matrix product over the
    unfolded patches, then ``+ pos_embed``, a learned absolute embedding;
  * ``depth`` pre-LN blocks, ``x = x + attn(norm1(x)); x = x + mlp(norm2(x))``
    (LayerNorm eps 1e-6, MLP 4 × ``embed_dim`` with exact GELU), global
    attention at ``global_attn_indexes`` and ``window_size``² windows
    elsewhere;
  * attention: ``softmax(q·kᵀ/√d + rel_h + rel_w)·v`` then ``proj``, with
    SAM's decomposed relative-position bias: ``rel_h[b, qh, qw, kh] =
    Σ_c q[b, qh, qw, c]·rel_pos_h[qh − kh + k_h − 1, c]`` from the unscaled
    q, and likewise ``rel_w`` over the columns;
  * neck: 1×1 conv to ``out_chans`` (no bias), LayerNorm over channels, 3×3
    conv (no bias), LayerNorm over channels.

Windowed blocks keep SAM's quirk: the map is zero-padded to a multiple of
the window after ``norm1``; the padded tokens go through ``qkv`` (their keys
and values are its biases), take part in every window's softmax unmasked,
and are cropped after ``proj``.

The attention is ``F.scaled_dot_product_attention`` with the decomposed
bias materialized as its additive mask in the network's dtype (bf16 in
eval; built by :func:`rel_pos_bias` as one matrix product), one call a
block and pass, counted in :data:`attention_calls`
(windowed and global) and timed by the device span ``sam.attn`` (the bias
and the attention). At ViT-B's widths a global block's bias is 12·4096²
values a slice, 403 MB in bf16, so :meth:`SamViTEncoder.slices_per_pass`
sizes the micro-batches of RP_Net's merged encoder pass from the device's
memory. Parameter names are SAM's (``patch_embed.proj``, ``pos_embed``,
``blocks.i.{norm1, attn.qkv, attn.proj, attn.rel_pos_h, attn.rel_pos_w,
norm2, mlp.lin1, mlp.lin2}``, ``neck.0``..``neck.3``), so a SAM or MedSAM
checkpoint's ``image_encoder.*`` loads by a rename
(:func:`encoder_state_from_sam`).
"""

from __future__ import annotations

import math
from typing import Dict, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from rpnet_tpu_torch.models.blocks import Conv2d
from rpnet_tpu_torch.utils.profiling import span

LN_EPS = 1e-6
MLP_RATIO = 4
PASS_SHARE = 8                  # a pass's transient tensors: ≤ 1/8 of the card's memory
CPU_PASS_BYTES = 1 << 30        # on the CPU: 1 GiB a pass

# attention calls so far, by kind: one a block and micro-batch
attention_calls: Dict[str, int] = {"windowed": 0, "global": 0}


def rel_index(size: int) -> torch.Tensor:
    """(size, size) rows of the relative-position table: ``i − j + size − 1``
    (SAM's ``get_rel_pos`` where queries and keys have the same size)."""
    i = torch.arange(size)
    return i[:, None] - i[None, :] + (size - 1)


def rel_expand(h: int, w: int) -> torch.Tensor:
    """(h + w, h·w) 0/1 matrix that spreads ``[rel_h, rel_w]`` over the keys:
    key ``kh·w + kw`` takes row ``kh`` and row ``h + kw``."""
    e = torch.zeros(h + w, h * w)
    key = torch.arange(h * w)
    e[key // w, key] = 1.0
    e[h + key % w, key] = 1.0
    return e


def rel_pos_bias(q, rel_pos_h, rel_pos_w, size, index_h, index_w, expand):
    """SAM's ``add_decomposed_rel_pos`` as a tensor to add: q (B, n, H·W, C)
    unscaled, the tables (2H − 1, C) and (2W − 1, C), their
    :func:`rel_index` rows and the :func:`rel_expand` matrix → (B, n, H·W,
    H·W), ``rel_h[..., kh] + rel_w[..., kw]`` at key ``kh·W + kw``, in q's
    dtype. The sum is one matrix product with the 0/1 matrix, each output
    the two terms added in f32 and rounded once, as an elementwise add
    rounds it, written at the product's rate rather than a broadcast add's."""
    B, n, L, C = q.shape
    H, W = size
    r_q = q.reshape(B, n, H, W, C)
    rel_h = torch.einsum("bnhwc,hkc->bnhwk", r_q, rel_pos_h[index_h])
    rel_w = torch.einsum("bnhwc,wkc->bnhwk", r_q, rel_pos_w[index_w])
    return torch.cat([rel_h, rel_w], -1).reshape(B, n, L, H + W) @ expand


class Attention(nn.Module):
    """Multi-head attention with the decomposed relative-position bias
    over an (B, H, W, dim) map of ``input_size`` → (B, H, W, dim)."""

    def __init__(self, dim: int, num_heads: int, input_size: Sequence[int], kind: str):
        super().__init__()
        self.num_heads, self.kind = num_heads, kind
        head_dim = dim // num_heads
        self.qkv = nn.Linear(dim, dim * 3)
        self.proj = nn.Linear(dim, dim)
        h, w = input_size
        self.rel_pos_h = nn.Parameter(torch.zeros(2 * h - 1, head_dim))
        self.rel_pos_w = nn.Parameter(torch.zeros(2 * w - 1, head_dim))
        self.register_buffer("index_h", rel_index(h), persistent=False)
        self.register_buffer("index_w", rel_index(w), persistent=False)
        self.register_buffer("expand", rel_expand(h, w), persistent=False)

    def forward(self, x):
        B, H, W, _ = x.shape
        qkv = self.qkv(x).reshape(B, H * W, 3, self.num_heads, -1).permute(2, 0, 3, 1, 4)
        q, k, v = qkv.unbind(0)                                     # (B, n, H·W, C)
        with span("sam.attn", x.device):
            bias = rel_pos_bias(q, self.rel_pos_h, self.rel_pos_w, (H, W),
                                self.index_h, self.index_w, self.expand)
            out = F.scaled_dot_product_attention(q, k, v, attn_mask=bias)
        attention_calls[self.kind] += 1
        return self.proj(out.transpose(1, 2).reshape(B, H, W, -1))


def window_partition(x, window: int):
    """(B, H, W, C) → windows (B·nh·nw, window, window, C), zero-padded at
    the bottom and right, and the padded size (SAM's ``window_partition``)."""
    B, H, W, C = x.shape
    ph, pw = (window - H % window) % window, (window - W % window) % window
    if ph or pw:
        x = F.pad(x, (0, 0, 0, pw, 0, ph))
    Hp, Wp = H + ph, W + pw
    x = x.view(B, Hp // window, window, Wp // window, window, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window, window, C), (Hp, Wp)


def window_unpartition(windows, window: int, padded, size):
    """The inverse of :func:`window_partition`, the padding cropped."""
    (Hp, Wp), (H, W) = padded, size
    B = windows.shape[0] // (Hp * Wp // window // window)
    x = windows.view(B, Hp // window, Wp // window, window, window, -1)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(B, Hp, Wp, -1)
    return x[:, :H, :W].contiguous() if Hp > H or Wp > W else x


class MLPBlock(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.lin1 = nn.Linear(dim, hidden)
        self.lin2 = nn.Linear(hidden, dim)
        self.act = nn.GELU()

    def forward(self, x):
        return self.lin2(self.act(self.lin1(x)))


class Block(nn.Module):
    """A pre-LN transformer block, windowed where ``window`` > 0."""

    def __init__(self, dim: int, num_heads: int, window: int, grid: int):
        super().__init__()
        self.window = window
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        size = (window, window) if window else (grid, grid)
        self.attn = Attention(dim, num_heads, size, "windowed" if window else "global")
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = MLPBlock(dim, dim * MLP_RATIO)

    def forward(self, x):
        shortcut = x
        x = self.norm1(x)
        if self.window:
            H, W = x.shape[1:3]
            x, padded = window_partition(x, self.window)
            x = window_unpartition(self.attn(x), self.window, padded, (H, W))
        else:
            x = self.attn(x)
        x = shortcut + x
        return x + self.mlp(self.norm2(x))


class PatchEmbed(nn.Module):
    """SAM's ``PatchEmbed``: ``proj``, a conv of kernel and stride ``patch``,
    applied as one matrix product over the unfolded patches (the conv's
    sums in another order). (B, H, W, 3) → (B, H/p, W/p, dim)."""

    def __init__(self, patch: int, in_chans: int, dim: int):
        super().__init__()
        self.patch = patch
        self.proj = nn.Conv2d(in_chans, dim, patch, stride=patch)

    def forward(self, x):
        B, H, W, C = x.shape
        p = self.patch
        patches = x.reshape(B, H // p, p, W // p, p, C).permute(0, 1, 3, 5, 2, 4)
        patches = patches.reshape(B, H // p, W // p, C * p * p)     # (c, kh, kw) as the weight
        return F.linear(patches, self.proj.weight.reshape(self.proj.out_channels, -1),
                        self.proj.bias)


class SamViTEncoder(nn.Module):
    """(N, img_size, img_size, 3) → (N, img_size/patch, img_size/patch,
    out_chans). The defaults are ``build_sam_vit_b``'s."""

    def __init__(self, img_size: int = 1024, patch_size: int = 16, embed_dim: int = 768,
                 depth: int = 12, num_heads: int = 12,
                 global_attn_indexes: Sequence[int] = (2, 5, 8, 11), window_size: int = 14,
                 out_chans: int = 256):
        super().__init__()
        self.img_size, self.num_heads, self.out_channels = img_size, num_heads, out_chans
        grid = img_size // patch_size
        self.patch_embed = PatchEmbed(patch_size, 3, embed_dim)
        self.pos_embed = nn.Parameter(torch.zeros(1, grid, grid, embed_dim))
        self.blocks = nn.ModuleList(
            Block(embed_dim, num_heads, 0 if i in global_attn_indexes else window_size, grid)
            for i in range(depth))
        # SAM's LayerNorm2d normalizes each pixel's channels: on channels-last
        # tensors, a LayerNorm over the last axis
        self.neck = nn.Sequential(Conv2d(embed_dim, out_chans, 1, bias=False),
                                  nn.LayerNorm(out_chans, eps=LN_EPS),
                                  Conv2d(out_chans, out_chans, 3, padding=1, bias=False),
                                  nn.LayerNorm(out_chans, eps=LN_EPS))

    def forward(self, x):
        x = self.patch_embed(x) + self.pos_embed
        for blk in self.blocks:
            x = blk(x)
        return self.neck(x)

    def slices_per_pass(self, x) -> int:
        """Slices of ``x``'s device and dtype a micro-batch may hold: the
        transient tensors of a slice's block (a global block's bias, q, k,
        v and the MLP's hidden activations, about heads·T² + 16·T·dim
        values for T tokens) within 1/:data:`PASS_SHARE` of the card's
        memory (:data:`CPU_PASS_BYTES` on the CPU)."""
        T = self.pos_embed.shape[1] * self.pos_embed.shape[2]
        per_slice = x.element_size() * (self.num_heads * T * T + 16 * T * self.pos_embed.shape[3])
        if x.device.type == "cuda":
            budget = torch.cuda.get_device_properties(x.device).total_memory // PASS_SHARE
        else:
            budget = CPU_PASS_BYTES
        return max(1, budget // per_slice)

    def encode(self, imgs):
        """RP_Net's images (N, H, W, 1), normalized crops → features: each
        resized bilinearly to ``img_size`` (align_corners False, no
        antialias), broadcast to 3 channels, encoded in micro-batches of at
        most :meth:`slices_per_pass` slices, as even as they split."""
        N = imgs.shape[0]
        passes = -(-N // self.slices_per_pass(imgs))
        step = -(-N // passes)
        outs = []
        with span("sam.encoder", imgs.device):
            for a in range(0, N, step):
                x = F.interpolate(imgs[a:a + step].permute(0, 3, 1, 2),
                                  size=(self.img_size, self.img_size), mode="bilinear",
                                  align_corners=False)
                outs.append(self(x.permute(0, 2, 3, 1).expand(-1, -1, -1, 3)))
        return outs[0] if len(outs) == 1 else torch.cat(outs)


@torch.no_grad()
def init_linear_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """torch's default ``nn.Linear`` init (kaiming_uniform(a=√5), bias
    U(±1/√fan_in)) drawn from ``generator``; ``pos_embed`` and the
    relative-position tables stay zero, and the LayerNorms ones and zeros,
    as SAM initializes them."""
    for m in module.modules():
        if isinstance(m, nn.Linear):
            nn.init.kaiming_uniform_(m.weight, a=math.sqrt(5), generator=generator)
            bound = 1.0 / math.sqrt(m.in_features)
            nn.init.uniform_(m.bias, -bound, bound, generator=generator)
    return module


SAM_PREFIX = "image_encoder."


def encoder_state_from_sam(state_dict) -> Dict[str, torch.Tensor]:
    """A SAM or MedSAM checkpoint's ``image_encoder.*`` entries under
    RP_Net's ``encoder.*`` names (the prompt encoder and mask decoder
    left out)."""
    return {"encoder." + k[len(SAM_PREFIX):]: v for k, v in state_dict.items()
            if k.startswith(SAM_PREFIX)}
