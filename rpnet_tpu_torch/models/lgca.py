"""LGCANet_V3: 3D-context-aware 2D segmentation (net/lgca_net_v3.py:579-658).

The counterpart of ``rpnet_tpu/models/lgca.py``. A 3D :class:`FeatureNet`
over the whole (downsampled) CT volume — ResBlock3d stages with instance
norm — gives a pyramid d1..d4 (24/32/64/64 channels) and a deep-supervision
head ``dsv``; a 2D U-Net over full-resolution slices (:class:`FusedUNet`)
fuses the pyramid at each of its 4 encoder levels through multi-head slice
attention (each head: a max-pooled 1×1-conv embedding of the 2D map against
the same embedding of every depth of the 3D map, softmax over depth, the
depth-weighted sum of the 3D features), and a globally pooled d4 feature at
its last decoder stage. ``attention_gates`` gives the AttU_Net variant.

Layout: channels last at module boundaries, (N, H, W, C) in 2D and
(N, D, H, W, C) in 3D; convolutions view 3D inputs as NCDHW by permute
(``torch.channels_last_3d``), as ``models/blocks.py`` does in 2D. Module
and parameter names are the upstream ``state_dict``'s (``context_net.
preBlock.0``, ``context_net.forw1.0.conv1``, ``unet.Conv1.conv.0``,
``unet.self_attention1.att_layer_0.global_pooling_2D.0``, ...), which the
JAX package's ``convert_lgca_state_dict`` parses. The upstream's dead
parameters (``forw4`` and the attention ``w_q``/``w_k``) are not built.

Every 3D convolution has a bias, as flax's ``nn.Conv`` has by default; the
attention embeddings and the fuse conv have none. The slice attention is
plain torch (softmax over a few hundred depths), as it is plain XLA in the
JAX package; the path launches no hand-written kernel.

Sharded training (``train/lgca.sharded_lgca_train_step``): ``forward``
also takes the slice batch as ``models/blocks.Shards``. The 3D context net
then runs once per distinct device of the shards, with its parameters
copied there (instance norms: nothing crosses devices), and the fused U-Net
runs the shards in lockstep, its batch norms taking their statistics over
all of them; ``seg_2d`` comes back as Shards, ``dsv`` from the first
shard's device.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from rpnet_tpu_torch.models.blocks import (NORMS, AttentionBlock, Conv2d,
                                           ConvBlock, ReLU, Shards, UpConv,
                                           on_shards, replica_call)
from rpnet_tpu_torch.models.losses import dice_loss_per_class
from rpnet_tpu_torch.ops.sampling import max_pool2d
from rpnet_tpu_torch.utils.profiling import span

P_NUM = (24, 32, 64, 64)   # 3D pyramid channel counts (lgca_net_v3.py:120)
# (heads, embedding features, embedding size) of the slice attention per level
ATT_SPEC = ((2, 2, 16), (2, 2, 8), (4, 4, 4), (4, 4, 4))


def _ncdhw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 4, 1, 2, 3)


def _ndhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 4, 1)


# --------------------------------------------------------------------------
# 3D building blocks
# --------------------------------------------------------------------------

def instance_norm_3d(x, eps: float = 1e-5):
    """torch InstanceNorm3d's default (no affine, biased variance) on
    (N, D, H, W, C)."""
    return _ndhwc(F.instance_norm(_ncdhw(x), eps=eps))


def max_pool3d(x, k: int = 2):
    """2×2×2 max pool, stride 2, no padding, on (N, D, H, W, C)."""
    return _ndhwc(F.max_pool3d(_ncdhw(x), k, k))


def upsample_trilinear(x, scale: int):
    """Trilinear upsampling by ``scale`` (half-pixel centres, which
    ``jax.image.resize(..., "trilinear")`` uses) on (N, D, H, W, C)."""
    return _ndhwc(F.interpolate(_ncdhw(x), scale_factor=scale, mode="trilinear",
                                align_corners=False))


def adaptive_max_pool2d(x, out: int):
    """``AdaptiveMaxPool2d((out, out))`` on (N, H, W, C); also where ``out``
    exceeds the input."""
    return F.adaptive_max_pool2d(x.permute(0, 3, 1, 2), out).permute(0, 2, 3, 1)


def adaptive_max_pool3d_hw(x, out: int):
    """``AdaptiveMaxPool3d((None, out, out))`` on (N, D, H, W, C): depth
    untouched."""
    return _ndhwc(F.adaptive_max_pool3d(_ncdhw(x), (x.shape[1], out, out)))


class Conv3d(nn.Conv3d):
    """``nn.Conv3d`` on (N, D, H, W, C) tensors (or Shards of them)."""

    def forward(self, x):
        if isinstance(x, Shards):
            return replica_call(self, x)
        return _ndhwc(super().forward(_ncdhw(x)))


class _Fn(nn.Module):
    """A parameter-free op as a stage of an upstream ``nn.Sequential``."""

    def __init__(self, fn, *args):
        super().__init__()
        self.fn, self.args = fn, args

    def forward(self, x):
        return on_shards(lambda a: self.fn(a, *self.args), x)


class ResBlock3d(nn.Module):
    """(conv3d + instance norm + ReLU) ×2 with a shortcut (ResBlock3d,
    lgca_net_v3.py:23-51); a 1×1×1 conv + instance norm shortcut only where
    the channels change."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv1 = Conv3d(cin, cout, 3, padding=1)
        self.conv2 = Conv3d(cout, cout, 3, padding=1)
        self.shortcut = (nn.Sequential(Conv3d(cin, cout, 1), _Fn(instance_norm_3d))
                         if cin != cout else None)

    def forward(self, x):
        residual = x if self.shortcut is None else self.shortcut(x)
        out = torch.relu(instance_norm_3d(self.conv1(x)))
        out = instance_norm_3d(self.conv2(out))
        return torch.relu(out + residual)


class FeatureNet(nn.Module):
    """3D context pyramid (FeatureNet, lgca_net_v3.py:54-113).

    (N, D, H, W, 1) → d1 (full resolution, 24 channels), d2 (/2, 32),
    d3 (/4, 64), d4 (/8, 64) and dsv (full resolution, ``out_channels``:
    trilinear ×8 of d4, then a 3³ conv).
    """

    def __init__(self, out_channels: int = 6):
        super().__init__()
        self.preBlock = nn.Sequential(
            Conv3d(1, P_NUM[0], 3, padding=1), _Fn(instance_norm_3d), nn.ReLU(),
            Conv3d(P_NUM[0], P_NUM[0], 3, padding=1), _Fn(instance_norm_3d), nn.ReLU())
        self.forw1 = nn.Sequential(ResBlock3d(P_NUM[0], P_NUM[1]), ResBlock3d(P_NUM[1], P_NUM[1]))
        self.forw2 = nn.Sequential(ResBlock3d(P_NUM[1], P_NUM[2]), ResBlock3d(P_NUM[2], P_NUM[2]))
        self.forw3 = nn.Sequential(*[ResBlock3d(P_NUM[2], P_NUM[3]) for _ in range(3)])
        self.dsv = nn.Sequential(_Fn(upsample_trilinear, 8),
                                 Conv3d(P_NUM[3], out_channels, 3, padding=1))

    def forward(self, x) -> Dict[str, torch.Tensor]:
        d1 = self.preBlock(x)
        d2 = self.forw1(max_pool3d(d1))
        d3 = self.forw2(max_pool3d(d2))
        d4 = self.forw3(max_pool3d(d3))
        return {"d1": d1, "d2": d2, "d3": d3, "d4": d4, "dsv": self.dsv(d4)}


# --------------------------------------------------------------------------
# slice attention
# --------------------------------------------------------------------------

class AttentionLayer(nn.Module):
    """One slice-attention head (AttentionLayer, lgca_net_v3.py:267-328).

    feat_2d (B, H, W, C2), feat_3d (1, D, H3, W3, C3) → fused
    (B, H3, W3, C3), att (B, D).

    The two embeddings are flattened in the JAX package's orders
    (``rpnet_tpu/models/lgca.py:155-167``): the 2D one from NHWC, so
    (E, E, F), the 3D one after its transpose to (F, E, E, D), so (F, E, E).
    Their product pairs the two orders as they are; NCHW's natural
    (F, E, E) flatten of the 2D embedding would give other logits wherever
    F > 1.
    """

    def __init__(self, c2: int, c3: int, num_feat: int, num_embed: int):
        super().__init__()
        self.global_pooling_2D = nn.Sequential(Conv2d(c2, num_feat, 1, bias=False),
                                               _Fn(adaptive_max_pool2d, num_embed))
        self.global_pooling_3D = nn.Sequential(Conv3d(c3, num_feat, 1, bias=False),
                                               _Fn(adaptive_max_pool3d_hw, num_embed))

    def forward(self, feat_2d, feat_3d):
        out = on_shards(self._attend, self.global_pooling_2D(feat_2d),
                        self.global_pooling_3D(feat_3d), feat_3d)
        if isinstance(out, Shards):
            return Shards(f for f, _ in out), Shards(a for _, a in out)
        return out

    @staticmethod
    def _attend(emb_2d, emb_3d, feat_3d):
        B, D = emb_2d.shape[0], feat_3d.shape[1]
        sig2 = emb_2d.reshape(B, -1)                                    # (B, E·E·F)
        sig3 = emb_3d[0].permute(3, 1, 2, 0).reshape(-1, D)             # (F·E·E, D)
        att = torch.softmax(sig2 @ sig3 / math.sqrt(sig2.shape[-1]), dim=1)
        fused = att @ feat_3d[0].reshape(D, -1)
        return fused.reshape(B, *feat_3d.shape[2:]), att


class MultiHeadAttentionLayer(nn.Module):
    """``num_head`` attention heads and a 1×1 fuse conv (no bias) + norm +
    ReLU (lgca_net_v3.py:331-362). Returns the fused map (B, H3, W3, C3) and
    the heads' attention (B, D, heads)."""

    def __init__(self, num_head: int, c2: int, c3: int, num_feat: int,
                 num_embed: int, norm: str = "BatchNorm2d"):
        super().__init__()
        self.num_head = num_head
        for i in range(num_head):
            self.add_module(f"att_layer_{i}", AttentionLayer(c2, c3, num_feat, num_embed))
        self.conv = nn.Sequential(Conv2d(num_head * c3, c3, 1, bias=False),
                                  NORMS[norm](c3), ReLU())

    def forward(self, feat_2d, feat_3d):
        heads = [getattr(self, f"att_layer_{i}")(feat_2d, feat_3d)
                 for i in range(self.num_head)]
        x = self.conv(on_shards(_cat, *[f for f, _ in heads]))
        return x, on_shards(lambda *a: torch.stack(a, dim=-1), *[a for _, a in heads])


def _cat(*parts):
    return torch.cat(parts, dim=-1)


# --------------------------------------------------------------------------
# fused 2D U-Nets
# --------------------------------------------------------------------------

class FusedUNet(nn.Module):
    """2D U-Net with 3D-attention fusion at 4 scales (U_Net,
    lgca_net_v3.py:365-475; ``attention_gates`` → AttU_Net, :478-576).

    x (B, H, W, 1) and the features {d1..d4, glob_feat (B, H, W, 64)} →
    {'seg_2d': (B, H, W, output_ch)}. The global feature enters ``dec2``'s
    input for U_Net and is concatenated after it for AttU_Net."""

    def __init__(self, output_ch: int = 6, norm: str = "BatchNorm2d",
                 feature_scale: float = 1.0, attention_gates: bool = False):
        super().__init__()
        if norm not in NORMS:
            raise NotImplementedError(f"unet_normalize_type {norm!r}: {', '.join(NORMS)}")
        f = [int(v / feature_scale) for v in (64, 128, 256, 512, 1024)]
        g = P_NUM[3]                                    # glob_feat channels
        self.attention_gates = attention_gates
        self.Conv1 = ConvBlock(1, f[0], norm)
        for lvl, (heads, nf, ne) in enumerate(ATT_SPEC):
            self.add_module(f"self_attention{lvl + 1}", MultiHeadAttentionLayer(
                heads, f[lvl], P_NUM[lvl], nf, ne, norm))
            self.add_module(f"Conv{lvl + 2}", ConvBlock(f[lvl] + P_NUM[lvl], f[lvl + 1], norm))
        for lvl in (5, 4, 3, 2):
            fo = f[lvl - 2]
            self.add_module(f"Up{lvl}", UpConv(f[lvl - 1], fo, norm))
            if attention_gates:
                f_int = f[lvl - 3] if lvl > 2 else f[0] // 2
                self.add_module(f"Att{lvl}", AttentionBlock(fo, fo, f_int, norm))
            extra = g if lvl == 2 and not attention_gates else 0
            self.add_module(f"Up_conv{lvl}", ConvBlock(2 * fo + extra, fo, norm))
        self.Conv_1x1 = Conv2d(f[0] + (g if attention_gates else 0), output_ch, 1)

    def forward(self, x, features: Dict[str, torch.Tensor]):
        p = [features[k] for k in ("d1", "d2", "d3", "d4")]
        skips = [self.Conv1(x)]
        cur = skips[0]
        for lvl in range(4):
            cur = on_shards(max_pool2d, cur, 2, 2)
            att_out, _ = getattr(self, f"self_attention{lvl + 1}")(cur, p[lvl])
            cur = getattr(self, f"Conv{lvl + 2}")(on_shards(_cat, cur, att_out))
            skips.append(cur)

        d = skips[4]
        for lvl in (5, 4, 3, 2):
            skip = skips[lvl - 2]
            d = getattr(self, f"Up{lvl}")(d)
            if self.attention_gates:
                skip = getattr(self, f"Att{lvl}")(d, skip)
            parts = [skip, d]
            if lvl == 2 and not self.attention_gates:
                parts.append(features["glob_feat"])
            d = getattr(self, f"Up_conv{lvl}")(on_shards(_cat, *parts))
        if self.attention_gates:
            d = on_shards(_cat, d, features["glob_feat"])
        return {"seg_2d": self.Conv_1x1(d)}


class LGCANetV3(nn.Module):
    """The full model (LGCANet_V3, lgca_net_v3.py:579-658).

    forward(volume (1, D, Hv, Wv, 1), slices (B, H, W, 1)) →
    {'seg_2d': (B, H, W, K), 'dsv': (1, D, Hv, Wv, K)}. The volume enters at
    the slices' resolution divided by ``context_net_downsample_scale`` (2),
    so pyramid level d_i matches the 2D encoder level below x_i.
    ``model.train()`` puts the U-Net's batch norms in batch-statistics mode
    over all B slices (``models/blocks.BatchNorm2d``, one group).
    """

    def __init__(self, output_ch: int = 6, norm: str = "BatchNorm2d",
                 feature_scale: float = 1.0, attention_gates: bool = False):
        super().__init__()
        self.output_ch = output_ch
        self.context_net = FeatureNet(output_ch)
        self.unet = FusedUNet(output_ch, norm, feature_scale, attention_gates)

    def forward(self, volume, slices) -> Dict[str, torch.Tensor]:
        if isinstance(slices, Shards):
            return self._forward_shards(volume, slices)
        with span("lgca.context", volume.device):
            feats = self.context_net(volume)
        feats["glob_feat"] = self._glob_feat(feats["d4"], slices)
        out = self.unet(slices, feats)
        out["dsv"] = feats["dsv"]
        return out

    @staticmethod
    def _glob_feat(d4, slices):
        """AdaptiveAvgPool3d(1) of d4, broadcast to the slices' resolution
        (lgca:605-609)."""
        B, H, W, _ = slices.shape
        glob = d4.mean(dim=(1, 2, 3))                                   # (1, 64)
        return glob[:, None, None, :].expand(B, H, W, glob.shape[-1])

    def _forward_shards(self, volume, slices: Shards):
        """The forward over a sharded slice batch (module doc): the context
        net once per distinct device, the U-Net in lockstep."""
        by_device = {}
        for s in slices:
            if s.device not in by_device:
                with span("lgca.context", s.device):
                    by_device[s.device] = replica_call(
                        self.context_net, Shards([volume.to(s.device, non_blocking=True)]))[0]
        feats = {k: Shards(by_device[s.device][k] for s in slices)
                 for k in ("d1", "d2", "d3", "d4")}
        feats["glob_feat"] = Shards(self._glob_feat(by_device[s.device]["d4"], s)
                                    for s in slices)
        out = self.unet(slices, feats)
        out["dsv"] = by_device[slices[0].device]["dsv"]
        return out

    @staticmethod
    def loss(pred, target) -> Dict[str, torch.Tensor]:
        """Per-class Dice of the 2D output plus that of ``dsv``
        (lgca_net_v3.py:629-649); each (K,)."""
        p2 = pred["seg_2d"]
        K = p2.shape[-1]
        unet_dice = dice_loss_per_class(p2.reshape(-1, K), target["mask"].reshape(-1, K))
        dsv_dice = dice_loss_per_class(pred["dsv"].reshape(-1, K),
                                       target["downsampled_volume_mask"].reshape(-1, K))
        return {"unet_dice": unet_dice, "loss_dice": unet_dice + dsv_dice}
