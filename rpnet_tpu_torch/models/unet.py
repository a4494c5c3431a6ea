"""U-Net encoder with 2-level decoder (net/unet.py:393-466).

The counterpart of ``rpnet_tpu/models/unet.py``: a 5-level encoder
(64→1024 channels, maxpool 2×2) and two decoder stages; the output is the
'd4' feature map at 1/4 resolution with 256 channels. Module names are the
upstream U_Net's (``Conv1``..``Conv5``, ``Up5``, ``Up_conv5``, ``Up4``,
``Up_conv4``). ``mask_feature_map`` injects the mask as one more input
channel of a level's first conv (net/unet.py:401-424, :435-450): ``x`` the
full-resolution mask before ``Conv1``, ``x2``/``x3``/``x5`` the mask
avg-pooled to that level before ``Conv2``/``Conv3``/``Conv5``; any other
value injects nothing (the JAX module names ``x4`` but injects nothing
there). ``norm`` is ``unet_normalize_type`` (``models/blocks.NORMS``).
``model.train()`` puts its batch norms in the JAX package's
batch-statistics mode (``models/blocks.BatchNorm2d``).
"""

from __future__ import annotations

import torch
from torch import nn

from rpnet_tpu_torch.models.blocks import ConvBlock, UpConv
from rpnet_tpu_torch.ops.sampling import avg_pool2d, max_pool2d

FEATS = (64, 128, 256, 512, 1024)
# mask_feature_map → (level, the mask's pooling factor there)
MASK_LEVELS = {"x": (1, 1), "x2": (2, 2), "x3": (3, 4), "x5": (5, 16)}


class UNet(nn.Module):
    """(B, H, W, C_in) and, with mask injection, a (B, H, W, 1) mask →
    'd4' features (B, H/4, W/4, 256)."""

    out_channels = FEATS[2]

    def __init__(self, in_ch: int = 1, mask_feature_map="no", norm: str = "BatchNorm2d"):
        super().__init__()
        f = FEATS
        self.mask_level, self.mask_pool = MASK_LEVELS.get(mask_feature_map, (0, 1))
        cin = [in_ch, f[0], f[1], f[2], f[3]]
        if self.mask_level:
            cin[self.mask_level - 1] += 1
        self.Conv1 = ConvBlock(cin[0], f[0], norm)
        self.Conv2 = ConvBlock(cin[1], f[1], norm)
        self.Conv3 = ConvBlock(cin[2], f[2], norm)
        self.Conv4 = ConvBlock(cin[3], f[3], norm)
        self.Conv5 = ConvBlock(cin[4], f[4], norm)
        self.Up5 = UpConv(f[4], f[3], norm)
        self.Up_conv5 = ConvBlock(f[4], f[3], norm)
        self.Up4 = UpConv(f[3], f[2], norm)
        self.Up_conv4 = ConvBlock(f[3], f[2], norm)

    def forward(self, x, mask=None):
        def level(i, a):
            if i == self.mask_level:
                m = mask if self.mask_pool == 1 else avg_pool2d(mask, self.mask_pool)
                a = torch.cat([a, m], dim=-1)
            return a

        x1 = self.Conv1(level(1, x))
        x2 = self.Conv2(level(2, max_pool2d(x1, 2, 2)))
        x3 = self.Conv3(level(3, max_pool2d(x2, 2, 2)))
        x4 = self.Conv4(max_pool2d(x3, 2, 2))
        x5 = self.Conv5(level(5, max_pool2d(x4, 2, 2)))
        d5 = self.Up_conv5(torch.cat([x4, self.Up5(x5)], dim=-1))
        return self.Up_conv4(torch.cat([x3, self.Up4(d5)], dim=-1))
