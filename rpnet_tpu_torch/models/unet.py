"""U-Net encoder with 2-level decoder (net/unet.py:393-466).

The counterpart of ``rpnet_tpu/models/unet.py``: a 5-level encoder
(64→1024 channels, maxpool 2×2) and two decoder stages; the output is the
'd4' feature map at 1/4 resolution with 256 channels. Module names are the
upstream U_Net's (``Conv1``..``Conv5``, ``Up5``, ``Up_conv5``, ``Up4``,
``Up_conv4``). Only ``mask_feature_map: no`` is ported. ``model.train()``
puts its batch norms in the JAX package's batch-statistics mode
(``models/blocks.BatchNorm2d``).
"""

from __future__ import annotations

import torch
from torch import nn

from rpnet_tpu_torch.models.blocks import ConvBlock, UpConv
from rpnet_tpu_torch.ops.sampling import max_pool2d

FEATS = (64, 128, 256, 512, 1024)


class UNet(nn.Module):
    """(B, H, W, C_in) → 'd4' features (B, H/4, W/4, 256)."""

    def __init__(self, in_ch: int = 1):
        super().__init__()
        f = FEATS
        self.Conv1 = ConvBlock(in_ch, f[0])
        self.Conv2 = ConvBlock(f[0], f[1])
        self.Conv3 = ConvBlock(f[1], f[2])
        self.Conv4 = ConvBlock(f[2], f[3])
        self.Conv5 = ConvBlock(f[3], f[4])
        self.Up5 = UpConv(f[4], f[3])
        self.Up_conv5 = ConvBlock(f[4], f[3])
        self.Up4 = UpConv(f[3], f[2])
        self.Up_conv4 = ConvBlock(f[3], f[2])

    def forward(self, x):
        x1 = self.Conv1(x)
        x2 = self.Conv2(max_pool2d(x1, 2, 2))
        x3 = self.Conv3(max_pool2d(x2, 2, 2))
        x4 = self.Conv4(max_pool2d(x3, 2, 2))
        x5 = self.Conv5(max_pool2d(x4, 2, 2))
        d5 = self.Up_conv5(torch.cat([x4, self.Up5(x5)], dim=-1))
        return self.Up_conv4(torch.cat([x3, self.Up4(d5)], dim=-1))
