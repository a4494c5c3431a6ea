"""ResNet18-style encoder (net/rp_net.py:19-42).

The counterpart of ``rpnet_tpu/models/resnet.py``: torchvision resnet18's
stem (7×7/2 conv, BN, ReLU, 3×3/2 max pool, ``layer1``) and three custom
stages of BasicBlocks (64 → 128 → 256 → 512) with stride 1 and 1×1-conv
shortcuts; (B, H, W, 3) → 512 channels at 1/4 resolution. Module names are
the upstream ones, ``backbone.0`` (stem conv), ``backbone.1`` (stem BN),
``backbone.4`` (layer1), ``backbone.5``..``7`` (the custom stages), each
block's ``conv1``/``bn1``/``conv2``/``bn2``/``downsample.0``/``.1``.
"""

from __future__ import annotations

import torch
from torch import nn

from rpnet_tpu_torch.models.blocks import BatchNorm2d, Conv2d
from rpnet_tpu_torch.ops.sampling import MaxPool2d


class BasicBlock(nn.Module):
    """torchvision's BasicBlock (bias-free 3×3 convs), stride 1; with
    ``downsample`` a 1×1 conv (with bias, as the JAX package's) + BN
    shortcut."""

    def __init__(self, cin: int, cout: int, downsample: bool = False):
        super().__init__()
        self.conv1 = Conv2d(cin, cout, 3, padding=1, bias=False)
        self.bn1 = BatchNorm2d(cout)
        self.conv2 = Conv2d(cout, cout, 3, padding=1, bias=False)
        self.bn2 = BatchNorm2d(cout)
        self.downsample = (nn.Sequential(Conv2d(cin, cout, 1), BatchNorm2d(cout))
                           if downsample else None)

    def forward(self, x):
        out = torch.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        identity = x if self.downsample is None else self.downsample(x)
        return torch.relu(out + identity)


class ResNet18Encoder(nn.Module):
    """(B, H, W, 3) → (B, H/4, W/4, 512)."""

    out_channels = 512

    def __init__(self):
        super().__init__()
        stages = [nn.Sequential(BasicBlock(64, 64), BasicBlock(64, 64))]
        for cin, cout in ((64, 128), (128, 256), (256, 512)):
            stages.append(nn.Sequential(BasicBlock(cin, cout, downsample=True),
                                        BasicBlock(cout, cout)))
        self.backbone = nn.Sequential(
            Conv2d(3, 64, 7, stride=2, padding=3, bias=False), BatchNorm2d(64),
            nn.ReLU(), MaxPool2d(3, 2, 1), *stages)

    def forward(self, x, mask=None):
        return self.backbone(x)
