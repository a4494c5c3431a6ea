"""NN building blocks on channels-last tensors (net/modules.py).

The port keeps the JAX package's (N, H, W, C) layout at every module
boundary. Convolutions and batch norms view their input as NCHW with
``x.permute(0, 3, 1, 2)``, which for a contiguous NHWC tensor is a
``torch.channels_last`` NCHW tensor: cuDNN runs on it without a copy and
returns channels-last output, which the inverse permute turns back into a
contiguous NHWC tensor. Parameters keep torch's OIHW layout and the upstream
RP-Net ``state_dict`` names (``conv.0``, ``conv.1``, ``up.1``, ...).

Initialization: torch's own defaults (Conv2d kaiming_uniform(a=√5), bias
U(±1/√fan_in); BatchNorm2d ones/zeros, running stats 0/1), the same
distributions as the JAX package's, drawn from an explicit
``torch.Generator`` by :func:`init_`.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from rpnet_tpu_torch.ops.sampling import upsample_nearest2x


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` on (N, H, W, C) tensors."""

    def forward(self, x):
        return super().forward(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` (eps 1e-5, momentum 0.1) on (N, H, W, C) tensors."""

    def forward(self, x):
        return super().forward(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class UpsampleNearest2x(nn.Module):
    """``nn.Upsample(scale_factor=2)`` on (N, H, W, C) tensors."""

    def forward(self, x):
        return upsample_nearest2x(x)


def conv_bn_relu(cin: int, cout: int, k: int = 3) -> list:
    """[conv k×k "SAME", BatchNorm2d, ReLU] — the upstream Sequential pieces."""
    return [Conv2d(cin, cout, k, padding=k // 2), BatchNorm2d(cout), nn.ReLU()]


class ConvBlock(nn.Module):
    """conv3x3+BN+ReLU ×2 (conv_block, net/modules.py:42-58)."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = nn.Sequential(*conv_bn_relu(cin, cout),
                                  *conv_bn_relu(cout, cout))

    def forward(self, x):
        return self.conv(x)


class UpConv(nn.Module):
    """nearest ×2 upsample + conv3x3 + BN + ReLU (up_conv, net/modules.py:61-75)."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.up = nn.Sequential(UpsampleNearest2x(), *conv_bn_relu(cin, cout))

    def forward(self, x):
        return self.up(x)


@torch.no_grad()
def init_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Re-draw every conv's parameters with torch's default init from
    ``generator`` (reset_parameters draws from the global RNG)."""
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            nn.init.kaiming_uniform_(m.weight, a=math.sqrt(5), generator=generator)
            if m.bias is not None:
                fan_in = m.weight.shape[1] * m.weight.shape[2] * m.weight.shape[3]
                bound = 1.0 / math.sqrt(fan_in)
                nn.init.uniform_(m.bias, -bound, bound, generator=generator)
    return module
