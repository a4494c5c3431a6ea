"""NN building blocks on channels-last tensors (net/modules.py).

The port keeps the JAX package's (N, H, W, C) layout at every module
boundary. Convolutions and batch norms view their input as NCHW with
``x.permute(0, 3, 1, 2)``, which for a contiguous NHWC tensor is a
``torch.channels_last`` NCHW tensor: cuDNN runs on it without a copy and
returns channels-last output, which the inverse permute turns back into a
contiguous NHWC tensor. Parameters keep torch's OIHW layout and the upstream
RP-Net ``state_dict`` names (``conv.0``, ``conv.1``, ``up.1``, ...).

BatchNorm in training mode follows the JAX package (flax ``nn.BatchNorm``
under the trainer's episode vmap), not ``torch.nn.BatchNorm2d``: batch
statistics are taken per episode (``groups`` leading blocks of the batch
axis), the running variance takes the biased batch variance, and the new
running statistics are the mean over episodes of the per-episode updates.

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
    """``nn.BatchNorm2d`` (eps 1e-5, momentum 0.1) on (N, H, W, C) tensors.

    In training mode the batch axis holds ``groups`` episodes, episode-major,
    and each episode is normalized with its own statistics, as flax's
    ``nn.BatchNorm(use_running_average=False, momentum=0.9)`` normalizes one
    vmapped episode (``rpnet_tpu/models/blocks.py:62-74``): biased variance
    in f32, ``y = x · scale/√(var+eps) + (bias − mean · scale/√(var+eps))``.
    The running statistics move by ``momentum`` toward the episodes' mean
    batch statistics; since the update is linear, that equals the JAX
    trainer's mean over episodes of the per-episode updates
    (``rpnet_tpu/train/trainer.py:198-203``).
    """

    groups = 1   # episodes in the batch axis (set by RPNet's training forward)

    def forward(self, x):
        if not self.training:
            return super().forward(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        N, H, W, C = x.shape
        xg = x.reshape(self.groups, -1, C)
        stat_dtype = torch.promote_types(x.dtype, torch.float32)
        var, mean = torch.var_mean(xg.to(stat_dtype), dim=1, correction=0)   # (E, C)
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1 - m).add_(mean.mean(0), alpha=m)
            self.running_var.mul_(1 - m).add_(var.mean(0), alpha=m)
            self.num_batches_tracked += 1
        mul = self.weight * torch.rsqrt(var + self.eps)                # (E, C)
        shift = self.bias - mean * mul
        y = xg * mul[:, None].to(x.dtype) + shift[:, None].to(x.dtype)
        return y.reshape(N, H, W, C)


def set_episode_groups(module: nn.Module, groups: int) -> None:
    """Tell every BatchNorm2d under ``module`` that the batch axis holds
    ``groups`` episodes (training mode)."""
    for m in module.modules():
        if isinstance(m, BatchNorm2d):
            m.groups = groups


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
