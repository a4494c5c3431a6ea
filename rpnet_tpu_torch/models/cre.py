"""Context relation encoder (net/rp_net.py:45-84).

The counterpart of ``rpnet_tpu/models/cre.py``'s ContextCorrelationEncoder:
foreground- and background-masked feature maps go through 3×3 conv + BN +
ReLU projections (``w_k``/``w_q``), the r-local correlation ((2r+1)²
channels, ``ops/correlation.py`` — the Hopper kernels on the card, forward
and, under autograd, backward), and ONE
1×1 conv + BN + ReLU (``q``) over ``[corr, fm1]`` down to 64 features, as
upstream. The JAX package splits that conv in two by linearity; the weight
bridge (``train/convert.py``) fuses it back. The upstream ``w_context``/``out``
submodules are never called and are not built.

The backward of ``torch.cat([corr, fm1])`` hands the correlation's backward
its gradient as a strided (B, h, w, d²) view of the (B, h, w, d² + C)
gradient; the backward kernel reads it with that pixel stride, no copy.
"""

from __future__ import annotations

import torch
from torch import nn

from rpnet_tpu_torch.models.blocks import conv_bn_relu
from rpnet_tpu_torch.ops.correlation import local_correlation_trainable

NUM_FEAT = 64


class ContextCorrelationEncoder(nn.Module):

    def __init__(self, channels: int = 256, radius: int = 5):
        super().__init__()
        self.radius = radius
        d2 = (2 * radius + 1) ** 2
        self.w_k = nn.Sequential(*conv_bn_relu(channels, channels))
        self.w_q = nn.Sequential(*conv_bn_relu(channels, channels))
        self.q = nn.Sequential(*conv_bn_relu(d2 + channels, NUM_FEAT, k=1))

    def forward(self, fm1, fm2):
        """fm1 = fg-masked, fm2 = bg-masked features, (B, h, w, C) each."""
        fm1 = self.w_k(fm1).contiguous()   # no-op when cuDNN kept channels-last
        fm2 = self.w_q(fm2).contiguous()
        corr = local_correlation_trainable(fm1, fm2, self.radius)   # (B, h, w, (2r+1)²)
        return self.q(torch.cat([corr, fm1], dim=-1))
