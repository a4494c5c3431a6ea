"""Context relation encoder (net/rp_net.py:45-84).

The counterpart of ``rpnet_tpu/models/cre.py``'s ContextCorrelationEncoder:
foreground- and background-masked feature maps go through 3×3 conv + BN +
ReLU projections (``w_k``/``w_q``), the r-local correlation ((2r+1)²
channels, ``ops/correlation.py`` — the Hopper kernels on the card, forward
and, under autograd, backward), and ONE
1×1 conv + BN + ReLU (``q``) over ``[corr, fm1]`` down to 64 features, as
upstream. The JAX package splits that conv in two by linearity; the weight
bridge (``train/convert.py``) fuses it back. Below f32 in eval (the bf16 eval
network) the port splits it as the JAX package does, so that it rounds where
that one does. The upstream ``w_context``/``out``
submodules are never called and are not built.

The backward of ``torch.cat([corr, fm1])`` hands the correlation's backward
its gradient as a strided (B, h, w, d²) view of the (B, h, w, d² + C)
gradient; the backward kernel reads it with that pixel stride, no copy.

:class:`SimpleConcat` is the ``use_relation_enc: concat`` mode
(``rpnet_tpu/models/cre.py:142-150``; upstream names it, net/rp_net.py:224,
but never defines it): the features and the mask concatenated, then one
1×1 conv + BN + ReLU down to 64. No correlation.

The correlation's forward is resolved per call, from the JAX package's
``RPNET_CORR_IMPL`` / ``RPNET_ROT_EXTRACT`` / ``RPNET_ROT_PACK`` and the
module's mode (``self.training`` where the JAX CRE takes ``train``), by
``ops.correlation.correlation_route``. Every route writes the quirk order,
so the weights are the same under every switch.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from rpnet_tpu_torch.models.blocks import conv_bn_relu
from rpnet_tpu_torch.ops.correlation import (correlation_route,
                                             local_correlation_trainable)

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
        route = correlation_route(fm1, self.radius, self.training)
        corr = local_correlation_trainable(fm1, fm2, self.radius, route)   # (B, h, w, (2r+1)²)
        if fm1.dtype.itemsize < 4 and not self.training:
            return self.q[2](self.q[1](self._q_split(corr, fm1)))
        return self.q(torch.cat([corr, fm1], dim=-1))

    def _q_split(self, corr, fm1):
        """``q``'s 1×1 conv as the JAX CRE computes it below f32: one conv
        over corr plus one over fm1 (then its bias), each result rounded."""
        conv, d2 = self.q[0], corr.shape[-1]
        w = conv.weight.to(corr.dtype)
        a = F.conv2d(corr.permute(0, 3, 1, 2), w[:, :d2]).permute(0, 2, 3, 1)
        b = F.conv2d(fm1.permute(0, 3, 1, 2), w[:, d2:]).permute(0, 2, 3, 1)
        return a + (b + conv.bias.to(fm1.dtype))


class SimpleConcat(nn.Module):
    """concat(features (B, h, w, C), mask (B, h, w, 1)) → 1×1 conv + BN +
    ReLU → (B, h, w, 64)."""

    def __init__(self, channels: int = 256):
        super().__init__()
        self.proj = nn.Sequential(*conv_bn_relu(channels + 1, NUM_FEAT, k=1))

    def forward(self, fts, mask):
        return self.proj(torch.cat([fts, mask], dim=-1))
