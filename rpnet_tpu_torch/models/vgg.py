"""VGG16 few-shot encoder (net/vgg.py:8-74).

The counterpart of ``rpnet_tpu/models/vgg.py``: five conv stages, a 3×3
max pool of stride 2 (padding 1) after each of the first three, one of
stride 1 after the fourth, the fifth dilated ×2 and without its last ReLU;
(B, H, W, 3) → 512 channels at 1/8 resolution. Module names are the
upstream ones, ``features.i.j`` (stage i at 0, 2, 4, 6, 8 between the
pools, conv j at 0, 2, 4 between the ReLUs), the names the JAX package's
``convert_state_dict`` parses. Convolutions draw kaiming-normal (ReLU gain)
weights, as the reference's ``_init_weights`` (net/vgg.py:60-63).
"""

from __future__ import annotations

from torch import nn

from rpnet_tpu_torch.models.blocks import Conv2d
from rpnet_tpu_torch.ops.sampling import MaxPool2d

STAGES = ((2, 64), (2, 128), (3, 256), (3, 512), (3, 512))   # (convs, channels)


class KaimingConv2d(Conv2d):
    """A :class:`Conv2d` that ``blocks.init_`` draws kaiming-normal (fan_in,
    ReLU gain) instead of torch's default."""
    kaiming_normal = True


def _stage(cin: int, n_convs: int, cout: int, dilation: int = 1,
           last_relu: bool = True) -> nn.Sequential:
    layers = []
    for i in range(n_convs):
        layers.append(KaimingConv2d(cin if i == 0 else cout, cout, 3,
                                    padding=dilation, dilation=dilation))
        if i != n_convs - 1 or last_relu:
            layers.append(nn.ReLU())
    return nn.Sequential(*layers)


class VGGEncoder(nn.Module):
    """(B, H, W, 3) → (B, H/8, W/8, 512)."""

    out_channels = 512

    def __init__(self):
        super().__init__()
        layers, cin = [], 3
        for i, (n, c) in enumerate(STAGES):
            last = i == len(STAGES) - 1
            layers.append(_stage(cin, n, c, dilation=2 if last else 1,
                                 last_relu=not last))
            if i < 3:
                layers.append(MaxPool2d(3, 2, 1))
            elif i == 3:
                layers.append(MaxPool2d(3, 1, 1))
            cin = c
        self.features = nn.Sequential(*layers)

    def forward(self, x, mask=None):
        return self.features(x)
