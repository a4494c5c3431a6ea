"""Model factory (net/model.py:4-7): config → seeded, eval-mode RPNet.

The counterpart of ``rpnet_tpu/models/factory.py::build_rpnet``, for eval
and (with ``align`` and ``num_iter``) training; the trainer switches the
model to training mode. Backbones ``UNet`` (with ``mask_feature_map``),
``vgg`` and ``resnet``; relation modes ``relation`` and ``concat``;
BatchNorm2d. A plain dict takes :class:`~rpnet_tpu_torch.config.Config`'s
defaults, where ``scale`` is 8 for ``vgg`` (features at 1/8) and 4
otherwise, as the JAX factory's default is.
"""

from __future__ import annotations

import torch

from rpnet_tpu_torch.config import Config
from rpnet_tpu_torch.models.blocks import init_
from rpnet_tpu_torch.models.rpnet import RPNet

_PORTED = {"net": ("RP_Net",), "unet_normalize_type": ("BatchNorm2d",)}


def build_rpnet(config, num_iter: int | None = None, seed: int = 0,
                device="cpu", align: bool = True) -> RPNet:
    """RPNet from the flat config (a ``Config`` or a dict), initialized from
    ``torch.Generator(seed)`` on the CPU, moved to ``device``, in eval mode."""
    if not isinstance(config, Config):
        config = Config(dict(config))   # the defaults, ``scale``'s included
    for key, ok in _PORTED.items():
        val = config.get(key, ok[0])
        if val not in ok:
            raise NotImplementedError(
                f"{key}: {val!r} is not ported to rpnet_tpu_torch yet "
                f"(ported: {', '.join(ok)})")
    model = RPNet(
        scale=config["scale"],
        num_iter=num_iter if num_iter is not None else config.get("n_iter_refinement", 4),
        radius=config.get("mask_refinement_correlation_radius", 5),
        soft_mask=bool(config.get("soft_mask", False)),
        align=align,
        backbone=config["backbone"],
        mask_feature_map=config["mask_feature_map"],
        use_relation_enc=config["use_relation_enc"],
    )
    init_(model, torch.Generator().manual_seed(seed))
    return model.to(device).eval()
