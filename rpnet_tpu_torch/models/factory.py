"""Model factory (net/model.py:4-7): config → seeded, eval-mode RPNet.

The counterpart of ``rpnet_tpu/models/factory.py::build_rpnet``, for eval
and (with ``align`` and ``num_iter``) training; the trainer switches the
model to training mode. Only the configuration of the main paths is ported:
the U-Net backbone with ``mask_feature_map: no``, the ``relation`` encoder,
BatchNorm2d.
"""

from __future__ import annotations

import torch

from rpnet_tpu_torch.models.blocks import init_
from rpnet_tpu_torch.models.rpnet import RPNet

_PORTED = {"net": ("RP_Net",), "backbone": ("UNet",), "mask_feature_map": ("no",),
           "use_relation_enc": ("relation",),
           "unet_normalize_type": ("BatchNorm2d",)}


def build_rpnet(config, num_iter: int | None = None, seed: int = 0,
                device="cpu", align: bool = True) -> RPNet:
    """RPNet from the flat config (a ``Config`` or a dict), initialized from
    ``torch.Generator(seed)`` on the CPU, moved to ``device``, in eval mode."""
    for key, ok in _PORTED.items():
        # YAML reads a bare `no` as False
        val = config.get(key, ok[0])
        val = "no" if val is False else val
        if val not in ok:
            raise NotImplementedError(
                f"{key}: {val!r} is not ported to rpnet_tpu_torch yet "
                f"(ported: {', '.join(ok)})")
    model = RPNet(
        scale=config.get("scale", 4),
        num_iter=num_iter if num_iter is not None else config.get("n_iter_refinement", 4),
        radius=config.get("mask_refinement_correlation_radius", 5),
        soft_mask=bool(config.get("soft_mask", False)),
        align=align,
    )
    init_(model, torch.Generator().manual_seed(seed))
    return model.to(device).eval()
