"""Model factory (net/model.py:4-7): config → seeded, eval-mode model.

The counterpart of ``rpnet_tpu/models/factory.py``: :func:`build_rpnet` for
eval and (with ``align`` and ``num_iter``) training, :func:`build_lgcanet`
for ``net: LGCANet_V3``, both in ``model_factory``; the trainers switch the
model to training mode. Backbones ``UNet`` (with ``mask_feature_map``),
``vgg``, ``resnet`` and ``sam_vit`` (SAM's ViT image encoder, widths from
the ``sam_vit`` key, ViT-B's by default; eval only: its Linear layers are
drawn from the same generator, and ``pretrained_path`` names a SAM or
MedSAM checkpoint whose ``image_encoder.*`` loads as ``encoder.*``);
relation modes ``relation`` and ``concat``; the
U-Net's ``unet_normalize_type`` BatchNorm2d, InstanceNorm2d or GroupNorm
(the JAX ``Norm2d``'s kinds; others raise there and here). A plain dict
takes :class:`~rpnet_tpu_torch.config.Config`'s defaults, where ``scale``
is 8 for ``vgg`` (features at 1/8) and 4 otherwise, as the JAX factory's
default is.
"""

from __future__ import annotations

import torch

from rpnet_tpu_torch.config import Config
from rpnet_tpu_torch.models.blocks import init_
from rpnet_tpu_torch.models.lgca import LGCANetV3
from rpnet_tpu_torch.models.rpnet import RPNet
from rpnet_tpu_torch.models.sam_vit import encoder_state_from_sam, init_linear_

_PORTED = {"net": ("RP_Net",)}


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
        norm=config["unet_normalize_type"],
        sam_vit=config["sam_vit"],
    )
    gen = torch.Generator().manual_seed(seed)
    init_(model, gen)
    if config["backbone"] == "sam_vit":
        init_linear_(model, gen)
        if config.get("pretrained_path"):
            load_sam_encoder(model, config["pretrained_path"])
    return model.to(device).eval()


def load_sam_encoder(model: RPNet, path: str) -> None:
    """A SAM or MedSAM ``.pth`` (``{'state_dict': ...}`` or a bare state
    dict) into the ViT encoder: its ``image_encoder.*`` as ``encoder.*``;
    every encoder tensor must be covered."""
    raw = torch.load(path, map_location="cpu", weights_only=True)
    sd = encoder_state_from_sam(raw.get("state_dict", raw))
    missing = [k for k in model.state_dict() if k.startswith("encoder.") and k not in sd]
    if missing:
        raise ValueError(f"{path}: no image_encoder tensor for {len(missing)} encoder "
                         f"tensors (e.g. {missing[0]})")
    model.load_state_dict(sd, strict=False)
    print(f"[sam_vit encoder from {path}]")


def build_lgcanet(config, seed: int = 0, device="cpu") -> LGCANetV3:
    """LGCANetV3 from the flat config (reference ctor lgca_net_v3.py:580-590):
    ``len(roi_names)`` output channels, the AttU_Net gates where ``net_UNet``
    is ``AttU_Net``; initialized from ``torch.Generator(seed)`` on the CPU,
    moved to ``device``, in eval mode."""
    if not isinstance(config, Config):
        config = Config(dict(config))
    rois = config.get("roi_names") or ["roi"] * int(config.get("num_class", 6))
    model = LGCANetV3(output_ch=len(rois), norm=config["unet_normalize_type"],
                      feature_scale=float(config["feature_scale"]),
                      attention_gates=config["net_UNet"] == "AttU_Net")
    init_(model, torch.Generator().manual_seed(seed))
    return model.to(device).eval()


model_factory = {"RP_Net": build_rpnet, "LGCANet_V3": build_lgcanet}
