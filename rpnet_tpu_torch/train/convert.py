"""The weight bridge and ``.pth`` loading.

The port's modules carry the upstream RP-Net ``state_dict`` names
(``encoder.Conv1.conv.0``, ``encoder.Up5.up.1``, VGG's
``encoder.features.i.j``, ResNet's ``encoder.backbone.*``, ``cre.w_k.0``,
``cre.q.0``, ...) — the names ``rpnet_tpu/train/convert.py`` parses — so a
reference checkpoint loads directly, and the JAX package's
``convert_state_dict`` inverts :func:`state_dict_from_jax`. The ``concat``
mode's ``sim_cat.proj.0``/``.1`` (conv, BN) have no upstream names (upstream
never defines the module) and the JAX converter does not map them; the
bridge carries them from the JAX tree's ``sim_cat`` all the same. A
mask-injected U-Net's widened first conv of its level keeps its name.

The U-Net's ``unet_normalize_type`` norms sit in the batch norm's slot: a
GroupNorm's flax ``gn`` scale and bias become that slot's ``weight`` and
``bias`` (no running statistics), an InstanceNorm2d has no tensors. The
JAX ``convert_state_dict`` maps batch norms only, and the port adds no
``.pth`` mapping of its own for GroupNorm.

LGCANet_V3 has its own name space (``context_net.*``, ``unet.*``):
:func:`lgca_state_dict_from_jax` is the exact inverse of the JAX package's
``convert_lgca_state_dict`` (``rpnet_tpu/train/convert.py:273-314``) — 2D
kernels HWIO → OIHW, 3D kernels DHWIO → OIDHW, batch norms as above — and
:func:`load_into` loads an upstream LGCA ``.pth``, skipping and returning
its dead keys (``context_net.forw4.*``, the attention ``w_q``/``w_k``), as
that converter reports them in ``_unmatched_keys``.

:func:`convert_torchvision_vgg16` is the ``pretrained_path`` warm start of
the VGG backbone (``rpnet_tpu/train/convert.py:327-355``).
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, List, Tuple

import numpy as np
import torch

_CONV_BLOCK = (("0", "conv1"), ("1", "norm1"), ("3", "conv2"), ("4", "norm2"))
_VGG_STAGES = (2, 2, 3, 3, 3)                   # convs in stage 1..5
_RESNET_INNER = (("conv1", "conv1", "conv"), ("bn1", "bn1", "norm"),
                 ("conv2", "conv2", "conv"), ("bn2", "bn2", "norm"),
                 ("downsample.0", "down_conv", "conv"), ("downsample.1", "down_bn", "norm"))


def _encoder_pairs(encoder: Dict[str, Any]) -> Iterator[Tuple[str, Tuple[str, ...], str]]:
    """The encoder's pairs; which backbone from the JAX tree's module names."""
    if "enc1" in encoder:                       # U-Net
        blocks = [(f"Conv{i}", f"enc{i}") for i in range(1, 6)]
        blocks += [("Up_conv5", "dec5"), ("Up_conv4", "dec4")]
        for tname, jname in blocks:
            for idx, inner in _CONV_BLOCK:
                yield (f"encoder.{tname}.conv.{idx}", ("encoder", jname, inner),
                       inner[:4])
        for i in (5, 4):
            yield f"encoder.Up{i}.up.1", ("encoder", f"up{i}", "conv"), "conv"
            yield f"encoder.Up{i}.up.2", ("encoder", f"up{i}", "norm"), "norm"
    elif "stage1_conv1" in encoder:             # VGG: features.{2s}.{2j}
        for s, n in enumerate(_VGG_STAGES):
            for j in range(n):
                yield (f"encoder.features.{2 * s}.{2 * j}",
                       ("encoder", f"stage{s + 1}_conv{j + 1}"), "conv")
    elif "stem_conv" in encoder:                # ResNet: backbone.*
        yield "encoder.backbone.0", ("encoder", "stem_conv"), "conv"
        yield "encoder.backbone.1", ("encoder", "stem_bn"), "norm"
        stages = [(4, "layer1")] + [(i + 3, f"stage{i}") for i in (2, 3, 4)]
        for idx, jname in stages:
            for b in (0, 1):
                for tinner, jinner, kind in _RESNET_INNER:
                    if jinner in encoder[f"{jname}_{b}"]:
                        yield (f"encoder.backbone.{idx}.{b}.{tinner}",
                               ("encoder", f"{jname}_{b}", jinner), kind)
    else:
        raise ValueError(f"unknown encoder modules {sorted(encoder)[:4]}")


def _module_pairs(params: Dict[str, Any]) -> Iterator[Tuple[str, Tuple[str, ...], str]]:
    """(torch module prefix, flax module path, 'conv' | 'norm') for every
    module of the tree that the bridge maps one to one (the fused
    ``cre.q.0`` is special)."""
    if "encoder" in params:
        yield from _encoder_pairs(params["encoder"])
    if "sim_cat" in params:
        yield "sim_cat.proj.0", ("sim_cat", "proj_conv"), "conv"
        yield "sim_cat.proj.1", ("sim_cat", "proj_norm"), "norm"
    if "cre" not in params:
        return
    for name in ("w_k", "w_q"):
        yield f"cre.{name}.0", ("cre", f"{name}_conv"), "conv"
        yield f"cre.{name}.1", ("cre", f"{name}_norm"), "norm"
    yield "cre.q.1", ("cre", "q_norm"), "norm"


def _lgca_pairs(params: Dict[str, Any]) -> Iterator[Tuple[str, Tuple[str, ...], str]]:
    """(torch module prefix, flax path of the parameter dict, 'conv' |
    'norm') for every LGCANet_V3 module with tensors: the inverse of
    ``_lgca_module_path`` (``rpnet_tpu/train/convert.py:195-270``). A conv
    path ends where its ``kernel`` sits; a norm path at the norm module."""
    ctx, unet = params["context_net"], params["unet"]
    yield "context_net.preBlock.0", ("context_net", "pre_conv1"), "conv"
    yield "context_net.preBlock.3", ("context_net", "pre_conv2"), "conv"
    for stage, n in ((1, 2), (2, 2), (3, 3)):
        for i in range(n):
            block = f"forw{stage}_{i}"
            for tname, jname in (("conv1", "conv1"), ("conv2", "conv2"),
                                 ("shortcut.0", "shortcut")):
                if jname in ctx[block]:
                    yield (f"context_net.forw{stage}.{i}.{tname}",
                           ("context_net", block, jname), "conv")
    yield "context_net.dsv.1", ("context_net", "dsv_conv"), "conv"
    for i in range(1, 6):
        for idx, inner in _CONV_BLOCK:
            yield f"unet.Conv{i}.conv.{idx}", ("unet", f"enc{i}", inner) + (
                ("conv",) if inner.startswith("conv") else ()), inner[:4]
    for i in range(2, 6):
        yield f"unet.Up{i}.up.1", ("unet", f"up{i}", "conv", "conv"), "conv"
        yield f"unet.Up{i}.up.2", ("unet", f"up{i}", "norm"), "norm"
        for idx, inner in _CONV_BLOCK:
            yield f"unet.Up_conv{i}.conv.{idx}", ("unet", f"dec{i}", inner) + (
                ("conv",) if inner.startswith("conv") else ()), inner[:4]
        if f"att{i}" in unet:
            for tname in ("W_g", "W_x", "psi"):
                jname = tname.lower()
                yield f"unet.Att{i}.{tname}.0", ("unet", f"att{i}", jname, "conv"), "conv"
                yield f"unet.Att{i}.{tname}.1", ("unet", f"att{i}", f"{jname}_norm"), "norm"
    for n in range(1, 5):
        sa = f"self_attention{n}"
        heads = sorted(k for k in unet[sa] if k.startswith("att_layer_"))
        for head in heads:
            for dim in ("2D", "3D"):
                yield (f"unet.{sa}.{head}.global_pooling_{dim}.0",
                       ("unet", sa, head, f"pool{dim.lower()}_conv"), "conv")
        yield f"unet.{sa}.conv.0", ("unet", sa, "fuse_conv", "conv"), "conv"
        yield f"unet.{sa}.conv.1", ("unet", sa, "fuse_norm"), "norm"
    yield "unet.Conv_1x1", ("unet", "final_conv", "conv"), "conv"


def _sub(tree: Dict[str, Any], path) -> Any:
    for p in path:
        tree = tree[p]
    return tree


def _get(tree: Dict[str, Any], path) -> np.ndarray:
    return np.asarray(_sub(tree, path), dtype=np.float32)


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _norm_tensors(prefix: str, params, stats, path) -> Dict[str, torch.Tensor]:
    """A norm module's tensors: a batch norm's four and its
    ``num_batches_tracked``, a GroupNorm's scale and bias, none for an
    InstanceNorm2d (no parameters, so no entry in the tree)."""
    norm = _sub(params, path[:-1]).get(path[-1], {})
    if "gn" in norm:
        return {f"{prefix}.weight": _t(_get(params, path + ("gn", "scale"))),
                f"{prefix}.bias": _t(_get(params, path + ("gn", "bias")))}
    if "bn" in norm:
        return {f"{prefix}.weight": _t(_get(params, path + ("bn", "scale"))),
                f"{prefix}.bias": _t(_get(params, path + ("bn", "bias"))),
                f"{prefix}.running_mean": _t(_get(stats, path + ("bn", "mean"))),
                f"{prefix}.running_var": _t(_get(stats, path + ("bn", "var"))),
                f"{prefix}.num_batches_tracked": torch.tensor(0)}
    return {}


def state_dict_from_jax(variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX package's ``{'params', 'batch_stats'}`` tree (numpy leaves) →
    the port's ``state_dict``: HWIO → OIHW; BN scale/bias/mean/var →
    weight/bias/running_mean/running_var; ``q_conv_corr`` + ``q_conv_fm`` →
    the fused ``cre.q.0`` weight ``[corr; fm]`` with ``q_conv_fm``'s bias."""
    params, stats = variables["params"], variables["batch_stats"]
    sd: Dict[str, torch.Tensor] = {}
    for prefix, path, kind in _module_pairs(params):
        if kind == "conv":
            sd[f"{prefix}.weight"] = _t(np.transpose(
                _get(params, path + ("conv", "kernel")), (3, 2, 0, 1)))
            if "bias" in _sub(params, path + ("conv",)):   # ResNet's are bias-free
                sd[f"{prefix}.bias"] = _t(_get(params, path + ("conv", "bias")))
        else:
            sd.update(_norm_tensors(prefix, params, stats, path))
    if "cre" not in params:
        return sd
    corr = _get(params, ("cre", "q_conv_corr", "conv", "kernel"))
    fm = _get(params, ("cre", "q_conv_fm", "conv", "kernel"))
    sd["cre.q.0.weight"] = _t(np.transpose(np.concatenate([corr, fm], axis=2),
                                           (3, 2, 0, 1)))
    sd["cre.q.0.bias"] = _t(_get(params, ("cre", "q_conv_fm", "conv", "bias")))
    return sd


def lgca_state_dict_from_jax(variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX LGCANetV3's ``{'params', 'batch_stats'}`` tree (numpy leaves)
    → the port's ``state_dict`` with the upstream names: kernels (kh, kw, I,
    O) or (kd, kh, kw, I, O) → (O, I, kh, kw) or (O, I, kd, kh, kw); biases
    where the conv has one; a norm's tensors as :func:`state_dict_from_jax`
    carries them."""
    params, stats = variables["params"], variables["batch_stats"]
    sd: Dict[str, torch.Tensor] = {}
    for prefix, path, kind in _lgca_pairs(params):
        if kind == "conv":
            k = _get(params, path + ("kernel",))
            sd[f"{prefix}.weight"] = _t(np.transpose(k, (k.ndim - 1, k.ndim - 2)
                                                     + tuple(range(k.ndim - 2))))
            if "bias" in _sub(params, path):
                sd[f"{prefix}.bias"] = _t(_get(params, path + ("bias",)))
        else:
            sd.update(_norm_tensors(prefix, params, stats, path))
    return sd


def convert_torchvision_vgg16(state_dict: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A torchvision VGG16 ``state_dict`` (``features.N.weight`` / ``.bias``)
    → the VGG encoder's convolutions (``encoder.features.{2s}.{2j}``), as
    the reference's positional 26-tensor partial load (net/vgg.py:65-74):
    the first 13 conv (weight, bias) pairs in ``features`` index order fill
    the five stages in order. The counterpart of the JAX package's
    ``convert_torchvision_vgg16`` (``rpnet_tpu/train/convert.py:327-355``),
    which returns the same tensors as a flax tree."""
    def index(key):
        return int(key.split(".")[1]) if key.startswith("features.") else 10 ** 6

    convs = [(state_dict[k], state_dict[k[:-len(".weight")] + ".bias"])
             for k in sorted(state_dict, key=index)
             if k.startswith("features.") and k.endswith(".weight")
             and k[:-len(".weight")] + ".bias" in state_dict]
    targets = [f"encoder.features.{2 * s}.{2 * j}"
               for s, n in enumerate(_VGG_STAGES) for j in range(n)]
    sd: Dict[str, torch.Tensor] = {}
    for name, (w, b) in zip(targets, convs):
        sd[f"{name}.weight"] = torch.as_tensor(w, dtype=torch.float32)
        sd[f"{name}.bias"] = torch.as_tensor(b, dtype=torch.float32)
    return sd


def load_torch_checkpoint(path: str) -> Dict[str, Any]:
    """A ``.pth`` checkpoint, ``{'state_dict': ...}`` (optionally with
    ``epoch``) or a bare state_dict → ``{'epoch', 'state_dict'}``."""
    raw = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(raw, dict) and "state_dict" in raw:
        return {"epoch": int(raw.get("epoch", 0) or 0), "state_dict": raw["state_dict"]}
    return {"epoch": 0, "state_dict": raw}


def load_into(model: torch.nn.Module, state_dict: Dict[str, Any]) -> List[str]:
    """Load ``state_dict`` into ``model``. Every model tensor must be covered
    (``num_batches_tracked`` excepted); keys the model does not have — the
    upstream decoder stages past d4 and the CRE's unused ``w_context``/``out``
    of RP_Net, LGCANet_V3's ``forw4`` and attention ``w_q``/``w_k`` — are
    skipped and returned."""
    own = model.state_dict()
    missing = [k for k in own if k not in state_dict
               and not k.endswith("num_batches_tracked")]
    if missing:
        raise ValueError(f"checkpoint does not cover {len(missing)} model "
                         f"tensors (e.g. {missing[0]})")
    extra = [k for k in state_dict if k not in own]
    model.load_state_dict({k: v for k, v in state_dict.items() if k in own},
                          strict=False)
    return extra
