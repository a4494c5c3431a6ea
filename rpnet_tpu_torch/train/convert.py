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


def _sub(tree: Dict[str, Any], path) -> Any:
    for p in path:
        tree = tree[p]
    return tree


def _get(tree: Dict[str, Any], path) -> np.ndarray:
    return np.asarray(_sub(tree, path), dtype=np.float32)


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


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
            sd[f"{prefix}.weight"] = _t(_get(params, path + ("bn", "scale")))
            sd[f"{prefix}.bias"] = _t(_get(params, path + ("bn", "bias")))
            sd[f"{prefix}.running_mean"] = _t(_get(stats, path + ("bn", "mean")))
            sd[f"{prefix}.running_var"] = _t(_get(stats, path + ("bn", "var")))
            sd[f"{prefix}.num_batches_tracked"] = torch.tensor(0)
    if "cre" not in params:
        return sd
    corr = _get(params, ("cre", "q_conv_corr", "conv", "kernel"))
    fm = _get(params, ("cre", "q_conv_fm", "conv", "kernel"))
    sd["cre.q.0.weight"] = _t(np.transpose(np.concatenate([corr, fm], axis=2),
                                           (3, 2, 0, 1)))
    sd["cre.q.0.bias"] = _t(_get(params, ("cre", "q_conv_fm", "conv", "bias")))
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
    — are skipped and returned."""
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
