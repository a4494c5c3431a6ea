"""The weight bridge and ``.pth`` loading.

The port's modules carry the upstream RP-Net ``state_dict`` names
(``encoder.Conv1.conv.0``, ``encoder.Up5.up.1``, ``cre.w_k.0``, ``cre.q.0``,
...) — the names ``rpnet_tpu/train/convert.py`` parses — so a reference
checkpoint loads directly, and the JAX package's ``convert_state_dict``
inverts :func:`state_dict_from_jax`.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, List, Tuple

import numpy as np
import torch

_CONV_BLOCK = (("0", "conv1"), ("1", "norm1"), ("3", "conv2"), ("4", "norm2"))


def _module_pairs() -> Iterator[Tuple[str, Tuple[str, ...], str]]:
    """(torch module prefix, flax module path, 'conv' | 'bn') for every
    module the bridge maps one to one (the fused ``cre.q.0`` is special)."""
    blocks = [(f"Conv{i}", f"enc{i}") for i in range(1, 6)]
    blocks += [("Up_conv5", "dec5"), ("Up_conv4", "dec4")]
    for tname, jname in blocks:
        for idx, inner in _CONV_BLOCK:
            yield (f"encoder.{tname}.conv.{idx}", ("encoder", jname, inner),
                   inner[:4])
    for i in (5, 4):
        yield f"encoder.Up{i}.up.1", ("encoder", f"up{i}", "conv"), "conv"
        yield f"encoder.Up{i}.up.2", ("encoder", f"up{i}", "norm"), "norm"
    for name in ("w_k", "w_q"):
        yield f"cre.{name}.0", ("cre", f"{name}_conv"), "conv"
        yield f"cre.{name}.1", ("cre", f"{name}_norm"), "norm"
    yield "cre.q.1", ("cre", "q_norm"), "norm"


def _get(tree: Dict[str, Any], path) -> np.ndarray:
    for p in path:
        tree = tree[p]
    return np.asarray(tree, dtype=np.float32)


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def state_dict_from_jax(variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX package's ``{'params', 'batch_stats'}`` tree (numpy leaves) →
    the port's ``state_dict``: HWIO → OIHW; BN scale/bias/mean/var →
    weight/bias/running_mean/running_var; ``q_conv_corr`` + ``q_conv_fm`` →
    the fused ``cre.q.0`` weight ``[corr; fm]`` with ``q_conv_fm``'s bias."""
    params, stats = variables["params"], variables["batch_stats"]
    sd: Dict[str, torch.Tensor] = {}
    for prefix, path, kind in _module_pairs():
        if kind == "conv":
            sd[f"{prefix}.weight"] = _t(np.transpose(
                _get(params, path + ("conv", "kernel")), (3, 2, 0, 1)))
            sd[f"{prefix}.bias"] = _t(_get(params, path + ("conv", "bias")))
        else:
            sd[f"{prefix}.weight"] = _t(_get(params, path + ("bn", "scale")))
            sd[f"{prefix}.bias"] = _t(_get(params, path + ("bn", "bias")))
            sd[f"{prefix}.running_mean"] = _t(_get(stats, path + ("bn", "mean")))
            sd[f"{prefix}.running_var"] = _t(_get(stats, path + ("bn", "var")))
            sd[f"{prefix}.num_batches_tracked"] = torch.tensor(0)
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
