"""Training checkpoints: save and resume.

The port's form of ``rpnet_tpu/train/checkpoint.py``. A checkpoint is the
reference's torch file, ``{'epoch', 'state_dict', 'optimizer'}``
(test_rpnet.py:86-96), with the upstream ``state_dict`` names of the model
saved (RP_Net's or LGCANet_V3's) — the file the port's eval CLI loads and
the JAX package's ``restore_into`` converts. ``epoch`` counts completed epochs, so a resume starts at the next.

Restoring overlays the checkpoint's tensors onto the fresh model, keeping
fresh values where it has none, as the JAX ``overlay`` does. The optimizer
state is restored when the checkpoint carries one that fits this
optimizer; otherwise (a reference checkpoint, or none) only the schedule
position resumes, as ``fast_forward_opt_state`` does.
"""

from __future__ import annotations

import os

import torch

from rpnet_tpu_torch.train.trainer import fast_forward_optimizer


def save_checkpoint(path: str, epoch: int, model: torch.nn.Module,
                    optimizer: torch.optim.Optimizer) -> str:
    """Write ``{'epoch', 'state_dict', 'optimizer'}`` to ``path`` (CPU tensors)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    state_dict = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    torch.save({"epoch": int(epoch), "state_dict": state_dict,
                "optimizer": optimizer.state_dict()}, path)
    return path


def _fits(optimizer: torch.optim.Optimizer, saved) -> bool:
    groups = saved.get("param_groups") if isinstance(saved, dict) else None
    return (groups is not None and len(groups) == len(optimizer.param_groups)
            and all(len(s["params"]) == len(g["params"])
                    for s, g in zip(groups, optimizer.param_groups)))


def restore_checkpoint(path: str, model: torch.nn.Module,
                       optimizer: torch.optim.Optimizer,
                       steps_per_epoch: int) -> int:
    """Overlay the checkpoint at ``path`` onto ``model`` (either model
    family) and ``optimizer``; returns the epoch to start from."""
    raw = torch.load(path, map_location="cpu", weights_only=True)
    wrapped = isinstance(raw, dict) and "state_dict" in raw   # else a bare state_dict
    sd = raw["state_dict"] if wrapped else raw
    epoch = int(raw.get("epoch", 0) or 0) if wrapped else 0
    own = model.state_dict()
    matched = {k: v for k, v in sd.items() if k in own}
    if not any(not k.endswith("num_batches_tracked") for k in matched):
        raise ValueError(f"checkpoint {path}: no tensor matches the model "
                         f"(wrong checkpoint for {type(model).__name__}?)")
    for k, v in matched.items():
        if tuple(v.shape) != tuple(own[k].shape):
            raise ValueError(f"checkpoint shape mismatch at {k}: "
                             f"{tuple(v.shape)} vs model {tuple(own[k].shape)}")
    model.load_state_dict(matched, strict=False)
    saved_opt = raw.get("optimizer") if wrapped else None
    if _fits(optimizer, saved_opt):
        optimizer.load_state_dict(saved_opt)
    elif epoch > 0:
        fast_forward_optimizer(optimizer, epoch * steps_per_epoch)
    return epoch
