"""LGCANet_V3 training step and whole-volume eval.

The counterpart of ``rpnet_tpu/train/lgca.py`` on one device (its
``sharded_lgca_train_step`` and ``evaluate_lgca_volume(mesh=...)`` over a
mesh of several devices are not ported: in-process multi-device sharding is
ROADMAP.md queue 1 item 8's open remainder). One train step: the 3D
context net over the downsampled volume and the fused 2D U-Net over a slice
batch in training mode (batch norm statistics over all the step's slices),
the per-class 2D + 3D Dice loss
(lgca_net_v3.py:629-649) averaged over classes, and the YAML's optimizer
(``train/trainer.make_optimizer``, AdamW with the step-decay schedule).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from rpnet_tpu_torch.models.factory import build_lgcanet
from rpnet_tpu_torch.models.lgca import LGCANetV3
from rpnet_tpu_torch.train.trainer import make_optimizer


def init_lgca(config, seed: int = 0, device="cpu", steps_per_epoch: int = 1):
    """(model, optimizer, state) for training: the seeded LGCANetV3 on
    ``device`` and the YAML's optimizer over its parameters, ``state`` =
    ``{"step": 0}``. The JAX ``init_lgca_state`` traces the model at the
    sampler's static shapes to create its parameters; torch modules have
    theirs from construction."""
    model = build_lgcanet(config, seed=seed, device=device)
    return model, make_optimizer(model.parameters(), config, steps_per_epoch), {"step": 0}


def make_lgca_train_step(model: LGCANetV3, optimizer: torch.optim.Optimizer):
    """``step(state, batch) → metrics`` (``rpnet_tpu/train/lgca.py:25-48``).

    ``batch`` is (volume (1, D, Hv, Wv, 1), slices (B, H, W, 1), mask
    (B, H, W, K), downsampled volume mask (1, D, Hv, Wv, K)) on the model's
    device; ``state["step"]`` (updates done) picks the learning rate and is
    advanced in place. Metrics are 0-d tensors on the device: ``loss`` and
    ``unet_dice`` (its 2D part), each the mean over classes."""

    def train_step(state: Dict, batch) -> Dict[str, torch.Tensor]:
        volume, slices, mask, vmask = batch
        model.train()
        out = model(volume, slices)
        losses = LGCANetV3.loss(out, {"mask": mask, "downsampled_volume_mask": vmask})
        loss = losses["loss_dice"].mean()
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        for group in optimizer.param_groups:
            group["lr"] = optimizer.schedule(state["step"])
        optimizer.step()
        state["step"] += 1
        return {"loss": loss.detach(), "unet_dice": losses["unet_dice"].mean().detach()}

    return train_step


@torch.no_grad()
def evaluate_lgca_volume(model: LGCANetV3, sample: Dict[str, np.ndarray], device,
                         chunk: int = 16) -> Dict[str, Optional[float]]:
    """Whole-volume eval (``rpnet_tpu/train/lgca.py:117-165``): every
    z-slice in chunks of ``chunk`` (the last one zero-padded), each through
    one eval forward of the whole model, context net included; sigmoid >
    0.5 on the predictions cut to D; per-class Dice on the host, None where
    the ground truth is empty. The volume and every slice go up once (a copy
    from pageable memory waits for the device to go idle, so one a chunk
    would serialize the chunks), the chunks are queued back to back and the
    predictions fetched once."""
    model.eval()
    volume = torch.from_numpy(sample["volume"]).to(device)
    mask = sample["mask"]
    D, K = sample["slices"].shape[0], mask.shape[-1]
    slices = torch.from_numpy(sample["slices"]).to(device)
    if D % chunk:                                    # the forward's one shape
        slices = torch.cat([slices, slices.new_zeros((chunk - D % chunk,) + slices.shape[1:])])
    preds = [torch.sigmoid(model(volume, slices[z0:z0 + chunk])["seg_2d"]) > 0.5
             for z0 in range(0, D, chunk)]
    pred = torch.cat(preds)[:D].cpu().numpy()

    out: Dict[str, Optional[float]] = {}
    for ki in range(K):
        gt = mask[..., ki] > 0.5
        if not gt.any():
            out[f"class_{ki}"] = None
            continue
        p = pred[..., ki]
        out[f"class_{ki}"] = float(2 * (p & gt).sum() / (p.sum() + gt.sum()))
    return out
