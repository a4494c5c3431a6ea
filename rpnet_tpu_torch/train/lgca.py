"""LGCANet_V3 training step and whole-volume eval.

The counterpart of ``rpnet_tpu/train/lgca.py``. One train step: the 3D
context net over the downsampled volume and the fused 2D U-Net over a slice
batch in training mode (batch norm statistics over all the step's slices),
the per-class 2D + 3D Dice loss
(lgca_net_v3.py:629-649) averaged over classes, and the YAML's optimizer
(``train/trainer.make_optimizer``, AdamW with the step-decay schedule).

Over a mesh (``parallel/mesh.LocalMesh``): :func:`sharded_lgca_train_step`
splits the slice batch over the data devices and keeps the batch norm
statistics global over it, so the step computes what the one-device step
computes (the JAX step's contract, ``rpnet_tpu/train/lgca.py:51-63``; a
data-parallel copy with statistics per shard computes something else). The
shards run in lockstep on one host thread (``models/blocks.Shards``): the
context net once per distinct device, each U-Net layer for every shard in
turn, each batch norm reducing its sums on the first device. The
parameters and the optimizer stay on the first device; the shards'
``seg_2d`` are gathered there for the loss and the backward sums the
shards' gradients onto the parameters. :func:`evaluate_lgca_volume` with
``mesh`` splits each chunk of slices over the data devices, each running
its own copy of the model (eval batch norms read running statistics, so
nothing crosses devices).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from rpnet_tpu_torch.models.blocks import Shards
from rpnet_tpu_torch.models.factory import build_lgcanet
from rpnet_tpu_torch.models.lgca import LGCANetV3
from rpnet_tpu_torch.parallel.mesh import (gather_slices, module_replicas,
                                           replicated, shard_slices)
from rpnet_tpu_torch.train.trainer import make_optimizer
from rpnet_tpu_torch.utils.profiling import span


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

    return _lgca_step(model, optimizer, lambda volume, slices: model(volume, slices))


def sharded_lgca_train_step(model: LGCANetV3, optimizer: torch.optim.Optimizer, mesh):
    """``step(state, batch) → metrics`` over ``mesh``
    (``rpnet_tpu/train/lgca.py:51-81``; module doc): the slice batch and its
    mask split over the data devices, the volume and its downsampled mask
    on the first device with the parameters (``model``'s device, which must
    be ``mesh.first``). The batch may be anywhere; metrics are on the first
    device. A ``model`` axis > 1 runs each row's first device alone."""
    home = torch.device(mesh.first)
    if next(model.parameters()).device != home:
        raise ValueError(f"the model lives on {next(model.parameters()).device}; "
                         f"the sharded step keeps it on the mesh's first device {home}")

    def forward(volume, slices):
        out = model(volume.to(home), Shards(shard_slices(mesh, slices)))
        return {"seg_2d": gather_slices(out["seg_2d"], home), "dsv": out["dsv"]}

    step = _lgca_step(model, optimizer, forward)
    return lambda state, batch: step(state, tuple(batch[:2]) + tuple(
        t.to(home, non_blocking=True) for t in batch[2:]))


def _lgca_step(model: LGCANetV3, optimizer: torch.optim.Optimizer, forward):
    """The step around ``forward(volume, slices)`` → {seg_2d, dsv}."""

    @span("train.step")
    def train_step(state: Dict, batch) -> Dict[str, torch.Tensor]:
        volume, slices, mask, vmask = batch
        model.train()
        out = forward(volume, slices)
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
@span("lgca.volume")
def evaluate_lgca_volume(model: LGCANetV3, sample: Dict[str, np.ndarray], device,
                         chunk: int = 16, mesh=None) -> Dict[str, Optional[float]]:
    """Whole-volume eval (``rpnet_tpu/train/lgca.py:117-165``): every
    z-slice in chunks of ``chunk`` (the last one zero-padded), each through
    one eval forward of the whole model, context net included; sigmoid >
    0.5 on the predictions cut to D; per-class Dice on the host, None where
    the ground truth is empty. The volume and every slice go up once (a copy
    from pageable memory waits for the device to go idle, so one a chunk
    would serialize the chunks), the chunks are queued back to back and the
    predictions fetched once.

    With ``mesh`` the chunk is rounded up to a multiple of the data axis and
    each chunk's slices are split over the data devices, each running its
    copy of the model (made for this call) on the volume copied there; the
    predictions are gathered on the first device (``mesh.first``, which
    replaces ``device``)."""
    model.eval()
    if mesh is not None:
        device = torch.device(mesh.first)
        n_data = mesh.shape["data"]
        chunk = -(-chunk // n_data) * n_data
    volume = torch.from_numpy(sample["volume"]).to(device)
    mask = sample["mask"]
    D, K = sample["slices"].shape[0], mask.shape[-1]
    slices = torch.from_numpy(sample["slices"]).to(device)
    if D % chunk:                                    # the forward's one shape
        slices = torch.cat([slices, slices.new_zeros((chunk - D % chunk,) + slices.shape[1:])])
    if mesh is None:
        forward = lambda sl: model(volume, sl)["seg_2d"]
    else:
        replicas = module_replicas(model, mesh.data_devices)
        volumes = dict(zip(map(torch.device, mesh.data_devices), replicated(mesh, volume)))
        forward = lambda sl: gather_slices(
            [replicas[s.device](volumes[s.device], s)["seg_2d"]
             for s in shard_slices(mesh, sl)], device)
    preds = [torch.sigmoid(forward(slices[z0:z0 + chunk])) > 0.5
             for z0 in range(0, D, chunk)]
    with span("lgca.fetch"):   # the wait for the queued chunks, then the copy
        pred = torch.cat(preds)[:D].cpu().numpy()

    out: Dict[str, Optional[float]] = {}
    with span("lgca.dice"):
        for ki in range(K):
            gt = mask[..., ki] > 0.5
            if not gt.any():
                out[f"class_{ki}"] = None
                continue
            p = pred[..., ki]
            out[f"class_{ki}"] = float(2 * (p & gt).sum() / (p.sum() + gt.sum()))
    return out
