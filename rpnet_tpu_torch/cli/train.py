"""Training CLI on PyTorch.

    python -m rpnet_tpu_torch.cli.train --yaml yamls/example.yml

The counterpart of ``rpnet_tpu/cli/train.py:42-70, 157-288`` for RP_Net:
seeds numpy and ``random`` from ``seed``, draws ``batch_size`` train-mode
episodes per step in the JAX CLI's order (one ``random.shuffle`` of the
episode order per epoch), runs the train step (``train/trainer.py``),
prints the per-epoch loss line in the JAX CLI's format, tees stdout to
``out_dir/log_train`` (and restores it on return), and saves
``out_dir/model/epoch_NNN.pth`` every ``epoch_save`` epochs. ``ckpt:``
resumes from such a file (or a reference ``.pth``). ``pretrained_path``
warm-starts the fresh model before that (``rpnet_tpu/train/checkpoint.py:
124-155``): with ``backbone: vgg`` a torchvision VGG16 ``state_dict`` fills
the encoder's 13 convolutions in order (``train/convert.
convert_torchvision_vgg16``), with any other backbone a full RP_Net ``.pth``
is loaded onto the model (``train/convert.load_into``). The epoch's mean
loss goes to TensorBoard as ``train/loss`` under ``out_dir/runs`` where
``tensorboard`` is installed, as the JAX CLI writes it; without it the run
trains all the same and says so.

It runs on the GPU (``--platform gpu``, the default) and raises when there
is none; ``--platform cpu`` runs on the CPU with the kernels' plain versions.
Training leaves cuDNN's convolutions at torch's default precision (TF32 on
the card), as the JAX package leaves its f32 convolutions at XLA's default:
over 100 steps of the example's training block the windowed loss means of
TF32 and full f32 agree within 0.6% (``tools/train_precision_ab.py``); the
demons blur keeps f32 (``registration/gaussian.no_tf32``).

``net: LGCANet_V3`` runs :func:`train_lgca` instead, the counterpart of
``rpnet_tpu/cli/train.py:73-150``: one whole-volume sample a step (volume
``j % len(sampler)``, its ``lgca_slices`` slices drawn from
``np.random.RandomState(seed)``), the same ``epoch N loss X (Y
volumes/s)`` line and ``.pth`` checkpoints with the upstream LGCA names; its
``mesh_shape`` is resolved with the slice batch as divisor, as the JAX CLI
resolves it; where its data axis is above 1 the step is
``train/lgca.sharded_lgca_train_step`` (the slice batch split over the data
devices, batch norm statistics global).

With ``multihost`` (or torchrun's variables) the process joins the gloo
group first (``parallel/mesh.py``); RP_Net training then runs per process,
as in the JAX CLI. ``debug_nans`` turns on
``utils/profiling.enable_nan_debugging`` for the model: the first NaN of a
forward or backward raises.
"""

from __future__ import annotations

import argparse
import os
import random
import sys
import time
from typing import Dict, List

import numpy as np
import torch

from rpnet_tpu_torch.cli.test_rpnet import (check_net, resolve_device, sharding_mesh,
                                            start_process)
from rpnet_tpu_torch.config import Config, load_yaml
from rpnet_tpu_torch.episode.lgca_data import LGCAVolumeSampler
from rpnet_tpu_torch.episode.sampler import EpisodeSampler
from rpnet_tpu_torch.models.factory import build_rpnet
from rpnet_tpu_torch.parallel.mesh import resolve_cli_mesh
from rpnet_tpu_torch.train.checkpoint import restore_checkpoint, save_checkpoint
from rpnet_tpu_torch.train.convert import (convert_torchvision_vgg16, load_into,
                                           load_torch_checkpoint)
from rpnet_tpu_torch.train.lgca import (init_lgca, make_lgca_train_step,
                                        sharded_lgca_train_step)
from rpnet_tpu_torch.train.trainer import make_optimizer, make_train_step
from rpnet_tpu_torch.utils.logger import Logger
from rpnet_tpu_torch.utils.profiling import enable_nan_debugging

parser = argparse.ArgumentParser(description="RP-Net training (PyTorch)")
parser.add_argument("--yaml", default=None)
parser.add_argument("--platform", default="gpu", choices=("gpu", "cpu"),
                    help="gpu (default; raises without one) or cpu")
parser.add_argument("--epochs", type=int, default=None)
parser.add_argument("--episodes-per-epoch", type=int, default=None)


def _compact_labels(a: np.ndarray) -> np.ndarray:
    """uint8 twin of a {0, 1}-valued float label array (exact; the train
    step widens it on the device). Other labels pass through."""
    if a.dtype == np.float32:
        u8 = a.astype(np.uint8)
        if np.array_equal(u8, a):
            return u8
    return a


def collate_batch(episodes, target_k: int = None) -> tuple:
    """Stack episodes into a leading E axis, padded to a common k.

    The slice binning clamps k to the shortest volume in each episode, so a
    short organ z-range yields fewer than ``k`` slices; short episodes are
    padded by cycling their slices, as the JAX CLI does.
    """
    ks = [e.query_images.shape[0] for e in episodes]
    k = target_k or max(ks)

    def cyc(a, axis):
        n = a.shape[axis]
        if n == k:
            return a
        return np.take(a, np.arange(k) % n, axis=axis)

    supp_img = np.stack([cyc(e.support_images, 1) for e in episodes])  # (E, Sh, k, H, W)
    supp_lab = np.stack([cyc(e.support_labels, 1) for e in episodes])
    qry_img = np.stack([cyc(e.query_images, 0) for e in episodes])     # (E, k, H, W)
    qry_lab = np.stack([cyc(e.query_labels, 0) for e in episodes])
    return supp_img, _compact_labels(supp_lab), qry_img, _compact_labels(qry_lab)


def apply_pretrained(model, config: Config) -> None:
    """The ``pretrained_path`` warm start (``rpnet_tpu/train/checkpoint.py:
    124-155``): a torchvision VGG16 checkpoint into the VGG encoder's
    convolutions, positionally; with another backbone a full RP_Net
    ``.pth`` onto the whole model."""
    path = config.get("pretrained_path")
    if not path:
        return
    backbone = config["backbone"]
    if backbone == "vgg":
        raw = torch.load(path, map_location="cpu", weights_only=True)
        sd = raw.get("state_dict", raw) if isinstance(raw, dict) else raw
        model.load_state_dict(convert_torchvision_vgg16(sd), strict=False)
        print(f"[vgg warm start from {path}]")
        return
    load_into(model, load_torch_checkpoint(path)["state_dict"])
    print(f"[{backbone} warm start from {path}]")


def summary_writer(out_dir: str):
    """TensorBoard's writer under ``out_dir/runs``, or None where
    ``tensorboard`` is not installed (``rpnet_tpu/cli/train.py:247-250``)."""
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError as e:
        print(f"[tensorboard not available ({e}); train/loss is not written]")
        return None
    runs = os.path.join(out_dir, "runs")
    print(f"[tensorboard: train/loss per epoch under {runs}]")
    return SummaryWriter(runs)


def main(argv=None):
    args = parser.parse_args(argv)
    if not args.yaml:
        print("No configuration file")
        return None
    device = resolve_device(args.platform)
    config = Config(load_yaml(args.yaml))
    check_net(config)
    device = start_process(config, device)

    seed = int(config.get("seed", 0))
    np.random.seed(seed)
    random.seed(seed)

    out_dir = config.get("out_dir") or "./results/{}/".format(
        os.path.splitext(os.path.basename(args.yaml))[0])
    model_dir = os.path.join(out_dir, "model")
    os.makedirs(model_dir, exist_ok=True)
    logger = Logger(os.path.join(out_dir, "log_train"))
    sys.stdout = logger
    try:
        if config["net"] == "LGCANet_V3":
            return train_lgca(config, args, device, out_dir, seed)
        return train(config, args, device, out_dir, seed)
    finally:
        if config.get("debug_nans"):
            enable_nan_debugging(False)
        sys.stdout = logger.terminal
        logger.close()


def train(config: Config, args, device, out_dir: str, seed: int) -> Dict:
    """The epoch loop; returns per-step losses, the seconds between
    successive steps' losses (from the second step on), the host seconds
    spent assembling each batch, epoch losses and the last checkpoint."""
    sampler = EpisodeSampler(config["data_dir"], config["train_set_name"],
                             config, mode="train")
    print(f"[length of train loader {len(sampler)}]")

    epochs = args.epochs or int(config.get("epochs", 100))
    batch_size = int(config.get("batch_size", 4))
    epi_per_epoch = args.episodes_per_epoch or len(sampler)
    epoch_save = int(config.get("epoch_save", 1))
    steps_per_epoch = max(1, -(-epi_per_epoch // batch_size))
    k = int(config.get("k", 12))

    model = build_rpnet(config, num_iter=config["n_iter_refinement"], seed=seed,
                        device=device, align=True)
    apply_pretrained(model, config)
    if config.get("debug_nans"):
        enable_nan_debugging(True, model)
    optimizer = make_optimizer(model.parameters(), config, steps_per_epoch)
    state = {"step": 0}
    start_epoch = 0
    if config.get("ckpt"):
        print(f"[Loading model from {config['ckpt']}]")
        start_epoch = restore_checkpoint(config["ckpt"], model, optimizer,
                                         steps_per_epoch)
        state["step"] = start_epoch * steps_per_epoch
    train_step = make_train_step(model, config, optimizer)
    writer = summary_writer(out_dir)

    def to_device(a):
        return torch.from_numpy(a).to(device, non_blocking=True)

    results: Dict[str, List] = {"step_losses": [], "step_seconds": [],
                                "data_seconds": [], "epoch_losses": [],
                                "checkpoint": None}
    try:
        order = list(range(len(sampler)))
        t_last = None
        for epoch in range(start_epoch, epochs):
            random.shuffle(order)
            t0 = time.time()
            losses: List[float] = []
            idx = 0
            pending = None   # the last step's metrics, still on the device

            def fetch():
                nonlocal t_last
                losses.append(float(pending["loss"]))   # waits for that step
                now = time.perf_counter()
                if t_last is not None:
                    results["step_seconds"].append(now - t_last)
                t_last = now

            while idx < epi_per_epoch:
                # assemble the next batch while the device runs the previous step
                # (the JAX CLI's order); reading the loss is the wait
                t_data = time.perf_counter()
                take = [order[(idx + j) % len(order)] for j in range(batch_size)]
                episodes = [sampler.sample(t) for t in take]
                batch = collate_batch(episodes, target_k=k)
                results["data_seconds"].append(time.perf_counter() - t_data)
                if pending is not None:
                    fetch()
                pending = train_step(state, tuple(map(to_device, batch)))
                idx += batch_size
            if pending is not None:
                fetch()
            wall = time.time() - t0
            mean_loss = float(np.mean(losses)) if losses else float("nan")
            print(f"epoch {epoch} loss {mean_loss:.4f} "
                  f"({epi_per_epoch / max(wall, 1e-9):.2f} episodes/s)")
            results["step_losses"] += losses
            results["epoch_losses"].append(mean_loss)
            if writer is not None:
                writer.add_scalar("train/loss", mean_loss, epoch)
            if (epoch + 1) % epoch_save == 0:
                # epoch = completed epochs (epoch + 1): a resume starts at the next
                results["checkpoint"] = save_checkpoint(
                    os.path.join(out_dir, "model", f"epoch_{epoch:03d}.pth"), epoch + 1,
                    model, optimizer)
    finally:
        if writer is not None:
            writer.close()
    return results


def train_lgca(config: Config, args, device, out_dir: str, seed: int) -> Dict:
    """The LGCANet_V3 epoch loop (``rpnet_tpu/cli/train.py:73-150``); returns
    what :func:`train` returns."""
    sampler = LGCAVolumeSampler(config["data_dir"], config["train_set_name"],
                                config, mode="train")
    print(f"[length of LGCA train loader {len(sampler)}]")
    epochs = args.epochs or int(config.get("epochs", 100))
    epoch_save = int(config.get("epoch_save", 1))
    steps_per_epoch = args.episodes_per_epoch or len(sampler)

    model, optimizer, state = init_lgca(config, seed, device, steps_per_epoch)
    start_epoch = 0
    if config.get("ckpt"):
        print(f"[Loading model from {config['ckpt']}]")
        start_epoch = restore_checkpoint(config["ckpt"], model, optimizer,
                                         steps_per_epoch)
        state["step"] = start_epoch * steps_per_epoch
    # the slice batch shards over the mesh's data axis, as in the JAX CLI
    # (rpnet_tpu/cli/train.py:113-123)
    mesh = sharding_mesh(resolve_cli_mesh(
        config.get("mesh_shape"), device,
        batch_divisor=int(config.get("lgca_slices", 8)), prefix="LGCA "))
    if config.get("debug_nans"):
        enable_nan_debugging(True, model)
    step = (make_lgca_train_step(model, optimizer) if mesh is None
            else sharded_lgca_train_step(model, optimizer, mesh))
    rng = np.random.RandomState(seed)

    def to_device(a):
        return torch.from_numpy(a).to(device, non_blocking=True)

    results: Dict[str, List] = {"step_losses": [], "step_seconds": [],
                                "data_seconds": [], "epoch_losses": [],
                                "checkpoint": None}
    t_last = None
    for epoch in range(start_epoch, epochs):
        t0 = time.time()
        losses: List[float] = []
        pending = None   # the last step's metrics, still on the device

        def fetch():
            nonlocal t_last
            losses.append(float(pending["loss"]))   # waits for that step
            now = time.perf_counter()
            if t_last is not None:
                results["step_seconds"].append(now - t_last)
            t_last = now

        for j in range(steps_per_epoch):
            # sample volume j while the device runs step j - 1
            t_data = time.perf_counter()
            s = sampler.sample(j % len(sampler), rng=rng)
            batch = tuple(to_device(s[k]) for k in ("volume", "slices", "mask",
                                                    "downsampled_volume_mask"))
            results["data_seconds"].append(time.perf_counter() - t_data)
            if pending is not None:
                fetch()
            pending = step(state, batch)
        if pending is not None:
            fetch()
        wall = time.time() - t0
        mean_loss = float(np.mean(losses))
        print(f"epoch {epoch} loss {mean_loss:.4f} "
              f"({steps_per_epoch / max(wall, 1e-9):.2f} volumes/s)")
        results["step_losses"] += losses
        results["epoch_losses"].append(mean_loss)
        if (epoch + 1) % epoch_save == 0:
            # epoch = completed epochs (epoch + 1): a resume starts at the next
            results["checkpoint"] = save_checkpoint(
                os.path.join(out_dir, "model", f"epoch_{epoch:03d}.pth"), epoch + 1,
                model, optimizer)
    return results


if __name__ == "__main__":
    main()
