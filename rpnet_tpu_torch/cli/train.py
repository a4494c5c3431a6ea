"""Training CLI on PyTorch.

    python -m rpnet_tpu_torch.cli.train --yaml yamls/example.yml

The counterpart of ``rpnet_tpu/cli/train.py:42-70, 157-288`` for RP_Net:
seeds numpy and ``random`` from ``seed``, draws ``batch_size`` train-mode
episodes per step in the JAX CLI's order (one ``random.shuffle`` of the
episode order per epoch), runs the train step (``train/trainer.py``),
prints the per-epoch loss line in the JAX CLI's format, tees stdout to
``out_dir/log_train`` (and restores it on return), and saves
``out_dir/model/epoch_NNN.pth`` every ``epoch_save`` epochs. ``ckpt:``
resumes from such a file (or a reference ``.pth``).

It runs on the GPU (``--platform gpu``, the default) and raises when there
is none; ``--platform cpu`` runs on the CPU with the kernels' plain versions.
float32 on the GPU turns TF32 off for cuDNN and matmuls, as the eval runner
does. Not ported yet (ROADMAP.md): LGCANet_V3 training, ``pretrained_path``
warm starts, TensorBoard scalars, n_way > 1 and bfloat16 training.
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

from rpnet_tpu_torch.cli.test_rpnet import resolve_device
from rpnet_tpu_torch.config import Config, load_yaml
from rpnet_tpu_torch.episode.sampler import EpisodeSampler
from rpnet_tpu_torch.models.factory import build_rpnet
from rpnet_tpu_torch.train.checkpoint import restore_checkpoint, save_checkpoint
from rpnet_tpu_torch.train.trainer import check_ported, make_optimizer, make_train_step
from rpnet_tpu_torch.utils.logger import Logger

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


def _check_ported(config: Config) -> None:
    check_ported(config)
    if config.get("net", "RP_Net") != "RP_Net":
        raise NotImplementedError("rpnet_tpu_torch trains RP_Net only "
                                  "(LGCANet_V3 is not ported yet)")
    if config.get("pretrained_path"):
        raise NotImplementedError("pretrained_path warm starts are not ported "
                                  "yet (resume with ckpt: instead)")


def main(argv=None):
    args = parser.parse_args(argv)
    if not args.yaml:
        print("No configuration file")
        return None
    device = resolve_device(args.platform)
    config = Config(load_yaml(args.yaml))
    _check_ported(config)

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
        return train(config, args, device, model_dir, seed)
    finally:
        sys.stdout = logger.terminal
        logger.close()


def train(config: Config, args, device, model_dir: str, seed: int) -> Dict:
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

    if device.type == "cuda":
        # float32 means float32 (the only training dtype ported)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    model = build_rpnet(config, num_iter=config["n_iter_refinement"], seed=seed,
                        device=device, align=True)
    optimizer = make_optimizer(model.parameters(), config, steps_per_epoch)
    state = {"step": 0}
    start_epoch = 0
    if config.get("ckpt"):
        print(f"[Loading model from {config['ckpt']}]")
        start_epoch = restore_checkpoint(config["ckpt"], model, optimizer,
                                         steps_per_epoch)
        state["step"] = start_epoch * steps_per_epoch
    train_step = make_train_step(model, config, optimizer)

    def to_device(a):
        return torch.from_numpy(a).to(device, non_blocking=True)

    results: Dict[str, List] = {"step_losses": [], "step_seconds": [],
                                "data_seconds": [], "epoch_losses": [],
                                "checkpoint": None}
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
        if (epoch + 1) % epoch_save == 0:
            # epoch = completed epochs (epoch + 1): a resume starts at the next
            results["checkpoint"] = save_checkpoint(
                os.path.join(model_dir, f"epoch_{epoch:03d}.pth"), epoch + 1,
                model, optimizer)
    return results


if __name__ == "__main__":
    main()
