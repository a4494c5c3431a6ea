#!/usr/bin/env python3
"""f32 training with cuDNN's TF32 off against TF32 on, on one GPU.

    python3 tools/train_precision_ab.py [--steps 100] [--window 10]

The example's training block (``yamls/example.yml``: 256², U-Net d4, r=5,
4 refinement iterations, batch_size 4 episodes of k=12 slices, 50 affine
steps at reg_fit_scale 4, dice_ce + align loss, AdamW at 1e-5, f32) on
``chip_smoke.py``'s synthetic train set (4 volumes × Spleen, Kidney L,
Kidney R of 48×272×272, seed 1, written once under
``build/train_precision_ab/``). ``--steps`` batches are drawn once on the
host from the example's seed, as the train CLI draws them (one shuffle of
the episode order, ``batch_size`` episodes a step), and both arms train the
same seeded model on the same batches through the port's train step
(``rpnet_tpu_torch.train.trainer.make_train_step``):

  * ``tf32-off``: ``torch.backends.cudnn.allow_tf32`` and
    ``torch.backends.cuda.matmul.allow_tf32`` False;
  * ``tf32-on``: cuDNN's TF32 on (torch's default), matmuls as torch's
    default (TF32 off).

Printed per arm: every step's loss, the mean over each window of
``--window`` steps, the warm seconds a step (host clock around the steps,
each ending in the loss's fetch, from the third step on) and the peak
memory allocated; then each window's relative gap between the arms. Then
one warm step of each arm under ``torch.profiler``: device time, the top
kernels, and every operator that launched a cuDNN layout transform
(``nhwcToNchw`` / ``nchwToNhwc``) with its input shapes and its parent
operators. The card's name and power limit come first.
"""

from __future__ import annotations

import argparse
import collections
import os
import random
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORK = os.path.join(ROOT, "build", "train_precision_ab")
ARMS = {"tf32-off": False, "tf32-on": True}
TRANSFORMS = ("nhwcToNchw", "nchwToNhwc")


def draw_batches(cfg, n_steps: int):
    """``n_steps`` host batches in the train CLI's order from ``seed``."""
    from rpnet_tpu_torch.cli.train import collate_batch
    from rpnet_tpu_torch.config import Config
    from rpnet_tpu_torch.episode.sampler import EpisodeSampler

    config = Config(cfg)
    seed = int(config.get("seed", 0))
    np.random.seed(seed)
    random.seed(seed)
    sampler = EpisodeSampler(config["data_dir"], config["train_set_name"], config,
                             mode="train")
    batch_size, k = int(config["batch_size"]), int(config["k"])
    order = list(range(len(sampler)))
    random.shuffle(order)
    return [collate_batch([sampler.sample(order[(i * batch_size + j) % len(order)])
                           for j in range(batch_size)], target_k=k)
            for i in range(n_steps)]


def set_tf32(on: bool) -> None:
    import torch

    torch.backends.cudnn.allow_tf32 = on
    torch.backends.cuda.matmul.allow_tf32 = False


def train_arm(cfg, batches, tf32: bool):
    """Losses, warm s/step and peak GiB of the arm's run over ``batches``."""
    import torch

    from rpnet_tpu_torch.config import Config
    from rpnet_tpu_torch.models.factory import build_rpnet
    from rpnet_tpu_torch.train.trainer import make_optimizer, make_train_step

    set_tf32(tf32)
    config = Config(cfg)
    model = build_rpnet(config, num_iter=config["n_iter_refinement"],
                        seed=int(config.get("seed", 0)), device="cuda")
    step = make_train_step(model, config, make_optimizer(model.parameters(), config))
    state = {"step": 0}
    torch.cuda.reset_peak_memory_stats()
    losses, stamps = [], []
    for b in batches:
        dev = tuple(torch.from_numpy(a).cuda(non_blocking=True) for a in b)
        losses.append(float(step(state, dev)["loss"]))
        stamps.append(time.perf_counter())
    warm = np.diff(stamps)[1:]
    return losses, float(np.mean(warm)), torch.cuda.max_memory_allocated() / 2 ** 30


def profile_arm(cfg, batch, tf32: bool):
    """One warm step under ``torch.profiler``: device ms, top kernels, and
    the operators that launched cuDNN's layout transforms."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from rpnet_tpu_torch.config import Config
    from rpnet_tpu_torch.models.factory import build_rpnet
    from rpnet_tpu_torch.train.trainer import make_optimizer, make_train_step

    set_tf32(tf32)
    config = Config(cfg)
    model = build_rpnet(config, num_iter=config["n_iter_refinement"], device="cuda")
    step = make_train_step(model, config, make_optimizer(model.parameters(), config))
    dev = tuple(torch.from_numpy(a).cuda() for a in batch)
    state = {"step": 0}
    float(step(state, dev)["loss"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        float(step(state, dev)["loss"])
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3

    kernels = collections.Counter()
    counts = collections.Counter()
    launchers = collections.defaultdict(lambda: [0, 0.0])
    for e in prof.events():
        for kern in getattr(e, "kernels", []):
            kernels[kern.name] += kern.duration / 1e3
            counts[kern.name] += 1
            if any(t in kern.name for t in TRANSFORMS):
                chain, p = [], e.cpu_parent
                while p is not None and len(chain) < 4:
                    chain.append(p.name)
                    p = p.cpu_parent
                key = (e.name, str(e.input_shapes)[:120], " < ".join(chain))
                launchers[key][0] += 1
                launchers[key][1] += kern.duration / 1e3
    total = sum(kernels.values())
    print(f"[profile {'tf32-on' if tf32 else 'tf32-off'}] one warm step: wall {wall:.2f} ms, "
          f"device time {total:.2f} ms in {sum(counts.values())} kernels", flush=True)
    for name, ms in kernels.most_common(12):
        print(f"[profile]   {ms:9.3f} ms  {counts[name]:5d}x  {name[:100]}")
    moved = sum(v[1] for v in launchers.values())
    print(f"[profile] layout transforms: {sum(v[0] for v in launchers.values())} "
          f"launches, {moved:.3f} ms, launched by:")
    for (op, shapes, chain), (n, ms) in sorted(launchers.items(), key=lambda kv: -kv[1][1]):
        print(f"[profile]   {n:4d}x {ms:8.3f} ms  {op} {shapes} < {chain}")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--window", type=int, default=10)
    args = ap.parse_args()

    import torch
    import yaml

    if not torch.cuda.is_available():
        raise SystemExit("train_precision_ab: no CUDA device; this tool runs on the GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    if smi.returncode != 0:
        raise SystemExit(f"nvidia-smi failed: {smi.stderr}")
    print(f"gpu {smi.stdout.strip()} | torch {torch.__version__} CUDA {torch.version.cuda}",
          flush=True)

    sys.path.insert(0, ROOT)
    from rpnet_tpu_torch.core.synthetic import generate_dataset

    paths = generate_dataset(os.path.join(WORK, "data"), n_train=4, n_test=1,
                             shape=(48, 272, 272), seed=1,
                             classes=("Spleen", "Kidney L", "Kidney R"))
    with open(os.path.join(ROOT, "yamls", "example.yml")) as f:
        cfg = yaml.safe_load(f)
    cfg.update(data_dir=paths["data_dir"], class_csv_dir=paths["class_dir"],
               train_set_name=paths["train_csv"], eval_set_name=paths["test_csv"],
               use_native_io=False)
    t0 = time.time()
    batches = draw_batches(cfg, args.steps)
    print(f"[data] {args.steps} batches of {cfg['batch_size']} episodes x {cfg['k']} "
          f"slices drawn in {time.time() - t0:.1f}s", flush=True)

    curves = {}
    for arm, tf32 in ARMS.items():
        t0 = time.time()
        losses, s_step, peak = train_arm(cfg, batches, tf32)
        if not all(np.isfinite(losses)):
            raise SystemExit(f"{arm}: non-finite loss {losses}")
        w = args.window
        means = [float(np.mean(losses[i:i + w])) for i in range(0, len(losses), w)]
        curves[arm] = means
        print(f"[{arm}] {len(losses)} steps in {time.time() - t0:.1f}s: warm "
              f"{s_step:.4f} s/step, peak {peak:.2f} GiB allocated", flush=True)
        print(f"[{arm}] losses {[round(v, 5) for v in losses]}")
        print(f"[{arm}] window means ({w} steps) {[round(v, 5) for v in means]}", flush=True)
    off, on = curves["tf32-off"], curves["tf32-on"]
    gaps = [abs(a - b) / abs(a) for a, b in zip(off, on)]
    tail = gaps[-max(1, len(gaps) // 2):]
    print(f"[gap] per window |on - off| / off: {[round(g, 5) for g in gaps]}; over the "
          f"last half max {max(tail):.5f}, mean {statistics.mean(tail):.5f} (limit 0.02)",
          flush=True)
    for tf32 in ARMS.values():
        profile_arm(cfg, batches[0], tf32)
    return 0


if __name__ == "__main__":
    sys.exit(main())
