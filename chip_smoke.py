#!/usr/bin/env python3
"""Bring-up check of rpnet_tpu_torch on one NVIDIA GPU (an H100 for sm_90a).

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code 1, no result line):
  1. build  — compile every kernel of the eval and training paths from
     ops/csrc/ (one nvcc per source, all started together) for sm_90a,
     printing ptxas' register/shared-memory report;
  2. kernels — call each kernel's wrapper on the card at the main paths'
     shapes, the eval shape (32 slices, 64×64, C=256, r=5), the training
     shape (48 slices, f32) and a ragged edge shape, in bf16 and f32, and
     hold it against its plain PyTorch version: bf16 within one bf16 ulp of
     the f32 result (rtol 2**-7, atol 1e-3), f32 within atol 1e-4 (sums in
     another order); the autograd Function's input gradients against torch
     autograd of the plain forward (f32, atol 1e-4); time kernels and plain
     versions with CUDA events;
  3. main path — the port's eval CLI (``rpnet_tpu_torch.cli.test_rpnet``)
     on a synthetic Abd-110-shaped dataset at 272² volumes / 256² crops,
     configured by yamls/example.yml (U-Net d4, r=5, 10 refinement
     iterations, 50 affine steps at reg_fit_scale 4, bf16 network), with the
     kernels' launch counts set to 0 just before and read just after; every
     kernel must have run 11 times per episode (once per support, once per
     refinement iteration), no episode may fail, every Dice must be finite;
  4. reference — the full-width model (random seeded weights, 3 refinement
     iterations) on a small input, f32 with TF32 off, on the card vs on the
     CPU (plain versions): logits within 2e-3, masks agreeing on > 99.9%;
  5. training path — the port's train CLI (``rpnet_tpu_torch.cli.train``)
     on a synthetic dataset of the train classes (Spleen, Kidney L,
     Kidney R; 48×272×272 volumes), configured by yamls/example.yml's
     training block at full width (1-way 1-shot, k=12, batch_size 4, U-Net
     d4, r=5, 4 refinement iterations, 50 affine steps at reg_fit_scale 4,
     dice_ce + align loss, AdamW, f32) for 4 steps, with the launch counts
     set to 0 just before and read just after: 5 forward and 5 backward
     correlation launches per step; every loss finite, the parameters
     moved, and the written epoch_000.pth loads into the eval model;
  6. training reference — one full-width train step (E=2, k=2, 64², SGD at
     lr 1 so the change is the gradient) on the card vs on the CPU, f32 with
     TF32 off: loss within 1e-4 relative, each parameter tensor's change
     within 3e-2 (norm of the difference over norm of the change; the batch
     statistics of two 64² slices carry f32 differences in the order of
     sums into the deep layers' gradients, ~1e-2 measured).

Then it prints the kernel table (a ``kernels`` line and a ``{"kernels":
...}`` JSON line), the card's name and power limit from nvidia-smi, and as
its last line ``{"ok": true, "device": {...}}``. It imports nothing of the
JAX package, and fails without a CUDA device or without the package beside it.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "build", "chip_smoke")   # .gitignore lists build/
HBM_BYTES_PER_S = 3.35e12                  # H100 SXM (NVIDIA data sheet)
PEAK_FLOPS = {"bfloat16": 989e12,          # dense bf16 tensor cores
              "float32": 67e12}            # f32 outside the tensor cores
N_EVAL_VOLUMES = 4
N_TRAIN_VOLUMES = 4                        # × 3 train classes = 12 episodes
TRAIN_EPISODES = 16                        # 4 steps of batch_size 4
TRAIN_CLASSES = ("Spleen", "Kidney L", "Kidney R")
KERNELS = ("local_corr", "local_corr_bwd")


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median device time of ``fn()`` in ms over ``reps`` CUDA-event-timed runs."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


def corr_bound(shape, r: int, dtype_name: str, backward: bool = False):
    """Least time (ms) for the local correlation (or its backward) on these
    inputs: each input read once, each output written once, over the HBM
    rate; the products that land inside the image (2·C FLOPs each, twice
    as many for the two gradients) over the dtype's peak."""
    B, H, W, C = shape
    itemsize = 2 if dtype_name == "bfloat16" else 4
    d = 2 * r + 1
    # forward: fm1, fm2 in, out (d²) out; backward: g (d²), fm1, fm2 in,
    # dfm1, dfm2 out
    n_fm = 4 if backward else 2
    nbytes = (n_fm * B * H * W * C + B * H * W * d * d) * itemsize

    def valid(n):   # Σ over positions of the in-image shifts
        return sum(min(i + r, n - 1) - max(i - r, 0) + 1 for i in range(n))

    flops = (2 if backward else 1) * 2.0 * B * C * valid(H) * valid(W)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype_name]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def phase_build():
    from concurrent.futures import ThreadPoolExecutor

    from rpnet_tpu_torch.ops import kernels

    t0 = time.time()
    with ThreadPoolExecutor(len(KERNELS)) as pool:   # one nvcc per source
        list(pool.map(lambda k: kernels.build(k, verbose=True), KERNELS))
    for k in KERNELS:
        kernels.load(k)
    log(f"[build] {', '.join(KERNELS)} built for sm_90a in {time.time() - t0:.2f}s")


def check_local_corr(shape, r: int, dtype, seed: int, timed: bool):
    """Kernel vs plain version on one input; raises on disagreement."""
    import torch

    from rpnet_tpu_torch.ops.correlation import (local_correlation,
                                                 local_correlation_plain)

    g = torch.Generator(device="cuda").manual_seed(seed)
    fm1 = torch.randn(shape, generator=g, device="cuda").to(dtype)
    fm2 = torch.randn(shape, generator=g, device="cuda").to(dtype)
    out = local_correlation(fm1, fm2, r)
    plain = local_correlation_plain(fm1, fm2, r)
    torch.cuda.synchronize()
    err = (out.float() - plain.float()).abs().max().item()
    if dtype == torch.bfloat16:
        f32_sum = local_correlation_plain(fm1.float(), fm2.float(), r)
        ok = all(torch.allclose(x.float(), f32_sum, rtol=2 ** -7, atol=1e-3)
                 for x in (out, plain))
        tol = "rtol 2**-7, atol 1e-3 of the f32 sum"
    else:
        ok = err <= 1e-4
        tol = "atol 1e-4"
    name = str(dtype).replace("torch.", "")
    res = {"shape": list(shape), "r": r, "dtype": name, "max_abs_err": err}
    if timed:
        res["ms"] = cuda_ms(lambda: local_correlation(fm1, fm2, r), reps=20)
        res["plain_ms"] = cuda_ms(lambda: local_correlation_plain(fm1, fm2, r), reps=3)
        res["bound_ms"], res["bound_by"] = corr_bound(shape, r, name)
    log(f"[kernels] local_correlation {json.dumps(res)} ({tol}: "
        f"{'ok' if ok else 'DISAGREES'})")
    if not ok or not math.isfinite(err):
        raise AssertionError(f"local_correlation kernel disagrees with its plain "
                             f"version at {shape} r={r} {name}: max err {err}")
    return res


def check_local_corr_bwd(shape, r: int, dtype, seed: int, timed: bool):
    """Backward kernel vs plain version on one input, g a strided view of a
    concat gradient as the CRE hands it over; raises on disagreement."""
    import torch

    from rpnet_tpu_torch.ops.correlation import (local_correlation_bwd,
                                                 local_correlation_bwd_plain)

    B, H, W, C = shape
    d2 = (2 * r + 1) ** 2
    gen = torch.Generator(device="cuda").manual_seed(seed)
    fm1 = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    fm2 = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    g = torch.randn((B, H, W, d2 + C), generator=gen, device="cuda").to(dtype)[..., :d2]
    out = local_correlation_bwd(g, fm1, fm2, r)
    plain = local_correlation_bwd_plain(g, fm1, fm2, r)
    torch.cuda.synchronize()
    err = max((o.float() - p.float()).abs().max().item() for o, p in zip(out, plain))
    if dtype == torch.bfloat16:
        f32 = local_correlation_bwd_plain(g.float(), fm1.float(), fm2.float(), r)
        ok = all(torch.allclose(x.float(), y, rtol=2 ** -7, atol=1e-3)
                 for pair in (out, plain) for x, y in zip(pair, f32))
        tol = "rtol 2**-7, atol 1e-3 of the f32 result"
    else:
        ok = err <= 1e-4
        tol = "atol 1e-4"
    name = str(dtype).replace("torch.", "")
    res = {"shape": list(shape), "r": r, "dtype": name, "max_abs_err": err}
    if timed:
        res["ms"] = cuda_ms(lambda: local_correlation_bwd(g, fm1, fm2, r), reps=20)
        res["plain_ms"] = cuda_ms(lambda: local_correlation_bwd_plain(g, fm1, fm2, r), reps=3)
        res["bound_ms"], res["bound_by"] = corr_bound(shape, r, name, backward=True)
    log(f"[kernels] local_correlation_bwd {json.dumps(res)} ({tol}: "
        f"{'ok' if ok else 'DISAGREES'})")
    if not ok or not math.isfinite(err):
        raise AssertionError(f"local_correlation_bwd kernel disagrees with its plain "
                             f"version at {shape} r={r} {name}: max err {err}")
    return res


def check_autograd(shape, r: int, seed: int):
    """The autograd Function (kernel forward + kernel backward) vs torch
    autograd of the plain forward, f32 on the card, through a concat as in
    the CRE."""
    import torch

    from rpnet_tpu_torch.ops.correlation import (local_correlation_plain,
                                                 local_correlation_trainable)

    gen = torch.Generator(device="cuda").manual_seed(seed)
    fm1 = torch.randn(shape, generator=gen, device="cuda")
    fm2 = torch.randn(shape, generator=gen, device="cuda")
    ct = torch.randn(shape[:3] + ((2 * r + 1) ** 2 + shape[3],), generator=gen,
                     device="cuda")
    grads = []
    for corr in (local_correlation_trainable, local_correlation_plain):
        a, b = fm1.clone().requires_grad_(), fm2.clone().requires_grad_()
        (torch.cat([corr(a, b, r), a], dim=-1) * ct).sum().backward()
        grads.append((a.grad, b.grad))
    torch.cuda.synchronize()
    err = max((x - y).abs().max().item() for x, y in zip(*grads))
    log(f"[kernels] autograd Function vs autograd of the plain version at "
        f"{list(shape)} r={r} f32: max |grad diff| {err:.3e} (atol 1e-4)")
    if not err <= 1e-4:
        raise AssertionError(f"autograd Function gradients disagree: {err}")


def make_dataset():
    from rpnet_tpu_torch.core.synthetic import generate_dataset

    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    t0 = time.time()
    paths = generate_dataset(os.path.join(WORK, "data"), n_train=1,
                             n_test=N_EVAL_VOLUMES, shape=(48, 272, 272),
                             classes=("Liver",), seed=0)
    log(f"[data] {N_EVAL_VOLUMES} synthetic 48x272x272 eval volumes in "
        f"{time.time() - t0:.1f}s")
    return paths


def write_config(paths):
    import yaml

    with open(os.path.join(ROOT, "yamls", "example.yml")) as f:
        cfg = yaml.safe_load(f)
    cfg.update(data_dir=paths["data_dir"], class_csv_dir=paths["class_dir"],
               eval_set_name=paths["test_csv"], train_set_name=paths["train_csv"],
               out_dir=os.path.join(WORK, "out"), n_runs=1)
    path = os.path.join(WORK, "example_synthetic.yml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path, cfg


def main_path_slices(cfg):
    """The query-slice count of each eval episode (host sampling only)."""
    from rpnet_tpu_torch.config import Config
    from rpnet_tpu_torch.episode.sampler import EpisodeSampler

    config = Config(cfg)
    s = EpisodeSampler(config["data_dir"], config["eval_set_name"], config)
    return [s.load_image_and_mask(row["pid"], s.classes[ci])[0].shape[0]
            for ci, rows in enumerate(s.data_info) for row in rows]


def phase_main_path(yaml_path):
    import torch

    from rpnet_tpu_torch.cli import test_rpnet
    from rpnet_tpu_torch.ops.correlation import (local_correlation,
                                                 local_correlation_bwd)

    local_correlation.launches = 0
    local_correlation_bwd.launches = 0
    t0 = time.time()
    results = test_rpnet.main(["--yaml", yaml_path])
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = {"local_correlation": local_correlation.launches,
                "local_correlation_bwd": local_correlation_bwd.launches}

    n_eps = results["episodes"]
    if results["failed_episodes"]:
        raise AssertionError(f"{results['failed_episodes']} of {n_eps} episodes failed")
    if n_eps < 3:
        raise AssertionError(f"only {n_eps} episodes ran")
    for cls, r in results["classes"].items():
        vals = r["affine"] + r["fewshot"] + [v for mv in r["refinement"].values() for v in mv]
        if len(r["refinement"]) != 10 or not all(math.isfinite(v) for v in vals):
            raise AssertionError(f"{cls}: non-finite or missing Dice {r}")
        log(f"[main] {cls}: dice affine {r['affine'][0]:.4f}, fewshot "
            f"{r['fewshot'][0]:.4f}, ref 9 {r['refinement'][9][0]:.4f}")
    if launches != {"local_correlation": 11 * n_eps, "local_correlation_bwd": 0}:
        raise AssertionError(f"correlation launches {launches} in {n_eps} episodes; "
                             f"expected {11 * n_eps} forward, 0 backward")
    log(f"[main] {n_eps} episodes, {results['episodes_per_sec']:.3f} episodes/s "
        f"(first pass, includes warm-up; CLI wall {wall:.1f}s), launches {launches}")
    return results, launches


def make_train_config():
    """The example YAML's training block on a synthetic train-class dataset."""
    import yaml

    from rpnet_tpu_torch.core.synthetic import generate_dataset

    t0 = time.time()
    paths = generate_dataset(os.path.join(WORK, "train_data"), n_train=N_TRAIN_VOLUMES,
                             n_test=1, shape=(48, 272, 272), classes=TRAIN_CLASSES,
                             seed=1)
    log(f"[data] {N_TRAIN_VOLUMES} synthetic 48x272x272 train volumes "
        f"({', '.join(TRAIN_CLASSES)}) in {time.time() - t0:.1f}s")
    with open(os.path.join(ROOT, "yamls", "example.yml")) as f:
        cfg = yaml.safe_load(f)
    cfg.update(data_dir=paths["data_dir"], class_csv_dir=paths["class_dir"],
               train_set_name=paths["train_csv"], eval_set_name=paths["test_csv"],
               out_dir=os.path.join(WORK, "train_out"))
    path = os.path.join(WORK, "example_train_synthetic.yml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path, cfg


def phase_training(yaml_path, cfg):
    import torch

    from rpnet_tpu_torch.cli import train as train_cli
    from rpnet_tpu_torch.config import Config
    from rpnet_tpu_torch.models.factory import build_rpnet
    from rpnet_tpu_torch.ops.correlation import (local_correlation,
                                                 local_correlation_bwd)
    from rpnet_tpu_torch.train.convert import load_into, load_torch_checkpoint

    torch.cuda.reset_peak_memory_stats()
    local_correlation.launches = 0
    local_correlation_bwd.launches = 0
    t0 = time.time()
    res = train_cli.main(["--yaml", yaml_path, "--epochs", "1",
                          "--episodes-per-epoch", str(TRAIN_EPISODES)])
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = {"local_correlation": local_correlation.launches,
                "local_correlation_bwd": local_correlation_bwd.launches}
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30

    steps = len(res["step_losses"])
    expect = steps * (1 + int(cfg["n_iter_refinement"]))   # Wa·Sh + iterations
    if steps < 3:
        raise AssertionError(f"only {steps} training steps ran")
    if launches != {"local_correlation": expect, "local_correlation_bwd": expect}:
        raise AssertionError(f"correlation launches {launches} in {steps} steps; "
                             f"expected {expect} each (5 per step)")
    if not all(math.isfinite(v) for v in res["step_losses"]):
        raise AssertionError(f"non-finite training loss: {res['step_losses']}")
    warm = res["step_seconds"]   # between successive losses, from step 2 on
    log(f"[train] {steps} steps of {cfg['batch_size']} episodes x {cfg['k']} "
        f"slices at 256²: losses {res['step_losses']}, seconds per step "
        f"{warm} (warm mean {sum(warm) / len(warm):.4f}s; batch assembly on "
        f"the host, overlapped with the previous step: {res['data_seconds']}), "
        f"peak memory allocated {peak_gb:.2f} GiB, CLI wall {wall:.1f}s, "
        f"launches {launches}")

    # the parameters moved from the seeded init, and the checkpoint loads
    # into the eval model
    config = Config(cfg)
    ckpt = load_torch_checkpoint(res["checkpoint"])
    init = build_rpnet(config, seed=int(cfg.get("seed", 0))).state_dict()
    moved = [k for k, v in ckpt["state_dict"].items()
             if k in init and v.is_floating_point() and not torch.equal(v, init[k])]
    if ckpt["epoch"] != 1 or len(moved) < len(init) // 2:
        raise AssertionError(f"checkpoint epoch {ckpt['epoch']}, {len(moved)} of "
                             f"{len(init)} tensors moved")
    model = build_rpnet(config, num_iter=config["n_test_iter_refinement"])
    load_into(model, ckpt["state_dict"])
    log(f"[train] {res['checkpoint']}: epoch {ckpt['epoch']}, {len(moved)} of "
        f"{len(init)} tensors moved from the init; loads into the eval model")
    return res, launches, peak_gb


def profile_train_step(cfg):
    """torch.profiler over one warm full-width train step on one batch of the
    synthetic train set: device time by kernel group and the busy share of
    the step's wall time (a measurement; nothing is checked)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from rpnet_tpu_torch.cli.train import collate_batch
    from rpnet_tpu_torch.config import Config
    from rpnet_tpu_torch.episode.sampler import EpisodeSampler
    from rpnet_tpu_torch.models.factory import build_rpnet
    from rpnet_tpu_torch.train.trainer import make_optimizer, make_train_step

    config = Config(cfg)
    sampler = EpisodeSampler(config["data_dir"], config["train_set_name"], config,
                             mode="train")
    batch = [torch.from_numpy(a).cuda() for a in collate_batch(
        [sampler.sample(j) for j in range(int(cfg["batch_size"]))], int(cfg["k"]))]
    model = build_rpnet(config, num_iter=config["n_iter_refinement"], device="cuda")
    step = make_train_step(model, config, make_optimizer(model.parameters(), config))
    state = {"step": 0}
    float(step(state, batch)["loss"])   # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        float(step(state, batch)["loss"])
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3

    def dev_ms(e):
        return getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0)) / 1e3

    # device-side events only (kernels, copies): an operator's own entry may
    # also carry its kernels' time
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA and dev_ms(e) > 0]
    groups = {"correlation kernels": 0.0, "convolutions (cuDNN)": 0.0, "other": 0.0}
    for e in events:
        n = e.key.lower()
        g = ("correlation kernels" if "local_corr" in n else
             "convolutions (cuDNN)" if any(t in n for t in ("conv", "cudnn", "xmma", "gemm",
                                                            "dgrad", "wgrad", "winograd",
                                                            "fft", "complex"))
             else "other")
        groups[g] += dev_ms(e)
    total = sum(groups.values())
    top = sorted(events, key=dev_ms, reverse=True)[:10]
    log(f"[train-profile] one warm step: wall {wall_ms:.2f} ms, device time "
        f"{total:.2f} ms (busy share {total / wall_ms:.3f}); by group "
        + json.dumps({k: round(v, 3) for k, v in groups.items()}))
    for e in top:
        log(f"[train-profile]   {dev_ms(e):9.3f} ms  {e.count:5d}x  {e.key[:90]}")


def phase_train_reference():
    """One full-width train step on the card vs on the CPU, f32, TF32 off."""
    import copy

    import numpy as np
    import torch

    from rpnet_tpu_torch.models.factory import build_rpnet
    from rpnet_tpu_torch.train.trainer import make_optimizer, make_train_step

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = {"mask_refinement_correlation_radius": 5, "n_iter_refinement": 4,
           "use_registration_loss": False, "optimizer": "sgd", "init_lr": 1.0,
           "weight_decay": 1e-4, "scheduler_step": 0, "loss": "dice_ce"}
    E, k, H = 2, 2, 64
    rng = np.random.RandomState(0)
    yy, xx = np.mgrid[:H, :H] / H
    lab = np.stack([((yy - 0.5 + 0.03 * i) / 0.25) ** 2 + ((xx - 0.45) / 0.3) ** 2 <= 1
                    for i in range(E * k)]).astype(np.float32)
    img = np.clip(0.6 * lab - 0.3 + 0.2 * rng.randn(E * k, H, H), -1, 1).astype(np.float32)
    qlab = np.roll(lab, 2, axis=-1)
    qimg = np.clip(0.6 * qlab - 0.3 + 0.2 * rng.randn(E * k, H, H), -1, 1).astype(np.float32)
    batch = [torch.from_numpy(a) for a in (img.reshape(E, 1, k, H, H), lab.reshape(E, 1, k, H, H),
                                           qimg.reshape(E, k, H, H), qlab.reshape(E, k, H, H))]
    base = build_rpnet(cfg, seed=3)
    start = copy.deepcopy(base.state_dict())
    results = {}
    for dev in ("cpu", "cuda"):
        model = copy.deepcopy(base).to(dev)
        step = make_train_step(model, cfg, make_optimizer(model.parameters(), cfg))
        m = step({"step": 0}, [b.to(dev) for b in batch])
        results[dev] = (float(m["loss"]), {n: p.detach().cpu() for n, p in model.named_parameters()})
    (loss_c, p_c), (loss_g, p_g) = results["cpu"], results["cuda"]
    # every conv feeds a batch norm, which cancels its bias: those get no
    # gradient in exact arithmetic and are left out
    conv_bias = {f"{n}.bias" for n, mod in base.named_modules()
                 if isinstance(mod, torch.nn.Conv2d)}
    worst = max(float(torch.linalg.vector_norm(p_g[n] - p_c[n])
                      / torch.linalg.vector_norm(p_c[n] - start[n]).clamp_min(1e-12))
                for n in p_c if n not in conv_bias)
    log(f"[train-reference] full-width step, E=2 k=2 64² r=5 SGD lr 1: loss card "
        f"{loss_g:.6f} CPU {loss_c:.6f} (rtol 1e-4); worst parameter change "
        f"difference {worst:.2e} of the change (3e-2)")
    if not (abs(loss_g - loss_c) <= 1e-4 * abs(loss_c) and worst <= 3e-2):
        raise AssertionError("the train step on the card disagrees with the CPU")


def phase_reference():
    """Full-width model on the card (kernel) vs on the CPU (plain), f32."""
    import numpy as np
    import torch

    from rpnet_tpu_torch.models.factory import build_rpnet

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = {"mask_refinement_correlation_radius": 5, "scale": 4}
    model = build_rpnet(cfg, num_iter=3, seed=1)
    rng = np.random.RandomState(0)
    B, H = 2, 64
    yy, xx = np.mgrid[:H, :H] / H
    lab = np.stack([((yy - 0.5) / 0.3) ** 2 + ((xx - 0.45 - 0.05 * b) / 0.3) ** 2 <= 1
                    for b in range(B)]).astype(np.float32)
    img = np.clip(0.6 * lab - 0.3 + 0.2 * rng.randn(B, H, H), -1, 1).astype(np.float32)
    args = [torch.from_numpy(a) for a in
            (img[None, None, ..., None], lab[None, None], 1 - lab[None, None],
             img[..., None], lab)]
    with torch.no_grad():
        ref = model(*args)["refinement"]
        out = model.to("cuda")(*[a.cuda() for a in args])["refinement"].cpu()
    err = (out - ref).abs().max().item()
    agree = ((out[..., 1] > out[..., 0]) == (ref[..., 1] > ref[..., 0])).float().mean().item()
    log(f"[reference] full-width model, 3 iterations, 2x64x64: card vs CPU "
        f"max |logit diff| {err:.2e} (atol 2e-3), mask agreement {agree:.5f}")
    if not (err <= 2e-3 and agree > 0.999):
        raise AssertionError("the model on the card disagrees with the CPU reference")


def gpu_line() -> str:
    proc = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60)
    if proc.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {proc.stderr}")
    return proc.stdout.strip().splitlines()[0]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on the GPU only",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import rpnet_tpu_torch  # noqa: F401 — fails where the package is absent

    card = gpu_line()
    log(f"[device] {torch.cuda.get_device_name(0)} | nvidia-smi: {card} | "
        f"torch {torch.__version__} CUDA {torch.version.cuda}")

    phase_build()
    paths = make_dataset()
    yaml_path, cfg = write_config(paths)
    dq = main_path_slices(cfg)
    log(f"[data] query slices per episode: {dq}")

    bf16, f32 = torch.bfloat16, torch.float32
    main_case = check_local_corr((dq[0], 64, 64, 256), 5, bf16, seed=1, timed=True)
    check_local_corr((32, 64, 64, 256), 5, bf16, seed=2, timed=True)
    check_local_corr((32, 64, 64, 256), 5, f32, seed=3, timed=True)
    check_local_corr((3, 20, 20, 64), 2, bf16, seed=4, timed=False)
    check_local_corr((3, 20, 20, 64), 2, f32, seed=5, timed=False)
    train_shape = (4 * int(cfg["k"]), 64, 64, 256)    # E·k slices of the train step
    train_fwd = check_local_corr(train_shape, 5, f32, seed=6, timed=True)
    train_bwd = check_local_corr_bwd(train_shape, 5, f32, seed=7, timed=True)
    check_local_corr_bwd((3, 20, 20, 64), 2, f32, seed=8, timed=False)
    check_local_corr_bwd((3, 20, 20, 64), 2, bf16, seed=9, timed=False)
    check_autograd((3, 20, 20, 64), 2, seed=10)
    check_autograd((4, 64, 64, 256), 5, seed=11)

    _, launches = phase_main_path(yaml_path)
    phase_reference()
    train_yaml, train_cfg = make_train_config()
    _, train_launches, _ = phase_training(train_yaml, train_cfg)
    profile_train_step(train_cfg)
    phase_train_reference()

    kernels = [{
        "name": "local_correlation",
        "route": "cuda",
        "source": "rpnet_tpu_torch/ops/csrc/local_corr.cu",
        "replaces": "rpnet_tpu/ops/pallas/correlation.py:289",
        "launches": launches["local_correlation"],
        "max_abs_err": main_case["max_abs_err"],
        "ms": main_case["ms"],
        "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"],
        "library_ms": None,      # no single PyTorch call computes it
    }, {
        "name": "local_correlation_train_forward",
        "route": "cuda",
        "source": "rpnet_tpu_torch/ops/csrc/local_corr.cu",
        "replaces": "rpnet_tpu/ops/pallas/correlation.py:36",
        "launches": train_launches["local_correlation"],
        "max_abs_err": train_fwd["max_abs_err"],
        "ms": train_fwd["ms"],
        "plain_ms": train_fwd["plain_ms"],
        "bound_ms": train_fwd["bound_ms"],
        "bound_by": train_fwd["bound_by"],
        "library_ms": None,
    }, {
        "name": "local_correlation_bwd",
        "route": "cuda",
        "source": "rpnet_tpu_torch/ops/csrc/local_corr_bwd.cu",
        "replaces": "rpnet_tpu/ops/pallas/correlation.py:776",
        "launches": train_launches["local_correlation_bwd"],
        "max_abs_err": train_bwd["max_abs_err"],
        "ms": train_bwd["ms"],
        "plain_ms": train_bwd["plain_ms"],
        "bound_ms": train_bwd["bound_ms"],
        "bound_by": train_bwd["bound_by"],
        "library_ms": None,
    }]
    log("kernels " + json.dumps([
        {"name": k["name"], "max_abs_err": k["max_abs_err"], "kernel_ms": k["ms"],
         "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
         "launches": k["launches"]} for k in kernels]))
    log(json.dumps({"kernels": kernels}))
    log(f"gpu {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
