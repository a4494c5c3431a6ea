#!/usr/bin/env python3
"""Bring-up check of rpnet_tpu_torch on one NVIDIA GPU (an H100 for sm_90a).

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code 1, no result line):
  1. build  — compile every kernel of the eval main path from ops/csrc/
     with nvcc for sm_90a, printing ptxas' register/shared-memory report;
  2. kernels — call each kernel's wrapper on the card at the main path's
     shapes, the eval shape (32 slices, 64×64, C=256, r=5) and a ragged edge
     shape, in bf16 and f32, and hold it against its plain PyTorch version:
     bf16 within one bf16 ulp of the f32 sum (rtol 2**-7, atol 1e-3), f32
     within atol 1e-4 (sums in another order); time kernel and plain version
     with CUDA events;
  3. main path — the port's eval CLI (``rpnet_tpu_torch.cli.test_rpnet``)
     on a synthetic Abd-110-shaped dataset at 272² volumes / 256² crops,
     configured by yamls/example.yml (U-Net d4, r=5, 10 refinement
     iterations, 50 affine steps at reg_fit_scale 4, bf16 network), with the
     kernels' launch counts set to 0 just before and read just after; every
     kernel must have run 11 times per episode (once per support, once per
     refinement iteration), no episode may fail, every Dice must be finite;
  4. reference — the full-width model (random seeded weights, 3 refinement
     iterations) on a small input, f32 with TF32 off, on the card vs on the
     CPU (plain versions): logits within 2e-3, masks agreeing on > 99.9%.

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


def corr_bound(shape, r: int, dtype_name: str):
    """Least time (ms) for the local correlation on these inputs: each input
    read once, the output written once, over the HBM rate; the products that
    land inside the image (2·C FLOPs each) over the dtype's peak."""
    B, H, W, C = shape
    itemsize = 2 if dtype_name == "bfloat16" else 4
    d = 2 * r + 1
    nbytes = (2 * B * H * W * C + B * H * W * d * d) * itemsize

    def valid(n):   # Σ over positions of the in-image shifts
        return sum(min(i + r, n - 1) - max(i - r, 0) + 1 for i in range(n))

    flops = 2.0 * B * C * valid(H) * valid(W)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype_name]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def phase_build():
    from rpnet_tpu_torch.ops import kernels

    t0 = time.time()
    kernels.build("local_corr", verbose=True)
    kernels.load("local_corr")
    log(f"[build] local_corr built for sm_90a in {time.time() - t0:.2f}s")


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
    from rpnet_tpu_torch.ops.correlation import local_correlation

    local_correlation.launches = 0
    t0 = time.time()
    results = test_rpnet.main(["--yaml", yaml_path])
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = {"local_correlation": local_correlation.launches}

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
    if launches["local_correlation"] != 11 * n_eps:
        raise AssertionError(f"local_correlation launched {launches['local_correlation']} "
                             f"times in {n_eps} episodes; expected {11 * n_eps}")
    log(f"[main] {n_eps} episodes, {results['episodes_per_sec']:.3f} episodes/s "
        f"(first pass, includes warm-up; CLI wall {wall:.1f}s), launches {launches}")
    return results, launches


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

    _, launches = phase_main_path(yaml_path)
    phase_reference()

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
