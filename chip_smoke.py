#!/usr/bin/env python3
"""Bring-up check of rpnet_tpu_torch on one NVIDIA GPU (an H100 for sm_90a).

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code 1, no result line):
  1. build  — compile every kernel of the eval and training paths and of the
     opt-in correlation forwards from ops/csrc/ (one nvcc per source, all
     started together) for sm_90a, printing ptxas' register/shared-memory
     report, the bf16 forward's design, shared memory and blocks an SM, the
     f32 forward's, the band kernel's and the C-strided kernel's (both
     dtypes) and the backward's designs, shared memory, blocks an SM,
     registers and spills;
  2. kernels — call each kernel's wrapper on the card at the main paths'
     shapes, the eval shape (the first episode's query slices, 64×64,
     C=256, r=5, bf16; and C=512 at 32×32 and 64×64, the VGG and ResNet
     backbones' eval shapes), the training shape (48 slices, f32) and the
     forward's tiling edges in both dtypes (ragged 20×20 and 3×5, W past one
     32- or 64-query strip, C = 16, 48 and 320, r = 1..5), on outputs
     NaN-poisoned, and hold it against its plain PyTorch version: bf16 within
     one bf16 ulp of the f32 result (rtol 2**-7, atol 1e-3), f32 within atol
     1e-4 (sums in another order); the backward at the training shape and
     at the same edges (and r=4), both dtypes, g as the CRE's strided view
     and contiguous, outputs NaN-poisoned; the autograd Function's input gradients
     against torch autograd of the plain forward (f32, atol 1e-4). The
     opt-in forwards likewise (``check_variant``): the tensor-core band
     kernel (RPNET_CORR_IMPL=pallas_mxu), its pdot epilogue
     (RPNET_ROT_EXTRACT=pdot, bf16, at C=256 — where it also matches the
     select kernel — and C=48) and its packed slice pairs
     (RPNET_ROT_PACK=1) at the eval and training shapes and at
     ``BAND_EDGES`` (band at the forward's edges in both dtypes, pdot at
     C = 48, 256, 320, pack at slice widths 64, 20, 100 and 8 in both
     dtypes with a partner slice 300× (f32) or 30× (bf16) larger), and the
     C-strided kernel
     (RPNET_CORR_IMPL=csub; also at the forward's edges and at C = 528, 576
     past the fm1 it keeps resident, W = 12 and 40, r = 1, 2, in both
     dtypes), all on NaN-poisoned outputs. Kernels and plain versions are
     timed with CUDA events (``rpnet_tpu_torch.utils.timing.cuda_ms``);
  2b. sweep kernels — the kernel sweep's own two kernels
     (``rpnet_tpu_torch.bench_tools.corr_sweep``, both on the band body of
     tensor-core products: corr_swapped, planar f32, and corr_rotmxu, NHWC
     with d² or 128 zero-padded lanes) against their plain versions at the
     sweep shape (32×64×64×256, r=5; f32 and bf16, every h_tile, both
     full_lanes and both out_f32;
     corr_swapped timed as the kernel alone and through its wrapper's
     transpose and cast) and at ``SWEEP_EDGES`` in both dtypes (corr_rotmxu
     with d² and 128 lanes), on outputs the caching allocator had filled
     with NaN; padding lanes exactly zero;
  2c. the kernel sweep — ``corr_sweep.main()`` at 32×64×64×256, r=5, with
     the launch counts set to 0 just before and read just after: no line
     FAILED or missed its tolerance, and each kernel launched as often as
     its lines call it;
  2d. grid_sample — CUDA ``F.grid_sample`` (bilinear, zeros,
     align_corners=False, f32) against a plain torch evaluation of the JAX
     gather formula ((x+1)·S − 1)/2 on the card, at every pair of
     knife-edge coordinates (exact integer and half-integer indices and
     1 ulp either side) for S = 64 and 48: values within 1e-5, the input's
     gradient within 1e-4, the grid's within 1e-6 of its scale everywhere;
     then the affine fit (50 steps, fit_scale 1) on a sharp input (binary
     squares plus noise) on the card and on the CPU, theta's difference
     logged;
  3. main path — the port's eval CLI (``rpnet_tpu_torch.cli.test_rpnet``)
     on a synthetic Abd-110-shaped dataset at 272² volumes / 256² crops,
     configured by yamls/example.yml (U-Net d4, r=5, 10 refinement
     iterations, 50 affine steps at reg_fit_scale 4, bf16 network), with the
     kernels' launch counts set to 0 just before and read just after; every
     kernel must have run 11 times per episode (once per support, once per
     refinement iteration), no episode may fail, every Dice must be finite;
  3b. eval switches — the same CLI, episodes and weights under each opt-in
     forward (pallas_mxu, csub, pdot, RPNET_ROT_PACK=1): 11 launches per
     episode of the selected kernel (pack: select for odd slice counts),
     refinement masks agreeing with phase 3's on > 99.9% of pixels;
  3c. data paths — the same CLI on the same episodes and weights for 3
     passes on each eval data path: the spec path (the example's defaults,
     a device volume cache of 16: index-only episodes gathered on the card),
     the prefetch path (cache 0, num_workers 4) and the plain host path
     (cache 0, num_workers 0): every episode's metrics equal across the
     paths, 11 launches an episode, no failure; each pass's episodes/s and
     ``stage_timing`` logged (no forward hook); then one warm episode queued
     on the spec and on the host path under
     ``torch.cuda.set_sync_debug_mode("warn")``: no synchronizing call; and
     one warm spec episode under ``torch.profiler`` (device time by kernel
     group, device operations, busy share);
  3d. breadth — the CLI on 2 episodes under ``backbone: vgg`` (scale 8),
     ``backbone: resnet``, ``mask_feature_map: x2``, ``use_relation_enc:
     concat`` and ``use_all_supports`` + ``multishot_fusion`` with 2 shots
     and ``n_way: 2``: Wa·Sh + 10 launches an episode (none under concat),
     no failed episode, every Dice finite;
  3r. registration reference — ``register_episode`` with 50 demons steps
     on the first episode's first 4 query slices at 256², matmul structure
     (fit_scale 4) and gather structure, on the card and on the CPU:
     warped labels agreeing on > 99.9% of pixels, the warped image within
     0.1 (5e-4 on average), the raw flow within half its largest value; the
     affine-only and demons priors' Dice logged; ``deeds_fit`` (128² grid,
     15² shifts) card vs CPU within 1e-4;
  3e. deformable eval — phase 3's CLI, episodes and weights with
     ``do_deformable: True`` for 2 passes, under ``reg_sampler: matmul``
     and ``gather``: 11 launches an episode, no failed episode, every Dice
     finite; each episode's demons prior Dice beside phase 3's affine-only
     one and the warm pass's episodes/s logged; under matmul one warm spec
     dispatch under the sync debug mode (no synchronizing call) and one
     warm episode profiled (device operations);
  3f. eval_3d — the eval CLI with ``yamls/example_3d.yml``'s settings on 2
     synthetic Liver volumes of 80×272×272 (2 windows each): 11 launches a
     window, no failed volume, finite Dice, predictions of the volume's
     shape;
  4. reference — the full-width model (random seeded weights, 3 refinement
     iterations) on a small input, f32 with TF32 off, on the card vs on the
     CPU (plain versions), for the U-Net, VGG and ResNet backbones: logits
     within 2e-3, masks agreeing on > 99.9%;
  5. training path — the port's train CLI (``rpnet_tpu_torch.cli.train``)
     on a synthetic dataset of the train classes (Spleen, Kidney L,
     Kidney R; 48×272×272 volumes), configured by yamls/example.yml's
     training block at full width (1-way 1-shot, k=12, batch_size 4, U-Net
     d4, r=5, 4 refinement iterations, 50 affine steps at reg_fit_scale 4,
     dice_ce + align loss, AdamW, f32) for 4 steps, with the launch counts
     set to 0 just before and read just after: 5 forward and 5 backward
     correlation launches per step; every loss finite, the parameters
     moved, and the written epoch_000.pth loads into the eval model;
  5b. training switches — 2 steps of the same CLI from the same seed under
     pallas_mxu, csub and rot + RPNET_ROT_PACK=1: 5 launches of the selected
     forward and 5 of the backward per step, the first loss within 1e-3
     relative of phase 5's;
  5c. deformable training — 2 steps of the train CLI with
     ``do_deformable: True`` (50 demons steps, matmul structure): 5 forward
     and 5 backward launches a step, finite losses, parameters moved;
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
import random
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "build", "chip_smoke")   # .gitignore lists build/
HBM_BYTES_PER_S = 3.35e12                  # H100 SXM (NVIDIA data sheet)
PEAK_FLOPS = {"bf16 tensor cores": 989e12,     # dense (NVIDIA data sheet)
              "tf32 tensor cores": 494.7e12}   # dense; f32 as three passes (3xTF32)
N_EVAL_VOLUMES = 4
N_TRAIN_VOLUMES = 4                        # × 3 train classes = 12 episodes
TRAIN_EPISODES = 16                        # 4 steps of batch_size 4
TRAIN_CLASSES = ("Spleen", "Kidney L", "Kidney R")
KERNELS = ("local_corr", "local_corr_bwd", "local_corr_band", "local_corr_csub",
           "local_corr_sweep")
# the wrappers that count their kernel's launches, by the name they report
WRAPPERS = ("local_correlation", "local_correlation_bwd", "local_correlation_band",
            "local_correlation_pdot", "local_correlation_packed",
            "local_correlation_csub")
# the kernel sweep's own two, in rpnet_tpu_torch.bench_tools.corr_sweep
SWEEP_WRAPPERS = ("corr_swapped", "corr_rotmxu")
# the opt-in forwards: RPNET_* settings → the wrapper that must launch
EVAL_SWITCHES = {"pallas_mxu": ({"RPNET_CORR_IMPL": "pallas_mxu"}, "local_correlation_band"),
                 "csub": ({"RPNET_CORR_IMPL": "csub"}, "local_correlation_csub"),
                 "pdot": ({"RPNET_ROT_EXTRACT": "pdot"}, "local_correlation_pdot"),
                 "pack": ({"RPNET_ROT_PACK": "1"}, "local_correlation_packed")}
TRAIN_SWITCHES = {"pallas_mxu": ({"RPNET_CORR_IMPL": "pallas_mxu"}, "local_correlation_band"),
                  "csub": ({"RPNET_CORR_IMPL": "csub"}, "local_correlation_csub"),
                  "rot+pack": ({"RPNET_CORR_IMPL": "rot", "RPNET_ROT_PACK": "1"},
                               "local_correlation_packed")}
VARIANT_TRAIN_EPISODES = 8                 # 2 steps of batch_size 4
SWEEP_SHAPE = (32, 64, 64, 256)            # bench_tools/corr_sweep.py's shape (r=5)
# the forward's tiling edges in (B, H, W, C) and r: ragged 20x20 and 3x5, W
# past one 32- or 64-query strip, C = 16, 48 and 320, r = 1..5
FWD_EDGES = (((3, 20, 20, 64), 2), ((2, 40, 100, 128), 5), ((1, 6, 72, 48), 5),
             ((3, 20, 20, 64), 1), ((3, 20, 20, 64), 3), ((2, 16, 64, 320), 5),
             ((1, 3, 5, 16), 5), ((2, 64, 64, 256), 4))
# the csub kernel's besides (it transposes them to (B, H, C, W)): bf16 stages
# by TMA where W % 8 == 0 and with plain loads elsewhere (W = 20, 100, 5, 12),
# keeps fm1 resident up to C = 512 and streams it past (576, 528), at every r
CSUB_EDGES = FWD_EDGES + (((1, 8, 40, 576), 3), ((1, 5, 12, 528), 2),
                          ((2, 12, 48, 64), 1), ((2, 9, 40, 32), 2))
# the band kernel's (local_corr_band.cu): (kind, (B, H, W, C), r). Band at
# the forward's edges, pdot at C = 48, 256 (a power-of-two scale, fm1 partly
# in registers, partly resident) and 320 (fm1 streamed in bf16), pack on slice
# pairs of widths 64, 20 (both slices in one block), 100 (a slice edge inside
# a block) and 8, the second slice of each pair `partner` times larger
BAND_EDGES = tuple(("band", shape, r) for shape, r in FWD_EDGES) + (
    ("pdot", (3, 20, 20, 48), 2), ("pdot", (2, 16, 64, 256), 5), ("pdot", (1, 9, 40, 320), 3),
    ("pack", (4, 16, 64, 32), 5), ("pack", (2, 20, 20, 64), 2), ("pack", (2, 6, 100, 48), 4),
    ("pack", (4, 9, 8, 16), 1))
BAND_PARTNER = {"float32": 300.0, "bfloat16": 30.0}
# the sweep kernels' (local_corr_sweep.cu, the band body's tiling: 4 rows x
# 64 queries in bf16, 32 in f32): W short of, past and off one strip (20,
# 100, 72, 24, 44, 36) and not a multiple of 4 (5, 18: scalar planar
# stores), C = 16, 48, 64, 128 and 320 (f32 in two channel groups), r = 1..5,
# H = 100 (25 rows of blocks), ragged H
SWEEP_EDGES = FWD_EDGES[:7] + (((2, 64, 24, 64), 1), ((2, 64, 24, 64), 3),
                               ((1, 100, 16, 64), 5), ((2, 12, 44, 48), 4),
                               ((1, 100, 36, 320), 4), ((2, 9, 18, 48), 2))


def log(msg: str) -> None:
    print(msg, flush=True)


def corr_bound(shape, r: int, dtype_name: str, backward: bool = False):
    """Least time (ms) for the local correlation (or its backward) on these
    inputs, what bounds it and the unit it divides by: each input read once,
    each output written once, over the HBM rate; the products that land
    inside the image (2·C FLOPs each, twice as many for the two gradients)
    over the fastest unit that keeps the dtype's accuracy — bf16 tensor
    cores for bf16, three TF32 tensor-core passes (3xTF32) for f32. One
    number per function, shape and dtype, whatever implements it."""
    B, H, W, C = shape
    itemsize = 2 if dtype_name == "bfloat16" else 4
    unit = "bf16 tensor cores" if dtype_name == "bfloat16" else "tf32 tensor cores"
    passes = 1 if dtype_name == "bfloat16" else 3
    d = 2 * r + 1
    # forward: fm1, fm2 in, out (d²) out; backward: g (d²), fm1, fm2 in,
    # dfm1, dfm2 out
    n_fm = 4 if backward else 2
    nbytes = (n_fm * B * H * W * C + B * H * W * d * d) * itemsize

    def valid(n):   # Σ over positions of the in-image shifts
        return sum(min(i + r, n - 1) - max(i - r, 0) + 1 for i in range(n))

    flops = passes * (2 if backward else 1) * 2.0 * B * C * valid(H) * valid(W)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[unit]
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations",
            unit)


def phase_build():
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from rpnet_tpu_torch.ops import kernels

    t0 = time.time()
    with ThreadPoolExecutor(len(KERNELS)) as pool:   # one nvcc per source
        list(pool.map(lambda k: kernels.build(k, verbose=True), KERNELS))
    for k in KERNELS:
        kernels.load(k)
    log(f"[build] {', '.join(KERNELS)} built for sm_90a in {time.time() - t0:.2f}s")
    plan = kernels.local_corr_bf16_plan(256, 5)
    log(f"[build] local_corr.cu bf16 design: TMA + wgmma (m64n32k16, one producer warp, "
        f"four consumer warpgroups, fm1 in registers), {plan['smem_bytes']} bytes of shared memory a block, "
        f"{plan['stages']} ring stages, {plan['blocks_per_sm']} block(s) an SM at C=256 r=5")
    fp = kernels.local_corr_f32_plan(256, 5)
    log(f"[build] local_corr.cu f32 design: TMA + wgmma m64n32k8 3xTF32 (one producer warp, "
        f"two splitter warps, two consumer warpgroups, 4 rows x 32 queries a block, of each "
        f"256 channels of fm1 128 in registers and 128 resident in shared memory); "
        f"{fp['smem_bytes']} bytes of shared memory a block, "
        f"{fp['blocks_per_sm']} block(s) an SM, {fp['registers']} registers a thread, "
        f"{fp['local_bytes']} bytes of local memory a thread (spills) at C=256 r=5")
    for dtype, design in ((torch.bfloat16, "TMA + wgmma m64n32k16 on MN-major operands "
                           "(one producer warp, two consumer warpgroups, 4 rows x 32 queries "
                           "a block, fm1 resident)"),
                          (torch.float32, "TMA + register-blocked FP32 FMAs (one producer "
                           "warp, 4 rows x 32 queries a block, a thread 2 queries x 4 rows "
                           "of one source row, 8 channels a stage)")):
        cp = kernels.local_corr_csub_plan(256, 5, dtype)
        log(f"[build] local_corr_csub.cu {'bf16' if dtype == torch.bfloat16 else 'f32'} "
            f"design: {design}; {cp['smem_bytes']} bytes of shared memory a block, "
            f"{cp['blocks_per_sm']} block(s) an SM, {cp['registers']} registers a thread, "
            f"{cp['local_bytes']} bytes of local memory a thread (spills) at C=256 r=5")
    for dtype, design in ((torch.bfloat16, "band, pdot, pack: TMA + wgmma m64n32k16 (one "
                           "producer warp, four consumer warpgroups, 4 rows x 64 queries a "
                           "block, of fm1's 256 channels 192 in registers and 64 resident in "
                           "shared memory)"),
                          (torch.float32, "band, pack: TMA + wgmma m64n32k8 3xTF32 (one "
                           "producer warp, two splitter warps, two consumer warpgroups, 4 rows "
                           "x 32 queries a block)")):
        bp = kernels.local_corr_band_plan(256, 5, dtype)
        log(f"[build] local_corr_band.cu {'bf16' if dtype == torch.bfloat16 else 'f32'} "
            f"design: {design}; {bp['smem_bytes']} bytes of shared memory a block, "
            f"{bp['blocks_per_sm']} block(s) an SM, {bp['registers']} registers a thread, "
            f"{bp['local_bytes']} bytes of local memory a thread (spills) at C=256 r=5")
    for kind, design in (("swapped", "corr_swapped: the band body (TMA + wgmma, bf16 m64n32k16, "
                          "f32 m64n32k8 3xTF32) writing f32 planes, in bf16 each source "
                          "row's band through a 16 x d slot a warp, in f32 from the NHWC "
                          "tile at the block's end"),
                         ("rotmxu", "corr_rotmxu: the band body, NHWC tile of d^2 lanes, "
                          "128 lanes zero-filled at the store")):
        for dtype in (torch.bfloat16, torch.float32):
            sp = kernels.local_corr_sweep_plan(kind, 256, 5, dtype)
            log(f"[build] local_corr_sweep.cu {'bf16' if dtype == torch.bfloat16 else 'f32'} "
                f"{design}; {sp['smem_bytes']} bytes of shared memory a block, "
                f"{sp['stages']} ring stages, {sp['blocks_per_sm']} block(s) an SM, "
                f"{sp['registers']} registers a thread, {sp['local_bytes']} bytes of local "
                "memory a thread (spills) at C=256 r=5")
    for bf16 in (False, True):
        bp = kernels.local_corr_bwd_plan(bf16, 5)
        log(f"[build] local_corr_bwd.cu {'bf16' if bf16 else 'f32'} design: transposed band "
            f"on {'mma.sync m16n8k16' if bf16 else 'wgmma m64n32k8 3xTF32'}, 4 rows x 32 "
            f"queries x 256 channels a block, 16 warps, 2-row cp.async ring, bands built "
            f"once a source row; "
            f"{bp['smem_bytes']} bytes of shared memory a block, {bp['blocks_per_sm']} "
            f"block(s) an SM, {bp['registers']} registers a thread, {bp['local_bytes']} "
            "bytes of local memory a thread (spills) at r=5")


def check_local_corr(shape, r: int, dtype, seed: int, timed: bool):
    """Kernel vs plain version on one input, on an output the caching
    allocator had filled with NaN (an element the kernel leaves unwritten
    shows); raises on disagreement."""
    import torch

    from rpnet_tpu_torch.ops.correlation import (local_correlation,
                                                 local_correlation_plain)
    from rpnet_tpu_torch.utils.timing import cuda_ms

    g = torch.Generator(device="cuda").manual_seed(seed)
    fm1 = torch.randn(shape, generator=g, device="cuda").to(dtype)
    fm2 = torch.randn(shape, generator=g, device="cuda").to(dtype)
    # poison: a block of the output's size, filled with NaN and freed, is
    # what the wrapper's torch.empty gets back
    poison = torch.full(shape[:3] + ((2 * r + 1) ** 2,), float("nan"), dtype=dtype,
                        device="cuda")
    del poison
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
        res["bound_ms"], res["bound_by"], res["bound_unit"] = corr_bound(shape, r, name)
    log(f"[kernels] local_correlation {json.dumps(res)} ({tol}: "
        f"{'ok' if ok else 'DISAGREES'})")
    if not ok or not math.isfinite(err):
        raise AssertionError(f"local_correlation kernel disagrees with its plain "
                             f"version at {shape} r={r} {name}: max err {err}")
    return res


def check_local_corr_bwd(shape, r: int, dtype, seed: int, timed: bool,
                         strided: bool = True):
    """Backward kernel vs plain version on one input, g a strided view of a
    concat gradient as the CRE hands it over (or contiguous), on outputs the
    caching allocator had filled with NaN (an element the kernel leaves
    unwritten shows); raises on disagreement."""
    import torch

    from rpnet_tpu_torch.ops.correlation import (local_correlation_bwd,
                                                 local_correlation_bwd_plain)
    from rpnet_tpu_torch.utils.timing import cuda_ms

    B, H, W, C = shape
    d2 = (2 * r + 1) ** 2
    gen = torch.Generator(device="cuda").manual_seed(seed)
    fm1 = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    fm2 = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    width = d2 + C if strided else d2
    g = torch.randn((B, H, W, width), generator=gen, device="cuda").to(dtype)[..., :d2]
    # poison: blocks of the outputs' size, filled with NaN and freed, are
    # what the wrapper's torch.empty_like gets back
    poison = [torch.full(shape, float("nan"), dtype=dtype, device="cuda") for _ in range(2)]
    del poison
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
    res = {"shape": list(shape), "r": r, "dtype": name, "max_abs_err": err,
           "g": "strided" if strided else "contiguous"}
    if timed:
        res["ms"] = cuda_ms(lambda: local_correlation_bwd(g, fm1, fm2, r), reps=20)
        res["plain_ms"] = cuda_ms(lambda: local_correlation_bwd_plain(g, fm1, fm2, r), reps=3)
        res["bound_ms"], res["bound_by"], res["bound_unit"] = corr_bound(
            shape, r, name, backward=True)
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


def variant_inputs(shape, dtype, seed: int, partner: float = 1.0):
    """fm1, fm2 (B, H, W, C) in ``dtype`` on the card from a seed, the second
    slice of each pair ``partner`` times larger, and those per-slice scales."""
    import torch

    B = shape[0]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    fm1 = torch.randn(shape, generator=gen, device="cuda")
    fm2 = torch.randn(shape, generator=gen, device="cuda")
    sc = torch.tensor([1.0, partner] * (B // 2) + [1.0] * (B % 2), device="cuda")
    fm1, fm2 = (x * sc[:, None, None, None] for x in (fm1, fm2))
    return fm1.to(dtype), fm2.to(dtype), sc


def variant_verdict(kind: str, out, ref, fm1, fm2, r: int, sc, res: dict):
    """Whether an opt-in forward's output ``out`` (and its plain version's
    ``ref``), both (B, H, W, d²), are right on the inputs of
    :func:`variant_inputs`; returns (ok, the tolerance's text) and adds what
    it measured to ``res``. Tolerances: f32 atol 1e-4 (times the slice
    scale² where the slices differ: 3xTF32 products, or f32 FMAs, summed in
    another order); bf16 kernel and plain version both within rtol 2**-7,
    atol 1e-3 of the f32 sum (one bf16 ulp); pdot both within 2**-6
    relative, atol 1e-3 of f32(S)·bf16(scale) (its two roundings)."""
    import torch

    from rpnet_tpu_torch.ops import correlation as tc

    C = fm1.shape[-1]
    dtype = fm1.dtype
    sums = tc._corr_sums(fm1.float(), fm2.float(), r)
    if kind == "pdot":
        scale_bf = float(torch.tensor(tc.correlation_scale(C), dtype=torch.bfloat16))
        exact = sums * scale_bf
        ok = all(torch.allclose(x.float(), exact, rtol=2 ** -6, atol=1e-3) for x in (out, ref))
        tol = "rtol 2**-6, atol 1e-3 of f32(S)*bf16(scale)"
        res["unequal_to_plain"] = (out != ref).float().mean().item()
        if C == 256:   # power-of-two scale: the select kernel's value
            sel = tc.local_correlation(fm1, fm2, r)
            torch.cuda.synchronize()
            res["unequal_to_select_kernel"] = (out != sel).float().mean().item()
            ok = ok and torch.allclose(out.float(), sel.float(), rtol=2 ** -7, atol=1e-3)
            ok = ok and torch.equal(ref, tc.local_correlation_plain(fm1, fm2, r))
    elif dtype == torch.bfloat16:
        f32 = sums * tc.correlation_scale(C)
        ok = all(torch.allclose(x.float(), f32, rtol=2 ** -7, atol=1e-3) for x in (out, ref))
        tol = "rtol 2**-7, atol 1e-3 of the f32 sum"
    else:
        slice_sq = (sc ** 2)[:, None, None, None]
        err_scaled = ((out - ref).abs() / slice_sq).max().item()
        ok = err_scaled <= 1e-4
        tol = "atol 1e-4" + (" x slice scale²" if bool((sc != 1).any()) else "")
        if kind == "pack":   # the packed function is the unpacked one
            direct = tc.local_correlation_plain(fm1, fm2, r)
            ok = ok and ((out - direct).abs() / slice_sq).max().item() <= 1e-4
    return ok, tol


def check_variant(kind: str, shape, r: int, dtype, seed: int, timed: bool,
                  partner: float = 1.0):
    """An opt-in forward's kernel vs its plain version on one input, through
    the wrapper that launches it: ``band`` and ``pdot`` on (B, H, W, C),
    ``pack`` on slice pairs packed to (B/2, H, 2W, C) (the second slice of
    each pair ``partner`` times larger), ``csub`` on (B, H, C, W), with the
    tolerances of :func:`variant_verdict`. Raises on disagreement."""
    import torch

    from rpnet_tpu_torch.ops import correlation as tc
    from rpnet_tpu_torch.utils.timing import cuda_ms

    W = shape[2]
    fm1, fm2, sc = variant_inputs(shape, dtype, seed, partner)
    # poison: a block of the output's size, filled with NaN and freed, is
    # what the wrapper's torch.empty gets back
    poison = torch.full(shape[:3] + ((2 * r + 1) ** 2,), float("nan"), dtype=dtype,
                        device="cuda")
    del poison
    if kind == "pack":
        args = (tc.pack_pairs(fm1), tc.pack_pairs(fm2), r, W)
        kernel, plain = tc.local_correlation_packed, tc.local_correlation_packed_plain
        unpack = tc.unpack_pairs
    elif kind == "csub":
        args = (fm1.transpose(2, 3).contiguous(), fm2.transpose(2, 3).contiguous(), r)
        kernel, plain, unpack = tc.local_correlation_csub, tc.local_correlation_csub_plain, None
    else:
        args = (fm1, fm2, r)
        kernel = {"band": tc.local_correlation_band, "pdot": tc.local_correlation_pdot}[kind]
        plain = {"band": tc.local_correlation_plain, "pdot": tc.local_correlation_pdot_plain}[kind]
        unpack = None
    out, ref = kernel(*args), plain(*args)
    if unpack is not None:
        out, ref = unpack(out), unpack(ref)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    name = str(dtype).replace("torch.", "")
    res = {"shape": list(shape), "r": r, "dtype": name, "max_abs_err": err}
    ok, tol = variant_verdict(kind, out, ref, fm1, fm2, r, sc, res)
    wrapper = kernel.__name__
    if timed:
        res["ms"] = cuda_ms(lambda: kernel(*args), reps=20)
        res["plain_ms"] = cuda_ms(lambda: plain(*args), reps=3)
        res["bound_ms"], res["bound_by"], res["bound_unit"] = corr_bound(shape, r, name)
        if kind in ("pack", "csub"):   # with the layout change the route adds
            fwd = tc.FORWARDS[kind]
            res["route_ms"] = cuda_ms(lambda: fwd(fm1, fm2, r), reps=20)
    log(f"[kernels] {wrapper} {json.dumps(res)} ({tol}: {'ok' if ok else 'DISAGREES'})")
    if not ok or not math.isfinite(err):
        raise AssertionError(f"{wrapper} kernel disagrees with its plain version at "
                             f"{shape} r={r} {name}: max err {err}")
    return res


def check_sweep_kernel(kind: str, shape, r: int, dtype, seed: int, timed: bool,
                       h_tile: int = 16, full_lanes: bool = False, out_f32: bool = True):
    """One of the kernel sweep's own kernels vs its plain version, through its
    wrapper (``bench_tools.corr_sweep``): ``swapped`` (planar f32, transposed
    and cast by the wrapper) at ``h_tile`` rows a block, ``rotmxu`` with
    ``full_lanes`` / ``out_f32``. The caching allocator's free blocks are
    filled with NaN first, so an output element the kernel leaves unwritten
    (a padding lane, a ragged edge) shows. Tolerances as check_variant's;
    full_lanes padding must be exactly zero. Raises on disagreement."""
    import torch

    from rpnet_tpu_torch.bench_tools import corr_sweep as cs
    from rpnet_tpu_torch.ops.correlation import local_correlation_plain
    from rpnet_tpu_torch.utils.timing import cuda_ms

    B, H, W, C = shape
    d2 = (2 * r + 1) ** 2
    gen = torch.Generator(device="cuda").manual_seed(seed)
    fm1 = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    fm2 = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    if kind == "swapped":
        kernel = lambda: cs.corr_swapped(fm1, fm2, r, h_tile=h_tile)  # noqa: E731
        plain = lambda: cs.corr_swapped_plain(fm1, fm2, r, h_tile=h_tile)  # noqa: E731
        sizes = [((B, d2, H, W), torch.float32), ((B, H, W, d2), dtype)]   # planar, result
    else:
        kernel = lambda: cs.corr_rotmxu(fm1, fm2, r, full_lanes=full_lanes,  # noqa: E731
                                        out_f32=out_f32)
        plain = lambda: cs.corr_rotmxu_plain(fm1, fm2, r, full_lanes=full_lanes,  # noqa: E731
                                             out_f32=out_f32)
        sizes = [((B, H, W, 128 if full_lanes else d2), dtype)]
    # poison: blocks of the output sizes, filled with NaN and freed, are what
    # the wrapper's torch.empty gets back
    poison = [torch.full(s_, float("nan"), dtype=t, device="cuda") for s_, t in sizes]
    del poison
    out, ref = kernel(), plain()
    torch.cuda.synchronize()
    pad_ok = True
    if kind == "rotmxu" and full_lanes:
        pad_ok = bool((out[..., d2:] == 0).all()) and bool((ref[..., d2:] == 0).all())
        out, ref = out[..., :d2], ref[..., :d2]
    err = (out.float() - ref.float()).abs().max().item()
    name = str(dtype).replace("torch.", "")
    if dtype == torch.bfloat16:
        f32_sum = local_correlation_plain(fm1.float(), fm2.float(), r)
        ok = all(torch.allclose(x.float(), f32_sum, rtol=2 ** -7, atol=1e-3) for x in (out, ref))
        tol = "rtol 2**-7, atol 1e-3 of the f32 sum"
    else:
        ok = err <= 1e-4
        tol = "atol 1e-4"
    ok = ok and pad_ok and out.dtype == dtype
    res = {"shape": list(shape), "r": r, "dtype": name, "max_abs_err": err}
    res.update({"h_tile": h_tile} if kind == "swapped" else
               {"full_lanes": full_lanes, "out_f32": out_f32, "padding_zero": pad_ok})
    if timed:
        res["ms"] = cuda_ms(kernel, reps=20)
        res["plain_ms"] = cuda_ms(plain, reps=3)
        res["bound_ms"], res["bound_by"], res["bound_unit"] = corr_bound(shape, r, name)
    if timed and kind == "swapped":   # the kernel alone, on its planar f32 output
        from rpnet_tpu_torch.ops import kernels
        from rpnet_tpu_torch.ops.correlation import correlation_scale

        planar = torch.empty((B, d2, H, W), dtype=torch.float32, device="cuda")
        res["kernel_ms"] = cuda_ms(lambda: kernels.launch_local_corr_sweep(
            "swapped", fm1, fm2, planar, r, h_tile, correlation_scale(C)), reps=20)
    wrapper = f"corr_{kind}"
    log(f"[sweep-kernels] {wrapper} {json.dumps(res)} ({tol}: {'ok' if ok else 'DISAGREES'})")
    if not ok or not math.isfinite(err):
        raise AssertionError(f"{wrapper} kernel disagrees with its plain version at "
                             f"{shape} r={r} {name}: max err {err}, padding zero {pad_ok}")
    return res


def phase_sweep_kernels():
    """Rows 8 and 9 (the kernel sweep's own kernels) against their plain
    versions: at the sweep shape in both dtypes, every h_tile of corr_swapped
    (timed as the kernel alone and through the wrapper) and every output
    option of corr_rotmxu; then at ``SWEEP_EDGES`` in both dtypes, corr_rotmxu
    with d² and with 128 lanes. Returns the timed results, keyed (kind,
    dtype name)."""
    import torch

    bf16, f32 = torch.bfloat16, torch.float32
    timed = {}
    for i, dtype in enumerate((bf16, f32)):
        name = str(dtype).replace("torch.", "")
        timed[("swapped", name)] = check_sweep_kernel("swapped", SWEEP_SHAPE, 5, dtype,
                                                      seed=40 + i, timed=True)
        timed[("rotmxu", name)] = check_sweep_kernel("rotmxu", SWEEP_SHAPE, 5, dtype,
                                                     seed=42 + i, timed=True)
        timed[("rotmxu full_lanes", name)] = check_sweep_kernel(
            "rotmxu", SWEEP_SHAPE, 5, dtype, seed=44 + i, timed=True, full_lanes=True)
        for ht in (8, 32):
            check_sweep_kernel("swapped", SWEEP_SHAPE, 5, dtype, seed=46 + i, timed=False,
                               h_tile=ht)
        check_sweep_kernel("rotmxu", SWEEP_SHAPE, 5, dtype, seed=48 + i, timed=False,
                           out_f32=False)
        check_sweep_kernel("rotmxu", SWEEP_SHAPE, 5, dtype, seed=50 + i, timed=False,
                           full_lanes=True, out_f32=False)
    for i, (shape, r) in enumerate(SWEEP_EDGES):
        for j, dtype in enumerate((bf16, f32)):
            check_sweep_kernel("swapped", shape, r, dtype, seed=60 + 4 * i + j, timed=False,
                               h_tile=(8, 16, 32)[(i + j) % 3])
            for full in (False, True):
                check_sweep_kernel("rotmxu", shape, r, dtype, seed=62 + 4 * i + j, timed=False,
                                   full_lanes=full, out_f32=i % 2 == 0)
    return timed


def phase_sweep():
    """The kernel sweep (``python -m rpnet_tpu_torch.bench_tools.corr_sweep``)
    at its shape, 32x64x64x256 r=5, with the launch counts set to 0 just
    before and read just after: no line may fail or miss its tolerance, and
    every kernel of the sweep must have launched as often as its lines
    call it (once checked, then 2 warm-up + 3 rounds of 20 timed calls)."""
    from rpnet_tpu_torch.bench_tools import corr_sweep

    per_line = 1 + 2 + 3 * 20
    expect = {"local_correlation": 3 * per_line, "local_correlation_band": 2 * per_line,
              "local_correlation_csub": 2 * per_line, "corr_swapped": 4 * per_line,
              "corr_rotmxu": 4 * per_line, "local_correlation_bwd": per_line}
    saved = {k: os.environ.pop(k, None) for k in ("SWEEP_ONLY", "SWEEP_BWD_ONLY")}
    try:
        reset_launches()
        t0 = time.time()
        failures = corr_sweep.main(SWEEP_SHAPE, 5)
        launches = read_launches()
    finally:
        os.environ.update({k: v for k, v in saved.items() if v is not None})
    log(f"[sweep] {time.time() - t0:.1f}s, failed lines {failures}, launches {launches}")
    if failures:
        raise AssertionError(f"kernel sweep lines failed: {failures}")
    if launches != expect:
        raise AssertionError(f"kernel sweep launches {launches}, expected {expect}")
    return launches


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


def _wrappers():
    from rpnet_tpu_torch.bench_tools import corr_sweep
    from rpnet_tpu_torch.ops import correlation as tc

    return ([getattr(tc, name) for name in WRAPPERS]
            + [getattr(corr_sweep, name) for name in SWEEP_WRAPPERS])


def reset_launches():
    for fn in _wrappers():
        fn.launches = 0


def read_launches():
    return {fn.__name__: fn.launches for fn in _wrappers() if fn.launches}


class switched:
    """The RPNET_* correlation switches set for a block, then restored."""

    def __init__(self, env):
        self.env = env

    def __enter__(self):
        self.saved = {k: os.environ.pop(k, None) for k in
                      ("RPNET_CORR_IMPL", "RPNET_ROT_EXTRACT", "RPNET_ROT_PACK")}
        os.environ.update(self.env)

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            os.environ.pop(k, None)
            if v is not None:
                os.environ[k] = v


class recorded_episodes:
    """Every episode's metrics as the CLI settles it (``EpisodeRunner.finalize``
    wrapped: it runs after the episode's own wait, so it adds no sync)."""

    def __enter__(self):
        from rpnet_tpu_torch.episode import pipeline

        self.cls, self.orig, results = pipeline.EpisodeRunner, pipeline.EpisodeRunner.finalize, []
        orig = self.orig

        def finalize(runner, d):
            results.append(orig(runner, d))
            return results[-1]

        self.cls.finalize = finalize
        return results

    def __exit__(self, *exc):
        self.cls.finalize = self.orig


def run_eval_cli(yaml_path, env=None, hook=True):
    """The eval CLI under the switches ``env``, launch counts set to 0 just
    before and read just after, every episode's metrics recorded; with
    ``hook``, also each model call's refinement masks, every iteration, and
    its first iteration's logits (a global forward hook, which fetches them
    to the host; the CLI is untouched). No failed episode, every Dice
    finite."""
    import torch

    from rpnet_tpu_torch.cli import test_rpnet
    from rpnet_tpu_torch.models.rpnet import RPNet

    masks, logits = [], []

    def record(module, args, out):
        if isinstance(module, RPNet):
            ref = out["refinement"]
            masks.append((ref[..., 1] > ref[..., 0]).cpu())
            logits.append(ref[0].float().cpu())

    handle = torch.nn.modules.module.register_module_forward_hook(record) if hook else None
    try:
        with switched(env or {}), recorded_episodes() as episodes:
            reset_launches()
            t0 = time.time()
            results = test_rpnet.main(["--yaml", yaml_path])
            torch.cuda.synchronize()
            launches = read_launches()
    finally:
        if handle is not None:
            handle.remove()
    results["wall"] = time.time() - t0
    n_eps = results["episodes"]
    if results["failed_episodes"]:
        raise AssertionError(f"{yaml_path}: {results['failed_episodes']} of {n_eps} "
                             "episodes failed")
    for cls, r in results["classes"].items():
        vals = r["affine"] + r["fewshot"] + [v for mv in r["refinement"].values() for v in mv]
        if len(r["refinement"]) != 10 or not all(math.isfinite(v) for v in vals):
            raise AssertionError(f"{yaml_path} {cls}: non-finite or missing Dice {r}")
    return results, launches, (masks, logits), episodes


def phase_main_path(yaml_path):
    results, launches, outputs, episodes = run_eval_cli(yaml_path)
    n_eps = results["episodes"]
    if n_eps < 3:
        raise AssertionError(f"only {n_eps} episodes ran")
    for cls, r in results["classes"].items():
        log(f"[main] {cls}: dice affine {r['affine'][0]:.4f}, fewshot "
            f"{r['fewshot'][0]:.4f}, ref 9 {r['refinement'][9][0]:.4f}")
    if launches != {"local_correlation": 11 * n_eps}:
        raise AssertionError(f"correlation launches {launches} in {n_eps} episodes; "
                             f"expected {11 * n_eps} of local_correlation only")
    log(f"[main] {n_eps} episodes, {results['episodes_per_sec']:.3f} episodes/s "
        f"(first pass, includes warm-up; CLI wall {results['wall']:.1f}s), "
        f"launches {launches}")
    return results, launches, outputs, episodes


def phase_eval_switches(yaml_path, dq, default_outputs):
    """The eval CLI under each opt-in forward, on the main path's episodes and
    weights: 11 launches per episode of the selected kernel (under pack, the
    episodes with an odd slice count run select), no failed episode, the
    refinement masks of every iteration agreeing with the default pass on
    more than 99.9% of pixels. The first iteration's logits are compared
    too, as a measurement: the masks of random weights empty out over the
    iterations, and an empty mask zeroes the correlation's input, so later
    iterations cannot tell the kernels apart."""
    default_masks, default_logits = default_outputs
    out = {}
    for label, (env, wrapper) in EVAL_SWITCHES.items():
        results, launches, (masks, logits), _ = run_eval_cli(yaml_path, env)
        n_eps = results["episodes"]
        if label == "pack":
            expect = {wrapper: 11 * sum(b % 2 == 0 for b in dq[:n_eps]),
                      "local_correlation": 11 * sum(b % 2 for b in dq[:n_eps])}
            expect = {k: v for k, v in expect.items() if v}
        else:
            expect = {wrapper: 11 * n_eps}
        if launches != expect:
            raise AssertionError(f"{label}: launches {launches}, expected {expect}")
        same = sum(int((a == b).sum()) for a, b in zip(masks, default_masks))
        total = sum(a.numel() for a in default_masks)
        agree = same / total
        fg = sum(int(a.sum()) for a in default_masks) / total
        dlogit = max(float((a - b).abs().max()) for a, b in zip(logits, default_logits))
        scale = max(float(b.abs().max()) for b in default_logits)
        log(f"[eval-{label}] {n_eps} episodes, {results['episodes_per_sec']:.3f} "
            f"episodes/s (CLI wall {results['wall']:.1f}s), launches {launches}, "
            f"refinement masks agree with the default pass on {agree:.6f} of {total} "
            f"pixels (foreground share of the default masks {fg:.4f}); first "
            f"iteration's logits differ by at most {dlogit:.4g} (largest |logit| "
            f"{scale:.4g})")
        if len(masks) != len(default_masks) or not agree > 0.999:
            raise AssertionError(f"{label}: masks agree on {agree} of the pixels")
        out[label] = launches
    return out


# phase 3c: the eval CLI's data paths (the example's defaults take the spec
# path); each runs DATA_PATH_RUNS passes, the later ones warm
DATA_PATHS = {"spec": {}, "prefetch": {"device_volume_cache": 0, "num_workers": 4},
              "plain": {"device_volume_cache": 0, "num_workers": 0}}
DATA_PATH_RUNS = 3
# phase 3d: eval breadth, 2 episodes each; (Wa, Sh) of the network's supports
BREADTH = {"vgg": ({"backbone": "vgg", "scale": 8}, (1, 1)),
           "resnet": ({"backbone": "resnet", "scale": 4}, (1, 1)),
           "mask_x2": ({"mask_feature_map": "x2"}, (1, 1)),
           "concat": ({"use_relation_enc": "concat"}, (1, 1)),
           "multishot": ({"use_all_supports": True, "multishot_fusion": True, "n_shot": 2,
                          "n_way": 2}, (2, 2))}


def run_cli_config(cfg, label, **kw):
    """:func:`run_eval_cli` without the hook on ``cfg`` updated by ``kw``
    (its own out_dir) → (results, launches, episodes, the passes'
    (stage_timing, pass_wall) lines from its log)."""
    import yaml

    out_dir = os.path.join(WORK, f"out_{label}")
    path = os.path.join(WORK, f"eval_{label}.yml")
    with open(path, "w") as f:
        yaml.safe_dump(dict(cfg, out_dir=out_dir, **kw), f)
    results, launches, _, episodes = run_eval_cli(path, hook=False)
    with open(os.path.join(out_dir, "log_eval")) as f:
        lines = [l.strip() for l in f]
    passes = list(zip([l for l in lines if l.startswith("stage_timing")],
                      [l for l in lines if l.startswith("pass_wall")]))
    return results, launches, episodes, passes


def phase_data_paths(cfg):
    """The eval CLI on the main path's episodes and weights on each data path,
    ``DATA_PATH_RUNS`` passes: the spec path (the example's defaults: device
    volume cache 16), the prefetch path (cache 0, num_workers 4) and the
    plain host path (cache 0, num_workers 0). Every episode's metrics equal
    across the paths, 11 launches an episode, no failure; the warm passes'
    episodes/s and stage_timing logged. Then a warm episode queued on each of
    the spec and host paths under ``torch.cuda.set_sync_debug_mode("warn")``:
    no synchronizing call (whether the episode was still running when the
    call returned is logged: a device that keeps up with the host's enqueue
    may have run all of it). Then one warm spec episode profiled."""
    per_path, launches_all = {}, {}
    for label, kw in DATA_PATHS.items():
        results, launches, episodes, passes = run_cli_config(
            cfg, f"data_{label}", n_runs=DATA_PATH_RUNS, **kw)
        n_eps = results["episodes"]
        expect = {"local_correlation": 11 * n_eps}
        if launches != expect:
            raise AssertionError(f"data path {label}: launches {launches}, expected {expect}")
        per_path[label] = episodes
        launches_all[label] = launches
        n_pass = n_eps // DATA_PATH_RUNS
        for i, (timing, wall) in enumerate(passes):
            secs = float(wall.split()[1].rstrip("s"))
            log(f"[data-{label}] pass {i + 1}{' (warm)' if i else ''}: "
                f"{n_pass / secs:.3f} episodes/s, {wall}; {timing}")
        log(f"[data-{label}] {n_eps} episodes in {DATA_PATH_RUNS} passes, CLI wall "
            f"{results['wall']:.1f}s, launches {launches}")
    ref = per_path["plain"]
    for label, episodes in per_path.items():
        if episodes != ref:
            diff = next(i for i, (a, b) in enumerate(zip(episodes, ref)) if a != b) \
                if len(episodes) == len(ref) else "count"
            raise AssertionError(f"data path {label}: episode metrics differ from the plain "
                                 f"path's (first at {diff})")
    log(f"[data] every episode's metrics equal on the spec, prefetch and plain paths "
        f"({len(ref)} episodes each)")
    check_dispatch_does_not_block(cfg)
    return launches_all


def check_dispatch_does_not_block(cfg, tag: str = "data", host: bool = True):
    """One warm episode queued on the spec and (with ``host``) on the host
    path under the sync debug mode, then one warm spec episode profiled;
    logged under ``[tag-sync]`` and ``[tag-profile]``. Returns the profile's
    device operations."""
    import warnings

    import torch

    from rpnet_tpu_torch.cli.test_rpnet import build_runner
    from rpnet_tpu_torch.config import Config
    from rpnet_tpu_torch.episode.sampler import EpisodeSampler

    config = Config(cfg)
    config = config.replace(n_iter_refinement=config["n_test_iter_refinement"])
    runner = build_runner(config, torch.device("cuda"))
    sampler = EpisodeSampler(config["data_dir"], config["eval_set_name"], config)
    picks = sampler.draw_supports(1)
    spec = sampler.sample_spec(1, picks=picks)
    ep = sampler.sample(1, picks=picks)

    def synchronizing_calls(fn):
        """fn() under the sync debug mode → (its result, the synchronizing
        calls it made, host ms)."""
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                t0 = time.perf_counter()
                out = fn()
                host_ms = (time.perf_counter() - t0) * 1e3
            finally:
                torch.cuda.set_sync_debug_mode(0)
        # (setting the mode itself warns that it is a prototype)
        return out, [str(w.message) for w in caught
                     if "called a synchronizing" in str(w.message)], host_ms

    # the control: a known synchronizing call is seen
    _, control, _ = synchronizing_calls(lambda: torch.ones(1, device="cuda").item())
    if not control:
        raise AssertionError("the sync debug mode did not see .item()")
    log(f"[{tag}-sync] control: .item() under the sync debug mode seen as {len(control)} "
        "synchronizing call(s)")
    queues = [("spec", lambda: runner.dispatch_spec(spec, sampler))]
    if host:
        queues.append(("host", lambda: runner.dispatch(ep)))
    for label, queue in queues:
        runner.finalize(queue())   # warm: first-use builds and allocations
        torch.cuda.synchronize()
        d, syncs, host_ms = synchronizing_calls(queue)
        running = not d.done.query()
        t1 = time.perf_counter()
        runner.finalize(d)
        wait_ms = (time.perf_counter() - t1) * 1e3
        log(f"[{tag}-sync] {label} dispatch: {host_ms:.1f} ms on the host, episode still "
            f"running when it returned: {running}, then {wait_ms:.1f} ms to its result; "
            f"synchronizing calls in the dispatch: {len(syncs)}")
        if syncs:
            raise AssertionError(f"{label} dispatch blocks the host: {syncs[:3]}")
    # where a warm spec episode's time goes: dispatch (the host's enqueue)
    # and settle, profiled
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()   # (after the profiler's own start)
        runner.finalize(runner.dispatch_spec(spec, sampler))
        wall_ms = (time.perf_counter() - t0) * 1e3
    return log_device_profile(f"{tag}-profile", "one warm spec episode (dispatch + settle)",
                              prof, wall_ms)


def phase_breadth(cfg, paths):
    """The eval CLI at 256² under each ``BREADTH`` configuration on 2
    episodes: Wa·Sh + 10 launches of local_correlation an episode (none under
    concat), no failed episode, every Dice finite."""
    with open(paths["test_csv"]) as f:
        pids = [l.strip() for l in f if l.strip()][:2]
    split = os.path.join(WORK, "breadth_test.csv")
    with open(split, "w") as f:
        f.write("\n".join(pids) + "\n")
    out = {}
    for label, (kw, (Wa, Sh)) in BREADTH.items():
        results, launches, _, passes = run_cli_config(
            cfg, f"breadth_{label}", eval_set_name=split, n_runs=1, **kw)
        n_eps = results["episodes"]
        expect = {} if kw.get("use_relation_enc") == "concat" else \
            {"local_correlation": (Wa * Sh + 10) * n_eps}
        r = next(iter(results["classes"].values()))
        log(f"[breadth-{label}] {n_eps} episodes, {results['episodes_per_sec']:.3f} "
            f"episodes/s (cold, CLI wall {results['wall']:.1f}s), dice affine "
            f"{r['affine'][0]:.4f}, fewshot {r['fewshot'][0]:.4f}, launches {launches}; "
            f"{passes[0][0]}")
        if n_eps != 2 or launches != expect:
            raise AssertionError(f"breadth {label}: {n_eps} episodes, launches {launches}, "
                                 f"expected {expect}")
        out[label] = launches
    return out


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
    from rpnet_tpu_torch.train.convert import load_into, load_torch_checkpoint

    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.time()
    res = train_cli.main(["--yaml", yaml_path, "--epochs", "1",
                          "--episodes-per-epoch", str(TRAIN_EPISODES)])
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = read_launches()
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


def phase_train_switches(cfg, default_first_loss: float):
    """The train CLI for 2 steps under each opt-in forward, from the same
    seed as the training path: 5 forward launches of the selected kernel and
    5 of the backward per step, finite losses, and the first step's loss
    within 1e-3 relative of the default route's."""
    import torch
    import yaml

    from rpnet_tpu_torch.cli import train as train_cli

    out = {}
    for label, (env, wrapper) in TRAIN_SWITCHES.items():
        vcfg = dict(cfg, out_dir=os.path.join(WORK, f"train_out_{label}"))
        path = os.path.join(WORK, f"example_train_{label}.yml")
        with open(path, "w") as f:
            yaml.safe_dump(vcfg, f)
        with switched(env):
            reset_launches()
            t0 = time.time()
            res = train_cli.main(["--yaml", path, "--epochs", "1", "--episodes-per-epoch",
                                  str(VARIANT_TRAIN_EPISODES)])
            torch.cuda.synchronize()
            launches = read_launches()
        steps = len(res["step_losses"])
        expect = {wrapper: 5 * steps, "local_correlation_bwd": 5 * steps}
        first = res["step_losses"][0]
        rel = abs(first - default_first_loss) / abs(default_first_loss)
        log(f"[train-{label}] {steps} steps: losses {res['step_losses']} (first vs "
            f"default route {rel:.2e} relative, limit 1e-3), seconds between steps "
            f"{res['step_seconds']}, CLI wall {time.time() - t0:.1f}s, launches {launches}")
        if steps != 2 or launches != expect:
            raise AssertionError(f"{label}: {steps} steps, launches {launches}, "
                                 f"expected {expect}")
        if not (all(math.isfinite(v) for v in res["step_losses"]) and rel <= 1e-3):
            raise AssertionError(f"{label}: losses {res['step_losses']} vs default "
                                 f"first loss {default_first_loss}")
        out[label] = launches
    return out


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

    log_device_profile("train-profile", "one warm step", prof, wall_ms)


def log_device_profile(tag: str, what: str, prof, wall_ms: float):
    """Device time by kernel group (correlation, cuDNN convolutions, other),
    the device operations run, the busy share of ``wall_ms`` and the top ten
    kernels of a ``torch.profiler`` run (a measurement; nothing is
    checked)."""
    import torch

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
    n_ops = sum(e.count for e in events)
    log(f"[{tag}] {what}: wall {wall_ms:.2f} ms, device time {total:.2f} ms (busy share "
        f"{total / wall_ms:.3f}) in {n_ops} device operations; "
        "by group " + json.dumps({k: round(v, 3) for k, v in groups.items()}))
    for e in top:
        log(f"[{tag}]   {dev_ms(e):9.3f} ms  {e.count:5d}x  {e.key[:90]}")
    return n_ops


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


def phase_reference(backbone: str = "UNet"):
    """Full-width model on the card (kernel) vs on the CPU (plain), f32."""
    import numpy as np
    import torch

    from rpnet_tpu_torch.models.factory import build_rpnet

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = {"mask_refinement_correlation_radius": 5, "backbone": backbone,
           "scale": 8 if backbone == "vgg" else 4}
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
    log(f"[reference] full-width {backbone} model, 3 iterations, 2x64x64: card vs CPU "
        f"max |logit diff| {err:.2e} (atol 2e-3), mask agreement {agree:.5f}")
    if not (err <= 2e-3 and agree > 0.999):
        raise AssertionError("the model on the card disagrees with the CPU reference")


def measure_bf16_rounding():
    """The price on the card of bf16 eval rounding as the JAX package does
    (a measurement; nothing is checked): the port's BatchNorm2d and Conv2d
    in bf16 eval (per-op roundings) against torch's fused eval batch norm
    and fused conv bias on the same tensors, at the eval encoder's first
    and last levels (2 × 26 slices)."""
    import torch
    import torch.nn.functional as F

    from rpnet_tpu_torch.models.blocks import BatchNorm2d, Conv2d
    from rpnet_tpu_torch.utils.timing import cuda_ms

    for shape in ((52, 256, 256, 64), (52, 32, 32, 256)):
        C = shape[-1]
        gen = torch.Generator(device="cuda").manual_seed(5)
        x = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
        bn = BatchNorm2d(C).eval().to("cuda", torch.bfloat16)
        conv = Conv2d(C, C, 3, padding=1).eval().to("cuda", torch.bfloat16)
        with torch.no_grad():
            ms = {
                "bn per-op": cuda_ms(lambda: bn(x), reps=10),
                "bn fused": cuda_ms(lambda: F.batch_norm(
                    x.permute(0, 3, 1, 2), bn.running_mean, bn.running_var, bn.weight,
                    bn.bias, False, 0.0, bn.eps), reps=10),
                "conv + bias add": cuda_ms(lambda: conv(x), reps=10),
                "conv fused bias": cuda_ms(lambda: F.conv2d(
                    x.permute(0, 3, 1, 2), conv.weight, conv.bias, padding=1), reps=10),
            }
        log(f"[bf16-rounding] {list(shape)}: " + ", ".join(f"{k} {v:.4f} ms" for k, v in ms.items()))


# ---------------------------------------------------------------------------
# grid_sample on the card (phase 2d), the registration stage (phase 3r) and
# the deformable / whole-volume paths (phases 3e, 3f, 5c)
# ---------------------------------------------------------------------------


def grid_sample_jax_formula(x, grid):
    """The JAX package's gather formula (rpnet_tpu/ops/sampling.py:38-77:
    bilinear, zero padding, align_corners=False, unnormalized as
    ((x + 1)·S − 1)/2) in plain torch ops: x (N, C, H, W), grid (N, Hg, Wg,
    2) → (N, C, Hg, Wg). Differentiable in x and grid as the JAX one is."""
    import torch

    N, C, H, W = x.shape
    ix = ((grid[..., 0] + 1.0) * W - 1.0) * 0.5
    iy = ((grid[..., 1] + 1.0) * H - 1.0) * 0.5
    x0, y0 = torch.floor(ix), torch.floor(iy)
    wx1, wy1 = ix - x0, iy - y0
    flat = x.reshape(N, C, H * W)
    out = 0
    for yy, wy in ((y0, 1.0 - wy1), (y0 + 1.0, wy1)):
        for xx, wx in ((x0, 1.0 - wx1), (x0 + 1.0, wx1)):
            valid = ((xx >= 0) & (xx <= W - 1) & (yy >= 0) & (yy <= H - 1)).to(x.dtype)
            idx = (yy.clamp(0, H - 1) * W + xx.clamp(0, W - 1)).long().reshape(N, 1, -1)
            vals = torch.gather(flat, 2, idx.expand(N, C, -1))
            out = out + vals * (wy * wx * valid).reshape(N, 1, -1)
    return out.reshape(N, C, grid.shape[1], grid.shape[2])


def knife_edge_coords(size: int):
    """Normalized coordinates whose unnormalized index is an exact integer
    or half-integer (from −1 to size), and the f32 neighbours 1 ulp either
    side of each."""
    import torch

    i = torch.arange(-1, size + 1, dtype=torch.float64)
    base = torch.cat([(2 * i + 1) / size - 1, (2 * i + 2) / size - 1]).float()
    return torch.cat([base, torch.nextafter(base, base + 1), torch.nextafter(base, base - 1)])


def check_grid_sample():
    """Phase 2d: ``F.grid_sample`` (bilinear, zeros, align_corners=False,
    f32) on the card against :func:`grid_sample_jax_formula` on the card, at
    every pair of knife-edge coordinates for S = 64 (exact in f32) and
    S = 48 (not): values within 1e-5, the input's gradient within 1e-4
    (summed in another order, atomics), the grid's gradient within 1e-6 of
    its largest entry at every point (at an exact-integer index the
    derivative is one-sided: an index one rounding away would take the
    other side, and no point may). The CPU's ``F.grid_sample`` against the
    formula on the CPU is logged beside it."""
    import torch
    import torch.nn.functional as F

    out = {}
    for size in (64, 48):
        c = knife_edge_coords(size)
        gy, gx = torch.meshgrid(c, c, indexing="ij")
        grid = torch.stack([gx, gy], -1)[None]                  # (1, n, n, 2)
        gen = torch.Generator().manual_seed(size)
        x = torch.rand((1, 2, size, size), generator=gen)
        g = torch.randn((1, 2) + grid.shape[1:3], generator=gen)
        res = {}
        for dev in ("cuda", "cpu"):
            per = []
            for fn in (lambda a, b: F.grid_sample(a, b, mode="bilinear", padding_mode="zeros",
                                                  align_corners=False),
                       grid_sample_jax_formula):
                a = x.to(dev).clone().requires_grad_(True)
                b = grid.to(dev).clone().requires_grad_(True)
                y = fn(a, b)
                y.backward(g.to(dev))
                per.append((y.detach().cpu(), a.grad.cpu(), b.grad.cpu()))
            (y0, dx0, dg0), (y1, dx1, dg1) = per
            flips = ((dg0 - dg1).abs() > 1e-3 * dg1.abs().max()).any(-1)
            res[dev] = {"values": float((y0 - y1).abs().max()),
                        "input_grad": float((dx0 - dx1).abs().max()),
                        "grid_grad": float((dg0 - dg1).abs().max()),
                        "grid_grad_scale": float(dg1.abs().max()),
                        "grid_grad_points_apart": int(flips.sum()),
                        "points": int(flips.numel())}
        log(f"[grid_sample] S={size}, {res['cuda']['points']} knife-edge points: card "
            f"{json.dumps(res['cuda'])}; CPU {json.dumps(res['cpu'])}")
        r = res["cuda"]
        if not (r["values"] <= 1e-5 and r["input_grad"] <= 1e-4
                and r["grid_grad"] <= 1e-6 * r["grid_grad_scale"]
                and r["grid_grad_points_apart"] == 0):
            raise AssertionError(f"F.grid_sample on the card disagrees with the JAX formula: {r}")
        out[size] = res
    return out


def check_affine_sharp():
    """Phase 2d, second part: the affine fit (50 Adam steps, fit_scale 1) on
    a sharp input, 4 slices at 256² of a binary square plus noise shifted
    by a few pixels, on the card and on the CPU: theta's largest difference
    (a measurement: the fit's trajectory is discontinuous at knife-edge
    coordinates)."""
    import numpy as np
    import torch

    from rpnet_tpu_torch.registration.affine import fit_affine

    rng = np.random.RandomState(21)
    H = 256
    yy, xx = np.mgrid[:H, :H]
    sq = lambda dy, dx: ((abs(yy - 128 - dy) < 48) & (abs(xx - 128 - dx) < 40)).astype(np.float32)
    mov = np.stack([sq(0, 0) + 0.05 * rng.randn(H, H) for _ in range(4)]).astype(np.float32)
    fix = np.stack([sq(3 + i, -4 + i) + 0.05 * rng.randn(H, H) for i in range(4)]).astype(np.float32)
    theta = {dev: fit_affine(torch.from_numpy(mov[..., None]).to(dev),
                             torch.from_numpy(fix[..., None]).to(dev), iters=50)[0].cpu()
             for dev in ("cpu", "cuda")}
    diff = float((theta["cuda"] - theta["cpu"]).abs().max())
    moved = float((theta["cpu"] - torch.eye(2, 3)).abs().max())
    log(f"[affine-sharp] 50 affine steps, fit_scale 1, 4 x 256² binary squares + noise: "
        f"theta card vs CPU max |diff| {diff:.3e} (theta moved {moved:.3e} from the identity)")
    return diff


def episode_slices(cfg, n: int = 4):
    """The first eval episode's first ``n`` query slices, shot 0's supports
    and the query labels (host sampling)."""
    from rpnet_tpu_torch.config import Config
    from rpnet_tpu_torch.episode.sampler import EpisodeSampler

    config = Config(cfg)
    s = EpisodeSampler(config["data_dir"], config["eval_set_name"], config)
    random.seed(int(config.get("seed", 0)))   # the support the CLI's first pass draws
    ep = s.sample(0, picks=s.draw_supports(0))
    return (ep.support_images[0, :n], ep.support_labels[0, :n], ep.query_images[:n],
            ep.query_labels[:n])


def phase_registration_reference(cfg):
    """Phase 3r: ``register_episode`` with 50 demons steps on the first
    episode's first 4 query slices at 256², in the matmul structure (the
    example's, fit_scale 4) and the gather structure (fit at full
    resolution, fit_scale 4 for the affine), on the card and on the CPU:
    warped labels agreeing on > REG_LABEL_AGREE of pixels, the warped image
    within REG_SRC_ATOL (REG_SRC_MEAN_ATOL on average), the raw flow within
    REG_FLOW_RTOL of its own largest value; the prior's Dice against the query labels logged, affine
    only and with the demons."""
    import numpy as np
    import torch

    from rpnet_tpu_torch.core.metrics import dice
    from rpnet_tpu_torch.registration.fit import register_episode

    s_img, s_lab, q_img, q_lab = (torch.from_numpy(np.ascontiguousarray(a))
                                  for a in episode_slices(cfg))
    out = {}
    for sampler in ("matmul", "gather"):
        res, secs = {}, {}
        for dev in ("cuda", "cpu"):
            t0 = time.time()
            r = register_episode(s_img.to(dev), q_img.to(dev), s_lab.to(dev),
                                 affine_iters=50, demons_iters=50, fit_scale=4,
                                 sampler=sampler)
            res[dev] = {k: v.cpu() for k, v in r._asdict().items()}
            secs[dev] = time.time() - t0
        g, c = res["cuda"], res["cpu"]
        m = {"theta": float((g["theta"] - c["theta"]).abs().max()),
             "flow": float((g["flow"] - c["flow"]).abs().max()),
             "flow_scale": float(c["flow"].abs().max()),
             "warped_src": float((g["warped_src"] - c["warped_src"]).abs().max()),
             "warped_src_mean": float((g["warped_src"] - c["warped_src"]).abs().mean()),
             "src_moved_mean": float((c["warped_src"] - c["affine_src"]).abs().mean()),
             "warped_label_agree": float((g["warped_label"] == c["warped_label"]).float().mean()),
             "dice_affine_prior": float(dice(g["affine_label"], q_lab)[0]),
             "dice_demons_prior": float(dice(g["warped_label"], q_lab)[0]),
             "dice_demons_prior_cpu": float(dice(c["warped_label"], q_lab)[0]),
             "seconds_card_cold": round(secs["cuda"], 3), "seconds_cpu": round(secs["cpu"], 3)}
        log(f"[reg-reference] {sampler} structure, 4 x 256², 50 affine + 50 demons steps: "
            f"card vs CPU {json.dumps(m)}")
        if not (m["warped_label_agree"] > REG_LABEL_AGREE
                and m["warped_src"] <= REG_SRC_ATOL
                and m["warped_src_mean"] <= REG_SRC_MEAN_ATOL
                and m["flow"] <= REG_FLOW_RTOL * m["flow_scale"]):
            raise AssertionError(f"register_episode ({sampler}) on the card disagrees with "
                                 f"the CPU: {m}")
        out[sampler] = m
    # DEEDS (no path calls it): its default 128² control grid and 15²
    # shifts on the same slices, the sample grid card vs CPU
    from rpnet_tpu_torch.registration.deeds import deeds_fit

    mov, fix = ((s_img + 1) * 0.5)[..., None], ((q_img + 1) * 0.5)[..., None]
    grids = {dev: deeds_fit(mov.to(dev), fix.to(dev)).cpu() for dev in ("cuda", "cpu")}
    diff = float((grids["cuda"] - grids["cpu"]).abs().max())
    log(f"[reg-reference] deeds_fit, 4 x 256², 128² grid, 15² shifts: sample grid card vs "
        f"CPU max |diff| {diff:.3e} (atol 1e-4)")
    if not diff <= 1e-4:
        raise AssertionError(f"deeds_fit on the card disagrees with the CPU: {diff}")
    return out


# Set after measuring on an NVIDIA H100 80GB HBM3 (700 W): labels agreed on
# 0.99998 (matmul) and 0.99991 (gather) of the pixels; the warped image
# parted by 4.1e-2 and 3.9e-2 at most and 6.3e-5 and 7.7e-5 on average, where
# the demons move it by 0.52 and 0.47 at most and 1.1e-2 and 5.5e-3 on
# average (``src_moved_mean``, the CPU's); the raw flow parted by 1.3e-2 of
# 0.20 and 2.1e-2 of 0.061. Where the flow's gradient is near zero Adam's
# normalized step moves it by ±lr whatever the gradient's size, and the card
# and the CPU sum that gradient in another order: the flow moves the image
# little there, so the image is held tighter than the flow.
REG_LABEL_AGREE = 0.999
REG_SRC_ATOL = 0.1
REG_SRC_MEAN_ATOL = 5e-4
REG_FLOW_RTOL = 0.5


def phase_deformable_eval(cfg, main_episodes):
    """Phase 3e: the eval CLI on the main path's episodes and weights with
    ``do_deformable: True`` (50 demons steps), 2 passes, once under
    ``reg_sampler: matmul`` (the example's) and once under ``gather``: 11
    launches of row 1 an episode, no failed episode, every Dice finite; each
    episode's demons prior Dice logged beside the main path's affine-only
    prior; the warm pass's episodes/s. Then, under matmul, one warm spec
    dispatch under the sync debug mode and one warm episode profiled."""
    out, ops = {}, None
    for sampler in ("matmul", "gather"):
        results, launches, episodes, passes = run_cli_config(
            cfg, f"deform_{sampler}", n_runs=2, do_deformable=True, reg_sampler=sampler)
        n_eps = results["episodes"]
        if launches != {"local_correlation": 11 * n_eps}:
            raise AssertionError(f"deformable {sampler}: launches {launches}, expected "
                                 f"{11 * n_eps} of local_correlation")
        n_pass = n_eps // 2
        warm_wall = float(passes[1][1].split()[1].rstrip("s"))
        pairs = [(round(a["dsc_affine"], 4), round(b["dsc_affine"], 4))
                 for a, b in zip(main_episodes[:n_pass], episodes[:n_pass])]
        log(f"[deform-{sampler}] {n_eps} episodes in 2 passes, warm pass {n_pass / warm_wall:.3f} "
            f"episodes/s ({passes[1][1]}; {passes[1][0]}), CLI wall {results['wall']:.1f}s, "
            f"launches {launches}; prior Dice per episode (affine only, with demons): {pairs}")
        out[sampler] = launches
        if sampler == "matmul":
            ops = check_dispatch_does_not_block(
                dict(cfg, do_deformable=True, reg_sampler=sampler), tag=f"deform-{sampler}",
                host=False)
    return out, ops


def phase_eval_3d():
    """Phase 3f: the eval CLI with ``yamls/example_3d.yml``'s settings
    (``eval_3d``, windows of 32 slices overlapping by 8, matmul structure,
    fit_scale 4, bf16) on 2 synthetic Liver volumes of 80×272×272 (41-54
    annotated slices: 2 windows each): 11 launches of row 1 a window, no
    failed volume, finite Dice, and each volume's prediction and prior of
    the query volume's shape."""
    import numpy as np
    import torch
    import yaml

    from rpnet_tpu_torch.cli import test_rpnet
    from rpnet_tpu_torch.core.synthetic import generate_dataset
    from rpnet_tpu_torch.episode import volume3d

    paths = generate_dataset(os.path.join(WORK, "data3d"), n_train=1, n_test=2,
                             shape=(80, 272, 272), classes=("Liver",), seed=2)
    with open(os.path.join(ROOT, "yamls", "example_3d.yml")) as f:
        cfg = yaml.safe_load(f)
    cfg.update(data_dir=paths["data_dir"], class_csv_dir=paths["class_dir"],
               eval_set_name=paths["test_csv"], train_set_name=paths["train_csv"],
               out_dir=os.path.join(WORK, "out_3d"))
    path = os.path.join(WORK, "example_3d_synthetic.yml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)

    volumes, orig = [], volume3d.Volume3DRunner.run_volume

    def run_volume(self, support_vol, support_lab, query_vol, query_lab, **kw):
        res = orig(self, support_vol, support_lab, query_vol, query_lab, **kw)
        volumes.append((query_vol.shape, res))
        return res

    volume3d.Volume3DRunner.run_volume = run_volume
    try:
        reset_launches()
        t0 = time.time()
        results = test_rpnet.main(["--yaml", path])
        torch.cuda.synchronize()
        launches = read_launches()
    finally:
        volume3d.Volume3DRunner.run_volume = orig
    wall = time.time() - t0
    windows = sum(len(volume3d.window_starts(shape[0], 32, 8)) for shape, _ in volumes)
    r = results["classes"]["Liver"]
    log(f"[eval-3d] {len(volumes)} volumes (query depths {[s[0] for s, _ in volumes]}), "
        f"{windows} windows, per volume (affine, fewshot) Dice "
        f"{[(v.dsc_affine, v.dsc_fewshot) for _, v in volumes]}, class means affine "
        f"{r['affine'][0]:.4f} fewshot {r['fewshot'][0]:.4f}, CLI wall {wall:.1f}s, "
        f"launches {launches}")
    if results["failed_episodes"] or len(volumes) != 2:
        raise AssertionError(f"eval_3d: {results['failed_episodes']} failed, "
                             f"{len(volumes)} volumes ran")
    if windows < 4 or launches != {"local_correlation": 11 * windows}:
        raise AssertionError(f"eval_3d: launches {launches} in {windows} windows")
    for shape, v in volumes:
        if v.prediction.shape != shape or v.appr_label.shape != shape or not all(
                d is not None and np.isfinite(d) for d in (v.dsc_affine, v.dsc_fewshot)):
            raise AssertionError(f"eval_3d volume of shape {shape}: {v.prediction.shape}, "
                                 f"Dice {v.dsc_affine}, {v.dsc_fewshot}")
    return launches


def phase_deformable_training(cfg, default_first_loss: float):
    """Phase 5c: the train CLI for 2 steps with ``do_deformable: True`` (50
    demons steps, matmul structure, fit_scale 4) from the training path's
    seed: 5 forward and 5 backward launches a step, finite losses, the
    parameters moved; the first loss logged beside the affine-only one."""
    import torch
    import yaml

    from rpnet_tpu_torch.cli import train as train_cli
    from rpnet_tpu_torch.config import Config
    from rpnet_tpu_torch.models.factory import build_rpnet
    from rpnet_tpu_torch.train.convert import load_torch_checkpoint

    vcfg = dict(cfg, do_deformable=True, out_dir=os.path.join(WORK, "train_out_deform"))
    path = os.path.join(WORK, "example_train_deform.yml")
    with open(path, "w") as f:
        yaml.safe_dump(vcfg, f)
    reset_launches()
    t0 = time.time()
    res = train_cli.main(["--yaml", path, "--epochs", "1", "--episodes-per-epoch",
                          str(VARIANT_TRAIN_EPISODES)])
    torch.cuda.synchronize()
    launches = read_launches()
    steps = len(res["step_losses"])
    ckpt = load_torch_checkpoint(res["checkpoint"])
    init = build_rpnet(Config(vcfg), seed=int(vcfg.get("seed", 0))).state_dict()
    moved = sum(1 for k, v in ckpt["state_dict"].items()
                if k in init and v.is_floating_point() and not torch.equal(v, init[k]))
    log(f"[train-deform] {steps} steps: losses {res['step_losses']} (affine-only first loss "
        f"{default_first_loss}), seconds between steps {res['step_seconds']}, CLI wall "
        f"{time.time() - t0:.1f}s, {moved} of {len(init)} tensors moved, launches {launches}")
    expect = {"local_correlation": 5 * steps, "local_correlation_bwd": 5 * steps}
    if steps != 2 or launches != expect:
        raise AssertionError(f"deformable training: {steps} steps, launches {launches}, "
                             f"expected {expect}")
    if not all(math.isfinite(v) for v in res["step_losses"]) or moved < len(init) // 2:
        raise AssertionError(f"deformable training: losses {res['step_losses']}, "
                             f"{moved} tensors moved")
    return launches


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
    # the breadth backbones' shapes (512 channels, two 256-channel groups):
    # VGG's 1/8 and ResNet's 1/4 of the 256² crops
    wide = {name: check_local_corr((dq[0], hw, hw, 512), 5, bf16, seed=4 + i, timed=True)
            for i, (name, hw) in enumerate((("vgg", 32), ("resnet", 64)))}
    check_local_corr((32, 64, 64, 256), 5, bf16, seed=2, timed=True)
    check_local_corr((32, 64, 64, 256), 5, f32, seed=3, timed=True)
    # the bf16 kernel's tiling edges: W past one 64-query strip, C not a
    # multiple of its 64-channel chunk, C past the 256 it keeps resident,
    # ragged 20x20, every radius class
    edges = list(FWD_EDGES[:6])
    # the f32 kernel's: 32-query strips, 32-channel chunks, 256-channel
    # groups (C=320 takes two), C=16 half a chunk, r=4
    for i, (shape, r) in enumerate(FWD_EDGES):
        for j, dtype in enumerate((bf16, f32)):
            check_local_corr(shape, r, dtype, seed=30 + 2 * i + j, timed=False)
    train_shape = (4 * int(cfg["k"]), 64, 64, 256)    # E·k slices of the train step
    train_fwd = check_local_corr(train_shape, 5, f32, seed=6, timed=True)
    train_bwd = check_local_corr_bwd(train_shape, 5, f32, seed=7, timed=True)
    check_local_corr_bwd(train_shape, 5, f32, seed=8, timed=False, strided=False)
    check_local_corr_bwd(train_shape, 5, bf16, seed=9, timed=False)
    # the backward's tiling edges (4-row x 32-query x 256-channel blocks,
    # a band depth per radius), both dtypes, g strided and contiguous
    bwd_edges = edges + [((2, 64, 64, 256), 4)]
    for i, (shape, r) in enumerate(bwd_edges):
        for j, dtype in enumerate((f32, bf16)):
            for strided in (True, False):
                check_local_corr_bwd(shape, r, dtype, seed=70 + 4 * i + 2 * j + strided,
                                     timed=False, strided=strided)
    check_autograd((3, 20, 20, 64), 2, seed=10)
    check_autograd((4, 64, 64, 256), 5, seed=11)

    # the opt-in forwards (RPNET_CORR_IMPL / RPNET_ROT_EXTRACT / RPNET_ROT_PACK)
    eval_shape = (dq[0], 64, 64, 256)
    even = next((b for b in dq if b % 2 == 0), dq[0] + 1)   # pack takes pairs
    variant = {
        "band": check_variant("band", eval_shape, 5, bf16, seed=12, timed=True),
        "pdot": check_variant("pdot", eval_shape, 5, bf16, seed=13, timed=True),
        "pack": check_variant("pack", (even, 64, 64, 256), 5, bf16, seed=14, timed=True),
        "csub": check_variant("csub", eval_shape, 5, bf16, seed=15, timed=True),
    }
    variant_train = {kind: check_variant(kind, train_shape, 5, f32, seed=16 + i, timed=True)
                     for i, kind in enumerate(("band", "pack", "csub"))}
    for i, (kind, shape, r) in enumerate(BAND_EDGES):
        for j, dtype in enumerate((bf16, f32) if kind != "pdot" else (bf16,)):
            partner = BAND_PARTNER[str(dtype).replace("torch.", "")] if kind == "pack" else 1.0
            check_variant(kind, shape, r, dtype, seed=200 + 2 * i + j, timed=False,
                          partner=partner)
    for i, (shape, r) in enumerate(CSUB_EDGES):
        for j, dtype in enumerate((bf16, f32)):
            check_variant("csub", shape, r, dtype, seed=130 + 2 * i + j, timed=False)
    check_variant("pdot", (4, 64, 64, 48), 5, bf16, seed=26, timed=False)

    # the kernel sweep: its own two kernels (rows 8 and 9), then the sweep
    sweep_timed = phase_sweep_kernels()
    sweep_launches = phase_sweep()
    check_grid_sample()
    check_affine_sharp()

    _, launches, default_outputs, main_episodes = phase_main_path(yaml_path)
    eval_launches = phase_eval_switches(yaml_path, dq, default_outputs)
    data_launches = phase_data_paths(cfg)
    breadth_launches = phase_breadth(cfg, paths)
    phase_registration_reference(cfg)
    deform_launches, deform_ops = phase_deformable_eval(cfg, main_episodes)
    eval3d_launches = phase_eval_3d()
    measure_bf16_rounding()
    for backbone in ("UNet", "vgg", "resnet"):
        phase_reference(backbone)
    train_yaml, train_cfg = make_train_config()
    train_res, train_launches, _ = phase_training(train_yaml, train_cfg)
    switch_launches = phase_train_switches(train_cfg, train_res["step_losses"][0])
    train_deform_launches = phase_deformable_training(train_cfg, train_res["step_losses"][0])
    profile_train_step(train_cfg)
    phase_train_reference()

    def entry(name, source, replaces, res, n_launches, **extra):
        """``replaces``: a line of rpnet_tpu/ops/pallas/correlation.py, or
        "file:line" of another file; ``extra``: more keys of the entry."""
        if isinstance(replaces, int):
            replaces = f"rpnet_tpu/ops/pallas/correlation.py:{replaces}"
        return {"name": name, "route": "cuda",
                "source": f"rpnet_tpu_torch/ops/csrc/{source}",
                "replaces": replaces,
                "launches": n_launches, "max_abs_err": res["max_abs_err"],
                "ms": res["ms"], "plain_ms": res["plain_ms"], "bound_ms": res["bound_ms"],
                "bound_by": res["bound_by"], "bound_unit": res["bound_unit"],
                "library_ms": None,      # no single PyTorch call computes it
                # corr_swapped: its kernel alone, before the wrapper's transpose
                **({"kernel_ms": res["kernel_ms"]} if "kernel_ms" in res else {}), **extra}

    def opt_in(wrapper):   # launches over the path runs that select it
        return sum(run.get(wrapper, 0) for run in
                   list(eval_launches.values()) + list(switch_launches.values()))

    # row 1: the main path's count beside its timed shape; the data-path and
    # breadth runs' counts per run, and the C = 512 shapes' times, beside it
    row1_runs = {"main": launches, **{f"data-{k}": v for k, v in data_launches.items()},
                 **{f"breadth-{k}": v for k, v in breadth_launches.items()},
                 **{f"deform-{k}": v for k, v in deform_launches.items()},
                 "eval3d": eval3d_launches}
    train_runs = {"train": train_launches, "train-deform": train_deform_launches}
    kernels = [
        entry("local_correlation", "local_corr.cu", 289, main_case,
              launches["local_correlation"],
              launches_by_run={k: v.get("local_correlation", 0) for k, v in row1_runs.items()},
              wide_shapes=wide),
        entry("local_correlation_train_forward", "local_corr.cu", 36, train_fwd,
              train_launches["local_correlation"],
              launches_by_run={k: v["local_correlation"] for k, v in train_runs.items()}),
        entry("local_correlation_bwd", "local_corr_bwd.cu", 776, train_bwd,
              train_launches["local_correlation_bwd"],
              launches_by_run={k: v["local_correlation_bwd"] for k, v in train_runs.items()}),
        entry("local_correlation_band", "local_corr_band.cu", 122, variant["band"],
              opt_in("local_correlation_band")),
        entry("local_correlation_pdot", "local_corr_band.cu", 289, variant["pdot"],
              opt_in("local_correlation_pdot")),
        entry("local_correlation_packed", "local_corr_band.cu", 446, variant["pack"],
              opt_in("local_correlation_packed")),
        entry("local_correlation_csub", "local_corr_csub.cu", 198, variant["csub"],
              opt_in("local_correlation_csub")),
        entry("corr_swapped", "local_corr_sweep.cu", "bench_tools/corr_sweep.py:37",
              sweep_timed[("swapped", "bfloat16")], sweep_launches["corr_swapped"]),
        entry("corr_rotmxu", "local_corr_sweep.cu", "bench_tools/corr_sweep.py:100",
              sweep_timed[("rotmxu", "bfloat16")], sweep_launches["corr_rotmxu"]),
    ]
    for name, res in wide.items():
        log(f"[kernels] {name} shape, local_correlation: {json.dumps(res)}")
    log(f"[kernels] local_correlation launches: main path {launches}, data paths "
        f"{data_launches}, breadth {breadth_launches}, deformable {deform_launches}, "
        f"eval_3d {eval3d_launches}; training {train_runs}; device operations of one "
        f"warm deformable (matmul) episode {deform_ops}")
    for kind, res in variant_train.items():
        log(f"[kernels] training shape, {kind}: {json.dumps(res)}")
    for (kind, dtype), res in sweep_timed.items():
        log(f"[kernels] sweep shape, {kind} {dtype}: {json.dumps(res)}")
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
