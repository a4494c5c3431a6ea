#!/usr/bin/env python3
"""Bring-up check of rpnet_tpu_torch on one NVIDIA GPU (an H100 for sm_90a).

    python3 chip_smoke.py [--phases name,name,...]

With no argument every phase runs, in the order below; ``--phases`` runs
the named ones alone, with the phases whose results they read (``main``
for ``eval-switches``, ``deform``, ``serve``, ``multiprocess`` and ``mesh``;
``trained`` for ``serve``;
``training`` for ``train-switches`` and ``train-deform``; ``lgca-train``
for ``lgca-eval``) and the build; the kernel JSON then lists the rows
whose checks ran, with the launches of the path phases that ran (null,
and no ``launches_by_run`` entry, for a path phase that did not). Phase
names in brackets below.

Phases, each of which raises on failure (exit code 1, no result line):
  1. build [build] — compile every kernel of the eval and training paths and of the
     opt-in correlation forwards from ops/csrc/ (one nvcc per source, all
     started together) for sm_90a, printing ptxas' register/shared-memory
     report, the bf16 forward's design, shared memory and blocks an SM, the
     f32 forward's, the band kernel's and the C-strided kernel's (both
     dtypes) and the backward's designs, shared memory, blocks an SM,
     registers and spills; beside them the host NRRD decoder
     (native/nrrd_cache.cpp, g++ and zlib, whose versions it prints);
  native-io [native-io] — every NRRD of the main path's dataset read
     through the raw cache (core/native_cache.read_cached) equal byte for
     byte to the Python codec (nrrd_io.read); one CT volume's read seconds
     by each reader, and the raw cache's first and warm reads; phase 3 then
     requires its sampler to have read every volume file through the raw
     cache (``EpisodeSampler.io_reads``);
  2. kernels [kernels] — call each kernel's wrapper on the card at the main paths'
     shapes, the eval shape (the first episode's query slices, 64×64,
     C=256, r=5, bf16; and C=512 at 32×32 and 64×64, the VGG and ResNet
     backbones' eval shapes), the training shape (48 slices, f32; and
     C=512 at 32×32 and 64×64, the VGG and ResNet training shapes, forward
     and backward, timed) and the
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
  2b. sweep kernels [sweep-kernels] — the kernel sweep's own two kernels
     (``rpnet_tpu_torch.bench_tools.corr_sweep``, both on the band body of
     tensor-core products: corr_swapped, planar f32, and corr_rotmxu, NHWC
     with d² or 128 zero-padded lanes) against their plain versions at the
     sweep shape (32×64×64×256, r=5; f32 and bf16, every h_tile, both
     full_lanes and both out_f32;
     corr_swapped timed as the kernel alone and through its wrapper's
     transpose and cast) and at ``SWEEP_EDGES`` in both dtypes (corr_rotmxu
     with d² and 128 lanes), on outputs the caching allocator had filled
     with NaN; padding lanes exactly zero;
  2c. the kernel sweep [sweep] — ``corr_sweep.main()`` at 32×64×64×256, r=5, with
     the launch counts set to 0 just before and read just after: no line
     FAILED or missed its tolerance, and each kernel launched as often as
     its lines call it;
  2d. grid_sample [grid-sample] — CUDA ``F.grid_sample`` (bilinear, zeros,
     align_corners=False, f32) against a plain torch evaluation of the JAX
     gather formula ((x+1)·S − 1)/2 on the card, at every pair of
     knife-edge coordinates (exact integer and half-integer indices and
     1 ulp either side) for S = 64 and 48: values within 1e-5, the input's
     gradient within 1e-4, the grid's within 1e-6 of its scale everywhere;
     then the affine fit (50 steps, fit_scale 1) on a sharp input (binary
     squares plus noise) on the card and on the CPU, theta's difference
     logged;
  2e. affine fit [affine-fit] — the affine fit kernel (``ops/csrc/affine_fit.cu``,
     the whole 50-step fit in one launch, through ``fit_affine``) against
     its plain version (``fit_affine_plain``) on the card at (S, H, W) =
     ``AFFINE_FIT_CASES`` (one slice, the eval cell's longest query and
     the training step's 48 slices at 256², and 48 at 64², the fit at
     ``reg_fit_scale`` 4), on smooth slices (a soft-edged organ on a
     low-frequency texture) and on slices of two
     ``benchmark/traffic/volumes.py`` volumes, on outputs NaN-poisoned:
     theta equal bit for bit to the plain version's (the fit through
     autograd over ``F.affine_grid`` + ``F.grid_sample``, which the kernel
     replaced on the card), for one slice (a batch of one takes another
     cuBLAS reduction, and the fits part by rounding) within 5e-5; each
     step's loss within 1e-5 relative of the MSE at the kernel's own theta
     of that step; two runs equal bit for bit; the kernel's time beside its bound
     (:func:`affine_fit_bound`) and the plain version's, which is also
     ``library_ms``; the launches the phase made, and those of phases 3
     and 5 where they ran, in ``launches_by_run``;
  3. main path [main] — the port's eval CLI (``rpnet_tpu_torch.cli.test_rpnet``)
     on a synthetic Abd-110-shaped dataset at 272² volumes / 256² crops,
     configured by yamls/example.yml (U-Net d4, r=5, 10 refinement
     iterations, 50 affine steps at reg_fit_scale 4, bf16 network), with the
     kernels' launch counts set to 0 just before and read just after; every
     kernel must have run 11 times per episode (once per support, once per
     refinement iteration), no episode may fail, every Dice must be finite;
  3b. eval switches [eval-switches] — the same CLI, episodes and weights under each opt-in
     forward (pallas_mxu, csub, pdot, RPNET_ROT_PACK=1): 11 launches per
     episode of the selected kernel (pack: select for odd slice counts),
     refinement masks agreeing with phase 3's on > 99.9% of pixels;
  3c. data paths [data-paths] — the same CLI on the same episodes and weights for 3
     passes on each eval data path: the spec path (the example's defaults,
     a device volume cache of 16: index-only episodes gathered on the card),
     the prefetch path (cache 0, num_workers 4) and the plain host path
     (cache 0, num_workers 0): every episode's metrics equal across the
     paths, 11 launches an episode, no failure; each pass's episodes/s and
     ``stage_timing`` logged (no forward hook); then one warm episode queued
     on the spec and on the host path under
     ``torch.cuda.set_sync_debug_mode("warn")``: no synchronizing call;
  3d. breadth [breadth] — the CLI on 2 episodes under ``backbone: vgg`` (scale 8),
     ``backbone: resnet``, ``mask_feature_map: x2``, ``use_relation_enc:
     concat`` and ``use_all_supports`` + ``multishot_fusion`` with 2 shots
     and ``n_way: 2``: Wa·Sh + 10 launches an episode (none under concat),
     no failed episode, every Dice finite;
  3r. registration reference [reg-reference] — ``register_episode`` with 50 demons steps
     on the first episode's first 4 query slices at 256², matmul structure
     (fit_scale 4) and gather structure, on the card and on the CPU:
     warped labels agreeing on > 99.9% of pixels, the warped image within
     0.1 (5e-4 on average), the raw flow within half its largest value; the
     affine-only and demons priors' Dice logged; ``deeds_fit`` (128² grid,
     15² shifts) card vs CPU within 1e-4;
  3e. deformable eval [deform] — phase 3's CLI, episodes and weights with
     ``do_deformable: True`` for 2 passes, under ``reg_sampler: matmul``
     and ``gather``: 11 launches an episode, no failed episode, every Dice
     finite; each episode's demons prior Dice beside phase 3's affine-only
     one and the warm pass's episodes/s logged; under matmul one warm spec
     dispatch under the sync debug mode (no synchronizing call);
  serve-routes [serve-routes] — the CRE alone at the eval shape under each
     opt-in forward's switch (rows 5, 6, 2, 3) exported on the card, saved
     and loaded: one node of that route's custom op in the graph; the
     reloaded program, run with no switch set, equal to the live CRE call,
     the row's launch count moved by one (``launches_by_run``
     ``serve-routes``);
  3f. eval_3d [eval-3d] — the eval CLI with ``yamls/example_3d.yml``'s settings on 2
     synthetic Liver volumes of 80×272×272 (2 windows each): 11 launches a
     window, no failed volume, finite Dice, predictions of the volume's
     shape;
  4. reference [bf16-rounding, reference] — the full-width model (random seeded weights, 3 refinement
     iterations) on a small input, f32 with TF32 off, on the card vs on the
     CPU (plain versions), for the U-Net, VGG and ResNet backbones: logits
     within 2e-3, masks agreeing on > 99.9%;
  5. training path [training] — the port's train CLI (``rpnet_tpu_torch.cli.train``)
     on a synthetic dataset of the train classes (Spleen, Kidney L,
     Kidney R; 48×272×272 volumes), configured by yamls/example.yml's
     training block at full width (1-way 1-shot, k=12, batch_size 4, U-Net
     d4, r=5, 4 refinement iterations, 50 affine steps at reg_fit_scale 4,
     dice_ce + align loss, AdamW, f32) for 4 steps, with the launch counts
     set to 0 just before and read just after: 5 forward and 5 backward
     correlation launches per step; every loss finite, the parameters
     moved, and the written epoch_000.pth loads into the eval model;
  5b. training switches [train-switches] — 2 steps of the same CLI from the same seed under
     pallas_mxu, csub and rot + RPNET_ROT_PACK=1: 5 launches of the selected
     forward and 5 of the backward per step, the first loss within 1e-3
     relative of phase 5's;
  5c. deformable training [train-deform] — 2 steps of the train CLI with
     ``do_deformable: True`` (50 demons steps, matmul structure): 5 forward
     and 5 backward launches a step, finite losses, parameters moved;
  5d. training breadth [train-breadth] — the train CLI at full width (the example's
     training block) for 1 step each (2 for vgg and bfloat16) under
     ``backbone: vgg`` (scale 8), ``backbone: resnet``, ``mask_feature_map:
     x2``, ``use_relation_enc: concat``, ``unet_normalize_type: GroupNorm``,
     ``n_way: 2`` (soft masks), ``compute_dtype: bfloat16`` and a VGG warm
     start from a seeded torchvision VGG16 state dict (``pretrained_path``):
     Wa·Sh + 4 forward and backward correlation launches a step (none under
     concat), each on f32 features, finite losses, the parameters moved (the
     warm-started encoder within 1e-3 of the state dict), the written
     checkpoint loading into the eval model of the same config, peak memory
     logged;
  6. training reference [train-reference] — one full-width train step (E=2, k=2, 64², SGD at
     lr 1 so the change is the gradient) on the card vs on the CPU, f32 with
     TF32 off, for the U-Net, VGG and ResNet backbones and the U-Net under
     ``compute_dtype: bfloat16`` (soft masks: see ``TRAIN_REFERENCE``): loss
     within 1e-4 relative, each parameter
     tensor's change within 3e-2 (norm of the difference over norm of the
     change; the batch statistics of two 64² slices carry f32 differences in
     the order of sums into the deep layers' gradients, ~1e-2 measured);
  3g. trained checkpoint [trained] — the train CLI trains a U-Net on the card
     (``TRAINED_STEPS`` steps of 4 episodes of ``TRAINED_K`` slices, AdamW at
     ``TRAINED_LR``), then the eval CLI runs phase 3's episodes on it in f32
     and in bf16: the f32 masks' foreground share above 1%, the fewshot Dice
     finite (logged beside the prior's), bf16 within 0.01 Dice of f32 at the
     last iteration and masks agreeing on more than 98% of pixels at every
     iteration; the phase's seconds logged;
  serve [serve] — the main path's configuration exported by the port's
     ``cli.export`` on the card (bf16, ``slices`` = slice_bucket; export
     seconds, graph nodes and artifact size logged) and served by
     ``cli.serve`` on phase 3's episodes and weights (its seeded init as a
     ``.pth``) for 4 passes, beside the live CLI on the same ``.pth`` for 4
     passes, both timed alike (the warm passes' episodes/s logged): per-episode
     Dice within 1e-3 of phase 3's, 11 launches of row 1 an episode counted
     by the custom op's CUDA implementation (``launches_by_run`` ``serve``);
     then one untimed served pass of the same artifact with phase 3g's
     trained weights: Dice within 1e-3 of phase 3g's live bf16 run and
     last-iteration masks agreeing on > 99.9% of pixels
     (``serve-trained``). In f32 (``compute_dtype: float32``): the live
     runner padding each episode to the artifact's slices, as the served
     runner does, against the served runner, cuDNN on as the CLIs run it:
     every metric within 1e-5; and, a second witness, ``cli.serve``
     against the live f32 CLI with cuDNN and TF32 off (their batches
     differ, and cuDNN picks its algorithms by batch size): within 1e-5
     (``serve-f32``);
  lgca-reference [lgca-reference] — the full-width LGCANet_V3 (random seeded weights, 4
     ROIs) on the card vs on the CPU, f32 with TF32 off, on a (1, 32, 64,
     64, 1) volume and 4 slices of 128²: one eval forward (``seg_2d`` and
     ``dsv`` within ``LGCA_REF_BOUNDS`` of their largest magnitude) and one
     SGD step at lr 1 (the loss, and each parameter's change against the
     norm of the change);
  lgca-train [lgca-train] — the port's train CLI with ``yamls/example_lgca.yml`` (U_Net,
     BatchNorm2d, full widths, 8 slices of 288² and a 144³ context volume a
     step, 4 ROIs, AdamW) on 2 synthetic 280×272×272 volumes for 4 steps,
     launch counts set to 0 just before and read just after: no correlation
     kernel runs (the LGCA path has none); finite losses, warm s/step and
     peak memory logged, the checkpoint loading into the eval model;
  lgca-eval [lgca-eval] — the port's eval CLI on the synthetic eval volume with that
     checkpoint: 18 forwards of 16 slices, no correlation launch, no failed
     volume; volumes/s, peak memory and per-ROI Dice logged;
  multiprocess [multiprocess] — the eval CLI on phase 3's configuration
     and volumes, each volume listed ``MP_REPEAT`` times (32 episodes a
     pass), ``MP_RUNS`` passes a run, as one process and as two processes
     sharing the card (``multihost: true``, a gloo group on a free
     localhost port, ``mesh_shape: {data: 2}`` resolved to ``{data: 1}``
     each), four runs alternated one/two/two/one, each from a ``python
     -c`` wrapper that calls the CLI's ``main`` and prints row 1's
     launches: every worker exits 0 within ``MP_TIMEOUT_S``, both print
     the single run's aggregate block, the union of their episode lines is
     the single run's (bit for bit, or within 1e-4, logged which), pass 1's
     episodes on phase 3's (query, support) pairs have phase 3's Dice, row
     1's launches summed over the workers equal the single run's; the
     median warm episodes/s of one and of two processes, every pass's,
     and each worker's ``stage_timing`` logged;
  mesh [mesh] — the eval CLI with ``mesh_shape: {data: 1, model: 1}``
     gives phase 3's episode metrics; ``{data: 2}`` in one process raises
     the JAX resolver's message; LGCANet_V3 eval with ``{data: 1}`` runs
     its volume;
  preprocess [preprocess] — on a synthetic 280×272×272 CT volume: the
     host body mask (timed), the torch morphology twins (radius 7) and Otsu
     on the card against the CPU (equal; Otsu equal or one bin apart) and
     timed, ``affine_register_volumes`` card vs CPU on 5 smoothed slices
     (theta within 1e-3), ``preprocess_patient`` on a 48×272×272 patient;
  debug-nans [debug-nans] — the eval CLI with ``debug_nans: true`` on 2
     episodes runs clean; with a NaN in episode 0's query volume that
     episode raises at its first NaN and is counted as the one failure;
  shard [shard] — in-process sharding over several devices: the host's
     cards in turn where it has two or more, else logical devices
     ``[cuda:0] * n`` (which it prints first). (a) phase 3's first 4
     episodes through the eval runner over ``{data: 2}`` against the
     one-device runner, same seeded weights, compared with cuDNN off (whose
     per-slice results do not depend on the batch): bf16 (per-episode
     metrics within 1e-3), f32 (1e-4) and ``do_deformable`` in bf16 (5e-3:
     the one-device deformable runner is not deterministic on the card);
     row 1 launched 11 times an episode on each shard
     (``launches_by_run`` ``shard-eval-*``); with cuDNN on (bf16) the
     difference logged, a warm pass of each timed, and one warm sharded dispatch under the sync debug mode (no
     synchronizing call); (b) ``yamls/example_lgca.yml``'s model and shapes:
     2 steps of the sharded LGCA step over ``{data: 2}`` (global batch
     norms) against 2 one-device steps from the same state (loss rtol 1e-3,
     parameters atol 5e-3, f32 TF32 off), then the eval volume with and
     without the mesh (per-ROI Dice within 1e-3); (c) the example's
     training block (soft masks, as phase 6's bf16 case), 2 steps of the
     dp × tp step over ``{data: 2, model: 2}`` against 2 one-device steps (loss within 1e-4 relative; each
     parameter's first-step gradient within 3e-2, as phase 6, or within
     twice the difference of the one-device step on the batch's episodes in
     another order), rows 4 and 7 launched 5 times a row and step
     (``shard-train``).

Each phase's seconds are logged as it ends (``[phases]``). Then it prints the kernel table (a ``kernels`` line and a ``{"kernels":
...}`` JSON line), the card's name and power limit from nvidia-smi, and as
its last line ``{"ok": true, "device": {...}}``. It imports nothing of the
JAX package, and fails without a CUDA device or without the package beside it.
"""

from __future__ import annotations

import contextlib
import ctypes
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
              "tf32 tensor cores": 494.7e12,   # dense; f32 as three passes (3xTF32)
              "f32 FMA units": 67e12}          # outside the tensor cores
N_EVAL_VOLUMES = 4
N_TRAIN_VOLUMES = 4                        # × 3 train classes = 12 episodes
TRAIN_EPISODES = 16                        # 4 steps of batch_size 4
TRAIN_CLASSES = ("Spleen", "Kidney L", "Kidney R")
KERNELS = ("local_corr", "local_corr_bwd", "local_corr_band", "local_corr_csub",
           "local_corr_sweep", "affine_fit")
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
# the affine fit kernel's cases (S, H, W): one slice, the eval cell's longest
# query (71 slices) and the RP_Net training step's E·k = 48 at the 256² crop,
# and 48 at 64² (reg_fit_scale 4); the first long case is the table's row
AFFINE_FIT_CASES = ((1, 256, 256), (71, 256, 256), (48, 256, 256), (48, 64, 64))
AFFINE_FIT_ITERS = 50
AFFINE_FIT_FLOPS = 77   # f32 operations a pixel-step, an FMA as two (ops/csrc/affine_fit.cu)


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

    from rpnet_tpu_torch.core import native_cache

    t0 = time.time()
    with ThreadPoolExecutor(len(KERNELS) + 1) as pool:   # one nvcc per source, one g++
        native = pool.submit(native_cache.build, verbose=True)
        list(pool.map(lambda k: kernels.build(k, verbose=True), KERNELS))
        native_lib = native.result()
    for k in KERNELS:
        kernels.load(k)
    log(f"[build] {', '.join(KERNELS)} built for sm_90a in {time.time() - t0:.2f}s")
    cxx = subprocess.run([native_cache.CXX, "--version"], capture_output=True,
                         text=True).stdout.splitlines()[0]
    lib = native_cache._load_library()
    lib.zlibVersion.restype = ctypes.c_char_p
    log(f"[build] native/nrrd_cache.cpp built by {cxx} against zlib "
        f"{lib.zlibVersion().decode()}: {os.path.relpath(native_lib, ROOT)}")
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


class tf32_off:
    """cuDNN's and the matmuls' TF32 off for a block (the card-vs-CPU
    phases compare f32 with f32), then restored."""

    def __enter__(self):
        import torch

        self.saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False

    def __exit__(self, *exc):
        import torch

        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = self.saved


class cudnn_off:
    """cuDNN and the matmuls' TF32 off for a block (torch's own CUDA
    convolutions, whose per-slice results do not depend on the batch
    size), then restored."""

    def __enter__(self):
        import torch

        self.saved = (torch.backends.cudnn.enabled, torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.enabled = False
        torch.backends.cuda.matmul.allow_tf32 = False

    def __exit__(self, *exc):
        import torch

        torch.backends.cudnn.enabled, torch.backends.cuda.matmul.allow_tf32 = self.saved


class correlation_dtypes:
    """The dtypes the training path's correlation wrappers receive in a
    block (the default route's forward and the backward), as a set of
    (direction, dtype); the wrappers themselves run and count as always
    (reset and read their counts outside the block)."""

    def __enter__(self):
        from rpnet_tpu_torch.ops import correlation as tc

        self.tc, self.fwd = tc, tc.FORWARDS["select"]
        self.bwd = tc.LocalCorrelation.backward   # the autograd Function's
        seen, fwd, bwd = set(), self.fwd, self.bwd

        def forward(fm1, fm2, r):
            seen.add(("forward", str(fm1.dtype).replace("torch.", "")))
            return fwd(fm1, fm2, r)

        def backward(ctx, g):
            seen.add(("backward", str(g.dtype).replace("torch.", "")))
            return bwd(ctx, g)

        tc.FORWARDS["select"] = forward
        tc.LocalCorrelation.backward = staticmethod(backward)
        return seen

    def __exit__(self, *exc):
        self.tc.FORWARDS["select"] = self.fwd
        self.tc.LocalCorrelation.backward = staticmethod(self.bwd)


class recorded_episodes:
    """Every episode's metrics as the CLI settles it (``EpisodeRunner.finalize``
    wrapped: it runs after the episode's own wait, so it adds no sync); with
    ``arrays``, every episode queued with its prediction and prior too (the
    runner's ``arrays``), which the records then hold."""

    def __init__(self, arrays: bool = False):
        self.arrays = arrays

    def __enter__(self):
        from rpnet_tpu_torch.episode import pipeline

        self.cls, results = pipeline.EpisodeRunner, []
        self.orig = (self.cls.finalize, self.cls._queue)
        finalize_, queue_ = self.orig

        def finalize(runner, d):
            results.append(finalize_(runner, d))
            return results[-1]

        def queue(runner, *args):   # (tensors ×4, n_slices, keep, arrays[, parts])
            return queue_(runner, *args[:6], True, *args[7:])

        self.cls.finalize = finalize
        if self.arrays:
            self.cls._queue = queue
        return results

    def __exit__(self, *exc):
        self.cls.finalize, self.cls._queue = self.orig


class recorded_samplers:
    """The ``EpisodeSampler``s made in a block (their ``io_reads`` say which
    reader loaded each volume file)."""

    def __enter__(self):
        from rpnet_tpu_torch.episode.sampler import EpisodeSampler

        self.cls, self.orig, made = EpisodeSampler, EpisodeSampler.__init__, []
        orig = self.orig

        def init(sampler, *args, **kw):
            orig(sampler, *args, **kw)
            made.append(sampler)

        self.cls.__init__ = init
        return made

    def __exit__(self, *exc):
        self.cls.__init__ = self.orig


def io_reads(samplers):
    """The samplers' volume reads by reader, summed."""
    from collections import Counter

    return dict(sum((s.io_reads for s in samplers), Counter()))


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
        with switched(env or {}), recorded_episodes() as episodes, \
                recorded_samplers() as samplers:
            reset_launches()
            t0 = time.time()
            results = test_rpnet.main(["--yaml", yaml_path])
            torch.cuda.synchronize()
            launches = read_launches()
    finally:
        if handle is not None:
            handle.remove()
    results["wall"] = time.time() - t0
    results["io_reads"] = io_reads(samplers)
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
    reads = results["io_reads"]
    log(f"[native-io] the main path's sampler read its volume files through: {reads}")
    if not reads.get("rawcache") or reads.get("nrrd_io") or reads.get("native"):
        raise AssertionError(f"the main path did not read through the native raw cache: {reads}")
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
    may have run all of it)."""
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


def synchronizing_calls(fn):
    """fn() under the sync debug mode → (its result, the synchronizing
    calls it made, host ms)."""
    import warnings

    import torch

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


def check_dispatch_does_not_block(cfg, tag: str = "data", host: bool = True):
    """One warm episode queued on the spec and (with ``host``) on the host
    path under the sync debug mode, logged under ``[tag-sync]``."""
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


def bn_cancelled_biases(model):
    """Biases of the convolutions that feed a batch norm, which cancels
    them: in exact arithmetic they get no gradient."""
    import torch

    from rpnet_tpu_torch.models.blocks import BatchNorm2d

    out = set()
    for name, mod in model.named_modules():
        kids = list(mod.named_children())
        for (n1, m1), (_, m2) in zip(kids, kids[1:]):
            if isinstance(m1, torch.nn.Conv2d) and isinstance(m2, BatchNorm2d):
                out.add(f"{name}.{n1}.bias" if name else f"{n1}.bias")
    return out


# phase 6: (backbone, compute_dtype) of the card-vs-CPU train step. The
# bf16 case runs soft masks: on this input its rounded weights put refinement
# probabilities within card-vs-CPU noise of the hard mask's 0.5 (on the CPU a
# 1e-5 change of the input moves its hard-mask loss by 1.8e-3, the f32
# step's by 1e-6), as the CPU parity tests hold multi-iteration steps
TRAIN_REFERENCE = (("UNet", "float32"), ("vgg", "float32"), ("resnet", "float32"),
                   ("UNet", "bfloat16"))


def phase_train_reference(backbone: str = "UNet", compute_dtype: str = "float32"):
    """One full-width train step on the card vs on the CPU, f32 activations,
    TF32 off; under ``compute_dtype: bfloat16`` the parameters rounded for
    the forward on both."""
    import copy

    import numpy as np
    import torch

    from rpnet_tpu_torch.models.factory import build_rpnet
    from rpnet_tpu_torch.train.trainer import make_optimizer, make_train_step

    cfg = {"mask_refinement_correlation_radius": 5, "n_iter_refinement": 4,
           "use_registration_loss": False, "optimizer": "sgd", "init_lr": 1.0,
           "weight_decay": 1e-4, "scheduler_step": 0, "loss": "dice_ce",
           "backbone": backbone, "scale": 8 if backbone == "vgg" else 4,
           "compute_dtype": compute_dtype, "soft_mask": compute_dtype != "float32"}
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
        with tf32_off():
            m = step({"step": 0}, [b.to(dev) for b in batch])
            results[dev] = (float(m["loss"]),
                            {n: p.detach().cpu() for n, p in model.named_parameters()})
    (loss_c, p_c), (loss_g, p_g) = results["cpu"], results["cuda"]
    cancelled = bn_cancelled_biases(base)
    worst = max(float(torch.linalg.vector_norm(p_g[n] - p_c[n])
                      / torch.linalg.vector_norm(p_c[n] - start[n]).clamp_min(1e-12))
                for n in p_c if n not in cancelled)
    log(f"[train-reference] full-width {backbone} {compute_dtype} step, E=2 k=2 64² r=5 SGD "
        f"lr 1: loss card {loss_g:.6f} CPU {loss_c:.6f} (rtol 1e-4); worst parameter "
        f"change difference {worst:.2e} of the change (3e-2)")
    if not (abs(loss_g - loss_c) <= 1e-4 * abs(loss_c) and worst <= 3e-2):
        raise AssertionError(f"the {backbone} {compute_dtype} train step on the card "
                             "disagrees with the CPU")


def phase_reference(backbone: str = "UNet"):
    """Full-width model on the card (kernel) vs on the CPU (plain), f32."""
    import numpy as np
    import torch

    from rpnet_tpu_torch.models.factory import build_rpnet

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
    with torch.no_grad(), tf32_off():
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


def affine_fit_bound(S: int, H: int, W: int, iters: int):
    """Least time (ms) for the affine fit at these shapes, what bounds it and
    the unit: ``AFFINE_FIT_FLOPS`` f32 operations a pixel-step on the FP32
    units (f32 throughout: no tensor core keeps its arithmetic), against the
    two images read once and theta and the losses written once at the HBM
    rate."""
    flops = float(AFFINE_FIT_FLOPS) * S * H * W * iters
    nbytes = 4.0 * (2 * S * H * W + 6 * S + iters * S)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS["f32 FMA units"]
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations",
            "f32 FMA units")


def affine_fit_inputs(kind: str, S: int, H: int, volumes):
    """Moving and fixed slices (S, H, H, 1), f32 in [0, 1], on the card.
    ``smooth``: a soft-edged organ on a low-frequency texture, offset between
    the two (the CPU tests' registration inputs). ``volumes``: the 256²
    centre crop of S evenly spaced depths of the two CT volumes ``volumes``
    (HU clipped to the configuration's range and mapped to [0, 1]),
    avg-pooled down to H."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    if kind == "smooth":
        rng = np.random.RandomState(S + H)
        yy, xx = np.mgrid[:H, :H] / H

        def slice_(cy, cx, phase):
            r2 = ((yy - cy) / 0.25) ** 2 + ((xx - cx) / 0.3) ** 2
            soft = 1 / (1 + np.exp(-(1 - r2) / 0.08))
            return 0.35 + 0.3 * soft + 0.05 * np.sin(2 * np.pi * (2 * yy + xx) + phase)

        off = rng.uniform(-0.05, 0.05, (S, 4))
        pair = [np.stack([slice_(0.5 + o[0], 0.45 + o[1], 0.0) for o in off]),
                np.stack([slice_(0.47 + o[2], 0.5 + o[3], 0.3) for o in off])]
        return tuple(torch.from_numpy(a[..., None].astype(np.float32)).cuda() for a in pair)
    out = []
    for vol in volumes:
        D, Hv, Wv = vol.shape
        z = torch.linspace(4, D - 5, S, device=vol.device).long()
        y0, x0 = (Hv - 256) // 2, (Wv - 256) // 2
        crop = vol[z, y0:y0 + 256, x0:x0 + 256].float().clamp(-1024, 3072)
        img = ((crop + 1024) / 4096)[:, None]
        if H != 256:
            img = F.avg_pool2d(img, 256 // H)
        out.append(img[:, 0, ..., None].contiguous())
    return tuple(out)


def check_affine_fit(kind: str, S: int, H: int, volumes):
    """The affine fit kernel against its plain version, the fit through
    autograd (which is also ``library_ms``'s yardstick, the fit the kernel
    replaced), on one input (phase 2e): twice, on outputs the caching
    allocator had filled with NaN; theta equal bit for bit (the kernel
    repeats the card's roundings; see its source note), within 5e-5 for one
    slice, where cuBLAS reduces autograd's theta gradient in another order
    (a batch of one goes to another GEMM) and the two fits part by rounding;
    each step's loss within 1e-5 relative of the MSE at the kernel's own
    theta of that step (its fit of t steps is the first t steps of its fit;
    summed in another order); two runs equal. Raises otherwise."""
    import torch

    from rpnet_tpu_torch.registration.affine import affine_warp, fit_affine, fit_affine_plain
    from rpnet_tpu_torch.utils.timing import cuda_ms

    iters, lr = AFFINE_FIT_ITERS, 0.01
    mov, fix = affine_fit_inputs(kind, S, H, volumes)
    fit_affine(mov, fix, iters, lr)    # the base tables, made once, outside the poison
    runs = []
    for _ in range(2):
        poison = [torch.full(shape, float("nan"), device="cuda") for shape in ((S, 2, 3),
                                                                               (iters, S))]
        del poison
        runs.append(fit_affine(mov, fix, iters, lr))
    (theta, losses), (theta2, losses2) = runs
    plain_theta, _ = fit_affine_plain(mov, fix, iters, lr)
    path = [fit_affine(mov, fix, t, lr)[0] for t in range(iters)]   # theta before step t + 1
    at_path = torch.stack([torch.mean((fix - affine_warp(mov, th)) ** 2, dim=(1, 2, 3))
                           for th in path])
    torch.cuda.synchronize()
    per_slice = (theta - plain_theta).abs().flatten(1).max(1).values
    res = {"kind": kind, "shape": [S, H, H], "max_abs_err": float(per_slice.max()),
           "slices_not_bitwise": int((per_slice > 0).sum()),
           "loss_rel_err": float(((losses - at_path).abs() / at_path.abs()).max()),
           "bitwise_repeat": bool(torch.equal(theta, theta2) and torch.equal(losses, losses2)),
           "finite": bool(torch.isfinite(theta).all() and torch.isfinite(losses).all()),
           "theta_moved": float((plain_theta - torch.eye(2, 3, device="cuda")).abs().max())}
    res["ms"] = cuda_ms(lambda: fit_affine(mov, fix, iters, lr), reps=10)
    res["plain_ms"] = res["library_ms"] = cuda_ms(lambda: fit_affine_plain(mov, fix, iters, lr),
                                                  reps=1)
    res["bound_ms"], res["bound_by"], res["bound_unit"] = affine_fit_bound(S, H, H, iters)
    theta_ok = res["max_abs_err"] <= 5e-5 if S == 1 else res["slices_not_bitwise"] == 0
    ok = res["finite"] and theta_ok and res["loss_rel_err"] <= 1e-5 and res["bitwise_repeat"]
    log(f"[affine-fit] {json.dumps(res)} (theta equal bit for bit, for one slice within 5e-5; "
        f"losses rtol 1e-5 at the kernel's theta; two runs equal: "
        f"{'ok' if ok else 'DISAGREES'})")
    if not ok:
        raise AssertionError(f"affine fit kernel disagrees with its plain version on "
                             f"{kind} {S}x{H}x{H}: {res}")
    return res


def phase_affine_fit():
    """Phase 2e: every ``AFFINE_FIT_CASES`` shape on both kinds of input
    (see the module docstring) → {cases, launches, plans}."""
    import torch

    from benchmark.traffic.volumes import make_volume
    from rpnet_tpu_torch.ops import kernels
    from rpnet_tpu_torch.registration.affine import fit_affine

    gen = torch.Generator(device="cuda").manual_seed(22)
    volumes = [make_volume((80, 272, 272), ("Liver",), {"Liver": 71}, gen, "cuda")[0]
               for _ in range(2)]
    plans = {}
    for H in sorted({c[1] for c in AFFINE_FIT_CASES}):
        plans[H] = kernels.affine_fit_plan(H, H)
        log(f"[affine-fit] plan at {H}x{H}: {json.dumps(plans[H])}")
    fit_affine.launches = 0
    cases = {(S, H, kind): check_affine_fit(kind, S, H, volumes)
             for S, H, _ in AFFINE_FIT_CASES for kind in ("smooth", "volumes")}
    return {"cases": cases, "launches": fit_affine.launches, "plans": plans}


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
    dispatch under the sync debug mode."""
    out = {}
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
            check_dispatch_does_not_block(
                dict(cfg, do_deformable=True, reg_sampler=sampler), tag=f"deform-{sampler}",
                host=False)
    return out


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


# phase 5d: training breadth, the train CLI at full width under each setting:
# (config overrides, steps). The supports are tiled over n_way ways, so the
# ways' probabilities are equal and never pass 0.5: with hard masks the
# refinement empties the query mask after the first iteration and the step
# has no gradient (in the JAX trainer too), hence soft masks under n_way 2
TRAIN_BREADTH = {"vgg": ({"backbone": "vgg", "scale": 8}, 2),
                 "resnet": ({"backbone": "resnet", "scale": 4}, 1),
                 "mask_x2": ({"mask_feature_map": "x2"}, 1),
                 "concat": ({"use_relation_enc": "concat"}, 1),
                 "groupnorm": ({"unet_normalize_type": "GroupNorm"}, 1),
                 "n_way2": ({"n_way": 2, "soft_mask": True}, 1),
                 "bf16": ({"compute_dtype": "bfloat16"}, 2),
                 "pretrained_vgg": ({"backbone": "vgg", "scale": 8}, 1)}
# torchvision VGG16's ``features`` indices of its 13 convolutions
TORCHVISION_VGG16_CONVS = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)


def write_torchvision_vgg16(path: str, seed: int):
    """A torchvision-named VGG16 ``state_dict`` (the 13 ``features`` convs,
    two ``classifier`` tensors the warm start skips) drawn from ``seed``."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    sd, cin = {}, 3
    for idx, cout in zip(TORCHVISION_VGG16_CONVS,
                         [c for n, c in ((2, 64), (2, 128), (3, 256), (3, 512), (3, 512))
                          for _ in range(n)]):
        sd[f"features.{idx}.weight"] = torch.randn(cout, cin, 3, 3, generator=gen) * 0.05
        sd[f"features.{idx}.bias"] = torch.randn(cout, generator=gen) * 0.01
        cin = cout
    sd["classifier.0.weight"] = torch.randn(8, 8, generator=gen)
    sd["classifier.0.bias"] = torch.zeros(8)
    torch.save(sd, path)
    return sd


def phase_train_breadth(cfg):
    """Phase 5d: the train CLI at full width under each ``TRAIN_BREADTH``
    setting: Wa·Sh + n_iter_refinement forward and backward correlation
    launches a step (none under concat), each on f32 features (under
    ``compute_dtype: bfloat16`` too), finite losses, the parameters moved,
    the written checkpoint loads into the eval model of the same config, peak
    memory logged. The VGG warm start (``pretrained_path``, a seeded
    torchvision VGG16 state dict) must start the encoder from those weights:
    after its step they are within 1e-3 of them (AdamW at 1e-5)."""
    import torch
    import yaml

    from rpnet_tpu_torch.cli import train as train_cli
    from rpnet_tpu_torch.config import Config
    from rpnet_tpu_torch.models.factory import build_rpnet
    from rpnet_tpu_torch.train.convert import (convert_torchvision_vgg16, load_into,
                                               load_torch_checkpoint)

    vgg_path = os.path.join(WORK, "torchvision_vgg16.pth")
    warm = convert_torchvision_vgg16(write_torchvision_vgg16(vgg_path, seed=21))
    out = {}
    for label, (kw, steps) in TRAIN_BREADTH.items():
        vcfg = dict(cfg, out_dir=os.path.join(WORK, f"train_out_{label}"), **kw)
        if label == "pretrained_vgg":
            vcfg["pretrained_path"] = vgg_path
        path = os.path.join(WORK, f"example_train_{label}.yml")
        with open(path, "w") as f:
            yaml.safe_dump(vcfg, f)
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        with correlation_dtypes() as dtypes:
            t0 = time.time()
            res = train_cli.main(["--yaml", path, "--epochs", "1", "--episodes-per-epoch",
                                  str(steps * int(vcfg["batch_size"]))])
            torch.cuda.synchronize()
            wall = time.time() - t0
        launches = read_launches()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        config = Config(vcfg)
        per_step = int(config["n_way"]) + int(config["n_iter_refinement"])   # Wa·Sh + T
        expect = {} if config["use_relation_enc"] == "concat" else {
            "local_correlation": per_step * steps, "local_correlation_bwd": per_step * steps}
        ckpt = load_torch_checkpoint(res["checkpoint"])
        init = build_rpnet(config, seed=int(vcfg.get("seed", 0))).state_dict()
        moved = sum(1 for k, v in ckpt["state_dict"].items()
                    if k in init and v.is_floating_point() and not torch.equal(v, init[k]))
        model = build_rpnet(config, num_iter=config["n_test_iter_refinement"])
        load_into(model, ckpt["state_dict"])
        note = ""
        if label == "pretrained_vgg":
            off = max(float((ckpt["state_dict"][k] - v).abs().max()) for k, v in warm.items())
            note = f", encoder convs within {off:.2e} of the warm start (1e-3)"
            if not off <= 1e-3:
                raise AssertionError(f"train-{label}: the encoder did not start from "
                                     f"{vgg_path} ({off})")
        log(f"[train-{label}] {len(res['step_losses'])} steps: losses {res['step_losses']}, "
            f"seconds between steps {res['step_seconds']}, peak memory allocated "
            f"{peak:.2f} GiB, CLI wall {wall:.1f}s, {moved} of {len(init)} tensors moved, "
            f"launches {launches}, correlation input dtypes {sorted(dtypes)}; the checkpoint "
            f"loads into the eval model{note}")
        if expect and dtypes != {("forward", "float32"), ("backward", "float32")}:
            raise AssertionError(f"train-{label}: the correlation saw {dtypes}; the "
                                 "training path correlates f32 features")
        if len(res["step_losses"]) != steps or launches != expect:
            raise AssertionError(f"train-{label}: {len(res['step_losses'])} steps, launches "
                                 f"{launches}, expected {expect}")
        if not all(math.isfinite(v) for v in res["step_losses"]) or moved < len(init) // 2:
            raise AssertionError(f"train-{label}: losses {res['step_losses']}, {moved} "
                                 "tensors moved")
        out[label] = launches
    return out


# phase 3g: a U-Net trained on the card by the train CLI, then evaluated
TRAINED_STEPS = 120        # batches of TRAINED_K-slice episodes (~0.63 s each)
TRAINED_K = 4
TRAINED_LR = 1e-4


def phase_trained_eval(train_cfg, eval_cfg):
    """Phase 3g: train a U-Net with the train CLI on the synthetic train
    classes (``TRAINED_STEPS`` steps of batch_size 4 episodes of
    ``TRAINED_K`` slices, AdamW at ``TRAINED_LR``, the example's training
    block otherwise), then run the eval CLI on phase 3's episodes with that
    checkpoint in f32 and in bf16: the f32 masks' foreground share of the
    last iteration above 1%, the f32 fewshot Dice finite (logged beside the
    prior's), and bf16 against f32 on the card within the bounds of
    ``tests/test_torch_bf16_eval.py``: last-iteration Dice within 0.01,
    masks agreeing on more than 98% of pixels at every iteration. Returns
    the checkpoint and the bf16 run's episodes and last-iteration masks
    (phase serve holds its served run against them)."""
    import torch
    import yaml

    from rpnet_tpu_torch.cli import train as train_cli

    t0 = time.time()
    tcfg = dict(train_cfg, k=TRAINED_K, init_lr=TRAINED_LR,
                out_dir=os.path.join(WORK, "train_out_trained"))
    tpath = os.path.join(WORK, "example_train_trained.yml")
    with open(tpath, "w") as f:
        yaml.safe_dump(tcfg, f)
    res = train_cli.main(["--yaml", tpath, "--epochs", "1", "--episodes-per-epoch",
                          str(TRAINED_STEPS * int(tcfg["batch_size"]))])
    torch.cuda.synchronize()
    t_train = time.time() - t0
    losses = res["step_losses"]
    if len(losses) != TRAINED_STEPS or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"trained: {len(losses)} steps, losses {losses[:5]}...")
    log(f"[trained] {len(losses)} steps (k={TRAINED_K}, lr {TRAINED_LR}) in {t_train:.1f}s: "
        f"mean loss of the first and last 10 steps {sum(losses[:10]) / 10:.4f} -> "
        f"{sum(losses[-10:]) / 10:.4f}, {res['checkpoint']}")

    runs = {}
    for dtype in ("float32", "bfloat16"):
        path = os.path.join(WORK, f"eval_trained_{dtype}.yml")
        with open(path, "w") as f:
            yaml.safe_dump(dict(eval_cfg, ckpt=res["checkpoint"], compute_dtype=dtype,
                                out_dir=os.path.join(WORK, f"out_trained_{dtype}")), f)
        results, launches, (masks, _), episodes = run_eval_cli(path)
        runs[dtype] = (results, masks, episodes)
        r = next(iter(results["classes"].values()))
        log(f"[trained-eval-{dtype}] {results['episodes']} episodes: mean dice affine "
            f"(prior) {r['affine'][0]:.4f}, fewshot {r['fewshot'][0]:.4f}, by iteration "
            f"{[round(v[0], 4) for v in r['refinement'].values()]}, launches {launches}")
    (r32, m32, _), (r16, m16, e16) = runs["float32"], runs["bfloat16"]
    # masks: one (iterations, slices, H, W) tensor per episode
    fg = sum(float(m[-1].float().sum()) for m in m32) / sum(m[-1].numel() for m in m32)
    agree = [sum(int((a[i] == b[i]).sum()) for a, b in zip(m32, m16))
             / sum(a[i].numel() for a in m32) for i in range(m32[0].shape[0])]
    c32, c16 = (next(iter(r["classes"].values())) for r in (r32, r16))
    last = len(c32["refinement"]) - 1     # [mean, std over runs] per iteration
    d32, d16 = c32["refinement"][last][0], c16["refinement"][last][0]
    log(f"[trained-eval] foreground share of the f32 masks (last iteration) {fg:.4f} "
        f"(> 0.01); f32 fewshot Dice {c32['fewshot'][0]:.4f} beside the prior's "
        f"{c32['affine'][0]:.4f}; "
        f"last-iteration mean Dice f32 {d32:.4f}, bf16 {d16:.4f} (|diff| < 0.01); masks "
        f"agree per iteration {[round(a, 5) for a in agree]} (> 0.98); phase took "
        f"{time.time() - t0:.1f}s")
    if not (fg > 0.01 and all(math.isfinite(v) for v in c32["fewshot"])):
        raise AssertionError(f"trained checkpoint: foreground share {fg}, fewshot "
                             f"{c32['fewshot']}")
    if not (abs(d32 - d16) < 0.01 and min(agree) > 0.98):
        raise AssertionError(f"bf16 vs f32 on the trained checkpoint: Dice {d16} vs "
                             f"{d32}, agreement {agree}")
    return {"train_s": t_train, "checkpoint": res["checkpoint"], "bf16_episodes": e16,
            "bf16_masks": [m[-1].numpy() for m in m16]}


LGCA_ROIS = ("Liver", "Spleen", "Kidney L", "Kidney R")
LGCA_VOLUME = (280, 272, 272)              # yamls/example_lgca.yml's num_slice, num_y, num_x
LGCA_STEPS = 4
LGCA_CHUNK = 16                            # evaluate_lgca_volume's slices a forward
# card vs CPU, f32 without TF32 (phase lgca-reference): max |diff| over the
# CPU's largest magnitude, the loss's relative difference, and each
# parameter's change against the norm of the change. Set from the first
# measurement (H100): 1.6e-6, 3.8e-6, 6.7e-8, and 5.0e-2 on the deepest
# attention level's 3D embedding, whose adaptive max pool routes the gradient
# through one argmax a window (card and CPU part at near ties)
LGCA_REF_BOUNDS = {"seg_2d": 1e-4, "dsv": 1e-4, "loss": 1e-6, "change": 1e-1}


def lgca_shape(cfg):
    """The LGCA sampler's working shape (D, H, W) and the context volume's."""
    from rpnet_tpu_torch.config import Config
    from rpnet_tpu_torch.episode.lgca_data import LGCAVolumeSampler

    s = LGCAVolumeSampler(cfg["data_dir"], cfg["train_set_name"], Config(cfg))
    return s.shape, tuple(n // d for n, d in zip(s.shape, s.ds))


def make_lgca_config():
    """``yamls/example_lgca.yml`` pointed at a synthetic set: 2 train and 1
    eval volume of 280×272×272 with the example's 4 ROIs."""
    import yaml

    from rpnet_tpu_torch.core.synthetic import generate_dataset

    t0 = time.time()
    paths = generate_dataset(os.path.join(WORK, "lgca_data"), n_train=2, n_test=1,
                             shape=LGCA_VOLUME, classes=LGCA_ROIS, seed=4)
    log(f"[data] 3 synthetic {'x'.join(map(str, LGCA_VOLUME))} LGCA volumes "
        f"({', '.join(LGCA_ROIS)}) in {time.time() - t0:.1f}s")
    with open(os.path.join(ROOT, "yamls", "example_lgca.yml")) as f:
        cfg = yaml.safe_load(f)
    cfg.update(data_dir=paths["data_dir"], train_set_name=paths["train_csv"],
               eval_set_name=paths["test_csv"], out_dir=os.path.join(WORK, "lgca_out"))
    path = os.path.join(WORK, "example_lgca_synthetic.yml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path, cfg


def phase_lgca_reference():
    """Phase lgca-reference: the full-width LGCANetV3 (random seeded weights,
    4 ROIs) on the card vs on the CPU, f32 with TF32 off: one eval forward
    (``seg_2d``, ``dsv``) and one train step (SGD at lr 1, so each
    parameter's change is its gradient; the loss) on a (1, 32, 64, 64, 1)
    volume and 4 slices of 128²."""
    import copy

    import numpy as np
    import torch

    from rpnet_tpu_torch.models.factory import build_lgcanet
    from rpnet_tpu_torch.train.lgca import make_lgca_train_step
    from rpnet_tpu_torch.train.trainer import make_optimizer

    cfg = {"roi_names": list(LGCA_ROIS), "optimizer": "sgd", "init_lr": 1.0,
           "momentum": 0.9, "weight_decay": 0.0, "scheduler_step": 0}
    rng = np.random.RandomState(0)
    zz, yy, xx = np.mgrid[:32, :64, :64] / np.array([32, 64, 64])[:, None, None, None]
    organ = (((zz - 0.5) / 0.3) ** 2 + ((yy - 0.5) / 0.25) ** 2 + ((xx - 0.4) / 0.2) ** 2) <= 1
    vol = np.clip(0.6 * organ - 0.3 + 0.2 * rng.randn(*organ.shape), -1, 1)
    volume = vol[None, ..., None].astype(np.float32)
    up = np.repeat(np.repeat(vol[8:24:4], 2, axis=1), 2, axis=2)          # 4 slices of 128²
    slices = up[..., None].astype(np.float32)
    m_up = np.repeat(np.repeat(organ[8:24:4], 2, axis=1), 2, axis=2)
    mask = np.zeros((4, 128, 128, 4), np.float32)
    mask[..., 0] = m_up
    vmask = np.zeros((1, 32, 64, 64, 4), np.float32)
    vmask[0, ..., 0] = organ
    batch = [torch.from_numpy(a) for a in (volume, slices, mask, vmask)]

    base = build_lgcanet(cfg, seed=7)
    start = copy.deepcopy(base.state_dict())
    fwd, steps = {}, {}
    for dev in ("cpu", "cuda"):
        model = copy.deepcopy(base).to(dev)
        with tf32_off():
            with torch.no_grad():
                out = model.eval()(*(b.to(dev) for b in batch[:2]))
                fwd[dev] = {k: out[k].cpu() for k in ("seg_2d", "dsv")}
            step = make_lgca_train_step(model, make_optimizer(model.parameters(), cfg))
            m = step({"step": 0}, [b.to(dev) for b in batch])
            steps[dev] = (float(m["loss"]), {n: p.detach().cpu()
                                             for n, p in model.named_parameters()})
    errs = {k: float((fwd["cuda"][k] - fwd["cpu"][k]).abs().max()
                     / fwd["cpu"][k].abs().max()) for k in ("seg_2d", "dsv")}
    (loss_c, p_c), (loss_g, p_g) = steps["cpu"], steps["cuda"]
    errs["loss"] = abs(loss_g - loss_c) / abs(loss_c)
    # conv biases that a batch norm or (every context-net conv but dsv's) an
    # instance norm follows get no gradient in exact arithmetic: skipped
    cancelled = bn_cancelled_biases(base) | {
        n for n in p_c if n.startswith("context_net.") and n.endswith(".bias")
        and not n.startswith("context_net.dsv.")}
    changes = {n: float(torch.linalg.vector_norm(p_g[n] - p_c[n])
                        / torch.linalg.vector_norm(p_c[n] - start[n]).clamp_min(1e-12))
               for n in p_c if n not in cancelled}
    errs["change"] = max(changes.values())
    log(f"[lgca-reference] full-width LGCANetV3 (4 ROIs), volume 1x32x64x64, 4 slices of "
        f"128², card vs CPU (TF32 off): " + ", ".join(
            f"{k} {v:.2e} (bound {LGCA_REF_BOUNDS[k]:.0e})" for k, v in errs.items())
        + f"; loss card {loss_g:.6f} CPU {loss_c:.6f}; worst changes " + ", ".join(
            f"{n} {changes[n]:.2e}" for n in sorted(changes, key=changes.get)[-3:]))
    if any(not (v <= LGCA_REF_BOUNDS[k]) for k, v in errs.items()):
        raise AssertionError(f"LGCANetV3 on the card disagrees with the CPU: {errs}")


def phase_lgca_train(yaml_path, cfg):
    """Phase lgca-train: the port's train CLI with ``net: LGCANet_V3`` at the
    example's full width and shapes (288³ working shape, a 144³ context
    volume, 8 slices of 288² a step, 4 ROIs) for ``LGCA_STEPS`` steps, launch
    counts set to 0 just before and read just after: no correlation kernel
    runs on this path; every loss finite; the checkpoint loads into the eval
    model."""
    import torch

    from rpnet_tpu_torch.cli import train as train_cli
    from rpnet_tpu_torch.models.factory import build_lgcanet
    from rpnet_tpu_torch.train.convert import load_into, load_torch_checkpoint

    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.time()
    res = train_cli.main(["--yaml", yaml_path, "--epochs", "1",
                          "--episodes-per-epoch", str(LGCA_STEPS)])
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = read_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    losses, warm = res["step_losses"], res["step_seconds"]
    if len(losses) != LGCA_STEPS or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"LGCA training: {len(losses)} steps, losses {losses}")
    if launches:
        raise AssertionError(f"correlation launches on the LGCA path: {launches}")
    ckpt = load_torch_checkpoint(res["checkpoint"])
    init = build_lgcanet(cfg, seed=int(cfg.get("seed", 0))).state_dict()
    moved = [k for k, v in ckpt["state_dict"].items()
             if k in init and v.is_floating_point() and not torch.equal(v, init[k])]
    load_into(build_lgcanet(cfg), ckpt["state_dict"])
    (_, H, W), ctx = lgca_shape(cfg)
    log(f"[lgca-train] {len(losses)} steps of {cfg['lgca_slices']} slices of {H}x{W} and a "
        f"{'x'.join(map(str, ctx))} context volume: losses {losses}, seconds between steps {warm} (warm mean "
        f"{sum(warm) / len(warm):.4f}s a step; host sampling overlapped: "
        f"{res['data_seconds']}), peak memory allocated {peak_gb:.2f} GiB, CLI wall "
        f"{wall:.1f}s, correlation launches {launches or 0}; {res['checkpoint']}: "
        f"{len(moved)} of {len(init)} tensors moved, loads into the eval model")
    if len(moved) < len(init) // 2:
        raise AssertionError(f"LGCA checkpoint: {len(moved)} of {len(init)} tensors moved")
    return res


def phase_lgca_eval(cfg, ckpt: str):
    """Phase lgca-eval: the port's eval CLI with ``net: LGCANet_V3`` on the
    eval volume with the lgca-train checkpoint, launch counts set to 0 just
    before and read just after: 18 forwards of 16 slices a 288-slice volume, no
    correlation launch, no failed volume, a Dice (or None) per ROI."""
    import torch
    import yaml

    from rpnet_tpu_torch.cli import test_rpnet
    from rpnet_tpu_torch.models.lgca import LGCANetV3

    path = os.path.join(WORK, "example_lgca_eval.yml")
    with open(path, "w") as f:
        yaml.safe_dump(dict(cfg, ckpt=ckpt, out_dir=os.path.join(WORK, "lgca_eval_out")), f)
    calls = []

    def count(module, args, out):
        if isinstance(module, LGCANetV3):
            calls.append(tuple(args[1].shape))

    handle = torch.nn.modules.module.register_module_forward_hook(count)
    try:
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        res = test_rpnet.main(["--yaml", path])
        torch.cuda.synchronize()
        launches = read_launches()
    finally:
        handle.remove()
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    chunks = -(-lgca_shape(cfg)[0][0] // LGCA_CHUNK) * res["volumes"]
    log(f"[lgca-eval] {res['volumes']} volume(s), {len(calls)} forwards of {calls[0]} "
        f"(expected {chunks}), {res['volumes_per_sec']:.4f} volumes/s (first pass, "
        f"includes warm-up; {res['wall_time_sec']:.2f}s), peak memory allocated "
        f"{peak_gb:.2f} GiB, failed volumes {res['failed_volumes']}, correlation "
        f"launches {launches or 0}; dice " + json.dumps(
            {k: v["dice"] for k, v in res["classes"].items()}))
    if res["failed_volumes"] or len(calls) != chunks or launches:
        raise AssertionError(f"LGCA eval: {res['failed_volumes']} failed, {len(calls)} "
                             f"forwards, launches {launches}")
    return res


def phase_native_io(paths):
    """Phase native-io: every NRRD of the main path's dataset read through
    the port's raw cache (``core/native_cache.read_cached``, a fresh cache
    directory) equal byte for byte to the port's Python codec
    (``nrrd_io.read``), and one CT volume's seconds: the Python codec, the
    native decoder, the first read through the raw cache (the conversion
    included) and a warm one. The files were just written: the page cache
    is warm for every read."""
    import numpy as np

    from rpnet_tpu_torch.core import native_cache, nrrd_io

    cache_dir = os.path.join(WORK, "rawcache")
    names = sorted(f for f in os.listdir(paths["data_dir"]) if f.endswith(".nrrd"))
    for name in names:
        path = os.path.join(paths["data_dir"], name)
        (a, meta), (b, _) = native_cache.read_cached(path, cache_dir), nrrd_io.read(path)
        if not meta.get("cached") or a.dtype != b.dtype or a.shape != b.shape \
                or a.tobytes() != b.tobytes():
            raise AssertionError(f"{name}: the raw cache read {a.dtype}{a.shape} {meta}, "
                                 f"nrrd_io {b.dtype}{b.shape}, not byte for byte equal")
    ct = os.path.join(paths["data_dir"], next(n for n in names if n.endswith("_clean.nrrd")))
    first_dir = os.path.join(WORK, "rawcache_first")

    def secs(fn):
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0

    t_py = secs(lambda: nrrd_io.read(ct))
    t_native = secs(lambda: native_cache.read(ct))
    t_first = secs(lambda: native_cache.read_cached(ct, first_dir))
    t_warm = secs(lambda: native_cache.read_cached(ct, first_dir))
    arr = nrrd_io.read(ct)[0]
    log(f"[native-io] {len(names)} NRRD files read through the raw cache equal byte for byte "
        f"to nrrd_io; one {arr.dtype} {'x'.join(map(str, arr.shape))} CT volume "
        f"({arr.nbytes} bytes, gzip {os.path.getsize(ct)} bytes; page cache warm): nrrd_io "
        f"{t_py:.4f}s, native decoder {t_native:.4f}s, raw cache first read (conversion "
        f"included) {t_first:.4f}s, warm {t_warm:.4f}s")
    return {"nrrd_io_s": t_py, "native_s": t_native, "first_s": t_first, "warm_s": t_warm}


def run_serve_cli(cfg, label, artifact, ckpt, arrays=False, **kw):
    """``cli.serve`` on ``artifact`` with ``cfg`` updated by ``kw`` (its own
    out_dir), launch counts set to 0 just before and read just after, every
    episode recorded (with ``arrays`` its prediction too, fetched as the
    live CLI does not: such a pass is not timed against it) → (results,
    launches, episodes, the passes' (stage_timing, pass_wall) lines from
    log_serve)."""
    import torch
    import yaml

    from rpnet_tpu_torch.cli import serve

    out_dir = os.path.join(WORK, f"out_{label}")
    path = os.path.join(WORK, f"serve_{label}.yml")
    with open(path, "w") as f:
        yaml.safe_dump(dict(cfg, out_dir=out_dir, **kw), f)
    with switched({}), recorded_episodes(arrays=arrays) as episodes:
        reset_launches()
        t0 = time.time()
        results = serve.main(["--artifact", artifact, "--yaml", path, "--ckpt", ckpt])
        torch.cuda.synchronize()
        launches = read_launches()
    results["wall"] = time.time() - t0
    if results["failed_episodes"]:
        raise AssertionError(f"served {label}: {results['failed_episodes']} episodes failed")
    with open(os.path.join(out_dir, "log_serve")) as f:
        lines = [l.strip() for l in f]
    passes = list(zip([l for l in lines if l.startswith("stage_timing")],
                      [l for l in lines if l.startswith("pass_wall")]))
    return results, launches, episodes, passes


def export_cli(cfg, label, ckpt):
    """``cli.export`` on the card for ``cfg`` → (artifact directory, manifest)."""
    import yaml

    from rpnet_tpu_torch.cli import export

    out = os.path.join(WORK, f"artifact_{label}")
    path = os.path.join(WORK, f"export_{label}.yml")
    with open(path, "w") as f:
        yaml.safe_dump(dict(cfg, ckpt=ckpt), f)
    with switched({}):
        export.main(["--yaml", path, "--out", out])
    with open(os.path.join(out, "manifest.json")) as f:
        return out, json.load(f)


SERVE_RUNS = 4   # timed passes of the served and live bf16 runs; all but the first warm


def runner_episodes(runner, config):
    """Phase 3's episodes settled by ``runner`` as one pass of the eval CLI
    settles them (its seeding, sampler and ``evaluate``; the lines it
    prints dropped) → every episode's metrics."""
    import io

    import numpy as np

    from rpnet_tpu_torch.cli import test_rpnet
    from rpnet_tpu_torch.episode.sampler import EpisodeSampler

    seed = int(config.get("seed", 0))
    np.random.seed(seed)
    random.seed(seed)
    sampler = EpisodeSampler(config["data_dir"], config["eval_set_name"], config)
    with recorded_episodes() as episodes, contextlib.redirect_stdout(io.StringIO()):
        failures = test_rpnet.evaluate(runner, sampler, config)[-1]
    if failures:
        raise AssertionError(f"{failures} episodes failed outside the CLI")
    return episodes


def largest_diff(a, b):
    """The largest difference of two runs' per-episode metrics."""
    keys = ("dsc_affine", "dsc_fewshot", "ncc_warped", "ncc_raw")
    pairs = [(x[k], y[k]) for x, y in zip(a, b) for k in keys] + \
        [(x["dsc_refinement"][i], y["dsc_refinement"][i])
         for x, y in zip(a, b) for i in x["dsc_refinement"]]
    if len(a) != len(b) or any((u is None) != (v is None) for u, v in pairs):
        raise AssertionError("the runs settled different episodes, or an episode's "
                             "ground truth is empty in one run only")
    return max(abs(u - v) for u, v in pairs if u is not None)


def phase_serve(cfg, main_episodes, trained, card):
    """Phase serve: the main path's configuration (U-Net, 256², r=5, 10
    refinement iterations, 50 affine steps at reg_fit_scale 4, ``slices`` =
    slice_bucket) exported by ``cli.export`` on the card, in bf16 and f32.

    bf16: ``cli.serve`` on phase 3's episodes and weights (its seeded init
    written as a ``.pth``) for ``SERVE_RUNS`` passes beside the live CLI on
    the same ``.pth``, both timed alike (neither fetches its masks):
    per-episode metrics within 1e-3 of phase 3's, row 1 launched 11 times
    an episode by the custom op's CUDA implementation. Then one untimed
    served pass with phase 3g's trained checkpoint (the same artifact: the
    weights are inputs), its masks fetched: metrics within 1e-3 of phase
    3g's live bf16 run, last-iteration masks agreeing with its on > 99.9%
    of pixels.

    f32 (``compute_dtype: float32``): the live runner padding each episode
    to the artifact's slices (``EpisodeRunner(slices=...)``), so that its
    convolutions see the program's batch, against the served runner on
    phase 3's episodes, cuDNN on as the CLIs run: metrics within 1e-5.
    Second witness: ``cli.serve`` against the live f32 CLI, whose batches
    differ (each episode's own slice count), with cuDNN and TF32 off
    (:class:`cudnn_off`): within 1e-5. Export seconds, graph nodes and
    artifact size logged."""
    import copy

    import torch

    from rpnet_tpu_torch.config import Config
    from rpnet_tpu_torch.episode.pipeline import EpisodeRunner
    from rpnet_tpu_torch.models.factory import build_rpnet
    from rpnet_tpu_torch.serve.export import load_artifact, make_artifact_runner

    config = Config(cfg)
    ckpt = os.path.join(WORK, "main_seed.pth")   # phase 3's weights (ckpt: null, seed 0)
    model = build_rpnet(config, num_iter=config["n_test_iter_refinement"],
                        seed=int(cfg.get("seed", 0)))
    torch.save({"epoch": 0, "state_dict": model.state_dict()}, ckpt)
    n_eps = len(main_episodes)

    def warm_rates(passes):   # episodes/s of each warm pass (pass_wall lines)
        return [round(n_eps / float(w.split()[1].rstrip("s")), 3) for _, w in passes[1:]]

    def exported(dcfg, tag):
        art, man = export_cli(dcfg, dcfg["compute_dtype"], ckpt)
        size = sum(os.path.getsize(os.path.join(art, f)) for f in os.listdir(art))
        if man["correlation_ops"] != {"rpnet_torch.local_corr.default": 11}:
            raise AssertionError(f"{tag}: the program's correlation nodes are "
                                 f"{man['correlation_ops']}, expected 11 of local_corr")
        log(f"[{tag}] export {man['export_seconds']:.2f}s, {man['graph_nodes']} graph "
            f"nodes, artifact {size} bytes; {card}")
        return art, man, {"export_s": man["export_seconds"], "nodes": man["graph_nodes"],
                          "bytes": size}

    def served(dcfg, tag, art, weights, runs, arrays=False):
        _, launches, eps, passes = run_serve_cli(dcfg, tag, art, weights, arrays=arrays,
                                                 n_runs=runs)
        if launches != {"local_correlation": 11 * n_eps * runs}:
            raise AssertionError(f"{tag}: launches {launches}, expected "
                                 f"{11 * n_eps * runs} of local_correlation")
        return launches, eps, passes

    out = {}
    # bf16
    bcfg = dict(cfg, compute_dtype="bfloat16")
    art, man, info = exported(bcfg, "serve")
    _, _, _, live_passes = run_cli_config(bcfg, "serve_live", n_runs=SERVE_RUNS, ckpt=ckpt)
    launches, eps, passes = served(bcfg, "serve", art, ckpt, SERVE_RUNS)
    d_main = largest_diff(eps[:n_eps], main_episodes)
    log(f"[serve] per-episode metrics within {d_main:.3g} of phase 3's (1e-3); warm passes "
        f"{warm_rates(passes)} episodes/s served (last: {passes[-1][1]}; {passes[-1][0]}) "
        f"against {warm_rates(live_passes)} live (last: {live_passes[-1][1]}; "
        f"{live_passes[-1][0]}), both without fetching masks; launches {launches}; {card}")
    if not d_main <= 1e-3:
        raise AssertionError(f"served bf16 eval disagrees with phase 3: {d_main}")
    out["serve"] = dict(info, launches=launches, served_eps=warm_rates(passes),
                        live_eps=warm_rates(live_passes))

    t_launches, t_eps, _ = served(bcfg, "serve-trained", art, trained["checkpoint"], 1,
                                  arrays=True)
    d_trained = largest_diff(t_eps, trained["bf16_episodes"][:n_eps])
    masks = trained["bf16_masks"][:n_eps]
    fg = sum(float(m.sum()) for m in masks) / sum(m.size for m in masks)
    agree = sum(int((e["prediction"] == m).sum()) for e, m in zip(t_eps, masks)) \
        / sum(m.size for m in masks)
    log(f"[serve-trained] the bf16 artifact with phase 3g's trained weights: per-episode "
        f"metrics within {d_trained:.3g} of phase 3g's live bf16 run (1e-3); last-iteration "
        f"masks (foreground {fg:.4f} of the live pixels) agree on {agree:.6f} (> 0.999); "
        f"launches {t_launches}")
    if not (d_trained <= 1e-3 and agree > 0.999):
        raise AssertionError(f"served bf16 eval on the trained weights disagrees with the "
                             f"live run: Dice {d_trained}, masks {agree}")
    out["serve-trained"] = {"launches": t_launches}

    # f32
    fcfg = dict(cfg, compute_dtype="float32")
    art, man, info = exported(fcfg, "serve-f32")
    rconfig = Config(fcfg).replace(n_iter_refinement=config["n_test_iter_refinement"])
    live = EpisodeRunner(copy.deepcopy(model), rconfig, "cuda", slices=man["slices"])
    program = make_artifact_runner(load_artifact(art, "cuda"), model.state_dict(),
                                   rconfig, "cuda")
    d_padded = largest_diff(runner_episodes(program, rconfig),
                            runner_episodes(live, rconfig))
    with cudnn_off():
        _, _, live_eps, _ = run_cli_config(fcfg, "serve-f32_live", ckpt=ckpt)
        launches, eps, _ = served(fcfg, "serve-f32", art, ckpt, 1)
    d_live = largest_diff(eps, live_eps)
    log(f"[serve-f32] per-episode metrics within {d_padded:.3g} of the live runner fed "
        f"the same {man['slices']}-slice padded episodes, cuDNN on (1e-5); cli.serve within "
        f"{d_live:.3g} of the live f32 CLI, both with cuDNN and TF32 off (1e-5); "
        f"launches {launches}")
    if not (d_padded <= 1e-5 and d_live <= 1e-5):
        raise AssertionError(f"served f32 eval disagrees with the live path: padded runner "
                             f"{d_padded}, CLI with cuDNN off {d_live}")
    out["serve-f32"] = dict(info, launches=launches)
    return out


def phase_serve_routes(dq):
    """Phase serve-routes: the CRE alone (``models/cre.py``, seeded, bf16,
    eval) at the eval shape under each opt-in forward's switch (rows 5, 6,
    2, 3), exported by ``torch.export`` on the card, saved and loaded: its
    graph holds that route's custom op once; the reloaded program, run with
    no switch set (the route is the artifact's), equals the live CRE call
    under the switch, and the row's launch count moves by one."""
    import torch

    from rpnet_tpu_torch.models.cre import ContextCorrelationEncoder
    from rpnet_tpu_torch.models.blocks import init_
    from rpnet_tpu_torch.serve.export import graph_nodes

    ops = {"local_correlation_band": "local_corr_band", "local_correlation_csub": "local_corr_csub",
           "local_correlation_pdot": "local_corr_pdot",
           "local_correlation_packed": "local_corr_packed"}
    even = next((b for b in dq if b % 2 == 0), dq[0] + 1)   # pack takes pairs
    out = {}
    for i, (label, (env, wrapper)) in enumerate(EVAL_SWITCHES.items()):
        B = even if label == "pack" else dq[0]
        cre = ContextCorrelationEncoder(256, 5)
        init_(cre, torch.Generator().manual_seed(40 + i))
        cre = cre.to("cuda", torch.bfloat16).eval()
        g = torch.Generator(device="cuda").manual_seed(50 + i)
        fm1, fm2 = (torch.randn((B, 64, 64, 256), generator=g, device="cuda",
                                dtype=torch.bfloat16) for _ in range(2))
        path = os.path.join(WORK, f"serve_route_{label}.pt2")
        with switched(env), torch.no_grad():
            t0 = time.time()
            torch.export.save(torch.export.export(cre, (fm1, fm2), strict=False), path)
            t_export = time.time() - t0
            live = cre(fm1, fm2)
        program = torch.export.load(path)
        nodes = [str(n.target) for n in graph_nodes(program)
                 if str(n.target).startswith("rpnet_torch.")]
        with torch.no_grad():
            reset_launches()
            served = program.module()(fm1, fm2)
            torch.cuda.synchronize()
            launches = read_launches()
        diff = (served.float() - live.float()).abs().max().item()
        log(f"[serve-routes] {label} ({env}): CRE at {B}x64x64x256 bf16 exported in "
            f"{t_export:.2f}s, graph correlation nodes {nodes}, reloaded program run with no "
            f"switch set: launches {launches}, max |served - live| {diff}")
        if nodes != [f"rpnet_torch.{ops[wrapper]}.default"] or launches != {wrapper: 1} \
                or not torch.equal(served, live):
            raise AssertionError(f"serve-routes {label}: nodes {nodes}, launches {launches}, "
                                 f"max difference {diff}")
        out[wrapper] = launches
    return out


# --------------------------------------------------------------------------
# multi-process eval, the mesh resolver, preprocessing and debug_nans
# --------------------------------------------------------------------------

MP_REPEAT = 8              # the phase's class CSV lists each eval volume this many times
MP_RUNS = 4                # passes of each run (the first cold)
MP_ORDER = ("one", "two", "two", "one")   # the runs, alternated
MP_TIMEOUT_S = 300         # each worker's time limit
# a worker: the eval CLI's main, then row 1's launches in this process
MP_WORKER = ("import sys\n"
             "sys.path.insert(0, sys.argv[1])\n"
             "import torch\n"
             "from rpnet_tpu_torch.cli import test_rpnet\n"
             "from rpnet_tpu_torch.ops import correlation as tc\n"
             "test_rpnet.main(['--yaml', sys.argv[2]])\n"
             "torch.cuda.synchronize()\n"
             "print('ROW1_LAUNCHES', tc.local_correlation.launches, flush=True)\n")
EPISODE_LINE = r"^(\d+) (\S+) (\S+) affine \((\S+), (\S+)\) (\S+), fewshot (\S+) (.*)$"


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_workers(yamls, label):
    """One eval CLI process per YAML on the card, started together; each
    must exit 0 within ``MP_TIMEOUT_S`` → their stdouts. Every worker is
    killed if one fails or hangs."""
    env = dict(os.environ, GLOO_SOCKET_IFNAME="lo")   # the group is on localhost
    for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "RPNET_MULTIHOST_OPTIONAL"):
        env.pop(k, None)
    procs = [subprocess.Popen([sys.executable, "-c", MP_WORKER, ROOT, y], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for y in yamls]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=MP_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for i, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise AssertionError(f"[{label}] worker {i} exited {p.returncode}:\n{out[-6000:]}")
    return outs


def parse_worker(out):
    """A worker's ({(pass, j): episode line}, [pass walls], [stage_timing
    lines], row 1's launches, the aggregate block)."""
    import re

    lines, passes, walls, timings, launches, agg = out.splitlines(), {}, [], [], None, []
    current = 0
    for i, ln in enumerate(lines):
        m = re.match(r"^(\d+) / (\d+)$", ln)
        if m:
            current = int(m.group(1))
        elif re.match(EPISODE_LINE, ln):
            passes[(current, int(ln.split()[0]))] = ln.rstrip()
        elif ln.startswith("pass_wall "):
            walls.append(float(ln.split()[1].rstrip("s")))
        elif ln.startswith("stage_timing "):
            timings.append(ln)
        elif ln.startswith("ROW1_LAUNCHES "):
            launches = int(ln.split()[1])
        elif ln.startswith("=======Average performance"):
            agg = [l.rstrip() for l in lines[i:i + 3]]
    return passes, walls, timings, launches, agg


def episode_numbers(line):
    """The Dice values of an episode line (affine, fewshot, each iteration)."""
    import re

    m = re.match(EPISODE_LINE, line)
    vals = [m.group(6), m.group(7)] + re.findall(r"ref \d+ (\S+),", m.group(8))
    return [None if v == "None" else float(v) for v in vals]


def main_log_episodes():
    """Phase main's per-episode lines (its CLI's log, its first pass)."""
    import re

    with open(os.path.join(WORK, "out", "log_eval")) as f:
        lines = f.read().splitlines()
    start = lines.index("1 / 1")
    out = {}
    for ln in lines[start + 1:]:
        if ln.startswith("1 / 1"):
            break
        if re.match(EPISODE_LINE, ln):
            out[int(ln.split()[0])] = ln.rstrip()
    return out


def repeated_class_csv(cfg, repeat):
    """A class-CSV directory whose eval-class lists hold each row of
    ``cfg``'s ``repeat`` times, in blocks: ``repeat`` × the episodes a pass
    on the same volumes (each episode draws its support from the other
    rows, so a support may be the query's own volume)."""
    import csv

    out = os.path.join(WORK, f"class_x{repeat}")
    os.makedirs(out, exist_ok=True)
    for roi in cfg["eval_classes"]:
        with open(os.path.join(cfg["class_csv_dir"], f"{roi}.csv")) as f:
            rows = list(csv.DictReader(f))
        with open(os.path.join(out, f"{roi}.csv"), "w", newline="") as f:
            w = csv.DictWriter(f, list(rows[0]))
            w.writeheader()
            for _ in range(repeat):
                w.writerows(rows)
    return out


def phase_multiprocess(cfg):
    """Phase multiprocess: the eval CLI as two processes sharing the card
    (``multihost: true``, a gloo group on a free localhost port,
    ``mesh_shape: {data: 2}`` resolved per process to ``{data: 1}``)
    against one process, on phase main's configuration and volumes with
    each volume listed ``MP_REPEAT`` times (32 episodes a pass, 16 a
    worker), ``MP_RUNS`` passes a run, the runs in the order ``MP_ORDER``,
    each launched the same way (a ``python -c`` wrapper that calls the
    CLI's ``main`` and prints row 1's launches). Every worker exits 0; in
    each pair both print the same aggregate block, the one-process runs'
    too; the union of a pair's episode lines is the one-process run's; every
    episode of the first one-process run's pass 1 whose (query, support)
    pair phase main ran has phase main's Dice, and each of phase main's
    pairs occurs; row 1's launches summed over a pair's workers equal the
    one-process run's. The median warm (passes 2 on) episodes/s of one and
    of two processes, every pass's, and each worker's ``stage_timing`` of
    the first pair logged."""
    import collections
    import statistics

    import torch
    import yaml

    torch.cuda.empty_cache()   # the parent's cached blocks stay free for the workers
    cfg = dict(cfg, class_csv_dir=repeated_class_csv(cfg, MP_REPEAT), n_runs=MP_RUNS)
    runs, seconds = [], []
    for i, kind in enumerate(MP_ORDER):
        if kind == "one":
            names = {"single": {}}
        else:
            group = {"multihost": True, "coordinator_address": f"127.0.0.1:{free_port()}",
                     "num_processes": 2, "mesh_shape": {"data": 2}}
            names = {"p0": dict(group, process_id=0), "p1": dict(group, process_id=1)}
        paths = []
        for name, extra in names.items():
            path = os.path.join(WORK, f"mp_{i}_{name}.yml")
            with open(path, "w") as f:
                yaml.safe_dump(dict(cfg, out_dir=os.path.join(WORK, f"out_mp_{i}_{name}"),
                                    **extra), f)
            paths.append(path)
        t0 = time.time()
        runs.append((kind, [parse_worker(o) for o in run_workers(paths, f"multiprocess-{i}")]))
        seconds.append(time.time() - t0)

    singles = [w[0] for kind, w in runs if kind == "one"]
    pairs = [w for kind, w in runs if kind == "two"]
    s_eps, _, _, s_launch, s_agg = singles[0]
    n_eps = len(s_eps) // MP_RUNS
    expect = 11 * n_eps * MP_RUNS
    exact = True
    # every later run against the first one-process run: a second one-process
    # run, then each pair (its workers' lines and launches together)
    for workers in [[w] for w in singles[1:]] + pairs:
        if not (workers[0][4] and all(w[4] == s_agg for w in workers)):
            raise AssertionError(f"[multiprocess] aggregate blocks differ: "
                                 f"{[w[4] for w in workers]} / {s_agg}")
        union = {k: v for w in workers for k, v in w[0].items()}
        if set(union) != set(s_eps) or sum(len(w[0]) for w in workers) != len(s_eps):
            raise AssertionError(f"[multiprocess] episodes {[sorted(w[0]) for w in workers]} "
                                 f"against the single run's {sorted(s_eps)}")
        if not all(union[k] == s_eps[k] for k in s_eps):   # the same numbers, not bit for bit
            exact = False
            worst = max(abs(a - b) for k in s_eps
                        for a, b in zip(episode_numbers(union[k]), episode_numbers(s_eps[k]))
                        if a is not None and b is not None)
            keys_same = all(union[k].split()[:3] == s_eps[k].split()[:3] for k in s_eps)
            if worst > 1e-4 or not keys_same:
                raise AssertionError(f"[multiprocess] episode lines differ from the single "
                                     f"run's by {worst}")
        if not (s_launch == sum(w[3] for w in workers) == expect):
            raise AssertionError(f"[multiprocess] row 1 launches: single {s_launch}, workers "
                                 f"{[w[3] for w in workers]}; expected {expect}")
    # phase main's episodes, by (query, support): the same volumes give the same Dice
    main_eps = {tuple(ln.split()[1:3]): episode_numbers(ln)
                for ln in main_log_episodes().values()}
    matched, main_worst = collections.Counter(), 0.0
    for (pas, j), line in s_eps.items():
        key = tuple(line.split()[1:3])
        if pas != 1 or key not in main_eps:
            continue
        ours = episode_numbers(line)
        if len(ours) != len(main_eps[key]):
            raise AssertionError(f"[multiprocess] episode {j}: {line} against phase main's "
                                 f"{key} {main_eps[key]}")
        matched[key] += 1
        main_worst = max([main_worst] + [abs(a - b) for a, b in zip(ours, main_eps[key])
                                         if a is not None and b is not None])
    if set(matched) != set(main_eps) or main_worst > 1e-4:
        raise AssertionError(f"[multiprocess] phase main's episodes in pass 1: {dict(matched)} "
                             f"of {sorted(main_eps)}, Dice within {main_worst}")
    # a pass ends with the records' merge (a collective), so the slower
    # worker's pass wall is the pair's
    one = [[n_eps / w for w in single[1]] for single in singles]
    two = [[n_eps / max(a, b) for a, b in zip(p0[1], p1[1])] for p0, p1 in pairs]
    warm_one = [v for r in one for v in r[1:]]
    warm_two = [v for r in two for v in r[1:]]
    med_one, med_two = statistics.median(warm_one), statistics.median(warm_two)
    p0, p1 = pairs[0]
    log(f"[multiprocess] {n_eps} episodes a pass ({n_eps // MP_REPEAT} volumes listed "
        f"{MP_REPEAT}x) x {MP_RUNS} passes a run, runs {'/'.join(MP_ORDER)}; worker shards of "
        f"{len({j for _, j in p0[0]})} and {len({j for _, j in p1[0]})} episodes; episode lines "
        f"{'bit-equal to' if exact else 'within 1e-4 of'} the first single run's in every run; "
        f"{sum(matched.values())} pass-1 episodes of phase main's {len(main_eps)} (query, "
        f"support) pairs {'equal to' if main_worst == 0 else f'within {main_worst:.3g} of'} "
        f"phase main's; row 1 launches {p0[3]} + {p1[3]} = {p0[3] + p1[3]} a pair "
        f"(single {s_launch})")
    log(f"[multiprocess] episodes/s by pass, one process "
        f"{[[round(v, 3) for v in r] for r in one]}, two processes "
        f"{[[round(v, 3) for v in r] for r in two]}; warm (passes 2-{MP_RUNS}) median of "
        f"{len(warm_one)}: one {med_one:.3f}, two {med_two:.3f} (x{med_two / med_one:.2f}); "
        f"run seconds {[round(t, 1) for t in seconds]}")
    for name, worker in (("single", singles[0]), ("p0", p0), ("p1", p1)):
        for i, t in enumerate(worker[2]):
            log(f"[multiprocess] {name} pass {i + 1}: {t}")
    return {"multiprocess-1proc": {"local_correlation": s_launch},
            "multiprocess-2proc": {"local_correlation": p0[3] + p1[3]}}


MESH_SPLIT_ERROR = "mesh shape {'data': 2, 'model': 1} needs 2 devices, have 1"


def phase_mesh(cfg, main_episodes, lgca_cfg):
    """Phase mesh: the eval CLI with ``mesh_shape: {data: 1, model: 1}``
    gives phase main's episode metrics (a 1-device mesh is the one-device
    path); ``{data: 2}`` in one process raises the JAX resolver's
    message; LGCANet_V3 eval with ``{data: 1}`` runs its volume."""
    import yaml

    from rpnet_tpu_torch.cli import test_rpnet

    results, launches, episodes, _ = run_cli_config(cfg, "mesh", mesh_shape={"data": 1,
                                                                             "model": 1})
    with open(os.path.join(WORK, "out_mesh", "log_eval")) as f:
        printed = "[mesh {'data': 1, 'model': 1} over 1 local devices]" in f.read()
    worst = largest_diff(episodes, main_episodes) if len(episodes) == len(main_episodes) \
        else float("inf")
    if worst > 1e-4 or not printed:
        raise AssertionError(f"[mesh] {{data: 1, model: 1}}: episode metrics {worst} from "
                             f"phase main's, mesh line printed {printed}")
    path = os.path.join(WORK, "eval_mesh2.yml")
    with open(path, "w") as f:
        yaml.safe_dump(dict(cfg, mesh_shape={"data": 2}, out_dir=os.path.join(WORK, "out_mesh2")),
                       f)
    try:
        test_rpnet.main(["--yaml", path])
        raise AssertionError("[mesh] {data: 2} on one card ran")
    except ValueError as e:
        if str(e) != MESH_SPLIT_ERROR:
            raise
    path = os.path.join(WORK, "lgca_mesh.yml")
    with open(path, "w") as f:
        yaml.safe_dump(dict(lgca_cfg, mesh_shape={"data": 1}, ckpt=None,
                            out_dir=os.path.join(WORK, "out_lgca_mesh")), f)
    res = test_rpnet.main(["--yaml", path])
    if res["volumes"] != 1 or res["failed_volumes"]:
        raise AssertionError(f"[mesh] LGCA {{data: 1}}: {res}")
    log(f"[mesh] {{data: 1, model: 1}}: {results['episodes']} episodes "
        f"{'equal to' if worst == 0 else f'within {worst:.3g} of'} phase main's, "
        f"launches {launches}; {{data: 2}} raised \"{MESH_SPLIT_ERROR}\"; LGCA {{data: 1}}: 1 "
        f"volume, {res['volumes_per_sec']:.4f} volumes/s (cold), dice "
        + json.dumps({k: v["dice"] for k, v in res["classes"].items()}))
    return launches


PREPROCESS_SHAPE = (280, 272, 272)   # the LGCA phases' volume (seed 4)


def phase_preprocess():
    """Phase preprocess: one synthetic CT volume at full size
    (``PREPROCESS_SHAPE``, seed 4): the host body mask
    (``body_mask_volume``, timed); the torch morphology twins (radius 7) on
    the card over the whole volume, equal to the same functions on the CPU
    on every 8th slice (they work slice by slice), and Otsu's threshold
    equal or one bin apart (logged which), each timed on the card;
    ``affine_register_volumes`` (50 steps, 5 slices of a smoothed pair) on
    the card against the CPU: theta within 1e-3; ``preprocess_patient`` on
    one synthetic 48×272×272 patient into the work directory."""
    import numpy as np
    import torch
    from scipy.ndimage import gaussian_filter, shift

    from rpnet_tpu_torch.core import nrrd_io
    from rpnet_tpu_torch.core.synthetic import make_patient
    from rpnet_tpu_torch.preprocess import abd110, morphology
    from rpnet_tpu_torch.preprocess.offline_registration import affine_register_volumes
    from rpnet_tpu_torch.utils.timing import cuda_ms

    vol = make_patient(PREPROCESS_SHAPE, 4)[0].astype(np.float32)
    mid = PREPROCESS_SHAPE[0] // 2
    t0 = time.time()
    body = morphology.body_mask_volume(vol)
    host_s = time.time() - t0
    # the twins work slice by slice: every 8th slice is held against the CPU,
    # the whole volume timed on the card
    every = slice(None, None, 8)
    cpu_mask, card_mask = torch.from_numpy(body[every]), torch.from_numpy(body).cuda()
    times = {}
    for name in ("dilate", "erode", "closing", "opening"):
        fn = getattr(morphology, f"{name}_torch")
        want = fn(cpu_mask, 7)
        got = fn(card_mask, 7)[every]
        if not torch.equal(got.cpu(), want):
            raise AssertionError(f"[preprocess] {name}_torch: card and CPU differ on "
                                 f"{int((got.cpu() != want).sum())} voxels")
        times[name] = cuda_ms(lambda: fn(card_mask, 7), 5)
    cpu_vol, card_vol = torch.from_numpy(vol), torch.from_numpy(vol).cuda()
    t_cpu = float(morphology.otsu_threshold_torch(cpu_vol))
    t_card = float(morphology.otsu_threshold_torch(card_vol))
    bin_width = (float(cpu_vol.max()) - float(cpu_vol.min())) / 256
    bins_apart = round(abs(t_card - t_cpu) / bin_width)
    if bins_apart > 1 or (bins_apart == 0 and t_card != t_cpu):
        raise AssertionError(f"[preprocess] Otsu: card {t_card}, CPU {t_cpu}")
    times["otsu"] = cuda_ms(lambda: morphology.otsu_threshold_torch(card_vol), 5)
    log(f"[preprocess] {'x'.join(map(str, PREPROCESS_SHAPE))} volume: host body_mask_volume "
        f"{host_s:.2f}s ({body.mean():.3f} of voxels body); radius-7 twins on the card equal "
        f"to the CPU's on every 8th slice; Otsu card {t_card} CPU {t_cpu} "
        f"({'equal' if bins_apart == 0 else 'one bin apart'}, host numpy "
        f"{morphology.otsu_threshold(vol[mid]):.2f} on slice {mid}); card ms "
        + json.dumps({k: round(v, 4) for k, v in times.items()}))

    fixed = gaussian_filter(vol[mid - 2:mid + 3], (0, 3, 3))
    moving = np.stack([shift(s, (4.0, -6.0), order=1, mode="nearest") for s in fixed])
    thetas = {}
    for dev in ("cuda", "cpu"):
        t0 = time.time()
        warped, thetas[dev] = affine_register_volumes(moving, fixed, iters=50, device=dev)
        thetas[dev + "_s"] = time.time() - t0
    diff = float(np.abs(thetas["cuda"] - thetas["cpu"]).max())
    err = (float(np.abs(moving - fixed).mean()), float(np.abs(warped - fixed).mean()))
    log(f"[preprocess] affine_register_volumes (5 smoothed 272x272 slices, 50 steps): theta "
        f"card {np.round(thetas['cuda'], 5).tolist()}, CPU - card {diff:.3g} (bound 1e-3); "
        f"seconds card {thetas['cuda_s']:.2f} CPU {thetas['cpu_s']:.2f}; mean |moving - fixed| "
        f"{err[0]:.2f} -> {err[1]:.2f} after")
    if diff > 1e-3:
        raise AssertionError(f"[preprocess] affine theta card vs CPU {diff}")

    pvol, masks = make_patient((48, 272, 272), 0)
    std = os.path.join(WORK, "preprocess", "standard", "p000")
    os.makedirs(os.path.join(std, "structures"), exist_ok=True)
    nrrd_io.write(os.path.join(std, "img.nrrd"), np.swapaxes(pvol, 0, -1))
    nrrd_io.write(os.path.join(std, "structures", "Liver.nrrd"),
                  np.swapaxes(masks["Liver"], 0, -1))
    save = os.path.join(WORK, "preprocess", "out")
    t0 = time.time()
    res = abd110.preprocess_patient("p000", os.path.dirname(std), save, roi_names=["Liver"])
    written = sorted(os.listdir(save))
    if res["n_rois"] != 1 or len(written) != 4:
        raise AssertionError(f"[preprocess] preprocess_patient: {res}, wrote {written}")
    log(f"[preprocess] preprocess_patient: {res['shape']} in {time.time() - t0:.2f}s, "
        f"wrote {written}")
    return {"theta_diff": diff}


def phase_debug_nans(cfg):
    """Phase debug-nans: the eval CLI with ``debug_nans: true`` on two
    volumes (2 episodes: the fewest with a support each) runs clean on the
    card (11 launches of row 1 an episode, no failure); with a NaN planted
    in episode 0's query volume, episode 0 raises at its first NaN and the
    CLI counts it as the one failed episode, as the JAX CLI counts
    ``jax_debug_nans``'s error."""
    import numpy as np
    import torch
    import yaml

    from rpnet_tpu_torch.cli import test_rpnet
    from rpnet_tpu_torch.config import Config
    from rpnet_tpu_torch.episode.sampler import EpisodeSampler

    with open(cfg["eval_set_name"]) as f:
        pids = f.read().split()[:2]
    split = os.path.join(WORK, "debug_nans_split.csv")
    with open(split, "w") as f:
        f.write("\n".join(pids) + "\n")
    one = dict(cfg, eval_set_name=split, debug_nans=True)
    sampler = EpisodeSampler(one["data_dir"], split, Config(one))
    ci, di = sampler.indices[0]
    pid = sampler.data_info[ci][di]["pid"]
    t0 = time.time()
    results, launches, _, _ = run_cli_config(one, "debug_nans")
    clean_s = time.time() - t0
    if results["episodes"] != 2 or launches != {"local_correlation": 22}:
        raise AssertionError(f"[debug-nans] clean run: {results['episodes']} episodes, "
                             f"launches {launches}")
    load = EpisodeSampler.load_image_and_mask

    def poisoned(s, p, roi):
        img, mask = load(s, p, roi)
        if p == pid:
            img = img.copy()
            img[tuple(n // 2 for n in img.shape)] = np.nan
        return img, mask

    path = os.path.join(WORK, "eval_debug_nans_poisoned.yml")
    with open(path, "w") as f:
        yaml.safe_dump(dict(one, out_dir=os.path.join(WORK, "out_debug_nans_poisoned")), f)
    EpisodeSampler.load_image_and_mask = poisoned
    try:
        poisoned_results = test_rpnet.main(["--yaml", path])
    finally:
        EpisodeSampler.load_image_and_mask = load
    with open(os.path.join(WORK, "out_debug_nans_poisoned", "log_eval")) as f:
        lines = f.read().splitlines()
    caught = [ln for ln in lines
              if ln.startswith(("FloatingPointError:", "RuntimeError:")) and "nan" in ln]
    if (poisoned_results["failed_episodes"] != 1 or not caught
            or not any(ln.startswith("0 EPISODE FAILED") for ln in lines)):
        raise AssertionError(f"[debug-nans] a NaN in episode 0's query volume: "
                             f"{poisoned_results['failed_episodes']} failed episodes, "
                             f"errors {caught}")
    if torch.is_anomaly_enabled():
        raise AssertionError("[debug-nans] anomaly detection left on after the CLI")
    log(f"[debug-nans] 2 episodes with debug_nans clean in {clean_s:.1f}s (launches "
        f"{launches}); with a NaN in episode 0's query volume episode 0 raised and "
        f"was counted failed (1 of 2): {caught[0]}")
    return launches


# ---------------------------------------------------------------------------
# in-process sharding over several devices (phase shard)
# ---------------------------------------------------------------------------

SHARD_EPISODES = 4          # phase 3's episodes through the sharded eval runner
# per-episode Dice, sharded against one device: f32 as the CPU tests hold it;
# bf16 the served-vs-live bound of PERF.md section 2; do_deformable (bf16)
# 5e-3: the one-device deformable runner differs from itself by 2.1e-4 to
# 3.8e-4 (the demons fit's grid_sample backward adds with atomics), and the
# sharded one from it by 3.9e-4 to 1.02e-3 (my chip runs, H100)
SHARD_EVAL_BOUNDS = {"f32": 1e-4, "bf16": 1e-3, "deform": 5e-3}
SHARD_STEPS = 2             # train steps of each sharded step against one device


def metric_diffs(a, b):
    """The largest difference of two runs' per-episode metrics, by kind:
    {"dice": ..., "ncc": ...}."""
    dice_keys, ncc_keys = ("dsc_affine", "dsc_fewshot"), ("ncc_warped", "ncc_raw")
    out = {}
    for kind, pairs in (
            ("dice", [(x[k], y[k]) for x, y in zip(a, b) for k in dice_keys]
             + [(x["dsc_refinement"][i], y["dsc_refinement"][i])
                for x, y in zip(a, b) for i in x["dsc_refinement"]]),
            ("ncc", [(x[k], y[k]) for x, y in zip(a, b) for k in ncc_keys])):
        if len(a) != len(b) or any((u is None) != (v is None) for u, v in pairs):
            raise AssertionError("the runs settled different episodes, or an episode's "
                                 "ground truth is empty in one run only")
        out[kind] = max(abs(u - v) for u, v in pairs if u is not None)
    return out


def shard_devices(n: int):
    """n devices for a mesh: the cards in turn where the host has two or
    more, else n logical devices on cuda:0 → (devices, what they are)."""
    import torch

    cards = torch.cuda.device_count()
    devices = [torch.device("cuda", i % cards) for i in range(n)]
    what = (f"real cards ({cards} on the host)" if cards >= 2 else
            "logical devices on cuda:0 (one card: the sharded code path, not the speed "
            "of several cards)")
    return devices, what


def shard_eval(cfg, devices):
    """(a): phase 3's first ``SHARD_EPISODES`` episodes (spec path) through
    the one-device runner and the runner over ``{data: 2}`` with the same
    seeded weights, in bf16, in f32 and with ``do_deformable`` in bf16,
    compared with cuDNN off (torch's own convolutions, whose per-slice
    results do not depend on the batch, which the shards halve; TF32 off):
    per-episode Dice within ``SHARD_EVAL_BOUNDS`` (the NCCs' difference
    logged, and with ``do_deformable`` the one-device runner's difference
    from itself); row 1's launches 11 an episode on each shard. In bf16 with
    cuDNN on, as the CLI runs: the difference logged (cuDNN picks its
    algorithms by batch size), a warm pass of each runner timed, and one
    warm sharded dispatch under the sync debug mode. → (results, launches
    by run, problems)."""
    import torch

    from rpnet_tpu_torch.config import Config
    from rpnet_tpu_torch.episode.pipeline import EpisodeRunner
    from rpnet_tpu_torch.episode.sampler import EpisodeSampler
    from rpnet_tpu_torch.models.factory import build_rpnet
    from rpnet_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh({"data": 2}, devices=devices)
    out, launches_by_run, problems = {}, {}, []
    for tag, over in (("bf16", {}), ("f32", {"compute_dtype": "float32"}),
                      ("deform", {"do_deformable": True})):
        config = Config(dict(cfg, **over))
        config = config.replace(n_iter_refinement=config["n_test_iter_refinement"])
        sampler = EpisodeSampler(config["data_dir"], config["eval_set_name"], config)
        n = min(SHARD_EPISODES, len(sampler))
        picks = [sampler.draw_supports(j) for j in range(n)]
        specs = [sampler.sample_spec(j, picks=picks[j]) for j in range(n)]

        def run(runner):
            queued = [runner.dispatch_spec(spec, sampler) for spec in specs]
            return [runner.finalize(d) for d in queued]

        one = EpisodeRunner(build_rpnet(config, num_iter=10, seed=0), config, "cuda")
        sharded = EpisodeRunner(build_rpnet(config, num_iter=10, seed=0), config, "cuda",
                                mesh=mesh)
        torch.cuda.reset_peak_memory_stats()
        with cudnn_off():
            want = run(one)
            reset_launches()
            got = run(sharded)
            torch.cuda.synchronize()
            launches, per_shard = read_launches(), list(sharded.shard_launches)
        diffs = metric_diffs(got, want)
        worst = diffs["dice"]
        timing, cudnn = {}, ""
        if tag == "deform":   # the one-device runner against itself
            with cudnn_off():
                again = metric_diffs(run(one), want)
            cudnn = (f"; the one-device runner against itself: Dice {again['dice']:.3g}, NCC "
                     f"{again['ncc']:.3g}")
        if tag == "bf16":   # cuDNN on, as the CLI runs; a warm pass of each timed alike
            cudnn_worst = metric_diffs(run(sharded), run(one))
            for name, runner in (("one device", one), ("sharded", sharded)):
                t0 = time.perf_counter()
                run(runner)
                torch.cuda.synchronize()
                timing[name] = n / (time.perf_counter() - t0)
            cudnn = (f"; with cuDNN on (the CLI's setting) Dice within "
                     f"{cudnn_worst['dice']:.3g}, NCC {cudnn_worst['ncc']:.3g}; warm "
                     f"episodes/s one device {timing['one device']:.3f}, sharded "
                     f"{timing['sharded']:.3f}")
        peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
        ok = (worst <= SHARD_EVAL_BOUNDS[tag] and launches == {"local_correlation": 22 * n}
              and per_shard == [11 * n, 11 * n])
        log(f"[shard-eval] {tag}: {n} episodes over {{data: 2}}, cuDNN off: per-episode "
            f"Dice within {worst:.3g} of one device (bound {SHARD_EVAL_BOUNDS[tag]}), NCC "
            f"within {diffs['ncc']:.3g}; "
            f"row 1's launches {launches}, per shard {per_shard} (11 an episode each); peak "
            f"memory allocated {peak_gb:.2f} GiB" + cudnn)
        if not ok:
            problems.append(f"[shard-eval] {tag}: Dice {worst}, launches {launches}, "
                            f"per shard {per_shard}")
        launches_by_run[f"shard-eval-{tag}"] = launches
        out[tag] = {"worst": diffs, "per_shard": per_shard, "peak_gb": peak_gb, **timing}
        if tag == "bf16":
            run(sharded)                              # warm again, then one dispatch checked
            torch.cuda.synchronize()
            d, syncs, host_ms = synchronizing_calls(lambda: sharded.dispatch_spec(specs[0],
                                                                                  sampler))
            sharded.finalize(d)
            log(f"[shard-sync] a warm sharded spec dispatch: {host_ms:.1f} ms on the host, "
                f"synchronizing calls {len(syncs)}")
            if syncs:
                problems.append(f"the sharded dispatch blocks the host: {syncs[:3]}")
        del one, sharded
        torch.cuda.empty_cache()
    return out, launches_by_run, problems


def shard_lgca(lgca_cfg, devices):
    """(b): ``yamls/example_lgca.yml``'s model and shapes, ``SHARD_STEPS``
    steps of ``sharded_lgca_train_step`` over ``{data: 2}`` against as many
    one-device steps from the same seeded state and samples (f32, TF32 off):
    losses within rtol 1e-3, parameters within 5e-3; then the eval volume
    through ``evaluate_lgca_volume`` with and without the mesh: per-ROI Dice
    within 1e-3; no correlation launch."""
    import numpy as np
    import torch

    from rpnet_tpu_torch.config import Config
    from rpnet_tpu_torch.episode.lgca_data import LGCAVolumeSampler
    from rpnet_tpu_torch.parallel.mesh import make_mesh
    from rpnet_tpu_torch.train.lgca import (evaluate_lgca_volume, init_lgca,
                                            make_lgca_train_step, sharded_lgca_train_step)

    config = Config(lgca_cfg)
    mesh = make_mesh({"data": 2}, devices=devices)
    sampler = LGCAVolumeSampler(config["data_dir"], config["train_set_name"], config,
                                mode="train")
    rng = np.random.RandomState(0)
    samples = [sampler.sample(j % len(sampler), rng=rng) for j in range(SHARD_STEPS)]
    keys = ("volume", "slices", "mask", "downsampled_volume_mask")
    batches = [tuple(torch.from_numpy(s[k]).cuda() for k in keys) for s in samples]
    losses, models = {}, {}
    torch.cuda.reset_peak_memory_stats()
    with tf32_off():
        for tag in ("one device", "sharded"):
            model, optimizer, state = init_lgca(config, 0, mesh.first)
            step = (make_lgca_train_step(model, optimizer) if tag == "one device"
                    else sharded_lgca_train_step(model, optimizer, mesh))
            reset_launches()
            t0 = time.perf_counter()
            losses[tag] = [float(step(state, b)["loss"]) for b in batches]
            torch.cuda.synchronize()
            log(f"[shard-lgca] {tag}: {SHARD_STEPS} steps in {time.perf_counter() - t0:.2f}s "
                f"(the first cold), losses {losses[tag]}")
            models[tag] = model
        launches = read_launches()
        one, sharded = models["one device"], models["sharded"]
        worst_param = max(float((p - q).detach().abs().max())
                          for p, q in zip(sharded.parameters(), one.parameters()))
        ev = LGCAVolumeSampler(config["data_dir"], config["eval_set_name"], config, mode="eval")
        sample = ev.sample(0)
        t0 = time.perf_counter()
        want = evaluate_lgca_volume(sharded, sample, mesh.first)
        t1 = time.perf_counter()
        got = evaluate_lgca_volume(sharded, sample, mesh.first, mesh=mesh)
        t2 = time.perf_counter()
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    dice_diff = [abs(got[k] - want[k]) for k in want if want[k] is not None]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses["sharded"], losses["one device"]))
    nones_agree = all((got[k] is None) == (want[k] is None) for k in want)
    log(f"[shard-lgca] {{data: 2}}: losses within {loss_rel:.3g} relative (rtol 1e-3), "
        f"parameters within {worst_param:.3g} (atol 5e-3) after {SHARD_STEPS} steps; the "
        f"eval volume's per-ROI Dice {json.dumps(got)} within "
        f"{max(dice_diff, default=0.0):.3g} of one device's (1e-3; {t1 - t0:.2f}s one "
        f"device, {t2 - t1:.2f}s sharded, both f32 TF32 off); correlation launches "
        f"{launches or 0}; peak memory allocated {peak_gb:.2f} GiB")
    problems = [] if (loss_rel <= 1e-3 and worst_param <= 5e-3 and nones_agree
                      and max(dice_diff, default=0.0) <= 1e-3 and not launches) else \
        ["[shard-lgca] the sharded LGCA step or eval disagrees"]
    return {"loss_rel": loss_rel, "worst_param": worst_param, "peak_gb": peak_gb}, problems


def shard_train(train_cfg, devices):
    """(c): the example's training block (E=4 episodes of k=12 at 256², U-Net
    d4, r=5, 4 refinement iterations, registration prior, AdamW; soft masks,
    as phase 6's bf16 case: with the example's hard masks the loss jumps
    where a refinement probability crosses 0.5, and the sharded step's f32
    rounding, its convolutions on half the batch and half the channels,
    moved the first loss by 8.2e-6 to 9.9e-5 relative in three calls) for
    ``SHARD_STEPS`` steps of ``sharded_train_step`` over ``{data: 2, model:
    2}`` against as many one-device steps from the same weights and batches,
    f32 with TF32 off, within phase 6's card-against-CPU bounds: each loss
    within 1e-4 relative, and each parameter tensor's gradient of the first
    step (the same weights on both sides) within 3e-2 (norm of the
    difference over norm of the gradient; the biases a batch norm cancels
    left out; a split weight's gradient is its row-slices' in the
    optimizer, concatenated), or within twice what the same one-device step
    shows with each batch's episodes in another order (the same function,
    its sums in another order: the f32 noise of these sums); rows 4 and 7
    launched 5 times a row and step."""
    import copy
    import random as stdlib_random

    import numpy as np
    import torch

    from rpnet_tpu_torch.cli.train import collate_batch
    from rpnet_tpu_torch.config import Config
    from rpnet_tpu_torch.episode.sampler import EpisodeSampler
    from rpnet_tpu_torch.models.factory import build_rpnet
    from rpnet_tpu_torch.parallel.mesh import make_mesh, shard_params
    from rpnet_tpu_torch.train.trainer import (make_optimizer, make_train_step,
                                               sharded_train_step)

    def gradients(model, optimizer, placement):
        """Each parameter's gradient by name, from the optimizer's entries
        (a split weight: its row-slices, in order)."""
        entries = iter([p for g in optimizer.param_groups for p in g["params"]])
        out = {}
        for name, p in model.named_parameters():
            parts = [next(entries) for _ in range(2 if placement[name] == "model" else 1)]
            out[name] = torch.cat([torch.zeros_like(q) if q.grad is None else q.grad
                                   for q in parts]).to("cpu")
        return out

    config = Config(dict(train_cfg, soft_mask=True))
    mesh = make_mesh({"data": 2, "model": 2}, devices=devices)
    E, k = int(config["batch_size"]), int(config["k"])
    stdlib_random.seed(0)
    np.random.seed(0)
    sampler = EpisodeSampler(config["data_dir"], config["train_set_name"], config, mode="train")
    batches = [tuple(torch.from_numpy(a).cuda() for a in collate_batch(
        [sampler.sample((s * E + j) % len(sampler)) for j in range(E)], target_k=k))
        for s in range(SHARD_STEPS)]
    base = build_rpnet(config, num_iter=config["n_iter_refinement"], seed=0, align=True)
    placement = shard_params(base, mesh)
    losses, grads = {}, {}
    torch.cuda.reset_peak_memory_stats()
    # the witness: each batch's episodes in another order (the loss is their mean)
    reordered = [tuple(torch.roll(t, E // 2, dims=0) for t in b) for b in batches]
    with tf32_off():
        for tag in ("one device", "reordered", "sharded"):
            model = copy.deepcopy(base).to(mesh.first)
            optimizer = make_optimizer(model.parameters(), config)
            step = (sharded_train_step(model, config, optimizer, mesh) if tag == "sharded"
                    else make_train_step(model, config, optimizer))
            reset_launches()
            t0 = time.perf_counter()
            state = {"step": 0}
            losses[tag] = []
            for i, b in enumerate(reordered if tag == "reordered" else batches):
                losses[tag].append(float(step(state, b)["loss"]))
                if i == 0:     # the first step's gradients: the same weights everywhere
                    grads[tag] = gradients(model, optimizer, placement if tag == "sharded"
                                           else dict.fromkeys(placement, "replicated"))
            torch.cuda.synchronize()
            run_launches = read_launches()
            if tag == "sharded":
                launches = run_launches
            log(f"[shard-train] {tag}: {SHARD_STEPS} steps in {time.perf_counter() - t0:.2f}s "
                f"(the first cold), losses {losses[tag]}, correlation launches {run_launches}")
            del model, optimizer, step
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    cancelled = bn_cancelled_biases(base)
    def rel(tag):   # each tensor's gradient difference from one device's, over its norm
        one = grads["one device"]
        return {n: float(torch.linalg.vector_norm(grads[tag][n] - one[n])
                         / torch.linalg.vector_norm(one[n]).clamp_min(1e-12))
                for n in one if n not in cancelled}

    sharded, witness = rel("sharded"), rel("reordered")
    over = {n: v for n, v in sharded.items() if v > max(3e-2, 2 * witness[n])}
    worst = max(sharded.values())
    log("[shard-train] largest first-step gradient differences, sharded (reordered "
        "one-device step): " + ", ".join(f"{n} {sharded[n]:.3g} ({witness[n]:.3g})"
                                          for n in sorted(sharded, key=sharded.get)[-4:])
        + f"; the reordered step's largest {max(witness.values()):.3g}")
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses["sharded"], losses["one device"]))
    expected = {"local_correlation": 5 * 2 * SHARD_STEPS,
                "local_correlation_bwd": 5 * 2 * SHARD_STEPS}
    log(f"[shard-train] {{data: 2, model: 2}}, E={E} k={k}, soft masks: losses within {loss_rel:.3g} "
        f"relative (1e-4), worst first-step gradient difference {worst:.3g} of the gradient "
        f"(3e-2 or twice the reordered step's: {len(over)} tensors over; "
        f"{sum(v == 'model' for v in placement.values())} weights split over model); launches {launches} (expected {expected}); peak memory allocated "
        f"{peak_gb:.2f} GiB")
    problems = [] if (loss_rel <= 1e-4 and not over and launches == expected) else \
        ["[shard-train] the dp x tp step disagrees with one device"]
    return ({"loss_rel": loss_rel, "worst": worst, "launches": launches, "peak_gb": peak_gb},
            problems)


def phase_shard(eval_cfg, lgca_cfg, train_cfg):
    """Phase shard: in-process sharding over several devices (the port of
    ``__graft_entry__.dryrun_multichip`` at full width): (a) the sharded
    RP_Net eval, (b) the sharded LGCA step and eval, (c) the dp × tp RP_Net
    train step, each against its one-device counterpart on the card. Every
    part runs; the phase fails at its end if any check failed."""
    devices, what = shard_devices(4)
    log(f"[shard] devices: {what}: {{data: 2}} over {[str(d) for d in devices[:2]]}, "
        f"{{data: 2, model: 2}} over {[str(d) for d in devices]}")
    t0 = time.time()
    evals, eval_launches, problems = shard_eval(eval_cfg, devices[:2])
    t1 = time.time()
    lgca, lgca_problems = shard_lgca(lgca_cfg, devices[:2])
    t2 = time.time()
    train, train_problems = shard_train(train_cfg, devices)
    log(f"[shard] seconds: eval {t1 - t0:.1f}, lgca {t2 - t1:.1f}, train "
        f"{time.time() - t2:.1f}")
    problems += lgca_problems + train_problems
    if problems:
        raise AssertionError("; ".join(problems))
    return {"eval": evals, "eval_launches": eval_launches, "lgca": lgca, "train": train,
            "devices": what}


def gpu_line() -> str:
    proc = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60)
    if proc.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {proc.stderr}")
    return proc.stdout.strip().splitlines()[0]


T_START = time.time()


class Run:
    """What the phases share: the datasets and configurations, made once
    where a phase first asks for them, and each phase's result by name."""

    def __init__(self, card: str):
        self.card = card
        self.results = {}
        self._made = {}

    def _once(self, key, make):
        if key not in self._made:
            self._made[key] = make()
        return self._made[key]

    def eval_data(self):
        """The main path's dataset → {paths, yaml, cfg, dq}."""
        def make():
            paths = make_dataset()
            yaml_path, cfg = write_config(paths)
            dq = main_path_slices(cfg)
            log(f"[data] query slices per episode: {dq}")
            return {"paths": paths, "yaml": yaml_path, "cfg": cfg, "dq": dq}
        return self._once("eval", make)

    def train_data(self):
        """The training dataset and YAML → (yaml path, cfg)."""
        return self._once("train", make_train_config)

    def lgca_data(self):
        return self._once("lgca", make_lgca_config)


def run_kernels(run):
    """Phase 2: every kernel against its plain version (see the docstring)."""
    import torch

    dq = run.eval_data()["dq"]
    cfg = run.eval_data()["cfg"]
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
    # rows 4 and 7 at the training breadth backbones' shapes (phase 5d): 512
    # channels, two 256-channel groups / blocks, VGG's 1/8 and ResNet's 1/4
    wide_train = {}
    for i, (name, hw) in enumerate((("vgg", 32), ("resnet", 64))):
        shape = (4 * int(cfg["k"]), hw, hw, 512)
        wide_train[name] = {
            "forward": check_local_corr(shape, 5, f32, seed=90 + 2 * i, timed=True),
            "backward": check_local_corr_bwd(shape, 5, f32, seed=91 + 2 * i, timed=True)}
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
    return {"main_case": main_case, "wide": wide, "train_fwd": train_fwd,
            "train_bwd": train_bwd, "wide_train": wide_train, "variant": variant,
            "variant_train": variant_train}


def fit_launches(fn):
    """fn() with ``fit_affine.launches`` set to 0 just before → (its result,
    the affine fit kernel's launches)."""
    from rpnet_tpu_torch.registration.affine import fit_affine

    fit_affine.launches = 0
    out = fn()
    return out, fit_affine.launches


def run_main(run):
    (_, launches, outputs, episodes), fits = fit_launches(
        lambda: phase_main_path(run.eval_data()["yaml"]))
    log(f"[main] affine fit kernel launches: {fits}")
    return {"launches": launches, "outputs": outputs, "episodes": episodes,
            "fit_launches": fits}


def run_training(run):
    (res, launches, _), fits = fit_launches(lambda: phase_training(*run.train_data()))
    log(f"[train] affine fit kernel launches: {fits}")
    return {"res": res, "launches": launches, "fit_launches": fits}


def run_train_breadth(run):
    return phase_train_breadth(run.train_data()[1])


def run_lgca_train(run):
    return phase_lgca_train(*run.lgca_data())


# the phases, in the order they run: name → (what it runs, the phases whose
# results it reads). ``--phases`` runs the named ones and what they need;
# the build comes first whatever is named.
PHASES = {
    "build": (lambda run: phase_build(), ()),
    "native-io": (lambda run: phase_native_io(run.eval_data()["paths"]), ()),
    "kernels": (run_kernels, ()),
    "sweep-kernels": (lambda run: phase_sweep_kernels(), ()),
    "sweep": (lambda run: phase_sweep(), ()),
    "grid-sample": (lambda run: (check_grid_sample(), check_affine_sharp()), ()),
    "affine-fit": (lambda run: phase_affine_fit(), ()),
    "main": (run_main, ()),
    "eval-switches": (lambda run: phase_eval_switches(
        run.eval_data()["yaml"], run.eval_data()["dq"], run.results["main"]["outputs"]),
        ("main",)),
    "data-paths": (lambda run: phase_data_paths(run.eval_data()["cfg"]), ()),
    "breadth": (lambda run: phase_breadth(run.eval_data()["cfg"], run.eval_data()["paths"]),
                ()),
    "reg-reference": (lambda run: phase_registration_reference(run.eval_data()["cfg"]), ()),
    "deform": (lambda run: phase_deformable_eval(run.eval_data()["cfg"],
                                                 run.results["main"]["episodes"]), ("main",)),
    "eval-3d": (lambda run: phase_eval_3d(), ()),
    "serve-routes": (lambda run: phase_serve_routes(run.eval_data()["dq"]), ()),
    "bf16-rounding": (lambda run: measure_bf16_rounding(), ()),
    "reference": (lambda run: [phase_reference(b) for b in ("UNet", "vgg", "resnet")], ()),
    "training": (run_training, ()),
    "train-switches": (lambda run: phase_train_switches(
        run.train_data()[1], run.results["training"]["res"]["step_losses"][0]), ("training",)),
    "train-deform": (lambda run: phase_deformable_training(
        run.train_data()[1], run.results["training"]["res"]["step_losses"][0]), ("training",)),
    "train-breadth": (run_train_breadth, ()),
    "train-reference": (lambda run: [phase_train_reference(b, d) for b, d in TRAIN_REFERENCE],
                        ()),
    "trained": (lambda run: phase_trained_eval(run.train_data()[1], run.eval_data()["cfg"]), ()),
    "serve": (lambda run: phase_serve(run.eval_data()["cfg"], run.results["main"]["episodes"],
                                      run.results["trained"], run.card), ("main", "trained")),
    "lgca-reference": (lambda run: phase_lgca_reference(), ()),
    "lgca-train": (run_lgca_train, ()),
    "lgca-eval": (lambda run: phase_lgca_eval(run.lgca_data()[1],
                                              run.results["lgca-train"]["checkpoint"]),
                  ("lgca-train",)),
    "multiprocess": (lambda run: phase_multiprocess(run.eval_data()["cfg"]), ("main",)),
    "mesh": (lambda run: phase_mesh(run.eval_data()["cfg"], run.results["main"]["episodes"],
                                    run.lgca_data()[1]), ("main",)),
    "preprocess": (lambda run: phase_preprocess(), ()),
    "debug-nans": (lambda run: phase_debug_nans(run.eval_data()["cfg"]), ()),
    "shard": (lambda run: phase_shard(run.eval_data()["cfg"], run.lgca_data()[1],
                                      run.train_data()[1]), ()),
}


def selected_phases(names):
    """The phases to run for ``--phases`` ``names`` (None: all), with what
    they need and the build, in ``PHASES`` order."""
    if names is None:
        return list(PHASES)
    unknown = [n for n in names if n not in PHASES]
    if unknown:
        raise SystemExit(f"chip_smoke: unknown phase(s) {unknown}; the phases are "
                         f"{', '.join(PHASES)}")
    want, todo = {"build"}, list(names)
    while todo:
        name = todo.pop()
        if name not in want:
            want.add(name)
            todo.extend(PHASES[name][1])
    return [n for n in PHASES if n in want]


def kernel_entries(results):
    """The kernel JSON's entries: one a row whose check phase ran, with the
    launches of the path phases that ran. A path phase that did not run
    gives no ``launches_by_run`` entry, and a row whose path did not run
    has ``launches`` null."""
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

    get = results.get

    def ran(phase, runs):   # ``runs`` ({run: launches}) where ``phase`` ran
        return runs() if phase in results else {}

    def count(runs, key, wrapper):   # a run's launches of ``wrapper``, None if not run
        return runs[key].get(wrapper, 0) if key in runs else None

    # row 1: the main path's count beside its timed shape; the data-path,
    # breadth, deformable, eval_3d, served and LGCA eval runs' counts per run
    row1_runs = {**ran("main", lambda: {"main": results["main"]["launches"]}),
                 **{f"data-{k}": v for k, v in (get("data-paths") or {}).items()},
                 **{f"breadth-{k}": v for k, v in (get("breadth") or {}).items()},
                 **ran("deform", lambda: {f"deform-{k}": v
                                          for k, v in results["deform"].items()}),
                 **ran("eval-3d", lambda: {"eval3d": results["eval-3d"]}),
                 **{k: v["launches"] for k, v in (get("serve") or {}).items()},
                 **ran("lgca-eval", lambda: {"lgca-eval": {}}),   # it requires none
                 **(get("multiprocess") or {}),
                 **ran("mesh", lambda: {"mesh": results["mesh"]}),
                 **ran("debug-nans", lambda: {"debug-nans": results["debug-nans"]}),
                 **ran("shard", lambda: results["shard"]["eval_launches"])}
    train_runs = {**ran("training", lambda: {"train": results["training"]["launches"]}),
                  **ran("train-deform", lambda: {"train-deform": results["train-deform"]}),
                  **{f"train-{k}": v for k, v in (get("train-breadth") or {}).items()},
                  **ran("lgca-train", lambda: {"lgca-train": {}}),   # it requires none
                  **ran("shard", lambda: {"shard-train": results["shard"]["train"]["launches"],
                                          "shard-lgca": {}})}
    opt_in_runs = list((get("eval-switches") or {}).values()) + \
        list((get("train-switches") or {}).values())

    def opt_in(wrapper):   # launches over the path runs that select it
        if "eval-switches" not in results and "train-switches" not in results:
            return None
        return sum(run.get(wrapper, 0) for run in opt_in_runs)

    entries = []
    k = get("kernels")
    if k:
        entries += [
            entry("local_correlation", "local_corr.cu", 289, k["main_case"],
                  count(row1_runs, "main", "local_correlation"),
                  launches_by_run={n: v.get("local_correlation", 0) for n, v in row1_runs.items()},
                  wide_shapes=k["wide"]),
            entry("local_correlation_train_forward", "local_corr.cu", 36, k["train_fwd"],
                  count(train_runs, "train", "local_correlation"),
                  launches_by_run={n: v.get("local_correlation", 0)
                                   for n, v in train_runs.items()},
                  wide_shapes={n: v["forward"] for n, v in k["wide_train"].items()}),
            entry("local_correlation_bwd", "local_corr_bwd.cu", 776, k["train_bwd"],
                  count(train_runs, "train", "local_correlation_bwd"),
                  launches_by_run={n: v.get("local_correlation_bwd", 0)
                                   for n, v in train_runs.items()},
                  wide_shapes={n: v["backward"] for n, v in k["wide_train"].items()})]
        routes = ran("serve-routes", lambda: {"serve-routes": results["serve-routes"]})
        for name, kind, line in (("local_correlation_band", "band", 122),
                                 ("local_correlation_pdot", "pdot", 289),
                                 ("local_correlation_packed", "pack", 446),
                                 ("local_correlation_csub", "csub", 198)):
            source = "local_corr_csub.cu" if kind == "csub" else "local_corr_band.cu"
            entries.append(entry(name, source, line, k["variant"][kind], opt_in(name),
                                 launches_by_run={n: v[name].get(name, 0)
                                                  for n, v in routes.items()}))
    fit = get("affine-fit")
    if fit:
        fit_runs = {"affine-fit": fit["launches"],
                    **ran("main", lambda: {"main": results["main"]["fit_launches"]}),
                    **ran("training", lambda: {"train": results["training"]["fit_launches"]})}
        row = fit["cases"][(AFFINE_FIT_CASES[1][0], AFFINE_FIT_CASES[1][1], "volumes")]
        entries.append(entry(
            "fit_affine", "affine_fit.cu",
            "none: the JAX package leaves the fit to XLA (rpnet_tpu/registration/affine.py)",
            row, fit_runs.get("main"), launches_by_run=fit_runs, library_ms=row["library_ms"],
            cases=[{k: c[k] for k in ("kind", "shape", "max_abs_err", "loss_rel_err", "ms",
                                      "plain_ms", "bound_ms")}
                   for c in fit["cases"].values()]))
    if get("sweep-kernels") and get("sweep"):
        sweep_timed, sweep_launches = get("sweep-kernels"), get("sweep")
        entries += [
            entry("corr_swapped", "local_corr_sweep.cu", "bench_tools/corr_sweep.py:37",
                  sweep_timed[("swapped", "bfloat16")], sweep_launches["corr_swapped"]),
            entry("corr_rotmxu", "local_corr_sweep.cu", "bench_tools/corr_sweep.py:100",
                  sweep_timed[("rotmxu", "bfloat16")], sweep_launches["corr_rotmxu"])]
    return entries, row1_runs, train_runs


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description="Bring-up check of rpnet_tpu_torch on one GPU")
    ap.add_argument("--phases", default=None,
                    help="comma-separated phases to run alone (with what they need and "
                         f"the build); default all: {', '.join(PHASES)}")
    args = ap.parse_args(argv)
    names = selected_phases(args.phases.split(",") if args.phases else None)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on the GPU only",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import rpnet_tpu_torch  # noqa: F401 — fails where the package is absent

    card = gpu_line()
    log(f"[device] {torch.cuda.get_device_name(0)} | nvidia-smi: {card} | "
        f"torch {torch.__version__} CUDA {torch.version.cuda}")
    log(f"[phases] running {', '.join(names)}")
    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)

    run = Run(card)
    seconds = {}
    for name in names:
        t0 = time.time()
        run.results[name] = PHASES[name][0](run)
        seconds[name] = round(time.time() - t0, 1)
        log(f"[phases] {name} {seconds[name]}s; the script so far "
            f"{time.time() - T_START:.1f}s")
    log(f"[phases] seconds: {json.dumps(seconds)}")

    kernels, row1_runs, train_runs = kernel_entries(run.results)
    res = run.results
    if "kernels" in res:
        for name, r in res["kernels"]["wide"].items():
            log(f"[kernels] {name} shape, local_correlation: {json.dumps(r)}")
        for kind, r in res["kernels"]["variant_train"].items():
            log(f"[kernels] training shape, {kind}: {json.dumps(r)}")
    log(f"[kernels] local_correlation launches by run {row1_runs}; training {train_runs}")
    for (kind, dtype), r in (res.get("sweep-kernels") or {}).items():
        log(f"[kernels] sweep shape, {kind} {dtype}: {json.dumps(r)}")
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
