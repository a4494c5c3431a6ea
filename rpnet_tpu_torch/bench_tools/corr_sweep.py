"""Sweep the local-correlation kernels at the real episode shape.

    python -m rpnet_tpu_torch.bench_tools.corr_sweep                 # on the card
    python -m rpnet_tpu_torch.bench_tools.corr_sweep --platform cpu --shape 2 16 16 64 --radius 3

The counterpart of ``bench_tools/corr_sweep.py``: B=32 query slices, 64x64
at C=256 (U-Net d4 of a 256² episode), r=5, inputs from numpy
``RandomState(0)``. Each of the JAX sweep's lines runs the port's kernel for
it and prints its time and ``maxerr`` (largest |out - reference|):

  ====================================  =====================================
  JAX sweep line                        port
  ====================================  =====================================
  xla f32                               ``local_correlation_plain`` (the
                                        reference of every f32 line)
  pallas f32 / bf16 ht=*, f32-out       ``local_corr.cu`` (no tile choice: one
                                        line each; f32-out is the bf16
                                        result read as f32)
  pallas-mxu f32 / bf16 ht=*            ``local_corr_band.cu`` (one line each)
  pallas-csub f32 / bf16 ht=*           ``local_corr_csub.cu`` with its
                                        transposes (one line each)
  pallas-swapped f32 / bf16 ht=*        :func:`corr_swapped` (``h_tile`` is
                                        accepted for signature parity: one
                                        kernel for the three f32 lines)
  pallas-rotmxu f32 / bf16 wt=*,        :func:`corr_rotmxu` (``w_tile`` is a
  bf16out                               TPU tile size: one line each; plus a
                                        ``full_lanes`` line)
  bwd xla shifted, bwd pallas ht=*      ``local_correlation_bwd_plain``,
                                        ``local_corr_bwd.cu``
  xla-mxu f32, bwd xla-mxu banded       not carried (XLA formulations, no
                                        kernel): printed as such
  ====================================  =====================================

bf16 lines are held against the f32 sums of the bf16 inputs. A line's
tolerance is the kernels' own: f32 within 1e-4, bf16 within one bf16 ulp
(rtol 2**-7, atol 1e-3). Times are CUDA events around 20 back-to-back calls,
the median of 3 rounds (``utils.timing.cuda_ms``); under ``--platform cpu``
they are the host's wall clock around the plain versions, and say nothing of
the card. ``SWEEP_ONLY`` (comma-separated substrings of line names) and
``SWEEP_BWD_ONLY`` select lines as in the JAX sweep. A line that raises
prints ``FAILED``; one that misses its tolerance prints ``MISSED``;
:func:`main` returns both, and the command exits 1 if there are any.

The module also holds the two kernels no other module of the port has, the
TPU sweep's own variants (``ops/csrc/local_corr_sweep.cu``), each with its
plain version and a launch count on its wrapper.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from rpnet_tpu_torch.ops.correlation import (FORWARDS, _check_kernel_inputs,
                                             correlation_scale,
                                             local_correlation,
                                             local_correlation_band,
                                             local_correlation_bwd,
                                             local_correlation_bwd_plain,
                                             local_correlation_plain)
from rpnet_tpu_torch.utils.timing import cuda_ms

SWAPPED_H_TILES = (8, 16, 32)   # corr_swapped's kernel instances (rows a block)
LANES = 128                     # corr_rotmxu's full_lanes width
F32_TOL = 1e-4
BF16_RTOL, BF16_ATOL = 2 ** -7, 1e-3


def _on_cpu(*ts) -> bool:
    return all(t.device.type == "cpu" for t in ts)


def corr_swapped_plain(fm1: torch.Tensor, fm2: torch.Tensor, r: int,
                       h_tile: int = 16) -> torch.Tensor:
    """The plain version of :func:`corr_swapped`. The kernel's planar f32
    sums, scaled, transposed and cast to fm1's dtype, are
    :func:`local_correlation_plain`'s value; ``h_tile`` is accepted for
    signature parity."""
    return local_correlation_plain(fm1, fm2, r)


def corr_swapped(fm1: torch.Tensor, fm2: torch.Tensor, r: int,
                 h_tile: int = 16) -> torch.Tensor:
    """``_corr_kernel_swapped`` (``bench_tools/corr_sweep.py:37``): the local
    correlation written planar (B, d², H, W) in f32, channel dx·d + dy, by a
    tensor-core band kernel of ``ops/csrc/local_corr_sweep.cu`` (bf16 stores
    each source row's band once it is multiplied, f32 its tile at the
    block's end), then transposed to (B, H, W, d²) and cast to fm1's dtype
    as the JAX wrapper does (``:95``). ``h_tile`` (8, 16 or 32, the TPU kernel's rows a grid step) is
    accepted for signature parity: the Hopper kernel's block owns 4 query
    rows whatever it is. A CPU tensor goes to :func:`corr_swapped_plain`; a
    CUDA tensor launches the kernel or raises."""
    if _on_cpu(fm1, fm2):
        return corr_swapped_plain(fm1, fm2, r, h_tile)
    _check_kernel_inputs("corr_swapped", fm1, fm2, r, max_batch=65535)
    if h_tile not in SWAPPED_H_TILES:
        raise ValueError(f"corr_swapped: h_tile {h_tile}; the kernel is built for "
                         f"{SWAPPED_H_TILES} query rows a block")
    from rpnet_tpu_torch.ops import kernels

    B, H, W, C = fm1.shape
    d2 = (2 * r + 1) ** 2
    planar = torch.empty((B, d2, H, W), dtype=torch.float32, device=fm1.device)
    out = torch.empty((B, H, W, d2), dtype=fm1.dtype, device=fm1.device)
    if out.numel() == 0:
        return out
    kernels.launch_local_corr_sweep("swapped", fm1, fm2, planar, r, h_tile,
                                    correlation_scale(C))
    corr_swapped.launches += 1
    out.copy_(planar.permute(0, 2, 3, 1))   # the transpose and the cast, one pass
    return out


corr_swapped.launches = 0   # kernel launches (the plain path never counts)


def _check_rot_height(name: str, H: int, r: int) -> None:
    if H + 2 * r > LANES:
        raise ValueError(f"{name}: the rotate variant assumes H+2r <= {LANES} "
                         f"(H={H}, r={r})")


def corr_rotmxu_plain(fm1: torch.Tensor, fm2: torch.Tensor, r: int, w_tile: int = 16,
                      full_lanes: bool = False, out_f32: bool = True) -> torch.Tensor:
    """The plain version of :func:`corr_rotmxu`: the local correlation in
    fm1's dtype, zero-padded to 128 channels with ``full_lanes``."""
    _check_rot_height("corr_rotmxu", fm1.shape[1], r)
    out = local_correlation_plain(fm1, fm2, r)
    if full_lanes:
        out = torch.nn.functional.pad(out, (0, LANES - out.shape[-1]))
    return out


def corr_rotmxu(fm1: torch.Tensor, fm2: torch.Tensor, r: int, w_tile: int = 16,
                full_lanes: bool = False, out_f32: bool = True) -> torch.Tensor:
    """``_corr_rot_kernel`` of the sweep (``bench_tools/corr_sweep.py:100``):
    the local correlation as tensor-core band products on NHWC
    (``ops/csrc/local_corr_sweep.cu``, the band kernel's body), written
    (B, H, W, d²) in fm1's dtype, or (B, H, W, 128) with channels d²..127
    zero when ``full_lanes`` (the next 1x1 conv can take K = 128). Needs
    H + 2r <= 128, as the JAX variant asserts (``:164``).

    ``w_tile`` is the TPU kernel's VMEM tile (query columns a grid step),
    accepted for signature parity; the Hopper kernel's block owns 4 query
    rows × 64 (bf16) or 32 (f32) queries. ``out_f32`` changes no value: the
    TPU variant's f32 output is cast to fm1's dtype by its wrapper, so both
    store the f32 sum rounded once. A CPU tensor goes to :func:`corr_rotmxu_plain`; a CUDA tensor
    launches the kernel or raises."""
    if _on_cpu(fm1, fm2):
        return corr_rotmxu_plain(fm1, fm2, r, w_tile, full_lanes, out_f32)
    _check_kernel_inputs("corr_rotmxu", fm1, fm2, r, max_batch=65535)
    B, H, W, C = fm1.shape
    _check_rot_height("corr_rotmxu", H, r)
    from rpnet_tpu_torch.ops import kernels

    lanes = LANES if full_lanes else (2 * r + 1) ** 2
    out = torch.empty((B, H, W, lanes), dtype=fm1.dtype, device=fm1.device)
    if out.numel() == 0:
        return out
    kernels.launch_local_corr_sweep("rotmxu", fm1, fm2, out, r, lanes,
                                    correlation_scale(C))
    corr_rotmxu.launches += 1
    return out


corr_rotmxu.launches = 0


# ------------------------------------------------------------------ sweep

def _host_ms(fn, reps: int, warmup: int = 1, rounds: int = 3) -> float:
    """Host wall time of one ``fn()`` in ms (CPU runs only), median of rounds."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        times.append((time.perf_counter() - t0) * 1e3 / reps)
    return sorted(times)[len(times) // 2]


def _within(out: torch.Tensor, ref: torch.Tensor, bf16: bool) -> bool:
    if bf16:
        return torch.allclose(out.float(), ref, rtol=BF16_RTOL, atol=BF16_ATOL)
    return float((out.float() - ref).abs().max()) <= F32_TOL


def main(shape=(32, 64, 64, 256), r: int = 5, device: str = "cuda",
         reps: int = 20) -> list:
    """Run the sweep; returns the names of the lines that failed or missed
    their tolerance (empty when all held)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the kernel sweep runs on the card; no CUDA device "
                           "is available (pass --platform cpu for the plain versions)")
    on_card = device.type == "cuda"
    unit = "ms" if on_card else "ms (host wall clock, plain versions)"

    def timed(fn):
        return cuda_ms(fn, reps) if on_card else _host_ms(fn, reps)

    B, H, W, C = shape
    d = 2 * r + 1
    rng = np.random.RandomState(0)
    fm1 = torch.from_numpy(rng.randn(B, H, W, C).astype(np.float32)).to(device)
    fm2 = torch.from_numpy(rng.randn(B, H, W, C).astype(np.float32)).to(device)
    fm1h, fm2h = fm1.to(torch.bfloat16), fm2.to(torch.bfloat16)
    ref = local_correlation_plain(fm1, fm2, r)
    ref_h = local_correlation_plain(fm1h.float(), fm2h.float(), r)

    only = os.environ.get("SWEEP_ONLY")   # substring filter, comma-separated
    rows, failures = [], []

    def selected(name):
        return not only or any(s in name for s in only.split(","))

    def line(name, fn, want=ref, bf16=False, pad=False):
        """Check and time one line; ``want`` is the reference (a tuple of
        them for the backward's two gradients)."""
        if not selected(name):
            return
        try:
            outs = fn()
            if on_card:
                torch.cuda.synchronize()
            outs, wants = (outs, want) if isinstance(want, tuple) else ((outs,), (want,))
            ok = True
            if pad:   # full_lanes: d² channels, then exact zeros
                ok = bool((outs[0][..., d * d:] == 0).all())
                outs = (outs[0][..., :d * d],)
            err = max(float((o.float() - w).abs().max()) for o, w in zip(outs, wants))
            ok = ok and all(_within(o, w, bf16) for o, w in zip(outs, wants))
            dt = timed(fn)
            rows.append((name, dt))
            print(f"{name:38s} {dt:8.4f} {unit}   maxerr {err:.2e}"
                  + ("" if ok else "   MISSED tolerance"), flush=True)
            if not ok:
                failures.append(name)
        except Exception as e:  # noqa: BLE001 — a line's failure is its output
            print(f"{name:38s} FAILED: {type(e).__name__}: {e}", flush=True)
            failures.append(name)

    def not_carried(name):
        if selected(name):
            print(f"{name:38s} not carried (an XLA formulation, no kernel)", flush=True)

    if not os.environ.get("SWEEP_BWD_ONLY"):
        csub = FORWARDS["csub"]
        line("xla f32", lambda: local_correlation_plain(fm1, fm2, r))
        line("pallas f32", lambda: local_correlation(fm1, fm2, r))
        for ht in (8, 16, 32):
            line(f"pallas-swapped f32 ht={ht}", lambda ht=ht: corr_swapped(fm1, fm2, r, h_tile=ht))
        line("pallas-mxu f32", lambda: local_correlation_band(fm1, fm2, r))
        line("pallas-csub f32", lambda: csub(fm1, fm2, r))
        line("pallas-csub bf16", lambda: csub(fm1h, fm2h, r), ref_h, bf16=True)
        line("pallas bf16", lambda: local_correlation(fm1h, fm2h, r), ref_h, bf16=True)
        line("pallas bf16 f32-out", lambda: local_correlation(fm1h, fm2h, r).float(), ref_h,
             bf16=True)
        line("pallas-swapped bf16 ht=16", lambda: corr_swapped(fm1h, fm2h, r, h_tile=16),
             ref_h, bf16=True)
        line("pallas-mxu bf16", lambda: local_correlation_band(fm1h, fm2h, r), ref_h, bf16=True)
        not_carried("xla-mxu f32")
        line("pallas-rotmxu f32", lambda: corr_rotmxu(fm1, fm2, r))
        line("pallas-rotmxu bf16", lambda: corr_rotmxu(fm1h, fm2h, r), ref_h, bf16=True)
        line("pallas-rotmxu bf16out", lambda: corr_rotmxu(fm1h, fm2h, r, out_f32=False),
             ref_h, bf16=True)
        line("pallas-rotmxu bf16 full_lanes",
             lambda: corr_rotmxu(fm1h, fm2h, r, full_lanes=True), ref_h, bf16=True, pad=True)
        if rows:
            best = min(rows, key=lambda t: t[1])
            print(f"\nbest fwd: {best[0]} at {best[1]:.4f} {unit}", flush=True)

    if only and "bwd" not in only:
        return failures
    g = torch.from_numpy(rng.randn(B, H, W, d * d).astype(np.float32)).to(device)
    grads = local_correlation_bwd_plain(g, fm1, fm2, r)
    line("bwd xla shifted", lambda: local_correlation_bwd_plain(g, fm1, fm2, r), grads)
    line("bwd pallas", lambda: local_correlation_bwd(g, fm1, fm2, r), grads)
    not_carried("bwd xla-mxu banded")
    return failures


def _parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--platform", default="gpu", choices=("gpu", "cpu"),
                   help="gpu (default; raises without one) or cpu (plain versions)")
    p.add_argument("--shape", type=int, nargs=4, default=(32, 64, 64, 256),
                   metavar=("B", "H", "W", "C"))
    p.add_argument("--radius", type=int, default=5)
    return p.parse_args(argv)


if __name__ == "__main__":
    args = _parse(sys.argv[1:])
    failed = main(tuple(args.shape), args.radius,
                  "cpu" if args.platform == "cpu" else "cuda")
    if failed:
        print(f"sweep: {len(failed)} line(s) failed: {', '.join(failed)}", file=sys.stderr)
    sys.exit(1 if failed else 0)
