"""A/B of versions of ``rpnet_tpu_torch/ops/csrc/local_corr_sweep.cu`` on one card.

    git show <commit>:rpnet_tpu_torch/ops/csrc/local_corr_sweep.cu > build/old.cu
    python3 tools/sweep_ab.py tree build/old.cu [more.cu ...]

Each source (``tree`` is the checkout's) is built with nvcc into its own
library under ``build/`` (one nvcc each, all started together; the ptxas
report printed), its two kernels (corr_swapped at every h_tile, corr_rotmxu
with d² and 128 lanes) are held against the plain version at the edge
shapes and the sweep shape, on outputs filled with NaN first, and then all
sources are timed in turns (A B ... B A) with
``rpnet_tpu_torch.utils.timing.cuda_ms`` at the sweep shape (32×64×64×256,
r=5) in f32 and bf16. corr_swapped is timed as the kernel alone (its planar
f32 output) and as the wrapper's whole function (kernel, transpose and
cast). Needs a CUDA device and nvcc.
"""
import ctypes
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))   # tools/ -> repo
sys.path.insert(0, ROOT)
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from rpnet_tpu_torch.ops import correlation as tc  # noqa: E402
from rpnet_tpu_torch.ops import kernels  # noqa: E402
from rpnet_tpu_torch.utils.timing import cuda_ms  # noqa: E402

bf16, f32 = torch.bfloat16, torch.float32
SWEEP = (32, 64, 64, 256)


def nvcc(n_src):
    n, src = n_src
    path = os.path.join(ROOT, "rpnet_tpu_torch/ops/csrc/local_corr_sweep.cu") if src == "tree" else src
    so = os.path.join(ROOT, "build", f"sab_{n}.so")
    return so, subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-Xptxas", "-v", "-o", so,
                               path], capture_output=True, text=True)


def call(lib, kind, fm1, fm2, out, r, tile):
    B, H, W, C = fm1.shape
    fn = getattr(lib, f"local_corr_{kind}_{'bf16' if fm1.dtype == bf16 else 'f32'}")
    err = fn(fm1.data_ptr(), fm2.data_ptr(), out.data_ptr(), B, H, W, C, r, tile,
             tc.correlation_scale(C), torch.cuda.current_stream().cuda_stream)
    assert err == 0, err


def inputs(shape, dt, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return (torch.randn(shape, generator=g, device="cuda").to(dt),
            torch.randn(shape, generator=g, device="cuda").to(dt))


def check(lib, src, shape, r, dt, seed):
    """Both kernels of ``lib`` against the plain version; returns the failures."""
    B, H, W, C = shape
    d2 = (2 * r + 1) ** 2
    fm1, fm2 = inputs(shape, dt, seed)
    ref = tc.local_correlation_plain(fm1.float(), fm2.float(), r)
    bad = []
    runs = [("swapped", ht, (B, d2, H, W), f32) for ht in (8, 16, 32)]
    if H + 2 * r <= 128:
        runs += [("rotmxu", lanes, (B, H, W, lanes), dt) for lanes in (d2, 128)]
    for kind, tile, oshape, odt in runs:
        out = torch.full(oshape, float("nan"), dtype=odt, device="cuda")
        try:
            call(lib, kind, fm1, fm2, out, r, tile)
            torch.cuda.synchronize()
        except Exception as e:  # noqa: BLE001
            print("LAUNCH FAILED", src, kind, tile, shape, r, dt, repr(e)[:300], flush=True)
            bad.append((kind, tile, shape))
            continue
        pad_ok = True
        if kind == "swapped":
            val = out.permute(0, 2, 3, 1).to(dt)
        else:
            pad_ok = tile == d2 or bool((out[..., d2:] == 0).all())
            val = out[..., :d2]
        if dt == bf16:
            ok = torch.allclose(val.float(), ref, rtol=2 ** -7, atol=1e-3)
        else:
            ok = (val - ref).abs().max().item() <= 1e-4
        err = (val.float() - ref).abs().max().item()
        if not (ok and pad_ok):
            bad.append((kind, tile, shape))
        print(f"check {src} {kind} {tile} {shape} r={r} {str(dt)[6:]}: max err vs f32 sum "
              f"{err:.3e} padding zero {pad_ok} {'ok' if ok and pad_ok else 'DISAGREES'}",
              flush=True)
    return bad


def main(srcs):
    print(cs.gpu_line(), flush=True)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    t0 = time.time()
    with ThreadPoolExecutor(len(srcs)) as pool:
        built = list(pool.map(nvcc, enumerate(srcs)))
    libs = {}
    for src, (so, proc) in zip(srcs, built):
        if proc.returncode:
            print("BUILD FAILED", src, proc.stderr[-4000:], flush=True)
            continue
        for line in proc.stderr.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print(src, "|", line.strip(), flush=True)
        lib = ctypes.CDLL(so)
        p, i = ctypes.c_void_p, ctypes.c_int
        for kind in ("swapped", "rotmxu"):
            for dt in ("f32", "bf16"):
                fn = getattr(lib, f"local_corr_{kind}_{dt}")
                fn.argtypes = [p, p, p, i, i, i, i, i, i, ctypes.c_float, p]
                fn.restype = i
        libs[src] = lib
    print(f"built in {time.time() - t0:.1f}s", flush=True)

    edges = [((3, 20, 20, 64), 2), ((2, 40, 100, 128), 5), ((1, 6, 72, 48), 5),
             ((3, 20, 20, 64), 1), ((3, 20, 20, 64), 3), ((2, 16, 64, 320), 5),
             ((2, 64, 24, 64), 1), ((2, 64, 24, 64), 3), ((1, 100, 16, 64), 5),
             ((1, 3, 5, 16), 5), (SWEEP, 5)]
    bad = {}
    for src, lib in libs.items():
        for n, (shape, r) in enumerate(edges):
            for dt in (bf16, f32):
                bad.setdefault(src, []).extend(check(lib, src, shape, r, dt, n))
    print("disagreeing:", {k: v for k, v in bad.items() if v}, flush=True)

    d2 = 121
    for dt in (bf16, f32):
        fm1, fm2 = inputs(SWEEP, dt, 0)
        planar = torch.empty((32, d2, 64, 64), dtype=f32, device="cuda")
        res_out = torch.empty((32, 64, 64, d2), dtype=dt, device="cuda")
        outs = {lanes: torch.empty((32, 64, 64, lanes), dtype=dt, device="cuda")
                for lanes in (d2, 128)}
        cases = {}
        for src, lib in libs.items():
            for ht in (8, 16, 32):
                cases[f"{src} swapped ht={ht} kernel"] = (
                    lambda lib=lib, ht=ht: call(lib, "swapped", fm1, fm2, planar, 5, ht))

            def whole(lib=lib):
                call(lib, "swapped", fm1, fm2, planar, 5, 16)
                res_out.copy_(planar.permute(0, 2, 3, 1))
            cases[f"{src} swapped ht=16 with transpose+cast"] = whole
            for lanes in (d2, 128):
                cases[f"{src} rotmxu lanes={lanes}"] = (
                    lambda lib=lib, lanes=lanes: call(lib, "rotmxu", fm1, fm2, outs[lanes], 5, lanes))
        cases["transpose+cast alone"] = lambda: res_out.copy_(planar.permute(0, 2, 3, 1))
        cases["local_corr.cu (NHWC store)"] = lambda: tc.local_correlation(fm1, fm2, 5)
        order = list(cases) + list(cases)[::-1]
        times = {k: [] for k in cases}
        for name in order:
            times[name].append(cuda_ms(cases[name], reps=20))
        for name, ts in times.items():
            print(f"time {str(dt)[6:]:8s} {name:50s} " + " ".join(f"{t:.4f}" for t in ts)
                  + " ms", flush=True)
    return 1 if any(bad.values()) else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:] or ["tree"]))
