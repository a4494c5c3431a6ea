"""A/B of versions of ``rpnet_tpu_torch/ops/csrc/local_corr_bwd.cu`` on one card.

    git show <commit>:rpnet_tpu_torch/ops/csrc/local_corr_bwd.cu > build/old.cu
    python3 tools/corr_bwd_ab.py tree build/old.cu [more.cu ...]

``tree`` is the checkout's source. Each source is built with nvcc into its
own library under ``build/`` (ignored by git; one nvcc each, all started
together; the ptxas report printed). Each is held against the plain version
(``ops.correlation.local_correlation_bwd_plain``) at the tiling edges
(ragged 20×20 and 40×100, C = 48, 64, 128 and 320, r = 1, 2, 3, 5) and the
training shape, in f32 (atol 1e-4) and bf16 (rtol 2**-7, atol 1e-3 of the
f32 result), with g as the CRE's strided concat view and contiguous, on
outputs filled with NaN first. Then all are timed in turns (A B ... B A)
with ``rpnet_tpu_torch.utils.timing.cuda_ms`` at 48×64×64×256 f32 (the
training shape) and at 32×64×64×256 in f32 and bf16 (the kernel sweep's),
r = 5. A source given as ``time:path`` is timed but not checked. Needs a
CUDA device and nvcc.
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
EDGES = [((3, 20, 20, 64), 2), ((2, 40, 100, 128), 5), ((1, 6, 72, 48), 5),
         ((2, 16, 64, 320), 5), ((3, 20, 20, 64), 1), ((3, 20, 20, 64), 3),
         ((2, 64, 64, 256), 4), ((48, 64, 64, 256), 5)]
TIMED = [((48, 64, 64, 256), f32), ((32, 64, 64, 256), f32), ((32, 64, 64, 256), bf16)]


def nvcc(n_src):
    n, src = n_src
    path = src.split("time:", 1)[-1]
    if path == "tree":
        path = os.path.join(ROOT, "rpnet_tpu_torch/ops/csrc/local_corr_bwd.cu")
    so = os.path.join(ROOT, "build", f"bab_{n}.so")
    return so, subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-Xptxas", "-v", "-o", so,
                               path], capture_output=True, text=True)


def call(lib, g, fm1, fm2, dfm1, dfm2, r):
    B, H, W, C = fm1.shape
    fn = lib.local_corr_bwd_bf16 if fm1.dtype == bf16 else lib.local_corr_bwd_f32
    err = fn(g.data_ptr(), g.stride(2), fm1.data_ptr(), fm2.data_ptr(), dfm1.data_ptr(),
             dfm2.data_ptr(), B, H, W, C, r, tc.correlation_scale(C),
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"local_corr_bwd launch failed (cudaError {err})")


def inputs(shape, r, dt, seed, strided=True):
    B, H, W, C = shape
    d2 = (2 * r + 1) ** 2
    gen = torch.Generator(device="cuda").manual_seed(seed)
    fm1 = torch.randn(shape, generator=gen, device="cuda").to(dt)
    fm2 = torch.randn(shape, generator=gen, device="cuda").to(dt)
    width = d2 + C if strided else d2
    g = torch.randn((B, H, W, width), generator=gen, device="cuda").to(dt)[..., :d2]
    return g, fm1, fm2


def check(lib, src, shape, r, dt, seed, strided):
    g, fm1, fm2 = inputs(shape, r, dt, seed, strided)
    out = [torch.full(shape, float("nan"), dtype=dt, device="cuda") for _ in range(2)]
    try:
        call(lib, g, fm1, fm2, *out, r)
        torch.cuda.synchronize()
    except Exception as e:  # noqa: BLE001
        print("LAUNCH FAILED", src, shape, r, dt, repr(e)[:300], flush=True)
        return False
    ref = tc.local_correlation_bwd_plain(g.float(), fm1.float(), fm2.float(), r)
    if dt == bf16:
        ok = all(torch.allclose(o.float(), p, rtol=2 ** -7, atol=1e-3) for o, p in zip(out, ref))
    else:
        ok = all((o - p).abs().max().item() <= 1e-4 for o, p in zip(out, ref))
    err = max((o.float() - p).abs().max().item() for o, p in zip(out, ref))
    print(f"check {src} {shape} r={r} {str(dt)[6:]} g {'strided' if strided else 'contiguous'}: "
          f"max err vs f32 result {err:.3e} {'ok' if ok else 'DISAGREES'}", flush=True)
    return ok


def main(srcs):
    print(cs.gpu_line(), flush=True)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    t0 = time.time()
    with ThreadPoolExecutor(len(srcs)) as pool:   # one nvcc per source, together
        built = list(pool.map(nvcc, enumerate(srcs)))
    libs = {}
    for src, (so, proc) in zip(srcs, built):
        if proc.returncode:
            errors = [line for line in proc.stderr.splitlines() if "error" in line]
            print("BUILD FAILED", src, "\n".join(errors[:20]), flush=True)
            continue
        for line in proc.stderr.splitlines():
            if "ptxas info" in line or "ptxas warning" in line or "bytes stack" in line:
                print(src, "|", line.strip(), flush=True)
        lib = ctypes.CDLL(so)
        p, i = ctypes.c_void_p, ctypes.c_int
        for fn in (lib.local_corr_bwd_f32, lib.local_corr_bwd_bf16):
            fn.argtypes = [p, i, p, p, p, p, i, i, i, i, i, ctypes.c_float, p]
            fn.restype = i
        libs[src] = lib
    print(f"built in {time.time() - t0:.1f}s", flush=True)

    bad = set()
    for src, lib in libs.items():
        if src.startswith("time:"):
            continue
        for n, (shape, r) in enumerate(EDGES):
            for dt in (f32, bf16):
                for strided in (True, False):
                    if not check(lib, src, shape, r, dt, 100 + n, strided):
                        bad.add(src)
    print("disagreeing:", sorted(bad), flush=True)

    for shape, dt in TIMED:
        g, fm1, fm2 = inputs(shape, 5, dt, 0)
        out = [torch.empty(shape, dtype=dt, device="cuda") for _ in range(2)]
        order = list(libs) + list(libs)[::-1]
        res = {k: [] for k in libs}
        for name in order:
            res[name].append(cuda_ms(lambda lib=libs[name]: call(lib, g, fm1, fm2, *out, 5),
                                     reps=20))
        bound = cs.corr_bound(shape, 5, str(dt)[6:], backward=True)[0]
        print(f"TIMES {shape} {str(dt)[6:]} (bound {bound:.4f} ms): "
              + ", ".join(f"{k}: {v}" for k, v in res.items()), flush=True)
    return 1 if bad or len(libs) < len(srcs) else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:] or ["tree"]))
