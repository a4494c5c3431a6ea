"""A/B of versions of ``rpnet_tpu_torch/ops/csrc/local_corr_csub.cu`` on one card.

    git show <commit>:rpnet_tpu_torch/ops/csrc/local_corr_csub.cu > build/old_csub.cu
    python3 tools/csub_ab.py tree build/old_csub.cu [more.cu ...]

``tree`` is the checkout's source; a source given as ``time:path`` (a
diagnostic copy) is timed but not checked. Each source is built with nvcc
into its own library under ``build/`` (ignored by git; the ptxas report of
every kernel printed, and from its SASS the highest register, the HGMMAs,
the waits for all of them, which show serialized wgmmas, and the spill
stores), held against the plain version on (B, H, C, W) inputs at the
tiling edges (C = 16, 48, 320, r = 1..5, ragged W = 20 and 5, W past one
block) and the eval shape in both dtypes, on NaN-filled outputs: bf16 within
rtol 2**-7, atol 1e-3 of the f32 sum, f32 within atol 1e-4. A source that
refuses a shape (the parent takes only W % 4 == 0) prints LAUNCH FAILED for
it. Then all are timed in turns (A B C ... C B A) with
``rpnet_tpu_torch.utils.timing.cuda_ms`` at the eval shape (26x64x64x256
bf16, r=5) and the training shape (48x64x64x256 f32), beside the tree's
``local_correlation`` on the same values in NHWC (rows 1 and 4, the same
function) and the csub route's two transposes alone. Needs a CUDA device and
nvcc.
"""
import ctypes, os, re, subprocess, sys, time
from concurrent.futures import ThreadPoolExecutor
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))   # tools/ -> repo
sys.path.insert(0, ROOT)
import torch
import chip_smoke as cs
from rpnet_tpu_torch.ops import kernels
from rpnet_tpu_torch.ops import correlation as tc
from rpnet_tpu_torch.utils.timing import cuda_ms

bf16, f32 = torch.bfloat16, torch.float32
print(cs.gpu_line(), flush=True)
srcs = sys.argv[1:] or ["tree"]
libs = {}
t0 = time.time()
os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)


def nvcc(n_src):   # one nvcc per source, all started together
    n, src = n_src
    src = src.split("time:", 1)[-1]
    path = (os.path.join(ROOT, "rpnet_tpu_torch/ops/csrc/local_corr_csub.cu") if src == "tree"
            else src)
    so = os.path.join(ROOT, "build", f"csub_ab_{n}.so")
    return so, subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-Xptxas", "-v", "-o", so,
                               path], capture_output=True, text=True)


def sass_stats(src, so):
    """Per kernel of the library, from its SASS: the highest register used,
    the HGMMAs, the waits for every outstanding HGMMA (one per HGMMA means
    ptxas serialized them) and the local-memory stores (spills)."""
    cuobjdump = os.path.join(os.path.dirname(kernels._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", so], capture_output=True, text=True).stdout
    for fn in re.split(r"\n\s*Function : ", sass)[1:]:
        name, body = fn.split("\n", 1)
        regs = [int(r) for r in re.findall(r"\bR(\d+)\b", body)]
        print(f"{src} | sass {name.strip()[:60]}: max register R{max(regs, default=0)}, "
              f"{body.count('HGMMA')} HGMMA, {body.count('DEPBAR.LE gsb0, 0x0')} full waits, "
              f"{len(re.findall(r'\bSTL', body))} STL", flush=True)


with ThreadPoolExecutor(len(srcs) + 1) as pool:
    fwd = pool.submit(kernels.build, "local_corr")
    built = list(pool.map(nvcc, enumerate(srcs)))
    fwd.result()
for src, (so, proc) in zip(srcs, built):
    if proc.returncode:
        print("BUILD FAILED", src, proc.stderr[-4000:], flush=True)
        continue
    for l in proc.stderr.splitlines():   # ptxas: registers, spills, serialized wgmmas
        print(src, "|", l, flush=True)
    sass_stats(src, so)
    lib = ctypes.CDLL(so)
    p, i_ = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.local_corr_csub_f32, lib.local_corr_csub_bf16):
        fn.argtypes = [p, p, p, i_, i_, i_, i_, i_, ctypes.c_float, p]; fn.restype = i_
    libs[src] = lib
print("built", time.time() - t0, flush=True)


def call(lib, fm1t, fm2t, out, r):
    B, H, C, W = fm1t.shape
    fn = lib.local_corr_csub_bf16 if fm1t.dtype == bf16 else lib.local_corr_csub_f32
    err = fn(fm1t.data_ptr(), fm2t.data_ptr(), out.data_ptr(), B, H, W, C, r,
             tc.correlation_scale(C), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"cudaError {err}")


def inputs(shape, dt, seed):
    """(B, H, W, C) values from a seed, and the same as (B, H, C, W)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    fm1, fm2 = (torch.randn(shape, generator=g, device="cuda").to(dt) for _ in range(2))
    return fm1, fm2, fm1.transpose(2, 3).contiguous(), fm2.transpose(2, 3).contiguous()


# NHWC shapes: chip_smoke's csub edges, then the eval and training shapes
edges = [*cs.CSUB_EDGES, ((26, 64, 64, 256), 5)]
bad = {}
for src, lib in libs.items():
    if src.startswith("time:"):   # a diagnostic copy: timed only
        continue
    for n, (shape, r) in enumerate(edges):
        for dt in (bf16, f32):
            fm1, fm2, fm1t, fm2t = inputs(shape, dt, n)
            out = torch.full(shape[:3] + ((2 * r + 1) ** 2,), float("nan"), dtype=dt,
                             device="cuda")
            try:
                call(lib, fm1t, fm2t, out, r)
                torch.cuda.synchronize()
            except Exception as e:
                print("LAUNCH FAILED", src, shape, r, dt, repr(e)[:300], flush=True)
                bad[src] = True
                continue
            ref = tc.local_correlation_plain(fm1.float(), fm2.float(), r)
            if dt == bf16:
                ok = torch.allclose(out.float(), ref, rtol=2 ** -7, atol=1e-3)
            else:
                ok = (out - ref).abs().max().item() <= 1e-4
            err = (out.float() - ref).abs().max().item()
            if not ok:
                bad[src] = True
            print(f"check {src} {shape} r={r} {dt}: max err vs f32 sum {err:.3e} "
                  f"{'ok' if ok else 'DISAGREES'}", flush=True)
print("disagreeing or refusing:", sorted(bad), flush=True)

for shape, dt in [((26, 64, 64, 256), bf16), ((48, 64, 64, 256), f32)]:
    fm1, fm2, fm1t, fm2t = inputs(shape, dt, 0)
    out = torch.empty(shape[:3] + (121,), dtype=dt, device="cuda")
    order = list(libs) + ["nhwc", "transposes"]
    order = order + order[::-1]
    res = {k: [] for k in order}
    for name in order:
        if name == "nhwc":   # rows 1 / 4 on the same values
            f = lambda: tc.local_correlation(fm1, fm2, 5)
        elif name == "transposes":   # what the csub route adds around its kernel
            f = lambda: (fm1.transpose(2, 3).contiguous(), fm2.transpose(2, 3).contiguous())
        else:
            f = lambda lib=libs[name]: call(lib, fm1t, fm2t, out, 5)
        res[name].append(cuda_ms(f, reps=30))
    print(f"TIMES {shape} {dt}: " + ", ".join(f"{k}: {v}" for k, v in res.items()), flush=True)
