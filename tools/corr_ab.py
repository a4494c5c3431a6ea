"""A/B of versions of ``rpnet_tpu_torch/ops/csrc/local_corr.cu`` on one card.

    git show <commit>:rpnet_tpu_torch/ops/csrc/local_corr.cu > build/old.cu
    python3 tools/corr_ab.py tree build/old.cu [more.cu ...]

``tree`` is the checkout's source; a source given as ``time:path`` (a
diagnostic copy, e.g. with the loads or the products taken out) is timed
but not checked. Each source is built with nvcc into its
own library under ``build/`` (ignored by git; the ptxas report of every
kernel printed, and from its SASS the highest register, the HGMMAs and the
waits for all of them, which show serialized wgmmas), held against the
plain version at the tiling edges and the eval shape on NaN-filled outputs
(each bf16 output also compared bit for bit with the first source's), then
all are timed in turns (A B C ... band band ... C B A) with
``rpnet_tpu_torch.utils.timing.cuda_ms`` at the eval shape (26×64×64×256
bf16, r=5) beside the band kernel, and with ``AB_F32=1`` also checked in f32
and timed at the training shape (48×64×64×256 f32) and the sweep shape
(32×64×64×256 f32). Needs a CUDA device and nvcc.
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
    path = os.path.join(ROOT, "rpnet_tpu_torch/ops/csrc/local_corr.cu") if src == "tree" else src
    so = os.path.join(ROOT, "build", f"ab_{n}.so")
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
        name = re.sub(r".*?\d(local_corr_[a-z0-9_]*?kernel)ILi(\d+)E.*", r"\1<\2>", name.strip())
        print(f"{src} | sass {name}: max register R{max(regs, default=0)}, "
              f"{body.count('HGMMA')} HGMMA, {body.count('DEPBAR.LE gsb0, 0x0')} full waits, "
              f"{len(re.findall(r'\bSTL', body))} STL", flush=True)


with ThreadPoolExecutor(len(srcs) + 1) as pool:
    band = pool.submit(kernels.build, "local_corr_band")
    built = list(pool.map(nvcc, enumerate(srcs)))
    band.result()
for src, (so, proc) in zip(srcs, built):
    if proc.returncode:
        print("BUILD FAILED", src, proc.stderr[-4000:], flush=True)
        continue
    for l in proc.stderr.splitlines():   # ptxas: registers, spills, serialized wgmmas
        print(src, "|", l, flush=True)
    sass_stats(src, so)
    lib = ctypes.CDLL(so)
    p, i_ = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.local_corr_f32, lib.local_corr_bf16):
        fn.argtypes = [p, p, p, i_, i_, i_, i_, i_, ctypes.c_float, p]; fn.restype = i_
    libs[src] = lib
print("built", time.time() - t0, flush=True)


def call(lib, fm1, fm2, out, r):
    B, H, W, C = fm1.shape
    fn = lib.local_corr_bf16 if fm1.dtype == bf16 else lib.local_corr_f32
    err = fn(fm1.data_ptr(), fm2.data_ptr(), out.data_ptr(), B, H, W, C, r,
             tc.correlation_scale(C), torch.cuda.current_stream().cuda_stream)
    assert err == 0, err


def inputs(shape, dt, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return (torch.randn(shape, generator=g, device="cuda").to(dt),
            torch.randn(shape, generator=g, device="cuda").to(dt))


edges = [((3, 20, 20, 64), 2), ((2, 40, 100, 128), 5), ((1, 6, 72, 48), 5),
         ((3, 20, 20, 64), 1), ((3, 20, 20, 64), 3), ((2, 16, 64, 320), 5),
         ((1, 3, 5, 16), 5), ((2, 64, 64, 256), 4), ((26, 64, 64, 256), 5)]
dts = (bf16, f32) if os.environ.get("AB_F32") else (bf16,)
bad = {}
first_bf16 = {}   # (edge, dtype) -> the first checked source's bf16 output
for src, lib in libs.items():
    if src.startswith("time:"):   # a diagnostic copy: timed only
        continue
    for n, (shape, r) in enumerate(edges):
        for dt in dts:
            fm1, fm2 = inputs(shape, dt, n)
            out = torch.full(shape[:3] + ((2 * r + 1) ** 2,), float("nan"), dtype=dt, device="cuda")
            try:
                call(lib, fm1, fm2, out, r)
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
            same = ""
            if dt == bf16:
                ref0 = first_bf16.setdefault(n, out)
                same = f", bit-identical to the first source: {torch.equal(out, ref0)}"
            print(f"check {src} {shape} r={r} {dt}: max err vs f32 sum {err:.3e} "
                  f"{'ok' if ok else 'DISAGREES'}{same}", flush=True)
print("disagreeing:", sorted(bad), flush=True)

cases = [((26, 64, 64, 256), bf16)]
if os.environ.get("AB_F32"):
    cases += [((48, 64, 64, 256), f32), ((32, 64, 64, 256), f32)]
for shape, dt in cases:
    fm1, fm2 = inputs(shape, dt, 0)
    out = torch.empty(shape[:3] + (121,), dtype=dt, device="cuda")
    order = list(libs) + ["band"]
    order = order + order[::-1]
    res = {k: [] for k in order}
    for name in order:
        if name == "band":
            f = lambda: kernels.launch_local_corr_band("band", fm1, fm2, out, 5, shape[2],
                                                        tc.correlation_scale(shape[3]))
        else:
            f = lambda lib=libs[name]: call(lib, fm1, fm2, out, 5)
        res[name].append(cuda_ms(f, reps=30))
    print(f"TIMES {shape} {dt}: " + ", ".join(f"{k}: {v}" for k, v in res.items()), flush=True)
