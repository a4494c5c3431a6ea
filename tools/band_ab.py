"""A/B of versions of ``rpnet_tpu_torch/ops/csrc/local_corr_band.cu`` on one card.

    git show <commit>:rpnet_tpu_torch/ops/csrc/local_corr_band.cu > build/old_band.cu
    python3 tools/band_ab.py tree build/old_band.cu [more ...]
    python3 tools/band_ab.py --build-only tree build/old_band.cu [more ...]

A source is ``tree`` (the checkout's) or a path, optionally followed by
nvcc flags after commas (``tree,-DNAME=1``). Prefixed ``time:`` it
is timed but not checked; prefixed ``noprod:`` it is timed with its
tensor-core products taken out (every statement that calls ``wgmma_*`` or
``mma_*`` on the accumulators becomes empty): what the loads, barriers and
epilogue cost alone. Each source is built with nvcc into its own library
under ``build/band_ab/`` (ignored by git), all at once, named by a hash of
its text and flags, so a later run reuses it (``--build-only`` builds and
stops: a call can then check each version in its own process, where a
trap in one cannot hide the others); the ptxas report of every kernel is
printed, and from its SASS the highest register, the HGMMAs, the waits for
all of them (one per HGMMA means ptxas serialized them) and the spill
stores. Each checked source is held against the plain versions at
``chip_smoke.BAND_EDGES`` and at the eval shape (band, pdot, pack in bf16;
band, pack in f32) on NaN-filled outputs, with ``chip_smoke``'s tolerances
(a source that refuses a shape prints LAUNCH FAILED and is not timed).
Then all are timed in turns (A B C ... C B A) with
``rpnet_tpu_torch.utils.timing.cuda_ms``: band, pdot and pack at the eval
shape (26x64x64x256 bf16, r=5; pack on the 13 slice pairs) beside the
tree's ``local_correlation`` (row 1) on the same values, and band and pack
at the training shape (48x64x64x256 f32) beside row 4. Needs a CUDA device
and nvcc.
"""
import ctypes, hashlib, os, re, subprocess, sys, time
from concurrent.futures import ThreadPoolExecutor
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))   # tools/ -> repo
sys.path.insert(0, ROOT)
import torch
import chip_smoke as cs
from rpnet_tpu_torch.ops import kernels
from rpnet_tpu_torch.ops import correlation as tc
from rpnet_tpu_torch.utils.timing import cuda_ms

bf16, f32 = torch.bfloat16, torch.float32
TREE = os.path.join(ROOT, "rpnet_tpu_torch/ops/csrc/local_corr_band.cu")
PRODUCTS = re.compile(r"^(\s+)(?:wgmma_rs|wgmma_ss|wgmma_tf32|mma_bf16|mma_tf32)\(acc[^;]*;", re.M)
print(cs.gpu_line(), flush=True)
build_only = sys.argv[1:2] == ["--build-only"]
specs = sys.argv[1 + build_only:] or ["tree"]
OUT = os.path.join(ROOT, "build", "band_ab")
os.makedirs(OUT, exist_ok=True)
t0 = time.time()


def nvcc(n_spec):   # one nvcc per source, all started together
    n, spec = n_spec
    path, *flags = spec.split(":", 1)[-1].split(",")
    path = TREE if path == "tree" else path
    with open(path) as f:
        text = f.read()
    if spec.startswith("noprod:"):
        text, count = PRODUCTS.subn(r"\1;", text)
        assert count, f"no products found in {path}"
    digest = hashlib.sha256("\0".join([text, *flags]).encode()).hexdigest()[:16]
    so = os.path.join(OUT, f"band_ab_{digest}.so")
    if os.path.exists(so):
        return so, subprocess.CompletedProcess([], 0, "", "(built before)")
    path = os.path.join(OUT, f"band_ab_{digest}.cu")
    with open(path, "w") as f:
        f.write(text)
    proc = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, *flags, "-Xptxas", "-v",
                           "-o", so + ".tmp", path], capture_output=True, text=True)
    if proc.returncode == 0:
        os.replace(so + ".tmp", so)
    return so, proc


def sass_stats(spec, so):
    """Per kernel of the library, from its SASS: the highest register used,
    the HGMMAs, the waits for every outstanding HGMMA, the local-memory
    stores (spills) and the memory barriers."""
    cuobjdump = os.path.join(os.path.dirname(kernels._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", so], capture_output=True, text=True).stdout
    for fn in re.split(r"\n\s*Function : ", sass)[1:]:
        name, body = fn.split("\n", 1)
        regs = [int(r) for r in re.findall(r"\bR(\d+)\b", body)]
        print(f"{spec} | sass {name.strip()[:72]}: max register R{max(regs, default=0)}, "
              f"{body.count('HGMMA')} HGMMA, {body.count('DEPBAR.LE gsb0, 0x0')} full waits, "
              f"{len(re.findall(r'STL', body))} STL, {body.count('MEMBAR')} MEMBAR", flush=True)


libs = {}
with ThreadPoolExecutor(len(specs) + 1) as pool:
    fwd = pool.submit(kernels.build, "local_corr")
    built = list(pool.map(nvcc, enumerate(specs)))
    fwd.result()
for spec, (so, proc) in zip(specs, built):
    if proc.returncode:
        print("BUILD FAILED", spec, proc.stderr[-4000:], flush=True)
        continue
    for line in proc.stderr.splitlines():   # ptxas: registers, spills, serialized wgmmas
        print(spec, "|", line, flush=True)
    sass_stats(spec, so)
    if build_only:
        continue
    lib = ctypes.CDLL(so)
    p, i_ = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.local_corr_band_f32, lib.local_corr_band_bf16, lib.local_corr_pack_f32,
               lib.local_corr_pack_bf16, lib.local_corr_pdot_bf16):
        fn.argtypes = [p, p, p, i_, i_, i_, i_, i_, i_, ctypes.c_float, p]
        fn.restype = i_
    libs[spec] = lib
print("built", time.time() - t0, flush=True)
if build_only:
    sys.exit(0)


def call(lib, kind, fm1, fm2, out, r, width):
    """One launch of ``kind`` on (B, H, W, C) inputs (pack: already packed)."""
    B, H, W, C = fm1.shape
    dt = "bf16" if fm1.dtype == bf16 else "f32"
    fn = getattr(lib, f"local_corr_{kind}_{dt}")
    err = fn(fm1.data_ptr(), fm2.data_ptr(), out.data_ptr(), B, H, W, C, r, width,
             tc.correlation_scale(C), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"cudaError {err}")


def run(lib, kind, fm1, fm2, r):
    """``kind`` on (B, H, W, C) inputs into a NaN-filled output → (B, H, W, d²)."""
    W = fm1.shape[2]
    a, b = (tc.pack_pairs(fm1), tc.pack_pairs(fm2)) if kind == "pack" else (fm1, fm2)
    out = torch.full(a.shape[:3] + ((2 * r + 1) ** 2,), float("nan"), dtype=a.dtype,
                     device="cuda")
    call(lib, kind, a, b, out, r, W)
    torch.cuda.synchronize()
    return tc.unpack_pairs(out) if kind == "pack" else out


PLAIN = {"band": tc.local_correlation_plain, "pdot": tc.local_correlation_pdot_plain,
         "pack": lambda a, b, r: tc.unpack_pairs(tc.local_correlation_packed_plain(
             tc.pack_pairs(a), tc.pack_pairs(b), r, a.shape[2]))}
cases = [*cs.BAND_EDGES, *(("band", (26, 64, 64, 256), 5), ("pdot", (26, 64, 64, 256), 5),
                           ("pack", (26, 64, 64, 256), 5))]
bad, refused = set(), set()
for spec, lib in libs.items():
    if spec.startswith(("time:", "noprod:")):   # timed only
        continue
    for n, (kind, shape, r) in enumerate(cases):
        for dt in ((bf16, f32) if kind != "pdot" else (bf16,)):
            partner = cs.BAND_PARTNER[str(dt).replace("torch.", "")] if kind == "pack" else 1.0
            fm1, fm2, sc = cs.variant_inputs(shape, dt, 400 + n, partner)
            try:
                out = run(lib, kind, fm1, fm2, r)
            except Exception as e:
                print("LAUNCH FAILED", spec, kind, shape, r, dt, repr(e)[:300], flush=True)
                bad.add(spec)
                refused.add(spec)
                continue
            ref = PLAIN[kind](fm1, fm2, r)
            res = {}
            ok, tol = cs.variant_verdict(kind, out, ref, fm1, fm2, r, sc, res)
            err = (out.float() - ref.float()).abs().max().item()
            ok = ok and bool(torch.isfinite(out).all())
            if not ok:
                bad.add(spec)
            print(f"check {spec} {kind} {shape} r={r} {dt}: max err vs plain {err:.3e} {res} "
                  f"({tol}) {'ok' if ok else 'DISAGREES'}", flush=True)
print("disagreeing or refusing:", sorted(bad), flush=True)

for shape, dt, kinds in [((26, 64, 64, 256), bf16, ("band", "pdot", "pack")),
                         ((48, 64, 64, 256), f32, ("band", "pack"))]:
    fm1, fm2, _ = cs.variant_inputs(shape, dt, 0)
    p1, p2 = tc.pack_pairs(fm1), tc.pack_pairs(fm2)
    out = torch.empty(shape[:3] + (121,), dtype=dt, device="cuda")
    outp = out.view(p1.shape[:3] + (121,))
    names = [(spec, kind) for spec in libs if spec not in refused
             for kind in kinds] + [("row 1" if dt == bf16
                                                                  else "row 4", "nhwc")]
    order = names + names[::-1]
    res = {k: [] for k in names}
    for spec, kind in order:
        if kind == "nhwc":   # the same function on the same values
            f = lambda: tc.local_correlation(fm1, fm2, 5)
        elif kind == "pack":
            f = lambda lib=libs[spec]: call(lib, "pack", p1, p2, outp, 5, shape[2])
        else:
            f = lambda lib=libs[spec], kind=kind: call(lib, kind, fm1, fm2, out, 5, shape[2])
        res[(spec, kind)].append(cuda_ms(f, reps=30))
    print(f"TIMES {shape} {dt}: " + "; ".join(f"{s} {k}: {v}" for (s, k), v in res.items()),
          flush=True)
