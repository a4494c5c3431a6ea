"""A/B of versions of ``rpnet_tpu_torch/ops/csrc/local_corr_sweep.cu`` on one card.

    git show <commit>:rpnet_tpu_torch/ops/csrc/local_corr_sweep.cu > build/old_sweep.cu
    python3 tools/sweep_ab.py tree build/old_sweep.cu noprod:tree [more ...]
    python3 tools/sweep_ab.py --build-only tree build/old_sweep.cu [more ...]

A source is ``tree`` (the checkout's) or a path. Prefixed ``noprod:`` it is
timed but not checked, with its tensor-core products taken out (every
statement that calls ``wgmma_*`` or ``mma_*`` on the accumulators becomes
empty): what the loads, barriers and epilogues cost alone. Each source is
built with nvcc into its own library under ``build/sweep_ab/`` (ignored by
git), all at once, named by a hash of its text, so a later run reuses it
(``--build-only`` builds and stops);
the ptxas report of every kernel is printed, and from its SASS the highest
register, the HGMMAs, the waits for all of them (one per HGMMA means ptxas
serialized them) and the spill stores. Each checked source's two kernels
(corr_swapped at every h_tile, corr_rotmxu with d² and 128 lanes) are held
against the plain version at ``chip_smoke.SWEEP_EDGES`` and at the sweep
shape in f32 and bf16, on outputs filled with NaN first, with
``chip_smoke``'s tolerances; the padding lanes must be exactly zero. Then
all sources are timed in turns (A B ... B A) with
``rpnet_tpu_torch.utils.timing.cuda_ms`` at the sweep shape (32×64×64×256,
r=5) in f32 and bf16: corr_swapped as the kernel alone (its planar f32
output) at each h_tile and with the wrapper's transpose and cast, corr_rotmxu
with d² and 128 lanes, beside the transpose and cast alone and the tree's
``local_correlation_band`` (row 5, the same body) on the same values. Needs a
CUDA device and nvcc.
"""
import ctypes
import hashlib
import os
import re
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
SWEEP = cs.SWEEP_SHAPE
TREE = os.path.join(ROOT, "rpnet_tpu_torch/ops/csrc/local_corr_sweep.cu")
OUT = os.path.join(ROOT, "build", "sweep_ab")
PRODUCTS = re.compile(r"^(\s+)(?:wgmma_rs|wgmma_ss|wgmma_tf32|mma_bf16|mma_tf32)\(acc[^;]*;", re.M)


def nvcc(spec):
    """Build one source (one nvcc each, all started together) → (library, process)."""
    path = spec.removeprefix("noprod:")
    path = TREE if path == "tree" else path
    with open(path) as f:
        text = f.read()
    if spec.startswith("noprod:"):
        text, count = PRODUCTS.subn(r"\1;", text)
        assert count, f"no products found in {path}"
    digest = hashlib.sha256(text.encode()).hexdigest()[:16]
    so = os.path.join(OUT, f"sweep_ab_{digest}.so")
    if os.path.exists(so):
        return so, subprocess.CompletedProcess([], 0, "", "(built before)")
    src = os.path.join(OUT, f"sweep_ab_{digest}.cu")
    with open(src, "w") as f:
        f.write(text)
    proc = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-Xptxas", "-v",
                           "-o", so + ".tmp", src], capture_output=True, text=True)
    if proc.returncode == 0:
        os.replace(so + ".tmp", so)
    return so, proc


def sass_stats(spec, so):
    """Per kernel of the library, from its SASS: the highest register used,
    the HGMMAs, the waits for every outstanding HGMMA, the local-memory
    stores (spills)."""
    cuobjdump = os.path.join(os.path.dirname(kernels._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", so], capture_output=True, text=True).stdout
    for fn in re.split(r"\n\s*Function : ", sass)[1:]:
        name, body = fn.split("\n", 1)
        regs = [int(r) for r in re.findall(r"\bR(\d+)\b", body)]
        short = re.sub(r"^_ZN\w+?_cu_[0-9a-f]{8}", "", name.strip())[:64]   # kernel<args>
        print(f"{spec} | sass {short}: max register R{max(regs, default=0)}, "
              f"{body.count('HGMMA')} HGMMA, {body.count('DEPBAR.LE gsb0, 0x0')} full waits, "
              f"{len(re.findall(r'STL', body))} STL", flush=True)


def call(lib, kind, fm1, fm2, out, r, tile):
    B, H, W, C = fm1.shape
    fn = getattr(lib, f"local_corr_{kind}_{'bf16' if fm1.dtype == bf16 else 'f32'}")
    err = fn(fm1.data_ptr(), fm2.data_ptr(), out.data_ptr(), B, H, W, C, r, tile,
             tc.correlation_scale(C), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"cudaError {err}")


def inputs(shape, dt, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return (torch.randn(shape, generator=g, device="cuda").to(dt),
            torch.randn(shape, generator=g, device="cuda").to(dt))


def check(lib, spec, shape, r, dt, seed):
    """Both kernels of ``lib`` against the plain version on NaN-filled
    outputs; returns the failures."""
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
        except Exception as e:  # noqa: BLE001 — a refused launch is a finding
            print("LAUNCH FAILED", spec, kind, tile, shape, r, dt, repr(e)[:300], flush=True)
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
        print(f"check {spec} {kind} {tile} {shape} r={r} {str(dt)[6:]}: max err vs f32 sum "
              f"{err:.3e} padding zero {pad_ok} {'ok' if ok and pad_ok else 'DISAGREES'}",
              flush=True)
    return bad


def main(argv):
    print(cs.gpu_line(), flush=True)
    build_only = argv[:1] == ["--build-only"]
    specs = argv[build_only:] or ["tree"]
    os.makedirs(OUT, exist_ok=True)
    t0 = time.time()
    with ThreadPoolExecutor(len(specs) + 1) as pool:
        band = pool.submit(kernels.build, "local_corr_band")
        built = list(pool.map(nvcc, specs))
        band.result()
    libs = {}
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
        p, i = ctypes.c_void_p, ctypes.c_int
        for kind in ("swapped", "rotmxu"):
            for dt in ("f32", "bf16"):
                fn = getattr(lib, f"local_corr_{kind}_{dt}")
                fn.argtypes = [p, p, p, i, i, i, i, i, i, ctypes.c_float, p]
                fn.restype = i
        libs[spec] = lib
    print(f"built in {time.time() - t0:.1f}s", flush=True)
    if build_only:
        return 0

    bad = {}
    for spec, lib in libs.items():
        if spec.startswith("noprod:"):   # timed only
            continue
        for n, (shape, r) in enumerate(cs.SWEEP_EDGES + ((SWEEP, 5),)):
            for dt in (bf16, f32):
                bad.setdefault(spec, []).extend(check(lib, spec, shape, r, dt, n))
    print("disagreeing:", {k: v for k, v in bad.items() if v}, flush=True)

    B, H, W, _ = SWEEP
    d2 = 121
    for dt in (bf16, f32):
        fm1, fm2 = inputs(SWEEP, dt, 0)
        planar = torch.empty((B, d2, H, W), dtype=f32, device="cuda")
        res_out = torch.empty((B, H, W, d2), dtype=dt, device="cuda")
        outs = {lanes: torch.empty((B, H, W, lanes), dtype=dt, device="cuda")
                for lanes in (d2, 128)}
        cases = {}
        for spec, lib in libs.items():
            for ht in (8, 16, 32):
                cases[f"{spec} swapped ht={ht} kernel"] = (
                    lambda lib=lib, ht=ht: call(lib, "swapped", fm1, fm2, planar, 5, ht))

            def whole(lib=lib):
                call(lib, "swapped", fm1, fm2, planar, 5, 16)
                res_out.copy_(planar.permute(0, 2, 3, 1))
            cases[f"{spec} swapped ht=16 with transpose+cast"] = whole
            for lanes in (d2, 128):
                cases[f"{spec} rotmxu lanes={lanes}"] = (
                    lambda lib=lib, lanes=lanes: call(lib, "rotmxu", fm1, fm2, outs[lanes], 5,
                                                      lanes))
        cases["transpose+cast alone"] = lambda: res_out.copy_(planar.permute(0, 2, 3, 1))
        cases["row 5 local_correlation_band"] = lambda: tc.local_correlation_band(fm1, fm2, 5)
        order = list(cases) + list(cases)[::-1]
        times = {k: [] for k in cases}
        for name in order:
            times[name].append(cuda_ms(cases[name], reps=20))
        for name, ts in times.items():
            print(f"time {str(dt)[6:]:8s} {name:50s} " + " ".join(f"{t:.4f}" for t in ts)
                  + " ms", flush=True)
    return 1 if any(bad.values()) else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
