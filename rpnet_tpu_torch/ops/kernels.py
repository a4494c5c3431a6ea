"""Build and bind the port's hand-written CUDA kernels.

Each source under ``ops/csrc/`` is compiled with ``nvcc`` for ``sm_90a`` into
a shared library with a plain C interface and loaded with ``ctypes``
(no PyTorch headers, so a build takes seconds). Nothing is built when this
module is imported: :func:`build` runs at the first launch, or when a caller
asks for it. The libraries go to ``build/kernels/`` at the repository root
(listed in ``.gitignore``), named by a hash of their source, so an edited
source is rebuilt and an unchanged one is reused. :func:`build_shared` holds
that content-hashed build once; ``core/native_cache.py`` builds the host
NRRD decoder (``native/nrrd_cache.cpp``, ``g++``) through it too.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): the "
                           "port's CUDA kernels are built at first use")
    return path


def build_shared(src: Path, out_dir: Path, command, verbose: bool = False) -> Path:
    """Compile ``src`` into ``out_dir/lib<stem>_<hash>.so``, once per hash of
    its source: ``command(out)`` is the compiler's command line writing the
    library to ``out``. An existing library is reused unless ``verbose``,
    which rebuilds it and prints what the compiler reports. A failed build
    raises with the compiler's message."""
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    lib = out_dir / f"lib{src.stem}_{digest}.so"
    if lib.exists() and not verbose:
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    cmd = command(tmp)
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:   # the compiler itself is missing
        os.unlink(tmp)
        raise RuntimeError(f"{cmd[0]} failed for {src}: {e}") from e
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"{cmd[0]} failed for {src}:\n{proc.stderr}")
    if verbose:
        print(proc.stdout + proc.stderr, end="")
    os.replace(tmp, lib)   # atomic: a concurrent build never sees half a file
    return lib


def build(name: str, verbose: bool = False) -> Path:
    """Compile ``csrc/<name>.cu`` (once per source hash) → the library path.

    ``verbose`` adds ``-Xptxas -v`` and prints what the compiler reports
    (registers, shared memory, spills per kernel).
    """
    src = CSRC / f"{name}.cu"
    return build_shared(src, BUILD_DIR, lambda out: [
        _nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []), "-o", out, str(src)],
        verbose)


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            _bind(name, lib)
            _libs[name] = lib
        return lib


def _bind(name: str, lib: ctypes.CDLL) -> None:
    if name == "local_corr":
        p, i = ctypes.c_void_p, ctypes.c_int
        for fn in (lib.local_corr_f32, lib.local_corr_bf16):
            fn.argtypes = [p, p, p, i, i, i, i, i, ctypes.c_float, p]
            fn.restype = i
        lib.local_corr_bf16_plan.argtypes = [i, i, p, p, p]
        lib.local_corr_bf16_plan.restype = i
        lib.local_corr_f32_plan.argtypes = [i, i, p, p, p, p]
        lib.local_corr_f32_plan.restype = i
        lib.local_corr_error_string.argtypes = [i]
        lib.local_corr_error_string.restype = ctypes.c_char_p
    elif name == "local_corr_bwd":
        p, i = ctypes.c_void_p, ctypes.c_int
        for fn in (lib.local_corr_bwd_f32, lib.local_corr_bwd_bf16):
            fn.argtypes = [p, i, p, p, p, p, i, i, i, i, i, ctypes.c_float, p]
            fn.restype = i
        lib.local_corr_bwd_plan.argtypes = [i, i, p, p, p, p]
        lib.local_corr_bwd_plan.restype = i
        lib.local_corr_bwd_error_string.argtypes = [i]
        lib.local_corr_bwd_error_string.restype = ctypes.c_char_p
    elif name == "local_corr_band":
        p, i = ctypes.c_void_p, ctypes.c_int
        for fn in (lib.local_corr_band_f32, lib.local_corr_band_bf16,
                   lib.local_corr_pack_f32, lib.local_corr_pack_bf16,
                   lib.local_corr_pdot_bf16):
            fn.argtypes = [p, p, p, i, i, i, i, i, i, ctypes.c_float, p]
            fn.restype = i
        lib.local_corr_band_plan.argtypes = [i, i, i, p, p, p, p]
        lib.local_corr_band_plan.restype = i
        lib.local_corr_band_error_string.argtypes = [i]
        lib.local_corr_band_error_string.restype = ctypes.c_char_p
    elif name == "local_corr_csub":
        p, i = ctypes.c_void_p, ctypes.c_int
        for fn in (lib.local_corr_csub_f32, lib.local_corr_csub_bf16):
            fn.argtypes = [p, p, p, i, i, i, i, i, ctypes.c_float, p]
            fn.restype = i
        lib.local_corr_csub_plan.argtypes = [i, i, i, p, p, p, p]
        lib.local_corr_csub_plan.restype = i
        lib.local_corr_csub_error_string.argtypes = [i]
        lib.local_corr_csub_error_string.restype = ctypes.c_char_p
    elif name == "local_corr_sweep":
        p, i = ctypes.c_void_p, ctypes.c_int
        for fn in (lib.local_corr_swapped_f32, lib.local_corr_swapped_bf16,
                   lib.local_corr_rotmxu_f32, lib.local_corr_rotmxu_bf16):
            fn.argtypes = [p, p, p, i, i, i, i, i, i, ctypes.c_float, p]
            fn.restype = i
        lib.local_corr_sweep_plan.argtypes = [i, i, i, i, p, p, p, p, p]
        lib.local_corr_sweep_plan.restype = i
        lib.local_corr_sweep_error_string.argtypes = [i]
        lib.local_corr_sweep_error_string.restype = ctypes.c_char_p


def launch_local_corr(fm1: torch.Tensor, fm2: torch.Tensor, out: torch.Tensor,
                      r: int, scale: float) -> None:
    """Launch the local-correlation kernel on the current stream of the
    tensors' device. The caller (``ops.correlation.local_correlation``) has
    checked device, dtype, shape and contiguity."""
    lib = load("local_corr")
    fn = lib.local_corr_bf16 if fm1.dtype == torch.bfloat16 else lib.local_corr_f32
    B, H, W, C = fm1.shape
    with torch.cuda.device(fm1.device):
        stream = torch.cuda.current_stream(fm1.device).cuda_stream
        err = fn(fm1.data_ptr(), fm2.data_ptr(), out.data_ptr(),
                 B, H, W, C, r, scale, stream)
    if err != 0:
        msg = lib.local_corr_error_string(err).decode()
        raise RuntimeError(f"local_corr launch failed: {msg} (cudaError {err})")


def local_corr_bf16_plan(C: int, r: int) -> Dict[str, int]:
    """The bf16 kernel's launch plan at (C, r): shared memory a block
    (bytes), ring stages and resident blocks an SM (the CUDA occupancy
    calculator)."""
    lib = load("local_corr")
    out = [ctypes.c_int() for _ in range(3)]
    err = lib.local_corr_bf16_plan(C, r, *(ctypes.byref(v) for v in out))
    if err != 0:
        msg = lib.local_corr_error_string(err).decode()
        raise RuntimeError(f"local_corr_bf16_plan failed: {msg} (cudaError {err})")
    return dict(zip(("smem_bytes", "stages", "blocks_per_sm"), (v.value for v in out)))


def local_corr_f32_plan(C: int, r: int) -> Dict[str, int]:
    """The f32 forward kernel's launch plan at (C, r): shared memory a block
    (bytes), resident blocks an SM (the CUDA occupancy calculator), registers
    a thread and local memory a thread (bytes; ptxas spills)."""
    lib = load("local_corr")
    out = [ctypes.c_int() for _ in range(4)]
    err = lib.local_corr_f32_plan(C, r, *(ctypes.byref(v) for v in out))
    if err != 0:
        msg = lib.local_corr_error_string(err).decode()
        raise RuntimeError(f"local_corr_f32_plan failed: {msg} (cudaError {err})")
    return dict(zip(("smem_bytes", "blocks_per_sm", "registers", "local_bytes"),
                    (v.value for v in out)))


def local_corr_bwd_plan(bf16: bool, r: int) -> Dict[str, int]:
    """The backward kernel's launch plan at radius ``r``: shared memory a
    block (bytes), resident blocks an SM (the CUDA occupancy calculator),
    registers a thread and local memory a thread (bytes; ptxas spills)."""
    lib = load("local_corr_bwd")
    out = [ctypes.c_int() for _ in range(4)]
    err = lib.local_corr_bwd_plan(int(bf16), r, *(ctypes.byref(v) for v in out))
    if err != 0:
        msg = lib.local_corr_bwd_error_string(err).decode()
        raise RuntimeError(f"local_corr_bwd_plan failed: {msg} (cudaError {err})")
    return dict(zip(("smem_bytes", "blocks_per_sm", "registers", "local_bytes"),
                    (v.value for v in out)))


def launch_local_corr_bwd(g: torch.Tensor, g_pitch: int, fm1: torch.Tensor,
                          fm2: torch.Tensor, dfm1: torch.Tensor,
                          dfm2: torch.Tensor, r: int, scale: float) -> None:
    """Launch the local-correlation backward kernel on the current stream of
    the tensors' device; g is read with pixel pitch ``g_pitch`` elements. The
    caller (``ops.correlation.local_correlation_bwd``) has checked device,
    dtype, shape and strides."""
    lib = load("local_corr_bwd")
    fn = (lib.local_corr_bwd_bf16 if fm1.dtype == torch.bfloat16
          else lib.local_corr_bwd_f32)
    B, H, W, C = fm1.shape
    with torch.cuda.device(fm1.device):
        stream = torch.cuda.current_stream(fm1.device).cuda_stream
        err = fn(g.data_ptr(), g_pitch, fm1.data_ptr(), fm2.data_ptr(),
                 dfm1.data_ptr(), dfm2.data_ptr(), B, H, W, C, r, scale, stream)
    if err != 0:
        msg = lib.local_corr_bwd_error_string(err).decode()
        raise RuntimeError(f"local_corr_bwd launch failed: {msg} (cudaError {err})")


def launch_local_corr_band(mode: str, fm1: torch.Tensor, fm2: torch.Tensor,
                           out: torch.Tensor, r: int, width: int,
                           scale: float) -> None:
    """Launch the tensor-core band kernel in ``mode`` ``band``, ``pack``
    (slices of ``width`` columns side by side) or ``pdot`` (bf16) on the
    current stream of the tensors' device. The callers in ``ops.correlation``
    have checked device, dtype, shape and contiguity."""
    lib = load("local_corr_band")
    bf16 = fm1.dtype == torch.bfloat16
    fn = {("band", False): lib.local_corr_band_f32, ("band", True): lib.local_corr_band_bf16,
          ("pack", False): lib.local_corr_pack_f32, ("pack", True): lib.local_corr_pack_bf16,
          ("pdot", True): lib.local_corr_pdot_bf16}[(mode, bf16)]
    B, H, W, C = fm1.shape
    with torch.cuda.device(fm1.device):
        stream = torch.cuda.current_stream(fm1.device).cuda_stream
        err = fn(fm1.data_ptr(), fm2.data_ptr(), out.data_ptr(),
                 B, H, W, C, r, width, scale, stream)
    if err != 0:
        msg = lib.local_corr_band_error_string(err).decode()
        raise RuntimeError(f"local_corr_band ({mode}) launch failed: {msg} "
                           f"(cudaError {err})")


def local_corr_band_plan(C: int, r: int, dtype: torch.dtype) -> Dict[str, int]:
    """The band kernel's launch plan at (C, r) in ``dtype``: shared memory a
    block (bytes), resident blocks an SM (the CUDA occupancy calculator), and
    the BAND instance's registers a thread and local memory a thread (bytes;
    ptxas spills)."""
    lib = load("local_corr_band")
    out = [ctypes.c_int() for _ in range(4)]
    err = lib.local_corr_band_plan(int(dtype == torch.bfloat16), C, r,
                                   *(ctypes.byref(v) for v in out))
    if err != 0:
        msg = lib.local_corr_band_error_string(err).decode()
        raise RuntimeError(f"local_corr_band_plan failed: {msg} (cudaError {err})")
    return dict(zip(("smem_bytes", "blocks_per_sm", "registers", "local_bytes"),
                    (v.value for v in out)))


def launch_local_corr_csub(fm1t: torch.Tensor, fm2t: torch.Tensor,
                           out: torch.Tensor, r: int, scale: float) -> None:
    """Launch the C-strided kernel on (B, H, C, W) inputs on the current
    stream of the tensors' device. The caller
    (``ops.correlation.local_correlation_csub``) has checked the layout."""
    lib = load("local_corr_csub")
    fn = (lib.local_corr_csub_bf16 if fm1t.dtype == torch.bfloat16
          else lib.local_corr_csub_f32)
    B, H, C, W = fm1t.shape
    with torch.cuda.device(fm1t.device):
        stream = torch.cuda.current_stream(fm1t.device).cuda_stream
        err = fn(fm1t.data_ptr(), fm2t.data_ptr(), out.data_ptr(),
                 B, H, W, C, r, scale, stream)
    if err != 0:
        msg = lib.local_corr_csub_error_string(err).decode()
        raise RuntimeError(f"local_corr_csub launch failed: {msg} (cudaError {err})")


def local_corr_csub_plan(C: int, r: int, dtype: torch.dtype) -> Dict[str, int]:
    """The C-strided kernel's launch plan at (C, r) in ``dtype``, on its TMA
    path (W % 8 == 0 in bf16, W % 4 == 0 in f32): shared memory a block
    (bytes), resident blocks an SM (the CUDA occupancy calculator), registers
    a thread and local memory a thread (bytes; ptxas spills)."""
    lib = load("local_corr_csub")
    out = [ctypes.c_int() for _ in range(4)]
    err = lib.local_corr_csub_plan(C, r, int(dtype == torch.bfloat16),
                                   *(ctypes.byref(v) for v in out))
    if err != 0:
        msg = lib.local_corr_csub_error_string(err).decode()
        raise RuntimeError(f"local_corr_csub_plan failed: {msg} (cudaError {err})")
    return dict(zip(("smem_bytes", "blocks_per_sm", "registers", "local_bytes"),
                    (v.value for v in out)))


def local_corr_sweep_plan(kind: str, C: int, r: int, dtype: torch.dtype) -> Dict[str, int]:
    """The launch plan of the sweep's ``swapped`` or ``rotmxu`` kernel at
    (C, r) in ``dtype``: shared memory a block (bytes), ring stages, resident
    blocks an SM (the CUDA occupancy calculator), registers a thread and
    local memory a thread (bytes; ptxas spills)."""
    lib = load("local_corr_sweep")
    out = [ctypes.c_int() for _ in range(5)]
    err = lib.local_corr_sweep_plan(int(kind == "swapped"), int(dtype == torch.bfloat16), C, r,
                                    *(ctypes.byref(v) for v in out))
    if err != 0:
        msg = lib.local_corr_sweep_error_string(err).decode()
        raise RuntimeError(f"local_corr_sweep_plan failed: {msg} (cudaError {err})")
    return dict(zip(("smem_bytes", "stages", "blocks_per_sm", "registers", "local_bytes"),
                    (v.value for v in out)))


def launch_local_corr_sweep(kind: str, fm1: torch.Tensor, fm2: torch.Tensor,
                            out: torch.Tensor, r: int, tile: int,
                            scale: float) -> None:
    """Launch one of the kernel sweep's kernels on the current stream of the
    tensors' device: ``swapped`` writes planar (B, d², H, W) float32
    (``tile``, 8, 16 or 32, is accepted for signature parity); ``rotmxu`` writes (B, H, W,
    ``tile``) in the inputs' dtype, ``tile`` = 128 lanes or d². The callers
    in ``bench_tools.corr_sweep`` have checked device, dtype, shape and
    contiguity."""
    lib = load("local_corr_sweep")
    bf16 = fm1.dtype == torch.bfloat16
    fn = {("swapped", False): lib.local_corr_swapped_f32,
          ("swapped", True): lib.local_corr_swapped_bf16,
          ("rotmxu", False): lib.local_corr_rotmxu_f32,
          ("rotmxu", True): lib.local_corr_rotmxu_bf16}[(kind, bf16)]
    B, H, W, C = fm1.shape
    with torch.cuda.device(fm1.device):
        stream = torch.cuda.current_stream(fm1.device).cuda_stream
        err = fn(fm1.data_ptr(), fm2.data_ptr(), out.data_ptr(),
                 B, H, W, C, r, tile, scale, stream)
    if err != 0:
        msg = lib.local_corr_sweep_error_string(err).decode()
        raise RuntimeError(f"local_corr_sweep ({kind}) launch failed: {msg} "
                           f"(cudaError {err})")
