"""Build and bind the port's hand-written CUDA kernels.

Each source under ``ops/csrc/`` is compiled with ``nvcc`` for ``sm_90a`` into
a shared library with a plain C interface and loaded with ``ctypes``
(no PyTorch headers, so a build takes seconds). Nothing is built when this
module is imported: :func:`build` runs at the first launch, or when a caller
asks for it. The libraries go to ``build/kernels/`` at the repository root
(listed in ``.gitignore``), named by a hash of their source, so an edited
source is rebuilt and an unchanged one is reused.
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


def build(name: str, verbose: bool = False) -> Path:
    """Compile ``csrc/<name>.cu`` (once per source hash) → the library path.

    ``verbose`` adds ``-Xptxas -v`` and prints what the compiler reports
    (registers, shared memory, spills per kernel).
    """
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    lib = BUILD_DIR / f"lib{name}_{digest}.so"
    if lib.exists() and not verbose:
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", tmp, str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stderr}")
    if verbose:
        print(proc.stdout + proc.stderr, end="")
    os.replace(tmp, lib)   # atomic: a concurrent build never sees half a file
    return lib


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
        lib.local_corr_error_string.argtypes = [i]
        lib.local_corr_error_string.restype = ctypes.c_char_p
    elif name == "local_corr_bwd":
        p, i = ctypes.c_void_p, ctypes.c_int
        for fn in (lib.local_corr_bwd_f32, lib.local_corr_bwd_bf16):
            fn.argtypes = [p, i, p, p, p, p, i, i, i, i, i, ctypes.c_float, p]
            fn.restype = i
        lib.local_corr_bwd_error_string.argtypes = [i]
        lib.local_corr_bwd_error_string.restype = ctypes.c_char_p


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
