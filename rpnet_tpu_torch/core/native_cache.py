"""ctypes bindings for the native NRRD decoder and raw-cache loader.

The counterpart of ``rpnet_tpu/core/native_cache.py``. The C++ library
(``rpnet_tpu_torch/native/nrrd_cache.cpp``, a copy of the JAX package's with
the same symbols and ``.rawcache`` layout, so the two packages' caches
interchange) inflates gzip NRRD payloads straight into numpy buffers and
converts a volume once into a flat ``.rawcache`` file whose later loads are
one read. The sampler reads every volume through :func:`read_cached` when
``use_native_io`` is on (the default).

The library is built with ``g++ -O3 -shared -fPIC ... -lz`` at first use,
never at import, into ``build/native/`` at the repository root (listed in
``.gitignore``), named by a hash of its source (``ops/kernels.build_shared``).

One deliberate difference from the JAX module: a failed build or load
raises with the compiler's message; the JAX module swallows it and reads
through the Python codec. A file the decoder refuses (big-endian, a
detached header, an encoding zlib cannot inflate) still goes through the
port's Python codec (``core/nrrd_io.py``), as in the JAX module. The
metadata returned says which path read the file: ``{"native": True}`` (with
``"cached": True`` from a ``.rawcache``), or the NRRD header with
``"native": False``.
"""

from __future__ import annotations

import ctypes
import os
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from rpnet_tpu_torch.core import nrrd_io

SRC = Path(__file__).resolve().parents[1] / "native" / "nrrd_cache.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX = "g++"
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_DTYPE_CODES = {1: np.int8, 2: np.uint8, 3: np.int16, 4: np.uint16,
                5: np.int32, 6: np.uint32, 7: np.int64, 8: np.uint64,
                9: np.float32, 10: np.float64}

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()           # one build and load a process
_convert_lock = threading.Lock()   # prefetch threads may convert one volume at once


def build(verbose: bool = False) -> Path:
    """Compile ``native/nrrd_cache.cpp`` (once per source hash) → the
    library path; raises with the compiler's message on failure."""
    from rpnet_tpu_torch.ops.kernels import build_shared

    return build_shared(SRC, BUILD_DIR, lambda out: [CXX, *CXX_FLAGS, "-o", out,
                                                     str(SRC), "-lz"], verbose)


def _load_library() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            query = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint32),
                     ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_uint64)]
            read_into = [ctypes.c_char_p, ctypes.c_void_p, ctypes.c_uint64]
            for fn, args in ((lib.nrrd_query, query), (lib.rawcache_query, query),
                             (lib.nrrd_read_into, read_into),
                             (lib.rawcache_read_into, read_into),
                             (lib.nrrd_to_rawcache, [ctypes.c_char_p, ctypes.c_char_p])):
                fn.argtypes = args
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def native_available() -> bool:
    """Whether the library builds and loads here (the readers raise if not)."""
    try:
        _load_library()
    except (RuntimeError, OSError):
        return False
    return True


def _query(fn, path: str) -> Optional[Tuple[np.dtype, Tuple[int, ...]]]:
    dtype_code = ctypes.c_uint32(0)
    ndim = ctypes.c_uint32(0)
    sizes = (ctypes.c_uint64 * 16)()
    if fn(path.encode(), ctypes.byref(dtype_code), ctypes.byref(ndim), sizes) != 0:
        return None
    shape = tuple(int(sizes[i]) for i in range(ndim.value))
    return np.dtype(_DTYPE_CODES[dtype_code.value]), shape


def _read_into(fn, path: str, meta) -> Optional[np.ndarray]:
    dtype, shape = meta
    buf = np.empty(int(np.prod(shape)), dtype=dtype)
    if fn(path.encode(), buf.ctypes.data_as(ctypes.c_void_p), ctypes.c_uint64(buf.nbytes)):
        return None
    return _to_index_order(buf, shape)


def _to_index_order(flat: np.ndarray, shape) -> np.ndarray:
    """NRRD element order (first axis fastest) → shape == sizes array."""
    arr = flat.reshape(shape[::-1]).transpose(tuple(range(len(shape) - 1, -1, -1)))
    return np.ascontiguousarray(arr)


def _python_read(path: str):
    arr, header = nrrd_io.read(path)
    return arr, dict(header, native=False)


def read(path: str) -> Tuple[np.ndarray, dict]:
    """``nrrd_io.read`` through the native decoder; a file it refuses goes
    through the Python codec."""
    lib = _load_library()
    meta = _query(lib.nrrd_query, path)
    arr = None if meta is None else _read_into(lib.nrrd_read_into, path, meta)
    if arr is None:
        return _python_read(path)
    return arr, {"native": True}


def cache_path_for(nrrd_path: str, cache_dir: Optional[str] = None) -> str:
    base = os.path.basename(nrrd_path) + ".rawcache"
    return os.path.join(cache_dir or os.path.dirname(nrrd_path), base)


def read_cached(nrrd_path: str, cache_dir: Optional[str] = None) -> Tuple[np.ndarray, dict]:
    """Read through the raw cache: the NRRD is converted once (again when it
    is newer than its cache), later loads are one read of the cache."""
    lib = _load_library()
    cpath = cache_path_for(nrrd_path, cache_dir)
    with _convert_lock:
        if not os.path.exists(cpath) or os.path.getmtime(cpath) < os.path.getmtime(nrrd_path):
            if cache_dir:
                os.makedirs(cache_dir, exist_ok=True)
            if lib.nrrd_to_rawcache(nrrd_path.encode(), cpath.encode()) != 0:
                return read(nrrd_path)
    meta = _query(lib.rawcache_query, cpath)
    arr = None if meta is None else _read_into(lib.rawcache_read_into, cpath, meta)
    if arr is None:
        return read(nrrd_path)
    return arr, {"native": True, "cached": True}
