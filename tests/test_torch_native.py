"""The port's native NRRD reader (``rpnet_tpu_torch/core/native_cache.py``,
its own copy of the C++ decoder) against the JAX package's: equal arrays
and dtypes from the same files, ``.rawcache`` files that either package
writes read by the other, a file the decoder refuses read by the Python
codec (and the metadata saying so), and a failed build raising instead of
falling back."""

import os

import numpy as np
import pytest
import torch

from rpnet_tpu.core import native_cache as jax_native
from rpnet_tpu_torch.core import native_cache, nrrd_io

torch.set_num_threads(2)   # small shapes; the suite runs several workers on one machine


@pytest.fixture(scope="module")
def volumes(tmp_path_factory):
    """Synthetic NRRDs in both encodings: (path, array) by name."""
    root = tmp_path_factory.mktemp("native")
    rng = np.random.RandomState(0)
    out = {}
    for name, dtype, enc in [("ct", np.int16, "gzip"), ("mask", np.uint8, "gzip"),
                             ("f32", np.float32, "raw"), ("u16", np.uint16, "raw")]:
        vol = (rng.rand(6, 9, 11) * 1000 - (500 if dtype in (np.int16, np.float32) else 0))
        vol = vol.astype(dtype)
        path = str(root / f"{name}.nrrd")
        nrrd_io.write(path, vol, encoding=enc)
        out[name] = (path, vol)
    return out


def test_read_matches_jax(volumes):
    for name, (path, vol) in volumes.items():
        (a, meta), (b, _) = native_cache.read(path), jax_native.read(path)
        assert meta == {"native": True}
        assert a.dtype == b.dtype == vol.dtype and a.shape == b.shape == vol.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
        np.testing.assert_array_equal(a, vol, err_msg=name)


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_rawcache_interchanges_with_jax(volumes, tmp_path, writer):
    """A ``.rawcache`` that one package writes, the other reads as its cache."""
    first, second = ((native_cache, jax_native) if writer == "torch"
                     else (jax_native, native_cache))
    for name, (path, vol) in volumes.items():
        a, meta_a = first.read_cached(path, cache_dir=str(tmp_path))
        cpath = native_cache.cache_path_for(path, str(tmp_path))
        assert cpath == jax_native.cache_path_for(path, str(tmp_path))
        stamp = os.stat(cpath).st_mtime_ns
        b, meta_b = second.read_cached(path, cache_dir=str(tmp_path))
        assert os.stat(cpath).st_mtime_ns == stamp, "the cache was written again"
        assert meta_a["cached"] and meta_b["cached"]
        assert a.dtype == b.dtype == vol.dtype
        np.testing.assert_array_equal(a, vol, err_msg=name)
        np.testing.assert_array_equal(b, vol, err_msg=name)


def test_refused_file_goes_through_the_python_codec(tmp_path):
    """The decoder takes little-endian files only: a big-endian one is read by
    the Python codec, and the metadata says so, as in the JAX module."""
    vol = (np.arange(4 * 5 * 3, dtype=np.int16) - 30).reshape(4, 5, 3)
    path = str(tmp_path / "big.nrrd")
    header = "NRRD0004\ntype: int16\ndimension: 3\nsizes: 4 5 3\nendian: big\nencoding: raw\n\n"
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(vol.transpose(2, 1, 0).astype(">i2").tobytes())
    for fn in (native_cache.read, lambda p: native_cache.read_cached(p, str(tmp_path / "c"))):
        arr, meta = fn(path)
        assert meta["native"] is False and meta["endian"] == "big"
        np.testing.assert_array_equal(arr, vol)
        np.testing.assert_array_equal(arr, jax_native.read(path)[0])


def test_failed_build_raises(monkeypatch, tmp_path):
    """No silent fallback: a compiler that cannot build the library makes the
    readers raise with its message (the JAX module reads through pynrrd's
    stand-in instead)."""
    path = str(tmp_path / "v.nrrd")
    nrrd_io.write(path, np.zeros((2, 3, 4), np.int16))
    monkeypatch.setattr(native_cache, "_lib", None)
    monkeypatch.setattr(native_cache, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native_cache, "CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="no-such-compiler"):
        native_cache.read_cached(path)
    assert not native_cache.native_available()
    assert not os.path.exists(native_cache.cache_path_for(path))
