"""Minimal self-contained NRRD reader/writer (the port's copy of
``rpnet_tpu/core/nrrd_io.py``).

The reference stores every volume as NRRD (`{pid}_clean.nrrd` +
`{pid}_{roi}.nrrd`, written by utils/preprocess_abd_110.py:96-112 and read by
dataset/few_shot_reader.py:326-334 via the third-party `pynrrd` package).
`pynrrd` is not part of this framework's dependency set, so we ship our own
codec for the subset of NRRD actually used by medical-CT pipelines:

  * NRRD0004/0005 headers, `raw` and `gzip` encodings
  * little/big endian scalar types (int8..int64, uint8..uint64, float32/64)
  * detached headers are NOT supported (the reference never produces them)

Array convention matches `pynrrd`'s default ``index_order='F'``: the returned
array has ``shape == sizes`` with the first axis fastest-varying on disk, so
files written by pynrrd and by this module are interchangeable.
"""

from __future__ import annotations

import gzip
import os
import zlib
from typing import Any, Dict, Tuple

import numpy as np

_NRRD_TYPE_TO_DTYPE = {
    "signed char": "i1", "int8": "i1", "int8_t": "i1",
    "uchar": "u1", "unsigned char": "u1", "uint8": "u1", "uint8_t": "u1",
    "short": "i2", "short int": "i2", "signed short": "i2", "int16": "i2", "int16_t": "i2",
    "ushort": "u2", "unsigned short": "u2", "uint16": "u2", "uint16_t": "u2",
    "int": "i4", "signed int": "i4", "int32": "i4", "int32_t": "i4",
    "uint": "u4", "unsigned int": "u4", "uint32": "u4", "uint32_t": "u4",
    "longlong": "i8", "long long": "i8", "int64": "i8", "int64_t": "i8",
    "ulonglong": "u8", "unsigned long long": "u8", "uint64": "u8", "uint64_t": "u8",
    "float": "f4", "double": "f8",
}

_DTYPE_TO_NRRD_TYPE = {
    "int8": "int8", "uint8": "uint8",
    "int16": "int16", "uint16": "uint16",
    "int32": "int32", "uint32": "uint32",
    "int64": "int64", "uint64": "uint64",
    "float32": "float", "float64": "double",
}


def _parse_header(f) -> Dict[str, str]:
    magic = f.readline().decode("ascii", "replace").strip()
    if not magic.startswith("NRRD"):
        raise ValueError(f"not an NRRD file (magic={magic!r})")
    header: Dict[str, str] = {}
    while True:
        line = f.readline()
        if line in (b"", b"\n", b"\r\n"):
            break
        text = line.decode("ascii", "replace").rstrip("\r\n")
        if text.startswith("#"):
            continue
        if ":=" in text:
            key, val = text.split(":=", 1)
        elif ": " in text:
            key, val = text.split(": ", 1)
        elif text.endswith(":"):
            key, val = text[:-1], ""
        else:
            continue
        header[key.strip().lower()] = val.strip()
    return header


def read(path: str) -> Tuple[np.ndarray, Dict[str, Any]]:
    """Read an NRRD file → ``(array, header)`` like ``pynrrd.read``."""
    with open(path, "rb") as f:
        header = _parse_header(f)
        payload = f.read()

    sizes = tuple(int(s) for s in header["sizes"].split())
    nrrd_type = header["type"].lower()
    if nrrd_type not in _NRRD_TYPE_TO_DTYPE:
        raise ValueError(f"unsupported NRRD type {nrrd_type!r}")
    code = _NRRD_TYPE_TO_DTYPE[nrrd_type]
    endian = header.get("endian", "little")
    dtype = np.dtype(("<" if endian == "little" else ">") + code)

    encoding = header.get("encoding", "raw").lower()
    if encoding in ("raw",):
        buf = payload
    elif encoding in ("gzip", "gz"):
        buf = gzip.decompress(payload)
    elif encoding in ("zlib",):
        buf = zlib.decompress(payload)
    else:
        raise ValueError(f"unsupported NRRD encoding {encoding!r}")

    count = int(np.prod(sizes))
    arr = np.frombuffer(buf, dtype=dtype, count=count)
    # Disk layout: first listed axis fastest (NRRD spec). Reshape C-order with
    # reversed sizes, then transpose → shape == sizes (pynrrd index_order='F').
    arr = arr.reshape(sizes[::-1]).transpose(tuple(range(len(sizes) - 1, -1, -1)))
    return np.ascontiguousarray(arr), header


def write(path: str, data: np.ndarray, header: Dict[str, Any] | None = None,
          encoding: str = "gzip") -> None:
    """Write ``data`` as NRRD (pynrrd-compatible, index_order='F')."""
    data = np.asarray(data)
    name = data.dtype.name
    if name not in _DTYPE_TO_NRRD_TYPE:
        raise ValueError(f"unsupported dtype {name}")
    sizes = data.shape
    lines = [
        "NRRD0004",
        "# written by rpnet_tpu_torch.core.nrrd_io",
        f"type: {_DTYPE_TO_NRRD_TYPE[name]}",
        f"dimension: {data.ndim}",
        f"sizes: {' '.join(str(s) for s in sizes)}",
        f"encoding: {encoding}",
    ]
    if data.dtype.itemsize > 1:
        lines.append("endian: little")
    if header:
        skip = {"type", "dimension", "sizes", "encoding", "endian", "data file", "datafile"}
        for k, v in header.items():
            if str(k).lower() not in skip:
                lines.append(f"{k}: {v}")
    # fastest axis first on disk == C-order bytes of the reversed-transposed array
    raw = np.ascontiguousarray(data.transpose(tuple(range(data.ndim - 1, -1, -1))))
    raw = raw.astype(data.dtype.newbyteorder("<"), copy=False).tobytes()
    if encoding == "gzip":
        payload = gzip.compress(raw, compresslevel=1)
    elif encoding == "raw":
        payload = raw
    else:
        raise ValueError(f"unsupported encoding {encoding!r}")
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(("\n".join(lines) + "\n\n").encode("ascii"))
        f.write(payload)
    os.replace(tmp, path)
