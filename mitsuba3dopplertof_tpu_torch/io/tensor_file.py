"""Mitsuba tensor-file container (port of the JAX package's
``io/tensor_file.py``; reference src/core/tensor.cpp): little-endian
'tensor_file' header, version (1, 0), a field table of (name, ndim, dtype,
offset, shape). The measured BSDF reads its .bsdf files (the RGL material
database format) with it; ``utils/measured_data.py`` writes them."""

from __future__ import annotations

import struct
from typing import Dict

import numpy as np

_DTYPES = {1: np.uint8, 2: np.int8, 3: np.uint16, 4: np.int16,
           5: np.uint32, 6: np.int32, 7: np.uint64, 8: np.int64,
           10: np.float32, 11: np.float64}
_DTYPE_IDS = {np.dtype(np.uint8): 1, np.dtype(np.float32): 10,
              np.dtype(np.float64): 11, np.dtype(np.int32): 6,
              np.dtype(np.uint32): 5, np.dtype(np.uint16): 3}


def read_tensor_file(path: str) -> Dict[str, np.ndarray]:
    with open(path, "rb") as f:
        buf = f.read()
    if buf[:12] != b"tensor_file\x00":
        raise RuntimeError(f"{path}: invalid tensor file header")
    n_fields, = struct.unpack_from("<I", buf, 14)
    pos = 18
    out = {}
    for _ in range(n_fields):
        name_len, = struct.unpack_from("<H", buf, pos)
        pos += 2
        name = buf[pos:pos + name_len].decode()
        pos += name_len
        ndim, = struct.unpack_from("<H", buf, pos)
        pos += 2
        dtype = buf[pos]
        pos += 1
        offset, = struct.unpack_from("<Q", buf, pos)
        pos += 8
        shape = struct.unpack_from(f"<{ndim}Q", buf, pos)
        pos += 8 * ndim
        np_dt = _DTYPES.get(dtype)
        if np_dt is None:
            raise RuntimeError(f"{path}: unknown dtype id {dtype}")
        count = int(np.prod(shape)) if shape else 1
        arr = np.frombuffer(buf, np_dt, count=count, offset=offset)
        out[name] = arr.reshape(shape)
    return out


def write_tensor_file(path: str, fields: Dict[str, np.ndarray]):
    """Writer (for converting/synthesizing .bsdf data)."""
    header = bytearray()
    header += b"tensor_file\x00"
    header += bytes([1, 0])
    header += struct.pack("<I", len(fields))
    entries = []
    # first pass to compute header size
    hsize = len(header)
    metas = []
    for name, arr in fields.items():
        arr = np.ascontiguousarray(arr)
        nb = name.encode()
        hsize += 2 + len(nb) + 2 + 1 + 8 + 8 * arr.ndim
        metas.append((nb, arr))
    offset = hsize
    body = bytearray()
    for nb, arr in metas:
        dt = _DTYPE_IDS.get(arr.dtype)
        if dt is None:
            raise RuntimeError(f"unsupported dtype {arr.dtype}")
        header += struct.pack("<H", len(nb)) + nb
        header += struct.pack("<H", arr.ndim)
        header += bytes([dt])
        header += struct.pack("<Q", offset)
        for s in arr.shape:
            header += struct.pack("<Q", s)
        body += arr.tobytes()
        offset += arr.nbytes
    with open(path, "wb") as f:
        f.write(bytes(header) + bytes(body))


__all__ = ["read_tensor_file", "write_tensor_file"]
