"""Volume data sources (port of the JAX package's ``volumes/__init__.py``;
reference src/volumes/{constvolume,gridvolume}.cpp), and the trilinear
lookup that volpath's density and S grids and the volume texture share:
voxel centres at (i + 0.5) / n of the unit cube, clamped at its faces."""

from __future__ import annotations

import struct

import numpy as np
import torch

from ..core.properties import Properties, register_plugin


class Volume:
    def __init__(self, props: Properties):
        self.id = props.id

    def mean_rgb(self) -> np.ndarray:
        return np.ones(3)


@register_plugin("volume", "constvolume")
class ConstVolume(Volume):
    """reference src/volumes/constvolume.cpp."""

    def __init__(self, props: Properties):
        super().__init__(props)
        v = props.get("value", 1.0)
        if isinstance(v, dict):
            v = v.get("value")
        a = np.asarray(v, np.float64).reshape(-1)
        self.values_raw = a
        self.value = np.repeat(a, 3)[:3] if a.size == 1 else a[:3]

    def mean_rgb(self):
        return self.value


@register_plugin("volume", "gridvolume")
class GridVolume(Volume):
    """reference src/volumes/gridvolume.cpp — Mitsuba .vol grids (format 3,
    float32). The grid loads whole; integrators/volpath.py samples it
    trilinearly (``_grid_density``); ``to_world`` maps the unit cube
    [0,1]^3 onto the grid's world bounds."""

    def __init__(self, props: Properties):
        super().__init__(props)
        from ..core.fresolver import resolve_filename
        filename = resolve_filename(props.get_string("filename"))
        self.to_world = np.asarray(
            props.get_transform("to_world", np.eye(4)), np.float64)
        self.filter_type = props.get_string("filter_type", "trilinear")
        if self.filter_type not in ("trilinear", "nearest"):
            raise RuntimeError(
                f"gridvolume: unknown filter_type '{self.filter_type}'")
        # raw: scalar density grids carry no color transfer either way
        props.get_bool("raw", False)
        self.data = self._load_vol(filename)

    def max(self) -> float:
        return float(self.data.max())

    def scalar_grid(self):
        """(nz, ny, nx) float32 density (channel 0)."""
        return np.ascontiguousarray(self.data[..., 0], np.float32)

    @staticmethod
    def _load_vol(filename: str) -> np.ndarray:
        with open(filename, "rb") as f:
            buf = f.read()
        if buf[:3] != b"VOL":
            raise RuntimeError(f"{filename}: not a Mitsuba .vol file")
        version = buf[3]
        dtype_id, xres, yres, zres, channels = struct.unpack_from(
            "<iiiii", buf, 4)
        if dtype_id != 1:
            raise RuntimeError(".vol: only float32 grids supported")
        # bbox: 6 floats
        data = np.frombuffer(buf, np.float32,
                             count=xres * yres * zres * channels,
                             offset=4 + 20 + 24)
        return data.reshape(zres, yres, xres, channels)

    def mean_rgb(self):
        m = float(self.data.mean())
        return np.full(3, m)


def grid_cell(lc, n):
    """(i0, i1, t) along one axis of grids of ``n`` voxels (int32 tensors)
    at unit-cube coordinates ``lc``: the two voxels whose centres bracket
    the point, clamped to the grid, and the weight of the second."""
    nf = torch.clamp(n.to(lc.dtype), min=1.0)
    f = torch.minimum(torch.clamp(lc * nf - 0.5, min=0.0), nf - 1.0)
    i0 = f.to(torch.int32)
    return (i0, torch.minimum(i0 + 1, torch.clamp(n - 1, min=0)),
            f - i0.to(lc.dtype))


def trilinear(at, cx, cy, cz):
    """The trilinear blend of ``at(x, y, z)`` (a voxel's value) over the
    cells ``cx``, ``cy``, ``cz`` of ``grid_cell``; the weights broadcast
    against the values (give (N, 1) weights for (N, C) values)."""
    x0, x1, tx = cx
    y0, y1, ty = cy
    z0, z1, tz = cz
    c00 = at(x0, y0, z0) * (1 - tx) + at(x1, y0, z0) * tx
    c10 = at(x0, y1, z0) * (1 - tx) + at(x1, y1, z0) * tx
    c01 = at(x0, y0, z1) * (1 - tx) + at(x1, y0, z1) * tx
    c11 = at(x0, y1, z1) * (1 - tx) + at(x1, y1, z1) * tx
    c0 = c00 * (1 - ty) + c10 * ty
    c1 = c01 * (1 - ty) + c11 * ty
    return c0 * (1 - tz) + c1 * tz


__all__ = ["Volume", "ConstVolume", "GridVolume", "grid_cell", "trilinear"]
