"""Volume data sources (port of the JAX package's ``volumes/__init__.py``;
reference src/volumes/{constvolume,gridvolume}.cpp)."""

from __future__ import annotations

import struct

import numpy as np

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


__all__ = ["Volume", "ConstVolume", "GridVolume"]
