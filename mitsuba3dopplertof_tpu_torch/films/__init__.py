"""Film plugins and image accumulation (port of the JAX package's
``films/__init__.py``: hdrfilm, ``block_create``, ``filter_reach``,
``block_splat_wavefront`` and ``develop``).

The reference accumulates weighted samples with atomic scatter_reduce
(src/render/imageblock.cpp:119-127,174-400) and develops rgb = value /
weight (src/films/hdrfilm.cpp:305+). Here, as in the JAX package, there are
no scatters: the wavefront is pixel-major (lane = pixel*spp + s), so the
per-pixel sum is a reshape and a reduction, and a reconstruction filter's
footprint becomes (2K+1)^2 shifted dense images added at static offsets.

The sum over a pixel's samples is a pairwise tree of elementwise adds in a
fixed order, and the shifted images are added in descending row offset,
i.e. in ascending source row. A pixel therefore receives the same float
additions in the same order whether the frame is rendered in one pass or
in strips of rows, on the CPU and on the card alike: strip-pass renders
equal single-pass renders bit for bit. The block is updated in place.

Block layout is (C, H, W).
"""

from __future__ import annotations

import math
from typing import List, Tuple

import torch

from ..core.properties import Properties, register_plugin


class Film:
    def __init__(self, props: Properties):
        self.id = props.id
        self.width = props.get_int("width", 768)
        self.height = props.get_int("height", 576)
        self.pixel_format = props.get_string("pixel_format", "rgb")
        self.file_format = props.get_string("file_format", "openexr")
        self.component_format = props.get_string("component_format",
                                                 "float16")
        if self.component_format not in ("float16", "float32"):
            raise RuntimeError(
                f"film: unknown component_format '{self.component_format}'")
        # stored as the JAX package stores them; nothing reads them
        self.crop_offset = (props.get_int("crop_offset_x", 0),
                            props.get_int("crop_offset_y", 0))
        self.crop_size = (props.get_int("crop_width", self.width),
                          props.get_int("crop_height", self.height))
        self.sample_border = props.get_bool("sample_border", False)
        self.rfilter = None
        from ..rfilters import ReconstructionFilter
        for key, v in props.objects():
            if isinstance(v, ReconstructionFilter):
                self.rfilter = v
        if self.rfilter is None:
            from ..rfilters import GaussianFilter
            self.rfilter = GaussianFilter(Properties("gaussian"))

    @property
    def size(self) -> Tuple[int, int]:
        return (self.width, self.height)

    @property
    def has_alpha(self) -> bool:
        return "a" in self.pixel_format.lower()

    @property
    def channel_count(self) -> int:
        # RGB + [A] + W (reference hdrfilm develop: base_ch = alpha ? 5 : 4)
        return 5 if self.has_alpha else 4

    @property
    def weight_index(self) -> int:
        return 4 if self.has_alpha else 3


@register_plugin("film", "hdrfilm")
class HDRFilm(Film):
    pass


def block_create(width: int, height: int, n_channels: int, device=None):
    return torch.zeros((n_channels, height, width), device=device)


def filter_reach(rfilter) -> int:
    """Largest pixel offset a sample's filter footprint reaches (the K of
    the (2K+1)^2 shifted-image splat)."""
    if rfilter.is_box:
        return 0
    count = int(math.ceil(2.0 * float(rfilter.radius)))
    return count // 2 + (count % 2)


def _tree_sum(x):
    """Row sums of a (M, S) tensor as a pairwise tree of elementwise adds:
    the same additions in the same order for any M and on any device."""
    while x.shape[1] > 1:
        h = x.shape[1] // 2
        y = x[:, :h] + x[:, h:2 * h]
        x = torch.cat([y, x[:, 2 * h:]], dim=1) if x.shape[1] % 2 else y
    return x[:, 0]


def block_splat_wavefront(block, rfilter, pos_x, pos_y, values: List,
                          active, W: int, H: int, spp: int,
                          pad_rows: int = 0, row0: int = 0,
                          strip_rows: int = None):
    """Add a pixel-major wavefront into ``block`` (in place; returned).

    ``pos_x/pos_y``: continuous global sample positions (N,). ``values``:
    C (N,) channel tensors. With ``strip_rows`` the wavefront covers pixel
    rows [row0, row0 + strip_rows) only, and ``block`` is the strip canvas
    with ``pad_rows >= filter_reach(rfilter)`` rows of padding above and
    below, so taps that cross a strip land in canvas rows.
    (reference imageblock.cpp:263-344, continuous JIT path).
    """
    HC = block.shape[1]
    n = pos_x.shape[0]
    dev = pos_x.device
    values = [torch.where(active, v, 0.0) for v in values]
    strip = strip_rows is not None
    rows = strip_rows if strip else H
    lpix = torch.arange(n, dtype=torch.int32, device=dev) // spp
    pix_x = lpix % W
    pix_y = lpix // W + (row0 if strip else 0)

    def segsum(v):
        return _tree_sum(v.reshape(rows * W, spp)).reshape(rows, W)

    y_base = pad_rows + row0 if strip else pad_rows

    if rfilter.is_box:
        # samples land in their own pixel (imageblock.cpp:471)
        block[:, y_base:y_base + rows, :] += torch.stack(
            [segsum(v) for v in values])
        return block

    radius = float(rfilter.radius)
    count = int(math.ceil(2.0 * radius))
    K = count // 2 + (count % 2)          # max |offset| from own pixel
    if strip and pad_rows < K:
        raise ValueError(f"strip splat needs pad_rows >= {K} for this "
                         "filter")

    pos_fx = pos_x - 0.5
    pos_fy = pos_y - 0.5
    lo_x = torch.ceil(pos_fx - radius).to(torch.int32)
    lo_y = torch.ceil(pos_fy - radius).to(torch.int32)
    hi_x = torch.floor(pos_fx + radius).to(torch.int32)
    hi_y = torch.floor(pos_fy + radius).to(torch.int32)
    wx = [rfilter.eval(lo_x.to(pos_x.dtype) - pos_fx + k)
          for k in range(count)]
    wy = [rfilter.eval(lo_y.to(pos_y.dtype) - pos_fy + k)
          for k in range(count)]
    vx = [lo_x + k <= hi_x for k in range(count)]
    vy = [lo_y + k <= hi_y for k in range(count)]
    rel_x = lo_x - pix_x        # in [-K, K]
    rel_y = lo_y - pix_y

    def tap_weight(rel, valid, w, off):
        acc = None
        for k in range(count):
            term = torch.where((rel + k == off) & valid[k], w[k], 0.0)
            acc = term if acc is None else acc + term
        return acc

    wsum_x = [tap_weight(rel_x, vx, wx, dx) for dx in range(-K, K + 1)]
    for dy_off in range(K, -K - 1, -1):
        wsum_y = tap_weight(rel_y, vy, wy, dy_off)
        for dx_off in range(-K, K + 1):
            wgt = wsum_y * wsum_x[dx_off + K]
            sx0 = max(0, -dx_off)
            wdt = W - abs(dx_off)
            x0 = max(0, dx_off)
            imgs = torch.stack([segsum(v * wgt)[:, sx0:sx0 + wdt]
                                for v in values])
            if strip:
                y0 = y_base + dy_off
                block[:, y0:y0 + rows, x0:x0 + wdt] += imgs
                continue
            # a sample in source row r lands at canvas row pad + r + dy;
            # clip to the canvas
            dlo_y = max(0, pad_rows + dy_off)
            dhi_y = min(pad_rows + H + dy_off, HC)
            slo_y = dlo_y - (pad_rows + dy_off)
            block[:, dlo_y:dhi_y, x0:x0 + wdt] += \
                imgs[:, slo_y:slo_y + (dhi_y - dlo_y)]
    return block


def develop(block, has_alpha: bool, weight_idx: int = None):
    """value / weight per channel (reference hdrfilm.cpp:305+), the weight
    channel dropped; pixels of zero weight develop to 0. Returns (H, W,
    C-1)."""
    if weight_idx is None:
        weight_idx = 4 if has_alpha else 3
    w = block[weight_idx]
    safe = torch.where(w > 0.0, w, 1.0)
    keep = torch.cat([block[:weight_idx], block[weight_idx + 1:]], dim=0)
    vals = torch.where((w > 0.0)[None], keep / safe[None], 0.0)
    return vals.permute(1, 2, 0)


__all__ = ["Film", "HDRFilm", "block_create", "filter_reach",
           "block_splat_wavefront", "develop"]
