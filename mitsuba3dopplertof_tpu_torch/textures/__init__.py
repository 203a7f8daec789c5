"""Texture plugins (port of the JAX package's ``textures/__init__.py``:
``checkerboard``, ``bitmap``, ``mesh_attribute`` and ``volume``;
reference src/textures/{checkerboard,bitmap,mesh_attribute,volume}.cpp).

Every texture in the scene gets a row of the texture table; bitmap images
and volume grids concatenate into one flat rgb atlas so that a gather per
tap evaluates any of them. Checkerboard is procedural; a mesh attribute
is read from the per-triangle attribute table (``SceneArrays.mesh_attr``).
BSDF and emitter rows name their texture by id. In the spectral variant
a parallel atlas holds every texel's sigmoid-polynomial coefficients
(``tex_atlas_c0..c2``), which bitmap lookups evaluate at the lane's hero
wavelengths.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.cie import eval_reflectance_spectrum
from ..core.properties import Properties, register_plugin

# type ids (the JAX package's numbering)
TEX_CHECKERBOARD = 0
TEX_BITMAP = 1
TEX_VOLUME = 2       # a 3D volume sampled at the world hit position
TEX_MESHATTR = 3     # a per-vertex mesh attribute, barycentric-interpolated

N_TEX_PARAMS = 27
# param columns
T_COLOR0 = 0     # checkerboard color0 rgb / mesh_attribute: scale at [0]
T_COLOR1 = 3     # checkerboard color1 rgb
T_UVSCALE = 6    # uv transform: scale u, scale v, offset u, offset v
T_ATLAS = 10     # bitmap, volume: atlas offset (as float), 11: width
T_GRID = 12      # volume: nx, ny, nz at 12..14
T_W2G = 15       # volume: world-to-grid 3x4 row-major at 15..26
# bitmap only (the volume's grid columns: the dispatch is by type)
T_FILTER = 12    # 0 = nearest, 1 = bilinear (reference default)
T_WRAP = 13      # 0 = repeat, 1 = mirror, 2 = clamp

FILTER_MODES = {"nearest": 0, "bilinear": 1}
WRAP_MODES = {"repeat": 0, "mirror": 1, "clamp": 2}


def _get_rgb(props, key, default):
    v = props.get(key, default)
    if isinstance(v, dict):
        v = v.get("value")
    a = np.asarray(v, dtype=np.float64).reshape(-1)
    if a.size == 1:
        a = np.repeat(a, 3)
    return a[:3]


class Texture:
    type_id = TEX_CHECKERBOARD

    def __init__(self, props: Properties):
        self.id = props.id
        m = props.get_transform("to_uv", np.eye(4))
        # uv transform: scale from the 2x2 block, offset from translation
        self.uv_scale = (float(m[0, 0]), float(m[1, 1]))
        self.uv_offset = (float(m[0, 3]), float(m[1, 3]))
        self.image: Optional[np.ndarray] = None   # (h, w, 3) for bitmaps

    def params_row(self) -> np.ndarray:
        p = np.zeros(N_TEX_PARAMS)
        p[T_UVSCALE] = self.uv_scale[0]
        p[T_UVSCALE + 1] = self.uv_scale[1]
        p[T_UVSCALE + 2] = self.uv_offset[0]
        p[T_UVSCALE + 3] = self.uv_offset[1]
        return p

    def mean_rgb(self) -> np.ndarray:
        return np.array([0.5, 0.5, 0.5])


@register_plugin("texture", "checkerboard")
class Checkerboard(Texture):
    """reference src/textures/checkerboard.cpp — color0/color1 grid."""
    type_id = TEX_CHECKERBOARD

    def __init__(self, props: Properties):
        super().__init__(props)
        self.color0 = _get_rgb(props, "color0", [0.4, 0.4, 0.4])
        self.color1 = _get_rgb(props, "color1", [0.2, 0.2, 0.2])

    def params_row(self):
        p = super().params_row()
        p[T_COLOR0:T_COLOR0 + 3] = self.color0
        p[T_COLOR1:T_COLOR1 + 3] = self.color1
        return p

    def mean_rgb(self):
        return 0.5 * (np.asarray(self.color0) + np.asarray(self.color1))


@register_plugin("texture", "bitmap")
class BitmapTexture(Texture):
    """reference src/textures/bitmap.cpp — an image-backed texture with
    bilinear (default) or nearest filtering and repeat / mirror / clamp
    wrapping (bitmap.cpp:145-163); sRGB -> linear on load for 8-bit images
    (the reference's raw=false default)."""
    type_id = TEX_BITMAP

    def __init__(self, props: Properties):
        super().__init__(props)
        from ..core.fresolver import resolve_filename
        filename = resolve_filename(props.get_string("filename"))
        raw = props.get_bool("raw", False)
        ft = props.get_string("filter_type", "bilinear")
        wm = props.get_string("wrap_mode", "repeat")
        if ft not in FILTER_MODES:
            raise RuntimeError(f"bitmap: invalid filter_type '{ft}'")
        if wm not in WRAP_MODES:
            raise RuntimeError(f"bitmap: invalid wrap_mode '{wm}'")
        self.filter_mode = FILTER_MODES[ft]
        self.wrap_mode = WRAP_MODES[wm]
        self.image = self._load(filename, raw)

    def params_row(self):
        p = super().params_row()
        p[T_FILTER] = self.filter_mode
        p[T_WRAP] = self.wrap_mode
        return p

    @staticmethod
    def _load(filename: str, raw: bool) -> np.ndarray:
        from ..io.bitmap import read_exr_rgb
        if filename.lower().endswith(".exr"):
            return np.asarray(read_exr_rgb(filename), np.float32)
        import imageio.v3 as iio
        img = np.asarray(iio.imread(filename), np.float32)
        if img.ndim == 2:
            img = np.stack([img] * 3, axis=-1)
        img = img[..., :3] / 255.0
        if not raw:   # sRGB -> linear
            img = np.where(img <= 0.04045, img / 12.92,
                           ((img + 0.055) / 1.055) ** 2.4)
        return img.astype(np.float32)

    def mean_rgb(self):
        return self.image.reshape(-1, 3).mean(axis=0)


@register_plugin("texture", "mesh_attribute")
class MeshAttribute(Texture):
    """reference src/textures/mesh_attribute.cpp — a per-vertex mesh
    attribute (``vertex_color`` of PLY and .serialized files) interpolated
    barycentrically at the hit. The attribute table is packed per global
    triangle slot at scene compile (render/scene.py)."""
    type_id = TEX_MESHATTR

    def __init__(self, props: Properties):
        super().__init__(props)
        self.name = props.get_string("name")
        self.scale = props.get_float("scale", 1.0)

    def params_row(self):
        p = super().params_row()
        p[T_COLOR0] = self.scale
        return p

    def mean_rgb(self):
        return np.array([0.5, 0.5, 0.5]) * self.scale


@register_plugin("texture", "volume")
class VolumeTexture(Texture):
    """reference src/textures/volume.cpp — a volume (constvolume or
    gridvolume) evaluated at the world hit position through the volume's
    inverse to_world, trilinearly (the medium grids' voxel-centre
    convention)."""
    type_id = TEX_VOLUME

    def __init__(self, props: Properties):
        super().__init__(props)
        from ..volumes import Volume
        self.volume = None
        for key, v in props.objects():
            if isinstance(v, Volume):
                self.volume = v
        if self.volume is None:
            raise RuntimeError("volume texture: provide a nested volume")

    def grid_rgb(self) -> np.ndarray:
        """(nz, ny, nx, 3) float grid (a constant becomes one cell)."""
        v = self.volume
        g = getattr(v, "data", None)
        if g is None:
            return np.asarray(v.mean_rgb(), np.float32).reshape(1, 1, 1, 3)
        g = np.asarray(g, np.float32)
        if g.shape[-1] == 1:
            g = np.repeat(g, 3, axis=-1)
        return g[..., :3]

    def world_to_grid(self) -> np.ndarray:
        m = np.asarray(getattr(self.volume, "to_world", np.eye(4)),
                       np.float64)
        return np.linalg.inv(m)[:3, :4]

    def params_row(self):
        p = super().params_row()
        g = self.grid_rgb()
        p[T_GRID] = g.shape[2]
        p[T_GRID + 1] = g.shape[1]
        p[T_GRID + 2] = g.shape[0]
        p[T_W2G:T_W2G + 12] = self.world_to_grid().reshape(-1)
        return p

    def mean_rgb(self):
        return self.grid_rgb().reshape(-1, 3).mean(axis=0)


# ---------------------------------------------------------------------------
# Device-side evaluation
# ---------------------------------------------------------------------------

def eval_texture(sa, tex_id, uv_u, uv_v, p=None, b_u=None, b_v=None,
                 prim=None, wavelengths=None):
    """Evaluate per-lane textures at (uv_u, uv_v) as Vec3 rgb; lanes with
    ``tex_id < 0`` are the caller's to mask. ``p`` (world hit position)
    serves ``volume`` textures, ``b_u`` / ``b_v`` / ``prim`` (barycentrics
    and global triangle slot) ``mesh_attribute`` textures; where a call
    site has no surface interaction to give, those types return 0.5 gray,
    as the JAX package's do. With ``wavelengths`` (the spectral variant's
    hero wavelengths) a bitmap's texels give their upsampled reflectance
    spectrum there (the atlas's per-texel coefficients); the other types
    keep their rgb as three wavelength values, as in the JAX package."""
    from ..core.vec import Vec3, where3
    idx = torch.clamp(tex_id, min=0).long()

    def param(j):
        return sa.tex_params[j][idx]

    u = uv_u * param(T_UVSCALE) + param(T_UVSCALE + 2)
    v = uv_v * param(T_UVSCALE + 1) + param(T_UVSCALE + 3)

    lane_type = sa.tex_type[idx]
    zero = torch.zeros_like(uv_u)
    out = Vec3(zero, zero, zero)
    for tid in sa.tex_types_present:
        if tid == TEX_CHECKERBOARD:
            cell = (torch.floor(u * 2.0).to(torch.int32)
                    + torch.floor(v * 2.0).to(torch.int32)) & 1
            c0 = Vec3(param(T_COLOR0), param(T_COLOR0 + 1),
                      param(T_COLOR0 + 2))
            c1 = Vec3(param(T_COLOR1), param(T_COLOR1 + 1),
                      param(T_COLOR1 + 2))
            val = where3(cell == 0, c0, c1)
        elif tid == TEX_BITMAP:
            off = param(T_ATLAS).to(torch.int32)
            w = param(T_ATLAS + 1).to(torch.int32)
            h = sa.tex_h[idx]
            filt = param(T_FILTER)
            wrapm = param(T_WRAP).to(torch.int32)

            def wrap_idx(i, n):
                """Per-tap index wrap (reference bitmap.cpp:156-163),
                applied to integer taps so that bilinear weights span
                seams. Lanes of other types (n = 0) take n = 1, which
                changes no bitmap lane and divides by no zero."""
                n = torch.clamp(n, min=1)
                rep = torch.remainder(i, n)
                t2 = torch.remainder(i, 2 * n)
                t2 = torch.where(t2 < 0, t2 + 2 * n, t2)
                mir = torch.where(t2 >= n, 2 * n - 1 - t2, t2)
                clp = torch.minimum(torch.clamp(i, min=0), n - 1)
                return torch.where(wrapm == 0, rep,
                                   torch.where(wrapm == 1, mir, clp))

            spectral = (wavelengths is not None
                        and sa.tex_atlas_c0.shape[0] > 1)

            def fetch(xi, yi):
                flat = (off + wrap_idx(yi, h) * w + wrap_idx(xi, w)).long()
                if spectral:
                    c0 = sa.tex_atlas_c0[flat]
                    c1 = sa.tex_atlas_c1[flat]
                    c2 = sa.tex_atlas_c2[flat]
                    return Vec3(*(eval_reflectance_spectrum(c0, c1, c2, lam)
                                  for lam in wavelengths))
                return Vec3(sa.tex_atlas_r[flat], sa.tex_atlas_g[flat],
                            sa.tex_atlas_b[flat])

            wf = w.to(u.dtype)
            hf = h.to(v.dtype)
            # nearest tap
            xn = torch.floor(u * wf).to(torch.int32)
            yn = torch.floor(v * hf).to(torch.int32)
            # bilinear taps at texel centers (the reference's half-texel
            # shift)
            xf = u * wf - 0.5
            yf = v * hf - 0.5
            x0 = torch.floor(xf).to(torch.int32)
            y0 = torch.floor(yf).to(torch.int32)
            fx = xf - torch.floor(xf)
            fy = yf - torch.floor(yf)
            v00 = fetch(x0, y0)
            v10 = fetch(x0 + 1, y0)
            v01 = fetch(x0, y0 + 1)
            v11 = fetch(x0 + 1, y0 + 1)
            lin = (v00 * ((1.0 - fx) * (1.0 - fy)) + v10 * (fx * (1.0 - fy))
                   + v01 * ((1.0 - fx) * fy) + v11 * (fx * fy))
            val = where3(filt > 0.5, lin, fetch(xn, yn))
        elif tid == TEX_VOLUME and p is not None:
            val = _eval_volume(sa, param, p)
        elif (tid == TEX_MESHATTR and b_u is not None and prim is not None
              and sa.mesh_attr is not None):
            # barycentric interpolation of the packed per-vertex
            # attribute (reference mesh_attribute.cpp eval), times scale
            ma = sa.mesh_attr
            pr = torch.clamp(prim, 0, ma.shape[1] - 1).long()
            bw = 1.0 - b_u - b_v
            val = Vec3(
                bw * ma[0][pr] + b_u * ma[3][pr] + b_v * ma[6][pr],
                bw * ma[1][pr] + b_u * ma[4][pr] + b_v * ma[7][pr],
                bw * ma[2][pr] + b_u * ma[5][pr] + b_v * ma[8][pr]
            ) * param(T_COLOR0)
        elif tid in (TEX_VOLUME, TEX_MESHATTR):
            # no surface interaction at this call site
            h = torch.full_like(uv_u, 0.5)
            val = Vec3(h, h, h)
        else:
            raise ValueError(f"unknown texture type {tid}")
        out = where3(lane_type == tid, val, out)
    return out


def _eval_volume(sa, param, p):
    """A volume texture at world points ``p``: world -> the volume's
    [0,1]^3 by T_W2G, then a trilinear lookup in the atlas with the
    voxel-centre convention of the medium grids (reference volume.cpp
    eval, gridvolume.cpp)."""
    from ..core.vec import Vec3
    from ..volumes import grid_cell, trilinear

    def w2g(j):
        return param(T_W2G + j)
    lx = w2g(0) * p.x + w2g(1) * p.y + w2g(2) * p.z + w2g(3)
    ly = w2g(4) * p.x + w2g(5) * p.y + w2g(6) * p.z + w2g(7)
    lz = w2g(8) * p.x + w2g(9) * p.y + w2g(10) * p.z + w2g(11)
    nx = param(T_GRID).to(torch.int32)
    ny = param(T_GRID + 1).to(torch.int32)
    off = param(T_ATLAS).to(torch.int32)
    last = sa.tex_atlas_r.shape[0] - 1

    def at(x, y, z):
        lin = torch.clamp(off + (z * ny + y) * nx + x, 0, last).long()
        return Vec3(sa.tex_atlas_r[lin], sa.tex_atlas_g[lin],
                    sa.tex_atlas_b[lin])
    return trilinear(at, grid_cell(lx, nx), grid_cell(ly, ny),
                     grid_cell(lz, param(T_GRID + 2).to(torch.int32)))


__all__ = ["Texture", "Checkerboard", "BitmapTexture", "MeshAttribute",
           "VolumeTexture", "eval_texture", "N_TEX_PARAMS",
           "TEX_CHECKERBOARD", "TEX_BITMAP", "TEX_VOLUME", "TEX_MESHATTR",
           "T_COLOR0", "T_COLOR1", "T_UVSCALE", "T_ATLAS", "T_GRID",
           "T_W2G", "T_FILTER", "T_WRAP"]
