"""Scenes of the textured-surface, emitter and phase plugins, built here
(not published scenes), with the assets they read written by numpy and
the port's own EXR writer:

- ``surface_scene``: a wall under ``normalmap`` over diffuse, a floor
  under ``bumpmap`` (a bitmap height) over roughplastic, a panel whose
  diffuse reflectance is a ``volume`` texture, a rectangle area light with
  a checkerboard radiance and a sphere area light with a bitmap radiance;
  ``dopplertofpath`` with the correlated sampler, as on the canonical
  scene (10 triangles and a sphere: kernel B1);
- ``mesh_light_scene``: the animated UV sphere of ``bench_scenes`` written
  as a binary PLY with vertex colours and shaded by ``mesh_attribute``,
  under a flat mesh area light with uvs and a bitmap radiance (above 192
  triangles: kernel B2);
- ``media_scene``: four boxes holding homogeneous media with the
  ``rayleigh``, ``blendphase``, ``tabphase`` and ``sggx`` phases, the
  last with a 6-channel ``gridvolume`` S that varies in space, under
  ``volpath``.

    assets = write_surface_assets(tmp_dir)
    scene = mi.load_dict(surface_scene(assets, spp=64, res=256))

``tf`` / ``anim_cls``: the transform module and AnimatedTransform class of
the package that loads the dict (default: the port's).
"""

from __future__ import annotations

import os
import struct

import numpy as np

from ..core import transform as _tf
from ..core.transform import AnimatedTransform as _AnimatedTransform
from ..io.bitmap import write_exr
from .bench_scenes import animated_mesh_scene, uv_sphere_grid


def write_vol(path: str, data: np.ndarray):
    """A Mitsuba .vol grid (format 3, float32) of ``data`` (z, y, x, ch),
    its bounding box the unit cube."""
    nz, ny, nx, ch = data.shape
    with open(path, "wb") as f:
        f.write(b"VOL" + bytes([3]))
        f.write(struct.pack("<iiiii", 1, nx, ny, nz, ch))
        f.write(struct.pack("<6f", 0, 0, 0, 1, 1, 1))
        f.write(np.ascontiguousarray(data, np.float32).tobytes())


def _write_rgb_exr(path: str, img: np.ndarray):
    # FLOAT channels, no compression: every EXR reader of either package
    # reads it
    write_exr(path, {"R": img[..., 0], "G": img[..., 1], "B": img[..., 2]},
              half=False, compression="none")


def _smooth_noise(rng, h, w, octaves=((4, 1.0), (9, 0.4), (17, 0.15))):
    """A smooth, irregular field on an h x w texel grid in [0, 1]: random
    values on coarse lattices, bilinearly upsampled and summed. No two
    neighbouring texels are equal, so a height difference across a texel
    is never zero by symmetry (a zero gradient would leave the sign of a
    bumped normal's component to rounding)."""
    out = np.zeros((h, w))
    for k, amp in octaves:
        lat = rng.random((k + 1, k + 1))
        y = np.linspace(0, k, h, endpoint=False) + 0.5 * k / h
        x = np.linspace(0, k, w, endpoint=False) + 0.5 * k / w
        y0, x0 = np.floor(y).astype(int), np.floor(x).astype(int)
        fy, fx = (y - y0)[:, None], (x - x0)[None, :]
        out += amp * ((1 - fy) * (1 - fx) * lat[y0][:, x0]
                      + (1 - fy) * fx * lat[y0][:, x0 + 1]
                      + fy * (1 - fx) * lat[y0 + 1][:, x0]
                      + fy * fx * lat[y0 + 1][:, x0 + 1])
    out += 1e-3 * rng.random((h, w))
    return (out - out.min()) / (out.max() - out.min())


def write_surface_assets(directory: str, seed: int = 7) -> dict:
    """Write the surface scene's maps into ``directory``, made from
    ``seed``: a 64x64 tangent-space normal map and a 64x64 height map of
    irregular bumps, a 32x64 radiance map for the sphere light, and an
    8x8x8 rgb volume. Returns their paths by name."""
    os.makedirs(directory, exist_ok=True)
    rng = np.random.default_rng(seed)
    paths = {"normal": os.path.join(directory, "bumps_normal.exr"),
             "height": os.path.join(directory, "bumps_height.exr"),
             "glow": os.path.join(directory, "glow.exr"),
             "tint": os.path.join(directory, "tint.vol")}
    # the normal map: the normals of an irregular height field
    f = 0.6 * _smooth_noise(rng, 64, 64)
    gy, gx = np.gradient(f, 1.0 / 64)
    n = np.stack([-0.08 * gx, -0.08 * gy, np.ones_like(f)], -1)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    _write_rgb_exr(paths["normal"], 0.5 * n + 0.5)
    h = _smooth_noise(rng, 64, 64)
    _write_rgb_exr(paths["height"], np.repeat(h[..., None], 3, -1))
    v, u = np.meshgrid((np.arange(32) + 0.5) / 32, (np.arange(64) + 0.5) / 64,
                       indexing="ij")
    glow = np.stack([8 + 6 * np.cos(2 * np.pi * u), 6 + 5 * np.sin(
        3 * np.pi * v), 4 + 3 * np.cos(4 * np.pi * u) * np.sin(np.pi * v)],
        -1) * (0.8 + 0.4 * _smooth_noise(rng, 32, 64))[..., None]
    _write_rgb_exr(paths["glow"], glow)
    g = np.linspace(0.1, 0.9, 8)
    zz, yy, xx = np.meshgrid(g, g, g, indexing="ij")
    write_vol(paths["tint"], np.stack([xx, yy, 1.0 - 0.5 * (xx + zz)], -1))
    return paths


def write_sggx_vol(path: str, sxy_max: float = 0.1):
    """A 6-channel S grid (8 x 4 x 4) whose microflakes turn across x:
    normal to z on the left half, to y on the right, with an off-diagonal
    Sxy that grows with z from 0 to ``sxy_max``. At the default 0.1 every
    S is positive definite, as a microflake distribution must be (det >=
    0.01); on the right half Sxy above sqrt(0.02) breaks that."""
    data = np.zeros((4, 4, 8, 6), np.float32)
    data[..., :4, :3] = [1.0, 1.0, 0.02]
    data[..., 4:, :3] = [1.0, 0.02, 1.0]
    data[..., 3] = np.linspace(0.0, sxy_max, 4)[:, None, None]
    write_vol(path, data)


def write_colored_sphere_ply(path: str, nu: int, nv: int) -> int:
    """The unit UV sphere of ``bench_scenes.uv_sphere_grid`` as a binary
    little-endian PLY with float32 positions and normals and uchar vertex
    colours (a smooth function of the position). Returns the triangle
    count."""
    verts, tris = uv_sphere_grid(nu, nv)
    names = ("x", "y", "z", "nx", "ny", "nz")
    vert = np.empty(len(verts), [(c, "<f4") for c in names]
                    + [(c, "u1") for c in ("red", "green", "blue")])
    for k, c in enumerate("xyz"):
        vert[c] = vert["n" + c] = verts[:, k]
    col = 0.5 + 0.5 * np.stack([np.sin(3 * verts[:, 0] + 1),
                                np.cos(4 * verts[:, 1]),
                                np.sin(5 * verts[:, 2] - verts[:, 0])], -1)
    for k, c in enumerate(("red", "green", "blue")):
        vert[c] = np.round(col[:, k] * 255).astype(np.uint8)
    face = np.empty(len(tris), [("n", "u1"), ("idx", "<i4", (3,))])
    face["n"] = 3
    face["idx"] = tris
    head = ("ply\nformat binary_little_endian 1.0\n"
            f"element vertex {len(verts)}\n"
            + "".join(f"property float {c}\n" for c in names)
            + "".join(f"property uchar {c}\n"
                      for c in ("red", "green", "blue"))
            + f"element face {len(tris)}\n"
            "property list uchar int vertex_indices\nend_header\n")
    with open(path, "wb") as f:
        f.write(head.encode("ascii") + vert.tobytes() + face.tobytes())
    return len(tris)


def write_light_grid_ply(path: str, n: int) -> int:
    """A flat n x n grid over [-1, 1]^2 in the xz plane, ``2 n^2``
    triangles wound so that their normals point down (-y), with uvs, as a
    binary little-endian PLY. Returns the triangle count."""
    g = np.linspace(-1.0, 1.0, n + 1)
    zz, xx = np.meshgrid(g, g, indexing="ij")
    vert = np.empty((n + 1) ** 2, [(c, "<f4") for c in ("x", "y", "z",
                                                         "u", "v")])
    vert["x"] = xx.ravel()
    vert["y"] = 0.0
    vert["z"] = zz.ravel()
    vert["u"] = 0.5 * (xx.ravel() + 1.0)
    vert["v"] = 0.5 * (zz.ravel() + 1.0)
    j, i = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    a, b = j * (n + 1) + i, j * (n + 1) + i + 1
    c, d = a + n + 1, b + n + 1
    # (a, b, d): e1 along +x, e2 along +z, e1 x e2 along -y
    tris = np.stack([np.stack([a, b, d], -1), np.stack([a, d, c], -1)],
                    2).reshape(-1, 3)
    face = np.empty(len(tris), [("n", "u1"), ("idx", "<i4", (3,))])
    face["n"] = 3
    face["idx"] = tris
    head = ("ply\nformat binary_little_endian 1.0\n"
            f"element vertex {len(vert)}\n"
            + "".join(f"property float {c}\n" for c in "xyzuv")
            + f"element face {len(tris)}\n"
            "property list uchar int vertex_indices\nend_header\n")
    with open(path, "wb") as f:
        f.write(head.encode("ascii") + vert.tobytes() + face.tobytes())
    return len(tris)


def _rgb(v):
    return {"type": "rgb", "value": v}


def _camera(tf, spp, res, shutter=True):
    sensor = {"type": "perspective", "fov": 45,
              "to_world": tf.look_at([0, 0.5, -4], [0, 0, 0], [0, 1, 0]),
              "film": {"type": "hdrfilm", "width": res, "height": res},
              "sampler": {"type": "correlated", "sample_count": spp,
                          "time_correlate_number": 2,
                          "path_correlate_number": 2}}
    if shutter:
        sensor.update(shutter_open=0.0, shutter_close=0.0015)
    return sensor


_DOPPLER = {"type": "dopplertofpath", "max_depth": 4, "time": 0.0015,
            "w_g": 30.0, "hetero_frequency": 1.0,
            "time_sampling_method": "antithetic",
            "path_correlation_depth": 4}


def surface_scene(assets: dict, spp: int, res: int = 256, tf=None,
                  anim_cls=None) -> dict:
    """The normal-mapped wall, the bump-mapped roughplastic floor, the
    volume-textured panel, the checkerboard rectangle light and the
    bitmap sphere light (``assets`` from ``write_surface_assets``). The
    panel and the sphere light move during the 1.5 ms shutter: a Doppler
    image of a scene at rest is close to zero."""
    tf = tf or _tf
    anim_cls = anim_cls or _AnimatedTransform

    def moving(a, b, m):
        return anim_cls([(0.0, tf.translate(a) @ m),
                         (0.0015, tf.translate(b) @ m)])
    return {
        "type": "scene",
        "wall": {"type": "rectangle",
                 "to_world": tf.translate([0, 0.3, 2.0])
                 @ tf.rotate([0, 1, 0], 180) @ tf.scale([2.5, 1.6, 1]),
                 "bsdf": {"type": "normalmap",
                          "normalmap": {"type": "bitmap", "raw": True,
                                        "filename": assets["normal"]},
                          "bsdf": {"type": "diffuse",
                                   "reflectance": _rgb([0.7, 0.6, 0.5])}}},
        "floor": {"type": "rectangle",
                  "to_world": tf.translate([0, -1.2, 0.5])
                  @ tf.rotate([1, 0, 0], -90) @ tf.scale([3, 3, 1]),
                  "bsdf": {"type": "bumpmap", "scale": 0.02,
                           "height": {"type": "bitmap", "raw": True,
                                      "filename": assets["height"],
                                      "to_uv": tf.scale([3, 3, 1])},
                           "bsdf": {"type": "roughplastic",
                                    "alpha": 0.15,
                                    "diffuse_reflectance": _rgb(
                                        [0.3, 0.45, 0.6])}}},
        "panel": {"type": "rectangle",
                  "to_world": moving([-1.2, -0.3, 0.8], [-1.0, -0.3, 0.8],
                                     tf.rotate([0, 1, 0], 150)
                                     @ tf.scale([0.6, 0.8, 1])),
                  "bsdf": {"type": "twosided", "bsdf": {
                      "type": "diffuse",
                      "reflectance": {
                          "type": "volume",
                          "volume": {"type": "gridvolume",
                                     "filename": assets["tint"],
                                     "to_world": tf.translate(
                                         [-1.8, -1.2, 0.1])
                                     @ tf.scale([1.4, 1.8, 1.4])}}}}},
        "panel_light": {"type": "rectangle",
                        "to_world": tf.translate([1.2, 1.4, 0.6])
                        @ tf.rotate([1, 0, 0], 90)
                        @ tf.scale([0.5, 0.4, 1]),
                        "emitter": {"type": "area", "radiance": {
                            "type": "checkerboard",
                            "color0": _rgb([14.0, 12.0, 9.0]),
                            "color1": _rgb([3.0, 4.0, 6.0]),
                            "to_uv": tf.scale([4, 4, 1])}}},
        "lamp": {"type": "sphere",
                 "to_world": moving([-0.8, 1.1, 0.2], [-0.4, 1.1, 0.2],
                                    tf.rotate([1, 0, 0], 60)
                                    @ tf.scale([0.3] * 3)),
                 "emitter": {"type": "area", "radiance": {
                     "type": "bitmap", "raw": True,
                     "filename": assets["glow"]}}},
        "sensor": _camera(tf, spp, res),
        "integrator": dict(_DOPPLER),
    }


def mesh_light_scene(sphere_ply: str, light_ply: str, glow: str, spp: int,
                     res: int = 256, tf=None, anim_cls=None) -> dict:
    """The animated mesh scene of ``bench_scenes`` (its camera, shutter,
    correlated sampler, floor, point light and dopplertofpath) with its
    sphere read from ``sphere_ply`` (``write_colored_sphere_ply``) and
    shaded by its vertex colours, and the grid of ``light_ply``
    (``write_light_grid_ply``) above it as an area light with the bitmap
    ``glow`` as radiance."""
    tf = tf or _tf
    base = animated_mesh_scene(sphere_ply, spp, res, tf, anim_cls)
    return {
        **base,
        "mesh": {"type": "ply", "filename": sphere_ply,
                 "to_world": base["mesh"]["to_world"],
                 "bsdf": {"type": "diffuse", "reflectance": {
                     "type": "mesh_attribute", "name": "vertex_color"}}},
        "ceiling_light": {"type": "ply", "filename": light_ply,
                          "to_world": tf.translate([0, 1.6, 0.3])
                          @ tf.scale([1.2, 1, 1.2]),
                          "emitter": {"type": "area", "radiance": {
                              "type": "bitmap", "raw": True,
                              "filename": glow}}},
    }


# the four phases of the media scene, by box
PHASES = ("rayleigh", "blendphase", "tabphase", "sggx")


def media_scene(sggx_vol: str, spp: int, res: int = 256, tf=None) -> dict:
    """Four null-bounded boxes in a row, each holding a homogeneous medium
    (sigma_t 2.5, albedo 0.85) with one of ``PHASES``: Rayleigh; a blend
    (weight 0.3) of HG g = 0.6 and HG g = -0.3; a forward-peaked table of
    six values; SGGX with the S grid ``sggx_vol`` (``write_sggx_vol``)
    mapped onto its box. A floor, a point light and a rectangle area
    light; ``volpath`` with max_depth 6, an independent sampler."""
    tf = tf or _tf
    xs = (-1.5, -0.5, 0.5, 1.5)
    phases = {
        "rayleigh": {"type": "rayleigh"},
        "blendphase": {"type": "blendphase", "weight": 0.3,
                       "phase1": {"type": "hg", "g": 0.6},
                       "phase2": {"type": "hg", "g": -0.3}},
        "tabphase": {"type": "tabphase",
                     "values": "0.2, 0.3, 0.5, 1.0, 2.5, 6.0"},
        "sggx": {"type": "sggx", "S": {
            "type": "gridvolume", "filename": sggx_vol,
            "to_world": tf.translate([xs[3] - 0.4, -0.4, -0.4])
            @ tf.scale([0.8] * 3)}},
    }
    scene = {
        "type": "scene",
        "integrator": {"type": "volpath", "max_depth": 6},
        "floor": {"type": "rectangle",
                  "to_world": tf.translate([0, -0.6, 0])
                  @ tf.rotate([1, 0, 0], -90) @ tf.scale([6, 6, 1])},
        "light": {"type": "point", "position": [0, 3, -3],
                  "intensity": _rgb(30.0)},
        "top": {"type": "rectangle",
                "to_world": tf.translate([0, 2.5, 0.5])
                @ tf.rotate([1, 0, 0], 90) @ tf.scale([2, 0.5, 1]),
                "emitter": {"type": "area", "radiance": _rgb(6.0)}},
        "sensor": {"type": "perspective", "fov": 45,
                   "to_world": tf.look_at([0, 0.8, -4], [0, 0, 0],
                                          [0, 1, 0]),
                   "film": {"type": "hdrfilm", "width": res, "height": res},
                   "sampler": {"type": "independent", "sample_count": spp}},
    }
    for x, name in zip(xs, PHASES):
        scene[f"box_{name}"] = {
            "type": "cube", "bsdf": {"type": "null"},
            "to_world": tf.translate([x, 0.0, 0.0]) @ tf.scale([0.4] * 3),
            "interior": {"type": "homogeneous", "sigma_t": _rgb(2.5),
                         "albedo": _rgb(0.85), "phase": phases[name]}}
    return scene


__all__ = ["write_vol", "write_surface_assets", "write_sggx_vol",
           "write_colored_sphere_ply", "write_light_grid_ply",
           "surface_scene", "mesh_light_scene", "media_scene", "PHASES"]
