"""Hero validation scene (the port's copy of the JAX package's
``utils/hero_scene.py``): a cornell-box-class scene with everything the
renderer must handle at once — a 10k+-triangle procedural mesh, bitmap +
checkerboard textures, an environment emitter, a heterogeneous medium, and
TWO animated instances under the Doppler integrator.

Medium note: `dopplertofpath` is surface-only in the reference too (its
sample() takes `const Medium*` unused, dopplertofpath.cpp:82) — under the
default integrator the smoke exercises the loader/volume/null-boundary
paths only. Pass ``integrator={"type": "volpath", ...}`` for radiometric
medium transport (the reference's animation pipeline renders its radiance
pairs exactly this way).

The reference validates per-scene against bundled assets
(doppler_tutorials/src/utils/common_configs.py — cornell-box,
living-room-2, kitchen, ...) that are not shipped in the snapshot; this
procedurally-authored scene is the rebuild's equivalent weight-class
validation target. Everything is generated deterministically on first use
under ``cache_dir`` (default ``~/.cache/mitsuba3dopplertof_tpu_torch/hero``;
the EXRs written by the port's ``write_exr_rgb``, ZIP-compressed) so
goldens are reproducible.
"""

from __future__ import annotations

import os

import numpy as np

_CACHE = os.path.join(os.path.expanduser("~"), ".cache",
                      "mitsuba3dopplertof_tpu_torch", "hero")


def _knot_obj(path: str, nu: int = 96, nv: int = 56, p: int = 2,
              q: int = 3, radius: float = 0.30, tube: float = 0.115):
    """(p,q) torus-knot tube mesh, 2*nu*nv triangles (10,752 by default)."""
    t = np.linspace(0.0, 2 * np.pi, nu, endpoint=False)
    r = 0.40 * np.cos(q * t) + 1.0
    cx = radius * r * np.cos(p * t)
    cy = radius * r * np.sin(p * t)
    cz = radius * 0.55 * np.sin(q * t)
    c = np.stack([cx, cy, cz], -1)                       # (nu, 3)
    tang = np.roll(c, -1, axis=0) - np.roll(c, 1, axis=0)
    tang /= np.linalg.norm(tang, axis=-1, keepdims=True)
    up = np.array([0.0, 0.0, 1.0])
    n1 = np.cross(tang, up)
    n1 /= np.maximum(np.linalg.norm(n1, axis=-1, keepdims=True), 1e-9)
    n2 = np.cross(tang, n1)
    ph = np.linspace(0.0, 2 * np.pi, nv, endpoint=False)
    ring = (np.cos(ph)[None, :, None] * n1[:, None, :]
            + np.sin(ph)[None, :, None] * n2[:, None, :])   # (nu, nv, 3)
    verts = (c[:, None, :] + tube * ring).reshape(-1, 3)

    lines = [f"v {x:.6f} {y:.6f} {z:.6f}" for x, y, z in verts]

    def vid(i, j):
        return (i % nu) * nv + (j % nv) + 1
    for i in range(nu):
        for j in range(nv):
            a, b = vid(i, j), vid(i + 1, j)
            cc, d = vid(i + 1, j + 1), vid(i, j + 1)
            lines.append(f"f {a} {b} {cc}")
            lines.append(f"f {a} {cc} {d}")
    with open(path, "w") as f:
        f.write("\n".join(lines))
    return 2 * nu * nv


def _icosphere_obj(path: str, nu: int = 24, nv: int = 18):
    from math import pi, sin, cos
    lines = []
    for j in range(nv + 1):
        for i in range(nu):
            th, phn = pi * j / nv, 2 * pi * i / nu
            lines.append(f"v {sin(th)*cos(phn):.6f} {cos(th):.6f} "
                         f"{sin(th)*sin(phn):.6f}")

    def vid(i, j):
        return j * nu + (i % nu) + 1
    for j in range(nv):
        for i in range(nu):
            a, b = vid(i, j), vid(i + 1, j)
            c, d = vid(i + 1, j + 1), vid(i, j + 1)
            lines.append(f"f {a} {b} {c}")
            lines.append(f"f {a} {c} {d}")
    with open(path, "w") as f:
        f.write("\n".join(lines))
    return 2 * nu * nv


def _marble_exr(path: str, n: int = 128):
    """Procedural marble-ish albedo texture (deterministic)."""
    from ..io.bitmap import write_exr_rgb
    y, x = np.mgrid[0:n, 0:n] / n
    v = np.sin(8.0 * x + 3.0 * np.sin(5.0 * y)) * 0.5 + 0.5
    rgb = np.stack([0.25 + 0.55 * v, 0.30 + 0.40 * v,
                    0.45 + 0.25 * (1 - v)], -1).astype(np.float32)
    write_exr_rgb(path, rgb)


def _sky_exr(path: str, w: int = 128, h: int = 64):
    """Procedural gradient sky with a bright blob (env emitter)."""
    from ..io.bitmap import write_exr_rgb
    y, x = np.mgrid[0:h, 0:w]
    th = (y + 0.5) / h * np.pi
    ph = (x + 0.5) / w * 2 * np.pi
    base = np.maximum(np.cos(th), 0.0)[..., None] * \
        np.array([0.35, 0.45, 0.75]) + np.array([0.05, 0.06, 0.10])
    blob = 4.0 * np.exp(-12.0 * ((th - 0.8) ** 2 + (ph - 4.0) ** 2))
    rgb = (base + blob[..., None] * np.array([1.0, 0.9, 0.7]))
    write_exr_rgb(path, rgb.astype(np.float32))


def _smoke_vol(path: str, n: int = 24):
    """Deterministic swirl-density grid volume (binary .vol)."""
    z, y, x = np.mgrid[0:n, 0:n, 0:n] / (n - 1.0)
    r = np.sqrt((x - 0.5) ** 2 + (y - 0.5) ** 2)
    d = np.exp(-14.0 * (r - 0.22 * (1.0 + 0.6 * np.sin(6.0 * z))) ** 2)
    d *= np.exp(-2.0 * z) * (0.5 + 0.5 * np.cos(9.0 * x * y))
    data = np.ascontiguousarray(d.astype(np.float32))
    import struct as _st
    with open(path, "wb") as f:
        f.write(b"VOL")
        f.write(_st.pack("<B", 3))
        f.write(_st.pack("<i", 1))            # float32
        f.write(_st.pack("<iii", n, n, n))
        f.write(_st.pack("<i", 1))            # channels
        f.write(_st.pack("<6f", 0, 0, 0, 1, 1, 1))
        f.write(data.tobytes())


def hero_assets(cache_dir: str = None):
    """Generate (once) and return the asset paths."""
    d = cache_dir or _CACHE
    os.makedirs(d, exist_ok=True)
    paths = {
        "knot": os.path.join(d, "knot.obj"),
        "sphere": os.path.join(d, "sphere.obj"),
        "marble": os.path.join(d, "marble.exr"),
        "sky": os.path.join(d, "sky.exr"),
        "smoke": os.path.join(d, "smoke.vol"),
    }
    if not os.path.exists(paths["knot"]):
        _knot_obj(paths["knot"])
    if not os.path.exists(paths["sphere"]):
        _icosphere_obj(paths["sphere"])
    if not os.path.exists(paths["marble"]):
        _marble_exr(paths["marble"])
    if not os.path.exists(paths["sky"]):
        _sky_exr(paths["sky"])
    if not os.path.exists(paths["smoke"]):
        _smoke_vol(paths["smoke"])
    return paths


def hero_scene_dict(spp: int = 64, res: int = 256, max_depth: int = 6,
                    w_g: float = 30.0, hetero_frequency: float = 1.0,
                    sensor_phase_offset: float = 0.0,
                    time_sampling_method: str = "antithetic",
                    path_correlation_depth: int = 2,
                    integrator: dict = None, cache_dir: str = None,
                    exposure: float = 0.0015):
    """The hero scene as a load_dict dictionary.

    Contents: cornell box (textured back wall, checkerboard floor), a
    10.7k-tri torus knot (roughplastic) ANIMATED sideways, a 864-tri
    mirror sphere mesh ANIMATED upward, a heterogeneous smoke column, an
    area ceiling light plus a dim environment map through the open front,
    dopplertofpath + correlated sampler."""
    from ..core import transform as tf
    from ..core.transform import AnimatedTransform

    a = hero_assets(cache_dir)
    T = exposure
    if integrator is None:
        integrator = {
            "type": "dopplertofpath", "max_depth": max_depth, "time": T,
            "w_g": w_g, "hetero_frequency": hetero_frequency,
            "sensor_phase_offset": sensor_phase_offset,
            "time_sampling_method": time_sampling_method,
            "path_correlation_depth": path_correlation_depth,
        }

    def wall(to_world, bsdf):
        return {"type": "rectangle", "to_world": to_world, "bsdf": bsdf}

    white = {"type": "twosided",
             "bsdf": {"type": "diffuse", "reflectance": 0.73}}
    return {
        "type": "scene",
        "integrator": integrator,
        "sensor": {
            "type": "perspective", "fov": 42,
            "shutter_open": 0.0, "shutter_close": T,
            "to_world": tf.look_at([0, 1.0, -3.6], [0, 1.0, 0], [0, 1, 0]),
            "film": {"type": "hdrfilm", "width": res, "height": res,
                     "rfilter": {"type": "tent"}},
            "sampler": {"type": "correlated", "sample_count": spp,
                        "time_correlate_number": 2,
                        "path_correlate_number": 2},
        },
        # cornell box: floor/ceiling/back/left/right (front open -> env)
        "floor": wall(tf.translate([0, 0, 0]) @ tf.rotate([1, 0, 0], -90)
                      @ tf.scale([2, 2, 1]),
                      {"type": "twosided", "bsdf": {
                          "type": "diffuse", "reflectance": {
                              "type": "checkerboard",
                              "color0": {"type": "rgb",
                                         "value": [0.325, 0.31, 0.25]},
                              "color1": {"type": "rgb",
                                         "value": [0.725, 0.71, 0.68]},
                              "to_uv": tf.scale([6, 6, 1])}}}),
        "ceiling": wall(tf.translate([0, 2, 0]) @ tf.rotate([1, 0, 0], 90)
                        @ tf.scale([2, 2, 1]), white),
        "back": wall(tf.translate([0, 1, 2]) @ tf.rotate([1, 0, 0], 180)
                     @ tf.scale([2, 1, 1]),
                     {"type": "twosided", "bsdf": {
                         "type": "diffuse", "reflectance": {
                             "type": "bitmap", "filename": a["marble"]}}}),
        "left": wall(tf.translate([-2, 1, 0]) @ tf.rotate([0, 1, 0], 90)
                     @ tf.scale([2, 1, 1]),
                     {"type": "twosided", "bsdf": {
                         "type": "diffuse",
                         "reflectance": {"type": "rgb",
                                         "value": [0.61, 0.0625, 0.0625]}}}),
        "right": wall(tf.translate([2, 1, 0]) @ tf.rotate([0, 1, 0], -90)
                      @ tf.scale([2, 1, 1]),
                      {"type": "twosided", "bsdf": {
                          "type": "diffuse",
                          "reflectance": {"type": "rgb",
                                          "value": [0.105, 0.37, 0.076]}}}),
        # animated 10.7k-tri knot, rough plastic
        "knot": {"type": "obj", "filename": a["knot"],
                 "bsdf": {"type": "roughplastic", "alpha": 0.08,
                          "diffuse_reflectance": {
                              "type": "rgb", "value": [0.2, 0.25, 0.7]}},
                 "to_world": AnimatedTransform([
                     (0.0, tf.translate([-0.55, 0.75, 0.45])
                      @ tf.rotate([0, 1, 0], 30) @ tf.scale([1.1] * 3)),
                     (T, tf.translate([-0.25, 0.75, 0.45])
                      @ tf.rotate([0, 1, 0], 30) @ tf.scale([1.1] * 3))])},
        # animated mirror sphere mesh
        "ball": {"type": "obj", "filename": a["sphere"],
                 "bsdf": {"type": "conductor"},
                 "to_world": AnimatedTransform([
                     (0.0, tf.translate([0.95, 0.42, 0.3])
                      @ tf.scale([0.42] * 3)),
                     (T, tf.translate([0.95, 0.60, 0.3])
                      @ tf.scale([0.42] * 3))])},
        # heterogeneous smoke column (null boundary)
        "smoke": {"type": "cube", "bsdf": {"type": "null"},
                  "to_world": tf.translate([0.8, 0.7, -0.9])
                  @ tf.scale([0.35, 0.7, 0.35]),
                  "interior": {"type": "heterogeneous",
                               "sigma_t": {"type": "gridvolume",
                                           "filename": a["smoke"],
                                           "to_world":
                                           tf.translate([-1, -1, -1])
                                           @ tf.scale([2, 2, 2])},
                               "albedo": 0.8, "scale": 6.0}},
        # lights: area panel + env through the open front
        "lamp": {"type": "rectangle",
                 "to_world": tf.translate([0, 1.995, 0])
                 @ tf.rotate([1, 0, 0], 90) @ tf.scale([0.55, 0.55, 1]),
                 "emitter": {"type": "area",
                             "radiance": {"type": "rgb",
                                          "value": [14.0, 11.5, 8.0]}}},
        "env": {"type": "envmap", "filename": a["sky"], "scale": 0.35},
    }


def load_hero_scene(device=None, **kw):
    """The hero scene loaded by the port, on ``device`` (default: the
    package device)."""
    import mitsuba3dopplertof_tpu_torch as mi
    return mi.load_dict(hero_scene_dict(**kw), device=device)


__all__ = ["hero_scene_dict", "load_hero_scene", "hero_assets"]
