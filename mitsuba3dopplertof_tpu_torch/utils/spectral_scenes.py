"""Scenes for the spectral and mono variants, built here (not published
scenes), with the maps they read written by numpy and the port's own EXR
writer:

- ``spectral_surface_scene``: a floor whose diffuse reflectance is a
  bitmap, a sphere of the named conductor ``Au`` (its eta / k spectra), a
  sphere of roughplastic and one of plastic, and a null-bounded cube of
  coloured homogeneous medium, lit by a small envmap sky (per-texel
  emission spectra) and a rectangle area light; ``path`` (which passes
  through the cube) or ``volpath``, an independent sampler (14 triangles
  and 3 spheres: kernel B1);
- ``specfilm_film``: a ``specfilm`` with three ``regular`` sensor
  response functions, one channel each.

    assets = write_spectral_assets(tmp_dir)
    mi.set_variant("cuda_spectral")
    scene = mi.load_dict(spectral_surface_scene(assets, spp=64, res=256))

``tf``: the transform module of the package that loads the dict (default:
the port's).
"""

from __future__ import annotations

import os

import numpy as np

from ..core import transform as _tf
from .textured_scenes import _smooth_noise, _write_rgb_exr


def _rgb(v):
    return {"type": "rgb", "value": v}


def write_spectral_assets(directory: str, seed: int = 11,
                          sky_size=(16, 8), albedo_size=(32, 32)) -> dict:
    """Write the spectral surface scene's maps into ``directory``, made
    from ``seed``: a ``sky_size`` (width, height) sky, blue above and warm
    at the horizon, and an ``albedo_size`` colourful reflectance map.
    Returns their paths by name."""
    os.makedirs(directory, exist_ok=True)
    rng = np.random.default_rng(seed)
    paths = {"sky": os.path.join(directory, "sky.exr"),
             "albedo": os.path.join(directory, "albedo.exr")}
    w, h = sky_size
    v = (np.arange(h) + 0.5) / h
    up = np.clip(1.0 - 2.0 * v, 0.0, 1.0)[:, None, None]
    sky = (up * np.array([0.35, 0.55, 1.1])
           + (1.0 - up) * np.array([1.2, 0.8, 0.45]))
    sky = sky * (0.8 + 0.4 * _smooth_noise(rng, h, w, ((3, 1.0),)))[
        ..., None]
    _write_rgb_exr(paths["sky"], sky.astype(np.float32))
    aw, ah = albedo_size
    alb = np.stack([_smooth_noise(rng, ah, aw) for _ in range(3)], -1)
    _write_rgb_exr(paths["albedo"], (0.1 + 0.8 * alb).astype(np.float32))
    return paths


def specfilm_film(res: int, peaks=(450.0, 550.0, 650.0)) -> dict:
    """A ``specfilm`` with one triangular ``regular`` SRF 100 nm wide
    around each of ``peaks`` (keys ``srf_0``, ``srf_1``, ...), a box
    filter."""
    film = {"type": "specfilm", "width": res, "height": res,
            "rfilter": {"type": "box"}}
    for k, c in enumerate(peaks):
        film[f"srf_{k}"] = {"type": "regular",
                            "lambda_min": c - 50.0,
                            "lambda_max": c + 50.0,
                            "values": "0, 0.5, 1, 0.5, 0"}
    return film


def spectral_surface_scene(assets: dict, spp: int, res: int = 256, tf=None,
                           integrator=None) -> dict:
    """The textured floor, the gold, roughplastic and plastic spheres,
    the medium cube, the sky and the rectangle light (``assets`` from
    ``write_spectral_assets``)."""
    tf = tf or _tf
    return {
        "type": "scene",
        "integrator": integrator or {"type": "path", "max_depth": 4},
        "floor": {"type": "rectangle",
                  "to_world": tf.translate([0, -1.0, 0.5])
                  @ tf.rotate([1, 0, 0], -90) @ tf.scale([3, 3, 1]),
                  "bsdf": {"type": "diffuse",
                           "reflectance": {"type": "bitmap",
                                           "filename": assets["albedo"],
                                           "to_uv": tf.scale([2, 2, 1])}}},
        "gold": {"type": "sphere", "center": [-0.9, -0.45, 0.6],
                 "radius": 0.55,
                 "bsdf": {"type": "conductor", "material": "Au"}},
        "rough": {"type": "sphere", "center": [0.15, -0.5, 0.9],
                  "radius": 0.5,
                  "bsdf": {"type": "roughplastic", "alpha": 0.2,
                           "diffuse_reflectance": _rgb([0.2, 0.5, 0.25])}},
        "smooth": {"type": "sphere", "center": [1.05, -0.6, 0.3],
                   "radius": 0.4,
                   "bsdf": {"type": "plastic",
                            "diffuse_reflectance": _rgb([0.7, 0.15, 0.1])}},
        "fog": {"type": "cube",
                "to_world": tf.translate([0.9, 0.2, 1.4])
                @ tf.rotate([0, 1, 0], 30) @ tf.scale([0.45, 0.5, 0.45]),
                "bsdf": {"type": "null"},
                "interior": {"type": "homogeneous",
                             "sigma_t": _rgb([1.8, 1.2, 0.6]),
                             "albedo": _rgb([0.9, 0.6, 0.3])}},
        "light": {"type": "rectangle",
                  "to_world": tf.translate([0.4, 1.6, 0.2])
                  @ tf.rotate([1, 0, 0], 90) @ tf.scale([0.6, 0.4, 1]),
                  "emitter": {"type": "area",
                              "radiance": _rgb([9.0, 7.5, 5.0])}},
        "sky": {"type": "envmap", "filename": assets["sky"], "scale": 0.6},
        "sensor": {"type": "perspective", "fov": 50,
                   "to_world": tf.look_at([0, 0.4, -3.2], [0, -0.3, 0.5],
                                          [0, 1, 0]),
                   "film": {"type": "hdrfilm", "width": res, "height": res,
                            "rfilter": {"type": "box"}},
                   "sampler": {"type": "independent", "sample_count": spp}},
    }


__all__ = ["write_spectral_assets", "specfilm_film",
           "spectral_surface_scene"]
