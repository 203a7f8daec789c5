"""The large-scene benchmark scenes of the JAX package's
``scripts/bench_suite.py`` as scene dicts for ``load_dict``: an animated
UV-sphere mesh (2k, 10k, 40k or 100k triangles) under a point light,
rendered with ``dopplertofpath`` and a correlated sampler, and a static
50k-triangle mesh rendered with ``path``. The OBJ writer is the port's own
copy of ``uvsphere_obj``.

    path = "sphere_144x140.obj"
    write_uv_sphere_obj(path, 144, 140)        # 40,320 triangles
    scene = mi.load_dict(animated_mesh_scene(path, spp=256))
"""

from __future__ import annotations

import numpy as np

from ..core import transform as _tf
from ..core.transform import AnimatedTransform as _AnimatedTransform

# (nu, nv) of bench_suite's animated scenes, by their label
ANIMATED_SIZES = {"2k": (32, 32), "10k": (72, 70), "40k": (144, 140),
                  "100k": (360, 140)}
STATIC_SIZE = (160, 158)          # the static 50k scene


def write_uv_sphere_obj(path: str, nu: int, nv: int) -> int:
    """Write a unit UV sphere of ``2 nu nv`` triangles as an OBJ file
    (vertices to 6 decimals; the pole rows give zero-area triangles).
    Returns the triangle count."""
    lines = []
    for j in range(nv + 1):
        for i in range(nu):
            th, ph = np.pi * j / nv, 2 * np.pi * i / nu
            lines.append(f"v {np.sin(th)*np.cos(ph):.6f} {np.cos(th):.6f} "
                         f"{np.sin(th)*np.sin(ph):.6f}")

    def vid(i, j):
        return j * nu + (i % nu) + 1
    for j in range(nv):
        for i in range(nu):
            a, b, c, d = vid(i, j), vid(i + 1, j), vid(i + 1, j + 1), \
                vid(i, j + 1)
            lines.append(f"f {a} {b} {c}")
            lines.append(f"f {a} {c} {d}")
    with open(path, "w") as f:
        f.write("\n".join(lines))
    return 2 * nu * nv


def _floor_and_light(tf):
    return {
        "floor": {"type": "rectangle",
                  "to_world": tf.translate([0, -1.2, 0])
                  @ tf.rotate([1, 0, 0], -90) @ tf.scale([6, 6, 1])},
        "light": {"type": "point", "position": [0, 4, -4],
                  "intensity": {"type": "rgb", "value": 40.0}},
    }


def animated_mesh_scene(obj_path: str, spp: int, res: int = 256, tf=None,
                        anim_cls=None) -> dict:
    """bench_suite ``animated_mesh_scene``: the sphere moves 1.2 units
    along x during the 1.5 ms shutter. ``tf``/``anim_cls``: the transform
    module and AnimatedTransform class of the package that loads the dict
    (default: this package's)."""
    tf = tf or _tf
    anim_cls = anim_cls or _AnimatedTransform
    return {
        "type": "scene",
        "mesh": {"type": "obj", "filename": obj_path,
                 "to_world": anim_cls([
                     (0.0, tf.translate([-0.6, 0, 0])),
                     (0.0015, tf.translate([0.6, 0, 0]))])},
        **_floor_and_light(tf),
        "sensor": {"type": "perspective", "fov": 45,
                   "shutter_open": 0.0, "shutter_close": 0.0015,
                   "to_world": tf.look_at([0, 0.5, -4], [0, 0, 0],
                                          [0, 1, 0]),
                   "film": {"type": "hdrfilm", "width": res, "height": res},
                   "sampler": {"type": "correlated", "sample_count": spp,
                               "time_correlate_number": 2,
                               "path_correlate_number": 2}},
        "integrator": {"type": "dopplertofpath", "max_depth": 4,
                       "time": 0.0015, "w_g": 150.0,
                       "hetero_frequency": 1.0,
                       "time_sampling_method": "antithetic",
                       "path_correlation_depth": 2},
    }


def static_mesh_scene(obj_path: str, spp: int, res: int = 256,
                      tf=None) -> dict:
    """bench_suite ``static_mesh_scene``: the mesh at rest, ``path`` with
    an independent sampler."""
    tf = tf or _tf
    return {
        "type": "scene",
        "mesh": {"type": "obj", "filename": obj_path},
        **_floor_and_light(tf),
        "sensor": {"type": "perspective", "fov": 45,
                   "to_world": tf.look_at([0, 0.5, -4], [0, 0, 0],
                                          [0, 1, 0]),
                   "film": {"type": "hdrfilm", "width": res, "height": res},
                   "sampler": {"type": "independent", "sample_count": spp}},
        "integrator": {"type": "path", "max_depth": 4},
    }


__all__ = ["write_uv_sphere_obj", "animated_mesh_scene", "static_mesh_scene",
           "ANIMATED_SIZES", "STATIC_SIZE"]
