"""The benchmark scenes of the JAX package's ``scripts/bench_suite.py`` as
scene dicts for ``load_dict``: an animated UV-sphere mesh (2k, 10k, 40k or
100k triangles) under a point light, rendered with ``dopplertofpath`` and
a correlated sampler; a static 50k-triangle mesh rendered with ``path``;
the deep-path row, a sphere light in a diffuse box; and the volpath row, a
homogeneous medium in a cube. The OBJ writer is
the port's own copy of ``uvsphere_obj``; the PLY writer writes the same
sphere.

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


def uv_sphere_grid(nu: int, nv: int) -> tuple[np.ndarray, np.ndarray]:
    """The unit UV sphere's ``(nv + 1) nu`` vertices (float64, row ``j``
    at polar angle ``pi j / nv``) and its ``2 nu nv`` triangles (0-based;
    the pole rows give zero-area triangles)."""
    j, i = np.meshgrid(np.arange(nv + 1), np.arange(nu), indexing="ij")
    th, ph = np.pi * j / nv, 2 * np.pi * i / nu
    verts = np.stack([np.sin(th) * np.cos(ph), np.cos(th),
                      np.sin(th) * np.sin(ph)], -1).reshape(-1, 3)
    j, i = np.meshgrid(np.arange(nv), np.arange(nu), indexing="ij")
    a, b = j * nu + i, j * nu + (i + 1) % nu
    c, d = (j + 1) * nu + (i + 1) % nu, (j + 1) * nu + i
    tris = np.stack([np.stack([a, b, c], -1), np.stack([a, c, d], -1)],
                    2).reshape(-1, 3)
    return verts, tris


def write_uv_sphere_obj(path: str, nu: int, nv: int) -> int:
    """Write the unit UV sphere of ``2 nu nv`` triangles as an OBJ file
    (vertices to 6 decimals). Returns the triangle count."""
    verts, tris = uv_sphere_grid(nu, nv)
    lines = [f"v {x:.6f} {y:.6f} {z:.6f}" for x, y, z in verts]
    lines += [f"f {a} {b} {c}" for a, b, c in tris + 1]
    with open(path, "w") as f:
        f.write("\n".join(lines))
    return len(tris)


def write_uv_sphere_ply(path: str, nu: int, nv: int) -> int:
    """Write the unit UV sphere of ``2 nu nv`` triangles as a binary
    little-endian PLY file: float32 positions and normals (the normal of a
    unit sphere's vertex is its position), uchar/int face lists. Returns
    the triangle count."""
    verts, tris = uv_sphere_grid(nu, nv)
    names = ("x", "y", "z", "nx", "ny", "nz")
    vert = np.empty(len(verts), [(c, "<f4") for c in names])
    for k, c in enumerate("xyz"):
        vert[c] = vert["n" + c] = verts[:, k]
    face = np.empty(len(tris), [("n", "u1"), ("idx", "<i4", (3,))])
    face["n"] = 3
    face["idx"] = tris
    head = ("ply\nformat binary_little_endian 1.0\n"
            f"element vertex {len(verts)}\n"
            + "".join(f"property float {c}\n" for c in names)
            + f"element face {len(tris)}\n"
            "property list uchar int vertex_indices\nend_header\n")
    with open(path, "wb") as f:
        f.write(head.encode("ascii") + vert.tobytes() + face.tobytes())
    return len(tris)


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


def deep_path_scene(spp: int, res: int = 256, tf=None) -> dict:
    """bench_suite ``deep_path_scene`` as written: a 3x-scaled two-sided
    diffuse cube (12 triangles) lit from inside by a sphere of radius 0.4
    carrying an area light of radiance 12, ``path`` with max_depth 48 and
    rr_depth 5, an independent sampler."""
    tf = tf or _tf
    return {
        "type": "scene",
        "integrator": {"type": "path", "max_depth": 48, "rr_depth": 5},
        "box": {"type": "cube", "to_world": tf.scale([3.0] * 3),
                "bsdf": {"type": "twosided",
                         "nested": {"type": "diffuse",
                                    "reflectance": {"type": "rgb",
                                                    "value": 0.6}}}},
        "light": {"type": "sphere", "radius": 0.4,
                  "to_world": tf.translate([0, 2.2, 0]),
                  "emitter": {"type": "area",
                              "radiance": {"type": "rgb", "value": 12.0}}},
        "sensor": {"type": "perspective", "fov": 60,
                   "to_world": tf.look_at([0, 0, -2.6], [0, 0, 0],
                                          [0, 1, 0]),
                   "film": {"type": "hdrfilm", "width": res, "height": res},
                   "sampler": {"type": "independent", "sample_count": spp}},
    }


def volpath_scene(spp: int, res: int = 256, tf=None) -> dict:
    """bench_suite ``volpath_scene`` as written: a 1.2-scaled cube with a
    null BSDF holding a homogeneous medium (sigma_t 1.5, albedo 0.8) over
    a floor, lit by a point light, ``volpath`` with max_depth 6, an
    independent sampler."""
    tf = tf or _tf
    return {
        "type": "scene",
        "integrator": {"type": "volpath", "max_depth": 6},
        "medium_box": {"type": "cube",
                       "to_world": tf.scale([1.2] * 3),
                       "bsdf": {"type": "null"},
                       "interior": {"type": "homogeneous",
                                    "sigma_t": {"type": "rgb", "value": 1.5},
                                    "albedo": {"type": "rgb", "value": 0.8}}},
        "floor": {"type": "rectangle",
                  "to_world": tf.translate([0, -1.5, 0])
                  @ tf.rotate([1, 0, 0], -90) @ tf.scale([6, 6, 1])},
        "light": {"type": "point", "position": [0, 4, -4],
                  "intensity": {"type": "rgb", "value": 40.0}},
        "sensor": {"type": "perspective", "fov": 45,
                   "to_world": tf.look_at([0, 0.5, -4], [0, 0, 0],
                                          [0, 1, 0]),
                   "film": {"type": "hdrfilm", "width": res, "height": res},
                   "sampler": {"type": "independent", "sample_count": spp}},
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


__all__ = ["uv_sphere_grid", "write_uv_sphere_obj", "write_uv_sphere_ply",
           "animated_mesh_scene", "static_mesh_scene", "deep_path_scene",
           "ANIMATED_SIZES", "STATIC_SIZE"]
