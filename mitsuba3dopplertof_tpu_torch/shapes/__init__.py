"""Shape plugins (port of the JAX package's ``shapes/__init__.py``: the
triangle-mesh base, rectangle, cube, OBJ meshes and the analytic sphere).

Every shape is an indexed triangle mesh in object space (or an analytic
unit sphere) plus a possibly animated to_world transform, so static and
animated shapes compile into the same tables. Reference plugins:
src/shapes/{rectangle,cube,obj,sphere}.cpp.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..core.properties import Properties, register_plugin
from ..core.transform import AnimatedTransform


class Mesh:
    """Host-side indexed triangle mesh (numpy, object space)."""

    def __init__(self, vertices: np.ndarray, faces: np.ndarray,
                 normals: Optional[np.ndarray] = None,
                 uvs: Optional[np.ndarray] = None):
        self.vertices = np.asarray(vertices, dtype=np.float64).reshape(-1, 3)
        self.faces = np.asarray(faces, dtype=np.int64).reshape(-1, 3)
        self.normals = (np.asarray(normals, dtype=np.float64).reshape(-1, 3)
                        if normals is not None else None)
        self.uvs = (np.asarray(uvs, dtype=np.float64).reshape(-1, 2)
                    if uvs is not None else None)

    @property
    def n_triangles(self) -> int:
        return self.faces.shape[0]

    def surface_areas(self, to_world: np.ndarray) -> np.ndarray:
        """Per-triangle world-space areas under an affine transform."""
        vw = self.vertices @ to_world[:3, :3].T + to_world[:3, 3]
        v0 = vw[self.faces[:, 0]]
        e1 = vw[self.faces[:, 1]] - v0
        e2 = vw[self.faces[:, 2]] - v0
        return 0.5 * np.linalg.norm(np.cross(e1, e2), axis=-1)


class Shape:
    """Base: a mesh + to_world (static or 2-keyframe animated) + refs."""

    def __init__(self, props: Properties):
        self.id = props.id
        self.to_world: AnimatedTransform = props.get_animated_transform(
            "to_world", AnimatedTransform())
        # reference shape.cpp flip_normals: negate geometric and shading
        # normals, applied per instance in render/scene.py build_si
        self.flip_normals = props.get_bool("flip_normals", False)
        self.bsdf = None
        self.emitter = None
        self.sensor = None        # an irradiance meter bound to this shape
        self.mesh: Optional[Mesh] = None
        from ..bsdfs import BSDF
        from ..emitters import Emitter
        from ..sensors import IrradianceMeter
        for key, v in props.objects():
            if isinstance(v, BSDF):
                self.bsdf = v
            elif isinstance(v, Emitter):
                self.emitter = v
                v.shape = self
            elif isinstance(v, IrradianceMeter):
                self.sensor = v
                v.shape = self
            else:
                raise NotImplementedError(
                    f"shape child '{key}' of kind {v.plugin_category} is not "
                    "ported yet (ROADMAP Queue A item 9)")


def make_rectangle() -> Mesh:
    """Unit rectangle [-1,1]^2 in the XY plane, normal +Z, uv in [0,1]^2
    (reference src/shapes/rectangle.cpp:104-121)."""
    v = np.array([[-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0]],
                 dtype=np.float64)
    uv = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], dtype=np.float64)
    f = np.array([[0, 1, 2], [2, 3, 0]])
    n = np.tile([[0.0, 0.0, 1.0]], (4, 1))
    return Mesh(v, f, n, uv)


def make_cube() -> Mesh:
    """[-1,1]^3 cube with the reference's 24-vertex layout
    (reference src/shapes/cube.cpp:114-140)."""
    v = np.array([
        [1, -1, -1], [1, -1, 1], [-1, -1, 1], [-1, -1, -1],
        [1, 1, -1], [-1, 1, -1], [-1, 1, 1], [1, 1, 1],
        [1, -1, -1], [1, 1, -1], [1, 1, 1], [1, -1, 1],
        [1, -1, 1], [1, 1, 1], [-1, 1, 1], [-1, -1, 1],
        [-1, -1, 1], [-1, 1, 1], [-1, 1, -1], [-1, -1, -1],
        [1, 1, -1], [1, -1, -1], [-1, -1, -1], [-1, 1, -1],
    ], dtype=np.float64)
    n = np.array(
        [[0, -1, 0]] * 4 + [[0, 1, 0]] * 4 + [[1, 0, 0]] * 4 +
        [[0, 0, 1]] * 4 + [[-1, 0, 0]] * 4 + [[0, 0, -1]] * 4,
        dtype=np.float64)
    uv = np.array([[0, 1], [1, 1], [1, 0], [0, 0]] * 6, dtype=np.float64)
    f = np.array([
        [0, 1, 2], [3, 0, 2], [4, 5, 6], [7, 4, 6],
        [8, 9, 10], [11, 8, 10], [12, 13, 14], [15, 12, 14],
        [16, 17, 18], [19, 16, 18], [20, 21, 22], [23, 20, 22],
    ])
    return Mesh(v, f, n, uv)


@register_plugin("shape", "rectangle")
class RectangleShape(Shape):
    def __init__(self, props: Properties):
        super().__init__(props)
        self.mesh = make_rectangle()


@register_plugin("shape", "cube")
class CubeShape(Shape):
    def __init__(self, props: Properties):
        super().__init__(props)
        self.mesh = make_cube()


@register_plugin("shape", "obj")
class ObjShape(Shape):
    """Triangle mesh from a Wavefront OBJ file (reference
    src/shapes/obj.cpp). Above 64 faces the compiler Morton-orders them,
    as the JAX package does (render/scene.py)."""

    def __init__(self, props: Properties):
        super().__init__(props)
        from ..core.fresolver import resolve_filename
        from ..io.mesh_loaders import load_obj
        filename = resolve_filename(props.get_string("filename"))
        props.mark_queried("face_normals")
        self.mesh = load_obj(filename)


@register_plugin("shape", "sphere")
class SphereShape(Shape):
    """Analytic unit sphere under its to_world transform (reference
    src/shapes/sphere.cpp): the intersector solves the quadratic in object
    space."""
    is_analytic_sphere = True

    def __init__(self, props: Properties):
        super().__init__(props)
        from ..core import transform as tf
        center = props.get_vector("center", np.zeros(3))
        radius = props.get_float("radius", 1.0)
        base = self.to_world
        local = tf.translate(center) @ tf.scale([radius] * 3)
        if base.animated:
            self.to_world = AnimatedTransform(
                keyframes=[(t, m @ local) for t, m in base.keyframes])
        else:
            self.to_world = AnimatedTransform(
                static_matrix=base.static_matrix @ local)


__all__ = ["Shape", "Mesh", "make_rectangle", "make_cube", "RectangleShape",
           "CubeShape", "ObjShape", "SphereShape"]
