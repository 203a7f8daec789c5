"""Shape plugins (port of the JAX package's ``shapes/__init__.py``: the
triangle-mesh base, rectangle, cube, disk, cylinder, OBJ, PLY and
``.serialized`` meshes, the analytic sphere, shapegroup, instance and
merge).

Every shape is an indexed triangle mesh in object space (or an analytic
unit sphere) plus a possibly animated to_world transform, so static and
animated shapes compile into the same tables. The disk and the cylinder
are tessellated as the JAX package tessellates them. An instance expands
at load time into one shape per child of its group, with the composed
transform (``io/dict_loader.py``). Reference plugins:
src/shapes/{rectangle,cube,disk,cylinder,obj,ply,serialized,sphere,
shapegroup,instance,merge}.cpp.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np

from ..core.properties import Properties, register_plugin
from ..core.transform import AnimatedTransform


class Mesh:
    """Host-side indexed triangle mesh (numpy, object space)."""

    def __init__(self, vertices: np.ndarray, faces: np.ndarray,
                 normals: Optional[np.ndarray] = None,
                 uvs: Optional[np.ndarray] = None,
                 attributes: Optional[dict] = None):
        self.vertices = np.asarray(vertices, dtype=np.float64).reshape(-1, 3)
        self.faces = np.asarray(faces, dtype=np.int64).reshape(-1, 3)
        self.normals = (np.asarray(normals, dtype=np.float64).reshape(-1, 3)
                        if normals is not None else None)
        self.uvs = (np.asarray(uvs, dtype=np.float64).reshape(-1, 2)
                    if uvs is not None else None)
        # named per-vertex attributes, e.g. {"vertex_color": (V, 3)}
        # (reference mesh.cpp add_attribute), which mesh_attribute
        # textures read
        self.attributes = dict(attributes or {})

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
        # participating media inside and outside the boundary (volpath)
        self.interior_medium = None
        self.exterior_medium = None
        self.mesh: Optional[Mesh] = None
        from ..bsdfs import BSDF
        from ..emitters import Emitter
        from ..media import Medium
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
            elif isinstance(v, Medium):
                if key == "exterior":
                    self.exterior_medium = v
                else:
                    self.interior_medium = v
            elif isinstance(v, Shape):
                continue          # children of a shapegroup or a merge
            else:
                raise NotImplementedError(
                    f"shape child '{key}' of kind {v.plugin_category} is not "
                    "ported yet (ROADMAP Queue A item 10)")


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


def make_disk(subdiv: int = 64) -> Mesh:
    """Unit disk in the XY plane, normal +Z, as a fan of ``subdiv``
    triangles (reference src/shapes/disk.cpp)."""
    ang = np.linspace(0, 2 * math.pi, subdiv, endpoint=False)
    rim = np.stack([np.cos(ang), np.sin(ang), np.zeros_like(ang)], axis=-1)
    verts = np.concatenate([[[0.0, 0.0, 0.0]], rim], axis=0)
    faces = [[0, 1 + i, 1 + (i + 1) % subdiv] for i in range(subdiv)]
    n = np.tile([[0.0, 0.0, 1.0]], (len(verts), 1))
    uv = 0.5 * (verts[:, :2] + 1.0)
    return Mesh(verts, np.asarray(faces), n, uv)


def make_cylinder(subdiv: int = 64) -> Mesh:
    """Open cylinder along +Z, radius 1, z in [0, 1], ``2 subdiv``
    triangles with radial normals (reference src/shapes/cylinder.cpp)."""
    ang = np.linspace(0, 2 * math.pi, subdiv, endpoint=False)
    c, s = np.cos(ang), np.sin(ang)
    bot = np.stack([c, s, np.zeros_like(ang)], axis=-1)
    top = np.stack([c, s, np.ones_like(ang)], axis=-1)
    verts = np.concatenate([bot, top], axis=0)
    normals = np.concatenate([np.stack([c, s, np.zeros_like(ang)],
                                       axis=-1)] * 2, axis=0)
    faces = []
    for i in range(subdiv):
        j = (i + 1) % subdiv
        faces.append([i, j, subdiv + j])
        faces.append([i, subdiv + j, subdiv + i])
    uv = np.concatenate([
        np.stack([ang / (2 * math.pi), np.zeros_like(ang)], axis=-1),
        np.stack([ang / (2 * math.pi), np.ones_like(ang)], axis=-1)], axis=0)
    return Mesh(verts, np.asarray(faces), normals, uv)


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


@register_plugin("shape", "disk")
class DiskShape(Shape):
    def __init__(self, props: Properties):
        super().__init__(props)
        self.mesh = make_disk()


@register_plugin("shape", "cylinder")
class CylinderShape(Shape):
    def __init__(self, props: Properties):
        super().__init__(props)
        self.mesh = make_cylinder()


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


@register_plugin("shape", "ply")
class PlyShape(Shape):
    """Triangle mesh from a PLY file (reference src/shapes/ply.cpp)."""

    def __init__(self, props: Properties):
        super().__init__(props)
        from ..core.fresolver import resolve_filename
        from ..io.mesh_loaders import load_ply
        filename = resolve_filename(props.get_string("filename"))
        props.mark_queried("face_normals")
        self.mesh = load_ply(filename)


@register_plugin("shape", "serialized")
class SerializedShape(Shape):
    """Shape ``shape_index`` of a Mitsuba ``.serialized`` file (reference
    src/shapes/serialized.cpp)."""

    def __init__(self, props: Properties):
        super().__init__(props)
        from ..core.fresolver import resolve_filename
        from ..io.mesh_loaders import load_serialized
        filename = resolve_filename(props.get_string("filename"))
        shape_index = props.get_int("shape_index", 0)
        props.mark_queried("face_normals")
        self.mesh = load_serialized(filename, shape_index)


@register_plugin("shape", "shapegroup")
class ShapeGroup(Shape):
    """Shapes for instancing (reference src/shapes/shapegroup.cpp): the
    group itself is never rendered; each instance of it expands into its
    children at load time."""

    def __init__(self, props: Properties):
        super().__init__(props)
        self.children = [v for _, v in props.objects()
                         if isinstance(v, Shape)]


@register_plugin("shape", "instance")
class Instance(Shape):
    """A shapegroup placed by a possibly animated transform (reference
    src/shapes/instance.cpp, with the fork's animated transform,
    instance.cpp:62-63, 155-250)."""

    def __init__(self, props: Properties):
        super().__init__(props)
        self.group = None
        for _, v in props.objects():
            if isinstance(v, ShapeGroup):
                self.group = v
        if self.group is None:
            raise RuntimeError("instance: requires a shapegroup child/ref")


@register_plugin("shape", "merge")
class MergeShape(Shape):
    """Child meshes concatenated into one triangle soup in world space at
    each child's first keyframe (reference src/shapes/merge.cpp). As in the
    JAX package the merged mesh keeps no normals or uvs, and takes the
    first child's BSDF unless it has its own."""

    def __init__(self, props: Properties):
        super().__init__(props)
        children = [v for _, v in props.objects() if isinstance(v, Shape)]
        if not children:
            raise RuntimeError("merge: requires child shapes")
        verts, faces, base = [], [], 0
        for ch in children:
            if ch.mesh is None:
                raise RuntimeError("merge: analytic children not supported")
            m0 = (ch.to_world.static_matrix if not ch.to_world.animated
                  else ch.to_world.matrices()[0])
            v = ch.mesh.vertices @ m0[:3, :3].T + m0[:3, 3]
            verts.append(v)
            faces.append(ch.mesh.faces + base)
            base += v.shape[0]
        self.mesh = Mesh(np.concatenate(verts), np.concatenate(faces))
        if children[0].bsdf is not None and self.bsdf is None:
            self.bsdf = children[0].bsdf


@register_plugin("shape", "blender")
class BlenderShape(Shape):
    """reference src/shapes/blender.cpp imports in-memory Blender meshes:
    only meaningful inside a Blender process, so it raises, as in the JAX
    package."""

    def __init__(self, props: Properties):
        raise RuntimeError(
            "shape type 'blender' imports in-memory Blender meshes and is "
            "only available inside Blender; export to PLY/OBJ instead")


__all__ = ["Shape", "Mesh", "make_rectangle", "make_cube", "make_disk",
           "make_cylinder", "RectangleShape", "CubeShape", "DiskShape",
           "CylinderShape", "ObjShape", "PlyShape", "SerializedShape",
           "SphereShape", "ShapeGroup", "Instance", "MergeShape"]
