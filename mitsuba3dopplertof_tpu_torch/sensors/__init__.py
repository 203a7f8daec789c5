"""Sensor plugins (port of the JAX package's ``sensors/__init__.py``: the
perspective camera, reference src/sensors/perspective.cpp:200-236 with the
perspective_projection of include/mitsuba/render/sensor.h:227, and the
thinlens, orthographic, radiancemeter, irradiancemeter, distant and batch
sensors of src/sensors/*.cpp).

The shutter window doubles as the ToF exposure interval
(reference src/render/sensor.cpp:15-19).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..core.properties import Properties, register_plugin
from ..core.vec import Vec3, coordinate_system, normalize, where3
from ..core.warp import cosine_hemisphere_c, disk_concentric_c
from ..render.types import Ray


def parse_fov(props: Properties, aspect: float) -> float:
    """reference src/render/sensor.cpp parse_fov — the x-fov in degrees."""
    if props.has_property("fov"):
        fov = props.get_float("fov")
        axis = props.get_string("fov_axis", "x")
        if axis == "x":
            return fov

        def conv(v, f):
            return math.degrees(
                2.0 * math.atan(math.tan(math.radians(v) * 0.5) * f))
        if axis == "y":
            return conv(fov, aspect)
        if axis == "diagonal":
            return conv(fov, 1.0 / math.hypot(1.0, 1.0 / aspect))
        if axis == "smaller":
            return fov if aspect <= 1.0 else conv(fov, aspect)
        if axis == "larger":
            return fov if aspect >= 1.0 else conv(fov, aspect)
        raise RuntimeError(f"Unknown fov_axis '{axis}'")
    focal = props.get_float("focal_length", 50.0)
    value = math.degrees(2.0 * math.atan(43.266615300557 / (2.0 * focal)))
    d = math.hypot(1.0, 1.0 / aspect)
    return math.degrees(2.0 * math.atan(math.tan(math.radians(value) * 0.5)
                                        / d))


class Sensor:
    def __init__(self, props: Properties):
        self.id = props.id
        self.to_world = props.get_transform("to_world", np.eye(4))
        self.shutter_open = props.get_float("shutter_open", 0.0)
        self.shutter_close = props.get_float("shutter_close",
                                             self.shutter_open)
        self.film = None
        self.sampler = None
        self.medium = None        # the medium the camera sits in (volpath)
        from ..films import Film
        from ..media import Medium
        from ..samplers import Sampler
        for key, v in props.objects():
            if isinstance(v, Film):
                self.film = v
            elif isinstance(v, Sampler):
                self.sampler = v
            elif isinstance(v, Medium):
                self.medium = v
            elif not isinstance(v, Sensor):
                # nested sensors are the batch sensor's children
                raise NotImplementedError(
                    f"sensor child '{key}' of kind "
                    f"{getattr(v, '_category', type(v).__name__)} is not "
                    "ported yet (ROADMAP Queue A item 10)")
        if self.film is None:
            from ..films import HDRFilm
            self.film = HDRFilm(Properties("hdrfilm"))
        if self.sampler is None:
            from ..samplers import IndependentSampler
            self.sampler = IndependentSampler(Properties("independent"))

    @property
    def shutter_open_time(self) -> float:
        return self.shutter_close - self.shutter_open

    @property
    def needs_aperture_sample(self) -> bool:
        return False


def _matrix12(mat) -> tuple:
    """The row-major 3x4 part of a 4x4 matrix as 12 Python floats."""
    return tuple(float(mat[i, j]) for i in range(3) for j in range(4))


class SensorParams(NamedTuple):
    """Camera constants: the matrix is 12 Python floats."""
    m: tuple                    # row-major 3x4 world matrix
    tan_half_x: float
    tan_half_y: float
    near_clip: float
    far_clip: float
    kind: int = 0               # 0 perspective, 1 thinlens, 2 orthographic
                                # or distant, 3 radiancemeter, 4 / 5
                                # irradiancemeter (unbound / bound)
    pp_ox: float = 0.0          # principal point offset, film-size units
    pp_oy: float = 0.0          # (reference perspective.cpp:191-205)


class BatchParams(NamedTuple):
    """Batch sensor: K children side by side (reference
    src/sensors/batch.cpp); film column band k belongs to child k."""
    children: tuple             # of (SensorParams, lens or None)


@register_plugin("sensor", "perspective")
class PerspectiveSensor(Sensor):
    def __init__(self, props: Properties):
        super().__init__(props)
        self.near_clip = props.get_float("near_clip", 1e-2)
        self.far_clip = props.get_float("far_clip", 1e4)
        # ProjectiveCamera property (reference sensor.cpp:196): a pinhole
        # ignores it
        self.focus_distance = props.get_float("focus_distance", 0.0)
        size = self.film.size
        self.aspect = size[0] / size[1]
        self.x_fov = parse_fov(props, self.aspect)
        self.pp_offset = (props.get_float("principal_point_offset_x", 0.0),
                          props.get_float("principal_point_offset_y", 0.0))

    def device_params(self) -> SensorParams:
        th = math.tan(math.radians(self.x_fov) * 0.5)
        return SensorParams(
            m=_matrix12(self.to_world),
            tan_half_x=float(th), tan_half_y=float(th / self.aspect),
            near_clip=float(self.near_clip), far_clip=float(self.far_clip),
            kind=0, pp_ox=float(self.pp_offset[0]),
            pp_oy=float(self.pp_offset[1]))


@register_plugin("sensor", "thinlens")
class ThinLensSensor(PerspectiveSensor):
    """Perspective camera with a thin-lens aperture (reference
    src/sensors/thinlens.cpp): depth of field from an aperture-disk sample
    and the central ray's point on the focus plane."""

    def __init__(self, props: Properties):
        self.aperture_radius = props.get_float("aperture_radius", 0.1)
        super().__init__(props)
        self.focus_distance = props.get_float("focus_distance", 10.0)

    @property
    def needs_aperture_sample(self) -> bool:
        return True

    def device_params(self) -> SensorParams:
        return super().device_params()._replace(kind=1)

    def device_lens_params(self):
        return float(self.aperture_radius), float(self.focus_distance)


@register_plugin("sensor", "orthographic")
class OrthographicSensor(Sensor):
    """reference src/sensors/orthographic.cpp: parallel rays along camera
    +Z; the film plane's extent comes from the to_world scale."""

    def __init__(self, props: Properties):
        super().__init__(props)
        self.near_clip = props.get_float("near_clip", 1e-2)
        self.far_clip = props.get_float("far_clip", 1e4)

    def device_params(self) -> SensorParams:
        return SensorParams(m=_matrix12(self.to_world), tan_half_x=1.0,
                            tan_half_y=1.0, near_clip=float(self.near_clip),
                            far_clip=float(self.far_clip), kind=2)


@register_plugin("sensor", "radiancemeter")
class RadianceMeter(Sensor):
    """reference src/sensors/radiancemeter.cpp: radiance along one ray
    (origin and +Z of to_world); the film is typically 1x1."""

    def device_params(self) -> SensorParams:
        return SensorParams(m=_matrix12(self.to_world), tan_half_x=0.0,
                            tan_half_y=0.0, near_clip=0.0, far_clip=1e4,
                            kind=3)


@register_plugin("sensor", "irradiancemeter")
class IrradianceMeter(Sensor):
    """reference src/sensors/irradiancemeter.cpp: irradiance over the shape
    it is attached to. Positions uniform over the surface, directions
    cosine-weighted about the normal, ray weight pi. Binds to rectangles
    and spheres; an unbound meter is a point meter at the to_world
    origin."""

    def __init__(self, props: Properties):
        super().__init__(props)
        self.shape = None            # bound by the owning shape at load

    def device_params(self) -> SensorParams:
        kind = 4
        mat = self.to_world
        tanx = 0.0
        if self.shape is not None:
            mat = np.asarray(self.shape.to_world.matrices()[0])
            kind = 5
            tanx = 1.0 if getattr(self.shape, "is_analytic_sphere",
                                  False) else 0.0
        return SensorParams(m=_matrix12(mat), tan_half_x=tanx,
                            tan_half_y=0.0, near_clip=0.0, far_clip=1e4,
                            kind=kind)


@register_plugin("sensor", "distant")
class DistantSensor(Sensor):
    """reference src/sensors/distant.cpp: an orthographic-like sensor
    looking along a direction."""

    def __init__(self, props: Properties):
        super().__init__(props)
        if props.has_property("direction"):
            d = np.asarray(props.get_vector("direction"))
            d = d / np.linalg.norm(d)
            # to_world's rotation columns (s, t, d)
            s = np.cross([0, 1, 0] if abs(d[1]) < 0.9 else [1, 0, 0], d)
            s = s / np.linalg.norm(s)
            t = np.cross(d, s)
            m = np.eye(4)
            m[:3, 0], m[:3, 1], m[:3, 2] = s, t, d
            self.to_world = m

    def device_params(self) -> SensorParams:
        return SensorParams(m=_matrix12(self.to_world), tan_half_x=1.0,
                            tan_half_y=1.0, near_clip=0.0, far_clip=1e4,
                            kind=2)


@register_plugin("sensor", "batch")
class BatchSensor(Sensor):
    """reference src/sensors/batch.cpp: nested sensors rendered side by
    side. Like the JAX package, it asks for no aperture sample even when
    a child is a thin lens."""

    def __init__(self, props: Properties):
        super().__init__(props)
        self.children = [v for _, v in props.objects()
                         if isinstance(v, Sensor)]
        if not self.children:
            raise RuntimeError("batch: needs nested sensors")
        first = self.children[0]
        self.film = self.film or first.film
        self.sampler = self.sampler or first.sampler

    def device_params(self) -> BatchParams:
        return BatchParams(children=tuple(
            (c.device_params(),
             c.device_lens_params() if hasattr(c, "device_lens_params")
             else None)
            for c in self.children))


def _to_world(m, v: Vec3, point: bool) -> Vec3:
    """Apply the row-major 3x4 matrix ``m`` to a vector (or a point)."""
    out = [m[4 * r] * v.x + m[4 * r + 1] * v.y + m[4 * r + 2] * v.z
           for r in range(3)]
    if point:
        out = [c + m[4 * r + 3] for r, c in enumerate(out)]
    return Vec3(*out)


def sample_ray_kind(params, lens, time, sx, sy, ap_x=None, ap_y=None):
    """Sensor rays from film-plane samples in [0,1]^2 and aperture samples,
    each an (N,) tensor, by the sensor's kind. ``lens`` is (aperture
    radius, focus distance) for a thin lens, else None; ``ap_x``/``ap_y``
    are read only by the thin lens and the bound irradiance meter.
    Returns (Ray, weight)."""
    if isinstance(params, BatchParams):
        return _sample_ray_batch(params, time, sx, sy, ap_x, ap_y)
    if params.kind == 1:
        return _sample_ray_thinlens(params, lens, time, sx, sy, ap_x, ap_y)
    if params.kind == 2:
        return _sample_ray_orthographic(params, time, sx, sy)
    if params.kind == 5:
        return _sample_ray_irradiance(params, time, sx, sy, ap_x, ap_y)
    if params.kind in (3, 4):
        # radiance meter, unbound irradiance meter: a constant ray
        m = params.m
        one = torch.ones_like(sx)
        d = Vec3(m[2] * one, m[6] * one, m[10] * one)
        o = Vec3(m[3] * one, m[7] * one, m[11] * one)
        return Ray(o, d, time, torch.full_like(sx, params.far_clip)), 1.0
    return _sample_ray_perspective(params, time, sx, sy)


def _sample_ray_perspective(params: SensorParams, time, sx, sy):
    """reference perspective.cpp:217-236: the camera-space direction
    ((1-2*sx)*tan(fov_x/2), (1-2*sy)*tan(fov_x/2)/aspect, 1), normalized and
    rotated to world; the origin advances to the near plane. Weight 1."""
    dcx = (1.0 - 2.0 * (sx + params.pp_ox)) * params.tan_half_x
    dcy = (1.0 - 2.0 * (sy + params.pp_oy)) * params.tan_half_y
    d_cam = normalize(Vec3(dcx, dcy, torch.ones_like(sx)))
    m = params.m
    d = Vec3(m[0] * d_cam.x + m[1] * d_cam.y + m[2] * d_cam.z,
             m[4] * d_cam.x + m[5] * d_cam.y + m[6] * d_cam.z,
             m[8] * d_cam.x + m[9] * d_cam.y + m[10] * d_cam.z)
    inv_z = 1.0 / d_cam.z
    near_t = params.near_clip * inv_z
    far_t = params.far_clip * inv_z
    o = Vec3(m[3] + d.x * near_t, m[7] + d.y * near_t, m[11] + d.z * near_t)
    return Ray(o, d, time, far_t - near_t), 1.0


def _sample_ray_thinlens(params, lens, time, sx, sy, ap_x, ap_y):
    """reference thinlens.cpp sample_ray: the aperture point on the disk,
    toward the central ray's point on the focus plane."""
    aperture_radius, focus_distance = lens
    m = params.m
    dcx = (1.0 - 2.0 * (sx + params.pp_ox)) * params.tan_half_x
    dcy = (1.0 - 2.0 * (sy + params.pp_oy)) * params.tan_half_y
    d_cam = normalize(Vec3(dcx, dcy, torch.ones_like(sx)))
    px, py = disk_concentric_c(ap_x, ap_y)
    px = px * aperture_radius
    py = py * aperture_radius
    ft = focus_distance / d_cam.z
    fx = d_cam.x * ft
    fy = d_cam.y * ft
    fz = torch.full_like(fx, focus_distance)
    d2 = normalize(Vec3(fx - px, fy - py, fz))
    d = _to_world(m, d2, point=False)
    o = _to_world(m, Vec3(px, py, torch.zeros_like(px)), point=True)
    inv_z = 1.0 / d2.z
    near_t = params.near_clip * inv_z
    far_t = params.far_clip * inv_z
    o = o + d * near_t
    return Ray(o, d, time, far_t - near_t), 1.0


def _sample_ray_orthographic(params, time, sx, sy):
    """Orthographic and distant sensors: parallel rays along to_world's
    +Z from the film point (1 - 2 sx, 1 - 2 sy, 0)."""
    m = params.m
    ox = 1.0 - 2.0 * sx
    oy = 1.0 - 2.0 * sy
    one = torch.ones_like(ox)
    d = Vec3(m[2] * one, m[6] * one, m[10] * one)
    o = Vec3(m[0] * ox + m[1] * oy + m[3],
             m[4] * ox + m[5] * oy + m[7],
             m[8] * ox + m[9] * oy + m[11])
    o = o + d * params.near_clip
    return Ray(o, d, time, torch.full_like(
        ox, params.far_clip - params.near_clip)), 1.0


def _sample_ray_irradiance(params, time, sx, sy, ap_x, ap_y):
    """An irradiance meter bound to its shape: a point uniform on the
    rectangle [-1,1]^2 (normal +z) or the unit sphere, in world space, and
    a cosine-weighted direction about the normal. Weight pi."""
    m = params.m
    if params.tan_half_x > 0.5:          # sphere: a uniform surface point
        z = 1.0 - 2.0 * sx
        r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
        phi = 2.0 * np.pi * sy
        lp = Vec3(r * torch.cos(phi), r * torch.sin(phi), z)
        ln = lp
    else:                                # rectangle [-1,1]^2, normal +z
        zero = torch.zeros_like(sx)
        lp = Vec3(1.0 - 2.0 * sx, 1.0 - 2.0 * sy, zero)
        ln = Vec3(zero, zero, torch.ones_like(sx))
    o = _to_world(m, lp, point=True)
    nw = normalize(_to_world(m, ln, point=False))
    t1, t2 = coordinate_system(nw)
    dl = cosine_hemisphere_c(ap_x, ap_y)
    d = t1 * dl.x + t2 * dl.y + nw * dl.z
    o = o + nw * 1e-4
    return (Ray(o, d, time, torch.full_like(sx, params.far_clip)),
            float(np.pi))


def _sample_ray_batch(params: BatchParams, time, sx, sy, ap_x, ap_y):
    """Child k takes the film's k-th band of columns, with sx rescaled to
    its own [0, 1)."""
    k_n = len(params.children)
    u = torch.clamp(sx * k_n, 0.0, k_n - 1e-4)
    child = torch.floor(u)
    lx = u - child
    ray = weight = None
    for k, (cp, cl) in enumerate(params.children):
        r_k, w_k = sample_ray_kind(cp, cl, time, lx, sy, ap_x, ap_y)
        w_k = w_k * torch.ones_like(sx)
        if ray is None:
            ray, weight = r_k, w_k
        else:
            sel = child == k
            ray = Ray(where3(sel, r_k.o, ray.o), where3(sel, r_k.d, ray.d),
                      time, torch.where(sel, r_k.maxt, ray.maxt))
            weight = torch.where(sel, w_k, weight)
    return ray, weight


__all__ = ["Sensor", "PerspectiveSensor", "ThinLensSensor",
           "OrthographicSensor", "RadianceMeter", "IrradianceMeter",
           "DistantSensor", "BatchSensor", "SensorParams", "BatchParams",
           "sample_ray_kind", "parse_fov"]
