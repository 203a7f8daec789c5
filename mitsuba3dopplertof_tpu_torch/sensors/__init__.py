"""Sensor plugins (port of the JAX package's ``sensors/__init__.py``: the
perspective camera, reference src/sensors/perspective.cpp:200-236 with the
perspective_projection of include/mitsuba/render/sensor.h:227).

The shutter window doubles as the ToF exposure interval
(reference src/render/sensor.cpp:15-19).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..core.properties import Properties, register_plugin
from ..core.vec import Vec3, normalize
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
        from ..films import Film
        from ..samplers import Sampler
        for key, v in props.objects():
            if isinstance(v, Film):
                self.film = v
            elif isinstance(v, Sampler):
                self.sampler = v
            else:
                raise NotImplementedError(
                    f"sensor child '{key}' is not ported yet "
                    "(ROADMAP Queue A item 9)")
        if self.film is None:
            from ..films import HDRFilm
            self.film = HDRFilm(Properties("hdrfilm"))
        if self.sampler is None:
            from ..samplers import IndependentSampler
            self.sampler = IndependentSampler(Properties("independent"))

    @property
    def shutter_open_time(self) -> float:
        return self.shutter_close - self.shutter_open


class SensorParams(NamedTuple):
    """Camera constants: the matrix is 12 Python floats."""
    m: tuple                    # row-major 3x4 world matrix
    tan_half_x: float
    tan_half_y: float
    near_clip: float
    far_clip: float
    pp_ox: float = 0.0          # principal point offset, film-size units
    pp_oy: float = 0.0          # (reference perspective.cpp:191-205)


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
            m=tuple(float(self.to_world[i, j])
                    for i in range(3) for j in range(4)),
            tan_half_x=float(th), tan_half_y=float(th / self.aspect),
            near_clip=float(self.near_clip), far_clip=float(self.far_clip),
            pp_ox=float(self.pp_offset[0]), pp_oy=float(self.pp_offset[1]))


def sample_ray_kind(params: SensorParams, time, sx, sy):
    """Camera rays from film-plane samples in [0,1]^2, each an (N,) tensor
    (reference perspective.cpp:217-236): the camera-space direction
    ((1-2*sx)*tan(fov_x/2), (1-2*sy)*tan(fov_x/2)/aspect, 1), normalized and
    rotated to world; the origin advances to the near plane. Returns
    (Ray, weight 1.0)."""
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


__all__ = ["Sensor", "PerspectiveSensor", "SensorParams", "sample_ray_kind",
           "parse_fov"]
