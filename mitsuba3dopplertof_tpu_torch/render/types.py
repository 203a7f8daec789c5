"""Wavefront record types, component-wise (port of the JAX package's
``render/types.py``; reference include/mitsuba/core/ray.h and
include/mitsuba/render/interaction.h). Every field is an (N,) tensor."""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..core.vec import Vec3, dot, norm

# reference include/mitsuba/core/math.h:18-22
RAY_EPSILON = float(1.5e3 * 2.0 ** -24)
SHADOW_EPSILON = RAY_EPSILON * 10.0


class Ray(NamedTuple):
    o: Vec3
    d: Vec3
    time: torch.Tensor
    maxt: torch.Tensor


class SurfaceInteraction(NamedTuple):
    valid: torch.Tensor      # (N,) bool, replaces si.is_valid()
    t: torch.Tensor
    p: Vec3                  # world position
    n: Vec3                  # geometric normal (world)
    sh_n: Vec3               # shading normal (frame z)
    sh_s: Vec3
    sh_t: Vec3
    uv_u: torch.Tensor
    uv_v: torch.Tensor
    wi: Vec3                 # incident direction, local frame
    inst: torch.Tensor       # (N,) int32 instance (-1 = miss)
    prim: torch.Tensor       # (N,) int32 triangle slot
    time: torch.Tensor
    b_u: Optional[torch.Tensor] = None
    b_v: Optional[torch.Tensor] = None

    def to_local(self, v: Vec3) -> Vec3:
        return Vec3(dot(v, self.sh_s), dot(v, self.sh_t), dot(v, self.sh_n))

    def to_world(self, v: Vec3) -> Vec3:
        return self.sh_s * v.x + self.sh_t * v.y + self.sh_n * v.z

    # -- ray spawning (reference interaction.h:136-167) --------------------
    def _offset_p(self, d: Vec3) -> Vec3:
        mx = torch.maximum(torch.abs(self.p.x),
                           torch.maximum(torch.abs(self.p.y),
                                         torch.abs(self.p.z)))
        mag = (1.0 + mx) * RAY_EPSILON
        mag = torch.where(dot(self.n, d) >= 0.0, mag, -mag)
        return self.p + self.n * mag

    def spawn_ray(self, d: Vec3) -> Ray:
        return Ray(self._offset_p(d), d, self.time,
                   torch.full_like(self.t, float("inf")))

    def spawn_ray_to(self, target: Vec3) -> Ray:
        o = self._offset_p(target - self.p)
        d = target - o
        dist = norm(d)
        d = d * (1.0 / torch.clamp(dist, min=1e-20))
        return Ray(o, d, self.time, dist * (1.0 - SHADOW_EPSILON))


class DirectionSample(NamedTuple):
    """NEE sample record (reference include/mitsuba/render/records.h)."""
    p: Vec3
    n: Vec3
    d: Vec3
    dist: torch.Tensor
    pdf: torch.Tensor
    delta: torch.Tensor
    emitter: torch.Tensor    # (N,) int32 emitter index (-1 = none)


__all__ = ["Ray", "SurfaceInteraction", "DirectionSample",
           "RAY_EPSILON", "SHADOW_EPSILON"]
