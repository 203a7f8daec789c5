"""Sampling warps of the diffuse BSDF and the constant emitter (port of
the JAX package's ``core/warp.py`` component-wise variants; reference
include/mitsuba/core/warp.h)."""

from __future__ import annotations

import torch

from .math import PI, TWO_PI, safe_sqrt
from .vec import Vec3


def disk_concentric_c(sx, sy):
    """Shirley-Chiu concentric square -> disk."""
    x = 2.0 * sx - 1.0
    y = 2.0 * sy - 1.0
    is_zero = (x == 0.0) & (y == 0.0)
    q13 = torch.abs(x) < torch.abs(y)
    r = torch.where(q13, y, x)
    rp = torch.where(q13, x, y)
    phi = 0.25 * PI * rp / torch.where(r == 0.0, 1.0, r)
    phi = torch.where(q13, 0.5 * PI - phi, phi)
    phi = torch.where(is_zero, 0.0, phi)
    return r * torch.cos(phi), r * torch.sin(phi)


def cosine_hemisphere_c(sx, sy) -> Vec3:
    """Cosine-weighted hemisphere via the concentric disk."""
    px, py = disk_concentric_c(sx, sy)
    return Vec3(px, py, safe_sqrt(1.0 - px * px - py * py))


def uniform_sphere_c(sx, sy) -> Vec3:
    """Uniform direction on the unit sphere."""
    z = 1.0 - 2.0 * sy
    r = safe_sqrt(1.0 - z * z)
    phi = TWO_PI * sx
    return Vec3(r * torch.cos(phi), r * torch.sin(phi), z)


__all__ = ["disk_concentric_c", "cosine_hemisphere_c", "uniform_sphere_c"]
