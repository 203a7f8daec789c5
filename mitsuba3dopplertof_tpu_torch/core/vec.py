"""Component-wise 3-vectors and affine transforms (port of the JAX
package's ``core/vec.py``).

The port keeps the JAX package's SoA layout at its public functions: a Vec3
is three (N,) tensors. A "cmat" is a tuple of 12 entries (m00..m03,
m10..m13, m20..m23); each entry is a Python float or an (N,) tensor.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch


class Vec3(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor

    def __add__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x + o.x, self.y + o.y, self.z + o.z)
        return Vec3(self.x + o, self.y + o, self.z + o)

    def __sub__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x - o.x, self.y - o.y, self.z - o.z)
        return Vec3(self.x - o, self.y - o, self.z - o)

    def __mul__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x * o.x, self.y * o.y, self.z * o.z)
        return Vec3(self.x * o, self.y * o, self.z * o)

    __rmul__ = __mul__

    def __neg__(self):
        return Vec3(-self.x, -self.y, -self.z)

    @staticmethod
    def full(n, vx, vy, vz, device=None):
        return Vec3(torch.full((n,), vx, device=device),
                    torch.full((n,), vy, device=device),
                    torch.full((n,), vz, device=device))

    @staticmethod
    def zeros(n, device=None):
        z = torch.zeros((n,), device=device)
        return Vec3(z, z, z)

    @staticmethod
    def ones(n, device=None):
        o = torch.ones((n,), device=device)
        return Vec3(o, o, o)


def dot(a: Vec3, b: Vec3):
    return a.x * b.x + a.y * b.y + a.z * b.z


def cross(a: Vec3, b: Vec3) -> Vec3:
    return Vec3(a.y * b.z - a.z * b.y,
                a.z * b.x - a.x * b.z,
                a.x * b.y - a.y * b.x)


def norm(a: Vec3):
    return torch.sqrt(torch.clamp(dot(a, a), min=0.0))


def normalize(a: Vec3) -> Vec3:
    return a * torch.rsqrt(torch.clamp(dot(a, a), min=1e-30))


def where3(m, a: Vec3, b: Vec3) -> Vec3:
    return Vec3(torch.where(m, a.x, b.x), torch.where(m, a.y, b.y),
                torch.where(m, a.z, b.z))


def vmax(a: Vec3):
    return torch.maximum(a.x, torch.maximum(a.y, a.z))


def cmat_lerp(c0, c1, t):
    """Clamped keyframe lerp with per-lane t in [0,1]."""
    return tuple(a * (1.0 - t) + b * t for a, b in zip(c0, c1))


def cmat_apply_point(c, p: Vec3) -> Vec3:
    return Vec3(c[0] * p.x + c[1] * p.y + c[2] * p.z + c[3],
                c[4] * p.x + c[5] * p.y + c[6] * p.z + c[7],
                c[8] * p.x + c[9] * p.y + c[10] * p.z + c[11])


def cmat_apply_vector(c, v: Vec3) -> Vec3:
    return Vec3(c[0] * v.x + c[1] * v.y + c[2] * v.z,
                c[4] * v.x + c[5] * v.y + c[6] * v.z,
                c[8] * v.x + c[9] * v.y + c[10] * v.z)


def cmat_apply_transpose_vector(c, v: Vec3) -> Vec3:
    """Transpose of the 3x3 block (normals use the inverse's transpose)."""
    return Vec3(c[0] * v.x + c[4] * v.y + c[8] * v.z,
                c[1] * v.x + c[5] * v.y + c[9] * v.z,
                c[2] * v.x + c[6] * v.y + c[10] * v.z)


def cmat_inverse(c):
    """Closed-form affine inverse, component-wise."""
    a00, a01, a02, t0, a10, a11, a12, t1, a20, a21, a22, t2 = c
    c00 = a11 * a22 - a12 * a21
    c01 = a02 * a21 - a01 * a22
    c02 = a01 * a12 - a02 * a11
    c10 = a12 * a20 - a10 * a22
    c11 = a00 * a22 - a02 * a20
    c12 = a02 * a10 - a00 * a12
    c20 = a10 * a21 - a11 * a20
    c21 = a01 * a20 - a00 * a21
    c22 = a00 * a11 - a01 * a10
    det = a00 * c00 + a01 * c10 + a02 * c20
    inv = 1.0 / det
    i00, i01, i02 = c00 * inv, c01 * inv, c02 * inv
    i10, i11, i12 = c10 * inv, c11 * inv, c12 * inv
    i20, i21, i22 = c20 * inv, c21 * inv, c22 * inv
    nt0 = -(i00 * t0 + i01 * t1 + i02 * t2)
    nt1 = -(i10 * t0 + i11 * t1 + i12 * t2)
    nt2 = -(i20 * t0 + i21 * t1 + i22 * t2)
    return (i00, i01, i02, nt0, i10, i11, i12, nt1, i20, i21, i22, nt2)


def spherical_uv(pn: Vec3):
    """The uv of points ``pn`` on the unit sphere in object space
    (reference sphere.cpp): u = atan2(y, x) / 2 pi in [0, 1), v = acos(z)
    / pi."""
    u = torch.atan2(pn.y, pn.x) * (0.5 / math.pi)
    u = torch.where(u < 0.0, u + 1.0, u)
    v = torch.acos(torch.clamp(pn.z, -1.0, 1.0)) * (1.0 / math.pi)
    return u, v


def coordinate_system(n: Vec3):
    """Duff et al. orthonormal basis, component-wise."""
    sign = torch.where(n.z >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + n.z)
    b = n.x * n.y * a
    s = Vec3(1.0 + sign * n.x * n.x * a, sign * b, -sign * n.x)
    t = Vec3(b, sign + n.y * n.y * a, -n.y)
    return s, t


__all__ = [
    "Vec3", "dot", "cross", "norm", "normalize", "where3", "vmax",
    "cmat_lerp", "cmat_apply_point", "cmat_apply_vector",
    "cmat_apply_transpose_vector", "cmat_inverse", "coordinate_system",
    "spherical_uv",
]
