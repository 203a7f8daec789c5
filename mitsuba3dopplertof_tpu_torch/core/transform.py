"""4x4 affine transforms and 2-keyframe animated transforms (host side,
numpy): the parts of the JAX package's ``core/transform.py`` that scene
loading uses. The per-lane clamped keyframe lerp, inverse and apply live in
``core/vec.py`` (``cmat_*``).

Reference semantics:
  * ``Transform4f`` ops        — reference include/mitsuba/core/transform.h
  * ``AnimatedTransform.eval`` — clamped component-wise matrix lerp between
    the two keyframes (reference transform.h:458-466).
"""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np


def identity() -> np.ndarray:
    return np.eye(4, dtype=np.float64)


def translate(v) -> np.ndarray:
    m = identity()
    m[:3, 3] = v
    return m


def scale(v) -> np.ndarray:
    m = identity()
    v = np.broadcast_to(np.asarray(v, dtype=np.float64), (3,))
    m[0, 0], m[1, 1], m[2, 2] = v
    return m


def rotate(axis, angle_deg: float) -> np.ndarray:
    """Rotation about ``axis`` by ``angle_deg`` degrees (right-handed)."""
    axis = np.asarray(axis, dtype=np.float64)
    axis = axis / np.linalg.norm(axis)
    a = math.radians(angle_deg)
    c, s = math.cos(a), math.sin(a)
    x, y, z = axis
    r = np.array([
        [c + x * x * (1 - c), x * y * (1 - c) - z * s, x * z * (1 - c) + y * s],
        [y * x * (1 - c) + z * s, c + y * y * (1 - c), y * z * (1 - c) - x * s],
        [z * x * (1 - c) - y * s, z * y * (1 - c) + x * s, c + z * z * (1 - c)],
    ])
    m = identity()
    m[:3, :3] = r
    return m


def look_at(origin, target, up) -> np.ndarray:
    """Mitsuba's look_at: camera-space +Z points at the target, +X is left
    (matches reference transform.h Transform4f::look_at)."""
    origin = np.asarray(origin, dtype=np.float64)
    target = np.asarray(target, dtype=np.float64)
    up = np.asarray(up, dtype=np.float64)
    d = target - origin
    d = d / np.linalg.norm(d)
    left = np.cross(up / np.linalg.norm(up), d)
    left = left / np.linalg.norm(left)
    new_up = np.cross(d, left)
    m = identity()
    m[:3, 0] = left
    m[:3, 1] = new_up
    m[:3, 2] = d
    m[:3, 3] = origin
    return m


class AnimatedTransform:
    """Host-side container: list of (time, 4x4 matrix) keyframes.

    Matches the fork's behavior: with <2 keyframes it's static; with >=2 only
    the first two keyframes participate in the lerp (reference
    transform.h:461-466 uses m_keyframes[0] and m_keyframes[1]).
    """

    def __init__(self, keyframes: List[Tuple[float, np.ndarray]] = None,
                 static_matrix: np.ndarray = None):
        self.keyframes = sorted(keyframes or [], key=lambda kv: kv[0])
        self.static_matrix = (
            static_matrix if static_matrix is not None else identity())

    @property
    def animated(self) -> bool:
        return len(self.keyframes) >= 2

    def matrices(self) -> Tuple[np.ndarray, np.ndarray, float, float]:
        """Return (m0, m1, t0, t1); static transforms repeat their matrix."""
        if not self.animated:
            m = (self.keyframes[0][1] if self.keyframes
                 else self.static_matrix)
            return m, m, 0.0, 1.0
        (t0, m0), (t1, m1) = self.keyframes[0], self.keyframes[1]
        return m0, m1, float(t0), float(t1)

    def eval(self, time: float) -> np.ndarray:
        m0, m1, t0, t1 = self.matrices()
        if not self.animated:
            return m0
        u = min(max((time - t0) / (t1 - t0), 0.0), 1.0)
        return m0 * (1.0 - u) + m1 * u

    def get_min_time(self) -> float:
        return min((t for t, _ in self.keyframes), default=0.0)

    def get_max_time(self) -> float:
        return max((t for t, _ in self.keyframes), default=0.0)


__all__ = ["identity", "translate", "scale", "rotate", "look_at",
           "AnimatedTransform"]
