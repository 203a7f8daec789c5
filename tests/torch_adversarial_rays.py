"""Rays that stress a conservative ray-triangle gate
(``adversarial_rays``), for the port's tests of B6 on the CPU
(tests/test_torch_alt_kernels.py) and on the card
(tests/test_torch_cuda.py). Imports only the port (no jax)."""

import numpy as np
import torch

from mitsuba3dopplertof_tpu_torch.core.vec import Vec3
from mitsuba3dopplertof_tpu_torch.render.types import Ray

_GEOM = ("v0x", "v0y", "v0z", "e1x", "e1y", "e1z", "e2x", "e2y", "e2z")


def adversarial_rays(sa, n, seed, device):
    """``n`` rays that stress a conservative ray-triangle gate, in five
    equal parts: through a point of a triangle's edge, through a vertex,
    grazing (a direction 1e-3 off the triangle's plane) toward an interior
    point, parallel to the plane and 1e-6 (relative) beside it, and toward
    an interior point from about 1e3 away. Each aims at a random triangle
    of nonzero area of ``sa``, an animated one at its instance's first
    keyframe time (where its transform is the first matrix); the edge,
    vertex and grazing rays come from 0.5-4 units away. A quarter of the
    rays end within 0.1% of their target (maxt), the rest at infinity.
    Made with numpy from ``seed``."""
    rng = np.random.default_rng(seed)
    geo = lambda kind: np.stack([sa.tri(kind, c).cpu().numpy().astype(
        np.float64) for c in _GEOM], axis=1)
    parts = [(geo("s")[:sa.n_static_tris], np.zeros(sa.n_static_tris))]
    for inst, start, count in sa.anim_ranges:
        m = sa.inst_m0c[:, inst].cpu().numpy().astype(np.float64) \
            .reshape(3, 4)
        a = geo("a")[start:start + count].reshape(-1, 3, 3)
        world = a @ m[:, :3].T
        world[:, 0] += m[:, 3]
        parts.append((world.reshape(-1, 9), np.full(count, float(
            sa.inst_t0[inst]))))
    tri = np.concatenate([p[0] for p in parts])
    tri_time = np.concatenate([p[1] for p in parts])
    nrm = np.cross(tri[:, 3:6], tri[:, 6:9])
    area = np.linalg.norm(nrm, axis=1)
    ok = np.flatnonzero(area > 1e-10)
    pick = ok[rng.integers(0, len(ok), n)]
    v0, e1, e2 = tri[pick, 0:3], tri[pick, 3:6], tri[pick, 6:9]
    nh = nrm[pick] / area[pick, None]
    kind = np.arange(n) % 5
    a = rng.uniform(0.0, 1.0, (n, 1))
    b1, b2 = rng.uniform(0.0, 1.0, (2, n, 1))
    flip = b1 + b2 > 1.0
    b1, b2 = np.where(flip, 1.0 - b1, b1), np.where(flip, 1.0 - b2, b2)
    edge = rng.integers(0, 3, n)[:, None]
    p = np.where(kind[:, None] == 0,
                 np.where(edge == 0, v0 + a * e1, np.where(
                     edge == 1, v0 + a * e2, v0 + e1 + a * (e2 - e1))),
                 np.where(kind[:, None] == 1,
                          v0 + np.where(edge == 0, 0.0, 1.0)
                          * np.where(edge == 1, e1, e2),
                          v0 + b1 * e1 + b2 * e2))
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tan = d - (d * nh).sum(1, keepdims=True) * nh
    tan /= np.linalg.norm(tan, axis=1, keepdims=True)
    side = np.where(rng.uniform(size=(n, 1)) < 0.5, -1.0, 1.0)
    d = np.where(kind[:, None] == 2, tan + side * 1e-3 * nh,
                 np.where(kind[:, None] == 3, tan, d))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    dist = np.where(kind == 4, rng.uniform(500.0, 1000.0, n),
                    rng.uniform(0.5, 4.0, n))
    o = p - d * dist[:, None]
    o = np.where(kind[:, None] == 3, o + side * 1e-6
                 * (1.0 + np.abs(p).max(1, keepdims=True)) * nh, o)
    maxt = np.where(rng.uniform(size=n) < 0.25,
                    dist * rng.uniform(0.999, 1.001, n), np.inf)
    f = lambda v: torch.as_tensor(np.asarray(v, np.float32), device=device)
    return Ray(Vec3(*(f(o[:, i]) for i in range(3))),
               Vec3(*(f(d[:, i]) for i in range(3))), f(tri_time[pick]),
               f(maxt))
