"""Lanes whose render hangs on the last bits of a ray query: a helper of
the port's tests and of chip_smoke.py's phase 10 (imports the port only,
so that chip_smoke.py may import it on the card).

Two renders of one scene on two devices (or by two packages) trace rays
that differ in their last bits: XLA, PyTorch's CPU kernels and CUDA
round ``rsqrt``, ``sin``, ``exp`` differently, and the card's Woop test
and payload rebuild are not Möller-Trumbore. A path whose ray meets two
surfaces at one t (the hero's smoke cube stands on its floor: one plane)
or grazes a triangle's edge can then take the other branch, and its
sample differs by far more than the rounding. ``TieRecorder`` marks such
lanes in a render (``hooked``), so that a comparison can leave them out of
both renders and hold the rest to its tolerance (``dropped``).

A lane is marked when a closest-hit query of it has a hit on another
static shape within ``rel`` of its t, or when a closest-hit or any-hit
query of it passes within ``edge`` (in barycentric units) of the edge of a
static triangle no farther than its hit. Animated shapes are not tested.
"""

from __future__ import annotations

import contextlib
import sys

import torch

_GEOM = ("v0x", "v0y", "v0z", "e1x", "e1y", "e1z", "e2x", "e2y", "e2z")


def _barycentric(sa, ray):
    """(hit t, u, v, det ok) of every lane against every static triangle,
    (N, T) each (Möller-Trumbore, unclipped)."""
    n_s = sa.n_static_tris
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = (
        sa.tri("s", c)[None, :n_s] for c in _GEOM)
    ox, oy, oz = (c[:, None] for c in ray.o)
    dx, dy, dz = (c[:, None] for c in ray.d)
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    ok = torch.abs(det) > 1e-12
    inv = 1.0 / torch.where(ok, det, 1.0)
    tx, ty, tz = ox - v0x, oy - v0y, oz - v0z
    u = (tx * px + ty * py + tz * pz) * inv
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv
    t = (e2x * qx + e2y * qy + e2z * qz) * inv
    return t, u, v, ok


class TieRecorder:
    """Marks the lanes of a render of one pass of ``n_lanes`` lanes whose
    queries meet a near tie or graze a static edge (see the module's
    docstring)."""

    def __init__(self, n_lanes: int, device, rel: float = 2.0 ** -20,
                 edge: float = 2.0 ** -17):
        self.marked = torch.zeros(n_lanes, dtype=torch.bool, device=device)
        self.rel = rel
        self.edge = edge

    def _grazes(self, t, u, v, ok, reach):
        e = self.edge
        w = 1.0 - u - v
        near = torch.minimum(torch.minimum(torch.abs(u), torch.abs(v)),
                             torch.abs(w)) <= e
        inside = (u >= -e) & (v >= -e) & (w >= -e)
        return (ok & near & inside & (t > 0.0) & (t <= reach[:, None])).any(1)

    def closest(self, sa, ray, si, active=None):
        if sa.n_static_tris == 0:
            return
        t, u, v, ok = _barycentric(sa, ray)
        hit = (ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > 0.0)
               & (t < ray.maxt[:, None]))
        best = torch.where(si.valid, si.t, float("inf"))
        inst = sa.s_inst[None, :sa.n_static_tris]
        tie = (hit & (inst != si.inst[:, None])
               & (torch.abs(t - best[:, None]) <= self.rel * best[:, None]))
        reach = torch.minimum(best * (1.0 + self.rel), ray.maxt)
        mark = tie.any(1) | self._grazes(t, u, v, ok, reach)
        self.marked |= mark if active is None else mark & active

    def shadow(self, sa, ray, active=None):
        if sa.n_static_tris == 0:
            return
        t, u, v, ok = _barycentric(sa, ray)
        mark = self._grazes(t, u, v, ok, ray.maxt)
        self.marked |= mark if active is None else mark & active

    @contextlib.contextmanager
    def hooked(self):
        """Record every query of the integrators (the path loop, volpath,
        direct, aov, ptracer, the polarized path loop) while the context
        is open."""
        from mitsuba3dopplertof_tpu_torch import integrators as pi
        from mitsuba3dopplertof_tpu_torch.integrators import (
            extras as ex, polarized as po, ptracer as pt, volpath as vp)
        mods = (pi, vp, ex, pt, po)
        saved = [(m, k, getattr(m, k)) for m in mods
                 for k in ("ray_intersect", "ray_test")]
        # a module that binds the queries itself would escape the hooks
        for name, m in list(sys.modules.items()):
            if (name.startswith("mitsuba3dopplertof_tpu_torch.")
                    and name != "mitsuba3dopplertof_tpu_torch.render.scene"
                    and m not in mods
                    and any(getattr(m, k, None) is f for _, k, f in saved)):
                raise RuntimeError(f"TieRecorder: {name} binds a ray "
                                   "query that it does not hook")
        orig_i = pi.ray_intersect
        orig_t = pi.ray_test

        def ray_intersect(sa, ray, active=None):
            si = orig_i(sa, ray, active)
            self.closest(sa, ray, si, active)
            return si

        def ray_test(sa, ray, active=None):
            self.shadow(sa, ray, active)
            return orig_t(sa, ray, active)

        try:
            for m, k, _ in saved:
                setattr(m, k, ray_intersect if k == "ray_intersect"
                        else ray_test)
            yield self
        finally:
            for m, k, f in saved:
                setattr(m, k, f)

    @contextlib.contextmanager
    def dropped(self):
        """Leave the marked lanes out of the film of every render pass run
        while the context is open (renders of one pass of ``n_lanes``
        lanes, on any device)."""
        from mitsuba3dopplertof_tpu_torch import integrators as pi
        splat = pi.block_splat_wavefront

        def block_splat_wavefront(block, rfilter, x, y, values, active,
                                  *args, **kw):
            if active.shape != self.marked.shape:
                raise ValueError("TieRecorder: renders of one pass only")
            keep = active & ~self.marked.to(active.device)
            return splat(block, rfilter, x, y, values, keep, *args, **kw)

        pi.block_splat_wavefront = block_splat_wavefront
        try:
            yield self
        finally:
            pi.block_splat_wavefront = splat
