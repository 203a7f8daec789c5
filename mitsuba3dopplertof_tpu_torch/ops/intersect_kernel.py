"""Ray queries of the port: the B1 brute-force CUDA kernel
``csrc/intersect_bruteforce.cu`` with its plain PyTorch version, and the
routing of scenes above ``STREAM_THRESHOLD`` triangles to the large-scene
kernels B2-B6.

Port of the JAX package's ``ops/intersect_kernel.py`` (the Pallas kernel
``_build_kernel``, ``intersect_pallas`` and ``ray_test_pallas``) and of its
oracle ``render/scene.py:_hit_reference`` / ``_spheres_reference``. B1
computes, per ray, the closest hit (or any hit) over all static triangles
in world space, every animated instance's triangles in its object space at
the ray's own time, and the analytic unit spheres, with the full payload:
t, slot, instance, barycentrics, world-space geometric and shading normals
and uv.

Entry points (reference scene.cpp:125-167):
  * ``intersect(sa, ray, active)`` — closest hit, full ``HitRecord``
  * ``ray_test(sa, ray, active)``  — boolean any-hit

On the card, scenes of at most ``STREAM_THRESHOLD`` triangles launch B1.
Larger ones take the route that ``MI_STREAM_KERNEL`` names, as in the JAX
package (``intersect_pallas`` / ``ray_test_pallas``), over binned rays
(``ops/ray_binning.py``) where binning pays:

  * ``v4`` (the default): B2, ``ops/intersect_v4.py``;
  * ``v3``: B5, ``ops/intersect_v3.py``;
  * ``v2``: B4, ``ops/intersect_v2.py``;
  * ``mxu``: B6, ``ops/intersect_mxu.py``;
  * ``v1`` and any other value: B3, ``ops/intersect_stream.py``.

B2, B4, B5 and B6 return (t, prim) and
``ops/intersect_mxu.payload_from_prim`` rebuilds the hit record; B3
returns the record itself. Every route merges the spheres-only pass of B1
by closest t. A CUDA tensor launches the kernels or raises. A tensor on
the CPU takes the plain Möller intersector (``intersect_reference`` /
``ray_test_reference``) at every scene size, as the JAX package on the CPU
takes ``_hit_reference``; with ``MI_STREAM_KERNEL`` set to one of the
alternates, a large scene on the CPU goes through the same routing with
that kernel's plain version. ``LAUNCHES`` counts B1 launches (all forms),
``LAUNCHES_BY_FORM`` per form.
"""

from __future__ import annotations

import ctypes
import os
from typing import NamedTuple

import torch

from ..core.vec import (Vec3, cross, dot, where3, cmat_lerp, cmat_inverse,
                        cmat_apply_point, cmat_apply_vector,
                        cmat_apply_transpose_vector, spherical_uv)
from ..render.types import Ray
from .cuda_build import CudaLibrary

INST_REC = 26                 # m0 (3x4), m1 (3x4), t0, t1
_SPH_SLOT_BASE = 1 << 28      # prim slots >= this are analytic spheres

# above this total triangle count (static + animated) the card routes
# triangles to the large-scene kernel B2 (JAX ops/intersect_kernel.py:427)
STREAM_THRESHOLD = 192

# lanes x triangles per chunk of the plain scan (elements of one (N, C)
# temporary)
_SCAN_ELEMS = 1 << 24

LAUNCHES = 0
LAUNCHES_BY_FORM = {"closest_hit": 0, "any_hit": 0}


class HitRecord(NamedTuple):
    t: torch.Tensor        # (N,) inf on miss
    prim: torch.Tensor     # (N,) int32 global triangle slot (-1 miss)
    inst: torch.Tensor     # (N,) int32 instance id (-1 miss)
    u: torch.Tensor
    v: torch.Tensor
    gnx: torch.Tensor      # geometric normal, world space, unnormalized
    gny: torch.Tensor
    gnz: torch.Tensor
    nsx: torch.Tensor      # shading normal, world space, unnormalized
    nsy: torch.Tensor
    nsz: torch.Tensor
    uv_u: torch.Tensor
    uv_v: torch.Tensor


def reset_launch_counts():
    global LAUNCHES
    LAUNCHES = 0
    for k in LAUNCHES_BY_FORM:
        LAUNCHES_BY_FORM[k] = 0


def is_large(sa) -> bool:
    return sa.n_static_tris + sa.n_anim_tris > STREAM_THRESHOLD


def stream_kernel() -> str:
    """The large-scene route (MI_STREAM_KERNEL, JAX ``_kernel_choice``):
    "v4" (B2, the default), "v3" (B5), "v2" (B4), "mxu" (B6); "v1" and any
    other value select the streamed kernel B3."""
    choice = os.environ.get("MI_STREAM_KERNEL", "v4")
    if choice == "v4" and os.environ.get("MI_V4_ROUNDS", "1") != "1":
        raise NotImplementedError(
            "MI_V4_ROUNDS=lite|2: the two-round forms of B2 are not ported "
            "(ROADMAP Queue A item 8); unset it for the single walk")
    return choice if choice in ("v4", "v3", "v2", "mxu") else "v1"


# ---------------------------------------------------------------------------
# Plain version: the port of _hit_reference + _spheres_reference
# ---------------------------------------------------------------------------

_GEOM = ("v0x", "v0y", "v0z", "e1x", "e1y", "e1z", "e2x", "e2y", "e2z")
# a triangle record's columns, in the kernel's table order
_TRI_NAMES = _GEOM + ("n0x", "n0y", "n0z", "n1x", "n1y", "n1z",
                      "n2x", "n2y", "n2z", "uv0u", "uv0v", "uv1u", "uv1v",
                      "uv2u", "uv2v", "inst")


def _moller(o: Vec3, d: Vec3, maxt, cols, c0: int, c1: int):
    """Möller-Trumbore of every lane against triangles [c0, c1), in the
    kernels' order of operations: (hit, t), (N, c1 - c0) each; a hit is
    any t in (0, maxt). ``o``, ``d``, ``maxt``: (N, 1) columns; ``cols``:
    per-column (T,) tensors."""
    return _moller_geom(o, d, maxt, [cols[c][None, c0:c1] for c in _GEOM])


def _moller_geom(o: Vec3, d: Vec3, maxt, geom):
    """``_moller`` on the nine columns ``geom`` (v0 e1 e2), any tensors
    that broadcast against ``o``, ``d`` and ``maxt``."""
    ox, oy, oz = o
    dx, dy, dz = d
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = geom
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    ok = torch.abs(det) > 1e-12
    inv_det = 1.0 / torch.where(ok, det, 1.0)
    tx = ox - v0x
    ty = oy - v0y
    tz = oz - v0z
    u = (tx * px + ty * py + tz * pz) * inv_det
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv_det
    t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    hit = (ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
           & (t > 0.0) & (t < maxt))
    return hit, t


def _columns(o: Vec3, d: Vec3, maxt):
    return (Vec3(o.x[:, None], o.y[:, None], o.z[:, None]),
            Vec3(d.x[:, None], d.y[:, None], d.z[:, None]), maxt[:, None])


def _scan(o: Vec3, d: Vec3, maxt, cols, start: int, count: int, best_t,
          best_idx):
    """Möller-Trumbore over triangles [start, start + count) against all
    lanes, a chunk of triangles at a time ((N, C) tensors). Within a chunk
    the first index of the smallest t wins, across chunks strict
    ``t < best``: the first slot on ties, as the JAX package's sequential
    ``_intersect_scan``. ``cols``: per-column (T,) tensors."""
    n = o.x.shape[0]
    step = max(1, min(count, _SCAN_ELEMS // max(n, 1)))
    oc, dc, mt = _columns(o, d, maxt)
    for c0 in range(start, start + count, step):
        c1 = min(c0 + step, start + count)
        hit, t = _moller(oc, dc, mt, cols, c0, c1)
        tm = torch.where(hit, t, float("inf"))
        k = torch.argmin(tm, dim=1)
        tk = torch.gather(tm, 1, k[:, None])[:, 0]
        take = tk < best_t
        best_t = torch.where(take, tk, best_t)
        best_idx = torch.where(take, (k + c0).to(torch.int32), best_idx)
    return best_t, best_idx


def _lerped_matrix(m0c, m1c, t0, t1, time, k: int):
    """Clamped keyframe lerp of column ``k`` of the (12, K) matrix tables
    at each lane's time (reference transform.h:458-466)."""
    span = t1[k] - t0[k]
    denom = torch.where(span != 0.0, span, 1.0)
    u = torch.clamp((time - t0[k]) / denom, 0.0, 1.0)
    return cmat_lerp(tuple(m0c[j, k] for j in range(12)),
                     tuple(m1c[j, k] for j in range(12)), u)


def _inv_lerped(mc0, mc1, tw0, tw1, time):
    """Per-lane inverse of the clamped keyframe lerp of two 3x4 matrices
    (JAX ops/intersect_kernel.py:68, reference transform.h:458-466), in
    the kernels' order of operations. Returns (inv3x3 9-tuple, inv_t
    3-tuple)."""
    span = tw1 - tw0
    denom = torch.where(span != 0.0, span, 1.0)
    uu = torch.clamp((time - tw0) / denom, 0.0, 1.0)
    c = [m0 * (1.0 - uu) + m1 * uu for m0, m1 in zip(mc0, mc1)]
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
    i = (c00 * inv, c01 * inv, c02 * inv, c10 * inv, c11 * inv, c12 * inv,
         c20 * inv, c21 * inv, c22 * inv)
    nt0 = -(i[0] * t0 + i[1] * t1 + i[2] * t2)
    nt1 = -(i[3] * t0 + i[4] * t1 + i[5] * t2)
    nt2 = -(i[6] * t0 + i[7] * t1 + i[8] * t2)
    return i, (nt0, nt1, nt2)


def _miss_record(n: int, dev) -> HitRecord:
    z = torch.zeros((n,), device=dev)
    m1 = torch.full((n,), -1, dtype=torch.int32, device=dev)
    return HitRecord(torch.full((n,), float("inf"), device=dev), m1, m1,
                     *([z] * 10))


def _sphere_test(sa, ray: Ray, s: int):
    """The unit sphere of sphere ``s`` in its object space (reference
    src/shapes/sphere.cpp): (hit, t, o, d, inv) per lane, a hit being any
    t in (0, maxt); o, d the object-space ray, inv the inverse matrix."""
    if sa.sphere_animated[s]:
        c_t = _lerped_matrix(sa.sph_m0c, sa.sph_m1c, sa.sph_t0,
                             sa.sph_t1, ray.time, s)
    else:
        c_t = tuple(sa.sph_m0c[j, s] for j in range(12))
    inv = cmat_inverse(c_t)
    o = cmat_apply_point(inv, ray.o)
    d = cmat_apply_vector(inv, ray.d)
    a = dot(d, d)
    b = 2.0 * dot(o, d)
    c = dot(o, o) - 1.0
    disc = b * b - 4.0 * a * c
    ok = disc >= 0.0
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    q = -0.5 * (b + torch.where(b >= 0.0, sq, -sq))
    t0 = q / torch.where(a != 0.0, a, 1.0)
    t1 = c / torch.where(q != 0.0, q, 1.0)
    tn = torch.minimum(t0, t1)
    tf = torch.maximum(t0, t1)
    t = torch.where(tn > 0.0, tn, tf)
    return ok & (t > 0.0) & (t < ray.maxt), t, o, d, inv


def _spheres_reference(sa, ray: Ray, hit: HitRecord) -> HitRecord:
    """Analytic spheres: the unit sphere in object space (reference
    src/shapes/sphere.cpp)."""
    out = hit
    for s in range(sa.n_spheres):
        ok, t, o, d, inv = _sphere_test(sa, ray, s)
        hit_m = ok & (t < out.t)
        pn = o + d * t                 # object-space normal = hit point
        wn = cmat_apply_transpose_vector(inv, pn)
        u, v = spherical_uv(pn)
        zero = torch.zeros_like(u)
        out = HitRecord(*(torch.where(hit_m, new, old) for new, old in zip(
            (t, torch.full_like(out.prim, _SPH_SLOT_BASE + s),
             sa.sph_inst[s].expand_as(out.inst), zero, zero,
             wn.x, wn.y, wn.z, wn.x, wn.y, wn.z, u, v), out)))
    return out


def _slot_payload(g, o_hit: Vec3, d_hit: Vec3):
    """(u, v, geometric normal, shading normal, uv_u, uv_v) of triangle
    columns ``g`` against the ray (o_hit, d_hit) in its hit space: the
    Möller barycentrics and the interpolated attributes."""
    v0 = Vec3(g["v0x"], g["v0y"], g["v0z"])
    e1 = Vec3(g["e1x"], g["e1y"], g["e1z"])
    e2 = Vec3(g["e2x"], g["e2y"], g["e2z"])
    pv = cross(d_hit, e2)
    det = dot(e1, pv)
    inv_det = 1.0 / torch.where(torch.abs(det) > 1e-12, det, 1.0)
    tv = o_hit - v0
    u = dot(tv, pv) * inv_det
    qv = cross(tv, e1)
    v = dot(d_hit, qv) * inv_det
    w = 1.0 - u - v
    gn = cross(e1, e2)
    ns = Vec3(w * g["n0x"] + u * g["n1x"] + v * g["n2x"],
              w * g["n0y"] + u * g["n1y"] + v * g["n2y"],
              w * g["n0z"] + u * g["n1z"] + v * g["n2z"])
    uv_u = w * g["uv0u"] + u * g["uv1u"] + v * g["uv2u"]
    uv_v = w * g["uv0v"] + u * g["uv1v"] + v * g["uv2v"]
    return u, v, gn, ns, uv_u, uv_v


def with_plain_miss_payload(sa, ray: Ray, hit: HitRecord) -> HitRecord:
    """``hit`` with the payload of its missed lanes (prim < 0) replaced by
    what the plain version gives them: the first static triangle slot's
    barycentrics against the ray and its interpolated normals and uv, and
    instance -1. The kernels leave their own values on those lanes; this
    makes every route agree with the plain version (and the JAX package)
    where a caller reads the payload of a miss."""
    n = ray.o.x.shape[0]
    g = {c: sa.tri("s", c)[0].expand(n) for c in _TRI_NAMES
         if c not in ("inst", "prim")}
    u, v, gn, ns, uv_u, uv_v = _slot_payload(g, ray.o, ray.d)
    miss = hit.prim < 0
    new = dict(u=u, v=v, gnx=gn.x, gny=gn.y, gnz=gn.z, nsx=ns.x, nsy=ns.y,
               nsz=ns.z, uv_u=uv_u, uv_v=uv_v,
               inst=torch.full_like(hit.inst, -1))
    return hit._replace(**{k: torch.where(miss, val, getattr(hit, k))
                           for k, val in new.items()})


def intersect_reference(sa, ray: Ray) -> HitRecord:
    """Plain closest hit with the full payload (the port of the JAX
    package's ``_hit_reference``): scanned brute force, then the winner's
    payload gathered and recomputed in its hit space."""
    n = ray.o.x.shape[0]
    dev = ray.o.x.device
    best_t = torch.full((n,), float("inf"), device=dev)
    best_idx = torch.full((n,), -1, dtype=torch.int32, device=dev)
    s_cols = {c: sa.tri("s", c) for c in _GEOM}
    a_cols = {c: sa.tri("a", c) for c in _GEOM}

    if sa.n_static_tris > 0:
        best_t, best_idx = _scan(ray.o, ray.d, ray.maxt, s_cols, 0,
                                 sa.n_static_tris, best_t, best_idx)

    o_objs = {}
    is_anim = torch.zeros((n,), dtype=torch.bool, device=dev)
    for (inst, start, count) in sa.anim_ranges:
        c_t = _lerped_matrix(sa.inst_m0c, sa.inst_m1c, sa.inst_t0,
                             sa.inst_t1, ray.time, inst)
        inv = cmat_inverse(c_t)
        o_obj = cmat_apply_point(inv, ray.o)
        d_obj = cmat_apply_vector(inv, ray.d)
        o_objs[inst] = (o_obj, d_obj)
        t_a, i_a = _scan(o_obj, d_obj, ray.maxt, a_cols, start, count,
                         best_t, torch.full_like(best_idx, -1))
        took = i_a >= 0
        # global slot convention: [0, n_static) static, then animated
        best_idx = torch.where(took, i_a + sa.n_static_tris, best_idx)
        best_t = torch.where(took, t_a, best_t)
        is_anim = is_anim | took

    idx_s = torch.clamp(best_idx, 0, sa.s_inst.shape[0] - 1).long()
    idx_a = torch.clamp(best_idx - sa.n_static_tris, 0,
                        sa.a_inst.shape[0] - 1).long()
    g = {c: torch.where(is_anim, sa.tri("a", c)[idx_a], sa.tri("s", c)[idx_s])
         for c in _TRI_NAMES}

    o_hit, d_hit = ray.o, ray.d
    for (inst, start, count) in sa.anim_ranges:
        o_obj, d_obj = o_objs[inst]
        m = is_anim & (g["inst"] == inst)
        o_hit = where3(m, o_obj, o_hit)
        d_hit = where3(m, d_obj, d_hit)

    u, v, gn, ns, uv_u, uv_v = _slot_payload(g, o_hit, d_hit)

    # animated hits: normals to world by the lerped matrix's inverse
    # transpose at the ray's time
    if sa.anim_ranges:
        inst_id = torch.clamp(g["inst"], min=0).long()
        span = sa.inst_t1[inst_id] - sa.inst_t0[inst_id]
        uu = torch.clamp((ray.time - sa.inst_t0[inst_id])
                         / torch.where(span != 0.0, span, 1.0), 0.0, 1.0)
        c_t = cmat_lerp(tuple(sa.inst_m0c[j][inst_id] for j in range(12)),
                        tuple(sa.inst_m1c[j][inst_id] for j in range(12)),
                        uu)
        inv_t = cmat_inverse(c_t)
        gn = where3(is_anim, cmat_apply_transpose_vector(inv_t, gn), gn)
        ns = where3(is_anim, cmat_apply_transpose_vector(inv_t, ns), ns)

    inst_out = torch.where(best_idx >= 0, g["inst"], -1)
    hit = HitRecord(best_t, best_idx, inst_out, u, v,
                    gn.x, gn.y, gn.z, ns.x, ns.y, ns.z, uv_u, uv_v)
    if sa.n_spheres:
        hit = _spheres_reference(sa, ray, hit)
    return hit


def ray_test_reference(sa, ray: Ray):
    """Plain occlusion flag: whether any triangle or sphere is hit in
    (0, maxt). Equal to ``intersect_reference(sa, ray).prim >= 0``."""
    return intersect_reference(sa, ray).prim >= 0


# ---------------------------------------------------------------------------
# The CUDA kernel: build, load, launch
# ---------------------------------------------------------------------------

def _bind(lib):
    fn = lib.mi_intersect_bruteforce
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                   + [ctypes.c_float]
                   + [ctypes.c_void_p] * 8 + [ctypes.c_longlong, ctypes.c_int]
                   + [ctypes.c_void_p] * 3)


LIBRARY = CudaLibrary("intersect_bruteforce", _bind)


def scene_tables(sa):
    """The kernel's tables, cached on the SceneArrays: triangle records
    (T, 25) f32 in slot order, animated-instance records (A, 26) f32 with
    their (inst, start, count) ints (A, 3), sphere records (S, 27) f32 with
    their animated flags (S,) int32."""
    if sa._tables is not None:
        return sa._tables
    dev = sa.device

    def tri_table(prefix, n):
        cols = [sa.tri(prefix, c)[:n] for c in _TRI_NAMES[:-1]]
        cols.append(sa.tri(prefix, "inst")[:n].to(torch.float32))
        return torch.stack(cols, dim=-1)

    tri = torch.cat([tri_table("s", sa.n_static_tris),
                     tri_table("a", sa.n_anim_tris)], dim=0)
    ranges = list(sa.anim_ranges)
    inst = torch.stack([torch.cat([
        sa.inst_m0c[:, i], sa.inst_m1c[:, i], sa.inst_t0[i:i + 1],
        sa.inst_t1[i:i + 1]]) for i, _, _ in ranges]) if ranges else \
        torch.zeros((0, INST_REC), device=dev)
    anim = torch.tensor(ranges, dtype=torch.int32,
                        device=dev).reshape(-1, 3)
    ns = sa.n_spheres
    sph = torch.cat([sa.sph_m0c.T, sa.sph_m1c.T, sa.sph_t0[:, None],
                     sa.sph_t1[:, None], sa.sph_inst[:, None].float()],
                    dim=1)[:ns]
    sph_anim = torch.tensor([int(a) for a in sa.sphere_animated],
                            dtype=torch.int32, device=dev)
    sa._tables = tuple(x.contiguous() for x in (tri, inst, anim, sph,
                                                sph_anim))
    return sa._tables


# ---------------------------------------------------------------------------
# B1's warp gate: conservative boxes per slot and the gate's plain version
# ---------------------------------------------------------------------------

# Box pads, so that float rounding never culls a slot the exact test
# accepts: each table box grows by GATE_TABLE_PAD * (1 + the largest
# |coordinate| of the boxes), and each warp's gate by GATE_ORIGIN_PAD * its
# largest |origin|. Both are orders of magnitude above the rounding of the
# slab and Möller arithmetic (a few float32 ulps of those magnitudes).
GATE_TABLE_PAD = 1e-4
GATE_ORIGIN_PAD = 1e-5
_BIG = 3.0e38


def gate_boxes(sa):
    """B1's gate boxes, cached: (6, T_s + A + S) float32, rows lo xyz and hi
    xyz, columns the static triangles (world boxes), the animated ranges
    (the swept world box of the instance: its triangles' boxes at both
    keyframes, which hold every lerped position) and the spheres (the world
    box of the unit sphere under each keyframe matrix; the first only for a
    sphere that does not move), padded by ``GATE_TABLE_PAD``."""
    box = sa._cache.get("b1_gate_boxes")
    if box is not None:
        return box
    tri, inst, anim, sph, sph_anim = scene_tables(sa)
    ns = sa.n_static_tris
    g = tri[:, :9].to(torch.float64)
    verts = torch.stack([g[:, 0:3], g[:, 0:3] + g[:, 3:6],
                         g[:, 0:3] + g[:, 6:9]], dim=1)        # (T, 3, 3)
    lo, hi = [verts[:ns].amin(1)], [verts[:ns].amax(1)]
    for a, (_, start, count) in enumerate(anim.tolist()):
        m = inst[a, :24].to(torch.float64).reshape(2, 3, 4)
        pts = verts[ns + start:ns + start + count].reshape(-1, 3)
        w = (torch.einsum("kij,vj->kvi", m[:, :, :3], pts)
             + m[:, None, :, 3]).reshape(-1, 3)
        lo.append(w.amin(0, keepdim=True))
        hi.append(w.amax(0, keepdim=True))
    for s in range(sph.shape[0]):
        m = sph[s, :24 if int(sph_anim[s]) else 12].to(
            torch.float64).reshape(-1, 3, 4)
        half = torch.sqrt((m[:, :, :3] ** 2).sum(-1))
        lo.append((m[:, :, 3] - half).amin(0, keepdim=True))
        hi.append((m[:, :, 3] + half).amax(0, keepdim=True))
    lo, hi = torch.cat(lo), torch.cat(hi)
    scale = float(torch.cat([lo.abs(), hi.abs()]).max()) if lo.numel() \
        else 0.0
    pad = GATE_TABLE_PAD * (1.0 + scale)
    box = torch.cat([lo - pad, hi + pad], dim=1).T.to(
        torch.float32).contiguous()
    sa._cache["b1_gate_boxes"] = box
    return box


class WarpMasks(NamedTuple):
    slots: torch.Tensor       # (W, T + S) bool: the warp tests this slot
    ranges: torch.Tensor      # (W, A) bool: it reaches this instance
    culls: torch.Tensor       # (W,) bool: its gate runs slab tests


def _warp_bounds(o, d, maxt, live):
    """A warp's ray bounds as the kernel's ``warp_bounds`` computes them;
    every argument (W, 32). Lanes that cannot hit (``live`` false) stay
    out; a direction axis is bounded if its component is beyond ±1e-12 on
    every live lane; NaN origins stay out, as fminf/fmaxf skip them."""
    def wmin(x):
        return torch.where(live & ~torch.isnan(x), x, float("inf")).amin(1)

    def wmax(x):
        return torch.where(live & ~torch.isnan(x), x, -float("inf")).amax(1)

    same, ia, ib, ol, oh = [], [], [], [], []
    omax = torch.zeros_like(maxt[:, 0])
    for dc, oc in zip(d, o):
        dl, dh = wmin(dc), wmax(dc)
        # beyond ±1e-12 on every live lane (a NaN component never is)
        sm = ((~live | (dc > 1e-12)).all(1)
              | (~live | (dc < -1e-12)).all(1))
        same.append(sm)
        ia.append(1.0 / torch.where(sm, dl, 1.0))
        ib.append(1.0 / torch.where(sm, dh, 1.0))
        ol.append(wmin(oc))
        oh.append(wmax(oc))
        omax = torch.maximum(omax, torch.maximum(ol[-1].abs(),
                                                 oh[-1].abs()))
    # a warp whose directions straddle zero on two axes or three runs no
    # slab tests: every slot passes
    return dict(same=same, ia=ia, ib=ib, ol=ol, oh=oh,
                culls=(same[0].int() + same[1].int() + same[2].int()) >= 2,
                t_hi=torch.clamp(wmax(maxt), max=_BIG),
                pad=GATE_ORIGIN_PAD * omax, live=live.any(1))


def _gate_pass(g, box, c0: int, c1: int):
    """(W, c1 - c0) bool: may a ray of the warp enter box column c of
    ``box`` at a distance in [0, t_hi] (the kernel's ``box_pass``); every
    box passes where the gate cannot cull, none where no lane is live."""
    pad = g["pad"][:, None]
    t_lo = torch.zeros((pad.shape[0], c1 - c0), device=box.device)
    t_hi = g["t_hi"][:, None].expand_as(t_lo)
    for ax in range(3):
        bmin = box[ax, None, c0:c1] - pad
        bmax = box[3 + ax, None, c0:c1] + pad
        ol, oh = g["ol"][ax][:, None], g["oh"][ax][:, None]
        ia, ib = g["ia"][ax][:, None], g["ib"][ax][:, None]
        vals = [n * r for n in (bmin - ol, bmin - oh, bmax - ol, bmax - oh)
                for r in (ia, ib)]
        lo = torch.stack(vals).amin(0)
        hi = torch.stack(vals).amax(0)
        sm = g["same"][ax][:, None]
        t_lo = torch.where(sm, torch.maximum(t_lo, lo), t_lo)
        t_hi = torch.where(sm, torch.minimum(t_hi, hi), t_hi)
    return (((t_lo <= t_hi) | ~g["culls"][:, None])
            & g["live"][:, None])


def b1_warp_masks(sa, ray: Ray) -> WarpMasks:
    """The plain version of B1's gate: per 32-lane warp (lanes in order,
    the last warp padded with dead lanes), the slots its gate passes (an
    animated range's triangles all of them, where its swept box passes),
    the instances whose inverse it computes, and whether it runs slab
    tests. The kernel tests these slots, and all of a round of 32 where
    most pass; the any-hit form stops once every lane is occluded. For
    tests and measurement; the kernel never calls it."""
    n = ray.o.x.shape[0]
    w = -(-n // 32)

    def lanes(x, fill):
        return torch.cat([x, x.new_full((w * 32 - n,), fill)]).reshape(w, 32)

    maxt = lanes(ray.maxt, -1.0)
    live = maxt > 0.0
    g = _warp_bounds([lanes(c, 0.0) for c in ray.o],
                     [lanes(c, 0.0) for c in ray.d], maxt, live)
    gate = _gate_pass(g, gate_boxes(sa), 0, gate_boxes(sa).shape[1])
    ns = sa.n_static_tris
    na = len(sa.anim_ranges)
    ranges = gate[:, ns:ns + na]
    anim = [ranges[:, a, None].expand(w, count)
            for a, (_, _, count) in enumerate(sa.anim_ranges)]
    return WarpMasks(torch.cat([gate[:, :ns], *anim, gate[:, ns + na:]],
                               dim=1), ranges, g["culls"] & g["live"])


def slot_hits(sa, ray: Ray):
    """(N, T + S) bool: whether each lane's exact test accepts each
    triangle slot and sphere (any t in (0, maxt), not only the closest), in
    the plain version's arithmetic. Every slot set here must be set in the
    lane's warp mask (``b1_warp_masks``)."""
    s_cols = {c: sa.tri("s", c) for c in _GEOM}
    a_cols = {c: sa.tri("a", c) for c in _GEOM}
    out = [_moller(*_columns(ray.o, ray.d, ray.maxt), s_cols, 0,
                   sa.n_static_tris)[0]]
    for (inst, start, count) in sa.anim_ranges:
        inv = cmat_inverse(_lerped_matrix(sa.inst_m0c, sa.inst_m1c,
                                          sa.inst_t0, sa.inst_t1, ray.time,
                                          inst))
        cols = _columns(cmat_apply_point(inv, ray.o),
                        cmat_apply_vector(inv, ray.d), ray.maxt)
        out.append(_moller(*cols, a_cols, start, start + count)[0])
    out += [_sphere_test(sa, ray, s)[0][:, None]
            for s in range(sa.n_spheres)]
    return torch.cat(out, dim=1)


def _check_rays(ray: Ray):
    comps = (ray.o.x, ray.o.y, ray.o.z, ray.d.x, ray.d.y, ray.d.z,
             ray.time, ray.maxt)
    n = comps[0].shape[0]
    for c in comps:
        if (c.dtype != torch.float32 or c.dim() != 1 or c.shape[0] != n
                or not c.is_contiguous() or c.device != comps[0].device):
            raise ValueError(
                "intersect kernel: ray components must be contiguous "
                f"(N,) float32 tensors on one device; got {c.dtype} "
                f"{tuple(c.shape)} on {c.device}")
    return comps, n


def _launch(sa, ray: Ray, any_hit: bool, spheres_only: bool = False):
    """One launch of B1. ``spheres_only``: the analytic spheres alone (the
    pass merged into large-scene hits, JAX ops/intersect_kernel.py:403)."""
    global LAUNCHES
    comps, n = _check_rays(ray)
    dev = comps[0].device
    if dev.type != "cuda":
        raise ValueError(f"intersect kernel: rays on {dev}, need CUDA")
    if sa.device != dev:
        raise ValueError(f"intersect kernel: scene tables on {sa.device}, "
                         f"rays on {dev}")
    lib = LIBRARY.load()
    tri, inst, anim, sph, sph_anim = scene_tables(sa)
    box = gate_boxes(sa)
    n_tri, n_static, n_anim = ((0, 0, 0) if spheres_only else
                               (tri.shape[0], sa.n_static_tris,
                                inst.shape[0]))
    if any_hit:
        outf = torch.empty((0,), device=dev)
        outi = torch.empty((1, n), dtype=torch.int32, device=dev)
    else:
        outf = torch.empty((11, n), device=dev)
        outi = torch.empty((2, n), dtype=torch.int32, device=dev)
    if n > 0:
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.mi_intersect_bruteforce(
                tri.data_ptr(), inst.data_ptr(), anim.data_ptr(),
                sph.data_ptr(), sph_anim.data_ptr(), box.data_ptr(),
                n_tri, n_static, n_anim, sph.shape[0], box.shape[1],
                box.shape[1] - sph.shape[0] if spheres_only else 0,
                GATE_ORIGIN_PAD, *(c.data_ptr() for c in comps), n,
                int(any_hit),
                outf.data_ptr(), outi.data_ptr(), stream)
        if err != 0:
            raise RuntimeError(f"intersect kernel launch failed: CUDA "
                               f"error {err}")
        LAUNCHES += 1
        LAUNCHES_BY_FORM["any_hit" if any_hit else "closest_hit"] += 1
    if any_hit:
        return outi[0] != 0
    t, u, v, gx, gy, gz, nx, ny, nz, uu, vv = outf
    return HitRecord(t, outi[0], outi[1], u, v, gx, gy, gz, nx, ny, nz,
                     uu, vv)


# ---------------------------------------------------------------------------
# Large scenes: B2-B6 + binning + payload, merged with the spheres-only pass
# ---------------------------------------------------------------------------

def _spheres_pass(sa, ray: Ray, any_hit: bool):
    """The analytic spheres alone: B1 with zero triangles on the card, its
    plain version on the CPU."""
    if ray.o.x.device.type == "cuda":
        return _launch(sa, ray, any_hit, spheres_only=True)
    hit = _spheres_reference(sa, ray, _miss_record(ray.o.x.shape[0],
                                                   ray.o.x.device))
    return hit.prim >= 0 if any_hit else hit


def _route_kernel(choice: str):
    """(query function, lanes per block) of a large-scene route."""
    if choice == "v4":
        from .intersect_v4 import BLOCK, intersect_v4 as isect
    elif choice == "v3":
        from .intersect_v3 import BLOCK, intersect_v3 as isect
    elif choice == "v2":
        from .intersect_v2 import BLOCK, intersect_v2 as isect
    elif choice == "mxu":
        from .intersect_mxu import BLOCK, intersect_mxu as isect
    else:
        from .intersect_stream import BLOCK, intersect_stream as isect
    return isect, BLOCK


def _large_query(sa, ray: Ray, active, any_hit: bool, choice: str):
    """The route's kernel over binned rays where binning pays (JAX
    intersect_pallas:454-498): (t, prim), or B3's closest-hit record."""
    from .ray_binning import binned, should_bin
    isect, block = _route_kernel(choice)
    if should_bin(sa, ray.o.x.shape[0], block):
        return binned(sa, ray, active,
                      lambda r: list(isect(sa, r, any_hit=any_hit)))
    return isect(sa, ray, any_hit=any_hit)


def intersect_large(sa, ray: Ray, active=None) -> HitRecord:
    """Closest hit of a scene above ``STREAM_THRESHOLD`` triangles through
    the route ``MI_STREAM_KERNEL`` names, as the card computes it (plain
    versions on the CPU)."""
    from .intersect_mxu import payload_from_prim
    choice = stream_kernel()
    out = _large_query(sa, ray, active, False, choice)
    hit_s = (HitRecord(*out) if choice == "v1"
             else payload_from_prim(sa, ray, *out))
    if sa.n_spheres == 0:
        return hit_s
    hit_d = _spheres_pass(sa, ray, any_hit=False)
    take_d = hit_d.t < hit_s.t
    return HitRecord(*(torch.where(take_d, d, s_)
                       for d, s_ in zip(hit_d, hit_s)))


def ray_test_large(sa, ray: Ray, active=None):
    """Occlusion in a scene above ``STREAM_THRESHOLD`` triangles through
    the route ``MI_STREAM_KERNEL`` names, as the card computes it (plain
    versions on the CPU)."""
    occ = _large_query(sa, ray, active, True, stream_kernel())[1] >= 0
    if sa.n_spheres > 0:
        occ = occ | _spheres_pass(sa, ray, any_hit=True)
    return occ


def _cpu_takes_moller(large: bool) -> bool:
    """On the CPU the default route is the plain Möller intersector; an
    alternate value of MI_STREAM_KERNEL sends a large scene through the
    routing with that kernel's plain version."""
    return not large or stream_kernel() == "v4"


def intersect(sa, ray: Ray, active=None) -> HitRecord:
    """Closest hit with the full payload: the plain version for CPU
    tensors; on the card B1, or above ``STREAM_THRESHOLD`` triangles the
    large-scene route that MI_STREAM_KERNEL names.
    ``active`` (optional) only deadens lanes for binning; callers mask
    the result themselves."""
    _check_rays(ray)
    large = is_large(sa)
    if ray.o.x.device.type == "cpu" and _cpu_takes_moller(large):
        return intersect_reference(sa, ray)
    if large:
        return intersect_large(sa, ray, active)
    return _launch(sa, ray, any_hit=False)


def ray_test(sa, ray: Ray, active=None):
    """Occlusion flag: the plain version for CPU tensors; on the card the
    any-hit form of B1 or of the large-scene route."""
    _check_rays(ray)
    large = is_large(sa)
    if ray.o.x.device.type == "cpu" and _cpu_takes_moller(large):
        return ray_test_reference(sa, ray)
    if large:
        return ray_test_large(sa, ray, active)
    return _launch(sa, ray, any_hit=True)


__all__ = ["HitRecord", "intersect", "ray_test", "intersect_reference",
           "with_plain_miss_payload",
           "ray_test_reference", "intersect_large", "ray_test_large",
           "scene_tables", "gate_boxes", "b1_warp_masks", "slot_hits",
           "WarpMasks", "LIBRARY", "LAUNCHES",
           "LAUNCHES_BY_FORM", "STREAM_THRESHOLD"]
