"""Brute-force ray intersection for scenes of at most 192 triangles: the
CUDA kernel ``csrc/intersect_bruteforce.cu`` and its plain PyTorch version.

Port of the JAX package's ``ops/intersect_kernel.py`` (the Pallas kernel
``_build_kernel``) and of its oracle ``render/scene.py:_hit_reference`` /
``_spheres_reference``. Both forms compute, per ray, the closest hit (or
any hit) over all static triangles in world space, every animated
instance's triangles in its object space at the ray's own time, and the
analytic unit spheres, with the full payload: t, slot, instance,
barycentrics, world-space geometric and shading normals and uv.

Entry points (reference scene.cpp:125-167):
  * ``intersect(sa, ray)`` — closest hit, full ``HitRecord``
  * ``ray_test(sa, ray)``  — boolean any-hit

A tensor on the CPU takes the plain version (``intersect_reference`` /
``ray_test_reference``); a CUDA tensor launches the kernel or raises.
``LAUNCHES`` counts kernel launches (all forms), ``LAUNCHES_BY_FORM`` per
form.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
import tempfile
import time as _time
from pathlib import Path
from typing import NamedTuple

import torch

from ..core.vec import (Vec3, cross, dot, where3, cmat_lerp, cmat_inverse,
                        cmat_apply_point, cmat_apply_vector,
                        cmat_apply_transpose_vector)
from ..render.types import Ray

INST_REC = 26                 # m0 (3x4), m1 (3x4), t0, t1
_SPH_SLOT_BASE = 1 << 28      # prim slots >= this are analytic spheres

# above this total triangle count the JAX package streams triangles
# through its large-scene kernels, which the port does not have yet
STREAM_THRESHOLD = 192

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


def _check_scene(sa):
    if sa.n_static_tris + sa.n_anim_tris > STREAM_THRESHOLD:
        raise NotImplementedError("large-scene kernel: ROADMAP B2")


# ---------------------------------------------------------------------------
# Plain version: the port of _hit_reference + _spheres_reference
# ---------------------------------------------------------------------------

_GEOM = ("v0x", "v0y", "v0z", "e1x", "e1y", "e1z", "e2x", "e2y", "e2z")
# a triangle record's columns, in the kernel's table order
_TRI_NAMES = _GEOM + ("n0x", "n0y", "n0z", "n1x", "n1y", "n1z",
                      "n2x", "n2y", "n2z", "uv0u", "uv0v", "uv1u", "uv1v",
                      "uv2u", "uv2v", "inst")


def _scan(o: Vec3, d: Vec3, maxt, cols, start: int, count: int, best_t,
          best_idx):
    """Möller-Trumbore over triangles [start, start + count), one triangle
    at a time against all lanes; strict ``t < best`` keeps the first slot
    on ties. ``cols``: per-column Python lists of the float32 values."""
    for i in range(start, start + count):
        v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = (cols[c][i]
                                                        for c in _GEOM)
        px = d.y * e2z - d.z * e2y
        py = d.z * e2x - d.x * e2z
        pz = d.x * e2y - d.y * e2x
        det = e1x * px + e1y * py + e1z * pz
        ok = torch.abs(det) > 1e-12
        inv_det = 1.0 / torch.where(ok, det, 1.0)
        tx = o.x - v0x
        ty = o.y - v0y
        tz = o.z - v0z
        u = (tx * px + ty * py + tz * pz) * inv_det
        qx = ty * e1z - tz * e1y
        qy = tz * e1x - tx * e1z
        qz = tx * e1y - ty * e1x
        v = (d.x * qx + d.y * qy + d.z * qz) * inv_det
        t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
        hit = (ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
               & (t > 0.0) & (t < maxt) & (t < best_t))
        best_t = torch.where(hit, t, best_t)
        best_idx = torch.where(hit, i, best_idx)
    return best_t, best_idx


def _lerped_matrix(m0c, m1c, t0, t1, time, k: int):
    """Clamped keyframe lerp of column ``k`` of the (12, K) matrix tables
    at each lane's time (reference transform.h:458-466)."""
    span = t1[k] - t0[k]
    denom = torch.where(span != 0.0, span, 1.0)
    u = torch.clamp((time - t0[k]) / denom, 0.0, 1.0)
    return cmat_lerp(tuple(m0c[j, k] for j in range(12)),
                     tuple(m1c[j, k] for j in range(12)), u)


def _spheres_reference(sa, ray: Ray, hit: HitRecord) -> HitRecord:
    """Analytic spheres: the unit sphere in object space (reference
    src/shapes/sphere.cpp)."""
    out = hit
    for s in range(sa.n_spheres):
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
        hit_m = ok & (t > 0.0) & (t < ray.maxt) & (t < out.t)
        pn = o + d * t                 # object-space normal = hit point
        wn = cmat_apply_transpose_vector(inv, pn)
        u = torch.atan2(pn.y, pn.x) * (0.5 / math.pi)
        u = torch.where(u < 0.0, u + 1.0, u)
        v = torch.acos(torch.clamp(pn.z, -1.0, 1.0)) * (1.0 / math.pi)
        zero = torch.zeros_like(u)
        out = HitRecord(*(torch.where(hit_m, new, old) for new, old in zip(
            (t, torch.full_like(out.prim, _SPH_SLOT_BASE + s),
             sa.sph_inst[s].expand_as(out.inst), zero, zero,
             wn.x, wn.y, wn.z, wn.x, wn.y, wn.z, u, v), out)))
    return out


def intersect_reference(sa, ray: Ray) -> HitRecord:
    """Plain closest hit with the full payload (the port of the JAX
    package's ``_hit_reference``): scanned brute force, then the winner's
    payload gathered and recomputed in its hit space."""
    _check_scene(sa)
    n = ray.o.x.shape[0]
    dev = ray.o.x.device
    best_t = torch.full((n,), float("inf"), device=dev)
    best_idx = torch.full((n,), -1, dtype=torch.int32, device=dev)
    s_cols = {c: sa.tri("s", c).tolist() for c in _GEOM}
    a_cols = {c: sa.tri("a", c).tolist() for c in _GEOM}

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
    v0 = Vec3(g["v0x"], g["v0y"], g["v0z"])
    e1 = Vec3(g["e1x"], g["e1y"], g["e1z"])
    e2 = Vec3(g["e2x"], g["e2y"], g["e2z"])

    o_hit, d_hit = ray.o, ray.d
    for (inst, start, count) in sa.anim_ranges:
        o_obj, d_obj = o_objs[inst]
        m = is_anim & (g["inst"] == inst)
        o_hit = where3(m, o_obj, o_hit)
        d_hit = where3(m, d_obj, d_hit)

    # barycentrics of the winner in its hit space
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

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "intersect_bruteforce.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")
BUILD_LOG = ""                # nvcc's output of the last build (ptxas -v)

_lib = None


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME", "") + "/bin/nvcc",
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                       "build csrc/intersect_bruteforce.cu")


def library_path() -> Path:
    """The built library, keyed by a hash of the source and the flags."""
    h = hashlib.sha256(SOURCE.read_bytes()
                       + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"intersect_bruteforce_{h}.so"


def build() -> float:
    """Compile the kernel if its library is missing and load it. Returns
    the seconds spent compiling (0 when the library existed)."""
    global _lib, BUILD_LOG
    if _lib is not None:
        return 0.0
    so = library_path()
    seconds = 0.0
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        t0 = _time.perf_counter()
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, str(SOURCE)],
                              capture_output=True, text=True)
        seconds = _time.perf_counter() - t0
        BUILD_LOG = proc.stdout + proc.stderr
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed:\n{BUILD_LOG}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    fn = lib.mi_intersect_bruteforce
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                   + [ctypes.c_void_p] * 8 + [ctypes.c_longlong, ctypes.c_int]
                   + [ctypes.c_void_p] * 3)
    _lib = lib
    return seconds


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


def _launch(sa, ray: Ray, any_hit: bool):
    global LAUNCHES
    comps, n = _check_rays(ray)
    dev = comps[0].device
    if dev.type != "cuda":
        raise ValueError(f"intersect kernel: rays on {dev}, need CUDA")
    if sa.device != dev:
        raise ValueError(f"intersect kernel: scene tables on {sa.device}, "
                         f"rays on {dev}")
    build()
    tri, inst, anim, sph, sph_anim = scene_tables(sa)
    if any_hit:
        outf = torch.empty((0,), device=dev)
        outi = torch.empty((1, n), dtype=torch.int32, device=dev)
    else:
        outf = torch.empty((11, n), device=dev)
        outi = torch.empty((2, n), dtype=torch.int32, device=dev)
    if n > 0:
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = _lib.mi_intersect_bruteforce(
                tri.data_ptr(), inst.data_ptr(), anim.data_ptr(),
                sph.data_ptr(), sph_anim.data_ptr(),
                tri.shape[0], sa.n_static_tris, inst.shape[0], sph.shape[0],
                *(c.data_ptr() for c in comps), n, int(any_hit),
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


def intersect(sa, ray: Ray) -> HitRecord:
    """Closest hit with the full payload: the plain version for CPU
    tensors, the CUDA kernel for tensors on the card."""
    _check_scene(sa)
    _check_rays(ray)
    if ray.o.x.device.type == "cpu":
        return intersect_reference(sa, ray)
    return _launch(sa, ray, any_hit=False)


def ray_test(sa, ray: Ray):
    """Occlusion flag: the plain version for CPU tensors, the CUDA kernel
    (any-hit form) for tensors on the card."""
    _check_scene(sa)
    _check_rays(ray)
    if ray.o.x.device.type == "cpu":
        return ray_test_reference(sa, ray)
    return _launch(sa, ray, any_hit=True)


__all__ = ["HitRecord", "intersect", "ray_test", "intersect_reference",
           "ray_test_reference", "scene_tables", "build", "LAUNCHES",
           "LAUNCHES_BY_FORM", "STREAM_THRESHOLD"]
