"""Kernel B6, the chunk visit lists and the payload of the large-scene
kernels (port of the JAX package's ``ops/intersect_mxu.py``: the Pallas
kernel ``_build_mxu_kernel`` with its wrapper ``intersect_mxu``,
``_visit_order``, ``_woop_table``, ``_payload_table`` and
``payload_from_prim``).

B6 (``MI_STREAM_KERNEL=mxu``) writes the ray-triangle test as an affine
map of the ray (Woop's unit-triangle transform): with the ray features
X = [ox oy oz 1 dx dy dz maxt], a 128-triangle chunk is one
(768 x 8) . (8 x lanes) product giving o' and d' of every triangle, then
t = -o'z / d'z, u = o'x + t d'x, v = o'y + t d'y and a min over the chunk.
The TPU kernel runs that product on its matrix unit at the highest
precision. The CUDA kernel ``csrc/intersect_mxu.cu`` runs it on the
tensor cores in TF32 as a conservative gate (``mxu_gate_reference`` is
the gate's plain version), and the exact float32 test, with the
structural zeros of W skipped, only on the pairs that the gate passes;
the plain version writes the product as ordered sums over the eight
features (no ``torch.matmul`` on this route), and the kernel's t equals
it bit for bit. Chunks are walked front to back per block of ``BLOCK``
lanes (``_visit_order``), without a scene-box clamp.

  * ``intersect_mxu(sa, ray, any_hit)`` — the kernel for CUDA tensors, the
    plain version for CPU tensors;
  * ``intersect_mxu_reference(sa, ray, any_hit)`` — the plain version:
    every lane against every chunk, dense;
  * ``mxu_gate_reference(tables, x, time, c0, c1, best)`` — the pairs the
    kernel's tensor-core gate passes to the exact test (for the tests and
    the chip measurements; the main path never calls it).

Both intersectors return (t, prim) in the global slot convention. The
large-scene kernels B2, B4, B5 and B6 return only (t, prim);
``payload_from_prim`` then rebuilds the full hit record of the winner:
one row gather from a per-triangle table plus a dense recompute of
barycentrics at the known hit point, normals and uv (reference
compute_surface_interaction, instance.cpp:155-250). ``LAUNCHES`` /
``LAUNCHES_BY_FORM`` count B6's launches.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..render.types import Ray
from .cuda_build import CudaLibrary
from .intersect_kernel import (HitRecord, _check_rays, _inv_lerped,
                               scene_tables)
from .intersect_stream import (BLOCK, CHUNK, PAD_TO, _check_launch,
                               _chunk_boxes, _chunked_layout, _inst_table,
                               _padded_cols, _runs, _unit_ray)
from .intersect_v3 import _slab_visit_order, _woop_coefficients

T = PAD_TO              # triangles per chunk = one product
SUBS = T // CHUNK       # 32-triangle culling boxes per chunk
GROUPS = T // 8         # groups of 8 triangles: one m16n8k8 row tile pair
_BIG = 3.0e38
# lanes x triangles per chunk of the plain version (elements of one
# (lanes, triangles) temporary) and chunks per step
_REF_ELEMS = 1 << 24
_REF_CHUNKS = 8
# The gate's radius per unit of S M (S = sum_k |w_k| of a component, M the
# largest |feature| it meets) and its slack on t < min(maxt, best):
# csrc/intersect_mxu.cu derives both.
GATE_EPS = 2.0 ** -9
GATE_T_SLACK = 1.0 + 2.0 ** -20
WARP = 32

LAUNCHES = 0
LAUNCHES_BY_FORM = {"closest_hit": 0, "any_hit": 0}


def reset_launch_counts():
    global LAUNCHES
    LAUNCHES = 0
    for k in LAUNCHES_BY_FORM:
        LAUNCHES_BY_FORM[k] = 0


def _visit_order(sub, n_chunks: int, x, blk: int):
    """Per-block front-to-back visit lists over the 128-triangle chunks
    (JAX intersect_mxu.py:300): ``intersect_v3._slab_visit_order`` over
    each chunk's box, the union of its ``SUBS`` 32-triangle boxes ``sub``
    ((SUBS * n_chunks, 6); inverted pad boxes union away)."""
    sb = sub[:SUBS * n_chunks].reshape(n_chunks, SUBS, 6)
    return _slab_visit_order(sb[:, :, :3].amin(dim=1),
                             sb[:, :, 3:].amax(dim=1), x, blk)


def _woop_table(sa, segments, n_chunks: int) -> torch.Tensor:
    """Woop coefficient table, (n_chunks * 8, 768) f32 (JAX
    intersect_mxu.py:379). Row k of a chunk's (8, 768) block holds the
    coefficient of ray feature k for 6 components x 128 triangles,
    component-major: o' = B o + c takes features 0-3, d' = B d features
    4-6, feature 7 (maxt) meets zeros. The coefficients are B5's
    (``intersect_v3._woop_coefficients``); degenerate and pad triangles
    have zero rows (d'z = 0: no hit)."""
    return _woop_layout(_woop_coefficients(sa, segments), n_chunks)


def _woop_layout(rec, n_chunks: int) -> torch.Tensor:
    """``_woop_table`` from the (P, 12) Woop rows ``rec``."""
    rows = rec.reshape(-1, 3, 4)
    z = torch.zeros_like(rows)
    w = torch.cat([torch.cat([rows, z], dim=2),          # o': B | c | 0 0 0 0
                   torch.cat([z, rows[:, :, :3], z[:, :, :1]], dim=2)],
                  dim=1)                                 # (P, 6, 8)
    # -> (n_chunks, 8, 6, T) -> (n_chunks * 8, 6 T)
    return w.reshape(n_chunks, T, 6, 8).permute(0, 3, 2, 1).reshape(
        n_chunks * 8, 6 * T).contiguous()


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """Float32 ``x`` rounded to TF32 (10 explicit mantissa bits), to
    nearest with ties away from zero, as ``cvt.rna.tf32.f32`` rounds; the
    13 low bits are zero. For finite values below 3.4e38."""
    b = x.contiguous().view(torch.int32)
    return ((b + 0x1000) & -0x2000).view(torch.float32)


def _fragment_table(w, n_chunks: int) -> torch.Tensor:
    """W rounded to TF32 in the order of the A fragments of
    ``mma.m16n8k8.row.col.tf32``, flat: (n_chunks, GROUPS, 3 tiles,
    32 lanes, 4). Tile m of group q is a 16 x 8 A whose rows g and g + 8
    are components 2m and 2m + 1 of triangle 8q + g (tile 0: o'x, o'y;
    tile 1: o'z, d'x; tile 2: d'y, d'z) and whose columns are the eight
    ray features; lane 4g + c holds a0..a3 = A[g][c], A[g+8][c],
    A[g][c+4], A[g+8][c+4], one 16-byte load."""
    # (n, 8 features = (h, c), 6 components = (m, p), T = (q, g))
    wt = tf32_round(w).reshape(n_chunks, 2, 4, 3, 2, GROUPS, 8)
    return wt.permute(0, 5, 3, 6, 2, 1, 4).reshape(-1).contiguous()


def _unfragment(frag, n_chunks: int) -> torch.Tensor:
    """``_fragment_table``'s order undone: (n_chunks * 8, 768), the layout
    of ``_woop_table``."""
    f = frag.reshape(n_chunks, GROUPS, 3, 8, 4, 2, 2)
    return f.permute(0, 5, 4, 2, 6, 1, 3).reshape(n_chunks * 8, 6 * T)


def _radius_table(w, n_chunks: int) -> torch.Tensor:
    """(n_chunks * T, 8) f32: per triangle GATE_EPS * S of its six
    components (o'x o'y o'z d'x d'y d'z; S = sum_k |w_k| in float32) and
    two zeros. A triangle whose d'z row is zero (degenerate or pad: d'z is
    0 for every ray, so it never hits) gets -1 for o'z and d'z, which
    makes the kernel's sign test of d'z pass and its t > 0 test reject."""
    s = w.reshape(n_chunks, 8, 6, T).abs().sum(dim=1)   # (n, 6, T)
    s = s.permute(0, 2, 1).reshape(-1, 6) * GATE_EPS
    dead = (s[:, 5] == 0.0)[:, None]
    s = torch.where(dead & torch.tensor([False, False, True, False, False,
                                         True], device=s.device), -1.0, s)
    return torch.cat([s, torch.zeros_like(s[:, :2])], dim=1).contiguous()


class MxuTables(NamedTuple):
    meta: torch.Tensor      # (n_chunks, 2) int32: anim range | -1, slot0
    w: torch.Tensor         # (n_chunks * 8, 768) f32 Woop table
    inst: torch.Tensor      # (n_ranges or 1, 26) f32 instance records
    has_anim: bool
    sub: torch.Tensor       # (4 n_chunks, 6) f32 32-triangle world AABBs
    n_chunks: int
    runs: Tuple[Tuple[int, int, int], ...]   # (anim range | -1, c0, c1)
    frag: torch.Tensor      # (n_chunks * 6144,) f32: W in TF32, A fragments
    rad: torch.Tensor       # (n_chunks * T, 8) f32: GATE_EPS * S per component
    rec: torch.Tensor       # (n_chunks * T, 12) f32: Woop rows r0 c0 r1 c1 r2 c2


def mxu_tables(sa) -> MxuTables:
    """B6's per-scene tables, cached on the SceneArrays."""
    if "mxu" in sa._cache:
        return sa._cache["mxu"]
    segments, meta32 = _chunked_layout(sa.n_static_tris, sa.anim_ranges)
    n_chunks = meta32.shape[0] // SUBS
    meta = meta32[::SUBS]
    rec = _woop_coefficients(sa, segments).contiguous()
    w = _woop_layout(rec, n_chunks)
    tables = MxuTables(
        torch.as_tensor(meta, device=sa.device).contiguous(), w,
        _inst_table(sa), bool(sa.anim_ranges),
        _chunk_boxes(sa, SUBS * n_chunks).contiguous(), n_chunks,
        _runs(meta, 1), _fragment_table(w, n_chunks),
        _radius_table(w, n_chunks), rec)
    sa._cache["mxu"] = tables
    return tables


def prepare(tables: MxuTables, ray: Ray):
    """The kernel's per-query inputs (JAX ``intersect_mxu`` :571-579): X,
    (8, N) rows ox oy oz 1 dx dy dz maxt padded to whole blocks, with maxt
    clamped to 3e38 (row 7 meets zero coefficients and 0 * inf is NaN) and
    dead (-1) in the padding; the padded times; the blocks' visit lists.
    A lane whose maxt is NaN takes no part in its block's largest maxt, as
    in ``intersect_v4.prepare`` (JAX's amax would leave the whole block
    nothing to reach); X keeps the NaN for the kernel. Returns (x, time,
    order, tlo)."""
    o, d, time, maxt = _padded_cols(ray, torch.clamp(ray.maxt, max=_BIG),
                                    BLOCK)
    head = list(o) + [torch.ones_like(maxt)] + list(d)
    x = torch.stack(head + [maxt])
    order, tlo = _visit_order(tables.sub, tables.n_chunks, torch.stack(
        head + [torch.where(torch.isnan(maxt), -float("inf"), maxt)]),
        BLOCK)
    return x.contiguous(), time, order, tlo


def _affine_hit(w, xp, best):
    """The product and its epilogue for lanes (rows) against triangles
    (columns), in the kernel's order of operations (JAX
    intersect_mxu.py:199-217). ``w``: (8, 6, 1, C) coefficients; ``xp``:
    8 (L, 1) ray features; ``best``: (L, 1) the lanes' best t. Each of the
    six components is the ordered sum over the features k = 0..7. Returns
    t with misses at +inf."""
    res = []
    for c in range(6):
        acc = w[0, c] * xp[0]
        for k in range(1, 8):
            acc = acc + w[k, c] * xp[k]
        res.append(acc)
    oxp, oyp, ozp, dxp, dyp, dzp = res
    dz_ok = torch.abs(dzp) > 1e-30
    t = -ozp / torch.where(dz_ok, dzp, 1.0)
    u = oxp + t * dxp
    v = oyp + t * dyp
    hit = (dz_ok & (torch.minimum(u, v) >= 0.0) & (u + v <= 1.0)
           & (t > 0.0) & (t < xp[7]) & (t < best))
    return torch.where(hit, t, float("inf"))


def intersect_mxu_reference(sa, ray: Ray, any_hit: bool = False):
    """B6's plain version: every lane against every chunk, dense, in
    chunks of lanes and triangles; within a chunk the lowest triangle wins
    among equal t, across chunks strict ``t < best`` in slot order.
    Returns (t, prim); with ``any_hit`` the closest hit too (any-hit
    promises only occlusion)."""
    _check_rays(ray)
    tb = mxu_tables(sa)
    n = ray.o.x.shape[0]
    dev = ray.o.x.device
    maxt = torch.clamp(ray.maxt, max=_BIG)
    best_t = torch.full((n,), float("inf"), device=dev)
    best_p = torch.full((n,), -1, dtype=torch.int32, device=dev)
    lanes = max(1, _REF_ELEMS // (_REF_CHUNKS * T))
    j = torch.arange(T, dtype=torch.int32, device=dev)
    one = torch.ones((), device=dev)
    for l0 in range(0, n, lanes):
        sl = slice(l0, min(l0 + lanes, n))
        o = (ray.o.x[sl], ray.o.y[sl], ray.o.z[sl])
        d = (ray.d.x[sl], ray.d.y[sl], ray.d.z[sl])
        mt = maxt[sl, None]
        bt = best_t[sl]
        bp = best_p[sl]
        for ci, c0, c1 in tb.runs:
            r = _unit_ray(tb, ci, o, d, ray.time[sl])
            xp = [c[:, None] for c in r[:3]] + [one.expand_as(mt)] \
                + [c[:, None] for c in r[3:]] + [mt]
            for a in range(c0, c1, _REF_CHUNKS):
                b = min(a + _REF_CHUNKS, c1)
                # (chunks, 8, 6, T) -> (8, 6, 1, chunks * T)
                w = tb.w[a * 8:b * 8].reshape(b - a, 8, 6, T).permute(
                    1, 2, 0, 3).reshape(8, 6, 1, (b - a) * T)
                slots = (tb.meta[a:b, 1:2] + j).reshape(-1)
                tm = _affine_hit(w, xp, bt[:, None])
                k = torch.argmin(tm, dim=1)
                tk = torch.gather(tm, 1, k[:, None])[:, 0]
                take = tk < bt
                bt = torch.where(take, tk, bt)
                bp = torch.where(take, slots[k], bp)
        best_t[sl] = bt
        best_p[sl] = bp
    return best_t, best_p


def _fma(a, b, c):
    """float32 a * b + c rounded once, as ``__fmaf_rn`` (the product is
    exact in float64; the sum rounds to float64 and then to float32, which
    can differ from one rounding only at rare ties)."""
    return (a.double() * b.double() + c.double()).float()


def _gate_rule(o, d, ro, rd, tq):
    """The kernel's conservative reject rule (csrc/intersect_mxu.cu
    ``gate_pass``), in float32 with its fused multiply-adds. ``o``, ``d``:
    the approximate o' and d' (3-tuples), ``ro``, ``rd``: their radii,
    ``tq``: min(maxt, best) * GATE_T_SLACK, -inf for a dead lane. True
    where the pair goes to the exact test."""
    ox, oy, oz = o
    dx, dy, dz = d
    rox, roy, roz = ro
    rdx, rdy, rdz = rd
    dzm = dz.abs()
    ozs = torch.where(dz < 0.0, -oz, oz)
    dhi = dzm + rdz
    ozr = ozs.abs() + roz
    ru = _fma(ox.abs() + rox, rdz, _fma(dzm, rox, _fma(ozr, rdx,
                                                       dx.abs() * roz)))
    rv = _fma(oy.abs() + roy, rdz, _fma(dzm, roy, _fma(ozr, rdy,
                                                       dy.abs() * roz)))
    u = _fma(ox, dzm, -(ozs * dx))
    v = _fma(oy, dzm, -(ozs * dy))
    reject = ((ozs >= roz) | (_fma(tq, dhi, ozs + roz) <= 0.0)
              | (u + ru < 0.0) | (v + rv < 0.0)
              | ((u - ru) + (v - rv) > dhi))
    return (tq > 0.0) & ~((dzm > rdz) & reject)


def _warp_max(v):
    return v.reshape(-1, WARP).amax(dim=1).repeat_interleave(WARP)


def mxu_gate_reference(tables: MxuTables, x, time, c0: int, c1: int,
                       best=None):
    """The plain version of B6's tensor-core gate: which pairs of lanes
    and triangles of chunks ``c0 .. c1 - 1`` it passes to the exact test,
    (N, (c1 - c0) * T) bool. ``x``, ``time``: ``prepare``'s X and times
    (N a multiple of 32: the kernel's warps); ``best``: each lane's best
    t so far, (N,) or per chunk (N, c1 - c0) (default: none, +inf).

    As the kernel does: the ray in each chunk's hit space (``_unit_ray``)
    rounded to TF32, [ox oy oz 1 dx dy dz 0] (maxt meets zeros; a dead lane,
    maxt <= 0, takes zeros); the TF32 table (``tables.frag``, its order
    undone) times those features, summed in float32 over k = 0..7 (the
    tensor cores sum in an order of their own: the radius covers any); a
    radius GATE_EPS * S * M per component, with M the largest
    max(|o|, 1) (o') or max(|d|) (d') over the live lanes of the lane's
    warp of 32; and the reject rule of ``_gate_rule`` with
    T = min(maxt, best) * GATE_T_SLACK."""
    n = x.shape[1]
    if n % WARP:
        raise ValueError("mxu_gate_reference: lanes must fill warps of 32")
    w = _unfragment(tables.frag, tables.n_chunks).reshape(
        tables.n_chunks, 8, 6, T)
    rad = tables.rad.reshape(tables.n_chunks, T, 8)
    maxt = x[7]
    live = maxt > 0.0
    if best is None:
        best = torch.full_like(maxt, float("inf"))
    if best.dim() == 1:
        best = best[:, None].expand(n, c1 - c0)
    tq = torch.where(live[:, None], torch.minimum(maxt[:, None], best)
                     * GATE_T_SLACK, float("-inf"))
    one = torch.ones_like(maxt)
    zero = torch.zeros_like(maxt)
    out = []
    for ci, a, b in tables.runs:
        a, b = max(a, c0), min(b, c1)
        if a >= b:
            continue
        r = _unit_ray(tables, ci, (x[0], x[1], x[2]), (x[4], x[5], x[6]),
                      time)
        m_o = torch.stack([r[0].abs(), r[1].abs(), r[2].abs(), one]).amax(0)
        m_d = torch.stack([c.abs() for c in r[3:]]).amax(0)
        m_o = _warp_max(torch.where(live, m_o, zero))[:, None]
        m_d = _warp_max(torch.where(live, m_d, zero))[:, None]
        feat = [torch.where(live, tf32_round(c), zero)[:, None]
                for c in (r[0], r[1], r[2], one, r[3], r[4], r[5], zero)]
        wc = w[a:b].permute(1, 2, 0, 3).reshape(8, 6, (b - a) * T)
        acc = []
        for c in range(6):
            s = wc[0, c] * feat[0]
            for k in range(1, 8):
                s = s + wc[k, c] * feat[k]
            acc.append(s)
        rr = rad[a:b].reshape(-1, 8)
        out.append(_gate_rule(acc[:3], acc[3:],
                              [rr[:, i] * m_o for i in range(3)],
                              [rr[:, 3 + i] * m_d for i in range(3)],
                              tq[:, a - c0:b - c0].repeat_interleave(T,
                                                                     dim=1)))
    return torch.cat(out, dim=1)


def _bind(lib):
    fn = lib.mi_intersect_mxu
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 2
                   + [ctypes.c_void_p] * 2 + [ctypes.c_longlong, ctypes.c_int]
                   + [ctypes.c_void_p] * 3)
    lib.mi_intersect_mxu_block.restype = ctypes.c_int
    lib.mi_intersect_mxu_block.argtypes = []
    if lib.mi_intersect_mxu_block() != BLOCK:
        raise RuntimeError("csrc/intersect_mxu.cu was built for another "
                           "block size than ops/intersect_stream.py BLOCK")


LIBRARY = CudaLibrary("intersect_mxu", _bind,
                      headers=("intersect_common.cuh",))


def launch(tables: MxuTables, prep, any_hit: bool):
    """One launch over prepared inputs (``prepare``). Returns (t, prim) at
    the padded length."""
    global LAUNCHES
    x, time, order, tlo = prep
    n_pad, dev = _check_launch("intersect_mxu", tables.frag, (time,), BLOCK)
    if (x.shape != (8, n_pad) or x.dtype != torch.float32
            or not x.is_contiguous() or x.device != dev):
        raise ValueError("intersect_mxu kernel: X must be contiguous "
                         f"(8, {n_pad}) float32 on {dev}")
    nb = n_pad // BLOCK
    if order.shape != (nb, tables.n_chunks) or tlo.shape != order.shape:
        raise ValueError("intersect_mxu kernel: one visit list per block of "
                         f"{BLOCK} lanes")
    lib = LIBRARY.load()
    t = torch.empty((n_pad,), device=dev)
    prim = torch.empty((n_pad,), dtype=torch.int32, device=dev)
    if n_pad > 0:
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.mi_intersect_mxu(
                tables.frag.data_ptr(), tables.rad.data_ptr(),
                tables.rec.data_ptr(), tables.meta.data_ptr(),
                tables.inst.data_ptr(), tables.sub.data_ptr(),
                order.data_ptr(), tlo.data_ptr(), tables.n_chunks,
                int(tables.has_anim), x.data_ptr(), time.data_ptr(), n_pad,
                int(any_hit), t.data_ptr(), prim.data_ptr(), stream)
        if err != 0:
            raise RuntimeError(f"intersect_mxu kernel launch failed: CUDA "
                               f"error {err}")
        LAUNCHES += 1
        LAUNCHES_BY_FORM["any_hit" if any_hit else "closest_hit"] += 1
    return t, prim


def intersect_mxu(sa, ray: Ray, any_hit: bool = False):
    """Closest-hit (or any-hit) (t, prim) over all triangles as affine
    maps of the ray: the CUDA kernel for tensors on the card, the plain
    version for CPU tensors."""
    _check_rays(ray)
    if ray.o.x.device.type == "cpu":
        return intersect_mxu_reference(sa, ray, any_hit)
    n = ray.o.x.shape[0]
    tables = mxu_tables(sa)
    t, prim = launch(tables, prepare(tables, ray), any_hit)
    return t[:n], prim[:n]


def _payload_table(sa) -> torch.Tensor:
    """(T_total, 26) per-triangle records in global slot order: B1's
    triangle records (24 geometry/uv floats and the instance id,
    ``intersect_kernel.scene_tables``) and the animated-range index (-1
    static). Cached on the SceneArrays."""
    if "payload" not in sa._cache:
        aidx = np.repeat(
            np.arange(-1, len(sa.anim_ranges), dtype=np.float32),
            [sa.n_static_tris] + [c for _, _, c in sa.anim_ranges])
        aidx = torch.as_tensor(aidx, device=sa.device)[:, None]
        sa._cache["payload"] = torch.cat([scene_tables(sa)[0], aidx],
                                         dim=1).contiguous()
    return sa._cache["payload"]


def payload_from_prim(sa, ray, t, prim):
    """The full ``HitRecord`` of the winning triangle per lane from B2's
    (t, prim): one row gather plus a dense Möller/interpolation recompute
    (JAX intersect_mxu.py:455)."""
    tbl = _payload_table(sa)
    n_tot = tbl.shape[0]
    idx = torch.clamp(prim, 0, n_tot - 1).long()
    rec = tbl[idx]                                       # (N, 26)
    valid = prim >= 0

    o = (ray.o.x, ray.o.y, ray.o.z)
    d = (ray.d.x, ray.d.y, ray.d.z)
    if sa.anim_ranges:
        aidx = rec[:, 25].to(torch.int32)
        is_anim = aidx >= 0
        irec = _inst_table(sa)[torch.clamp(aidx, min=0).long()]
        i3, it3 = _inv_lerped(tuple(irec[:, j] for j in range(12)),
                              tuple(irec[:, 12 + j] for j in range(12)),
                              irec[:, 24], irec[:, 25], ray.time)
        fa = is_anim.to(torch.float32)
        om = 1.0 - fa
        # the ray in hit space: fa * (M^-1 x) + om * x
        o = tuple(fa * (i3[3 * k] * o[0] + i3[3 * k + 1] * o[1]
                        + i3[3 * k + 2] * o[2] + it3[k]) + om * o[k]
                  for k in range(3))
        d = tuple(fa * (i3[3 * k] * d[0] + i3[3 * k + 1] * d[1]
                        + i3[3 * k + 2] * d[2]) + om * d[k]
                  for k in range(3))

    v0 = (rec[:, 0], rec[:, 1], rec[:, 2])
    e1 = (rec[:, 3], rec[:, 4], rec[:, 5])
    e2 = (rec[:, 6], rec[:, 7], rec[:, 8])
    # barycentrics at the known hit point (hit space): p = o + t d
    px = o[0] + t * d[0] - v0[0]
    py = o[1] + t * d[1] - v0[1]
    pz = o[2] + t * d[2] - v0[2]
    # solve p = u e1 + v e2 in the triangle plane (2x2 Gram system)
    d11 = e1[0] * e1[0] + e1[1] * e1[1] + e1[2] * e1[2]
    d12 = e1[0] * e2[0] + e1[1] * e2[1] + e1[2] * e2[2]
    d22 = e2[0] * e2[0] + e2[1] * e2[1] + e2[2] * e2[2]
    dp1 = px * e1[0] + py * e1[1] + pz * e1[2]
    dp2 = px * e2[0] + py * e2[1] + pz * e2[2]
    den = d11 * d22 - d12 * d12
    den = torch.where(torch.abs(den) > 1e-30, den, 1.0)
    u = torch.clamp((d22 * dp1 - d12 * dp2) / den, 0.0, 1.0)
    v = torch.clamp((d11 * dp2 - d12 * dp1) / den, 0.0, 1.0)
    w = 1.0 - u - v

    gx = e1[1] * e2[2] - e1[2] * e2[1]
    gy = e1[2] * e2[0] - e1[0] * e2[2]
    gz = e1[0] * e2[1] - e1[1] * e2[0]
    nx = w * rec[:, 9] + u * rec[:, 12] + v * rec[:, 15]
    ny = w * rec[:, 10] + u * rec[:, 13] + v * rec[:, 16]
    nz = w * rec[:, 11] + u * rec[:, 14] + v * rec[:, 17]
    if sa.anim_ranges:
        def inv_t(x, y, z):
            return (fa * (i3[0] * x + i3[3] * y + i3[6] * z) + om * x,
                    fa * (i3[1] * x + i3[4] * y + i3[7] * z) + om * y,
                    fa * (i3[2] * x + i3[5] * y + i3[8] * z) + om * z)
        gx, gy, gz = inv_t(gx, gy, gz)
        nx, ny, nz = inv_t(nx, ny, nz)
    uv_u = w * rec[:, 18] + u * rec[:, 20] + v * rec[:, 22]
    uv_v = w * rec[:, 19] + u * rec[:, 21] + v * rec[:, 23]

    return HitRecord(
        t=torch.where(valid, t, float("inf")),
        prim=prim,
        inst=torch.where(valid, rec[:, 24].to(torch.int32), -1),
        u=torch.where(valid, u, 0.0), v=torch.where(valid, v, 0.0),
        gnx=torch.where(valid, gx, 0.0), gny=torch.where(valid, gy, 0.0),
        gnz=torch.where(valid, gz, -1.0),
        nsx=torch.where(valid, nx, 0.0), nsy=torch.where(valid, ny, 0.0),
        nsz=torch.where(valid, nz, -1.0),
        uv_u=torch.where(valid, uv_u, 0.0),
        uv_v=torch.where(valid, uv_v, 0.0))


__all__ = ["payload_from_prim", "intersect_mxu", "intersect_mxu_reference",
           "mxu_gate_reference", "mxu_tables", "prepare", "launch",
           "tf32_round", "LIBRARY", "T", "SUBS", "BLOCK", "GATE_EPS",
           "LAUNCHES", "LAUNCHES_BY_FORM"]
