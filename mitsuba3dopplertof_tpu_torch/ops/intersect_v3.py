"""Kernel B5, the 32-triangle Woop units of the large-scene kernels and
their per-block visit lists (port of the JAX package's
``ops/intersect_v3.py``: the Pallas kernel ``_build_v3_kernel`` with its
wrapper ``intersect_v3``, and the helpers ``_woop_records`` and
``_unit_visit_order``, which B2 shares).

B5 (``MI_STREAM_KERNEL=v3``) walks B2's units and B2's visit lists, which
the CUDA kernel ``csrc/intersect_v3.cu`` builds itself as B2's does (the
scene-box clamp of maxt, a slab test of every unit box against the
block's ray bounds, the units sorted by entry distance, in rounds of at
most ``cap`` entries), with B2's walk: each warp down the list on its own
bound, every walk shared by the CTA's eight warps. Before a unit, each
lane tests its own ray against the unit's box within its own far end
(``lane_box_test``), and the warp skips the unit where no lane passes.
Culling is conservative, so the result is that of the dense test of every
lane against every unit, which is B2's plain version:
``intersect_v3_reference`` is ``intersect_v4_reference``.

  * ``intersect_v3(sa, ray, any_hit)`` — the kernel for CUDA tensors (one
    launch, no PyTorch visit lists), the plain version for CPU tensors;
    returns (t, prim) in the global slot convention;
  * ``lane_box_test`` and ``v3_walk_reference`` — the kernel's per-lane
    box test and its warps' walks in plain PyTorch, step by step, for the
    tests and chip_smoke.py's bound; never on the main path.

``LAUNCHES`` / ``LAUNCHES_BY_FORM`` count kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from ..render.types import Ray
from .cuda_build import CudaLibrary
from .intersect_kernel import _check_rays
from .intersect_stream import BLOCK, CHUNK, _unit_ray


UNIT_REC = 12 * CHUNK     # floats per unit: coefficient c of tri j at c*32+j
_BIG = 3.0e38
_GEOM = ("v0x", "v0y", "v0z", "e1x", "e1y", "e1z", "e2x", "e2y", "e2z")


def _cross(a, b):
    return (a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0])


def _woop_coefficients(sa, segments) -> torch.Tensor:
    """(P, 12) f32 Woop coefficients of the padded triangles: the rows of
    B = [e1 | e2 | n]^-1 (n = e1 x e2, via the adjugate), each followed by
    its entry of c = -B v0. Degenerate and pad triangles get zero rows."""
    parts = []
    for kind, start, count in segments:
        if kind == "pad":
            parts.append(torch.zeros((count, 9), device=sa.device))
            continue
        parts.append(torch.stack(
            [sa.tri(kind, c)[start:start + count] for c in _GEOM], dim=-1))
    g = torch.cat(parts, dim=0)                          # (P, 9)
    v0 = (g[:, 0], g[:, 1], g[:, 2])
    e1 = (g[:, 3], g[:, 4], g[:, 5])
    e2 = (g[:, 6], g[:, 7], g[:, 8])
    nrm = _cross(e1, e2)
    det = nrm[0] * nrm[0] + nrm[1] * nrm[1] + nrm[2] * nrm[2]   # |n|^2
    ok = det > 1e-32
    inv = torch.where(ok, 1.0 / torch.where(ok, det, 1.0), 0.0)
    r0 = tuple(x * inv for x in _cross(e2, nrm))
    r1 = tuple(x * inv for x in _cross(nrm, e1))
    r2 = tuple(x * inv for x in nrm)
    rows = []
    for r in (r0, r1, r2):
        c = -(r[0] * v0[0] + r[1] * v0[1] + r[2] * v0[2])
        rows += [r[0], r[1], r[2], c]
    return torch.stack(rows, dim=-1)


def _woop_records(sa, segments, n_units: int) -> torch.Tensor:
    """Woop table, (n_units, 384) f32 (JAX intersect_v3.py:280 keeps the
    same 384 floats in an (8, 128) tile): coefficient c of triangle j of a
    unit at c * 32 + j. Zero rows of degenerate and pad triangles give
    t = -0/0 = NaN, which every comparison rejects."""
    w = _woop_coefficients(sa, segments)                 # (P, 12)
    # (n_units, 32, 12) -> coefficient-major (n_units, 12, 32)
    return w.reshape(n_units, CHUNK, 12).transpose(1, 2).reshape(
        n_units, UNIT_REC).contiguous()


def _slab_keys(blo, bhi, x, blk: int):
    """(N / blk, n) entry distances of each block of ``blk`` lanes into
    each box (``blo``, ``bhi``: (n, 3) corners; an inverted box is never
    entered), 3e38 where the block cannot enter it. ``x``: (8, N) rows
    ox oy oz 1 dx dy dz maxt, N a multiple of ``blk``. A conservative slab
    test of each block's ray bounds against each box within the block's
    largest maxt gives its entry distance t_lo."""
    n_units = blo.shape[0]
    nb = x.shape[1] // blk
    xb = x.reshape(8, nb, blk)
    ol = xb[0:3].amin(dim=2).T
    oh = xb[0:3].amax(dim=2).T
    dl = xb[4:7].amin(dim=2).T
    dh = xb[4:7].amax(dim=2).T
    mt = torch.clamp(xb[7].amax(dim=1), max=_BIG)
    live = blo[:, 0] <= bhi[:, 0]

    t_lo = torch.zeros((nb, n_units), device=x.device)
    t_hi = mt[:, None].expand(nb, n_units)
    for ax in range(3):
        dla = dl[:, ax:ax + 1]
        dha = dh[:, ax:ax + 1]
        same = (dla > 1e-12) | (dha < -1e-12)
        inv_a = 1.0 / torch.where(same, dla, 1.0)
        inv_b = 1.0 / torch.where(same, dha, 1.0)
        lo = torch.full((nb, n_units), _BIG, device=x.device)
        hi = torch.full((nb, n_units), -_BIG, device=x.device)
        for p in (blo[None, :, ax], bhi[None, :, ax]):
            for oo in (ol[:, ax:ax + 1], oh[:, ax:ax + 1]):
                num = p - oo
                for iv in (inv_a, inv_b):
                    val = num * iv
                    lo = torch.minimum(lo, val)
                    hi = torch.maximum(hi, val)
        lo = torch.where(same, lo, -_BIG)
        hi = torch.where(same, hi, _BIG)
        t_lo = torch.maximum(t_lo, lo)
        t_hi = torch.minimum(t_hi, hi)
    possible = (t_lo <= t_hi) & live[None, :]
    return torch.where(possible, t_lo, _BIG)


def _slab_visit_order(blo, bhi, x, blk: int):
    """Per-block front-to-back visit lists over boxes: the boxes sorted by
    ``_slab_keys``, unreachable ones (3e38) last. Returns (order, t_lo
    sorted), both (N / blk, n); the sort is stable, as ``jnp.argsort``."""
    key = _slab_keys(blo, bhi, x, blk)
    order = torch.argsort(key, dim=1, stable=True)
    return (order.to(torch.int32).contiguous(),
            torch.gather(key, 1, order).contiguous())


def _unit_visit_order(box, n_units: int, x, blk: int):
    """Per-block visit lists over the 32-triangle units (JAX
    intersect_v3.py:316): ``_slab_visit_order`` over the units' boxes
    ``box`` (n_units, 6)."""
    return _slab_visit_order(box[:n_units, :3], box[:n_units, 3:], x, blk)


# ---------------------------------------------------------------------------
# B5: plain version, its per-lane box test and walk step by step, kernel
# ---------------------------------------------------------------------------

WARP = 32
# csrc/intersect_common.cuh kSlabSlack: the far side of the per-lane box
# test is scaled by 1 + 2^-19 (Ize's 1 + 2 gamma_3, widened; exact in
# float32)
SLAB_SLACK = 1.0 + 2.0 ** -19
_CAP = 1.0e37             # a walk's far end is capped here (kBoundCap)

LAUNCHES = 0
LAUNCHES_BY_FORM = {"closest_hit": 0, "any_hit": 0}


def reset_launch_counts():
    global LAUNCHES
    LAUNCHES = 0
    for k in LAUNCHES_BY_FORM:
        LAUNCHES_BY_FORM[k] = 0


def intersect_v3_reference(sa, ray: Ray, any_hit: bool = False):
    """B5's plain version: B2's (``intersect_v4_reference``), the dense
    Woop test of every lane against every unit."""
    from .intersect_v4 import intersect_v4_reference
    return intersect_v4_reference(sa, ray, any_hit)


def lane_box_test(o, inv, box, far):
    """The kernel's per-lane box test (csrc/intersect_common.cuh
    ``lane_box``) in its order of operations, float32: may each world ray
    (``o``: 3 origin components, ``inv``: 3 of 1 / d) enter its box
    (``box``: (..., 6) lo xyz, hi xyz, never inverted) at a distance in [0,
    ``far``]? Per axis the plane parameters (b - o) * inv give an entry
    (torch.minimum) and an exit (torch.maximum), each NaN if either is
    (a zero direction component with the origin in a face plane); a NaN
    moves neither the near side (0, then the largest entry) nor the far
    side (``far``, then the smallest exit); the far side is scaled by
    ``SLAB_SLACK``. All operands broadcast. Returns bool."""
    lo = torch.zeros_like(far)
    hi = far
    for ax in range(3):
        t0 = (box[..., ax] - o[ax]) * inv[ax]
        t1 = (box[..., 3 + ax] - o[ax]) * inv[ax]
        t_en = torch.minimum(t0, t1)
        t_ex = torch.maximum(t0, t1)
        lo = torch.where(t_en > lo, t_en, lo)
        hi = torch.where(t_ex < hi, t_ex, hi)
    return lo <= hi * SLAB_SLACK


class V3Walk(NamedTuple):
    t: torch.Tensor         # (N,) best t, +inf on a miss
    prim: torch.Tensor      # (N,) int32 slot of the winner, -1 on a miss
    tested: torch.Tensor    # (N / 32, n_units) bool: the units each warp's
                            # walk tests


def v3_walk_reference(tables, ray: Ray, any_hit: bool, far=None) -> V3Walk:
    """csrc/intersect_v3.cu's walk as one warp alone would run it, step by
    step, for every warp at once, over the rays padded to whole blocks:
    down its block's visit list (``intersect_v4.prepare``'s, which the
    kernel's rounds take in the same order) on its own bound (the largest
    over its 32 lanes of min(best t, maxt), torch.fmin as the kernel's
    fminf; any-hit maxt for a lane with no hit yet and -3e38 for one with
    a hit; capped at 1e37), to the first entry whose t_lo exceeds it;
    before each unit the per-lane box test (``lane_box_test``) of each live
    lane (maxt > 0) within its own far end (closest-hit min(best t, maxt),
    any-hit maxt while it has no hit), the unit skipped where no lane of
    the warp passes; then Woop's test of the unit on all 32 lanes in its
    transform group's hit space, with the tie rule: a lower t, or an equal
    t at a lower slot. ``far``: (f, last), each (N,), to use in place of
    the lanes' own far ends: lane l's far end is f[l] at the ranks up to
    last[l] of its block's list and none after: the walk that
    chip_smoke.py's ``WalkWork.b5_warps`` counts."""
    from .intersect_v4 import _woop_hit, prepare
    o, d, time, maxt, order, tlo = prepare(tables, ray)
    n = maxt.shape[0]
    dev = maxt.device
    nw = n // WARP
    live = maxt > 0.0
    inv = tuple(1.0 / c for c in d)
    cis = sorted({ci for ci, _, _ in tables.runs})
    rays = torch.stack([torch.stack(_unit_ray(tables, ci, o, d, time))
                        for ci in cis])
    ci_index = torch.as_tensor([cis.index(int(ci)) for ci in
                                tables.meta[:, 0].tolist()], device=dev)
    inf = float("inf")
    best_t = torch.full((n,), inf, device=dev)
    no_hit = torch.iinfo(torch.int64).max
    best_s = torch.full((n,), no_hit, dtype=torch.int64, device=dev)
    tested = torch.zeros((nw, tables.n_units), dtype=torch.bool, device=dev)
    done = torch.zeros((nw,), dtype=torch.bool, device=dev)
    block = torch.arange(nw, device=dev) // (BLOCK // WARP)
    j = torch.arange(CHUNK, device=dev)
    for pos in range(tables.n_units):
        u = order[block, pos].long()
        if far is not None:
            on = pos <= far[1]
            term = torch.where(on, far[0], -_BIG)
            lane_far = torch.where(on, far[0], -inf)
        elif any_hit:
            hit = best_s != no_hit
            term = torch.where(hit, -_BIG, maxt)
            lane_far = torch.where(hit, -inf, maxt)
        else:
            term = lane_far = torch.fmin(best_t, maxt)
        term = torch.where(torch.isnan(term), -inf, term)
        bound = torch.clamp(term.reshape(nw, WARP).amax(dim=1), max=_CAP)
        done |= tlo[block, pos] > bound
        box = tables.box[u].repeat_interleave(WARP, dim=0)
        passes = live & lane_box_test(o, inv, box, lane_far)
        run = ~done & passes.reshape(nw, WARP).any(dim=1)
        if not bool(run.any()):
            continue
        tested[run, u[run]] = True
        lanes = run.repeat_interleave(WARP).nonzero()[:, 0]
        ul = u.repeat_interleave(WARP)[lanes]
        r = rays[ci_index[ul], :, lanes]
        w = tables.woop_tri[ul]
        tm = _woop_hit([w[:, :, c] for c in range(12)],
                       [r[:, a:a + 1] for a in range(6)], maxt[lanes, None])
        jm = torch.argmin(tm, dim=1)
        tc = tm.gather(1, jm[:, None])[:, 0]
        sc = tables.meta[ul, 1].long() + j[jm]
        bt, bs = best_t[lanes], best_s[lanes]
        take = torch.isfinite(tc) & ((tc < bt) | ((tc == bt) & (sc < bs)))
        best_t[lanes] = torch.where(take, tc, bt)
        best_s[lanes] = torch.where(take, sc, bs)
    found = best_s != no_hit
    prim = torch.where(found, best_s, -1).to(torch.int32)
    return V3Walk(best_t, prim, tested)


def _bind(lib):
    fn = lib.mi_intersect_v3
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
                   + [ctypes.c_void_p] * 8 + [ctypes.c_longlong, ctypes.c_int]
                   + [ctypes.c_void_p] * 3)
    for name in ("mi_intersect_v3_block", "mi_intersect_v3_max_cap"):
        getattr(lib, name).restype = ctypes.c_int
        getattr(lib, name).argtypes = []
    if lib.mi_intersect_v3_block() != BLOCK:
        raise RuntimeError("csrc/intersect_v3.cu was built for another "
                           "block size than ops/intersect_stream.py BLOCK")


LIBRARY = CudaLibrary("intersect_v3", _bind,
                      headers=("intersect_common.cuh",))


def launch(tables, ray: Ray, any_hit: bool, cap: Optional[int] = None):
    """One launch over the ray columns (contiguous float32 (n,) on the
    card, any n) and B2's tables (``intersect_v4.v4_tables``): the kernel
    builds its visit lists (``cap`` entries a round; default every unit,
    up to the compiled maximum) and walks them. Returns (t, prim) of the n
    lanes."""
    from .intersect_v4 import walk_units
    global LAUNCHES
    t, prim = walk_units(tables, ray, any_hit, cap, "intersect_v3", LIBRARY)
    if t.numel():
        LAUNCHES += 1
        LAUNCHES_BY_FORM["any_hit" if any_hit else "closest_hit"] += 1
    return t, prim


def intersect_v3(sa, ray: Ray, any_hit: bool = False):
    """Closest-hit (or any-hit) (t, prim) over all triangles, one unit per
    step behind a per-lane box test: the CUDA kernel for tensors on the
    card (its own visit lists, no ``prepare``), the plain version for CPU
    tensors."""
    from .intersect_v4 import v4_tables
    _check_rays(ray)
    if ray.o.x.device.type == "cpu":
        return intersect_v3_reference(sa, ray, any_hit)
    return launch(v4_tables(sa), ray, any_hit)


__all__ = ["UNIT_REC", "BLOCK", "intersect_v3", "intersect_v3_reference",
           "lane_box_test", "v3_walk_reference", "launch", "LIBRARY",
           "LAUNCHES", "LAUNCHES_BY_FORM", "SLAB_SLACK"]
