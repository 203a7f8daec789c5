"""Kernel B4 and the scene-box exit bound of the large-scene kernels (port
of the JAX package's ``ops/intersect_v2.py``: the Pallas kernel
``_build_v2_kernel`` with its wrapper ``intersect_v2``, ``_tri_records``
and ``scene_box_exit``, which B2 and B5 share).

B4 (``MI_STREAM_KERNEL=v2``) walks 128-triangle chunks front to back with
Möller-Trumbore. The CUDA kernel ``csrc/intersect_v2.cu`` runs one CTA per
block of ``BLOCK`` lanes and builds the block's visit list itself: it
clamps maxt by the scene box (``scene_box_exit``), slab-tests every chunk
box (the union of its four 32-triangle boxes) against the ray bounds of
the block's lanes and sorts the reachable chunks by their conservative
entry distance t_lo (``intersect_mxu._visit_order``'s list, in rounds of
at most ``cap`` entries). Each 32-lane warp's walk goes down that list on
its own far end and runs a quarter only if its live lanes' ray bounds can
enter the quarter's box within it; every such walk is shared by the CTA's
eight warps, a quarter each. Culling is conservative, so the result equals
the dense Möller test of every lane against every chunk; the nearest hit
wins, and the smallest slot among equal t.

  * ``intersect_v2(sa, ray, any_hit)`` — the kernel for CUDA tensors (one
    launch, no PyTorch visit lists), the plain version for CPU tensors;
  * ``intersect_v2_reference(sa, ray, any_hit)`` — the plain version: the
    dense Möller test over the padded chunk table with the clamped maxt;
  * ``lists(tables, ray, cap)`` — the kernel's visit lists alone, for
    checking them against ``_visit_order``; no render calls it;
  * ``v2_lists_reference`` and ``v2_walk_reference`` — the kernel's lists
    (rounds included) and its warps' walks in plain PyTorch, step by step,
    for the tests and chip_smoke.py's bound; never on the main path, nor
    is ``prepare`` (the visit lists as ``_visit_order`` builds them).

Both queries return (t, prim) in the global slot convention;
``ops/intersect_mxu.payload_from_prim`` rebuilds the hit record. The
any-hit form promises only occlusion (prim >= 0).
``LAUNCHES`` / ``LAUNCHES_BY_FORM`` count the walk's launches.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from ..core.vec import Vec3
from ..render.types import Ray
from .cuda_build import CudaLibrary
from .intersect_kernel import _GEOM, _check_rays, _moller_geom
from .intersect_mxu import _visit_order
from .intersect_stream import (BLOCK, CHUNK, PAD_TO, _check_launch,
                               _chunk_boxes, _chunked_layout, _gates,
                               _inst_table, _moller_dense, _padded_cols,
                               _runs, _spans, _unit_ray, group_rounds)
from .intersect_v3 import _slab_keys

T = PAD_TO                # triangles per visit chunk (= transform-group pad)
SUBS = T // CHUNK         # 32-triangle culling boxes per chunk
TRI_ROWS = 9              # v0, e1, e2 components
WARP = 32
_BIG = 3.0e38
_CAP = 1.0e37             # the walk's far end is capped here (kBoundCap)

LAUNCHES = 0
LAUNCHES_BY_FORM = {"closest_hit": 0, "any_hit": 0}


def reset_launch_counts():
    global LAUNCHES
    LAUNCHES = 0
    for k in LAUNCHES_BY_FORM:
        LAUNCHES_BY_FORM[k] = 0


def scene_box_exit(sub, o, d):
    """Per-lane exit distance of the scene box (the union of the live
    chunk AABBs ``sub``, (n, 6)): a ray hits nothing past the point where
    it leaves the box, so min(maxt, exit) bounds its traversal. Rays that
    miss the box get -1 (dead). ``o``/``d``: 3-tuples of (N,) tensors."""
    lo = sub[:, :3].amin(dim=0)                  # inverted pads union away
    hi = sub[:, 3:].amax(dim=0)
    t_en = torch.full_like(o[0], -_BIG)
    t_ex = torch.full_like(o[0], _BIG)
    for ax in range(3):
        da = d[ax]
        oa = o[ax]
        ok = torch.abs(da) > 1e-20
        inv = 1.0 / torch.where(ok, da, 1.0)
        ta = (lo[ax] - oa) * inv
        tb = (hi[ax] - oa) * inv
        alo = torch.minimum(ta, tb)
        ahi = torch.maximum(ta, tb)
        inside = (oa >= lo[ax]) & (oa <= hi[ax])
        alo = torch.where(ok, alo, torch.where(inside, -_BIG, _BIG))
        ahi = torch.where(ok, ahi, torch.where(inside, _BIG, -_BIG))
        t_en = torch.maximum(t_en, alo)
        t_ex = torch.minimum(t_ex, ahi)
    hit_box = (t_en <= t_ex) & (t_ex > 0.0)
    ex_pad = torch.clamp(t_ex, max=_BIG) * 1.001 + 1e-4
    return torch.where(hit_box, ex_pad, -1.0)


# ---------------------------------------------------------------------------
# B4: tables, plain version, kernel
# ---------------------------------------------------------------------------

def _tri_records(sa, segments, n_chunks: int) -> torch.Tensor:
    """Möller records, (n_chunks, 9, 128) f32: row c of a chunk holds
    component c of v0, e1, e2 for its 128 triangles (the nine used rows of
    JAX intersect_v2.py:339; its seven zero rows only pad a TPU tile).
    Pad triangles have zero edges: det = 0, never hit."""
    parts = []
    for kind, start, count in segments:
        if kind == "pad":
            parts.append(torch.zeros((count, TRI_ROWS), device=sa.device))
            continue
        parts.append(torch.stack(
            [sa.tri(kind, c)[start:start + count] for c in _GEOM], dim=-1))
    p = torch.cat(parts, dim=0)                          # (C * T, 9)
    return p.reshape(n_chunks, T, TRI_ROWS).transpose(1, 2).contiguous()


class V2Tables(NamedTuple):
    meta: torch.Tensor      # (n_chunks, 2) int32: anim range | -1, slot0
    tri: torch.Tensor       # (n_chunks, 9, 128) f32 Möller records
    inst: torch.Tensor      # (n_ranges or 1, 26) f32 instance records
    has_anim: bool
    sub: torch.Tensor       # (4 n_chunks, 6) f32 32-triangle world AABBs
    n_chunks: int
    runs: Tuple[Tuple[int, int, int], ...]   # (anim range | -1, row0, row1)
    slots: torch.Tensor     # (n_chunks * 128,) int32 global slot of each row
    box: torch.Tensor       # (n_chunks, 6) f32 chunk boxes: union of 4 subs
    scene_box: torch.Tensor  # (6,) f32 union of the sub boxes


def v2_tables(sa) -> V2Tables:
    """B4's per-scene tables, cached on the SceneArrays. The kernel keeps
    the smallest slot among equal t, which is the plain version's first
    row only if slots rise with rows on every triangle that can be hit:
    the chunks' first slots must never fall (pad rows are never hit)."""
    if "v2" in sa._cache:
        return sa._cache["v2"]
    segments, meta32 = _chunked_layout(sa.n_static_tris, sa.anim_ranges)
    n_chunks = meta32.shape[0] // SUBS
    meta = meta32[::SUBS]
    if (meta[1:, 1] < meta[:-1, 1]).any():
        raise RuntimeError("B4's tie rule needs slots that rise with rows")
    meta_t = torch.as_tensor(meta, device=sa.device).contiguous()
    slots = (meta_t[:, 1:2] + torch.arange(T, dtype=torch.int32,
                                           device=sa.device)).reshape(-1)
    sub = _chunk_boxes(sa, SUBS * n_chunks).contiguous()
    sb = sub.reshape(n_chunks, SUBS, 6)
    tables = V2Tables(
        meta_t, _tri_records(sa, segments, n_chunks), _inst_table(sa),
        bool(sa.anim_ranges), sub, n_chunks, _runs(meta, T), slots,
        torch.cat([sb[:, :, :3].amin(dim=1), sb[:, :, 3:].amax(dim=1)],
                  dim=1).contiguous(),
        torch.cat([sub[:, :3].amin(dim=0), sub[:, 3:].amax(dim=0)]))
    sa._cache["v2"] = tables
    return tables


def _clamped_maxt(sub, o, d, maxt):
    """maxt clamped to 3e38 and to the scene-box exit (-1 off the box)."""
    return torch.minimum(torch.clamp(maxt, max=_BIG),
                         scene_box_exit(sub, o, d))


def _block_inputs(tables: V2Tables, ray: Ray):
    """Ray columns padded to whole blocks (padding lanes dead), maxt
    clamped by the scene box, and the (8, N) rows ox oy oz 1 dx dy dz maxt
    of the visit lists: (o, d, time, maxt, x)."""
    o, d, time, maxt = _padded_cols(ray, ray.maxt, BLOCK)
    maxt = _clamped_maxt(tables.sub, o, d, maxt)
    x = torch.stack(list(o) + [torch.ones_like(maxt)] + list(d) + [maxt])
    return o, d, time, maxt, x


def prepare(tables: V2Tables, ray: Ray):
    """The visit lists in PyTorch (JAX ``intersect_v2`` :432-440), which
    the kernel builds itself: ray columns padded to whole blocks, maxt
    clamped by the scene box (padding lanes dead), and the blocks' visit
    lists over the chunks. Returns (o, d, time, maxt, order, tlo). For the
    tests, ``v2_walk_reference`` and chip_smoke.py; not on the query's
    path."""
    o, d, time, maxt, x = _block_inputs(tables, ray)
    order, tlo = _visit_order(tables.sub, tables.n_chunks, x, BLOCK)
    return o, d, time, maxt, order, tlo


def intersect_v2_reference(sa, ray: Ray, any_hit: bool = False):
    """B4's plain version: every lane against every padded chunk row,
    dense Möller-Trumbore with the |det| > 1e-12 guard in the kernel's
    order of operations, maxt clamped by the scene box; the first slot
    wins among equal t. Returns (t, prim); with ``any_hit`` the closest
    hit too (any-hit promises only occlusion)."""
    _check_rays(ray)
    tb = v2_tables(sa)
    o = (ray.o.x, ray.o.y, ray.o.z)
    d = (ray.d.x, ray.d.y, ray.d.z)
    rows = tb.tri.transpose(0, 1).reshape(TRI_ROWS, -1)  # (9, C * T)
    cols = {c: rows[i] for i, c in enumerate(_GEOM)}
    t, row = _moller_dense(tb, cols, tb.runs, o, d, ray.time,
                           _clamped_maxt(tb.sub, o, d, ray.maxt))
    prim = torch.where(row >= 0, tb.slots[torch.clamp(row, min=0).long()], -1)
    return t, prim


# ---------------------------------------------------------------------------
# The kernel's lists and walk in plain PyTorch (tests and chip_smoke.py;
# not the main path)
# ---------------------------------------------------------------------------

def chunk_keys(tables: V2Tables, ray: Ray) -> torch.Tensor:
    """(n_blocks, n_chunks): the entry distance of each block's rays
    (padded, maxt clamped) into each chunk box, 3e38 where they cannot
    enter it: the keys of ``_visit_order``
    (``intersect_v3._slab_keys``), which the kernel's lists sort."""
    x = _block_inputs(tables, ray)[4]
    return _slab_keys(tables.box[:, :3], tables.box[:, 3:], x, BLOCK)


def v2_lists_reference(tables: V2Tables, ray: Ray,
                       cap: Optional[int] = None):
    """csrc/intersect_v2.cu's visit lists, step by step: per block the
    keys (``chunk_keys``) taken in rounds of at most ``cap`` entries
    (``intersect_stream.group_rounds``, the kernel's ``list_round``;
    default: one round), then the unreachable chunks in index order with
    key 3e38. Returns (order (n_blocks, n_chunks) int32, t_lo (n_blocks,
    n_chunks) float32, reachable chunks per block int32), as ``lists``
    gives them."""
    keys = chunk_keys(tables, ray)
    nb, n = keys.shape
    ent = torch.cat(group_rounds(keys, cap or n), dim=1)
    valid = ent >= 0
    # rank of each chunk: its place in the rounds, or n + index if it is
    # unreachable
    rank = (n + torch.arange(n, device=keys.device)).expand(nb, n).clone()
    rows, cols = valid.nonzero(as_tuple=True)
    rank[rows, ent[rows, cols] & 0xFFFFFFFF] = (valid.cumsum(dim=1)
                                                - 1)[rows, cols]
    order = torch.argsort(rank, dim=1)
    return (order.to(torch.int32), torch.gather(keys, 1, order),
            valid.sum(dim=1, dtype=torch.int32))


class V2Walk(NamedTuple):
    t: torch.Tensor         # (N,) best t, +inf on a miss
    prim: torch.Tensor      # (N,) int32 slot of the winner, -1 on a miss
    tested: torch.Tensor    # (N / 32, 4 n_chunks) bool: the quarters each
                            # warp's walk tests


def v2_walk_reference(tables: V2Tables, prep, any_hit: bool,
                      far=None) -> V2Walk:
    """csrc/intersect_v2.cu's walk as one warp alone would run it, step by
    step, for every warp at once: down its block's list (``prep``:
    ``prepare``'s columns and lists, which the kernel's rounds walk in the
    same order) with its gate over its live lanes and its own far end
    (closest-hit the largest over its live lanes of min(best t, maxt),
    any-hit the largest maxt of its live lanes with no hit yet; capped at
    1e37, -3e38 where none), its stop at the first entry whose t_lo
    exceeds the far end (any-hit also once every live lane has a hit), the
    slab test of each quarter of an entry with the far end as it stands,
    Möller-Trumbore over the quarter in its transform group's hit space,
    and the tie rule: a lower t, or an equal t at a lower slot. ``far``:
    (N / 32, n_chunks) far ends to use in place of the warp's own, by the
    rank of the entry in its block's list (no any-hit stop then): the walk
    that chip_smoke.py's ``WalkWork.b4_warps`` counts."""
    o, d, time, maxt, order, tlo = prep
    n = maxt.shape[0]
    dev = maxt.device
    nw = n // WARP
    gate, walk_far = _gates(o, d, maxt, WARP)
    walk_far = torch.clamp(walk_far, max=_CAP)
    q_lo, q_ex = _spans(gate, tables.sub)
    live = maxt > 0.0
    # each lane's ray in each transform group's hit space
    cis = sorted({ci for ci, _, _ in tables.runs})
    rays = torch.stack([torch.stack(_unit_ray(tables, ci, o, d, time))
                        for ci in cis])
    ci_index = torch.as_tensor([cis.index(int(ci)) for ci in
                                tables.meta[:, 0].tolist()], device=dev)
    # (4 n_chunks, 32, 9): the quarters' triangles
    geom = tables.tri.reshape(tables.n_chunks, TRI_ROWS, SUBS, CHUNK) \
        .permute(0, 2, 3, 1).reshape(-1, CHUNK, TRI_ROWS)
    best_t = torch.full((n,), float("inf"), device=dev)
    no_hit = torch.iinfo(torch.int64).max
    best_s = torch.full((n,), no_hit, dtype=torch.int64, device=dev)
    tested = torch.zeros((nw, SUBS * tables.n_chunks), dtype=torch.bool,
                         device=dev)
    done = ~(walk_far >= 0.0)
    block = torch.arange(nw, device=dev) // (BLOCK // WARP)
    lane_j = torch.arange(CHUNK, device=dev)
    for pos in range(order.shape[1]):
        k = order[block, pos].long()
        f = walk_far if far is None else far[:, pos]
        done |= tlo[block, pos] > f
        for s in range(SUBS):
            f = walk_far if far is None else far[:, pos]
            q = k * SUBS + s
            lo = q_lo.gather(1, q[:, None])[:, 0]
            ex = q_ex.gather(1, q[:, None])[:, 0]
            run = ~done & (lo <= torch.minimum(ex, f))
            if not bool(run.any()):
                continue
            tested[run, q[run]] = True
            lanes = run.repeat_interleave(WARP).nonzero()[:, 0]
            ql = q.repeat_interleave(WARP)[lanes]
            r = rays[ci_index[ql // SUBS], :, lanes]
            g = geom[ql]
            hit, t = _moller_geom(
                Vec3(*(r[:, a:a + 1] for a in range(3))),
                Vec3(*(r[:, a:a + 1] for a in range(3, 6))),
                maxt[lanes, None], [g[:, :, i] for i in range(TRI_ROWS)])
            tm = torch.where(hit, t, float("inf"))
            jm = torch.argmin(tm, dim=1)
            tc = tm.gather(1, jm[:, None])[:, 0]
            sc = (tables.meta[ql // SUBS, 1].long() + (ql % SUBS) * CHUNK
                  + lane_j[jm])
            bt, bs = best_t[lanes], best_s[lanes]
            take = torch.isfinite(tc) & ((tc < bt) | ((tc == bt)
                                                      & (sc < bs)))
            best_t[lanes] = torch.where(take, tc, bt)
            best_s[lanes] = torch.where(take, sc, bs)
            if far is None:
                hit_any = best_s != no_hit
                term = (torch.where(hit_any, -_BIG, maxt) if any_hit
                        else torch.minimum(best_t, maxt))
                walk_far = torch.clamp(torch.where(
                    live, term, -_BIG).reshape(nw, WARP).amax(dim=1),
                    max=_CAP)
                if any_hit:
                    done |= ~(live & ~hit_any).reshape(nw, WARP).any(dim=1)
    found = best_s != no_hit
    prim = torch.where(found, best_s, -1).to(torch.int32)
    return V2Walk(best_t, prim, tested)


# ---------------------------------------------------------------------------
# The CUDA kernel: build, load, launch
# ---------------------------------------------------------------------------

def _bind(lib):
    fn = lib.mi_intersect_v2
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 3
                   + [ctypes.c_void_p] * 8 + [ctypes.c_longlong, ctypes.c_int]
                   + [ctypes.c_void_p] * 3)
    fl = lib.mi_intersect_v2_lists
    fl.restype = ctypes.c_int
    fl.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 2
                   + [ctypes.c_void_p] * 8 + [ctypes.c_longlong]
                   + [ctypes.c_void_p] * 4)
    for name in ("mi_intersect_v2_block", "mi_intersect_v2_max_cap"):
        getattr(lib, name).restype = ctypes.c_int
        getattr(lib, name).argtypes = []
    if lib.mi_intersect_v2_block() != BLOCK:
        raise RuntimeError("csrc/intersect_v2.cu was built for another "
                           "block size than ops/intersect_stream.py BLOCK")


LIBRARY = CudaLibrary("intersect_v2", _bind,
                      headers=("intersect_common.cuh",))


def _columns(tables: V2Tables, ray: Ray, cap: Optional[int]):
    """The eight ray columns as the kernel takes them (contiguous float32
    (n,) on the scene tables' CUDA device, any n), the list capacity
    (default: every chunk, up to the compiled maximum) and the loaded
    library."""
    cols = (ray.o.x, ray.o.y, ray.o.z, ray.d.x, ray.d.y, ray.d.z, ray.time,
            ray.maxt)
    n, dev = _check_launch("intersect_v2", tables.tri, cols, 1)
    lib = LIBRARY.load()
    max_cap = lib.mi_intersect_v2_max_cap()
    cap = min(tables.n_chunks, max_cap) if cap is None else cap
    if not 1 <= cap <= max_cap:
        raise ValueError(f"intersect_v2 kernel: list capacity {cap} outside "
                         f"[1, {max_cap}]")
    return cols, n, dev, cap, lib


def launch(tables: V2Tables, ray: Ray, any_hit: bool,
           cap: Optional[int] = None):
    """One launch over the ray columns and the scene tables: the kernel
    builds its visit lists (``cap`` chunks a round) and walks them.
    Returns (t, prim) of the n lanes."""
    global LAUNCHES
    cols, n, dev, cap, lib = _columns(tables, ray, cap)
    t = torch.empty((n,), device=dev)
    prim = torch.empty((n,), dtype=torch.int32, device=dev)
    if n > 0:
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.mi_intersect_v2(
                tables.tri.data_ptr(), tables.meta.data_ptr(),
                tables.inst.data_ptr(), tables.sub.data_ptr(),
                tables.box.data_ptr(), tables.scene_box.data_ptr(),
                tables.n_chunks, int(tables.has_anim), cap,
                *(c.data_ptr() for c in cols), n, int(any_hit),
                t.data_ptr(), prim.data_ptr(), stream)
        if err != 0:
            raise RuntimeError(f"intersect_v2 kernel launch failed: CUDA "
                               f"error {err}")
        LAUNCHES += 1
        LAUNCHES_BY_FORM["any_hit" if any_hit else "closest_hit"] += 1
    return t, prim


def lists(tables: V2Tables, ray: Ray, cap: Optional[int] = None):
    """The kernel's visit lists alone (a check, not a path): per block of
    ``BLOCK`` lanes the chunks sorted by (t_lo, chunk), the unreachable
    ones last in index order with key 3e38, as ``_visit_order`` gives them
    for ``prepare``'s inputs. Returns (order (n_blocks, n_chunks) int32,
    t_lo (n_blocks, n_chunks) float32, reachable chunks per block). For CPU
    tensors the plain version, ``v2_lists_reference``."""
    if ray.o.x.device.type == "cpu":
        return v2_lists_reference(tables, ray, cap)
    cols, n, dev, cap, lib = _columns(tables, ray, cap)
    nb = -(-n // BLOCK)
    order = torch.empty((nb, tables.n_chunks), dtype=torch.int32, device=dev)
    tlo = torch.empty((nb, tables.n_chunks), device=dev)
    length = torch.empty((nb,), dtype=torch.int32, device=dev)
    if n > 0:
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.mi_intersect_v2_lists(
                tables.box.data_ptr(), tables.scene_box.data_ptr(),
                tables.n_chunks, cap, *(c.data_ptr() for c in cols), n,
                order.data_ptr(), tlo.data_ptr(), length.data_ptr(), stream)
        if err != 0:
            raise RuntimeError(f"intersect_v2 lists launch failed: CUDA "
                               f"error {err}")
    return order, tlo, length


def intersect_v2(sa, ray: Ray, any_hit: bool = False):
    """Closest-hit (or any-hit) (t, prim) over all triangles in
    128-triangle chunks: the CUDA kernel for tensors on the card, the
    plain version for CPU tensors."""
    _check_rays(ray)
    if ray.o.x.device.type == "cpu":
        return intersect_v2_reference(sa, ray, any_hit)
    ray = Ray(Vec3(*(c.contiguous() for c in ray.o)),
              Vec3(*(c.contiguous() for c in ray.d)), ray.time.contiguous(),
              ray.maxt.contiguous())
    return launch(v2_tables(sa), ray, any_hit)


__all__ = ["scene_box_exit", "intersect_v2", "intersect_v2_reference",
           "v2_tables", "prepare", "launch", "lists", "chunk_keys",
           "v2_lists_reference", "v2_walk_reference", "LIBRARY", "T", "SUBS",
           "BLOCK", "LAUNCHES", "LAUNCHES_BY_FORM"]
