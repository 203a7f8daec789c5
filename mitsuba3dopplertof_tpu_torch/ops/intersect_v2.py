"""Kernel B4 and the scene-box exit bound of the large-scene kernels (port
of the JAX package's ``ops/intersect_v2.py``: the Pallas kernel
``_build_v2_kernel`` with its wrapper ``intersect_v2``, ``_tri_records``
and ``scene_box_exit``, which B2 and B5 share).

B4 (``MI_STREAM_KERNEL=v2``) walks 128-triangle chunks front to back with
Möller-Trumbore. For each block of ``BLOCK`` lanes a dense slab test in
PyTorch sorts the chunks by the conservative entry distance of the union
of their four 32-triangle boxes (``intersect_mxu._visit_order``); rays are
clamped to the scene box first. The CUDA kernel ``csrc/intersect_v2.cu``
runs one CTA per block, stops at the first chunk whose t_lo exceeds the
block's bound, and inside a chunk runs each 32-triangle quarter only if
its own box passes the slab test with the current bound. Culling is
conservative, so the result equals the dense Möller test of every lane
against every chunk up to ties in t.

  * ``intersect_v2(sa, ray, any_hit)`` — the kernel for CUDA tensors, the
    plain version for CPU tensors;
  * ``intersect_v2_reference(sa, ray, any_hit)`` — the plain version: the
    dense Möller test over the padded chunk table with the clamped maxt.

Both return (t, prim) in the global slot convention;
``ops/intersect_mxu.payload_from_prim`` rebuilds the hit record.
``LAUNCHES`` / ``LAUNCHES_BY_FORM`` count kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch

from ..render.types import Ray
from .cuda_build import CudaLibrary
from .intersect_kernel import _GEOM, _check_rays
from .intersect_mxu import _visit_order
from .intersect_stream import (BLOCK, CHUNK, PAD_TO, _chunk_boxes,
                               _chunked_layout, _inst_table, _launch_walk,
                               _moller_dense, _padded_cols, _runs)

T = PAD_TO                # triangles per visit chunk (= transform-group pad)
SUBS = T // CHUNK         # 32-triangle culling boxes per chunk
TRI_ROWS = 9              # v0, e1, e2 components
_BIG = 3.0e38

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


def v2_tables(sa) -> V2Tables:
    """B4's per-scene tables, cached on the SceneArrays."""
    if "v2" in sa._cache:
        return sa._cache["v2"]
    segments, meta32 = _chunked_layout(sa.n_static_tris, sa.anim_ranges)
    n_chunks = meta32.shape[0] // SUBS
    meta = meta32[::SUBS]
    meta_t = torch.as_tensor(meta, device=sa.device).contiguous()
    slots = (meta_t[:, 1:2] + torch.arange(T, dtype=torch.int32,
                                           device=sa.device)).reshape(-1)
    tables = V2Tables(
        meta_t, _tri_records(sa, segments, n_chunks), _inst_table(sa),
        bool(sa.anim_ranges),
        _chunk_boxes(sa, SUBS * n_chunks).contiguous(), n_chunks,
        _runs(meta, T), slots)
    sa._cache["v2"] = tables
    return tables


def _clamped_maxt(sub, o, d, maxt):
    """maxt clamped to 3e38 and to the scene-box exit (-1 off the box)."""
    return torch.minimum(torch.clamp(maxt, max=_BIG),
                         scene_box_exit(sub, o, d))


def prepare(tables: V2Tables, ray: Ray):
    """The kernel's per-query inputs (JAX ``intersect_v2`` :432-440): ray
    columns padded to whole blocks, maxt clamped by the scene box (padding
    lanes dead), and the blocks' visit lists over the chunks. Returns (o,
    d, time, maxt, order, tlo)."""
    o, d, time, maxt = _padded_cols(ray, ray.maxt, BLOCK)
    maxt = _clamped_maxt(tables.sub, o, d, maxt)
    x = torch.stack(list(o) + [torch.ones_like(maxt)] + list(d) + [maxt])
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


def _bind(lib):
    fn = lib.mi_intersect_v2
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 2
                   + [ctypes.c_void_p] * 8 + [ctypes.c_longlong, ctypes.c_int]
                   + [ctypes.c_void_p] * 3)
    lib.mi_intersect_v2_block.restype = ctypes.c_int
    lib.mi_intersect_v2_block.argtypes = []
    if lib.mi_intersect_v2_block() != BLOCK:
        raise RuntimeError("csrc/intersect_v2.cu was built for another "
                           "block size than ops/intersect_stream.py BLOCK")


LIBRARY = CudaLibrary("intersect_v2", _bind,
                      headers=("intersect_common.cuh",))


def launch(tables: V2Tables, prep, any_hit: bool):
    """One launch over prepared inputs (``prepare``). Returns (t, prim) at
    the padded length."""
    global LAUNCHES
    t, prim = _launch_walk("intersect_v2", LIBRARY,
                           tables.tri, tables.sub, tables, tables.n_chunks,
                           prep, any_hit)
    if t.numel():
        LAUNCHES += 1
        LAUNCHES_BY_FORM["any_hit" if any_hit else "closest_hit"] += 1
    return t, prim


def intersect_v2(sa, ray: Ray, any_hit: bool = False):
    """Closest-hit (or any-hit) (t, prim) over all triangles in
    128-triangle chunks: the CUDA kernel for tensors on the card, the
    plain version for CPU tensors."""
    _check_rays(ray)
    if ray.o.x.device.type == "cpu":
        return intersect_v2_reference(sa, ray, any_hit)
    n = ray.o.x.shape[0]
    tables = v2_tables(sa)
    t, prim = launch(tables, prepare(tables, ray), any_hit)
    return t[:n], prim[:n]


__all__ = ["scene_box_exit", "intersect_v2", "intersect_v2_reference",
           "v2_tables", "prepare", "launch", "LIBRARY", "T", "SUBS", "BLOCK",
           "LAUNCHES", "LAUNCHES_BY_FORM"]
