"""Kernel B2: the large-scene ray query, (t, prim) over 32-triangle Woop
units walked front to back (port of the JAX package's
``ops/intersect_v4.py``: the Pallas kernel ``_build_v4_kernel`` and its
wrapper ``_v4_tables`` / ``_pad_to`` / ``_v4_call`` / ``intersect_v4``,
with the visit lists of ``intersect_v3._unit_visit_order``).

The triangles sit in 32-triangle units (``intersect_stream``'s layout,
Woop coefficients from ``intersect_v3._woop_records``). The CUDA kernel
``csrc/intersect_v4.cu`` runs one CTA per block of ``BLOCK`` lanes and
builds the block's visit list itself: it clamps maxt by the scene box
(``intersect_v2.scene_box_exit``), slab-tests every unit box against the
block's ray bounds and sorts the reachable units by their conservative
entry distance t_lo (``intersect_v3._unit_visit_order``'s list, in rounds
of at most ``cap`` entries). The list is walked for each warp's 32 lanes
on their own bound (the largest ``min(t, maxt)``; -3e38 for an any-hit
lane that has a hit), skipping units those rays cannot enter, and every
such walk is shared by the CTA's eight warps, entry by entry. Culling
is conservative, so the result equals a dense test of every lane against
every unit; the nearest hit wins, and the smallest slot among equal t.

  * ``intersect_v4(sa, ray, any_hit)`` — the kernel for CUDA tensors (one
    launch, no PyTorch visit lists), the plain version for CPU tensors;
  * ``intersect_v4_reference(sa, ray, any_hit)`` — the plain version: the
    dense Woop test of every lane against every unit in the kernel's order
    of operations, in chunks of lanes and units;
  * ``lists(tables, ray, cap)`` — the kernel's visit lists alone, for
    checking them against ``_unit_visit_order``; no render calls it;
  * ``prepare(tables, ray)`` — the visit lists in PyTorch, for the tests,
    chip_smoke.py and B5's walk step by step (``intersect_v3``); no query
    calls it;
  * ``walk_units`` — one launch of B2's kernel, or of B5's, which shares
    its C interface, its lists and its walk.

Both queries return (t, prim) in the global slot convention ([0, n_static)
static, then animated); ``ops/intersect_mxu.payload_from_prim`` rebuilds
the hit record. The any-hit form promises only occlusion (prim >= 0): the
kernel stops early with some hit, the plain version returns the closest.
``LAUNCHES`` / ``LAUNCHES_BY_FORM`` count the walk's launches.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from ..core.vec import Vec3
from ..render.types import Ray
from .cuda_build import CudaLibrary
from .intersect_kernel import _check_rays
from .intersect_stream import (CHUNK, _chunk_boxes, _chunked_layout,
                               _inst_table, _padded_cols, _runs, _unit_ray)
from .intersect_v2 import _clamped_maxt
from .intersect_v3 import _unit_visit_order, _woop_records

BLOCK = 256             # lanes per CTA = lanes per visit list
_BIG = 3.0e38
# lanes x triangles per chunk of the plain version (elements of one
# (lanes, triangles) temporary)
_REF_ELEMS = 1 << 25
_REF_UNITS = 32         # units per chunk of the plain version

LAUNCHES = 0
LAUNCHES_BY_FORM = {"closest_hit": 0, "any_hit": 0}


def reset_launch_counts():
    global LAUNCHES
    LAUNCHES = 0
    for k in LAUNCHES_BY_FORM:
        LAUNCHES_BY_FORM[k] = 0


class V4Tables(NamedTuple):
    meta: torch.Tensor      # (n_units, 2) int32: anim range | -1, slot0
    woop: torch.Tensor      # (n_units, 384) f32 Woop coefficients
    inst: torch.Tensor      # (n_ranges or 1, 26) f32 instance records
    has_anim: bool
    box: torch.Tensor       # (n_units, 6) f32 world AABBs
    n_units: int
    runs: Tuple[Tuple[int, int, int], ...]   # (anim range | -1, u0, u1)
    woop_tri: torch.Tensor  # (n_units, 32, 12) f32, triangle-major woop
    scene_box: torch.Tensor  # (6,) f32 union of the unit boxes


def v4_tables(sa) -> V4Tables:
    """The per-scene tables (JAX ``_v4_tables``), cached on the
    SceneArrays; only the visit lists are rebuilt per query."""
    if "v4" in sa._cache:
        return sa._cache["v4"]
    segments, meta = _chunked_layout(sa.n_static_tris, sa.anim_ranges)
    n_units = meta.shape[0]
    woop = _woop_records(sa, segments, n_units)
    box = _chunk_boxes(sa, n_units).contiguous()
    tables = V4Tables(
        torch.as_tensor(meta, device=sa.device).contiguous(), woop,
        _inst_table(sa), bool(sa.anim_ranges), box, n_units,
        _runs(meta, 1),
        woop.reshape(n_units, 12, CHUNK).transpose(1, 2).contiguous(),
        torch.cat([box[:, :3].amin(dim=0), box[:, 3:].amax(dim=0)]))
    sa._cache["v4"] = tables
    return tables


def prepare(tables: V4Tables, ray: Ray):
    """The visit lists in PyTorch (JAX ``_v4_call`` up to the launch), as
    the kernels of B2 and B5 build them: ray columns padded to whole
    blocks, maxt clamped by the scene box (padding lanes dead), and the
    blocks' visit lists; a lane whose maxt is NaN takes no part in its
    block's largest maxt, as in the kernels (fmaxf), where JAX's amax
    would leave the whole block nothing to reach. Returns (o, d, time,
    maxt, order, tlo)."""
    o, d, time, maxt = _padded_cols(ray, ray.maxt, BLOCK)
    maxt = _clamped_maxt(tables.box, o, d, maxt)
    x = torch.stack(list(o) + [torch.ones_like(maxt)] + list(d) + [
        torch.where(torch.isnan(maxt), -float("inf"), maxt)])
    order, tlo = _unit_visit_order(tables.box, tables.n_units, x, BLOCK)
    return o, d, time, maxt, order, tlo


# ---------------------------------------------------------------------------
# Plain version
# ---------------------------------------------------------------------------

def _woop_hit(w, r, maxt):
    """The Woop test of lanes (rows) against triangles (columns), in the
    kernel's order of operations (JAX intersect_v4.py:185-197). ``w``: 12
    (1, C) coefficient rows; ``r``: 6 (L, 1) ray columns. Returns t with
    misses at +inf."""
    rox, roy, roz, rdx, rdy, rdz = r
    ozp = w[8] * rox + w[9] * roy + w[10] * roz + w[11]
    dzp = w[8] * rdx + w[9] * rdy + w[10] * rdz
    t = -ozp / dzp              # degenerate rows -> NaN -> no hit
    o0 = w[0] * rox + w[1] * roy + w[2] * roz + w[3]
    d0 = w[0] * rdx + w[1] * rdy + w[2] * rdz
    u = o0 + t * d0
    o1 = w[4] * rox + w[5] * roy + w[6] * roz + w[7]
    d1 = w[4] * rdx + w[5] * rdy + w[6] * rdz
    vv = o1 + t * d1
    hit = ((u >= 0.0) & (vv >= 0.0) & (u + vv <= 1.0) & (t > 0.0)
           & (t < maxt))
    return torch.where(hit, t, float("inf"))


def intersect_v4_reference(sa, ray: Ray, any_hit: bool = False,
                           unit_hits: Optional[torch.Tensor] = None):
    """B2's plain version: every lane against every unit, dense, in
    chunks of lanes and units; the first slot wins among equal t (strict
    ``t < best`` in slot order). Returns (t, prim); with ``any_hit`` the
    closest hit too (any-hit promises only occlusion). ``unit_hits``
    ((N, n_units) bool, optional) receives which units each lane hits
    within its maxt (chip_smoke.py counts an any-hit walk's work from
    it)."""
    _check_rays(ray)
    tb = v4_tables(sa)
    n = ray.o.x.shape[0]
    dev = ray.o.x.device
    o = (ray.o.x, ray.o.y, ray.o.z)
    d = (ray.d.x, ray.d.y, ray.d.z)
    maxt = _clamped_maxt(tb.box, o, d, ray.maxt)
    best_t = torch.full((n,), float("inf"), device=dev)
    best_p = torch.full((n,), -1, dtype=torch.int32, device=dev)
    lanes = max(1, _REF_ELEMS // (_REF_UNITS * CHUNK))
    j = torch.arange(CHUNK, dtype=torch.int32, device=dev)
    for l0 in range(0, n, lanes):
        sl = slice(l0, min(l0 + lanes, n))
        mt = maxt[sl, None]
        bt = best_t[sl]
        bp = best_p[sl]
        for ci, u0, u1 in tb.runs:
            r = tuple(c[:, None] for c in _unit_ray(
                tb, ci, tuple(c[sl] for c in o), tuple(c[sl] for c in d),
                ray.time[sl]))
            for a in range(u0, u1, _REF_UNITS):
                b = min(a + _REF_UNITS, u1)
                # (units, 12, 32) -> 12 coefficient rows over the triangles
                w = tb.woop[a:b].reshape(b - a, 12, CHUNK).transpose(0, 1)
                w = w.reshape(12, 1, (b - a) * CHUNK)
                slots = (tb.meta[a:b, 1:2] + j).reshape(-1)
                tm = _woop_hit(w, r, mt)
                if unit_hits is not None:
                    unit_hits[sl, a:b] = torch.isfinite(tm).reshape(
                        -1, b - a, CHUNK).any(dim=2)
                k = torch.argmin(tm, dim=1)
                tk = torch.gather(tm, 1, k[:, None])[:, 0]
                take = tk < bt
                bt = torch.where(take, tk, bt)
                bp = torch.where(take, slots[k], bp)
        best_t[sl] = bt
        best_p[sl] = bp
    return best_t, best_p


# ---------------------------------------------------------------------------
# The CUDA kernel: build, load, launch
# ---------------------------------------------------------------------------

def _bind(lib):
    fn = lib.mi_intersect_v4
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
                   + [ctypes.c_void_p] * 8 + [ctypes.c_longlong, ctypes.c_int]
                   + [ctypes.c_void_p] * 3)
    fl = lib.mi_intersect_v4_lists
    fl.restype = ctypes.c_int
    fl.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 2
                   + [ctypes.c_void_p] * 8 + [ctypes.c_longlong]
                   + [ctypes.c_void_p] * 4)
    for name in ("mi_intersect_v4_block", "mi_intersect_v4_max_cap"):
        getattr(lib, name).restype = ctypes.c_int
        getattr(lib, name).argtypes = []
    if lib.mi_intersect_v4_block() != BLOCK:
        raise RuntimeError("csrc/intersect_v4.cu was built for another "
                           "block size than ops/intersect_v4.py BLOCK")


LIBRARY = CudaLibrary("intersect_v4", _bind,
                      headers=("intersect_common.cuh",))


def _columns(tables: V4Tables, ray: Ray, cap: Optional[int],
             name: str = "intersect_v4", library: CudaLibrary = LIBRARY):
    """The eight ray columns as the kernel ``name`` (B2's, or B5's, which
    takes the same arguments) takes them: contiguous float32 (n,) on the
    scene tables' CUDA device; the list capacity (default: every unit, up
    to the compiled maximum) and the loaded ``library``."""
    cols = (ray.o.x, ray.o.y, ray.o.z, ray.d.x, ray.d.y, ray.d.z, ray.time,
            ray.maxt)
    n = cols[0].shape[0]
    dev = cols[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name} kernel: rays on {dev}, need CUDA")
    if tables.woop.device != dev:
        raise ValueError(f"{name} kernel: scene tables on "
                         f"{tables.woop.device}, rays on {dev}")
    for c in cols:
        if (c.dtype != torch.float32 or not c.is_contiguous()
                or c.shape != (n,) or c.device != dev):
            raise ValueError(f"{name} kernel: ray columns must be "
                             f"contiguous ({n},) float32 on {dev}")
    lib = library.load()
    max_cap = getattr(lib, f"mi_{name}_max_cap")()
    cap = min(tables.n_units, max_cap) if cap is None else cap
    if not 1 <= cap <= max_cap:
        raise ValueError(f"{name} kernel: list capacity {cap} outside "
                         f"[1, {max_cap}]")
    return cols, n, dev, cap, lib


def walk_units(tables: V4Tables, ray: Ray, any_hit: bool,
               cap: Optional[int] = None, name: str = "intersect_v4",
               library: CudaLibrary = LIBRARY):
    """One launch of a walk over the units (``mi_<name>`` of ``library``:
    B2's, or B5's with the same C interface): the kernel builds its visit
    lists (``cap`` entries a round) and walks them. Returns (t, prim) of
    the n lanes."""
    cols, n, dev, cap, lib = _columns(tables, ray, cap, name, library)
    t = torch.empty((n,), device=dev)
    prim = torch.empty((n,), dtype=torch.int32, device=dev)
    if n > 0:
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = getattr(lib, f"mi_{name}")(
                tables.woop_tri.data_ptr(), tables.meta.data_ptr(),
                tables.inst.data_ptr(), tables.box.data_ptr(),
                tables.scene_box.data_ptr(), tables.n_units,
                int(tables.has_anim), cap,
                *(c.data_ptr() for c in cols), n, int(any_hit),
                t.data_ptr(), prim.data_ptr(), stream)
        if err != 0:
            raise RuntimeError(f"{name} kernel launch failed: CUDA error "
                               f"{err}")
    return t, prim


def launch(tables: V4Tables, ray: Ray, any_hit: bool,
           cap: Optional[int] = None):
    """One launch of B2 over the ray columns and the scene tables
    (``walk_units``). Returns (t, prim) of the n lanes."""
    global LAUNCHES
    t, prim = walk_units(tables, ray, any_hit, cap)
    if t.numel():
        LAUNCHES += 1
        LAUNCHES_BY_FORM["any_hit" if any_hit else "closest_hit"] += 1
    return t, prim


def lists(tables: V4Tables, ray: Ray, cap: Optional[int] = None):
    """The kernel's visit lists alone (a check, not a path): per block of
    ``BLOCK`` lanes the units sorted by (t_lo, unit), the unreachable ones
    last in index order with key 3e38, as ``_unit_visit_order`` gives them
    for ``prepare``'s inputs. Returns (order (n_blocks, n_units) int32,
    t_lo (n_blocks, n_units) float32, reachable units per block). For CPU
    tensors the plain version: ``prepare``'s lists, the same at any
    capacity."""
    if ray.o.x.device.type == "cpu":
        order, tlo = prepare(tables, ray)[4:]
        return order, tlo, (tlo < _BIG).sum(dim=1, dtype=torch.int32)
    cols, n, dev, cap, lib = _columns(tables, ray, cap)
    nb = -(-n // BLOCK)
    order = torch.empty((nb, tables.n_units), dtype=torch.int32, device=dev)
    tlo = torch.empty((nb, tables.n_units), device=dev)
    length = torch.empty((nb,), dtype=torch.int32, device=dev)
    if n > 0:
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.mi_intersect_v4_lists(
                tables.box.data_ptr(), tables.scene_box.data_ptr(),
                tables.n_units, cap, *(c.data_ptr() for c in cols), n,
                order.data_ptr(), tlo.data_ptr(), length.data_ptr(), stream)
        if err != 0:
            raise RuntimeError(f"intersect_v4 lists launch failed: CUDA "
                               f"error {err}")
    return order, tlo, length


def intersect_v4(sa, ray: Ray, any_hit: bool = False):
    """Closest-hit (or any-hit) (t, prim) over all triangles: the CUDA
    kernel for tensors on the card, the plain version for CPU tensors."""
    _check_rays(ray)
    if ray.o.x.device.type == "cpu":
        return intersect_v4_reference(sa, ray, any_hit)
    ray = Ray(Vec3(*(c.contiguous() for c in ray.o)),
              Vec3(*(c.contiguous() for c in ray.d)), ray.time.contiguous(),
              ray.maxt.contiguous())
    return launch(v4_tables(sa), ray, any_hit)


__all__ = ["intersect_v4", "intersect_v4_reference", "v4_tables", "prepare",
           "launch", "walk_units", "lists", "LIBRARY", "BLOCK", "LAUNCHES",
           "LAUNCHES_BY_FORM"]
