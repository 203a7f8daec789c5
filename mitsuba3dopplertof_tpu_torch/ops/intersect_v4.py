"""Kernel B2: the large-scene ray query, (t, prim) over 32-triangle Woop
units walked front to back (port of the JAX package's
``ops/intersect_v4.py``: the Pallas kernel ``_build_v4_kernel`` and its
wrapper ``_v4_tables`` / ``_pad_to`` / ``_v4_call`` / ``intersect_v4``).

The triangles sit in 32-triangle units (``intersect_stream``'s layout,
Woop coefficients from ``intersect_v3._woop_records``). For each block of
``BLOCK`` lanes a dense slab test in PyTorch sorts the units by a
conservative entry distance t_lo (``intersect_v3._unit_visit_order``);
rays are clamped to the scene box first (``intersect_v2.scene_box_exit``).
The CUDA kernel ``csrc/intersect_v4.cu`` runs one CTA per block: it walks
the block's list in groups of ``GROUP`` units and stops once the next
group's t_lo exceeds the block's bound (the largest ``min(t, maxt)`` of its
lanes; -3e38 for an any-hit lane that has a hit). Culling is conservative,
so the result equals a dense test of every lane against every unit up to
ties in t.

  * ``intersect_v4(sa, ray, any_hit)`` — the kernel for CUDA tensors, the
    plain version for CPU tensors;
  * ``intersect_v4_reference(sa, ray, any_hit)`` — the plain version: the
    dense Woop test of every lane against every unit in the kernel's order
    of operations, in chunks of lanes and units.

Both return (t, prim) in the global slot convention ([0, n_static)
static, then animated); ``ops/intersect_mxu.payload_from_prim`` rebuilds
the hit record. The any-hit form promises only occlusion (prim >= 0): the
kernel stops early with some hit, the plain version returns the closest.
``LAUNCHES`` / ``LAUNCHES_BY_FORM`` count kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from ..render.types import Ray
from .cuda_build import CudaLibrary
from .intersect_kernel import _check_rays, _inv_lerped
from .intersect_stream import CHUNK, _chunked_layout, _inst_table
from .intersect_v2 import scene_box_exit
from .intersect_v3 import _unit_visit_order, _woop_records

GROUP = 8               # units per step of the walk
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


def v4_tables(sa) -> V4Tables:
    """The per-scene tables (JAX ``_v4_tables``), cached on the
    SceneArrays; only the visit lists are rebuilt per query."""
    if "v4" in sa._cache:
        return sa._cache["v4"]
    segments, meta = _chunked_layout(sa.n_static_tris, sa.anim_ranges)
    n_units = meta.shape[0]
    box = sa.chunk_aabb
    if box is None:
        box = torch.cat([torch.full((n_units, 3), -_BIG, device=sa.device),
                         torch.full((n_units, 3), _BIG, device=sa.device)],
                        dim=1)
    runs = []
    for u, ci in enumerate(meta[:, 0].tolist()):
        if runs and runs[-1][0] == ci:
            runs[-1][2] = u + 1
        else:
            runs.append([ci, u, u + 1])
    tables = V4Tables(
        torch.as_tensor(meta, device=sa.device).contiguous(),
        _woop_records(sa, segments, n_units), _inst_table(sa),
        bool(sa.anim_ranges), box.contiguous(), n_units,
        tuple(tuple(r) for r in runs))
    sa._cache["v4"] = tables
    return tables


def _pad_to(x, n_pad: int, fill=None):
    """Pad (N,) ``x`` to ``n_pad`` lanes: with ``fill``, or by repeating
    the last lane (keeps the last block's ray bounds tight)."""
    n = x.shape[0]
    if n_pad == n:
        return x
    if fill is None:
        tail = x[-1:].expand(n_pad - n)
    else:
        tail = torch.full((n_pad - n,), fill, dtype=x.dtype, device=x.device)
    return torch.cat([x, tail])


def _clamped_maxt(tables: V4Tables, o, d, maxt):
    """maxt clamped to 3e38 and to the scene-box exit (-1 off the box)."""
    return torch.minimum(torch.clamp(maxt, max=_BIG),
                         scene_box_exit(tables.box, o, d))


def prepare(tables: V4Tables, ray: Ray):
    """The kernel's per-query inputs (JAX ``_v4_call`` up to the launch):
    ray columns padded to whole blocks, maxt clamped by the scene box
    (padding lanes dead), and the blocks' visit lists. Returns (o, d,
    time, maxt, order, tlo)."""
    n = ray.o.x.shape[0]
    n_pad = -(-n // BLOCK) * BLOCK
    o = tuple(_pad_to(c, n_pad) for c in (ray.o.x, ray.o.y, ray.o.z))
    d = tuple(_pad_to(c, n_pad) for c in (ray.d.x, ray.d.y, ray.d.z))
    maxt = _clamped_maxt(tables, o, d, _pad_to(ray.maxt, n_pad, fill=-1.0))
    x = torch.stack(list(o) + [torch.ones_like(maxt)] + list(d) + [maxt])
    order, tlo = _unit_visit_order(tables.box, tables.n_units, x, BLOCK)
    return o, d, _pad_to(ray.time, n_pad), maxt, order, tlo


# ---------------------------------------------------------------------------
# Plain version
# ---------------------------------------------------------------------------

def _unit_ray(tables: V4Tables, ci: int, o, d, time):
    """The ray in the hit space of units of transform group ``ci`` (-1
    static), as the kernel computes it (JAX intersect_v4.py:158-173):
    ``fa * (M^-1 x) + om * x`` with fa = 1 for animated units, 0 for
    static ones."""
    if not tables.has_anim:
        return (*o, *d)
    rec = tables.inst[max(ci, 0)]
    i3, it3 = _inv_lerped(tuple(rec[j] for j in range(12)),
                          tuple(rec[12 + j] for j in range(12)),
                          rec[24], rec[25], time)
    fa = 1.0 if ci >= 0 else 0.0
    om = 1.0 - fa
    ox, oy, oz = o
    dx, dy, dz = d
    return (fa * (i3[0] * ox + i3[1] * oy + i3[2] * oz + it3[0]) + om * ox,
            fa * (i3[3] * ox + i3[4] * oy + i3[5] * oz + it3[1]) + om * oy,
            fa * (i3[6] * ox + i3[7] * oy + i3[8] * oz + it3[2]) + om * oz,
            fa * (i3[0] * dx + i3[1] * dy + i3[2] * dz) + om * dx,
            fa * (i3[3] * dx + i3[4] * dy + i3[5] * dz) + om * dy,
            fa * (i3[6] * dx + i3[7] * dy + i3[8] * dz) + om * dz)


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


def intersect_v4_reference(sa, ray: Ray, any_hit: bool = False):
    """B2's plain version: every lane against every unit, dense, in
    chunks of lanes and units; the first slot wins among equal t (strict
    ``t < best`` in slot order). Returns (t, prim); with ``any_hit`` the
    closest hit too (any-hit promises only occlusion)."""
    _check_rays(ray)
    tb = v4_tables(sa)
    n = ray.o.x.shape[0]
    dev = ray.o.x.device
    o = (ray.o.x, ray.o.y, ray.o.z)
    d = (ray.d.x, ray.d.y, ray.d.z)
    maxt = _clamped_maxt(tb, o, d, ray.maxt)
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
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 2
                   + [ctypes.c_void_p] * 8 + [ctypes.c_longlong, ctypes.c_int]
                   + [ctypes.c_void_p] * 4)
    lib.mi_intersect_v4_block.restype = ctypes.c_int
    lib.mi_intersect_v4_block.argtypes = []
    if lib.mi_intersect_v4_block() != BLOCK:
        raise RuntimeError("csrc/intersect_v4.cu was built for another "
                           "block size than ops/intersect_v4.py BLOCK")


LIBRARY = CudaLibrary("intersect_v4", _bind)


def launch(tables: V4Tables, prep, any_hit: bool,
           groups_out: Optional[torch.Tensor] = None):
    """One launch over prepared inputs (``prepare``). Returns (t, prim) at
    the padded length. ``groups_out`` ((n_blocks,) int32, optional)
    receives the number of groups each block walked."""
    global LAUNCHES
    o, d, time, maxt, order, tlo = prep
    cols = (*o, *d, time, maxt)
    n_pad = maxt.shape[0]
    dev = maxt.device
    if dev.type != "cuda":
        raise ValueError(f"intersect_v4 kernel: rays on {dev}, need CUDA")
    if tables.woop.device != dev:
        raise ValueError(f"intersect_v4 kernel: scene tables on "
                         f"{tables.woop.device}, rays on {dev}")
    for c in cols:
        if (c.dtype != torch.float32 or not c.is_contiguous()
                or c.shape != (n_pad,) or c.device != dev):
            raise ValueError("intersect_v4 kernel: ray columns must be "
                             f"contiguous ({n_pad},) float32 on {dev}")
    nb = n_pad // BLOCK
    if n_pad % BLOCK or order.shape != (nb, tables.n_units) \
            or tlo.shape != order.shape:
        raise ValueError("intersect_v4 kernel: lanes must fill whole "
                         "blocks with one visit list each")
    if groups_out is not None and (groups_out.shape != (nb,)
                                   or groups_out.dtype != torch.int32):
        raise ValueError("intersect_v4 kernel: groups_out must be "
                         f"({nb},) int32")
    lib = LIBRARY.load()
    t = torch.empty((n_pad,), device=dev)
    prim = torch.empty((n_pad,), dtype=torch.int32, device=dev)
    if n_pad > 0:
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.mi_intersect_v4(
                tables.woop.data_ptr(), tables.meta.data_ptr(),
                tables.inst.data_ptr(), order.data_ptr(), tlo.data_ptr(),
                tables.n_units, int(tables.has_anim),
                *(c.data_ptr() for c in cols), n_pad, int(any_hit),
                t.data_ptr(), prim.data_ptr(),
                groups_out.data_ptr() if groups_out is not None else None,
                stream)
        if err != 0:
            raise RuntimeError(f"intersect_v4 kernel launch failed: CUDA "
                               f"error {err}")
        LAUNCHES += 1
        LAUNCHES_BY_FORM["any_hit" if any_hit else "closest_hit"] += 1
    return t, prim


def intersect_v4(sa, ray: Ray, any_hit: bool = False):
    """Closest-hit (or any-hit) (t, prim) over all triangles: the CUDA
    kernel for tensors on the card, the plain version for CPU tensors."""
    _check_rays(ray)
    if ray.o.x.device.type == "cpu":
        return intersect_v4_reference(sa, ray, any_hit)
    n = ray.o.x.shape[0]
    tables = v4_tables(sa)
    t, prim = launch(tables, prepare(tables, ray), any_hit)
    return t[:n], prim[:n]


__all__ = ["intersect_v4", "intersect_v4_reference", "v4_tables", "prepare",
           "launch", "LIBRARY", "GROUP", "BLOCK", "LAUNCHES",
           "LAUNCHES_BY_FORM"]
