"""Kernel B3 and the chunked triangle layout of the large-scene kernels
(port of the JAX package's ``ops/intersect_stream.py``: the Pallas kernel
``_build_stream_kernel`` with its wrapper ``intersect_stream``, and the
helpers ``_chunked_layout``, ``chunk_aabbs``, ``_assemble_tri_table`` and
``_inst_table``).

Triangles are cut into 32-triangle chunks; each transform group (the
static triangles, then each animated range) is padded to a multiple of
``PAD_TO`` triangles so that no chunk mixes groups. A chunk carries its
animated-range index (-1 static) and the global slot of its first
triangle.

B3 (``MI_STREAM_KERNEL=v1``) is the streamed query: no ordering and no
scene-box clamp. A block of ``BLOCK`` lanes goes through the chunks in
table order, eight at a time: a conservative slab test of the block's ray
bounds against the group's box, then against each chunk's box, with
``t_hi = min(largest maxt, largest best t)`` of the block as the far end,
decides which chunks run Möller-Trumbore. Closest-hit returns the full
``HitRecord`` (no ``payload_from_prim`` on this route; missed lanes carry
zeros, as the TPU kernel leaves them), any-hit (t, prim).

  * ``intersect_stream(sa, ray, any_hit)`` — the CUDA kernel
    ``csrc/intersect_stream.cu`` for CUDA tensors, the plain version for
    CPU tensors;
  * ``intersect_stream_reference(sa, ray, any_hit)`` — the plain version:
    the dense Möller test of every lane against every padded triangle
    (first table row on ties), then the winner's record interpolated.

``LAUNCHES`` / ``LAUNCHES_BY_FORM`` count kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..core.vec import Vec3
from ..render.types import Ray
from .cuda_build import CudaLibrary
from .intersect_kernel import (_GEOM, _TRI_NAMES, HitRecord, _check_rays,
                               _inv_lerped, _scan)

CHUNK = 32          # triangles per culling unit (one conservative AABB)
PAD_TO = 128        # each transform group pads to this boundary
CPG = 8             # chunks per group box of B3's two-level test
BLOCK = 256         # lanes per CTA = lanes per block of B3-B6 (kBlock of
                    # csrc/intersect_common.cuh)
TRI_REC = 25        # floats per triangle of B3's table (B1's record)
_BIG = 3.0e38

LAUNCHES = 0
LAUNCHES_BY_FORM = {"closest_hit": 0, "any_hit": 0}


def reset_launch_counts():
    global LAUNCHES
    LAUNCHES = 0
    for k in LAUNCHES_BY_FORM:
        LAUNCHES_BY_FORM[k] = 0


def _chunked_layout(n_static: int, anim_ranges):
    """Host-side chunk layout (JAX intersect_stream.py:316). Returns
    (segments, chunk_meta): segments = [(kind, src_start, count)] with kind
    's'/'a'/'pad', describing the padded triangle table; chunk_meta is
    (n_chunks, 2) int32 [anim range index | -1, global slot of first tri].
    """
    segments = []
    meta = []

    def add_group(kind, src_start, count, slot_base, anim_idx):
        if count == 0:
            return
        segments.append((kind, src_start, count))
        pad = (-count) % PAD_TO
        if pad:
            segments.append(("pad", 0, pad))
        for c in range(-(-(count + pad) // CHUNK)):
            meta.append((anim_idx, slot_base + c * CHUNK))

    add_group("s", 0, n_static, 0, -1)
    for a, (inst, start, count) in enumerate(anim_ranges):
        add_group("a", start, count, n_static + start, a)
    if not meta:                         # no triangles at all
        segments.append(("pad", 0, PAD_TO))
        for c in range(PAD_TO // CHUNK):
            meta.append((-1, 0))
    return segments, np.asarray(meta, np.int32)


def chunk_aabbs(n_static: int, anim_ranges, s_v0, s_e1, s_e2,
                a_v0, a_e1, a_e2, inst_m0, inst_m1) -> np.ndarray:
    """Host-side per-chunk world AABBs (n_chunks, 6) following
    ``_chunked_layout`` (JAX intersect_stream.py:346).

    ``s_*``/``a_*``: (T, 3) numpy vertex/edge arrays (static world space,
    animated object space). ``inst_m0/m1``: per anim-range (3,4) keyframe
    matrices. Animated chunk boxes are the union of both keyframe images,
    which bounds the component-wise matrix lerp (every moving point is a
    convex combination of its two keyframe images, reference
    transform.h:461-466). Pad-only chunks keep an inverted box: never
    visited."""
    segments, meta = _chunked_layout(n_static, anim_ranges)
    n_chunks = meta.shape[0]
    out = np.empty((n_chunks, 6), np.float32)
    out[:, :3] = np.float32(3e38)
    out[:, 3:] = np.float32(-3e38)
    range_by_start = {r[1]: i for i, r in enumerate(anim_ranges)}
    ci = 0
    for kind, start, count in segments:
        if kind == "pad":
            continue
        if kind == "s":
            v0 = s_v0[start:start + count]
            p1 = v0 + s_e1[start:start + count]
            p2 = v0 + s_e2[start:start + count]
            pts = (v0, p1, p2)
        else:
            a = range_by_start[start]
            v0 = a_v0[start:start + count]
            p1 = v0 + a_e1[start:start + count]
            p2 = v0 + a_e2[start:start + count]
            pts = []
            for m in (inst_m0[a], inst_m1[a]):
                for p in (v0, p1, p2):
                    pts.append(p @ m[:3, :3].T + m[:3, 3])
        for c in range(-(-count // CHUNK)):
            sl = slice(c * CHUNK, min((c + 1) * CHUNK, count))
            lo = np.min([p[sl].min(axis=0) for p in pts], axis=0)
            hi = np.max([p[sl].max(axis=0) for p in pts], axis=0)
            pad = 1e-5 * np.maximum(np.abs(lo), np.abs(hi)) + 1e-7
            out[ci, :3] = lo - pad
            out[ci, 3:] = hi + pad
            ci += 1
        # pad-only chunks at the group's tail keep their inverted boxes
        ci += (count + (-count) % PAD_TO) // CHUNK - (-(-count // CHUNK))
    assert ci <= n_chunks
    return out


def _inst_table(sa) -> torch.Tensor:
    """(n_anim, 26) f32 records of the animated ranges' instances: m0
    (3x4), m1 (3x4), t0, t1; one zero row for a static scene. Cached on
    the SceneArrays."""
    if "inst" not in sa._cache:
        sa._cache["inst"] = torch.stack([torch.cat([
            sa.inst_m0c[:, inst], sa.inst_m1c[:, inst],
            sa.inst_t0[inst:inst + 1], sa.inst_t1[inst:inst + 1]])
            for (inst, start, count) in sa.anim_ranges]).contiguous() \
            if sa.anim_ranges else torch.zeros((1, 26), device=sa.device)
    return sa._cache["inst"]


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


def _padded_cols(ray: Ray, maxt, block: int):
    """The eight ray columns padded to whole blocks of ``block`` lanes:
    o, d and time repeat the last lane, maxt is dead (-1) in the padding.
    Returns (o 3-tuple, d 3-tuple, time, maxt)."""
    n = maxt.shape[0]
    n_pad = -(-n // block) * block
    return (tuple(_pad_to(c, n_pad) for c in (ray.o.x, ray.o.y, ray.o.z)),
            tuple(_pad_to(c, n_pad) for c in (ray.d.x, ray.d.y, ray.d.z)),
            _pad_to(ray.time, n_pad), _pad_to(maxt, n_pad, fill=-1.0))


def _check_launch(name: str, table: torch.Tensor, cols, block: int):
    """What every large-scene kernel asks of its inputs: contiguous
    float32 columns of one length, a multiple of ``block``, on the CUDA
    device of the scene tables. Returns (n_pad, device)."""
    n_pad = cols[0].shape[0]
    dev = cols[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name} kernel: rays on {dev}, need CUDA")
    if table.device != dev:
        raise ValueError(f"{name} kernel: scene tables on {table.device}, "
                         f"rays on {dev}")
    for c in cols:
        if (c.dtype != torch.float32 or not c.is_contiguous()
                or c.shape != (n_pad,) or c.device != dev):
            raise ValueError(f"{name} kernel: ray columns must be "
                             f"contiguous ({n_pad},) float32 on {dev}")
    if n_pad % block:
        raise ValueError(f"{name} kernel: lanes must fill whole blocks of "
                         f"{block}")
    return n_pad, dev


def _chunk_boxes(sa, n_chunks: int) -> torch.Tensor:
    """The scene's (n_chunks, 6) chunk boxes; unbounded ones (no culling)
    for a scene compiled without them."""
    if sa.chunk_aabb is not None:
        return sa.chunk_aabb
    return torch.cat([torch.full((n_chunks, 3), -_BIG, device=sa.device),
                      torch.full((n_chunks, 3), _BIG, device=sa.device)],
                     dim=1)


def _launch_walk(name: str, library: CudaLibrary, records, boxes, tables,
                 n_list: int, prep, any_hit: bool):
    """One launch of an ordered (t, prim) walk with the C interface that
    B5 and B4 share: ``mi_<name>(records, meta, inst, boxes, order, tlo,
    n_list, has_anim, 8 ray columns, n, any_hit, t, prim, stream)`` of ``library``, built and loaded once the inputs pass.
    ``prep``: (o, d, time, maxt, order, tlo), one visit list of ``n_list``
    entries per block of ``BLOCK`` lanes. Returns (t, prim) at the padded
    length; raises if the launch fails."""
    o, d, time, maxt, order, tlo = prep
    cols = (*o, *d, time, maxt)
    n_pad, dev = _check_launch(name, records, cols, BLOCK)
    nb = n_pad // BLOCK
    if order.shape != (nb, n_list) or tlo.shape != order.shape:
        raise ValueError(f"{name} kernel: one visit list of {n_list} "
                         f"entries per block of {BLOCK} lanes")
    fn = getattr(library.load(), f"mi_{name}")
    t = torch.empty((n_pad,), device=dev)
    prim = torch.empty((n_pad,), dtype=torch.int32, device=dev)
    if n_pad > 0:
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = fn(records.data_ptr(), tables.meta.data_ptr(),
                     tables.inst.data_ptr(), boxes.data_ptr(),
                     order.data_ptr(), tlo.data_ptr(), n_list,
                     int(tables.has_anim), *(c.data_ptr() for c in cols),
                     n_pad, int(any_hit), t.data_ptr(), prim.data_ptr(),
                     stream)
        if err != 0:
            raise RuntimeError(f"{name} kernel launch failed: CUDA error "
                               f"{err}")
    return t, prim


def _runs(meta: np.ndarray, rows: int):
    """Runs of consecutive chunks of one transform group, in table rows of
    ``rows`` triangles per chunk: ((anim range | -1, row0, row1), ...)."""
    runs = []
    for c, ci in enumerate(meta[:, 0].tolist()):
        if runs and runs[-1][0] == ci:
            runs[-1][2] = (c + 1) * rows
        else:
            runs.append([ci, c * rows, (c + 1) * rows])
    return tuple(tuple(r) for r in runs)


def _unit_ray(tables, ci: int, o, d, time):
    """The ray in the hit space of transform group ``ci`` (-1 static), as
    the kernels compute it (JAX intersect_stream.py:178-195):
    ``fa * (M^-1 x) + om * x`` with fa = 1 for animated groups, 0 for
    static ones. ``tables``: any kernel's tables with ``has_anim`` and
    ``inst``."""
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


def _moller_dense(tables, cols, runs, o, d, time, maxt):
    """Every lane against every row of a padded triangle table with
    Möller-Trumbore in the kernels' order of operations
    (``intersect_kernel._scan``), each run of rows in its transform
    group's hit space. The first row wins among equal t. Returns (t with
    misses at +inf, winning row | -1)."""
    n = maxt.shape[0]
    best_t = torch.full((n,), float("inf"), device=maxt.device)
    best_row = torch.full((n,), -1, dtype=torch.int32, device=maxt.device)
    for ci, r0, r1 in runs:
        r = _unit_ray(tables, ci, o, d, time)
        best_t, best_row = _scan(Vec3(*r[:3]), Vec3(*r[3:]), maxt, cols, r0,
                                 r1 - r0, best_t, best_row)
    return best_t, best_row


# ---------------------------------------------------------------------------
# B3: tables, plain version, kernel
# ---------------------------------------------------------------------------

def _assemble_tri_table(sa, segments) -> torch.Tensor:
    """The padded triangle table, (P, 25) f32 (JAX
    intersect_stream.py:395): B1's record per triangle, zero rows for
    padding (zero edges: det = 0, never hit)."""
    parts = []
    for kind, start, count in segments:
        if kind == "pad":
            parts.append(torch.zeros((count, TRI_REC), device=sa.device))
            continue
        seg = [sa.tri(kind, c)[start:start + count] for c in _TRI_NAMES[:-1]]
        seg.append(sa.tri(kind, "inst")[start:start + count]
                   .to(torch.float32))
        parts.append(torch.stack(seg, dim=-1))
    return torch.cat(parts, dim=0)


class StreamTables(NamedTuple):
    tri: torch.Tensor       # (n_chunks * 32, 25) f32
    meta: torch.Tensor      # (n_chunks, 2) int32: anim range | -1, slot0
    aabb: torch.Tensor      # (n_chunks, 6) f32 chunk boxes
    grp: torch.Tensor       # (n_chunks / CPG, 6) f32 group boxes
    inst: torch.Tensor      # (n_ranges or 1, 26) f32 instance records
    has_anim: bool
    n_chunks: int           # a multiple of CPG
    runs: Tuple[Tuple[int, int, int], ...]   # (anim range | -1, row0, row1)
    slots: torch.Tensor     # (n_chunks * 32,) int32 global slot of each row


def stream_tables(sa) -> StreamTables:
    """B3's per-scene tables (JAX ``intersect_stream`` :440-468), cached on
    the SceneArrays. The chunk tables are padded to a multiple of ``CPG``
    with never-visited chunks (zero triangles, inverted boxes); a group's
    box is the union of its ``CPG`` chunks' boxes."""
    if "stream" in sa._cache:
        return sa._cache["stream"]
    dev = sa.device
    segments, meta = _chunked_layout(sa.n_static_tris, sa.anim_ranges)
    tri = _assemble_tri_table(sa, segments)
    n_chunks = meta.shape[0]
    aabb = _chunk_boxes(sa, n_chunks)
    pad_c = (-n_chunks) % CPG
    if pad_c:
        tri = torch.cat([tri, torch.zeros((pad_c * CHUNK, TRI_REC),
                                          device=dev)])
        meta = np.concatenate([meta, np.zeros((pad_c, 2), np.int32)])
        aabb = torch.cat([aabb, torch.cat(
            [torch.full((pad_c, 3), _BIG, device=dev),
             torch.full((pad_c, 3), -_BIG, device=dev)], dim=1)])
        n_chunks += pad_c
    ga = aabb.reshape(n_chunks // CPG, CPG, 6)
    grp = torch.cat([ga[:, :, :3].amin(dim=1), ga[:, :, 3:].amax(dim=1)],
                    dim=1)
    meta_t = torch.as_tensor(meta, device=dev).contiguous()
    slots = (meta_t[:, 1:2] + torch.arange(CHUNK, dtype=torch.int32,
                                           device=dev)).reshape(-1)
    tables = StreamTables(tri.contiguous(), meta_t, aabb.contiguous(),
                          grp.contiguous(), _inst_table(sa),
                          bool(sa.anim_ranges), n_chunks,
                          _runs(meta, CHUNK), slots)
    sa._cache["stream"] = tables
    return tables


def intersect_stream_reference(sa, ray: Ray, any_hit: bool = False):
    """B3's plain version. Closest-hit: the ``HitRecord`` of the dense
    Möller scan's winner, its u, v recomputed and its normals and uv
    interpolated from its table row in the kernel's order of operations
    (JAX intersect_stream.py:206-262); missed lanes carry t = inf,
    prim = -1 and zeros. Any-hit: (t, prim) of the closest hit (any-hit
    promises only occlusion)."""
    _check_rays(ray)
    tb = stream_tables(sa)
    o = (ray.o.x, ray.o.y, ray.o.z)
    d = (ray.d.x, ray.d.y, ray.d.z)
    cols = {c: tb.tri[:, i] for i, c in enumerate(_GEOM)}
    t, row = _moller_dense(tb, cols, tb.runs, o, d, ray.time, ray.maxt)
    valid = row >= 0
    idx = torch.clamp(row, min=0).long()
    prim = torch.where(valid, tb.slots[idx], -1)
    if any_hit:
        return t, prim

    rec = tb.tri[idx]                                    # (N, 25)
    if tb.has_anim:
        ci = tb.meta[idx // CHUNK, 0]
        irec = tb.inst[torch.clamp(ci, min=0).long()]
        i3, it3 = _inv_lerped(tuple(irec[:, j] for j in range(12)),
                              tuple(irec[:, 12 + j] for j in range(12)),
                              irec[:, 24], irec[:, 25], ray.time)
        fa = (ci >= 0).to(torch.float32)
        om = 1.0 - fa
        o = tuple(fa * (i3[3 * k] * o[0] + i3[3 * k + 1] * o[1]
                        + i3[3 * k + 2] * o[2] + it3[k]) + om * o[k]
                  for k in range(3))
        d = tuple(fa * (i3[3 * k] * d[0] + i3[3 * k + 1] * d[1]
                        + i3[3 * k + 2] * d[2]) + om * d[k]
                  for k in range(3))
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = (rec[:, i]
                                                   for i in range(9))
    px = d[1] * e2z - d[2] * e2y
    py = d[2] * e2x - d[0] * e2z
    pz = d[0] * e2y - d[1] * e2x
    det = e1x * px + e1y * py + e1z * pz
    inv = 1.0 / torch.where(torch.abs(det) > 1e-12, det, 1.0)
    tx = o[0] - v0x
    ty = o[1] - v0y
    tz = o[2] - v0z
    u = (tx * px + ty * py + tz * pz) * inv
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    v = (d[0] * qx + d[1] * qy + d[2] * qz) * inv
    w = 1.0 - u - v

    gx = e1y * e2z - e1z * e2y
    gy = e1z * e2x - e1x * e2z
    gz = e1x * e2y - e1y * e2x
    nx = w * rec[:, 9] + u * rec[:, 12] + v * rec[:, 15]
    ny = w * rec[:, 10] + u * rec[:, 13] + v * rec[:, 16]
    nz = w * rec[:, 11] + u * rec[:, 14] + v * rec[:, 17]
    if tb.has_anim:
        def inv_t(x, y, z):
            return (fa * (i3[0] * x + i3[3] * y + i3[6] * z) + om * x,
                    fa * (i3[1] * x + i3[4] * y + i3[7] * z) + om * y,
                    fa * (i3[2] * x + i3[5] * y + i3[8] * z) + om * z)
        gx, gy, gz = inv_t(gx, gy, gz)
        nx, ny, nz = inv_t(nx, ny, nz)
    uv_u = w * rec[:, 18] + u * rec[:, 20] + v * rec[:, 22]
    uv_v = w * rec[:, 19] + u * rec[:, 21] + v * rec[:, 23]
    zero = torch.zeros_like(t)
    return HitRecord(
        t, prim, torch.where(valid, rec[:, 24].to(torch.int32), 0),
        *(torch.where(valid, x, zero)
          for x in (u, v, gx, gy, gz, nx, ny, nz, uv_u, uv_v)))


def _bind(lib):
    fn = lib.mi_intersect_stream
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 2
                   + [ctypes.c_void_p] * 8 + [ctypes.c_longlong, ctypes.c_int]
                   + [ctypes.c_void_p] * 3)
    lib.mi_intersect_stream_block.restype = ctypes.c_int
    lib.mi_intersect_stream_block.argtypes = []
    if lib.mi_intersect_stream_block() != BLOCK:
        raise RuntimeError("csrc/intersect_stream.cu was built for another "
                           "block size than ops/intersect_stream.py BLOCK")


LIBRARY = CudaLibrary("intersect_stream", _bind,
                      headers=("intersect_common.cuh",))


def prepare(tables: StreamTables, ray: Ray):
    """The kernel's per-query inputs: the ray columns padded to whole
    blocks, padding lanes dead (maxt = -1). Returns (o, d, time, maxt)."""
    return _padded_cols(ray, ray.maxt, BLOCK)


def launch(tables: StreamTables, prep, any_hit: bool):
    """One launch over prepared inputs (``prepare``). Returns, at the
    padded length, the ``HitRecord`` or, with ``any_hit``, (t, prim)."""
    global LAUNCHES
    o, d, time, maxt = prep
    cols = (*o, *d, time, maxt)
    n_pad, dev = _check_launch("intersect_stream", tables.tri, cols, BLOCK)
    lib = LIBRARY.load()
    outf = torch.empty((1 if any_hit else 11, n_pad), device=dev)
    outi = torch.empty((1 if any_hit else 2, n_pad), dtype=torch.int32,
                       device=dev)
    if n_pad > 0:
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.mi_intersect_stream(
                tables.tri.data_ptr(), tables.meta.data_ptr(),
                tables.aabb.data_ptr(), tables.grp.data_ptr(),
                tables.inst.data_ptr(), tables.n_chunks,
                int(tables.has_anim), *(c.data_ptr() for c in cols), n_pad,
                int(any_hit), outf.data_ptr(), outi.data_ptr(), stream)
        if err != 0:
            raise RuntimeError(f"intersect_stream kernel launch failed: "
                               f"CUDA error {err}")
        LAUNCHES += 1
        LAUNCHES_BY_FORM["any_hit" if any_hit else "closest_hit"] += 1
    if any_hit:
        return outf[0], outi[0]
    t, u, v, gx, gy, gz, nx, ny, nz, uu, vv = outf
    return HitRecord(t, outi[0], outi[1], u, v, gx, gy, gz, nx, ny, nz,
                     uu, vv)


def intersect_stream(sa, ray: Ray, any_hit: bool = False):
    """The streamed query over all triangles: the CUDA kernel for tensors
    on the card, the plain version for CPU tensors. Returns the
    ``HitRecord`` or, with ``any_hit``, (t, prim)."""
    _check_rays(ray)
    if ray.o.x.device.type == "cpu":
        return intersect_stream_reference(sa, ray, any_hit)
    n = ray.o.x.shape[0]
    tables = stream_tables(sa)
    out = launch(tables, prepare(tables, ray), any_hit)
    if any_hit:
        return out[0][:n], out[1][:n]
    return HitRecord(*(x[:n] for x in out))


__all__ = ["CHUNK", "PAD_TO", "CPG", "BLOCK", "chunk_aabbs",
           "intersect_stream", "intersect_stream_reference",
           "stream_tables", "prepare", "launch", "LIBRARY", "LAUNCHES",
           "LAUNCHES_BY_FORM"]
