"""Kernel B5, the 32-triangle Woop units of the large-scene kernels and
their per-block visit lists (port of the JAX package's
``ops/intersect_v3.py``: the Pallas kernel ``_build_v3_kernel`` with its
wrapper ``intersect_v3``, and the helpers ``_woop_records`` and
``_unit_visit_order``, which B2 shares).

B5 (``MI_STREAM_KERNEL=v3``) is B2's predecessor: the same Woop records,
scene-box clamp of maxt and visit lists (``intersect_v4.v4_tables`` and
``prepare``), walked one unit per step. Before each unit the kernel repeats
the slab test of the block's ray bounds against the unit's box with the
block's current bound as the far end. Culling is conservative, so the
result is that of the dense test of every lane against every unit, which is
B2's plain version: ``intersect_v3_reference`` is
``intersect_v4_reference``.

  * ``intersect_v3(sa, ray, any_hit)`` — the CUDA kernel
    ``csrc/intersect_v3.cu`` for CUDA tensors, the plain version for CPU
    tensors; returns (t, prim) in the global slot convention.

``LAUNCHES`` / ``LAUNCHES_BY_FORM`` count kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from ..render.types import Ray
from .cuda_build import CudaLibrary
from .intersect_kernel import _check_rays
from .intersect_stream import BLOCK, CHUNK, _launch_walk


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
# B5: plain version and kernel
# ---------------------------------------------------------------------------

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


def _bind(lib):
    fn = lib.mi_intersect_v3
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 2
                   + [ctypes.c_void_p] * 8 + [ctypes.c_longlong, ctypes.c_int]
                   + [ctypes.c_void_p] * 3)
    lib.mi_intersect_v3_block.restype = ctypes.c_int
    lib.mi_intersect_v3_block.argtypes = []
    if lib.mi_intersect_v3_block() != BLOCK:
        raise RuntimeError("csrc/intersect_v3.cu was built for another "
                           "block size than ops/intersect_stream.py BLOCK")


LIBRARY = CudaLibrary("intersect_v3", _bind,
                      headers=("intersect_common.cuh",))


def launch(tables, prep, any_hit: bool):
    """One launch over B2's tables (``intersect_v4.v4_tables``) and
    prepared inputs (``intersect_v4.prepare``). Returns (t, prim) at the
    padded length."""
    global LAUNCHES
    t, prim = _launch_walk("intersect_v3", LIBRARY,
                           tables.woop, tables.box, tables, tables.n_units,
                           prep, any_hit)
    if t.numel():
        LAUNCHES += 1
        LAUNCHES_BY_FORM["any_hit" if any_hit else "closest_hit"] += 1
    return t, prim


def intersect_v3(sa, ray: Ray, any_hit: bool = False):
    """Closest-hit (or any-hit) (t, prim) over all triangles, one unit per
    step: the CUDA kernel for tensors on the card, the plain version for
    CPU tensors."""
    from .intersect_v4 import prepare, v4_tables
    _check_rays(ray)
    if ray.o.x.device.type == "cpu":
        return intersect_v3_reference(sa, ray, any_hit)
    n = ray.o.x.shape[0]
    tables = v4_tables(sa)
    t, prim = launch(tables, prepare(tables, ray), any_hit)
    return t[:n], prim[:n]


__all__ = ["UNIT_REC", "BLOCK", "intersect_v3", "intersect_v3_reference",
           "launch", "LIBRARY", "LAUNCHES", "LAUNCHES_BY_FORM"]
