"""The 32-triangle Woop units of the large-scene kernels and their
per-block visit lists (the helpers of the JAX package's
``ops/intersect_v3.py``: ``_woop_records`` and ``_unit_visit_order``).
Kernel B5 of that file is not ported yet (ROADMAP Queue B).
"""

from __future__ import annotations

import torch

from .intersect_stream import CHUNK

UNIT_REC = 12 * CHUNK     # floats per unit: coefficient c of tri j at c*32+j
_BIG = 3.0e38
_GEOM = ("v0x", "v0y", "v0z", "e1x", "e1y", "e1z", "e2x", "e2y", "e2z")


def _cross(a, b):
    return (a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0])


def _woop_records(sa, segments, n_units: int) -> torch.Tensor:
    """Woop table, (n_units, 384) f32 (JAX intersect_v3.py:280 keeps the
    same 384 floats in an (8, 128) tile). Per triangle the 12 coefficients
    are the rows of B = [e1 | e2 | n]^-1 (n = e1 x e2, via the adjugate)
    and c = -B v0. Degenerate and pad triangles get zero rows, so their
    t = -0/0 is NaN and every comparison rejects them."""
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
    w = torch.stack(rows, dim=-1)                        # (P, 12)
    # (n_units, 32, 12) -> coefficient-major (n_units, 12, 32)
    return w.reshape(n_units, CHUNK, 12).transpose(1, 2).reshape(
        n_units, UNIT_REC).contiguous()


def _unit_visit_order(box, n_units: int, x, blk: int):
    """Per-block front-to-back visit lists over the units (JAX
    intersect_v3.py:316). ``x``: (8, N) rows ox oy oz 1 dx dy dz maxt, N a
    multiple of ``blk``. A conservative slab test of each block's ray
    bounds against each unit's box gives its entry distance t_lo;
    unreachable units are keyed to 3e38. Returns (order, t_lo sorted),
    both (N / blk, n_units); the sort is stable, as ``jnp.argsort``."""
    nb = x.shape[1] // blk
    xb = x.reshape(8, nb, blk)
    ol = xb[0:3].amin(dim=2).T
    oh = xb[0:3].amax(dim=2).T
    dl = xb[4:7].amin(dim=2).T
    dh = xb[4:7].amax(dim=2).T
    mt = torch.clamp(xb[7].amax(dim=1), max=_BIG)

    blo = box[:, :3]
    bhi = box[:, 3:]
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
    key = torch.where(possible, t_lo, _BIG)
    order = torch.argsort(key, dim=1, stable=True)
    return (order.to(torch.int32).contiguous(),
            torch.gather(key, 1, order).contiguous())


__all__ = ["UNIT_REC"]
