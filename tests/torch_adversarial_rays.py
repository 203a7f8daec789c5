"""Rays that stress a conservative ray-triangle gate
(``adversarial_rays``) and a per-lane ray-box test (``ballot_rays``), and
B3's, B4's and B2's (B5's) tables with equal-t hits in two groups of
chunks, two chunks or two units (``equal_t_tables``,
``equal_t_v2_tables``, ``equal_t_v4_tables``), for the port's tests of
B6, B3, B4 and B5 on the CPU (tests/test_torch_alt_kernels.py) and on the
card (tests/test_torch_cuda.py). Imports only the port (no jax)."""

import numpy as np
import torch

from mitsuba3dopplertof_tpu_torch.core.vec import Vec3
from mitsuba3dopplertof_tpu_torch.render.types import Ray

_GEOM = ("v0x", "v0y", "v0z", "e1x", "e1y", "e1z", "e2x", "e2y", "e2z")


def adversarial_rays(sa, n, seed, device):
    """``n`` rays that stress a conservative ray-triangle gate, in five
    equal parts: through a point of a triangle's edge, through a vertex,
    grazing (a direction 1e-3 off the triangle's plane) toward an interior
    point, parallel to the plane and 1e-6 (relative) beside it, and toward
    an interior point from about 1e3 away. Each aims at a random triangle
    of nonzero area of ``sa``, an animated one at its instance's first
    keyframe time (where its transform is the first matrix); the edge,
    vertex and grazing rays come from 0.5-4 units away. A quarter of the
    rays end within 0.1% of their target (maxt), the rest at infinity.
    Made with numpy from ``seed``."""
    rng = np.random.default_rng(seed)
    geo = lambda kind: np.stack([sa.tri(kind, c).cpu().numpy().astype(
        np.float64) for c in _GEOM], axis=1)
    parts = [(geo("s")[:sa.n_static_tris], np.zeros(sa.n_static_tris))]
    for inst, start, count in sa.anim_ranges:
        m = sa.inst_m0c[:, inst].cpu().numpy().astype(np.float64) \
            .reshape(3, 4)
        a = geo("a")[start:start + count].reshape(-1, 3, 3)
        world = a @ m[:, :3].T
        world[:, 0] += m[:, 3]
        parts.append((world.reshape(-1, 9), np.full(count, float(
            sa.inst_t0[inst]))))
    tri = np.concatenate([p[0] for p in parts])
    tri_time = np.concatenate([p[1] for p in parts])
    nrm = np.cross(tri[:, 3:6], tri[:, 6:9])
    area = np.linalg.norm(nrm, axis=1)
    ok = np.flatnonzero(area > 1e-10)
    pick = ok[rng.integers(0, len(ok), n)]
    v0, e1, e2 = tri[pick, 0:3], tri[pick, 3:6], tri[pick, 6:9]
    nh = nrm[pick] / area[pick, None]
    kind = np.arange(n) % 5
    a = rng.uniform(0.0, 1.0, (n, 1))
    b1, b2 = rng.uniform(0.0, 1.0, (2, n, 1))
    flip = b1 + b2 > 1.0
    b1, b2 = np.where(flip, 1.0 - b1, b1), np.where(flip, 1.0 - b2, b2)
    edge = rng.integers(0, 3, n)[:, None]
    p = np.where(kind[:, None] == 0,
                 np.where(edge == 0, v0 + a * e1, np.where(
                     edge == 1, v0 + a * e2, v0 + e1 + a * (e2 - e1))),
                 np.where(kind[:, None] == 1,
                          v0 + np.where(edge == 0, 0.0, 1.0)
                          * np.where(edge == 1, e1, e2),
                          v0 + b1 * e1 + b2 * e2))
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tan = d - (d * nh).sum(1, keepdims=True) * nh
    tan /= np.linalg.norm(tan, axis=1, keepdims=True)
    side = np.where(rng.uniform(size=(n, 1)) < 0.5, -1.0, 1.0)
    d = np.where(kind[:, None] == 2, tan + side * 1e-3 * nh,
                 np.where(kind[:, None] == 3, tan, d))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    dist = np.where(kind == 4, rng.uniform(500.0, 1000.0, n),
                    rng.uniform(0.5, 4.0, n))
    o = p - d * dist[:, None]
    o = np.where(kind[:, None] == 3, o + side * 1e-6
                 * (1.0 + np.abs(p).max(1, keepdims=True)) * nh, o)
    maxt = np.where(rng.uniform(size=n) < 0.25,
                    dist * rng.uniform(0.999, 1.001, n), np.inf)
    f = lambda v: torch.as_tensor(np.asarray(v, np.float32), device=device)
    return Ray(Vec3(*(f(o[:, i]) for i in range(3))),
               Vec3(*(f(d[:, i]) for i in range(3))), f(tri_time[pick]),
               f(maxt))


def equal_t_tables(tb, prim, keys):
    """B3's tables (``intersect_stream.StreamTables``) with the triangles of
    one chunk copied into a pad chunk of the same transform group in
    another group of eight chunks, whose box is made the scene's widened
    by 1 on every side: a ray that hits a copied triangle hits its copy at
    the same t, from a higher table row, and a block whose key for the
    original's group is above 0 reaches the copy's group first. The chunk
    is, among those that have such a pad chunk, the one that holds the
    most winners ``prim`` (slots of each lane; -1 for a miss) in blocks
    whose key (``keys``: ``group_keys`` of the tables, (n_blocks,
    n_groups)) for its group is above 0. Returns (tables, chunk, copy)."""
    n = tb.n_chunks
    dev = tb.aabb.device
    pad = tb.aabb[:, 0] > tb.aabb[:, 3]
    real = tb.geom[:, 3:9].abs().sum(dim=1) > 0.0
    row_of = torch.full((int(tb.slots.max()) + 1,), -1, dtype=torch.int64,
                        device=dev)
    row_of[tb.slots[real].long()] = real.nonzero()[:, 0]
    lane = (prim >= 0).nonzero()[:, 0]
    chunk = row_of[prim[lane].long()] // 32
    ok = (chunk >= 0) & (keys[lane // 256, chunk.clamp(min=0) // 8] > 0.0)
    wins = torch.bincount(chunk[ok], minlength=n)
    ci = tb.meta[:, 0]
    group = torch.arange(n, device=dev) // 8
    for k in wins.argsort(descending=True).tolist():
        cand = (pad & (ci == ci[k]) & (group != k // 8)).nonzero()[:, 0]
        if len(cand):
            p = int(cand[0])
            break
    rec = slice(32 * k, 32 * k + 32)
    tri, geom, aabb = tb.tri.clone(), tb.geom.clone(), tb.aabb.clone()
    tri[32 * p:32 * p + 32] = tri[rec]
    geom[32 * p:32 * p + 32] = geom[rec]
    aabb[p, :3] = tb.aabb[~pad, :3].amin(dim=0) - 1.0
    aabb[p, 3:] = tb.aabb[~pad, 3:].amax(dim=0) + 1.0
    ga = aabb.reshape(-1, 8, 6)
    grp = torch.cat([ga[:, :, :3].amin(dim=1), ga[:, :, 3:].amax(dim=1)],
                    dim=1)
    return (tb._replace(tri=tri, geom=geom, aabb=aabb, grp=grp.contiguous()),
            k, p)


def equal_t_v2_tables(tb, prim, keys):
    """B4's tables (``intersect_v2.V2Tables``) with one more chunk, in the
    transform group of a chosen 32-triangle quarter, whose first quarter
    is a copy of that quarter and whose box is the scene's widened by 1 on
    every side (its other quarters are pad, with inverted boxes): a ray
    that hits a copied triangle hits its copy at the same t, at a higher
    row and a higher slot, and a block whose key for the original's chunk
    is above 0 may reach the copy's chunk first. The quarter is the one
    that holds the most winners ``prim`` (slots of each lane; -1 for a
    miss) in blocks whose key (``keys``: ``intersect_v2.chunk_keys`` of
    the tables, (n_blocks, n_chunks)) for its chunk is above 0. Returns
    (tables, quarter, the new chunk's index)."""
    n = tb.n_chunks
    dev = tb.tri.device
    real = tb.tri[:, 3:9].abs().sum(dim=1).reshape(-1) > 0.0
    row_of = torch.full((int(tb.slots.max()) + 1,), -1, dtype=torch.int64,
                        device=dev)
    row_of[tb.slots[real].long()] = real.nonzero()[:, 0]
    lane = (prim >= 0).nonzero()[:, 0]
    row = row_of[prim[lane].long()]
    ok = (row >= 0) & (keys[lane // 256, row.clamp(min=0) // 128] > 0.0)
    k = int(torch.bincount(row[ok] // 32, minlength=4 * n).argmax())
    tri = torch.zeros((1, 9, 128), device=dev)
    tri[0, :, :32] = tb.tri[k // 4, :, 32 * (k % 4):32 * (k % 4) + 32]
    live = tb.sub[:, 0] <= tb.sub[:, 3]
    sub = torch.cat([torch.full((4, 3), 3e38, device=dev),
                     torch.full((4, 3), -3e38, device=dev)], dim=1)
    sub[0, :3] = tb.sub[live, :3].amin(dim=0) - 1.0
    sub[0, 3:] = tb.sub[live, 3:].amax(dim=0) + 1.0
    ci = int(tb.meta[k // 4, 0])
    slot0 = int(tb.slots.max()) + 1
    meta = torch.tensor([[ci, slot0]], dtype=torch.int32, device=dev)
    sub_all = torch.cat([tb.sub, sub]).contiguous()
    return (tb._replace(
        meta=torch.cat([tb.meta, meta]).contiguous(),
        tri=torch.cat([tb.tri, tri]).contiguous(), sub=sub_all,
        n_chunks=n + 1, runs=tb.runs + ((ci, 128 * n, 128 * (n + 1)),),
        slots=torch.cat([tb.slots, slot0 + torch.arange(
            128, dtype=torch.int32, device=dev)]),
        box=torch.cat([tb.box, sub[:1]]).contiguous(),
        scene_box=torch.cat([sub[0, :3], sub[0, 3:]])), k, n)


def unit_of_slot(tb):
    """(n_slots,) int64: the unit (``intersect_v4.V4Tables``) that holds
    each slot's triangle, -1 for slots of no real triangle (pad and
    degenerate triangles have zero Woop rows)."""
    real = tb.woop_tri.abs().sum(dim=2) > 0.0                # (units, 32)
    slots = tb.meta[:, 1:2].long() + torch.arange(32, device=real.device)
    out = torch.full((int(slots[real].max()) + 1,), -1, dtype=torch.int64,
                     device=real.device)
    unit = torch.arange(tb.n_units, device=real.device)[:, None].expand(
        -1, 32)
    out[slots[real]] = unit[real]
    return out


def tight_boxes(sa, tb):
    """``tb.box`` with each static unit's box shrunk to the exact bounds of
    its triangles' float32 vertices (v0, v0 + e1, v0 + e2), no padding: a
    triangle that attains a bound lies in that face plane of its box.
    Animated units keep their boxes."""
    box = tb.box.clone()
    n = sa.n_static_tris
    g = {c: sa.tri("s", c)[:n] for c in _GEOM}
    v0 = torch.stack([g["v0x"], g["v0y"], g["v0z"]], dim=1)
    verts = torch.stack([v0, v0 + torch.stack([g["e1x"], g["e1y"], g["e1z"]],
                                              dim=1),
                         v0 + torch.stack([g["e2x"], g["e2y"], g["e2z"]],
                                          dim=1)], dim=1)     # (n, 3, 3)
    for u in range(tb.n_units):
        ci, s0 = (int(x) for x in tb.meta[u])
        if ci >= 0 or s0 >= n or not bool(tb.woop_tri[u].any()):
            continue
        v = verts[s0:min(s0 + 32, n)].reshape(-1, 3)
        box[u, :3] = v.amin(dim=0)
        box[u, 3:] = v.amax(dim=0)
    return box


def ballot_rays(sa, tb, n, seed, device):
    """``n`` rays that stress B5's per-lane ray-box test against the units
    of ``tb`` (``intersect_v4.V4Tables``), in five equal parts: (0) through
    a point of an edge of a static triangle, and (1) through a vertex of
    one, with one direction component exactly +0 or -0 (alternating), the
    edge's or the vertex's own coordinate on that axis, so the origin lies
    in a plane through the edge or vertex parallel to the ray: where the
    triangle attains its unit's bound there (``tight_boxes``), the origin
    lies in a face plane of the box; (2) from a point on a face or an edge
    of a unit's box (one or two coordinates exactly its bounds) toward a
    random point of the middle half of the box; (3) grazing a unit's box:
    toward one of its corners from 1-4 units away; (4) from about 1e3 away
    toward a random point of a static triangle, with one direction
    component exactly 0. Then every eighth lane ends exactly at its first
    hit (maxt = the plain version's t), every eighth from the fourth just
    past it (the next float), every seventh has a NaN maxt, and a quarter
    of the rest end at a finite maxt. Made with numpy from ``seed``."""
    from mitsuba3dopplertof_tpu_torch.ops.intersect_v4 import \
        intersect_v4_reference
    rng = np.random.default_rng(seed)
    ns = sa.n_static_tris
    tri = np.stack([sa.tri("s", c)[:ns].cpu().numpy() for c in _GEOM],
                   axis=1).astype(np.float32)                  # (ns, 9)
    ok = np.flatnonzero(np.linalg.norm(np.cross(tri[:, 3:6], tri[:, 6:9]),
                                       axis=1) > 1e-10)
    verts = np.stack([tri[:, 0:3], tri[:, 0:3] + tri[:, 3:6],
                      tri[:, 0:3] + tri[:, 6:9]], axis=1)      # float32
    kind = np.arange(n) % 5
    pick = ok[rng.integers(0, len(ok), n)]
    vi = rng.integers(0, 3, n)
    a = rng.uniform(0.0, 1.0, (n, 1)).astype(np.float32)
    edge = verts[pick, vi] + a * (verts[pick, (vi + 1) % 3]
                                  - verts[pick, vi])
    b1, b2 = rng.uniform(0.0, 1.0, (2, n, 1))
    flip = b1 + b2 > 1.0
    b1, b2 = np.where(flip, 1.0 - b1, b1), np.where(flip, 1.0 - b2, b2)
    inner = (verts[pick, 0] + b1 * (verts[pick, 1] - verts[pick, 0])
             + b2 * (verts[pick, 2] - verts[pick, 0]))
    # (2), (3): a live unit's box, and a triangle of the unit
    boxes = tb.box.cpu().numpy().astype(np.float64)
    real = (tb.woop_tri.abs().sum(dim=2) > 0.0).cpu().numpy()
    units = np.flatnonzero(real.any(axis=1))
    u = units[rng.integers(0, len(units), n)]
    lo, hi = boxes[u, :3], boxes[u, 3:]
    p_box = lo + rng.uniform(0.0, 1.0, (n, 3)) * (hi - lo)
    n_fix = rng.integers(1, 3, n)
    axes = np.argsort(rng.uniform(size=(n, 3)), axis=1)
    side = rng.integers(0, 2, (n, 3))
    for k in range(2):
        ax = axes[:, k]
        fix = n_fix > k
        rows = np.flatnonzero(fix)
        p_box[rows, ax[rows]] = np.where(side[rows, k] == 0,
                                         lo[rows, ax[rows]],
                                         hi[rows, ax[rows]])
    corner = np.where(side == 0, lo, hi)
    centre = 0.5 * (lo + hi)
    d = rng.normal(size=(n, 3))
    zero_ax = rng.integers(0, 3, n)
    sign0 = np.where(np.arange(n) % 2 == 0, 0.0, -0.0)
    rows = np.flatnonzero(kind != 3)
    d[rows, zero_ax[rows]] = 0.0
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[rows, zero_ax[rows]] = sign0[rows]
    dist = np.where(kind == 4, rng.uniform(500.0, 1000.0, n),
                    rng.uniform(1.0, 4.0, n))
    target = np.where(kind[:, None] == 0, edge,
                      np.where(kind[:, None] == 1, verts[pick, vi],
                               inner)).astype(np.float64)
    o = target - d * dist[:, None]
    # the zero component's coordinate is the target's own, exactly
    o[rows, zero_ax[rows]] = target[rows, zero_ax[rows]]
    # (2) from the box surface toward a point of its middle half
    k2 = kind == 2
    tgt2 = centre + 0.25 * (hi - lo) * rng.uniform(-1.0, 1.0, (n, 3))
    d2 = tgt2 - p_box
    d2 /= np.maximum(np.linalg.norm(d2, axis=1, keepdims=True), 1e-30)
    o = np.where(k2[:, None], p_box, o)
    d = np.where(k2[:, None], d2, d)
    # (3) toward a corner of the box from outside
    k3 = kind == 3
    away = rng.normal(size=(n, 3))
    away /= np.linalg.norm(away, axis=1, keepdims=True)
    o3 = corner + away * rng.uniform(1.0, 4.0, (n, 1))
    d3 = corner - o3
    d3 /= np.linalg.norm(d3, axis=1, keepdims=True)
    o = np.where(k3[:, None], o3, o)
    d = np.where(k3[:, None], d3, d)
    f = lambda v: torch.as_tensor(np.asarray(v, np.float32), device=device)
    ray = Ray(Vec3(*(f(o[:, i]) for i in range(3))),
              Vec3(*(f(d[:, i]) for i in range(3))),
              f(rng.uniform(0.0, 1.0, n)), f(np.full(n, np.inf)))
    t = intersect_v4_reference(sa, ray)[0]
    lane = torch.arange(n, device=t.device)
    maxt = torch.where(torch.as_tensor(rng.uniform(size=n) < 0.25,
                                       device=t.device),
                       f(rng.uniform(1.0, 8.0, n)), ray.maxt)
    found = torch.isfinite(t)
    maxt = torch.where(found & (lane % 8 == 0), t, maxt)
    maxt = torch.where(found & (lane % 8 == 4),
                       torch.nextafter(t, torch.full_like(t, np.inf)), maxt)
    maxt = torch.where(lane % 7 == 5, float("nan"), maxt)
    return ray._replace(maxt=maxt.contiguous())


def equal_t_v4_tables(tb, prim, keys):
    """B2's tables (``intersect_v4.V4Tables``, which B5 walks) with one
    more unit, in the transform group of a chosen unit, holding a copy of
    that unit's triangles, with a box that is the scene's widened by 1 on
    every side: a ray that hits a copied triangle hits its copy at the same
    t, at a higher slot, and a block whose key for the original unit is
    above 0 may reach the copy first. The unit is the one that holds the
    most winners ``prim`` (slots of each lane; -1 for a miss) in blocks
    whose key (``keys``: (n_blocks, n_units) entry distances of the
    blocks' visit lists) for it is above 0. Returns (tables, unit, the new
    unit's index)."""
    n = tb.n_units
    dev = tb.box.device
    of_slot = unit_of_slot(tb)
    lane = (prim >= 0).nonzero()[:, 0]
    unit = of_slot[prim[lane].long()]
    ok = (unit >= 0) & (keys[lane // 256, unit.clamp(min=0)] > 0.0)
    k = int(torch.bincount(unit[ok], minlength=n).argmax())
    live = tb.box[:, 0] <= tb.box[:, 3]
    box = torch.cat([tb.box[live, :3].amin(dim=0) - 1.0,
                     tb.box[live, 3:].amax(dim=0) + 1.0])[None]
    ci = int(tb.meta[k, 0])
    slot0 = int(of_slot.shape[0]) + 32
    meta = torch.tensor([[ci, slot0]], dtype=torch.int32, device=dev)
    return (tb._replace(
        meta=torch.cat([tb.meta, meta]).contiguous(),
        woop=torch.cat([tb.woop, tb.woop[k:k + 1]]).contiguous(),
        box=torch.cat([tb.box, box]).contiguous(), n_units=n + 1,
        runs=tb.runs + ((ci, n, n + 1),),
        woop_tri=torch.cat([tb.woop_tri, tb.woop_tri[k:k + 1]]).contiguous(),
        scene_box=box[0].clone()), k, n)
