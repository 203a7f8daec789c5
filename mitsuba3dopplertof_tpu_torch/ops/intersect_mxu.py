"""The payload of the large-scene kernels (the helpers ``_payload_table``
and ``payload_from_prim`` of the JAX package's ``ops/intersect_mxu.py``,
plain XLA code there and plain PyTorch here). Kernel B6 of that file is
not ported yet (ROADMAP Queue B).

B2 returns only (t, prim). The full hit record of the winner is then one
row gather from a per-triangle table plus a dense recompute: barycentrics
at the known hit point, normals and uv (reference
compute_surface_interaction, instance.cpp:155-250).
"""

from __future__ import annotations

import numpy as np
import torch

from .intersect_stream import _inst_table


def _payload_table(sa) -> torch.Tensor:
    """(T_total, 26) per-triangle records in global slot order: B1's
    triangle records (24 geometry/uv floats and the instance id,
    ``intersect_kernel.scene_tables``) and the animated-range index (-1
    static). Cached on the SceneArrays."""
    if "payload" not in sa._cache:
        from .intersect_kernel import scene_tables
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
    from .intersect_kernel import HitRecord, _inv_lerped

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


__all__ = ["payload_from_prim"]
