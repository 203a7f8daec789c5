"""The scene-box exit bound of the large-scene kernels (the helper
``scene_box_exit`` of the JAX package's ``ops/intersect_v2.py``). Kernel
B4 of that file is not ported yet (ROADMAP Queue B).
"""

from __future__ import annotations

import torch

_BIG = 3.0e38


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


__all__ = ["scene_box_exit"]
