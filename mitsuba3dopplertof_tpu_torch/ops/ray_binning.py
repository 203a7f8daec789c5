"""Ray binning: lane-block coherence for B2 (port of the JAX package's
``ops/ray_binning.py``: ``bin_key``, ``should_bin`` and ``binned``).

B2 culls 32-triangle units per lane block with one conservative slab test
over the block's ray bounds. Camera rays are coherent in pixel order, but
bounce and shadow rays scatter across the scene, and a block whose rays
point everywhere visits every unit. Sorting the wavefront by a
spatial-directional key before the query and restoring the order after
gives blocks tight bounds. The JAX package permutes with two variadic
``lax.sort``s (the TPU's fast permute); on the card it is one stable
``torch.sort`` of the key, a gather of the ray columns, and a scatter of
the results back through the permutation.

Key layout (int32, ascending):
  * bit 30:      dead lane (inactive / maxt <= 0): sorts last
  * bits 27-29:  direction octant
  * bits 6-26:   7-bit-per-axis Morton code of the quantized ray origin
  * bits 0-5:    3+3 bits of the direction's |x|, |y| share
The opt-in first-super key of the JAX package (``first_super``,
``super_boxes``, MI_BIN_FIRSTSUPER) is not ported (ROADMAP Queue A item 8).
"""

from __future__ import annotations

import os

import torch

from ..core.vec import Vec3
from ..render.types import Ray

_DEAD_KEY = 1 << 30


def _part1by2(x):
    """Spread the low 7 bits of x with 2 zero bits between each."""
    x = x & 0x7F
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def bin_key(ray: Ray, lo, hi) -> torch.Tensor:
    """Coherence sort key per lane, int32 (JAX ray_binning.py:112).
    ``lo``/``hi``: (3,) scene bounds. Lanes with maxt <= 0 get the dead
    key."""
    i32 = torch.int32
    octant = ((ray.d.x < 0).to(i32) | ((ray.d.y < 0).to(i32) << 1)
              | ((ray.d.z < 0).to(i32) << 2))
    ext = torch.clamp(hi - lo, min=1e-30)

    def q(p, ax):
        t = torch.clamp((p - lo[ax]) / ext[ax], 0.0, 1.0)
        return (t * 127.0).to(i32)

    ax_ = torch.abs(ray.d.x)
    ay_ = torch.abs(ray.d.y)
    s = ax_ + ay_ + torch.abs(ray.d.z)
    inv = 1.0 / torch.clamp(s, min=1e-30)
    db = (((ax_ * inv * 7.9999).to(i32) << 3)
          | (ay_ * inv * 7.9999).to(i32))
    morton = (_part1by2(q(ray.o.x, 0)) | (_part1by2(q(ray.o.y, 1)) << 1)
              | (_part1by2(q(ray.o.z, 2)) << 2))
    key = (octant << 27) | (morton << 6) | db
    return torch.where(ray.maxt <= 0.0, _DEAD_KEY, key)


def should_bin(sa, n_lanes: int, block: int) -> bool:
    """Binning pays only with several lane blocks (``block`` lanes each)
    and enough triangles that the kernel's unit visits dominate the
    permutation (JAX ray_binning.py:160). MI_NO_RAY_BINNING turns it
    off."""
    if os.environ.get("MI_NO_RAY_BINNING"):
        return False
    if sa.chunk_aabb is None:
        return False
    n_tris = sa.n_static_tris + sa.n_anim_tris
    return n_tris > 1024 and n_lanes > block


def binned(sa, ray: Ray, active, run):
    """Sort the wavefront by ``bin_key``, call ``run(sorted_ray) ->
    [outs]`` ((N,) tensors) and return the outputs in the original lane
    order. ``active`` (optional bool mask) deadens lanes through maxt, so
    their blocks cull every unit (JAX ray_binning.py:174)."""
    aabb = sa.chunk_aabb
    lo = aabb[:, :3].amin(dim=0)
    hi = aabb[:, 3:].amax(dim=0)
    maxt = ray.maxt if active is None else torch.where(active, ray.maxt,
                                                       -1.0)
    key = bin_key(ray._replace(maxt=maxt), lo, hi)
    perm = torch.sort(key, stable=True).indices
    ray_s = Ray(Vec3(ray.o.x[perm], ray.o.y[perm], ray.o.z[perm]),
                Vec3(ray.d.x[perm], ray.d.y[perm], ray.d.z[perm]),
                ray.time[perm], maxt[perm])
    restored = []
    for out in run(ray_s):
        back = torch.empty_like(out)
        back[perm] = out
        restored.append(back)
    return restored


__all__ = ["bin_key", "should_bin", "binned"]
