"""The chunked triangle layout of the large-scene kernels (the helpers of
the JAX package's ``ops/intersect_stream.py``: ``_chunked_layout``,
``chunk_aabbs`` and ``_inst_table``). The streamed kernel B3 of that file
is not ported yet (ROADMAP Queue B).

Triangles are cut into 32-triangle chunks; each transform group (the
static triangles, then each animated range) is padded to a multiple of
``PAD_TO`` triangles so that no chunk mixes groups. A chunk carries its
animated-range index (-1 static) and the global slot of its first
triangle.
"""

from __future__ import annotations

import numpy as np
import torch

CHUNK = 32          # triangles per culling unit (one conservative AABB)
PAD_TO = 128        # each transform group pads to this boundary


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


__all__ = ["CHUNK", "PAD_TO", "chunk_aabbs"]
