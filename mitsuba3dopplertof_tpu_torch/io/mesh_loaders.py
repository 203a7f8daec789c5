"""Mesh file loaders: Wavefront OBJ (port of the pure-Python path of the
JAX package's ``io/mesh_loaders.py``: ``load_obj`` and ``_finish_obj``).

Host-side numpy, as in the reference src/shapes/obj.cpp: the loader feeds
the scene compiler, never the device. The JAX package's native OBJ parser
(``ops/native``, ROADMAP Queue A item 14) and its PLY and ``.serialized``
loaders (ROADMAP Queue A item 3) are not ported yet.
"""

from __future__ import annotations

import gzip

import numpy as np


def _finish_obj(verts, norms, uvs, fv, ft, fn):
    """1-based / negative index normalization, then wedge re-indexing so
    that each vertex carries its own normal and uv."""
    from ..shapes import Mesh
    fv = np.where(fv > 0, fv - 1, verts.shape[0] + fv)
    if norms.size and np.any(fn != 0):
        # faces lacking a normal/uv index (mixed meshes) clamp to entry 0
        fn = np.clip(np.where(fn > 0, fn - 1, norms.shape[0] + fn),
                     0, norms.shape[0] - 1)
        has_uv = uvs.size > 0 and np.any(ft != 0)
        if has_uv:
            ft = np.clip(np.where(ft > 0, ft - 1, uvs.shape[0] + ft),
                         0, uvs.shape[0] - 1)
        flat_v = verts[fv.reshape(-1)]
        flat_n = norms[fn.reshape(-1)]
        flat_uv = uvs[ft.reshape(-1)] if has_uv else None
        faces = np.arange(flat_v.shape[0], dtype=np.int64).reshape(-1, 3)
        return Mesh(flat_v, faces, flat_n, flat_uv)
    return Mesh(verts, fv, None, None)


def load_obj(filename: str):
    """Triangulated mesh of an OBJ file (``.obj`` or ``.obj.gz``); polygons
    are fanned from their first vertex."""
    verts, norms, uvs = [], [], []
    fv, fn, ft = [], [], []
    opener = gzip.open if filename.endswith(".gz") else open
    with opener(filename, "rt", errors="replace") as f:
        for line in f:
            if line.startswith("v "):
                verts.append([float(x) for x in line.split()[1:4]])
            elif line.startswith("vn "):
                norms.append([float(x) for x in line.split()[1:4]])
            elif line.startswith("vt "):
                uvs.append([float(x) for x in line.split()[1:3]])
            elif line.startswith("f "):
                idx = []
                for tok in line.split()[1:]:
                    parts = tok.split("/")
                    vi = int(parts[0])
                    ti = int(parts[1]) if len(parts) > 1 and parts[1] else 0
                    ni = int(parts[2]) if len(parts) > 2 and parts[2] else 0
                    idx.append((vi, ti, ni))
                for k in range(1, len(idx) - 1):
                    fv.append([idx[0][0], idx[k][0], idx[k + 1][0]])
                    ft.append([idx[0][1], idx[k][1], idx[k + 1][1]])
                    fn.append([idx[0][2], idx[k][2], idx[k + 1][2]])

    return _finish_obj(
        np.asarray(verts, dtype=np.float64),
        np.asarray(norms, dtype=np.float64).reshape(-1, 3),
        np.asarray(uvs, dtype=np.float64).reshape(-1, 2),
        np.asarray(fv, dtype=np.int64).reshape(-1, 3),
        np.asarray(ft, dtype=np.int64).reshape(-1, 3),
        np.asarray(fn, dtype=np.int64).reshape(-1, 3))


__all__ = ["load_obj"]
