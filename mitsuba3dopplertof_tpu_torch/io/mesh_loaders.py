"""Mesh file loaders: Wavefront OBJ, PLY and Mitsuba ``.serialized``
(port of the JAX package's ``io/mesh_loaders.py``: the pure-Python path of
``load_obj`` and ``_finish_obj``, ``load_ply`` and ``load_serialized``).

Host-side numpy, as in the reference src/shapes/{obj,ply,serialized}.cpp:
the loaders feed the scene compiler, never the device. Coordinates are
parsed as the JAX package parses them, so the two packages compile a file
to the same tables bit for bit. The JAX package's native OBJ parser
(``ops/native``, ROADMAP Queue A item 14) is not ported.
"""

from __future__ import annotations

import gzip
import struct
import zlib

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


def load_ply(filename: str):
    """Triangulated mesh of a PLY file (ascii, or binary little- or
    big-endian; ``.gz`` too): positions, vertex normals (nx, ny, nz), uvs
    (u, v or s, t) and vertex colors as the ``vertex_color`` attribute;
    polygons are fanned from their first vertex."""
    from ..shapes import Mesh
    opener = gzip.open if filename.endswith(".gz") else open
    with opener(filename, "rb") as f:
        data = f.read()

    header_end = data.find(b"end_header\n") + len(b"end_header\n")
    header = data[:header_end].decode("ascii", errors="replace").splitlines()
    body = data[header_end:]

    fmt = "ascii"
    # (name, count, [(prop_type, prop_name) or
    #                 ('list', count_type, index_type, name)])
    elements = []
    cur = None
    for line in header:
        tok = line.split()
        if not tok:
            continue
        if tok[0] == "format":
            fmt = tok[1]
        elif tok[0] == "element":
            cur = (tok[1], int(tok[2]), [])
            elements.append(cur)
        elif tok[0] == "property":
            if tok[1] == "list":
                cur[2].append(("list", tok[2], tok[3], tok[4]))
            else:
                cur[2].append((tok[1], tok[2]))

    type_map = {"float": "f4", "float32": "f4", "double": "f8",
                "uchar": "u1", "uint8": "u1", "char": "i1", "int8": "i1",
                "ushort": "u2", "uint16": "u2", "short": "i2", "int16": "i2",
                "uint": "u4", "uint32": "u4", "int": "i4", "int32": "i4"}

    verts = normals = uvs = None
    vertex_color = None
    faces = []
    if fmt == "ascii":
        lines = body.decode("ascii", errors="replace").split("\n")
        li = 0
        for name, count, props in elements:
            if name == "vertex":
                rows = [lines[li + i].split() for i in range(count)]
                li += count
                arr = np.asarray(rows, dtype=np.float64)
                cols = [p[1] for p in props]
                verts = arr[:, [cols.index(c) for c in "xyz"]]
                if all(c in cols for c in ("nx", "ny", "nz")):
                    normals = arr[:, [cols.index(c)
                                      for c in ("nx", "ny", "nz")]]
                if all(c in cols for c in ("u", "v")):
                    uvs = arr[:, [cols.index(c) for c in ("u", "v")]]
                elif all(c in cols for c in ("s", "t")):
                    uvs = arr[:, [cols.index(c) for c in ("s", "t")]]
                if all(c in cols for c in ("red", "green", "blue")):
                    ci = [cols.index(c) for c in ("red", "green", "blue")]
                    ctypes = [props[j][0] for j in ci]
                    col = arr[:, ci]
                    if any(t in ("uchar", "uint8") for t in ctypes):
                        col = col / 255.0
                    vertex_color = col
            elif name == "face":
                for i in range(count):
                    tok = [int(x) for x in lines[li + i].split()]
                    n = tok[0]
                    poly = tok[1:1 + n]
                    for k in range(1, n - 1):
                        faces.append([poly[0], poly[k], poly[k + 1]])
                li += count
            else:
                li += count
    else:
        little = "little" in fmt
        endian = "<" if little else ">"
        off = 0
        for name, count, props in elements:
            if name == "vertex" and all(p[0] != "list" for p in props):
                dtype = np.dtype([(p[1], endian + type_map[p[0]])
                                  for p in props])
                arr = np.frombuffer(body, dtype=dtype, count=count, offset=off)
                off += dtype.itemsize * count
                verts = np.stack([arr["x"], arr["y"], arr["z"]],
                                 axis=-1).astype(np.float64)
                names = arr.dtype.names
                if all(c in names for c in ("nx", "ny", "nz")):
                    normals = np.stack([arr["nx"], arr["ny"], arr["nz"]],
                                       axis=-1).astype(np.float64)
                if all(c in names for c in ("u", "v")):
                    uvs = np.stack([arr["u"], arr["v"]],
                                   axis=-1).astype(np.float64)
                elif all(c in names for c in ("s", "t")):
                    uvs = np.stack([arr["s"], arr["t"]],
                                   axis=-1).astype(np.float64)
                if all(c in names for c in ("red", "green", "blue")):
                    col = np.stack([arr["red"], arr["green"], arr["blue"]],
                                   axis=-1).astype(np.float64)
                    if arr.dtype["red"].kind == "u":
                        col = col / 255.0
                    vertex_color = col
            elif name == "face":
                cnt_t, it_t = None, None
                for p in props:
                    if p[0] == "list":
                        cnt_t, it_t = type_map[p[1]], type_map[p[2]]
                cnt_size = np.dtype(cnt_t).itemsize
                it_size = np.dtype(it_t).itemsize
                # fast path: assume uniform triangle lists
                probe = np.frombuffer(body, dtype=endian + cnt_t, count=1,
                                      offset=off)[0]
                stride = cnt_size + int(probe) * it_size
                uniform = (off + stride * count <= len(body))
                if uniform and probe == 3:
                    rec = np.dtype([("n", endian + cnt_t),
                                    ("idx", endian + it_t, (3,))])
                    arr = np.frombuffer(body, dtype=rec, count=count,
                                        offset=off)
                    if np.all(arr["n"] == 3):
                        faces = arr["idx"].astype(np.int64)
                        off += rec.itemsize * count
                    else:
                        uniform = False
                if not (uniform and probe == 3):
                    for _ in range(count):
                        n = int(np.frombuffer(body, dtype=endian + cnt_t,
                                              count=1, offset=off)[0])
                        off += cnt_size
                        poly = np.frombuffer(body, dtype=endian + it_t,
                                             count=n, offset=off)
                        off += n * it_size
                        for k in range(1, n - 1):
                            faces.append([poly[0], poly[k], poly[k + 1]])

    attrs = ({"vertex_color": vertex_color}
             if vertex_color is not None else None)
    return Mesh(verts, np.asarray(faces, dtype=np.int64), normals, uvs,
                attributes=attrs)


def load_serialized(filename: str, shape_index: int = 0):
    """Mitsuba .serialized format (format 0x041C, versions 3-4):
    per-shape zlib streams; footer has an offset dictionary."""
    from ..shapes import Mesh
    with open(filename, "rb") as f:
        data = f.read()

    count = struct.unpack("<I", data[-4:])[0]
    # v4 offsets are u64, v3 u32; header version tells us which
    version = struct.unpack("<H", data[2:4])[0]
    if version >= 4:
        table = struct.unpack(f"<{count}Q", data[-4 - 8 * count:-4])
    else:
        table = struct.unpack(f"<{count}I", data[-4 - 4 * count:-4])
    off = table[shape_index]

    magic, ver = struct.unpack_from("<HH", data, off)
    if magic != 0x041C:
        raise RuntimeError(f"Invalid serialized mesh magic {magic:#x}")
    stream = zlib.decompress(data[off + 4:])

    pos = 0
    flags = struct.unpack_from("<I", stream, pos)[0]
    pos += 4
    if ver >= 4:
        end = stream.index(b"\0", pos)
        pos = end + 1  # shape name
    vertex_count, face_count = struct.unpack_from("<QQ", stream, pos)
    pos += 16

    double_prec = bool(flags & 0x2000)
    ftype = "f8" if double_prec else "f4"
    fsize = 8 if double_prec else 4

    def take(n_elem):
        nonlocal pos
        arr = np.frombuffer(stream, dtype="<" + ftype, count=n_elem,
                            offset=pos)
        pos += n_elem * fsize
        return arr

    verts = take(vertex_count * 3).reshape(-1, 3).astype(np.float64)
    normals = None
    uvs = None
    if flags & 0x0001:
        normals = take(vertex_count * 3).reshape(-1, 3).astype(np.float64)
    if flags & 0x0002:
        uvs = take(vertex_count * 2).reshape(-1, 2).astype(np.float64)
    vertex_color = None
    if flags & 0x0008:  # vertex colors
        vertex_color = take(vertex_count * 3).reshape(-1, 3).astype(np.float64)
    faces = np.frombuffer(stream, dtype="<u4", count=face_count * 3,
                          offset=pos).reshape(-1, 3).astype(np.int64)
    attrs = ({"vertex_color": vertex_color}
             if vertex_color is not None else None)
    return Mesh(verts, faces, normals, uvs, attributes=attrs)


__all__ = ["load_obj", "load_ply", "load_serialized"]
