"""Image I/O (port of the JAX package's ``io/bitmap.py``): a
self-contained OpenEXR scanline codec, PFM, PPM and RGBE, with PNG and
JPEG through ``imageio`` (imported when called).

EXR: HALF, FLOAT and UINT channels; reads NONE, ZIPS, ZIP and PIZ
(``io/exr_piz.py``), writes NONE, ZIPS and ZIP, all as OpenEXR
(reference src/core/bitmap.cpp links it) reads and writes them. The JAX
package writes PIZ through a native OpenEXR shim where OpenEXR's headers
exist; the port has no native code. The JAX package's own ZIP codec,
used where it has no OpenEXR, stores a block's first byte offset by 128
against OpenEXR's predictor: its files and OpenEXR's (and the port's)
misread each other.
"""

from __future__ import annotations

import struct
import zlib
from typing import Dict, List, Tuple

import numpy as np

_MAGIC = 20000630
_PT_UINT, _PT_HALF, _PT_FLOAT = 0, 1, 2
_PIXEL_SIZE = {_PT_HALF: 2, _PT_FLOAT: 4, _PT_UINT: 4}
# compression id -> scanlines per block
_LINES_PER_BLOCK = {0: 1, 2: 1, 3: 16, 4: 32}
_COMPRESSION = {"none": 0, "zips": 2, "zip": 3}


def _read_null_str(buf: bytes, off: int) -> Tuple[str, int]:
    end = buf.index(b"\0", off)
    return buf[off:end].decode("latin-1"), end + 1


def _unpredict_and_deinterleave(raw: bytes) -> bytes:
    """Undo OpenEXR's ZIP predictor and byte split (ImfZip.cpp): the first
    byte is stored as is, each later one as (byte - previous + 128) mod
    256; the first half of the bytes are the even ones."""
    arr = np.frombuffer(raw, np.uint8).astype(np.int64) - 128
    if arr.size:
        arr[0] += 128
    arr = (np.cumsum(arr) % 256).astype(np.uint8)
    n = arr.size
    half = (n + 1) // 2
    out = np.empty(n, np.uint8)
    out[0::2] = arr[:half]
    out[1::2] = arr[half:]
    return out.tobytes()


def _interleave_and_predict(raw: bytes) -> bytes:
    """OpenEXR's ZIP byte split and predictor (ImfZip.cpp), the inverse of
    ``_unpredict_and_deinterleave``."""
    arr = np.frombuffer(raw, np.uint8)
    n = arr.size
    half = (n + 1) // 2
    inter = np.empty(n, np.uint8)
    inter[:half] = arr[0::2]
    inter[half:] = arr[1::2]
    d = inter.astype(np.int16)
    d[1:] = (inter[1:].astype(np.int16) - inter[:-1].astype(np.int16)
             + 384) % 256
    return d.astype(np.uint8).tobytes()


def read_exr(path: str) -> Dict[str, np.ndarray]:
    """Read a scanline EXR; returns {channel_name: (H, W) float32}."""
    with open(path, "rb") as f:
        buf = f.read()
    magic, version = struct.unpack_from("<ii", buf, 0)
    if magic != _MAGIC:
        raise RuntimeError(f"{path}: not an EXR file")
    if version & 0x200:
        raise RuntimeError("tiled EXR not supported")
    off = 8

    channels: List[Tuple[str, int]] = []
    compression = 0
    data_window = (0, 0, 0, 0)
    while True:
        if buf[off] == 0:
            off += 1
            break
        name, off = _read_null_str(buf, off)
        _atype, off = _read_null_str(buf, off)
        size = struct.unpack_from("<i", buf, off)[0]
        off += 4
        val = buf[off:off + size]
        off += size
        if name == "channels":
            coff = 0
            while val[coff] != 0:
                cname, coff = _read_null_str(val, coff)
                ptype = struct.unpack_from("<i", val, coff)[0]
                coff += 16  # ptype + pLinear/reserved + xSampling + ySampling
                channels.append((cname, ptype))
        elif name == "compression":
            compression = val[0]
        elif name == "dataWindow":
            data_window = struct.unpack("<4i", val)

    x0, y0, x1, y1 = data_window
    W = x1 - x0 + 1
    H = y1 - y0 + 1
    if compression not in _LINES_PER_BLOCK:
        raise RuntimeError(f"EXR compression {compression} not supported")
    lines_per_block = _LINES_PER_BLOCK[compression]

    n_blocks = (H + lines_per_block - 1) // lines_per_block
    offsets = struct.unpack_from(f"<{n_blocks}q", buf, off)
    out = {c: np.zeros((H, W), np.float32) for c, _ in channels}

    for boff in offsets:
        y, size = struct.unpack_from("<ii", buf, boff)
        data = buf[boff + 8:boff + 8 + size]
        ny = min(lines_per_block, y1 - y + 1)
        raw_size = sum(_PIXEL_SIZE[pt] for _, pt in channels) * W * ny
        # a block no smaller compressed is stored raw
        if size < raw_size:
            if compression in (2, 3):
                data = _unpredict_and_deinterleave(zlib.decompress(data))
            elif compression == 4:
                from .exr_piz import piz_uncompress
                data = piz_uncompress(data, channels, W, ny)
        p = 0
        for ly in range(ny):
            yy = y - y0 + ly
            for cname, ptype in channels:
                cnt = W * _PIXEL_SIZE[ptype]
                chunk = data[p:p + cnt]
                p += cnt
                if ptype == _PT_HALF:
                    vals = np.frombuffer(chunk, np.float16).astype(np.float32)
                elif ptype == _PT_FLOAT:
                    vals = np.frombuffer(chunk, np.float32)
                else:
                    vals = np.frombuffer(chunk, np.uint32).astype(np.float32)
                out[cname][yy] = vals
    return out


def read_exr_rgb(path: str) -> np.ndarray:
    ch = read_exr(path)
    names = ("R", "G", "B") if "R" in ch else tuple(sorted(ch))[:3]
    return np.stack([ch[n] for n in names], axis=-1)


def write_exr(path: str, channels: Dict[str, np.ndarray],
              half: bool = True, compression: str = "zip"):
    """Write a scanline EXR: HALF or FLOAT channels in name order, NONE,
    ZIPS or ZIP blocks (a block no smaller compressed is stored raw)."""
    channels = {k: np.asarray(v, np.float32) for k, v in channels.items()}
    names = sorted(channels)
    H, W = next(iter(channels.values())).shape
    ptype = _PT_HALF if half else _PT_FLOAT
    comp_id = _COMPRESSION[compression]
    lines_per_block = _LINES_PER_BLOCK[comp_id]

    def attr(name, atype, val):
        return (name.encode() + b"\0" + atype.encode() + b"\0"
                + struct.pack("<i", len(val)) + val)

    chan_val = b""
    for n in names:
        chan_val += (n.encode() + b"\0"
                     + struct.pack("<iBBBBii", ptype, 0, 0, 0, 0, 1, 1))
    chan_val += b"\0"

    header = b""
    header += attr("channels", "chlist", chan_val)
    header += attr("compression", "compression", bytes([comp_id]))
    header += attr("dataWindow", "box2i",
                   struct.pack("<4i", 0, 0, W - 1, H - 1))
    header += attr("displayWindow", "box2i",
                   struct.pack("<4i", 0, 0, W - 1, H - 1))
    header += attr("lineOrder", "lineOrder", b"\0")
    header += attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
    header += attr("screenWindowCenter", "v2f", struct.pack("<2f", 0.0, 0.0))
    header += attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
    header += b"\0"

    n_blocks = (H + lines_per_block - 1) // lines_per_block
    blocks = []
    for bi in range(n_blocks):
        y = bi * lines_per_block
        ny = min(lines_per_block, H - y)
        raw = b"".join(
            channels[n][y + ly].astype(np.float16 if half
                                       else np.float32).tobytes()
            for ly in range(ny) for n in names)
        if comp_id == 0:
            data = raw
        else:
            data = zlib.compress(_interleave_and_predict(raw))
            if len(data) >= len(raw):
                data = raw
        blocks.append((y, data))

    out = struct.pack("<ii", _MAGIC, 2) + header
    base = len(out) + 8 * n_blocks
    offsets = []
    body = b""
    for y, data in blocks:
        offsets.append(base + len(body))
        body += struct.pack("<ii", y, len(data)) + data
    with open(path, "wb") as f:
        f.write(out + struct.pack(f"<{n_blocks}q", *offsets) + body)


def write_exr_rgb(path: str, img: np.ndarray, half: bool = True):
    write_exr(path, {"R": img[..., 0], "G": img[..., 1], "B": img[..., 2]},
              half=half)


def write_png(path: str, img: np.ndarray, gamma: bool = True):
    """8-bit PNG through imageio, sRGB-encoded when ``gamma`` (the JAX
    package's dithered quantization comes with ``io/resample``, ROADMAP
    Queue A item 3)."""
    import imageio.v3 as iio
    x = np.asarray(img, np.float64)
    if gamma:
        x = np.where(x <= 0.0031308, x * 12.92,
                     1.055 * np.maximum(x, 1e-9) ** (1 / 2.4) - 0.055)
    iio.imwrite(path, (np.clip(x, 0, 1) * 255 + 0.5).astype(np.uint8))


# ---------------------------------------------------------------------------
# Additional codecs (reference src/core/bitmap.cpp: JPEG/PFM/PPM/RGBE)
# ---------------------------------------------------------------------------

def read_pfm(path: str) -> np.ndarray:
    """Portable FloatMap (reference bitmap.cpp read_pfm): 'PF' rgb /
    'Pf' gray, scale line's sign gives endianness, rows bottom-up."""
    with open(path, "rb") as f:
        buf = f.read()
    parts = buf.split(maxsplit=3)
    header, w, h = parts[0], int(parts[1]), int(parts[2])
    rest = parts[3]
    nl = rest.index(b"\n") if b"\n" in rest[:32] else rest.index(b" ")
    scale = float(rest[:nl])
    data = rest[nl + 1:]
    ch = 3 if header == b"PF" else 1
    dt = "<f4" if scale < 0 else ">f4"
    img = np.frombuffer(data, dt, count=w * h * ch).reshape(h, w, ch)
    img = img[::-1].astype(np.float32)          # bottom-up storage
    if abs(scale) not in (0.0, 1.0):
        img = img * abs(scale)
    return np.repeat(img, 3, axis=2) if ch == 1 else img


def write_pfm(path: str, img: np.ndarray):
    img = np.asarray(img, np.float32)
    if img.ndim == 2:
        img = img[..., None].repeat(3, axis=2)
    h, w, _ = img.shape
    with open(path, "wb") as f:
        f.write(b"PF\n%d %d\n-1.0\n" % (w, h))
        f.write(np.ascontiguousarray(img[::-1, :, :3], "<f4").tobytes())


def read_ppm(path: str) -> np.ndarray:
    """Binary PPM 'P6' (reference bitmap.cpp read_ppm); returns linear
    float rgb in [0,1] (values are stored gamma-less by convention here)."""
    with open(path, "rb") as f:
        buf = f.read()
    tokens = []
    pos = 0
    while len(tokens) < 4:
        while pos < len(buf) and buf[pos:pos + 1].isspace():
            pos += 1
        if buf[pos:pos + 1] == b"#":
            pos = buf.index(b"\n", pos) + 1
            continue
        end = pos
        while end < len(buf) and not buf[end:end + 1].isspace():
            end += 1
        tokens.append(buf[pos:end])
        pos = end
    pos += 1
    if tokens[0] != b"P6":
        raise RuntimeError(f"{path}: only binary 'P6' PPM supported")
    w, h, maxv = int(tokens[1]), int(tokens[2]), int(tokens[3])
    dt = np.uint8 if maxv < 256 else ">u2"
    img = np.frombuffer(buf, dt, count=w * h * 3, offset=pos)
    return (img.reshape(h, w, 3).astype(np.float32) / float(maxv))


def write_ppm(path: str, img: np.ndarray):
    img = np.clip(np.asarray(img, np.float32), 0.0, 1.0)
    h, w = img.shape[:2]
    with open(path, "wb") as f:
        f.write(b"P6\n%d %d\n255\n" % (w, h))
        f.write((img[..., :3] * 255.0 + 0.5).astype(np.uint8).tobytes())


def read_rgbe(path: str) -> np.ndarray:
    """Radiance .hdr / RGBE (reference bitmap.cpp read_rgbe): shared
    exponent, new-style RLE scanlines."""
    with open(path, "rb") as f:
        buf = f.read()
    if not (buf.startswith(b"#?RADIANCE") or buf.startswith(b"#?RGBE")):
        raise RuntimeError(f"{path}: not a Radiance RGBE file")
    pos = buf.index(b"\n\n") + 2
    dim_end = buf.index(b"\n", pos)
    dims = buf[pos:dim_end].split()
    if dims[0] != b"-Y" or dims[2] != b"+X":
        raise RuntimeError(f"{path}: unsupported orientation {dims}")
    h, w = int(dims[1]), int(dims[3])
    pos = dim_end + 1
    rgbe = np.zeros((h, w, 4), np.uint8)
    data = np.frombuffer(buf, np.uint8, offset=pos)
    di = 0
    for y in range(h):
        if w < 8 or w > 0x7FFF or data[di] != 2 or data[di + 1] != 2:
            # flat (old-style) scanline
            rgbe[y] = data[di:di + w * 4].reshape(w, 4)
            di += w * 4
            continue
        di += 4
        for c in range(4):
            x = 0
            while x < w:
                run = int(data[di]); di += 1
                if run > 128:
                    rgbe[y, x:x + run - 128, c] = data[di]
                    di += 1
                    x += run - 128
                else:
                    rgbe[y, x:x + run, c] = data[di:di + run]
                    di += run
                    x += run
    f_exp = np.ldexp(1.0, rgbe[..., 3].astype(np.int32) - 136)
    return (rgbe[..., :3].astype(np.float32) + 0.5) * f_exp[..., None]


def write_rgbe(path: str, img: np.ndarray):
    img = np.maximum(np.asarray(img, np.float32), 0.0)[..., :3]
    h, w = img.shape[:2]
    m = img.max(axis=2)
    nz = m >= 1e-32
    e = np.frexp(np.maximum(m, 1e-32))[1]
    scale = np.ldexp(1.0, -e + 8)
    rgbe = np.zeros((h, w, 4), np.uint8)
    rgbe[..., :3] = np.clip(img * scale[..., None], 0, 255).astype(np.uint8)
    rgbe[..., 3] = np.where(nz, (e + 128).astype(np.uint8), 0)
    rgbe[~nz] = 0
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        f.write(b"-Y %d +X %d\n" % (h, w))
        f.write(rgbe.tobytes())              # flat scanlines


def read_jpeg(path: str) -> np.ndarray:
    """JPEG via imageio (reference bitmap.cpp libjpeg path); returns
    LINEAR rgb (sRGB decoded)."""
    import imageio.v3 as iio
    img = np.asarray(iio.imread(path), np.float32)
    if img.ndim == 2:
        img = np.stack([img] * 3, axis=-1)
    img = img[..., :3] / 255.0
    return np.where(img <= 0.04045, img / 12.92,
                    ((img + 0.055) / 1.055) ** 2.4).astype(np.float32)


def write_jpeg(path: str, img: np.ndarray, quality: int = 90):
    import imageio.v3 as iio
    img = np.clip(np.asarray(img, np.float32), 0.0, 1.0)[..., :3]
    srgb = np.where(img <= 0.0031308, img * 12.92,
                    1.055 * img ** (1 / 2.4) - 0.055)
    iio.imwrite(path, (srgb * 255.0 + 0.5).astype(np.uint8),
                quality=quality)


def read_bitmap(path: str) -> np.ndarray:
    """Extension-dispatched image read (reference Bitmap::Bitmap(path))."""
    low = path.lower()
    if low.endswith(".exr"):
        return read_exr_rgb(path)
    if low.endswith(".pfm"):
        return read_pfm(path)
    if low.endswith((".ppm", ".pnm")):
        return read_ppm(path)
    if low.endswith(".hdr"):
        return read_rgbe(path)
    if low.endswith((".jpg", ".jpeg")):
        return read_jpeg(path)
    import imageio.v3 as iio
    img = np.asarray(iio.imread(path), np.float32)
    if img.ndim == 2:
        img = np.stack([img] * 3, axis=-1)
    return img[..., :3] / 255.0


def write_bitmap(path: str, img: np.ndarray):
    """Extension-dispatched image write (reference Bitmap::write)."""
    low = path.lower()
    if low.endswith(".exr"):
        return write_exr_rgb(path, img)
    if low.endswith(".pfm"):
        return write_pfm(path, img)
    if low.endswith((".ppm", ".pnm")):
        return write_ppm(path, img)
    if low.endswith(".hdr"):
        return write_rgbe(path, img)
    if low.endswith((".jpg", ".jpeg")):
        return write_jpeg(path, img)
    if low.endswith(".png"):
        return write_png(path, img)
    raise RuntimeError(f"write_bitmap: unsupported extension for {path}")


__all__ = ["read_exr", "read_exr_rgb", "write_exr", "write_exr_rgb",
           "read_pfm", "write_pfm", "read_ppm", "write_ppm",
           "read_rgbe", "write_rgbe", "read_jpeg", "write_jpeg",
           "read_bitmap", "write_bitmap", "write_png"]
