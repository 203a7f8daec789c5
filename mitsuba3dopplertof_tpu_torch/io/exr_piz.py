"""PIZ decompression for the EXR reader, decode only (the port's copy of
the JAX package's ``io/exr_piz.py``).

Re-implemented from the OpenEXR specification (wavelet + canonical Huffman,
ImfPizCompressor/ImfHuf/ImfWav semantics) so that EXRs written by OpenEXR,
whose default is PIZ, read without the OpenEXR library. Pure numpy.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Tuple

import numpy as np

BITMAP_SIZE = 8192
HUF_ENCSIZE = (1 << 16) + 1
SHORT_ZEROCODE_RUN = 59
LONG_ZEROCODE_RUN = 63
SHORTEST_LONG_RUN = 2 + LONG_ZEROCODE_RUN - SHORT_ZEROCODE_RUN


class _BitReader:
    __slots__ = ("data", "pos", "acc", "nbits")

    def __init__(self, data: bytes, pos: int = 0):
        self.data = data
        self.pos = pos
        self.acc = 0
        self.nbits = 0

    def get_bits(self, n: int) -> int:
        while self.nbits < n:
            self.acc = (self.acc << 8) | self.data[self.pos]
            self.pos += 1
            self.nbits += 8
        self.nbits -= n
        v = (self.acc >> self.nbits) & ((1 << n) - 1)
        self.acc &= (1 << self.nbits) - 1
        return v


def _reverse_lut_from_bitmap(bitmap: np.ndarray) -> Tuple[np.ndarray, int]:
    d = np.arange(1 << 16, dtype=np.uint32)
    usable = (bitmap[d >> 3] & (1 << (d & 7)).astype(np.uint8)) != 0
    usable[0] = True
    vals = d[usable].astype(np.uint16)
    lut = np.zeros(1 << 16, np.uint16)
    lut[:vals.size] = vals
    return lut, vals.size - 1


def _huf_unpack_enc_table(br: _BitReader, im: int, iM: int) -> np.ndarray:
    lengths = np.zeros(HUF_ENCSIZE, np.int64)
    i = im
    while i <= iM:
        l = br.get_bits(6)
        if l == LONG_ZEROCODE_RUN:
            zerun = br.get_bits(8) + SHORTEST_LONG_RUN
            i += zerun
        elif l >= SHORT_ZEROCODE_RUN:
            i += l - SHORT_ZEROCODE_RUN + 2
        else:
            lengths[i] = l
            i += 1
    return lengths


def _huf_canonical_codes(lengths: np.ndarray) -> np.ndarray:
    """Build canonical codes from lengths (ImfHuf hufCanonicalCodeTable)."""
    n = np.zeros(59, np.int64)
    for l in lengths[lengths > 0]:
        n[l] += 1
    c = 0
    for i in range(58, 0, -1):
        nc = (c + n[i]) >> 1
        n[i] = c
        c = nc
    codes = np.zeros_like(lengths)
    start = n.copy()
    nz = np.nonzero(lengths)[0]
    for i in nz:
        l = lengths[i]
        codes[i] = start[l]
        start[l] += 1
    return codes


def _huf_decode(data: bytes, pos: int, nbits: int, im: int, iM: int,
                lengths: np.ndarray, codes: np.ndarray,
                n_out: int) -> np.ndarray:
    """Table-accelerated canonical-Huffman decode producing n_out uint16s."""
    # Build a flat decode dict keyed by (length << 32) | code — python dict,
    # then decode with a 14-bit fast table like the original.
    DECBITS = 14
    fast_sym = np.full(1 << DECBITS, -1, np.int64)
    fast_len = np.zeros(1 << DECBITS, np.int64)
    long_codes: Dict[Tuple[int, int], int] = {}
    nz = np.nonzero(lengths)[0]
    for sym in nz:
        l = int(lengths[sym])
        c = int(codes[sym])
        if l <= DECBITS:
            base = c << (DECBITS - l)
            cnt = 1 << (DECBITS - l)
            fast_sym[base:base + cnt] = sym
            fast_len[base:base + cnt] = l
        else:
            long_codes[(l, c)] = sym

    out = np.empty(n_out, np.uint16)
    oi = 0
    rlc = iM
    acc = 0
    nacc = 0
    total_bits = nbits
    bits_read = 0
    p = pos

    data_len = len(data)
    while oi < n_out:
        # refill
        while nacc < DECBITS and p < data_len:
            acc = (acc << 8) | data[p]
            p += 1
            nacc += 8
        if nacc >= DECBITS:
            idx = (acc >> (nacc - DECBITS)) & ((1 << DECBITS) - 1)
            sym = fast_sym[idx]
            if sym >= 0:
                l = fast_len[idx]
                nacc -= l
                acc &= (1 << nacc) - 1
            else:
                # long code: extend bit by bit beyond DECBITS
                l = DECBITS
                c = idx
                nacc_local = nacc - DECBITS
                while True:
                    l += 1
                    while nacc_local < 1:
                        if p >= data_len:
                            raise RuntimeError("PIZ: huffman stream exhausted")
                        acc = (acc << 8) | data[p]
                        p += 1
                        nacc += 8
                        nacc_local += 8
                    c = (c << 1) | ((acc >> (nacc_local - 1)) & 1)
                    nacc_local -= 1
                    sym2 = long_codes.get((l, c))
                    if sym2 is not None:
                        sym = sym2
                        nacc = nacc_local
                        acc &= (1 << nacc) - 1
                        break
                    if l > 58:
                        raise RuntimeError("PIZ: invalid huffman code")
        else:
            # tail: fewer than DECBITS left — decode short codes bit-by-bit
            l = 0
            c = 0
            found = False
            while nacc > 0:
                l += 1
                c = (c << 1) | ((acc >> (nacc - 1)) & 1)
                nacc -= 1
                acc &= (1 << nacc) - 1
                # search any symbol with this (l, c)
                if l <= DECBITS:
                    idx = c << (DECBITS - l)
                    if fast_len[idx] == l and fast_sym[idx] >= 0:
                        sym = fast_sym[idx]
                        found = True
                        break
                else:
                    sym2 = long_codes.get((l, c))
                    if sym2 is not None:
                        sym = sym2
                        found = True
                        break
            if not found:
                raise RuntimeError("PIZ: truncated huffman stream")

        if sym == rlc:
            while nacc < 8:
                if p >= data_len:
                    raise RuntimeError("PIZ: run-length needs 8 bits")
                acc = (acc << 8) | data[p]
                p += 1
                nacc += 8
            cs = (acc >> (nacc - 8)) & 0xFF
            nacc -= 8
            acc &= (1 << nacc) - 1
            if oi == 0:
                raise RuntimeError("PIZ: run-length without previous symbol")
            out[oi:oi + cs] = out[oi - 1]
            oi += cs
        else:
            out[oi] = sym
            oi += 1
    return out


def _wav2_decode(buf: np.ndarray, nx: int, ox: int, ny: int, oy: int,
                 mx: int):
    """In-place 2D inverse wavelet (ImfWav wav2Decode). ``buf`` is a flat
    uint16 view; strides ox/oy in elements."""
    w14 = mx < (1 << 14)
    n = nx if nx < ny else ny
    p = 1
    while p <= n:
        p <<= 1
    p >>= 1
    p2 = p
    p >>= 1

    def idx2(iy, ix):
        return iy * oy + ix * ox

    while p >= 1:
        # vectorized over the 2x2 block grid
        ys = np.arange(0, ny - p2 + 1, p2)
        xs = np.arange(0, nx - p2 + 1, p2)
        if ys.size and xs.size:
            YY, XX = np.meshgrid(ys, xs, indexing="ij")
            i_00 = (YY * oy + XX * ox).ravel()
            i_01 = i_00 + p * ox
            i_10 = i_00 + p * oy
            i_11 = i_10 + p * ox
            v00, v01 = buf[i_00], buf[i_01]
            v10, v11 = buf[i_10], buf[i_11]
            if w14:
                a00, a10 = _wdec14(v00, v10)
                a01, a11 = _wdec14(v01, v11)
                b00, b01 = _wdec14(a00, a01)
                b10, b11 = _wdec14(a10, a11)
            else:
                a00, a10 = _wdec16(v00, v10)
                a01, a11 = _wdec16(v01, v11)
                b00, b01 = _wdec16(a00, a01)
                b10, b11 = _wdec16(a10, a11)
            buf[i_00], buf[i_01] = b00, b01
            buf[i_10], buf[i_11] = b10, b11
        if (nx & p) and ys.size:
            # odd rightmost column: px at x = nx - p? C code: px=ex+ox2 when
            # (nx & p): handles column at px (the loop leaves px just past ex)
            x_last = xs[-1] + p2 if xs.size else 0
            if x_last <= nx - 1 - p + 0:
                pass
            xcol = (nx - (nx & p)) if False else x_last
            if xcol < nx:
                i_00 = (ys * oy + xcol * ox)
                i_10 = i_00 + p * oy
                v00, v10 = buf[i_00], buf[i_10]
                a00, a10 = _wdec14(v00, v10) if w14 else _wdec16(v00, v10)
                buf[i_00], buf[i_10] = a00, a10
        if (ny & p) and xs.size:
            y_last = ys[-1] + p2 if ys.size else 0
            if y_last < ny:
                i_00 = (y_last * oy + xs * ox)
                i_01 = i_00 + p * ox
                v00, v01 = buf[i_00], buf[i_01]
                a00, a01 = _wdec14(v00, v01) if w14 else _wdec16(v00, v01)
                buf[i_00], buf[i_01] = a00, a01
            if (nx & p):
                x_last = xs[-1] + p2 if xs.size else 0
                if y_last < ny and x_last < nx:
                    pass  # single corner element remains untouched (copy)
        p2 = p
        p >>= 1


def _wdec14(l, h):
    ls = l.astype(np.int16).astype(np.int32)
    hs = h.astype(np.int16).astype(np.int32)
    hi = hs
    ai = ls + (hi & 1) + (hi >> 1)
    a = ai
    b = ai - hi
    return a.astype(np.uint16), b.astype(np.uint16)


def _wdec16(l, h):
    m = l.astype(np.int64)
    d = h.astype(np.int64)
    bb = (m - (d >> 1)) & 0xFFFF
    aa = (d + bb - 0x8000) & 0xFFFF
    return aa.astype(np.uint16), bb.astype(np.uint16)


def piz_uncompress(data: bytes, channels: List[Tuple[str, int]], W: int,
                   ny: int) -> bytes:
    """Decompress one PIZ block into raw scanline-interleaved bytes
    (same layout as an uncompressed block: per scanline, per channel)."""
    pos = 0
    min_nz, max_nz = struct.unpack_from("<HH", data, pos)
    pos += 4
    bitmap = np.zeros(BITMAP_SIZE, np.uint8)
    if min_nz <= max_nz:
        cnt = max_nz - min_nz + 1
        bitmap[min_nz:max_nz + 1] = np.frombuffer(data, np.uint8,
                                                  cnt, pos)
        pos += cnt
    lut, max_value = _reverse_lut_from_bitmap(bitmap)

    (length,) = struct.unpack_from("<i", data, pos)
    pos += 4

    # channel planes: HALF -> 1 ushort/px, FLOAT/UINT -> 2 ushorts/px
    sizes = [1 if pt == 1 else 2 for _, pt in channels]
    total = sum(W * ny * s for s in sizes)

    # hufUncompress header
    im, iM, table_len, nbits, _ = struct.unpack_from("<iiiii", data, pos)
    hpos = pos + 20
    br = _BitReader(data, hpos)
    lengths = _huf_unpack_enc_table(br, im, iM)
    codes = _huf_canonical_codes(lengths)
    decoded = _huf_decode(data, br.pos, nbits, im, iM, lengths, codes, total)

    # per-channel wavelet decode
    off = 0
    planes = []
    for (name, pt), s in zip(channels, sizes):
        plane = decoded[off: off + W * ny * s].copy()
        for j in range(s):
            _wav2_decode(plane[j:], W, s, ny, W * s, max_value)
        planes.append(plane)
        off += W * ny * s

    # apply LUT
    planes = [lut[p] for p in planes]

    # interleave to scanline layout
    out = bytearray()
    for y in range(ny):
        for (name, pt), s, plane in zip(channels, sizes, planes):
            row = plane[y * W * s:(y + 1) * W * s]
            out += row.tobytes()
    return bytes(out)
