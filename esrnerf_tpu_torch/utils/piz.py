"""PIZ codec for the OpenEXR reader/writer (numpy, and C++ for the Huffman
decode).

The port's copy of the numpy path of ``esrnerf_tpu/utils/piz.py``. PIZ is
OpenEXR's default production compression (wavelet + Huffman over 16-bit
planes, 32 scanlines per chunk) and a common Blender output format. The
scheme follows the public OpenEXR format documentation:

- bitmap/LUT range compaction (``ImfPizCompressor`` semantics)
- the 2-D Haar-like wavelet over each 16-bit plane (``ImfWav``:
  ``wav2Encode/wav2Decode`` with the 14-bit fast path and 16-bit modulo
  variants)
- canonical Huffman coding with 6-bit packed code lengths, zero-run
  escapes, and the run-length pseudo-symbol (``ImfHuf`` semantics)

The wavelet and LUT stages are vectorized numpy. The Huffman decode is a
bit-serial loop: :func:`huf_uncompress` runs it in the host library
``csrc/piz.cpp`` (the port's copy of the JAX package's native decoder,
built by :mod:`esrnerf_tpu_torch.ops.kernels` at first use) and raises if
that library cannot be built or loaded; the Python loop
(:func:`_huf_uncompress_plain`, tens of seconds for an 800x800 image)
stays as the plain version for the tests. The synthetic scenes are
written with ZIP compression and never reach this module.
"""

from __future__ import annotations

import ctypes
import struct
from typing import List, Tuple

import numpy as np

USHORT_RANGE = 1 << 16
BITMAP_SIZE = USHORT_RANGE >> 3

HUF_ENCBITS = 16
HUF_DECBITS = 14
HUF_ENCSIZE = (1 << HUF_ENCBITS) + 1  # 65537
HUF_DECSIZE = 1 << HUF_DECBITS
HUF_DECMASK = HUF_DECSIZE - 1

SHORT_ZEROCODE_RUN = 59
LONG_ZEROCODE_RUN = 63
SHORTEST_LONG_RUN = 2 + LONG_ZEROCODE_RUN - SHORT_ZEROCODE_RUN  # 6
LONGEST_LONG_RUN = 255 + SHORTEST_LONG_RUN

# 16-bit modulo wavelet constants
_NBITS = 16
_A_OFFSET = 1 << (_NBITS - 1)
_MOD_MASK = (1 << _NBITS) - 1


# ---------------------------------------------------------------- bitmap/LUT

def _bitmap_from_data(data: np.ndarray):
    """(bitmap[8192] uint8, minNonZero, maxNonZero) for uint16 ``data``."""
    present = np.zeros(USHORT_RANGE, bool)
    present[data] = True
    present[0] = False  # zero is never stored in the bitmap
    bits = np.packbits(present.reshape(-1, 8)[:, ::-1], axis=1).reshape(-1)
    nz = np.nonzero(bits)[0]
    if len(nz) == 0:
        return bits, BITMAP_SIZE - 1, 0  # min > max: empty bitmap
    return bits, int(nz[0]), int(nz[-1])


def _forward_lut_from_bitmap(bitmap: np.ndarray):
    bits = np.unpackbits(bitmap.reshape(-1, 1), axis=1)[:, ::-1].reshape(-1)
    present = bits.astype(bool)
    present[0] = True
    lut = np.zeros(USHORT_RANGE, np.uint16)
    idx = np.nonzero(present)[0]
    lut[idx] = np.arange(len(idx), dtype=np.uint16)
    return lut, len(idx) - 1  # maxValue


def _reverse_lut_from_bitmap(bitmap: np.ndarray):
    bits = np.unpackbits(bitmap.reshape(-1, 1), axis=1)[:, ::-1].reshape(-1)
    present = bits.astype(bool)
    present[0] = True
    idx = np.nonzero(present)[0]
    lut = np.zeros(USHORT_RANGE, np.uint16)
    lut[: len(idx)] = idx.astype(np.uint16)
    return lut, len(idx) - 1


# ------------------------------------------------------------------- wavelet

def _wenc14(a, b):
    as_ = a.astype(np.int16).astype(np.int32)
    bs = b.astype(np.int16).astype(np.int32)
    m = (as_ + bs) >> 1
    d = as_ - bs
    return (m & 0xFFFF).astype(np.uint16), (d & 0xFFFF).astype(np.uint16)


def _wdec14(l, h):
    ls = l.astype(np.int16).astype(np.int32)
    hs = h.astype(np.int16).astype(np.int32)
    ai = ls + (hs & 1) + (hs >> 1)
    a = ai
    b = ai - hs
    return (a & 0xFFFF).astype(np.uint16), (b & 0xFFFF).astype(np.uint16)


def _wenc16(a, b):
    ao = (a.astype(np.int32) + _A_OFFSET) & _MOD_MASK
    m = (ao + b.astype(np.int32)) >> 1
    d = ao - b.astype(np.int32)
    m = np.where(d < 0, (m + _A_OFFSET) & _MOD_MASK, m)
    d &= _MOD_MASK
    return m.astype(np.uint16), d.astype(np.uint16)


def _wdec16(l, h):
    m = l.astype(np.int32)
    d = h.astype(np.int32)
    b = (m - (d >> 1)) & _MOD_MASK
    a = (d + b - _A_OFFSET) & _MOD_MASK
    return a.astype(np.uint16), b.astype(np.uint16)


def wav2_encode(plane: np.ndarray, mx: int) -> None:
    """In-place 2-D wavelet encode of a [ny, nx] uint16 plane
    (``ImfWav.cpp wav2Encode``, vectorized per level)."""
    w14 = mx < (1 << 14)
    enc = _wenc14 if w14 else _wenc16
    ny, nx = plane.shape
    n = min(nx, ny)
    p = 1
    p2 = 2
    while p2 <= n:
        # vectorized over all (2p2)-strided 2x2 quads at offset (0,0),(0,p),
        # (p,0),(p,p)
        a = plane[0::p2, 0::p2]
        ey = (ny - p2) // p2 + 1  # number of quad rows with full pair rows
        ex = (nx - p2) // p2 + 1
        p00 = plane[0:ny - p2 + 1:p2, 0:nx - p2 + 1:p2]
        p01 = plane[0:ny - p2 + 1:p2, p:nx - p2 + 1 + p:p2]
        p10 = plane[p:ny - p2 + 1 + p:p2, 0:nx - p2 + 1:p2]
        p11 = plane[p:ny - p2 + 1 + p:p2, p:nx - p2 + 1 + p:p2]
        i00, i01 = enc(p00, p01)
        i10, i11 = enc(p10, p11)
        o00, o10 = enc(i00, i10)
        o01, o11 = enc(i01, i11)
        p00[...] = o00
        p01[...] = o01
        p10[...] = o10
        p11[...] = o11
        if nx & p:
            # odd column: pairs along y at the x where the quad loop ended
            cx = nx - (nx % p2)
            c0 = plane[0:ny - p2 + 1:p2, cx]
            c1 = plane[p:ny - p2 + 1 + p:p2, cx]
            o0, o1 = enc(c0, c1)
            plane[0:ny - p2 + 1:p2, cx] = o0
            plane[p:ny - p2 + 1 + p:p2, cx] = o1
        if ny & p:
            cy = ny - (ny % p2)
            r0 = plane[cy, 0:nx - p2 + 1:p2]
            r1 = plane[cy, p:nx - p2 + 1 + p:p2]
            o0, o1 = enc(r0, r1)
            plane[cy, 0:nx - p2 + 1:p2] = o0
            plane[cy, p:nx - p2 + 1 + p:p2] = o1
        p = p2
        p2 <<= 1


def wav2_decode(plane: np.ndarray, mx: int) -> None:
    """In-place inverse of :func:`wav2_encode` (``wav2Decode``)."""
    w14 = mx < (1 << 14)
    dec = _wdec14 if w14 else _wdec16
    ny, nx = plane.shape
    n = min(nx, ny)
    # find starting level: largest power of two <= n, then half
    p = 1
    while p <= n:
        p <<= 1
    p >>= 1
    p2 = p
    p >>= 1
    while p >= 1:
        p00 = plane[0:ny - p2 + 1:p2, 0:nx - p2 + 1:p2]
        p01 = plane[0:ny - p2 + 1:p2, p:nx - p2 + 1 + p:p2]
        p10 = plane[p:ny - p2 + 1 + p:p2, 0:nx - p2 + 1:p2]
        p11 = plane[p:ny - p2 + 1 + p:p2, p:nx - p2 + 1 + p:p2]
        i00, i10 = dec(p00, p10)
        i01, i11 = dec(p01, p11)
        o00, o01 = dec(i00, i01)
        o10, o11 = dec(i10, i11)
        p00[...] = o00
        p01[...] = o01
        p10[...] = o10
        p11[...] = o11
        if nx & p:
            cx = nx - (nx % p2)
            c0 = plane[0:ny - p2 + 1:p2, cx]
            c1 = plane[p:ny - p2 + 1 + p:p2, cx]
            o0, o1 = dec(c0, c1)
            plane[0:ny - p2 + 1:p2, cx] = o0
            plane[p:ny - p2 + 1 + p:p2, cx] = o1
        if ny & p:
            cy = ny - (ny % p2)
            r0 = plane[cy, 0:nx - p2 + 1:p2]
            r1 = plane[cy, p:nx - p2 + 1 + p:p2]
            o0, o1 = dec(r0, r1)
            plane[cy, 0:nx - p2 + 1:p2] = o0
            plane[cy, p:nx - p2 + 1 + p:p2] = o1
        p2 = p
        p >>= 1


# ------------------------------------------------------------------- huffman

def _huf_code_lengths(freq: np.ndarray, im: int, iM: int) -> np.ndarray:
    """Huffman code lengths for symbols [im, iM] (``hufBuildEncTable``
    merge semantics via linked symbol chains)."""
    import heapq

    scode = np.zeros(HUF_ENCSIZE, np.int64)
    hlink = np.arange(HUF_ENCSIZE, dtype=np.int64)
    heap = [(int(freq[i]), int(i)) for i in range(im, iM + 1) if freq[i]]
    heapq.heapify(heap)
    frq = freq.copy()
    while len(heap) > 1:
        fm, m = heapq.heappop(heap)
        fmm, mm = heapq.heappop(heap)
        frq[m] = fm + fmm
        heapq.heappush(heap, (int(frq[m]), m))
        # merge chains, incrementing code length of every symbol in both
        j = m
        while True:
            scode[j] += 1
            if hlink[j] == j:
                tail_m = j
                break
            j = hlink[j]
        j = mm
        while True:
            scode[j] += 1
            if hlink[j] == j:
                break
            j = hlink[j]
        hlink[tail_m] = mm
    return scode


def _canonical_codes(lengths: np.ndarray) -> np.ndarray:
    """Packed canonical codes ``(code << 6) | length``
    (``hufCanonicalCodeTable``)."""
    n = np.zeros(59, np.int64)
    for l in lengths[lengths > 0]:
        n[l] += 1
    c = 0
    first = np.zeros(59, np.int64)
    for i in range(58, 0, -1):
        nc = (c + n[i]) >> 1
        first[i] = c
        c = nc
    hcode = np.zeros(HUF_ENCSIZE, np.int64)
    counters = first.copy()
    idx = np.nonzero(lengths > 0)[0]
    for i in idx:
        l = int(lengths[i])
        hcode[i] = l | (int(counters[l]) << 6)
        counters[l] += 1
    return hcode


class _BitWriter:
    __slots__ = ("acc", "nbits", "out")

    def __init__(self):
        self.acc = 0
        self.nbits = 0
        self.out = bytearray()

    def write(self, nbits: int, value: int) -> None:
        self.acc = (self.acc << nbits) | value
        self.nbits += nbits
        while self.nbits >= 8:
            self.nbits -= 8
            self.out.append((self.acc >> self.nbits) & 0xFF)
        # keep only the bits not yet written: an unbounded accumulator makes
        # every shift cost its length, and an image's encode quadratic
        self.acc &= (1 << self.nbits) - 1

    def flush(self) -> int:
        total = len(self.out) * 8 + self.nbits
        if self.nbits:
            self.out.append((self.acc << (8 - self.nbits)) & 0xFF)
            self.acc = 0
            self.nbits = 0
        return total


def _pack_enc_table(hcode: np.ndarray, im: int, iM: int) -> bytes:
    w = _BitWriter()
    i = im
    while i <= iM:
        l = int(hcode[i]) & 63
        if l == 0:
            zerun = 1
            while i + zerun <= iM and zerun < LONGEST_LONG_RUN and (
                int(hcode[i + zerun]) & 63
            ) == 0:
                zerun += 1
            if zerun >= SHORTEST_LONG_RUN:
                # cap at what 8 bits can encode
                zerun = min(zerun, LONGEST_LONG_RUN)
                w.write(6, LONG_ZEROCODE_RUN)
                w.write(8, zerun - SHORTEST_LONG_RUN)
                i += zerun
                continue
            if zerun > 1:
                zerun = min(zerun, 5)
                w.write(6, SHORT_ZEROCODE_RUN + zerun - 2)
                i += zerun
                continue
            w.write(6, 0)
            i += 1
        else:
            w.write(6, l)
            i += 1
    w.flush()
    return bytes(w.out)


class _BitReader:
    __slots__ = ("data", "pos", "acc", "nbits")

    def __init__(self, data, pos=0):
        self.data = data
        self.pos = pos
        self.acc = 0
        self.nbits = 0

    def read(self, nbits: int) -> int:
        while self.nbits < nbits:
            self.acc = (self.acc << 8) | self.data[self.pos]
            self.pos += 1
            self.nbits += 8
        self.nbits -= nbits
        return (self.acc >> self.nbits) & ((1 << nbits) - 1)


def _unpack_enc_table(data, pos: int, im: int, iM: int):
    r = _BitReader(data, pos)
    lengths = np.zeros(HUF_ENCSIZE, np.int64)
    i = im
    while i <= iM:
        l = r.read(6)
        if l == LONG_ZEROCODE_RUN:
            zerun = r.read(8) + SHORTEST_LONG_RUN
            i += zerun
        elif l >= SHORT_ZEROCODE_RUN:
            i += l - SHORT_ZEROCODE_RUN + 2
        else:
            lengths[i] = l
            i += 1
    end = r.pos  # table is byte-aligned at its end
    return _canonical_codes_from_lengths_packed(lengths), end


def _canonical_codes_from_lengths_packed(lengths: np.ndarray) -> np.ndarray:
    return _canonical_codes(lengths)


def _huf_encode(hcode: np.ndarray, data: np.ndarray, rlc: int) -> Tuple[bytes, int]:
    """Run-length + Huffman bit encoding (``hufEncode``)."""
    w = _BitWriter()
    codes = hcode
    # pre-split lengths/values as python ints for the loop
    run_code = int(codes[rlc])
    run_len = run_code & 63
    run_val = run_code >> 6

    def out_code(c):
        w.write(c & 63, c >> 6)

    s = int(data[0])
    cs = 0
    # iterate over runs via numpy change-point detection
    d = np.asarray(data, np.int64)
    change = np.nonzero(d[1:] != d[:-1])[0]
    starts = np.concatenate([[0], change + 1])
    ends = np.concatenate([change + 1, [len(d)]])
    for st, en in zip(starts, ends):
        s = int(d[st])
        count = int(en - st)
        sc = int(codes[s])
        sl = sc & 63
        sv = sc >> 6
        while count > 0:
            cs = min(count, 256) - 1  # runCount stored in 8 bits
            if sl + run_len + 8 < sl * cs:
                w.write(sl, sv)
                w.write(run_len, run_val)
                w.write(8, cs)
            else:
                for _ in range(cs + 1):
                    w.write(sl, sv)
            count -= cs + 1
    nbits = w.flush()
    return bytes(w.out), nbits


def _build_dec_table(hcode: np.ndarray, im: int, iM: int):
    """(short_len[16384], short_lit[16384], longs{prefix: [symbols]})."""
    short_len = np.zeros(HUF_DECSIZE, np.int32)
    short_lit = np.zeros(HUF_DECSIZE, np.int64)
    longs: dict = {}
    idx = np.nonzero((hcode[im:iM + 1] & 63) > 0)[0] + im
    for i in idx:
        c = int(hcode[i])
        l = c & 63
        code = c >> 6
        if l > HUF_DECBITS:
            pl = code >> (l - HUF_DECBITS)
            longs.setdefault(pl, []).append(int(i))
        else:
            base = code << (HUF_DECBITS - l)
            n = 1 << (HUF_DECBITS - l)
            short_len[base: base + n] = l
            short_lit[base: base + n] = i
    return short_len, short_lit, longs


def _huf_decode(hcode, short_len, short_lit, longs, data, pos, nbits,
                rlc: int, n_out: int) -> np.ndarray:
    """Bit-serial Huffman decode (``hufDecode``)."""
    out = np.empty(n_out, np.uint16)
    oi = 0
    c = 0
    lc = 0
    end = pos + (nbits + 7) // 8
    db = data
    i = pos
    get = int
    while i < end:
        c = (c << 8) | db[i]
        i += 1
        lc += 8
        while lc >= HUF_DECBITS:
            pl_idx = (c >> (lc - HUF_DECBITS)) & HUF_DECMASK
            l = int(short_len[pl_idx])
            if l:
                lc -= l
                sym = int(short_lit[pl_idx])
            else:
                # long code: try the candidate list for this prefix
                cands = longs.get(pl_idx)
                if not cands:
                    raise ValueError("PIZ: invalid huffman code")
                sym = -1
                for j in cands:
                    cl = int(hcode[j]) & 63
                    cv = int(hcode[j]) >> 6
                    while lc < cl and i < end:
                        c = (c << 8) | db[i]
                        i += 1
                        lc += 8
                    if lc >= cl and cv == ((c >> (lc - cl)) & ((1 << cl) - 1)):
                        lc -= cl
                        sym = j
                        break
                if sym < 0:
                    raise ValueError("PIZ: unmatched long huffman code")
            if sym == rlc:
                # run-length: repeat previous symbol (8-bit count)
                if lc < 8:
                    c = (c << 8) | db[i]
                    i += 1
                    lc += 8
                cs = (c >> (lc - 8)) & 0xFF
                lc -= 8
                if oi == 0 or oi + cs > n_out:
                    raise ValueError("PIZ: bad run length")
                out[oi: oi + cs] = out[oi - 1]
                oi += cs
            else:
                out[oi] = sym
                oi += 1
        c &= (1 << lc) - 1  # only the unread bits (keeps the shifts short)
    # flush remaining whole-bit tail
    tail = (8 - nbits) & 7
    c >>= tail
    lc -= tail
    while lc > 0:
        pl_idx = (c << (HUF_DECBITS - lc)) & HUF_DECMASK
        l = int(short_len[pl_idx])
        if l and l <= lc:
            lc -= l
            sym = int(short_lit[pl_idx])
            if sym == rlc:
                raise ValueError("PIZ: run-length code in tail")
            out[oi] = sym
            oi += 1
        else:
            break
    if oi != n_out:
        raise ValueError(f"PIZ: decoded {oi} of {n_out} symbols")
    return out


def huf_compress(data: np.ndarray) -> bytes:
    """``hufCompress``: 20-byte header + packed code table + bitstream."""
    data = np.ascontiguousarray(data, np.uint16)
    if len(data) == 0:
        return b""
    freq = np.bincount(data, minlength=HUF_ENCSIZE).astype(np.int64)
    im = int(np.nonzero(freq)[0][0])
    iM = int(np.nonzero(freq)[0][-1])
    # run-length pseudo-symbol
    iM += 1
    freq[iM] = 1
    lengths = _huf_code_lengths(freq, im, iM)
    hcode = _canonical_codes(lengths)
    table = _pack_enc_table(hcode, im, iM)
    bits, nbits = _huf_encode(hcode, data, iM)
    head = struct.pack("<5I", im, iM, len(table), nbits, 0)
    return head + table + bits


def _huf_header(data: bytes):
    if len(data) < 20:
        raise ValueError("PIZ: truncated huffman header")
    im, iM, table_len, nbits, _ = struct.unpack_from("<5I", data, 0)
    if not (0 <= im < iM < HUF_ENCSIZE):
        raise ValueError("PIZ: bad huffman header")
    return im, iM, nbits


def huf_uncompress(data: bytes, n_out: int) -> np.ndarray:
    """``hufUncompress`` of ``n_out`` symbols by the host library."""
    from esrnerf_tpu_torch.ops import kernels

    if n_out == 0:
        return np.empty(0, np.uint16)
    _huf_header(data)
    out = np.empty(n_out, np.uint16)
    rc = kernels.lib("piz").piz_huf_decode(
        bytes(data), len(data),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)), n_out)
    if rc != 0:
        raise ValueError(f"PIZ: native huffman decode failed rc={rc}")
    return out


def _huf_uncompress_plain(data: bytes, n_out: int) -> np.ndarray:
    """``hufUncompress`` as a Python bit loop, the plain version."""
    if n_out == 0:
        return np.empty(0, np.uint16)
    im, iM, nbits = _huf_header(data)
    hcode, data_pos = _unpack_enc_table(data, 20, im, iM)
    short_len, short_lit, longs = _build_dec_table(hcode, im, iM)
    return _huf_decode(hcode, short_len, short_lit, longs, data, data_pos,
                       nbits, iM, n_out)


# ------------------------------------------------------------ chunk codec

def _channel_layout(chans: List[Tuple[str, int]], W: int, n_lines: int):
    """Per-channel (n_shorts_per_line, plane rows/cols) in file order.

    HALF is one short per sample; FLOAT/UINT are two shorts per sample
    (wavelet runs separately over the interleaved low/high short slices).
    """
    from esrnerf_tpu_torch.utils import exr as exrmod

    layout = []
    for name, pt in chans:
        size = exrmod._SIZES[pt] // 2
        layout.append((name, pt, size, W * size))
    return layout


def piz_compress(raw: np.ndarray, chans, W: int, n_lines: int) -> bytes:
    """Compress one chunk of scanline-interleaved raw bytes (uint8)."""
    layout = _channel_layout(chans, W, n_lines)
    per_line = sum(spl * 2 for _, _, _, spl in layout)
    assert len(raw) == per_line * n_lines, (len(raw), per_line, n_lines)
    # deinterleave scanlines into per-channel planes of uint16
    planes = []
    pos = 0
    line_u16 = np.frombuffer(raw.tobytes(), np.uint16).reshape(n_lines, -1)
    col = 0
    for name, pt, size, spl in layout:
        planes.append(np.ascontiguousarray(line_u16[:, col: col + spl]))
        col += spl
    tmp = np.concatenate([p.reshape(-1) for p in planes])

    bitmap, mn, mx = _bitmap_from_data(tmp)
    lut, max_value = _forward_lut_from_bitmap(bitmap)
    tmp = lut[tmp]

    # wavelet per channel per short-slice
    out_planes = []
    off = 0
    for (name, pt, size, spl), pl in zip(layout, planes):
        n = pl.size
        cd = tmp[off: off + n].reshape(n_lines, spl)
        for j in range(size):
            sl = np.ascontiguousarray(cd[:, j::size])
            wav2_encode(sl, max_value)
            cd[:, j::size] = sl
        off += n
    huf = huf_compress(tmp)

    head = struct.pack("<HH", mn, mx)
    if mn <= mx:
        head += bitmap[mn: mx + 1].tobytes()
    head += struct.pack("<i", len(huf))
    return head + huf


def piz_uncompress(data: bytes, chans, W: int, n_lines: int) -> np.ndarray:
    """Decompress one PIZ chunk back to scanline-interleaved uint8."""
    layout = _channel_layout(chans, W, n_lines)
    mn, mx = struct.unpack_from("<HH", data, 0)
    pos = 4
    bitmap = np.zeros(BITMAP_SIZE, np.uint8)
    if mn <= mx:
        nb = mx - mn + 1
        bitmap[mn: mx + 1] = np.frombuffer(data, np.uint8, nb, pos)
        pos += nb
    (huf_len,) = struct.unpack_from("<i", data, pos)
    pos += 4
    lut, max_value = _reverse_lut_from_bitmap(bitmap)

    n_shorts = sum(spl for _, _, _, spl in layout) * n_lines
    tmp = huf_uncompress(data[pos: pos + huf_len], n_shorts)

    off = 0
    planes = []
    for name, pt, size, spl in layout:
        n = spl * n_lines
        cd = tmp[off: off + n].reshape(n_lines, spl).copy()
        for j in range(size):
            sl = np.ascontiguousarray(cd[:, j::size])
            wav2_decode(sl, max_value)
            cd[:, j::size] = sl
        planes.append(lut[cd])
        off += n

    # re-interleave into scanline order
    line_u16 = np.concatenate(planes, axis=1)
    cols = []
    col = 0
    # planes are already in channel order per line; concatenate columns in
    # file channel order reproduces the raw layout
    return np.frombuffer(
        np.ascontiguousarray(line_u16).tobytes(), np.uint8
    ).copy()
