"""8-bit PNG reader and writer on ``zlib`` and numpy.

The datasets store images as PNGs, and the trainers write their renders as
PNGs; this module needs neither PIL nor OpenCV. It reads non-interlaced
8-bit grey, grey+alpha, RGB and RGBA images with any of the five row
filters, and writes them with filter 0 (none) or the row filters asked
for.

The row filters are undone by the host library ``csrc/png_unfilter.cpp``
(built by :mod:`esrnerf_tpu_torch.ops.kernels` at first use): the average
and Paeth filters, which photographs mostly use, are sequential along a
row, and the plain Python version (:func:`_unfilter_plain`, kept for the
tests) takes seconds per megapixel. If the library cannot be built or
loaded, :func:`read` raises.
"""

from __future__ import annotations

import ctypes
import struct
import zlib

import numpy as np

_SIG = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # colour type -> samples/pixel


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def _filter_rows(x: np.ndarray, bpp: int, types) -> np.ndarray:
    """``x [H, stride]`` uint8 filtered row by row, row ``y`` with type
    ``types[y]`` (0 none, 1 sub, 2 up, 3 average, 4 Paeth): the raw rows
    ``[H, 1 + stride]``, filter byte first."""
    H, stride = x.shape
    x = x.astype(np.int32)
    up = np.vstack([np.zeros((1, stride), np.int32), x[:-1]])
    pad = np.zeros((H, bpp), np.int32)
    left = np.hstack([pad, x[:, :-bpp]])
    upleft = np.hstack([pad, up[:, :-bpp]])
    p = left + up - upleft
    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
    paeth = np.where((pa <= pb) & (pa <= pc), left,
                     np.where(pb <= pc, up, upleft))
    types = np.asarray(types, np.int64)
    pred = np.choose(types[:, None], [np.zeros_like(x), left, up,
                                      (left + up) >> 1, paeth])
    return np.hstack([types[:, None], (x - pred) & 0xFF]).astype(np.uint8)


def write(path: str, img: np.ndarray, level: int = 6, filters=None) -> None:
    """Write a uint8 ``[H, W]`` or ``[H, W, C]`` image, C 1-4. Every row
    takes filter 0 (none) unless ``filters`` gives each row's type (0 none,
    1 sub, 2 up, 3 average, 4 Paeth)."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"png.write takes uint8 images, got {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    H, W, C = img.shape
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}.get(C)
    if ctype is None:
        raise ValueError(f"png.write: {C} channels (want 1 to 4)")
    x = np.ascontiguousarray(img).reshape(H, W * C)
    rows = (np.concatenate([np.zeros((H, 1), np.uint8), x], 1)
            if filters is None else _filter_rows(x, C, filters))
    ihdr = struct.pack(">IIBBBBB", W, H, 8, ctype, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_SIG + _chunk(b"IHDR", ihdr)
                + _chunk(b"IDAT", zlib.compress(rows.tobytes(), level))
                + _chunk(b"IEND", b""))


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter_plain(raw: np.ndarray, H: int, stride: int,
                    bpp: int) -> np.ndarray:
    """Undo the per-row filters of ``raw [H, 1 + stride]`` in Python."""
    out = np.zeros((H, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    for y in range(H):
        ftype = int(raw[y, 0])
        line = raw[y, 1:].astype(np.int32)
        if ftype == 0:
            cur = line
        elif ftype == 2:  # up
            cur = (line + prev) & 0xFF
        elif ftype == 1:  # sub: a running sum per channel
            cur = np.empty(stride, np.int32)
            for ch in range(bpp):
                cur[ch::bpp] = np.cumsum(line[ch::bpp]) & 0xFF
        elif ftype in (3, 4):  # average, paeth: sequential along the row
            lv, pv = line.tolist(), prev.tolist()
            cv = [0] * stride
            for i in range(stride):
                a = cv[i - bpp] if i >= bpp else 0
                c = pv[i - bpp] if i >= bpp else 0
                pred = (a + pv[i]) >> 1 if ftype == 3 else _paeth(a, pv[i], c)
                cv[i] = (lv[i] + pred) & 0xFF
            cur = np.asarray(cv, np.int32)
        else:
            raise ValueError(f"PNG: bad filter type {ftype} in row {y}")
        out[y] = cur
        prev = cur
    return out


def _unfilter(raw: np.ndarray, H: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters of ``raw [H, 1 + stride]`` with the host
    library; the same bytes as :func:`_unfilter_plain`."""
    from esrnerf_tpu_torch.ops import kernels

    raw = np.ascontiguousarray(raw, np.uint8)
    if raw.shape != (H, stride + 1) or not 1 <= bpp <= 4:
        raise ValueError(f"PNG: {raw.shape} bytes of rows for {H} rows of "
                         f"{stride} at {bpp} bytes a pixel")
    out = np.empty((H, stride), np.uint8)
    bad = kernels.lib("png_unfilter").esr_png_unfilter(
        raw.ctypes.data_as(ctypes.c_void_p), H, stride, bpp,
        out.ctypes.data_as(ctypes.c_void_p))
    if bad:
        raise ValueError(f"PNG: bad filter type {int(raw[bad - 1, 0])} in "
                         f"row {bad - 1}")
    return out


def read(path: str) -> np.ndarray:
    """Read a PNG into uint8 ``[H, W, C]`` (C = 2, 3 or 4) or ``[H, W]``
    for grey, as ``numpy.asarray(PIL.Image.open(path))`` gives them."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _SIG:
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        (n,) = struct.unpack_from(">I", data, pos)
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if hdr is None:
        raise ValueError(f"{path}: no IHDR chunk")
    W, H, depth, ctype, _, _, interlace = hdr
    if depth != 8 or interlace != 0 or ctype not in _CHANNELS:
        raise NotImplementedError(
            f"{path}: only non-interlaced 8-bit PNGs are read (depth {depth}, "
            f"colour type {ctype}, interlace {interlace})")
    C = _CHANNELS[ctype]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    img = _unfilter(raw.reshape(H, 1 + W * C), H, W * C, C).reshape(H, W, C)
    return img[..., 0] if C == 1 else img
