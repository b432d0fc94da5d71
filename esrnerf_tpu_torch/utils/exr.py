"""Minimal OpenEXR scanline codec (pure numpy + zlib).

The port's copy of ``esrnerf_tpu/utils/exr.py``. The ESR-NeRF datasets
store HDR ground truth as ``.exr`` and evals compute ``lin/MSE_EXR``
against it; no EXR library is needed. This module implements the OpenEXR
2.0 single-part scanline format from the public spec:

- reading: NONE / ZIPS(1-line) / ZIP(16-line) / PIZ(32-line) compression,
  HALF/FLOAT/UINT channels, arbitrary channel names (returns RGB(A)
  ordering when present);
- writing: HALF or FLOAT, NONE / ZIP / PIZ compression.

PIZ (wavelet + Huffman, the common Blender/production default) lives in
``utils/piz.py``.

The ZIP scheme is zlib over delta-encoded, two-way interleaved bytes
(OpenEXR ``ImfZip.cpp`` semantics, re-derived here in vectorized numpy).
"""

from __future__ import annotations

import struct
import zlib
from typing import Dict, List, Tuple

import numpy as np

MAGIC = 0x01312F76
PT_UINT, PT_HALF, PT_FLOAT = 0, 1, 2
_DTYPES = {PT_UINT: np.uint32, PT_HALF: np.float16, PT_FLOAT: np.float32}
_SIZES = {PT_UINT: 4, PT_HALF: 2, PT_FLOAT: 4}
COMP_NONE, COMP_RLE, COMP_ZIPS, COMP_ZIP, COMP_PIZ = 0, 1, 2, 3, 4
_LINES_PER_BLOCK = {COMP_NONE: 1, COMP_ZIPS: 1, COMP_ZIP: 16, COMP_PIZ: 32}


# ------------------------------------------------------------- zip predictor

def _zip_decode(data: bytes, expected: int) -> np.ndarray:
    raw = np.frombuffer(zlib.decompress(data), np.uint8).astype(np.int32)
    # un-delta: t[i] = t[i-1] + t[i] - 128 (mod 256)
    raw[1:] -= 128
    raw = np.cumsum(raw, dtype=np.int64) % 256
    raw = raw.astype(np.uint8)
    # un-interleave: first half -> even positions, second half -> odd
    n = len(raw)
    half = (n + 1) // 2
    out = np.empty(n, np.uint8)
    out[0::2] = raw[:half]
    out[1::2] = raw[half:]
    assert n == expected, (n, expected)
    return out


def _zip_encode(raw: np.ndarray) -> bytes:
    n = len(raw)
    half = (n + 1) // 2
    tmp = np.empty(n, np.uint8)
    tmp[:half] = raw[0::2]
    tmp[half:] = raw[1::2]
    t = tmp.astype(np.int32)
    d = np.empty(n, np.int32)
    d[0] = t[0]
    d[1:] = (t[1:] - t[:-1] + 128) % 256
    return zlib.compress(d.astype(np.uint8).tobytes(), 4)


# ------------------------------------------------------------------- reading

def _read_attrs(buf: memoryview, pos: int) -> Tuple[Dict[str, tuple], int]:
    attrs: Dict[str, tuple] = {}
    while True:
        end = bytes(buf[pos:pos + 256]).index(b"\0") + pos
        name = bytes(buf[pos:end]).decode()
        pos = end + 1
        if name == "":
            break
        end = bytes(buf[pos:pos + 256]).index(b"\0") + pos
        atype = bytes(buf[pos:end]).decode()
        pos = end + 1
        (size,) = struct.unpack_from("<i", buf, pos)
        pos += 4
        attrs[name] = (atype, bytes(buf[pos:pos + size]))
        pos += size
    return attrs, pos


def _parse_chlist(data: bytes) -> List[Tuple[str, int]]:
    chans = []
    pos = 0
    while data[pos] != 0:
        end = data.index(b"\0", pos)
        name = data[pos:end].decode()
        pos = end + 1
        (ptype,) = struct.unpack_from("<i", data, pos)
        pos += 16  # ptype + pLinear/reserved + xSampling + ySampling
        chans.append((name, ptype))
    return chans  # already alphabetical per spec


def imread(path: str) -> np.ndarray:
    """Read an EXR into float32 [H, W, C]; channels ordered RGB(A) when the
    file has R/G/B(/A), else alphabetical."""
    with open(path, "rb") as f:
        buf = memoryview(f.read())

    magic, version = struct.unpack_from("<ii", buf, 0)
    if magic != MAGIC:
        raise ValueError(f"{path}: not an EXR file")
    if version & 0x200:
        raise NotImplementedError("multi-part EXR not supported")
    if version & 0x800:
        raise NotImplementedError("deep EXR not supported")
    if version & 0x100:
        raise NotImplementedError("tiled EXR not supported")

    attrs, pos = _read_attrs(buf, 8)
    chans = _parse_chlist(attrs["channels"][1])
    comp = attrs["compression"][1][0]
    if comp not in _LINES_PER_BLOCK:
        raise NotImplementedError(f"EXR compression {comp} not supported")
    xmin, ymin, xmax, ymax = struct.unpack("<4i", attrs["dataWindow"][1])
    W, H = xmax - xmin + 1, ymax - ymin + 1
    lpb = _LINES_PER_BLOCK[comp]
    n_blocks = (H + lpb - 1) // lpb

    offsets = struct.unpack_from(f"<{n_blocks}Q", buf, pos)

    per_line = sum(W * _SIZES[pt] for _, pt in chans)
    out = {name: np.empty((H, W), np.float32) for name, _ in chans}

    for off in offsets:
        y, dsize = struct.unpack_from("<ii", buf, off)
        data = bytes(buf[off + 8: off + 8 + dsize])
        y0 = y - ymin
        n_lines = min(lpb, H - y0)
        raw_len = per_line * n_lines
        if comp == COMP_NONE:
            raw = np.frombuffer(data, np.uint8)
        elif dsize >= raw_len:  # incompressible block stored raw
            raw = np.frombuffer(data, np.uint8)
        elif comp == COMP_PIZ:
            from esrnerf_tpu_torch.utils import piz

            raw = piz.piz_uncompress(data, chans, W, n_lines)
            assert len(raw) == raw_len, (len(raw), raw_len)
        else:
            raw = _zip_decode(data, raw_len)
        p = 0
        for li in range(n_lines):
            for name, pt in chans:
                nbytes = W * _SIZES[pt]
                line = np.frombuffer(
                    raw[p: p + nbytes].tobytes(), _DTYPES[pt]
                ).astype(np.float32)
                out[name][y0 + li] = line
                p += nbytes

    names = [n for n, _ in chans]
    if set("RGB").issubset(names):
        order = ["R", "G", "B"] + (["A"] if "A" in names else [])
    else:
        order = names
    return np.stack([out[n] for n in order], axis=-1)


# ------------------------------------------------------------------- writing

def _attr(name: str, atype: str, value: bytes) -> bytes:
    return name.encode() + b"\0" + atype.encode() + b"\0" + struct.pack(
        "<i", len(value)
    ) + value


def imwrite(path: str, img: np.ndarray, half: bool = True,
            compression: str = "zip") -> None:
    img = np.asarray(img, np.float32)
    if img.ndim == 2:
        img = img[..., None]
    H, W, C = img.shape
    names = ["R", "G", "B", "A"][:C] if C <= 4 else [f"C{i}" for i in range(C)]
    ptype = PT_HALF if half else PT_FLOAT
    dt = _DTYPES[ptype]
    comp = {"none": COMP_NONE, "zip": COMP_ZIP, "zips": COMP_ZIPS,
            "piz": COMP_PIZ}[compression]
    lpb = _LINES_PER_BLOCK[comp]

    order = sorted(range(C), key=lambda i: names[i])
    chlist = b""
    for i in order:
        chlist += names[i].encode() + b"\0" + struct.pack(
            "<iBBBBii", ptype, 0, 0, 0, 0, 1, 1
        )
    chlist += b"\0"

    box = struct.pack("<4i", 0, 0, W - 1, H - 1)
    header = (
        struct.pack("<ii", MAGIC, 2)
        + _attr("channels", "chlist", chlist)
        + _attr("compression", "compression", bytes([comp]))
        + _attr("dataWindow", "box2i", box)
        + _attr("displayWindow", "box2i", box)
        + _attr("lineOrder", "lineOrder", b"\0")
        + _attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
        + _attr("screenWindowCenter", "v2f", struct.pack("<ff", 0.0, 0.0))
        + _attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
        + b"\0"
    )

    n_blocks = (H + lpb - 1) // lpb
    chunks = []
    data16 = img.astype(dt)
    for b in range(n_blocks):
        y0 = b * lpb
        n_lines = min(lpb, H - y0)
        lines = []
        for li in range(n_lines):
            for i in order:
                lines.append(data16[y0 + li, :, i].tobytes())
        raw = b"".join(lines)
        if comp == COMP_NONE:
            payload = raw
        elif comp == COMP_PIZ:
            from esrnerf_tpu_torch.utils import piz

            ordered = [(names[i], ptype) for i in order]
            payload = piz.piz_compress(
                np.frombuffer(raw, np.uint8), ordered, W, n_lines
            )
            if len(payload) >= len(raw):
                payload = raw
        else:
            payload = _zip_encode(np.frombuffer(raw, np.uint8))
            if len(payload) >= len(raw):
                payload = raw
        chunks.append((y0, payload))

    table_pos = len(header)
    data_pos = table_pos + 8 * n_blocks
    offsets = []
    cur = data_pos
    for y0, payload in chunks:
        offsets.append(cur)
        cur += 8 + len(payload)

    with open(path, "wb") as f:
        f.write(header)
        f.write(struct.pack(f"<{n_blocks}Q", *offsets))
        for y0, payload in chunks:
            f.write(struct.pack("<ii", y0, len(payload)))
            f.write(payload)
