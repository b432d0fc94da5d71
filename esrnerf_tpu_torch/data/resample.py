"""Image resampling for ``data.resize``, without PIL or OpenCV.

The JAX loaders resize images and masks with PIL's Lanczos and the
ESR-NeRF HDRs with OpenCV's Lanczos-4; the card's machine has neither.
This module reproduces both in numpy:

- :func:`lanczos_pil`: ``Image.fromarray(img).resize(size, Image.LANCZOS)``
  on uint8 ``L``, ``LA``, ``RGB`` and ``RGBA`` images, bit for bit. PIL
  (``libImaging/Resample.c``) builds separable Lanczos-3 coefficients with
  support ``3 * max(scale, 1)``, normalises them in double, quantises them
  to integers with 22 fractional bits (rounding half away from zero),
  resamples horizontally, then vertically, each pass accumulating in
  integers from a rounding bias of 2^21 and clipping to uint8. ``LA`` and
  ``RGBA`` are resized premultiplied by alpha (``Convert.c``), and divided
  back after.
- :func:`lanczos4_cv2`: ``cv2.resize(img, size,
  interpolation=cv2.INTER_LANCZOS4)`` on float32 images: a fixed 8-tap
  windowed sinc at the source coordinate ``(d + 0.5) * scale - 0.5``, no
  antialiasing when shrinking, the border replicated, coefficients in
  float32 normalised to sum 1, horizontal pass then vertical pass in
  float32, each sum in the order of OpenCV's loops for a 4-lane vector
  unit (x86's baseline SSE build), where it agrees bit for bit.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np

_PRECISION_BITS = 22  # PIL's fixed-point fraction of the 8-bit resampler


def _sinc(x: float) -> float:
    if x == 0.0:
        return 1.0
    x = x * math.pi
    return math.sin(x) / x


def _lanczos3(x: float) -> float:
    if -3.0 <= x < 3.0:
        return _sinc(x) * _sinc(x / 3)
    return 0.0


def _pil_coeffs(in_size: int, out_size: int):
    """PIL's ``precompute_coeffs`` + ``normalize_coeffs_8bpc`` for the
    whole source range: ``(first tap [out], int64 coefficients [out,
    ksize])``, taps past a row's own count zero."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 3.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    first = np.zeros(out_size, np.int64)
    kk = np.zeros((out_size, ksize), np.int64)
    ss = 1.0 / filterscale
    one = float(1 << _PRECISION_BITS)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        w = [_lanczos3((x + xmin - center + 0.5) * ss) for x in range(xmax)]
        ww = 0.0
        for v in w:
            ww += v
        for x, v in enumerate(w):
            if ww != 0.0:
                v /= ww
            # C's (int) truncates toward zero
            kk[xx, x] = int(v * one - 0.5) if v < 0 else int(0.5 + v * one)
        first[xx] = xmin
    return first, kk


def _pil_pass(img: np.ndarray, axis: int, out_size: int) -> np.ndarray:
    """One 8-bit pass of PIL's resampler along ``axis`` (0 rows, 1
    columns) of ``img [H, W, C]`` uint8."""
    first, kk = _pil_coeffs(img.shape[axis], out_size)
    n = img.shape[axis]
    src = img.astype(np.int64)
    shape = [1, 1, 1]
    shape[axis] = out_size
    acc = np.full(img.shape[:axis] + (out_size,) + img.shape[axis + 1:],
                  1 << (_PRECISION_BITS - 1), np.int64)
    for j in range(kk.shape[1]):
        k = kk[:, j]
        if not k.any():
            continue
        idx = np.minimum(first + j, n - 1)
        acc += np.take(src, idx, axis=axis) * k.reshape(shape)
    return np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)


def _muldiv255(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    t = a.astype(np.int64) * b + 128
    return ((t >> 8) + t) >> 8


def lanczos_pil(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """PIL's ``Image.fromarray(img).resize(size, Image.LANCZOS)`` as a
    uint8 array: ``img`` uint8 ``[H, W]`` (L), ``[H, W, 2]`` (LA), ``[H, W,
    3]`` (RGB) or ``[H, W, 4]`` (RGBA); ``size`` is ``(width,
    height)``."""
    if img.dtype != np.uint8 or img.ndim not in (2, 3) or (
            img.ndim == 3 and img.shape[2] not in (2, 3, 4)):
        raise ValueError(f"want a uint8 L/LA/RGB/RGBA image, got "
                         f"{img.dtype} {img.shape}")
    W, H = int(size[0]), int(size[1])
    if (img.shape[1], img.shape[0]) == (W, H):
        return img.copy()
    x = img[..., None] if img.ndim == 2 else img
    alpha = x.shape[2] in (2, 4)
    if alpha:  # premultiply (RGBA -> RGBa, LA -> La)
        a = x[..., -1:].astype(np.int64)
        x = np.concatenate([_muldiv255(x[..., :-1], a), a], -1).astype(
            np.uint8)
    if W != x.shape[1]:
        x = _pil_pass(x, 1, W)
    if H != x.shape[0]:
        x = _pil_pass(x, 0, H)
    if alpha:  # and back (RGBa -> RGBA, La -> LA)
        a = x[..., -1:].astype(np.int64)
        c = x[..., :-1].astype(np.int64)
        div = np.clip(255 * c // np.maximum(a, 1), 0, 255)
        c = np.where((a == 0) | (a == 255), c, div)
        x = np.concatenate([c, a], -1).astype(np.uint8)
    return x[..., 0] if img.ndim == 2 else x


# OpenCV's Lanczos-4 window: (cos, sin) weights of sin(y0 + i * 3pi/4)
_S45 = 0.70710678118654752440084436210485
_CS = ((1, 0), (-_S45, -_S45), (0, 1), (_S45, -_S45), (-1, 0), (_S45, _S45),
       (0, -1), (-_S45, _S45))


def _cv2_taps(in_size: int, out_size: int):
    """``(first source index [out], float32 coefficients [out, 8])`` of
    OpenCV's ``interpolateLanczos4`` at ``fx = (d + 0.5) * scale - 0.5``;
    taps ``first .. first + 7`` (clamped by the caller)."""
    scale = 1.0 / (out_size / in_size)
    f32 = np.float32
    fx = ((np.arange(out_size) + 0.5) * scale - 0.5).astype(f32)
    sx = np.floor(fx).astype(np.int64)
    fx = (fx - sx.astype(f32)).astype(f32)
    y0 = -(fx + f32(3)).astype(np.float64) * math.pi * 0.25
    s0, c0 = np.sin(y0), np.cos(y0)
    coeffs = np.zeros((out_size, 8), f32)
    total = np.zeros(out_size, f32)
    for i in range(8):
        yi = (fx + f32(3) - f32(i)).astype(f32)
        y = -yi.astype(np.float64) * math.pi * 0.25
        with np.errstate(divide="ignore", invalid="ignore"):
            c = ((_CS[i][0] * s0 + _CS[i][1] * c0) / (y * y)).astype(f32)
        coeffs[:, i] = np.where(np.abs(yi) >= f32(1e-6), c, f32(1e30))
        total = (total + coeffs[:, i]).astype(f32)
    inv = (f32(1) / total).astype(f32)
    return sx - 3, (coeffs * inv[:, None]).astype(f32)


def lanczos4_cv2(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """OpenCV's ``cv2.resize(img, size, interpolation=cv2.INTER_LANCZOS4)``
    on a float32 ``[H, W]`` or ``[H, W, C]`` image; ``size`` is ``(width,
    height)``. The column pass sums its taps in one order in OpenCV's
    4-lane vector loop and in another in its scalar tail; a build with
    wider vectors splits the row elsewhere and differs in the last bit."""
    W, H = int(size[0]), int(size[1])
    x = np.asarray(img, np.float32)
    if (x.shape[1], x.shape[0]) == (W, H):
        return x.copy()
    f32 = np.float32
    first, cx = _cv2_taps(x.shape[1], W)
    tmp = np.zeros((x.shape[0], W) + x.shape[2:], f32)
    bshape = (1, W) + (1,) * (x.ndim - 2)
    for j in range(8):  # sequential float32 sum, as OpenCV's row pass
        idx = np.clip(first + j, 0, x.shape[1] - 1)
        tmp = (tmp + x[:, idx] * cx[:, j].reshape(bshape)).astype(f32)
    first, cy = _cv2_taps(x.shape[0], H)
    rows = tmp.reshape(x.shape[0], -1)
    terms = [rows[np.clip(first + k, 0, x.shape[0] - 1)] * cy[:, k, None]
             for k in range(8)]
    # the column pass: 4-wide vector loop, the chain S7 b7 -> S0 b0 of
    # separate multiplies and adds; the scalar tail sums S0 b0 .. S7 b7
    n4 = rows.shape[1] // 4 * 4
    out = np.empty((H, rows.shape[1]), f32)
    acc = terms[7][:, :n4]
    for k in range(6, -1, -1):
        acc = terms[k][:, :n4] + acc
    out[:, :n4] = acc
    acc = terms[0][:, n4:]
    for k in range(1, 8):
        acc = acc + terms[k][:, n4:]
    out[:, n4:] = acc
    return out.reshape((H, W) + x.shape[2:])
