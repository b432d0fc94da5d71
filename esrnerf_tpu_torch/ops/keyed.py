"""Counter-based random draws keyed by integers.

A draw is a pure function of its key words: the run's seed, the global
step, and per row the ray's place in the step's global batch, the
sample's index along the ray and a lane (which draw of the row). No
generator state is carried from one call to the next, so a draw does not
depend on the order of the rows, on how the batch is split over ranks, or
on what ran before (a resumed run draws what an unbroken one draws).

The hash chains the 32-bit ``lowbias32`` mixer over the words: ``h <-
mix(h ^ word)``. It runs in plain int64 torch operations on values below
2**32: a 32-bit product is split into 16-bit halves so that no int64
product overflows, and every shift is of a non-negative value, so the CPU
and CUDA give the same bits. The words shared by a whole call (seed,
step) are mixed on the host in Python integers.

A uniform takes the top 24 bits of a lane's hash (exact in float32, in
``[0, 1)``); a standard normal takes two lanes by Box-Muller
(``sqrt(-2 ln u1) cos(2 pi u2)``, ``u1`` in ``(0, 1]``).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

MASK32 = 0xFFFFFFFF
_M1, _M2 = 0x7FEB352D, 0x846CA68B
_START = 0x243F6A88  # the state before the first word (mix(0) is 0)
_U24 = 1.0 / (1 << 24)


class DrawKey(NamedTuple):
    """The words shared by every draw of one step: the run's seed and the
    global step (any Python integers; each enters as two 32-bit
    words)."""

    seed: int
    step: int


def _mix_int(x: int) -> int:
    x ^= x >> 16
    x = (x * _M1) & MASK32
    x ^= x >> 15
    x = (x * _M2) & MASK32
    return x ^ (x >> 16)


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2**32`` for int64 ``x`` in ``[0, 2**32)`` and a 32-bit
    constant ``c``, with every intermediate below 2**49."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & MASK32


def _mix(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 16)
    x = _mul32(x, _M1)
    x = x ^ (x >> 15)
    x = _mul32(x, _M2)
    return x ^ (x >> 16)


def _prefix(key: DrawKey) -> int:
    """The hash state after the key's words, a Python integer."""
    h = _START
    for w in (key.seed, key.step):
        w &= (1 << 64) - 1
        h = _mix_int(h ^ (w & MASK32))
        h = _mix_int(h ^ (w >> 32))
    return h


def row_hash(key: DrawKey, ray: torch.Tensor,
             sample: torch.Tensor) -> torch.Tensor:
    """int64 ``[K]`` hash states of rows ``(ray, sample)`` (non-negative
    integers below 2**32) under ``key``."""
    h = _mix(ray.to(torch.int64) ^ _prefix(key))
    return _mix(h ^ sample.to(torch.int64))


def lanes(h: torch.Tensor, n: int, first: int = 0) -> torch.Tensor:
    """int64 ``[*h.shape, n]``: the final hashes of lanes ``first ..
    first + n - 1`` of each row state ``h``."""
    lane = torch.arange(first, first + n, dtype=torch.int64, device=h.device)
    return _mix(h[..., None] ^ lane)


def uniform(h: torch.Tensor) -> torch.Tensor:
    """float32 uniforms in ``[0, 1)`` from final hashes."""
    return (h >> 8).to(torch.float32) * _U24


def normal(h: torch.Tensor) -> torch.Tensor:
    """float32 standard normals from final hashes ``[..., 2 n]``, two
    lanes a normal (even lanes the radius, odd ones the angle):
    ``[..., n]``."""
    u1 = ((h[..., 0::2] >> 8) + 1).to(torch.float32) * _U24
    u2 = (h[..., 1::2] >> 8).to(torch.float32) * _U24
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos((2.0 * math.pi) * u2)
