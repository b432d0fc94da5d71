"""The program's own span record and counters
(``esrnerf_tpu_torch.utils.profiling.snapshot``), for the per-layer
readers of host time and counts. A program without the record reads as
nothing (None), as does a span or counter it never wrote."""

from __future__ import annotations

import statistics
from typing import Optional


def snapshot() -> Optional[dict]:
    from esrnerf_tpu_torch.utils import profiling

    snap = getattr(profiling, "snapshot", None)
    return None if snap is None else snap()


def median_ms(name: str) -> Optional[float]:
    """Median host ms of the span's last recorded calls."""
    span = ((snapshot() or {}).get("spans") or {}).get(name)
    if not span or not span["ns"]:
        return None
    return statistics.median(span["ns"]) / 1e6


def counter(name: str) -> Optional[float]:
    return ((snapshot() or {}).get("counters") or {}).get(name)
