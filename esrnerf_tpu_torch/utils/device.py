"""Device selection for the port's entry points, small device constants,
and timing of calls on a device."""

from __future__ import annotations

import functools
import time
from typing import Sequence

import torch


def resolve_device(device="cuda") -> torch.device:
    """``torch.device`` for an entry point's ``device`` argument.

    Entry points default to ``"cuda"``. Without CUDA this raises instead of
    quietly running the plain PyTorch versions on the CPU: a caller that
    wants the CPU says ``device="cpu"``.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch versions on the CPU"
        )
    return dev


def time_calls(fn, device, reps: int = 10) -> float:
    """Mean seconds per call of ``fn()`` over ``reps`` back-to-back calls
    after one warm-up call. On the card: CUDA events around the calls,
    after a spin kernel (``torch.cuda._sleep``) that holds the card while
    the host enqueues them, sized from one synchronised call's host time,
    so the events time the device's work and not the host's launch cost.
    Elsewhere the host clock."""
    dev = torch.device(device)
    fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(dev)
        host_s = time.perf_counter() - t0
        # ~2e9 cycles a second at the H100's boost clock; a lower clock
        # only lengthens the spin
        torch.cuda._sleep(int(min(2e9, (2 * reps * host_s + 1e-3) * 2e9)))
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / 1e3 / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps


@functools.lru_cache(maxsize=None)
def _const(values: tuple, dtype: torch.dtype, device: torch.device):
    return torch.tensor(values, dtype=dtype, device=device)


def small_const(values: Sequence, dtype: torch.dtype, device) -> torch.Tensor:
    """A small constant tensor on ``device``, made once per (values, dtype,
    device). ``torch.tensor(..., device="cuda")`` is a blocking copy that
    synchronises the stream, so the step never makes one. Callers must not
    modify the result in place."""
    return _const(tuple(values), dtype, torch.device(device))
