"""Device selection for the port's entry points, and small device
constants."""

from __future__ import annotations

import functools
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


@functools.lru_cache(maxsize=None)
def _const(values: tuple, dtype: torch.dtype, device: torch.device):
    return torch.tensor(values, dtype=dtype, device=device)


def small_const(values: Sequence, dtype: torch.dtype, device) -> torch.Tensor:
    """A small constant tensor on ``device``, made once per (values, dtype,
    device). ``torch.tensor(..., device="cuda")`` is a blocking copy that
    synchronises the stream, so the step never makes one. Callers must not
    modify the result in place."""
    return _const(tuple(values), dtype, torch.device(device))
