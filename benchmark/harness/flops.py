"""Matrix-multiply operations of a head, from its widths. A stage's
reference module (``benchmark/reference/<stage>.py``) counts its heads'
operations a step or a march with it.

A head is a ReLU stack of ``[in, out]`` layers; a layer costs ``2 in out``
operations a sample forward.
"""

from __future__ import annotations

from typing import List


def head_flops(dims: List[int]) -> float:
    """Forward operations of one sample through a head of widths ``dims``."""
    return float(sum(2 * a * b for a, b in zip(dims, dims[1:])))
