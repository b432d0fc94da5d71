"""The chip's peaks and the least work each of the port's kernels needs.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at the 700 W
limit): HBM3 at 3.35 TB/s, float32 outside the tensor cores at 67 TFLOP/s,
bfloat16 on the tensor cores at 989 TFLOP/s.

A kernel's bound is the larger of its bytes over the HBM peak and its
float32 operations over the float32 peak. Bytes count each input byte read
once and each output byte written once, from the launch's shapes and, where
the work depends on the data, from what these inputs need: the rows before
``n_valid`` (the march's pad tail is skipped) and the distinct table rows
that a gather reads or a splat accumulates into.
"""

from __future__ import annotations

from typing import Dict, Optional

HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12

# kernels of the port whose launches the benchmark records, by the name of
# their launcher in ``esrnerf_tpu_torch/ops/kernels.py``; the device trace
# names each ``<name>_kernel``
KERNELS = ("scan_fwd", "scan_bwd", "splat", "gather_weighted", "gather_raw")
GATHER_CHUNK = 2048  # rows a gather block skips whole past n_valid


def scan_fwd(N: int, S: int) -> Dict[str, float]:
    """K-1: reads alpha ``[N, S]``; writes the weights and the entering
    transmittance ``[N, S]`` and the last transmittance ``[N]``."""
    return {"bytes": 4.0 * (3 * N * S + N), "flops": 3.0 * N * S}


def scan_bwd(N: int, S: int) -> Dict[str, float]:
    """K-2: reads alpha, t_in and the weights' cotangent ``[N, S]`` and the
    last transmittance's ``[N]``; writes alpha's cotangent ``[N, S]``."""
    return {"bytes": 4.0 * (4 * N * S + N), "flops": 6.0 * N * S}


def splat(S: int, C: int, M_valid: int, rows: int) -> Dict[str, float]:
    """K-3: reads the bases ``[M]`` and values ``[S, C, M]`` of the rows
    before ``n_valid``; reads and writes each of the ``rows`` distinct
    table rows it accumulates into once."""
    return {"bytes": 4.0 * (M_valid + S * C * M_valid + 2 * rows * C),
            "flops": 2.0 * S * C * M_valid}


def gather_weighted(C: int, D: int, M: int, M_valid: int,
                    rows: int) -> Dict[str, float]:
    """K-4 weighted: reads the bases ``[M]`` and weights ``[M, D]`` of the
    live chunks and each distinct table row ``[C]`` once; writes ``[M,
    C]``."""
    return {"bytes": 4.0 * (M_valid * (1 + D) + rows * C + M * C),
            "flops": 2.0 * D * C * M_valid}


def gather_raw(D: int, M: int, M_valid: int, rows: int) -> Dict[str, float]:
    """K-4 raw: reads the bases of the live chunks and each distinct table
    value once; writes ``[M, D]``."""
    return {"bytes": 4.0 * (M_valid + rows + M * D), "flops": 0.0}


def bound_s(work: Dict[str, float]) -> float:
    """The least time the chip could take for ``work``."""
    return max(work["bytes"] / HBM_BYTES_PER_S,
               work["flops"] / F32_FLOP_PER_S)


def live_rows(M: int, n_valid: Optional[int], chunk: int = 1) -> int:
    """Rows a launch processes: those before ``n_valid`` rounded up to whole
    ``chunk``s, all ``M`` without ``n_valid``."""
    if n_valid is None:
        return M
    return min(M, -(-int(n_valid) // chunk) * chunk)
