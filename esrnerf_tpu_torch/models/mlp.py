"""Plain-dict MLPs for the renderer heads.

Port of ``esrnerf_tpu/models/mlp.py``. A head is a dict ``{"w0", "b0",
"w1", "b1", ...}`` with ``[in, out]`` weights, applied as a ReLU stack.

Precision: the reference runs the matmuls on bf16 operands with f32
accumulation and an f32 result. ``torch.matmul`` on bf16 tensors would
round its result to bf16, so with ``compute_dtype=torch.bfloat16`` this
port rounds the operands to bf16 and multiplies them in f32 (TF32 off):
the products of bf16 values are exact in f32, so the result is the
reference's. The casts' gradients round the backward to bf16 at the same
places as the reference's. The reference's row-chunked remat exists for a
16 GB chip and is not needed on the H100 at the fine step's 131,072 rows.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

MLPParams = Dict[str, torch.Tensor]


def mlp_dtype_from_cfg(cfg):
    """Compute dtype of the head matmuls from ``system.compute_dtype``:
    ``torch.bfloat16`` (default) or None for plain f32."""
    val = str(cfg.system.get("compute_dtype") or "bfloat16")
    return torch.bfloat16 if val == "bfloat16" else None


def init_mlp(
    generator: torch.Generator, dims: Sequence[int], device="cpu",
    zero_final_bias: bool = False,
) -> MLPParams:
    """``dims = [in, hidden..., out]``; weights and biases
    ``U(-1/sqrt(fan_in), 1/sqrt(fan_in))`` like ``torch.nn.Linear``, the
    last bias zero with ``zero_final_bias``. Draws on ``generator``'s
    device, then moves to ``device``."""
    params: MLPParams = {}
    n = len(dims) - 1
    gdev = generator.device
    for i in range(n):
        bound = 1.0 / float(dims[i]) ** 0.5

        def uniform(shape):
            u = torch.rand(shape, generator=generator, device=gdev)
            return (u * (2 * bound) - bound).to(device)

        params[f"w{i}"] = uniform((dims[i], dims[i + 1]))
        params[f"b{i}"] = (torch.zeros((dims[i + 1],), device=device)
                           if zero_final_bias and i == n - 1
                           else uniform((dims[i + 1],)))
    return params


def n_layers(params: MLPParams) -> int:
    return sum(1 for k in params if k.startswith("w"))


def _round(t: torch.Tensor, dtype) -> torch.Tensor:
    return t if dtype is None else t.to(dtype).to(torch.float32)


def apply_mlp(
    params: MLPParams,
    x: torch.Tensor,
    compute_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """ReLU MLP (no final activation); optional bf16 operands."""
    L = n_layers(params)
    out_dtype = x.dtype
    x = _round(x, compute_dtype)
    for i in range(L):
        w = _round(params[f"w{i}"], compute_dtype)
        b = _round(params[f"b{i}"], compute_dtype)
        x = torch.matmul(x.to(torch.float32), w) + b
        if i < L - 1:
            x = _round(torch.relu(x), compute_dtype)
    return x.to(out_dtype)
