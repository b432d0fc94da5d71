"""Sin/cos positional encodings. Port of ``esrnerf_tpu/ops/encoding.py``
(the reference's ``voxurfc.py:119-123,225-235`` embedding)."""

from __future__ import annotations

import torch


def freqs(n: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """``[2^0, 2^1, ..., 2^(n-1)]``."""
    return torch.tensor([2.0**i for i in range(n)], dtype=dtype,
                        device=device)


def posenc(x: torch.Tensor, n_freqs: int,
           include_input: bool = True) -> torch.Tensor:
    """``[x, sin(x * 2^i)..., cos(x * 2^i)...]`` over the last axis, with
    ``emb = x[..., None] * freq`` flattened (``d * n_freqs`` wide); output
    width :func:`posenc_dim`."""
    if n_freqs == 0:
        return x if include_input else x[..., :0]
    emb = (x[..., None] * freqs(n_freqs, x.dtype, x.device)).reshape(
        *x.shape[:-1], -1)
    parts = ([x] if include_input else []) + [torch.sin(emb), torch.cos(emb)]
    return torch.cat(parts, dim=-1)


def posenc_dim(d: int, n_freqs: int, include_input: bool = True) -> int:
    return d * ((1 if include_input else 0) + 2 * n_freqs)
