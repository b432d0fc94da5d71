"""Image-space ops. Port of ``esrnerf_tpu/ops/image.py::apply_gamma_curve``."""

from __future__ import annotations

import torch


def apply_gamma_curve(image: torch.Tensor) -> torch.Tensor:
    """Linear -> sRGB (exact piecewise OETF)."""
    low = 12.92 * image
    # clamp the argument so the unused pow branch stays finite for autograd
    high = 1.055 * torch.pow(torch.clamp(image, min=1e-12), 1.0 / 2.4) - 0.055
    return torch.where(image <= 0.0031308, low, high)
