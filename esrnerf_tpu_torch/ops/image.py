"""Image-space ops. Port of ``esrnerf_tpu/ops/image.py``: the exact sRGB
OETF/EOTF pair, PSNR from MSE, float -> uint8 images, and the RGB <-> HSV
pair of the relighting fine-tune's colour edits."""

from __future__ import annotations

import math

import numpy as np
import torch


def apply_gamma_curve(image: torch.Tensor) -> torch.Tensor:
    """Linear -> sRGB (exact piecewise OETF)."""
    low = 12.92 * image
    # clamp the argument so the unused pow branch stays finite for autograd
    high = 1.055 * torch.pow(torch.clamp(image, min=1e-12), 1.0 / 2.4) - 0.055
    return torch.where(image <= 0.0031308, low, high)


def remove_gamma_curve(image: torch.Tensor) -> torch.Tensor:
    """sRGB -> linear (exact piecewise EOTF)."""
    low = image / 12.92
    high = torch.pow(torch.clamp((image + 0.055) / 1.055, min=1e-12), 2.4)
    return torch.where(image < 0.04045, low, high)


def mse2psnr(mse) -> torch.Tensor:
    """``-10 log10(mse)``, as ``-10 ln(mse) / ln(10)``."""
    return -10.0 * torch.log(torch.as_tensor(mse)) / math.log(10.0)


def tensor2img(x) -> np.ndarray:
    """0~1 float (array or tensor) -> 0~255 uint8, truncating."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return (255 * np.clip(np.asarray(x), 0, 1)).astype(np.uint8)


def rgb_to_hsv(rgb: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Kornia-style RGB -> HSV with h in [0, 1). Hue ties go to the first
    maximal channel; ``%`` is floor-mod (``torch.remainder``)."""
    max_rgb, argmax_rgb = rgb.max(-1)
    min_rgb = rgb.min(-1).values
    deltac = max_rgb - min_rgb

    v = max_rgb
    s = deltac / (max_rgb + eps)

    deltac_safe = torch.where(deltac == 0, torch.ones_like(deltac), deltac)
    diff = max_rgb[..., None] - rgb
    rc, gc, bc = diff[..., 0], diff[..., 1], diff[..., 2]

    h1 = bc - gc
    h2 = (rc - bc) + 2.0 * deltac_safe
    h3 = (gc - rc) + 4.0 * deltac_safe
    h = torch.stack([h1, h2, h3], dim=-1) / deltac_safe[..., None]
    h = torch.gather(h, -1, argmax_rgb[..., None])[..., 0]
    h = torch.remainder(h / 6.0, 1.0)
    return torch.stack([h, s, v], dim=-1)


def hsv_to_rgb(hsv: torch.Tensor) -> torch.Tensor:
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    hi = torch.remainder(torch.floor(h * 6), 6)
    f = torch.remainder(h * 6, 6) - hi
    p = v * (1.0 - s)
    q = v * (1.0 - f * s)
    t = v * (1.0 - (1.0 - f) * s)

    hi = hi.to(torch.int64)
    indices = torch.stack([hi, hi + 6, hi + 12], dim=-1)
    table = torch.stack(
        [v, q, p, p, t, v, t, v, v, q, p, p, p, p, t, v, v, q], dim=-1)
    return torch.gather(table, -1, indices)
