"""Deterministic offline LPIPS fallback: AlexNet-topology random features.

Port of ``esrnerf_tpu/utils/lpips_fallback.py`` on ``F.conv2d`` and
``F.max_pool2d`` (on the CPU). When no calibrated LPIPS network can be
loaded (see ``metrics._load_lpips``), this gives a *deterministic*
perceptual distance with the same structure:

- an AlexNet-shaped 5-stage conv feature pyramid (64/192/384/256/256
  channels, same kernel sizes/strides/padding as torchvision's AlexNet
  features) with He-initialized weights drawn from a pinned
  ``numpy.random.Philox`` counter stream (the same weights as the JAX
  package's fallback, bit-stable across NumPy releases and platforms);
- unit-normalized feature differences, squared, averaged spatially,
  uniformly weighted across channels and summed over stages: the LPIPS
  formula with the calibration vector replaced by 1/C.

This is the "random network" baseline of the LPIPS paper (Zhang et al.
2018); values are NOT comparable to calibrated lpips-alex numbers and are
logged with a one-time provenance warning. A real bundle in
``assets/lpips_alex.pt`` is preferred automatically.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

# (out_ch, in_ch, ksize, stride, pad, maxpool_after) per conv stage —
# torchvision AlexNet ``features`` topology.
_STAGES = (
    (64, 3, 11, 4, 2, True),
    (192, 64, 5, 1, 2, True),
    (384, 192, 3, 1, 1, False),
    (256, 384, 3, 1, 1, False),
    (256, 256, 3, 1, 1, True),
)

# ImageNet normalization, as the lpips package's ScalingLayer applies to
# [-1, 1] inputs: (x - shift) / scale with shift/scale in [-1,1] units.
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)


@functools.lru_cache(maxsize=1)
def _weights():
    """He-init conv kernels from a pinned Philox counter stream."""
    rng = np.random.Generator(np.random.Philox(key=0x5E5F_1E37))
    ws = []
    for oc, ic, k, _s, _p, _mp in _STAGES:
        std = np.sqrt(2.0 / (ic * k * k))
        ws.append(
            (rng.standard_normal((oc, ic, k, k)) * std).astype(np.float32)
        )
    return ws


def _features(x: torch.Tensor, ws):
    x = (x - torch.as_tensor(_SHIFT).reshape(1, 3, 1, 1)) \
        / torch.as_tensor(_SCALE).reshape(1, 3, 1, 1)
    out = []
    for i, (w, (_oc, _ic, _k, s, p, mp)) in enumerate(zip(ws, _STAGES)):
        x = torch.relu(F.conv2d(x, w, stride=s, padding=p))
        out.append(x)
        if mp and i < len(_STAGES) - 1:  # the last pool feeds nothing
            x = F.max_pool2d(x, 3, 2)
    return out


@torch.no_grad()
def _distance(im0: torch.Tensor, im1: torch.Tensor) -> torch.Tensor:
    """Distance of two ``[1, 3, H, W]`` f32 images in [-1, 1]."""
    ws = [torch.as_tensor(w) for w in _weights()]
    total = torch.zeros((), dtype=torch.float32)
    for f0, f1 in zip(_features(im0, ws), _features(im1, ws)):
        n0 = f0 / torch.sqrt((f0 * f0).sum(1, keepdim=True) + 1e-10)
        n1 = f1 / torch.sqrt((f1 * f1).sum(1, keepdim=True) + 1e-10)
        d = (n0 - n1) ** 2
        # uniform calibration 1/C, spatial mean: the LPIPS formula with
        # the lin-layer weights replaced by a constant vector
        total = total + d.mean(dim=(2, 3)).mean(dim=1).sum()
    return total


def rand_lpips(gt: np.ndarray, im: np.ndarray) -> float:
    """Distance between two ``[3, H, W]`` float tensors in [-1, 1]."""
    a = np.asarray(gt, np.float32)[None]
    b = np.asarray(im, np.float32)[None]
    # AlexNet's stride-4 conv1 + three pools need >= ~17px inputs; tile
    # small probes up rather than crash (metrics tests use 8x8 images)
    h, w = a.shape[-2:]
    if h < 32 or w < 32:
        ry, rx = -(-32 // h), -(-32 // w)
        a = np.tile(a, (1, 1, ry, rx))
        b = np.tile(b, (1, 1, ry, rx))
    return float(_distance(torch.from_numpy(np.ascontiguousarray(a)),
                           torch.from_numpy(np.ascontiguousarray(b))))


class RandLPIPS:
    """Callable with the metrics scorer contract: (gt, im, normalize)."""

    provenance = (
        "deterministic random-feature LPIPS fallback (uncalibrated; "
        "commit assets/lpips_<net>.pt for the real metric)"
    )

    def __call__(self, gt, im, normalize: bool = True):
        if normalize:  # [0,1] -> [-1,1]
            gt, im = 2 * gt - 1, 2 * im - 1
        return torch.tensor(
            rand_lpips(np.asarray(gt), np.asarray(im))
        )
