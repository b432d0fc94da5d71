"""The benchmark's one traffic generator: it reads a mix's parameters
(``benchmark/traffic/<name>.json``) and makes its inputs from the seed.

``kind: train`` -- a ray pool for the stage's sampler, drawn on the
device: origins uniform on a sphere of ``origin_radius`` around the scene,
each ray aimed at a point drawn from ``N(0, target_std)`` (the ball at the
centre), an emission mode ``on`` with probability ``em_on_share``, and a
target colour uniform in ``[0, 1]``. The pool holds ``pool_rays`` rays.

``kind: render`` -- ``n_views`` pinhole cameras of ``width x height``
pixels and a vertical field of view of ``fov_deg``, at ``radius`` from the
centre, looking at it: azimuths evenly spaced around the scene, elevations
stepping through ``elevation_deg`` (three levels), the same set for every
seed. The seed draws their order and each view's emission mode.

The same seed gives the same inputs; every seed gives the same sizes.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np


def train_pool(traffic: dict, seed: int, device) -> Dict[str, np.ndarray]:
    """The pool, drawn on ``device`` by a generator seeded with ``seed`` in
    a few large calls, on the host."""
    import torch

    gen = torch.Generator(device=device).manual_seed(int(seed))
    n = int(traffic["pool_rays"])
    o = torch.randn((n, 3), generator=gen, device=device)
    o *= float(traffic["origin_radius"]) / torch.linalg.vector_norm(
        o, dim=-1, keepdim=True)
    d = torch.randn((n, 3), generator=gen, device=device)
    d = d * float(traffic["target_std"]) - o
    u = torch.rand((n, 4), generator=gen, device=device)
    pool = {"rays_o": o, "rays_d": d,
            "viewdirs": d / torch.linalg.vector_norm(d, dim=-1, keepdim=True),
            "em_modes": (u[:, 0] < float(traffic["em_on_share"])).long(),
            "rgbs": u[:, 1:]}
    return {k: v.cpu().numpy() for k, v in pool.items()}


def render_views(traffic: dict, seed: int) -> List[dict]:
    rng = np.random.default_rng(int(seed))
    W, H = int(traffic["width"]), int(traffic["height"])
    f = 0.5 * H / math.tan(math.radians(float(traffic["fov_deg"])) / 2)
    u, v = np.meshgrid(np.arange(W, dtype=np.float32) + 0.5,
                       np.arange(H, dtype=np.float32) + 0.5)
    cam = np.stack([(u - W / 2) / f, -(v - H / 2) / f,
                    -np.ones_like(u)], -1).reshape(-1, 3)
    lo, hi = (math.radians(x) for x in traffic["elevation_deg"])
    n = int(traffic["n_views"])
    views = []
    for k in rng.permutation(n):
        az = 2 * math.pi * k / n
        el = lo + (hi - lo) * (k % 3) / 2
        z = np.array([math.cos(el) * math.cos(az), math.cos(el) * math.sin(az),
                      math.sin(el)])
        pos = float(traffic["radius"]) * z
        x = np.cross([0.0, 0.0, 1.0], z)
        x /= np.linalg.norm(x)
        y = np.cross(z, x)
        rot = np.stack([x, y, z], 1).astype(np.float32)  # camera -> world
        d = (cam @ rot.T).astype(np.float32)
        views.append({
            "rays_o": np.broadcast_to(pos.astype(np.float32), d.shape).copy(),
            "rays_d": d,
            "viewdirs": (d / np.linalg.norm(d, axis=-1, keepdims=True)
                         ).astype(np.float32),
            "em_mode": int(rng.integers(0, 2)), "pose": rot})
    return views
