"""Quality metrics: PSNR, mipnerf-style SSIM, LPIPS, the emission-mask IoU
and the DTU Chamfer-distance protocol.

Port of ``esrnerf_tpu/utils/metrics.py``. Meshes are plain ``(vertices,
faces)`` numpy arrays. LPIPS resolves its scorer in the JAX package's
order (a TorchScript bundle, the ``lpips`` package, then the deterministic
random-feature fallback) and runs on the CPU. ``DTU_CD`` takes its
KD-trees from scipy, not sklearn.
"""

from __future__ import annotations

import warnings
from typing import Tuple

import numpy as np
import torch

__LPIPS__ = {}


def loss2psnr(loss: float) -> float:
    return float(-10.0 * np.log10(loss))


def rgb_ssim(
    img0,
    img1,
    max_val,
    filter_size: int = 11,
    filter_sigma: float = 1.5,
    k1: float = 0.01,
    k2: float = 0.03,
    return_map: bool = False,
):
    """SSIM as defined by google/mipnerf (third-party public code; the
    reference's ``utils2/metric.py:31-88`` is itself labeled "Modified from
    google/mipnerf"). Kept formula-identical so metrics are comparable
    bit-for-bit across frameworks."""
    import scipy.signal

    img0 = np.asarray(img0, dtype=np.float64)
    img1 = np.asarray(img1, dtype=np.float64)
    assert img0.ndim == 3 and img0.shape[-1] == 3 and img0.shape == img1.shape

    hw = filter_size // 2
    shift = (2 * hw - filter_size + 1) / 2
    f_i = ((np.arange(filter_size) - hw + shift) / filter_sigma) ** 2
    filt = np.exp(-0.5 * f_i)
    filt /= np.sum(filt)

    def convolve2d(z, f):
        return scipy.signal.convolve2d(z, f, mode="valid")

    def filt_fn(z):
        return np.stack(
            [
                convolve2d(convolve2d(z[..., i], filt[:, None]), filt[None, :])
                for i in range(z.shape[-1])
            ],
            -1,
        )

    mu0 = filt_fn(img0)
    mu1 = filt_fn(img1)
    mu00 = mu0 * mu0
    mu11 = mu1 * mu1
    mu01 = mu0 * mu1
    sigma00 = filt_fn(img0**2) - mu00
    sigma11 = filt_fn(img1**2) - mu11
    sigma01 = filt_fn(img0 * img1) - mu01

    sigma00 = np.maximum(0.0, sigma00)
    sigma11 = np.maximum(0.0, sigma11)
    sigma01 = np.sign(sigma01) * np.minimum(
        np.sqrt(sigma00 * sigma11), np.abs(sigma01)
    )
    c1 = (k1 * max_val) ** 2
    c2 = (k2 * max_val) ** 2
    numer = (2 * mu01 + c1) * (2 * sigma01 + c2)
    denom = (mu00 + mu11 + c1) * (sigma00 + sigma11 + c2)
    ssim_map = numer / denom
    return ssim_map if return_map else float(np.mean(ssim_map))


def _load_lpips(net_name: str):
    """Resolve an LPIPS scorer, in priority order:

    1. ``LPIPS_WEIGHTS`` env var (or ``LPIPS_WEIGHTS_<NET>`` for per-net
       files): path to a self-contained TorchScript module taking two
       ``[1,3,H,W]`` tensors in [-1, 1] and returning the scalar distance —
       the fully offline option (neither torchvision backbones nor the
       lpips package's weights need a download).
    2. ``assets/lpips_<net>.pt`` at the repo root — the default drop
       location of ``scripts/make_lpips_bundle.py``.
    3. The ``lpips`` package with its bundled pretrained weights.
    4. The deterministic random-feature fallback
       (``utils/lpips_fallback.py``) — finite, reproducible, but
       uncalibrated; a one-time warning states the provenance. Set
       ``ESRNERF_LPIPS_FALLBACK=0`` to restore the old NaN behavior.
    """
    import os

    assets = os.environ.get("ESRNERF_ASSETS") or os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))),
        "assets",
    )
    default = os.path.join(assets, f"lpips_{net_name}.pt")
    path = (
        os.environ.get(f"LPIPS_WEIGHTS_{net_name.upper()}")
        or os.environ.get("LPIPS_WEIGHTS")
        or (default if os.path.exists(default) else None)
    )
    if path:
        try:
            mod = torch.jit.load(path, map_location="cpu").eval()

            def scripted(gt, im, normalize=True):
                if normalize:  # [0,1] -> [-1,1] (lpips package convention)
                    gt, im = 2 * gt - 1, 2 * im - 1
                return mod(gt[None], im[None]).reshape(())

            return scripted
        except Exception as e:  # noqa: BLE001
            warnings.warn(f"LPIPS_WEIGHTS={path} failed to load ({e!r})")
    try:
        import lpips  # type: ignore

        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            return lpips.LPIPS(net=net_name, version="0.1").eval()
    except Exception as e:  # pragma: no cover - environment dependent
        if os.environ.get("ESRNERF_LPIPS_FALLBACK", "1") != "0":
            from esrnerf_tpu_torch.utils.lpips_fallback import RandLPIPS

            warnings.warn(
                f"calibrated LPIPS unavailable ({e!r}); using the "
                f"{RandLPIPS.provenance}."
            )
            return RandLPIPS()
        warnings.warn(
            f"LPIPS unavailable ({e!r}); reporting NaN. Provide a "
            "TorchScript bundle via LPIPS_WEIGHTS=<path> for offline use."
        )
        return None


def rgb_lpips(np_gt: np.ndarray, np_im: np.ndarray, net_name: str = "alex",
              device: str = "cpu") -> float:
    """LPIPS perceptual distance via torch-cpu. Needs pretrained weights
    (``LPIPS_WEIGHTS`` TorchScript bundle or the lpips package); returns NaN
    (once-warned) when neither can be loaded.
    """
    key = net_name
    if key not in __LPIPS__:
        __LPIPS__[key] = _load_lpips(net_name)
    model = __LPIPS__[key]
    if model is None:
        return float("nan")
    gt = torch.from_numpy(np.ascontiguousarray(np_gt)).permute(2, 0, 1).float()
    im = torch.from_numpy(np.ascontiguousarray(np_im)).permute(2, 0, 1).float()
    with torch.no_grad():
        return float(model(gt, im, normalize=True).item())


def IoU(mask1: np.ndarray, mask2: np.ndarray) -> Tuple[float, int, int]:
    """``(iou, intersection, union)`` of two boolean masks (the union
    counts at least 1)."""
    m1 = np.asarray(mask1, dtype=bool)
    m2 = np.asarray(mask2, dtype=bool)
    inter = int((m1 & m2).sum())
    union = max(1, int((m1 | m2).sum()))
    return inter / union, inter, union


def _sample_tri_batch(n1, n2, v1, v2, tri_vert0, thresh):
    """Vectorized per-triangle barycentric grid sampling
    (replaces the reference's mp.Pool over ``sample_single_tri``)."""
    pts = []
    # group triangles by (n1, n2) so each group is one vectorized mgrid op
    key = n1 * 100000 + n2
    order = np.argsort(key)
    key_sorted = key[order]
    bounds = np.searchsorted(key_sorted, np.unique(key_sorted))
    bounds = list(bounds) + [len(key_sorted)]
    for a, b in zip(bounds[:-1], bounds[1:]):
        idx = order[a:b]
        _n1, _n2 = int(n1[idx[0]]), int(n2[idx[0]])
        c = np.mgrid[: _n1 + 1, : _n2 + 1].astype(np.float64)
        c += 0.5
        c[0] /= max(_n1, 1e-7)
        c[1] /= max(_n2, 1e-7)
        c = np.transpose(c, (1, 2, 0)).reshape(-1, 2)
        k = c[c.sum(axis=-1) < 1]  # [m, 2]
        if len(k) == 0:
            continue
        q = (
            v1[idx][:, None, :] * k[None, :, :1]
            + v2[idx][:, None, :] * k[None, :, 1:]
            + tri_vert0[idx][:, None, :]
        )
        pts.append(q.reshape(-1, 3))
    return pts


def radius_downsample_mask(pts: np.ndarray, thresh: float,
                           window: int = 1 << 16,
                           budget: int = 1 << 12) -> np.ndarray:
    """Keep mask of the Chamfer protocol's downsampling: walk ``pts`` in
    order; a point still kept drops every other point within ``thresh``
    (distance <= ``thresh``).

    The balls come from a KD-tree in threaded batches: the next points
    still kept (looking at most ``window`` points ahead), as many as keep
    about ``budget`` indices in flight by the ball sizes seen so far and
    at most twice as many as the last batch used. A point of a batch that
    an earlier one drops skips its ball, so the mask
    is the one-ball-at-a-time walk's bit for bit; a scene whose balls hold
    a large share of the points asks for few balls, one whose balls are
    small (a real scan in millimetres) asks for them in large batches."""
    from scipy.spatial import cKDTree

    tree = cKDTree(pts)
    n = pts.shape[0]
    mask = np.ones(n, dtype=np.bool_)
    s, q = 0, 1
    while s < n:
        cand = s + np.flatnonzero(mask[s:s + window])
        if cand.size == 0:
            s += window
            continue
        idx = cand[:q]
        # threads pay off only on large batches (each call starts its own)
        balls = tree.query_ball_point(pts[idx], r=thresh,
                                      workers=-1 if idx.size >= 256 else 1)
        hits = used = 0
        for curr, ball in zip(idx, balls):
            hits += len(ball)
            if mask[curr]:
                used += 1
                mask[ball] = 0
                mask[curr] = 1
        s = int(idx[-1]) + 1
        # at most twice the balls the last batch used: where balls are
        # large, most of a batch's later points fall in its earlier balls
        q = int(np.clip(min(budget * idx.size // max(hits, 1), 2 * used),
                        1, window))
    return mask


def DTU_CD(
    vertices: np.ndarray,
    faces: np.ndarray,
    ObsMask: np.ndarray,
    BB: np.ndarray,
    Res: np.ndarray,
    stl: np.ndarray,
    ground_plane: np.ndarray,
    max_dist: float = 20.0,
    patch: int = 60,
    thresh: float = 0.2,
) -> Tuple[float, float, float]:
    """Full DTU Chamfer protocol (reference ``metric.py:113-256``):
    mesh→pcd surface sampling, KD-tree radius downsample, ObsMask +
    ground-plane filtering, then symmetric nearest-neighbor means.

    The downsampling keeps the reference's rule (walk the shuffled points
    in order; a point still kept drops every other point within
    ``thresh``) but asks a KD-tree (scipy's ``cKDTree``; both it and
    sklearn's include points at exactly ``thresh``) for balls in bounded
    batches, and only for points still kept when a batch starts
    (:func:`radius_downsample_mask`): the same mask as querying every ball
    up front, which on a dense mesh returns 10^8 indices or more.

    Returns (mean_d2s, mean_s2d, overall).
    """
    from scipy.spatial import cKDTree

    tri_vert = vertices[faces]
    v1 = tri_vert[:, 1] - tri_vert[:, 0]
    v2 = tri_vert[:, 2] - tri_vert[:, 0]
    l1 = np.linalg.norm(v1, axis=-1, keepdims=True)
    l2 = np.linalg.norm(v2, axis=-1, keepdims=True)
    area2 = np.linalg.norm(np.cross(v1, v2), axis=-1, keepdims=True)
    nz = (area2 > 0)[:, 0]
    l1, l2, area2, v1, v2, tv0 = (
        l1[nz], l2[nz], area2[nz], v1[nz], v2[nz], tri_vert[nz, 0],
    )
    thr = thresh * np.sqrt(l1 * l2 / area2)
    n1 = np.floor(l1[:, 0] / thr[:, 0]).astype(np.int64)
    n2 = np.floor(l2[:, 0] / thr[:, 0]).astype(np.int64)

    new_pts = _sample_tri_batch(n1, n2, v1, v2, tv0, thresh)
    data_pcd = np.concatenate([vertices] + new_pts, axis=0).astype(np.float64)

    rng = np.random.default_rng(0)
    rng.shuffle(data_pcd, axis=0)

    data_down = data_pcd[radius_downsample_mask(data_pcd, thresh)]

    BB = BB.astype(np.float32)
    inbound = (
        (data_down >= BB[:1] - patch) & (data_down < BB[1:] + patch * 2)
    ).sum(axis=-1) == 3
    data_in = data_down[inbound]

    data_grid = np.around((data_in - BB[:1]) / Res).astype(np.int32)
    grid_inbound = (
        (data_grid >= 0) & (data_grid < np.expand_dims(ObsMask.shape, 0))
    ).sum(axis=-1) == 3
    data_grid_in = data_grid[grid_inbound]
    in_obs = ObsMask[
        data_grid_in[:, 0], data_grid_in[:, 1], data_grid_in[:, 2]
    ].astype(np.bool_)
    data_in_obs = data_in[grid_inbound][in_obs]

    dist_d2s, _ = cKDTree(stl).query(data_in_obs, k=1)
    mean_d2s = float(dist_d2s[dist_d2s < max_dist].mean())

    stl_hom = np.concatenate([stl, np.ones_like(stl[:, :1])], -1)
    above = (ground_plane.reshape((1, 4)) * stl_hom).sum(-1) > 0
    stl_above = stl[above]

    dist_s2d, _ = cKDTree(data_in).query(stl_above, k=1)
    mean_s2d = float(dist_s2d[dist_s2d < max_dist].mean())

    return mean_d2s, mean_s2d, (mean_d2s + mean_s2d) / 2
