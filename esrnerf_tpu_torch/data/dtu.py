"""DTU multi-view stereo dataset loader.

Port of ``esrnerf_tpu/data/dtu.py`` (numpy): camera K, R and centre from
the projection matrices of ``cameras_sphere.npz``; masks composited over
the background; near/far from the maximum camera-pair distance; the
ObsMask/Plane MAT files and the STL point cloud loaded for the Chamfer
distance eval. DTU has no split, so every phase loads every view. The
arrays equal the JAX loader's (poses and rays to within a float32 ulp).

The JAX loader reads the PNGs with PIL and decomposes the cameras with
OpenCV; this one reads the PNGs with :mod:`esrnerf_tpu_torch.utils.png`
and decomposes the cameras in numpy and scipy (:func:`load_K_Rt_from_P`),
so neither PIL nor OpenCV is needed; ``data.resize`` resamples with PIL's
Lanczos as the JAX loader, reproduced by
:mod:`esrnerf_tpu_torch.data.resample`.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from glob import glob
from typing import Any, Dict, Tuple

import numpy as np

from esrnerf_tpu_torch.data.base import DataClass, LightDict
from esrnerf_tpu_torch.data.esrnerf import _imread_float as _imread
from esrnerf_tpu_torch.data.esrnerf import _imresize


def load_K_Rt_from_P(P: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """IDR-style decomposition of a 3x4 projection matrix into
    ``(intrinsics [4, 4] f64, camera-to-world pose [4, 4] f32)``, as
    ``cv2.decomposeProjectionMatrix`` followed by ``K / K[2, 2]``.

    ``P[:, :3] = K R`` by an RQ decomposition in float64, with OpenCV's
    signs: ``R`` a proper rotation, ``K[0, 0]`` and ``K[1, 1]`` positive, so
    ``K[2, 2]`` takes the sign of ``det P[:, :3]`` (and a negative one flips
    the whole of the normalised K). The camera centre ``c`` solves ``P [c;
    1] = 0``."""
    import scipy.linalg

    P = np.asarray(P, np.float64)
    M = P[:, :3]
    K, R = scipy.linalg.rq(M)
    s = np.where(np.diag(K) < 0, -1.0, 1.0)
    s[2] = s[0] * s[1] * np.sign(np.linalg.det(R))
    K, R = K * s[None, :], s[:, None] * R  # K R unchanged: s * s = 1
    K = K / K[2, 2]
    intrinsics = np.eye(4)
    intrinsics[:3, :3] = K
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = R.transpose()
    pose[:3, 3] = -np.linalg.solve(M, P[:, 3])
    return intrinsics, pose


class DTU(DataClass):
    def __init__(self, cfg, phase: str):
        super().__init__(cfg, phase)
        self.basedir = os.path.join(self.root, f"dtu_scan{self.scene}")
        with np.load(os.path.join(self.basedir, "cameras_sphere.npz")) as f:
            self.camera_dict = dict(f)  # read by the loader's threads
        self.rgb_paths = sorted(glob(os.path.join(self.basedir, "image",
                                                  "*.png")))
        self.mask_paths = sorted(glob(os.path.join(self.basedir, "mask",
                                                   "*png")))

        sample = self.seek(0)
        h, w = sample["image"].shape[:2]
        self.width, self.height = w, h
        P = (sample["world_mat"] @ sample["scale_mat"])[:3, :4]
        intrinsics, _ = load_K_Rt_from_P(P)
        self.flen = float(intrinsics[0, 0])
        self.K = intrinsics
        self._scale_mat = sample["scale_mat"].astype(np.float32)

        if self.resize:
            self.width = int(self.width * self.resize)
            self.height = int(self.height * self.resize)
            self.flen *= self.resize
            self.K[:2] *= self.resize

        # DTU Chamfer evaluation assets (ObsMask/Plane .mat + STL pcd)
        self._pcd_info = None
        try:
            from scipy.io import loadmat

            from esrnerf_tpu_torch.utils.mesh import load_ply

            obs = loadmat(f"{self.root}/ObsMask/ObsMask{self.scene}_10.mat")
            ObsMask, BB, Res = obs["ObsMask"], obs["BB"], obs["Res"]
            stl, _ = load_ply(
                f"{self.root}/Points/stl/stl{int(self.scene):03}_total.ply")
            plane = loadmat(f"{self.root}/ObsMask/Plane{self.scene}.mat")["P"]
            self._pcd_info = (ObsMask, BB, Res, stl, plane)
        except (FileNotFoundError, OSError) as e:
            print(f"DTU Chamfer assets unavailable ({e}); mesh CD disabled")

        i, j = np.meshgrid(
            np.arange(self.width, dtype=np.float32),
            np.arange(self.height, dtype=np.float32),
            indexing="xy",
        )
        i, j = i + 0.5, j + 0.5
        self.pixelcoord = np.stack(
            [
                (i - self.K[0][2]) / self.K[0][0],
                (j - self.K[1][2]) / self.K[1][1],
                np.ones_like(i),
            ],
            axis=-1,
        ).astype(np.float32)

        self.cache: Dict[str, np.ndarray] = {}
        self.preprocess()

    # ----------------------------------------------------------- properties

    @property
    def pcd(self):
        """(ObsMask, BB, Res, stl point cloud, ground plane) or None."""
        return self._pcd_info

    @property
    def image_size(self) -> Tuple[int, int]:
        return (self.width, self.height)

    @property
    def focal_length(self) -> float:
        return self.flen

    @property
    def all_data(self) -> Dict[str, np.ndarray]:
        return self.cache

    @property
    def near_far(self) -> Tuple[float, float]:
        return self.near, self.far

    @property
    def scale_mat(self) -> np.ndarray:
        return self._scale_mat

    def __len__(self) -> int:
        return len(self.cache["rgbs"])

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        return {k: v[index] for k, v in self.cache.items()}

    # ------------------------------------------------------------------- io

    def seek(self, index: int) -> Dict[str, Any]:
        return {
            "world_mat": self.camera_dict[f"world_mat_{index}"].astype(
                np.float32),
            "scale_mat": self.camera_dict[f"scale_mat_{index}"].astype(
                np.float32),
            "image": _imread(self.rgb_paths[index]),
            "mask": _imread(self.mask_paths[index]),
        }

    # ----------------------------------------------------------- preprocess

    def preprocess(self) -> None:
        """The JAX loader's arrays, filled view by view into their final
        buffers by a pool of threads (a 49-view 1200x1200 scan holds 70.6 M
        rays; numpy, zlib and the PNG unfilter release the GIL)."""
        wh = (self.width, self.height)
        n_px = self.width * self.height
        n = len(self.rgb_paths)
        out = {"poses": np.empty((n, 4, 4), np.float32)}
        for k in ("rays_o", "rays_d", "viewdirs"):
            out[k] = np.empty((n, n_px, 3), np.float32)

        def view(i):
            s = self.seek(i)
            P = (s["world_mat"] @ s["scale_mat"])[:3, :4]
            _, pose = load_K_Rt_from_P(P)
            out["poses"][i] = pose
            out["rays_o"][i], out["rays_d"][i] = self._view_rays(pose)
            rd = out["rays_d"][i]
            out["viewdirs"][i] = rd / np.linalg.norm(rd, axis=-1,
                                                     keepdims=True)
            img, msk = s["image"], s["mask"]
            if self.resize:
                img = _imresize(img, wh)
                msk = _imresize(msk, wh)
            img = img.reshape(n_px, -1)
            msk = msk.reshape(n_px, -1)[..., :1]
            return img * msk + self.white_bg * (1 - msk)

        def rgb(i):
            out["rgbs"][i] = view(i)

        # the first view sizes the colour buffer (3 or 4 channels)
        first = view(0)
        out["rgbs"] = np.empty((n, n_px, first.shape[-1]), np.float32)
        out["rgbs"][0] = first
        with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:
            list(pool.map(rgb, range(1, n)))
        if self.phase == "train":
            out["em_modes"] = np.full((n, n_px), LightDict["off"],
                                      dtype=np.int64)
        else:
            out["em_modes"] = np.zeros((n, 1), dtype=np.int64)

        cam_o = out["poses"][:, :3, 3]
        self.far = float(np.linalg.norm(cam_o[:, None] - cam_o, axis=-1).max())
        self.near = self.far * 0.05

        if self.phase == "train":
            for k in ("rgbs", "rays_o", "rays_d", "viewdirs"):
                out[k] = out[k].reshape(-1, 3)
            out["em_modes"] = out["em_modes"].reshape(-1)
        else:
            out["hdrs"] = out["rgbs"]

        self.cache = {k: np.ascontiguousarray(v) for k, v in out.items()}

    def _view_rays(self, pose: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """One view's ``(rays_o, rays_d) [H*W, 3]`` f32: the products and
        sums of the JAX loader's ``pose2ray``, per view."""
        pix = self.pixelcoord.reshape(-1, 3)
        rays_d = (pix[:, None, :] * pose[None, :3, :3]).sum(-1)
        return np.broadcast_to(pose[:3, -1], pix.shape), rays_d
