"""ESR-NeRF blender-style dataset loader.

Port of ``esrnerf_tpu/data/esrnerf.py`` (numpy): ``transforms_{phase}.json``
with per-frame light modes; ``test_nv`` also loads the emission-area masks
and the HDR EXRs, the relighting phases (``test_nvc``, ``test_nvi``,
``test_nvic``) each light's edit mask and its edit colour (hue,
saturation) and/or intensity; rays derive from the poses through the
blender -> OpenCV flip; RGBA is composited over a white or black
background; the train phase flattens all images into one ray pool. The
arrays equal the JAX loader's.

PNGs are read with :mod:`esrnerf_tpu_torch.utils.png` and EXRs with
:mod:`esrnerf_tpu_torch.utils.exr`, and a ``data.resize`` that changes the
image size resamples with :mod:`esrnerf_tpu_torch.data.resample` (PIL's
Lanczos for images and masks, OpenCV's Lanczos-4 for HDRs, as the JAX
loader does), so neither PIL nor OpenCV is needed.
The JAX loader also reads the relighting phases' HDR EXRs and never uses
them; this one does not read them.
"""

from __future__ import annotations

import json
import math
import os
from typing import Any, Dict, Tuple

import numpy as np

from esrnerf_tpu_torch.data import resample
from esrnerf_tpu_torch.data.base import DataClass, LightDict
from esrnerf_tpu_torch.utils import exr, png

# blender cam (+x right, +y up, -z forward) -> opencv (+x right, -y up, +z fwd)
BLENDER2OPENCV = np.array(
    [[1, 0, 0, 0], [0, -1, 0, 0], [0, 0, -1, 0], [0, 0, 0, 1]], dtype=np.float32
)
PHASES = ("train", "test_nv", "test_nvc", "test_nvi", "test_nvic")


def _imread_float(path: str) -> np.ndarray:
    return png.read(path).astype(np.float32) / 255.0


def _imresize(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """PIL's Lanczos resize of a [0, 1] image through uint8, as the JAX
    loader (:func:`~esrnerf_tpu_torch.data.resample.lanczos_pil`); at the
    image's own size that is the identity (every uint8 level survives ``x /
    255 * 255``), so the input comes back."""
    if (img.shape[1], img.shape[0]) == tuple(size):
        return img
    u8 = (np.clip(img, 0, 1) * 255).astype(np.uint8)
    return resample.lanczos_pil(u8, size).astype(np.float32) / 255.0


def _hdr_resize(hdr: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """OpenCV's Lanczos-4 resize of an HDR, as the JAX loader
    (:func:`~esrnerf_tpu_torch.data.resample.lanczos4_cv2`)."""
    return resample.lanczos4_cv2(hdr, size)


class ESRNeRF(DataClass):
    def __init__(self, cfg, phase: str):
        if phase not in PHASES:
            raise ValueError(f"unknown phase '{phase}' (one of {PHASES})")
        super().__init__(cfg, phase)
        tpath = os.path.join(
            self.root, str(self.scene), "transforms", f"transforms_{phase}.json"
        )
        with open(tpath, "r") as f:
            self.infos = json.load(f)

        sample = self.seek(0)
        h, w = sample["image"].shape[:2]
        self.width, self.height = w, h
        if self.resize:
            self.width = int(self.width * self.resize)
            self.height = int(self.height * self.resize)
        self._resample = (self.width, self.height) != (w, h)
        self.flen = (
            self.width / 2.0 / math.tan(float(self.infos["camera_angle_x"]) / 2.0)
        )

        # pixel-center camera-space directions
        i, j = np.meshgrid(
            np.arange(self.width, dtype=np.float32),
            np.arange(self.height, dtype=np.float32),
            indexing="xy",
        )
        i, j = i + 0.5, j + 0.5
        self.pixelcoord = np.stack(
            [
                (i - self.width * 0.5) / self.flen,
                (j - self.height * 0.5) / self.flen,
                np.ones_like(i),
            ],
            axis=-1,
        ).astype(np.float32)

        self.cache: Dict[str, np.ndarray] = {}
        self.preprocess()

    # ----------------------------------------------------------- properties

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
        return 2.0, 6.0

    @property
    def scale_mat(self) -> np.ndarray:
        return np.eye(4, dtype=np.float32)

    def __len__(self) -> int:
        return len(self.cache["rgbs"])

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        return {k: v[index] for k, v in self.cache.items()}

    # ------------------------------------------------------------------- io

    def seek(self, index: int) -> Dict[str, Any]:
        frame = self.infos["frames"][index]
        scene_dir = os.path.join(self.root, str(self.scene))
        dname, fname = frame["file_path"].split("/")
        sample: Dict[str, Any] = {
            "pose": np.asarray(frame["transform_matrix"], dtype=np.float32),
            "image": _imread_float(os.path.join(scene_dir, dname, fname + ".png")),
            "em_mode": [light["mode"] for light in frame["lights"]],
        }
        if self.phase == "test_nv":
            sample["area"] = _imread_float(
                os.path.join(scene_dir, dname, "emission", fname + ".png")
            )
            sample["hdr"] = exr.imread(
                os.path.join(scene_dir, dname, "exr", fname + ".exr")
            )[..., :3].astype(np.float32)
        if self.phase not in ("train", "test_nv"):
            sample["em_mask"] = [
                _imread_float(os.path.join(scene_dir,
                                           light["mask_path"] + ".png"))
                for light in frame["lights"]
            ]
            sample["em_color"] = [light["color"] for light in frame["lights"]]
            sample["em_intensity"] = [
                light["intensity"] for light in frame["lights"]
            ]
        return sample

    # ----------------------------------------------------------- preprocess

    def preprocess(self) -> None:
        cache: Dict[str, list] = {
            "poses": [], "rays_o": [], "rays_d": [], "viewdirs": [],
            "rgbs": [], "em_modes": [],
        }
        if self.phase == "test_nv":
            cache["areas"] = []
            cache["hdrs"] = []
        if self.phase in ("test_nvi", "test_nvic"):
            cache["em_masks"] = []
            cache["em_intensities"] = []
        if self.phase in ("test_nvc", "test_nvic"):
            cache["em_masks"] = []
            cache["em_colors"] = []

        wh = (self.width, self.height)
        n_px = self.width * self.height
        for idx in range(len(self.infos["frames"])):
            s = self.seek(idx)
            cache["poses"].append(s["pose"])

            img = s["image"]
            if self._resample:
                img = _imresize(img, wh)
            cache["rgbs"].append(img.reshape(n_px, -1))

            if self.phase == "train":
                mode = np.full(n_px, LightDict[s["em_mode"][0]], dtype=np.int64)
                cache["em_modes"].append(mode)
            else:
                cache["em_modes"].append(
                    np.asarray([LightDict[m] for m in s["em_mode"]], dtype=np.int64)
                )
                if self.phase == "test_nv":
                    area = s["area"]
                    if self._resample:
                        area = _imresize(area, wh)
                    cache["areas"].append((area[..., 0] > 0.5).reshape(-1))
                    hdr = s["hdr"]
                    if self._resample:
                        hdr = _hdr_resize(hdr, wh)
                    cache["hdrs"].append(hdr.reshape(n_px, -1))
                else:
                    masks = s["em_mask"]
                    if self._resample:
                        masks = [_imresize(m, wh) for m in masks]
                    cache["em_masks"].append(
                        np.stack([m[..., 0].reshape(-1) for m in masks], 0))
                    if self.phase in ("test_nvc", "test_nvic"):
                        cache["em_colors"].append(
                            np.asarray(s["em_color"], dtype=np.float32))
                    if self.phase in ("test_nvi", "test_nvic"):
                        cache["em_intensities"].append(
                            np.asarray(s["em_intensity"], dtype=np.float32))

        out = {k: np.stack(v, axis=0) for k, v in cache.items() if len(v) > 0}

        mask = out["rgbs"][..., -1:]
        out["rgbs"] = out["rgbs"][..., :3] * mask + (1 - mask) * self.white_bg
        out["rays_o"], out["rays_d"] = self.pose2ray(out["poses"])
        out["viewdirs"] = out["rays_d"] / np.linalg.norm(
            out["rays_d"], axis=-1, keepdims=True
        )
        if self.phase == "test_nv":
            out["hdrs"] = out["hdrs"][..., :3] * mask + (1 - mask) * self.white_bg

        if self.phase == "train":
            for k in ("rgbs", "rays_o", "rays_d", "viewdirs"):
                out[k] = out[k].reshape(-1, 3)
            out["em_modes"] = out["em_modes"].reshape(-1)

        self.cache = {k: np.ascontiguousarray(v) for k, v in out.items()}

    def pose2ray(self, poses: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        _pose = poses @ BLENDER2OPENCV
        pix = self.pixelcoord.reshape(-1, 3)
        rays_o = np.broadcast_to(
            _pose[..., None, :3, -1], (*_pose.shape[:-2], len(pix), 3)
        ).astype(np.float32)
        rays_d = (pix[None, :, None, :] * _pose[:, None, :3, :3]).sum(-1)
        return np.ascontiguousarray(rays_o), rays_d.astype(np.float32)
