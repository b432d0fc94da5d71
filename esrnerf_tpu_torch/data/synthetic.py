"""Synthetic scene generators for tests and benchmarks.

The port's copies of ``write_scene`` and ``write_dtu_scene`` from
``esrnerf_tpu/data/synthetic.py``: an emissive ball and a diffuse ball,
rendered analytically. ``write_scene`` writes a blender-convention
ESR-NeRF dataset in the file layout its loader expects
(``transforms/transforms_{phase}.json``, RGBA PNGs, emission masks, EXR
HDR, per-light edit masks); ``write_dtu_scene`` writes a DTU scan
(``cameras_sphere.npz``, image and mask PNGs, and the ObsMask, Plane and
STL assets of the Chamfer-distance eval). Both write the same pixels,
cameras and points as the JAX package's generators, through the port's
own PNG, EXR and PLY writers (and scipy for the ``.mat`` files).
"""

from __future__ import annotations

import json
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Tuple

import numpy as np

from esrnerf_tpu_torch.utils import exr, png

EMIT_RGB = np.array([1.0, 0.85, 0.4], np.float32)  # warm emissive color
EMIT_SCALE = 2.0  # HDR intensity of the emitter when on
DIFF_RGB = np.array([0.2, 0.4, 0.8], np.float32)
EMIT_CENTER = np.array([0.45, 0.0, 0.0], np.float32)
EMIT_R = 0.35
DIFF_CENTER = np.array([-0.45, 0.0, 0.0], np.float32)
DIFF_R = 0.4


def _look_at_blender(eye: np.ndarray, target: np.ndarray) -> np.ndarray:
    """camera-to-world with blender convention (-z forward, +y up)."""
    fwd = target - eye
    fwd = fwd / np.linalg.norm(fwd)
    z = -fwd
    up = np.array([0.0, 0.0, 1.0])
    if abs(np.dot(up, z)) > 0.99:
        up = np.array([0.0, 1.0, 0.0])
    x = np.cross(up, z)
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    m = np.eye(4, dtype=np.float32)
    m[:3, 0], m[:3, 1], m[:3, 2], m[:3, 3] = x, y, z, eye
    return m


def _ray_sphere(o, d, c, r) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (hit mask, t of first intersection)."""
    oc = o - c
    b = (oc * d).sum(-1)
    cc = (oc * oc).sum(-1) - r * r
    disc = b * b - cc
    hit = disc > 0
    t = -b - np.sqrt(np.maximum(disc, 0))
    hit = hit & (t > 0)
    return hit, t


def _render(pose: np.ndarray, wh: int, fov_x: float, on: bool,
            intensity: float = 1.0, color_scale=None):
    """Analytic render: returns (linear HDR rgb [H,W,3], alpha, emit_mask)."""
    f = wh / 2.0 / np.tan(fov_x / 2.0)
    i, j = np.meshgrid(np.arange(wh) + 0.5, np.arange(wh) + 0.5, indexing="xy")
    pix = np.stack([(i - wh / 2) / f, (j - wh / 2) / f, np.ones_like(i)], -1)
    b2o = np.diag([1.0, -1.0, -1.0, 1.0]).astype(np.float32)
    p = pose @ b2o
    d = (pix[..., None, :] * p[:3, :3]).sum(-1)
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    o = np.broadcast_to(p[:3, 3], d.shape)

    hit_e, t_e = _ray_sphere(o, d, EMIT_CENTER, EMIT_R)
    hit_d, t_d = _ray_sphere(o, d, DIFF_CENTER, DIFF_R)

    t_e = np.where(hit_e, t_e, np.inf)
    t_d = np.where(hit_d, t_d, np.inf)
    front_e = hit_e & (t_e <= t_d)
    front_d = hit_d & (t_d < t_e)

    emit_color = EMIT_RGB * (EMIT_SCALE * intensity)
    if color_scale is not None:
        emit_color = np.asarray(color_scale, np.float32) * (EMIT_SCALE * intensity)

    rgb = np.zeros((*d.shape[:-1], 3), np.float32)
    # diffuse ball: lambertian under a fixed sky + (if on) the emitter
    n_d = (o + d * t_d[..., None] - DIFF_CENTER) / DIFF_R
    sky = 0.35 + 0.25 * np.clip(n_d[..., 2], 0, 1)
    shade = sky.copy()
    if on:
        to_e = EMIT_CENTER - (o + d * np.where(np.isfinite(t_d), t_d, 0)[..., None])
        to_e = to_e / np.maximum(np.linalg.norm(to_e, axis=-1, keepdims=True), 1e-6)
        shade = sky + 0.6 * intensity * np.clip((n_d * to_e).sum(-1), 0, 1)
    rgb[front_d] = DIFF_RGB * shade[front_d][..., None]

    # emissive ball: dark shell when off, emit when on
    if on:
        rgb[front_e] = emit_color
    else:
        rgb[front_e] = 0.05

    alpha = (front_e | front_d).astype(np.float32)
    return rgb, alpha, front_e


def _srgb(x):
    x = np.clip(x, 0, 1)
    return np.where(x <= 0.0031308, 12.92 * x, 1.055 * x ** (1 / 2.4) - 0.055)


def write_scene(
    root: str,
    scene: str = "synth_ball",
    n_train: int = 12,
    n_test: int = 3,
    wh: int = 48,
    fov_x: float = 0.8,
    seed: int = 0,
) -> str:
    """Write the synthetic scene; returns the dataset root (pass as
    ``data.root``, with ``data.scene=<scene>``)."""
    rng = np.random.default_rng(seed)
    sdir = os.path.join(root, scene)
    for d in ["train", "test", "transforms", "train/exr", "test/exr",
              "train/emission", "test/emission", "masks"]:
        os.makedirs(os.path.join(sdir, d), exist_ok=True)

    # per-light edit mask: full-frame mask of the emitter region per view is
    # view dependent; use a constant white mask (single light edits whole img)
    mask_path = "masks/light0"
    png.write(os.path.join(sdir, mask_path + ".png"),
              np.full((wh, wh, 3), 255, np.uint8))

    def save_frame(split, idx, pose, on, intensity=1.0, color=None):
        rgb_lin, alpha, emit_mask = _render(pose, wh, fov_x, on, intensity, color)
        fname = f"r_{idx}"
        srgb = _srgb(rgb_lin)
        rgba = np.concatenate([srgb, alpha[..., None]], -1)
        png.write(os.path.join(sdir, split, fname + ".png"),
                  (rgba * 255).astype(np.uint8))
        exr.imwrite(
            os.path.join(sdir, split, "exr", fname + ".exr"), rgb_lin, half=False
        )
        em_img = np.repeat((emit_mask * 255).astype(np.uint8)[..., None], 3, -1)
        png.write(os.path.join(sdir, split, "emission", fname + ".png"),
                  em_img)
        return fname

    def frames_for(split, n, modes):
        frames = []
        for idx in range(n):
            theta = 2 * np.pi * idx / n + (0.3 if split == "test" else 0.0)
            phi = 0.45 + 0.35 * ((idx % 3) / 2.0)
            eye = 2.8 * np.array(
                [np.cos(theta) * np.cos(phi), np.sin(theta) * np.cos(phi),
                 np.sin(phi)]
            )
            pose = _look_at_blender(eye.astype(np.float32), np.zeros(3))
            mode = modes[idx % len(modes)]
            on = mode != "off"
            intensity = 0.5 if mode == "i_change" else 1.0
            # edit colors are (hue, saturation) pairs — the editing pipeline
            # replaces hsv[..., :2] with them (reference esrnerf.py:419-421)
            color_hs = [0.6, 0.8] if mode in ("c_change", "ic_change") else None
            color_rgb = None
            if color_hs is not None:
                import colorsys

                v = float(EMIT_RGB.max())
                color_rgb = list(
                    colorsys.hsv_to_rgb(color_hs[0], color_hs[1], v)
                )
            fname = save_frame(split, idx, pose, on, intensity, color_rgb)
            frames.append(
                {
                    "file_path": f"{split}/{fname}",
                    "transform_matrix": pose.tolist(),
                    "lights": [
                        {
                            "mode": mode,
                            "mask_path": mask_path,
                            "color": color_hs or [0.12, 0.6],
                            "intensity": intensity,
                        }
                    ],
                }
            )
        return frames

    def write_transforms(phase, frames):
        with open(
            os.path.join(sdir, "transforms", f"transforms_{phase}.json"), "w"
        ) as f:
            json.dump({"camera_angle_x": fov_x, "frames": frames}, f)

    write_transforms("train", frames_for("train", n_train, ["off", "on"]))
    write_transforms("test_nv", frames_for("test", n_test, ["off", "on"]))
    write_transforms("test_nvc", frames_for("test", n_test, ["c_change"]))
    write_transforms("test_nvi", frames_for("test", n_test, ["i_change"]))
    write_transforms("test_nvic", frames_for("test", n_test, ["ic_change"]))
    return root


def _look_at_opencv(eye: np.ndarray, target: np.ndarray) -> np.ndarray:
    """camera-to-world with OpenCV convention (+z forward, +y down)."""
    z = target - eye
    z = z / np.linalg.norm(z)
    up = np.array([0.0, 0.0, 1.0])
    if abs(np.dot(up, z)) > 0.99:
        up = np.array([0.0, 1.0, 0.0])
    x = np.cross(z, up)
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    m = np.eye(4, dtype=np.float32)
    m[:3, 0], m[:3, 1], m[:3, 2], m[:3, 3] = x, y, z, eye
    return m


def write_dtu_scene(
    root: str,
    scan: int = 1,
    n_views: int = 10,
    wh: int = 48,
    fov_x: float = 0.8,
    chamfer_assets: bool = True,
) -> str:
    """Write a DTU-format scene (``cameras_sphere.npz`` + image/ + mask/ +
    the ObsMask/Plane/STL Chamfer assets) of the two-ball scene, in the
    layout ``data.dtu.DTU`` expects; returns ``root`` (pass as
    ``data.root``, with ``data.scene=<scan>``). scale_mat is the identity,
    so all Chamfer assets live in the normalised world space."""
    from scipy.io import savemat

    from esrnerf_tpu_torch.utils.mesh import export_ply

    sdir = os.path.join(root, f"dtu_scan{scan}")
    for d in ["image", "mask"]:
        os.makedirs(os.path.join(sdir, d), exist_ok=True)
    os.makedirs(os.path.join(root, "ObsMask"), exist_ok=True)
    os.makedirs(os.path.join(root, "Points", "stl"), exist_ok=True)

    f = wh / 2.0 / np.tan(fov_x / 2.0)
    cx = cy = wh / 2.0 - 0.5
    K = np.array([[f, 0, cx], [0, f, cy], [0, 0, 1]], np.float64)

    def view(idx):
        theta = 2 * np.pi * idx / n_views
        phi = 0.45 + 0.3 * ((idx % 3) / 2.0)
        eye = 2.8 * np.array(
            [np.cos(theta) * np.cos(phi), np.sin(theta) * np.cos(phi),
             np.sin(phi)]
        )
        c2w = _look_at_opencv(eye.astype(np.float32), np.zeros(3))
        w2c = np.linalg.inv(c2w.astype(np.float64))
        world_mat = np.eye(4)
        world_mat[:3] = K @ w2c[:3]

        # render via the blender-convention renderer: undo its flip
        pose_blender = c2w @ np.diag([1.0, -1.0, -1.0, 1.0]).astype(np.float32)
        rgb_lin, alpha, _ = _render(pose_blender, wh, fov_x, on=False)
        png.write(os.path.join(sdir, "image", f"{idx:06d}.png"),
                  (_srgb(rgb_lin) * 255).astype(np.uint8))
        png.write(os.path.join(sdir, "mask", f"{idx:03d}.png"),
                  np.repeat((alpha * 255).astype(np.uint8)[..., None], 3, -1))
        return world_mat

    # views render independently; numpy and zlib release the GIL
    with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:
        world_mats = list(pool.map(view, range(n_views)))
    cams = {}
    for idx, world_mat in enumerate(world_mats):
        cams[f"world_mat_{idx}"] = world_mat
        cams[f"scale_mat_{idx}"] = np.eye(4)
    np.savez(os.path.join(sdir, "cameras_sphere.npz"), **cams)

    if chamfer_assets:
        # ObsMask: everything inside [-1,1]^3 observed; Res 0.05
        res = 0.05
        bb = np.array([[-1.0, -1.0, -1.0], [1.0, 1.0, 1.0]])
        dim = int(2.0 / res) + 1
        savemat(
            os.path.join(root, "ObsMask", f"ObsMask{scan}_10.mat"),
            {"ObsMask": np.ones((dim, dim, dim), np.uint8), "BB": bb,
             "Res": np.array([[res]])},
        )
        savemat(
            os.path.join(root, "ObsMask", f"Plane{scan}.mat"),
            {"P": np.array([[0.0], [0.0], [1.0], [10.0]])},
        )

        # GT point cloud: both sphere surfaces
        def sphere_pts(c, r, n=4000):
            rng = np.random.default_rng(scan)
            v = rng.normal(size=(n, 3))
            v /= np.linalg.norm(v, axis=-1, keepdims=True)
            return c + r * v

        pts = np.concatenate(
            [sphere_pts(EMIT_CENTER, EMIT_R), sphere_pts(DIFF_CENTER, DIFF_R)]
        ).astype(np.float32)
        export_ply(
            os.path.join(root, "Points", "stl", f"stl{scan:03d}_total.ply"),
            pts, np.zeros((0, 3), np.int64),
        )
    return root
