"""``data.resize`` without PIL or OpenCV: the port's resamplers
(``esrnerf_tpu_torch.data.resample``) against PIL's Lanczos (bitwise, on L,
LA, RGB and RGBA images shrunk and grown, odd sizes, 1-pixel edges) and
OpenCV's Lanczos-4 (float32 HDRs), the ESR-NeRF and DTU datasets at
``data.resize=0.5`` against the JAX loaders (which call PIL and OpenCV),
and a fresh interpreter loading both scenes at 0.5 without importing
either library."""

import os
import subprocess
import sys

import cv2
import numpy as np
import pytest
from PIL import Image

from esrnerf_tpu.config import load_cfg as jload
from esrnerf_tpu.data.dtu import DTU as JDTU
from esrnerf_tpu.data.esrnerf import ESRNeRF as JESRNeRF
from esrnerf_tpu_torch.config import load_cfg as tload
from esrnerf_tpu_torch.data.dtu import DTU as TDTU
from esrnerf_tpu_torch.data.esrnerf import ESRNeRF as TESRNeRF
from esrnerf_tpu_torch.data.resample import lanczos4_cv2, lanczos_pil
from esrnerf_tpu_torch.data.synthetic import write_dtu_scene, write_scene
from test_torch_common import REPO

pytestmark = pytest.mark.quick

FACTORS = (0.5, 0.37, 1.6)
# (height, width, channels): odd sizes, 1-pixel rows and columns
SHAPES = ((37, 53), (37, 53, 2), (37, 53, 3), (37, 53, 4), (1, 9, 3),
          (9, 1), (5, 5, 4), (64, 48, 3))


def _image(shape, seed):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    if len(shape) == 3 and shape[2] in (2, 4):
        # alpha 0 and 255 take their own branch of PIL's unpremultiply
        a = img[..., -1]
        a[rng.random(shape[:2]) < 0.25] = 0
        a[rng.random(shape[:2]) < 0.25] = 255
    return img


@pytest.mark.parametrize("factor", FACTORS)
@pytest.mark.parametrize("shape", SHAPES)
def test_lanczos_pil_is_bitwise_pil(shape, factor):
    img = _image(shape, hash((shape, factor)) % 2**32)
    for size in ((max(1, round(shape[1] * factor)),
                  max(1, round(shape[0] * factor))),
                 (shape[1], max(1, round(shape[0] * factor))),
                 (max(1, round(shape[1] * factor)), shape[0])):
        want = np.asarray(Image.fromarray(img).resize(size, Image.LANCZOS))
        got = lanczos_pil(img, size)
        assert got.dtype == np.uint8 and got.shape == want.shape, size
        np.testing.assert_array_equal(got, want, err_msg=str(size))


@pytest.mark.parametrize("factor", FACTORS + (2.0,))
@pytest.mark.parametrize("shape", ((37, 53, 3), (40, 40, 3), (9, 1, 3),
                                   (3, 7), (1, 6, 3)))
def test_lanczos4_cv2_matches_opencv(shape, factor):
    """Within 2 float32 ulps of the largest |value|: OpenCV's column pass
    sums its 8 taps in one order in its vector loop and another in its
    scalar tail, and the split point moves with the build's vector width
    (this module follows a 4-lane build, where it agrees bit for bit)."""
    rng = np.random.default_rng(int(factor * 100) + len(shape))
    img = (rng.random(shape, dtype=np.float32) * 8).astype(np.float32)
    size = (max(1, round(shape[1] * factor)), max(1, round(shape[0] * factor)))
    want = cv2.resize(img, size, interpolation=cv2.INTER_LANCZOS4)
    got = lanczos4_cv2(img, size)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(
        got, want, rtol=0, atol=2 * np.spacing(np.float32(np.abs(want).max())))


# ------------------------------------------------- the datasets at 0.5


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("resize"))
    esr = write_scene(f"{root}/esr", wh=40, n_train=2, n_test=1)
    write_dtu_scene(f"{root}/dtu", scan=97, n_views=3, wh=40)
    return esr, f"{root}/dtu"


def _esr_cfgs(root):
    ov = ["app.phase=train", "data.cls=esrnerf.ESRNeRF", f"data.root={root}",
          "data.scene=synth_ball", "data.resize=0.5"]
    cfg = os.path.join(REPO, "cfg/app/fine.yaml")
    return jload(cfg, ov, root_dir=REPO), tload(cfg, ov, root_dir=REPO)


@pytest.mark.parametrize("phase", ["train", "test_nv", "test_nvc"])
def test_esrnerf_dataset_at_half_size_matches_jax(scenes, phase):
    """Images, emission areas and edit masks bitwise (PIL's Lanczos); the
    HDRs within 2 float32 ulps of their largest value (OpenCV's
    Lanczos-4, as above)."""
    jc, tc = _esr_cfgs(scenes[0])
    j, t = JESRNeRF(jc, phase), TESRNeRF(tc, phase)
    assert t.image_size == j.image_size == (20, 20)
    assert t.all_data.keys() == j.all_data.keys()
    for k, want in j.all_data.items():
        got = t.all_data[k]
        assert got.dtype == want.dtype and got.shape == want.shape, k
        if k == "hdrs":
            np.testing.assert_allclose(
                got, want, rtol=0,
                atol=2 * np.spacing(np.float32(np.abs(want).max())))
        else:
            np.testing.assert_array_equal(got, want, err_msg=k)


def test_dtu_dataset_at_half_size_matches_jax(scenes):
    """Images and masks bitwise (PIL's Lanczos); the cameras as
    tests/test_torch_dtu.py holds them at full size: the intrinsics to
    1e-9 of their largest entry (OpenCV's and scipy's RQ), the rays within
    one float32 ulp of their largest value."""
    ov = ["app.phase=train", f"data.root={scenes[1]}", "data.resize=0.5"]
    cfg = os.path.join(REPO, "cfg/exp/dtu/97/coarse.yaml")
    j = JDTU(jload(cfg, ov, root_dir=REPO), "train")
    t = TDTU(tload(cfg, ov, root_dir=REPO), "train")
    assert t.image_size == j.image_size == (20, 20)
    assert set(t.all_data) == set(j.all_data)
    np.testing.assert_array_equal(t.all_data["rgbs"], j.all_data["rgbs"])
    np.testing.assert_allclose(t.K, j.K, rtol=0, atol=1e-9 * np.abs(j.K).max())
    for k in ("rays_o", "rays_d", "viewdirs"):
        want = j.all_data[k]
        np.testing.assert_allclose(
            t.all_data[k], want, rtol=0,
            atol=np.spacing(np.float32(np.abs(want).max())), err_msg=k)


def test_half_size_loads_without_pil_or_opencv(scenes):
    """A fresh interpreter loads both scenes at ``data.resize=0.5`` (the
    ESR-NeRF test_nv phase with its HDRs) and never imports PIL or cv2."""
    code = f"""
import sys
sys.path.insert(0, {REPO!r})
from esrnerf_tpu_torch.config import load_cfg
from esrnerf_tpu_torch.data.dtu import DTU
from esrnerf_tpu_torch.data.esrnerf import ESRNeRF
cfg = load_cfg({REPO!r} + "/cfg/app/fine.yaml", ["app.phase=train",
    "data.cls=esrnerf.ESRNeRF", "data.root={scenes[0]}",
    "data.scene=synth_ball", "data.resize=0.5"], root_dir={REPO!r})
assert ESRNeRF(cfg, "test_nv").all_data["hdrs"].shape[1] == 400
cfg = load_cfg({REPO!r} + "/cfg/exp/dtu/97/coarse.yaml", ["app.phase=train",
    "data.root={scenes[1]}", "data.resize=0.5"], root_dir={REPO!r})
assert DTU(cfg, "train").image_size == (20, 20)
bad = [m for m in ("PIL", "cv2") if m in sys.modules]
assert not bad, bad
"""
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
