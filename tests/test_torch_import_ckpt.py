"""The port's reference-checkpoint importer against the JAX package's: a
reference-layout state_dict (torch tensors under the reference's key names,
``[1, C, X, Y, Z]`` grids, ``[out, in]`` Linear weights) for each of the
four model kinds through both ``convert_state_dict`` and
``convert_checkpoint``, the payloads held bitwise; the path-to-kind
inference; and the entry point, in a fresh interpreter, on a checkpoint
whose pickled config is an instance of a class from a module that is not
installed (as the reference's Hydra ``DictConfig`` without
``omegaconf``)."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from chip_smoke import save_with_absent_cfg_class
from esrnerf_tpu.utils import import_torch_ckpt as jimp
from esrnerf_tpu_torch.utils import checkpoint as ckpt_io
from esrnerf_tpu_torch.utils import import_torch_ckpt as timp
from test_torch_common import REPO

pytestmark = pytest.mark.quick

GRID = (5, 6, 7)  # odd, unequal axes: a transposed axis cannot pass


def _mlp(rng, dims):
    out = {}
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        out[f"w{i}"] = rng.normal(size=(a, b)).astype(np.float32)
        out[f"b{i}"] = rng.normal(size=(b,)).astype(np.float32)
    return out


def _params(kind, seed=0):
    """A random parameter tree of ``kind`` in the port's layout."""
    rng = np.random.default_rng(seed)
    grid = lambda c: rng.normal(size=GRID + (c,)).astype(np.float32)
    if kind == "dvgo":
        return {"density": grid(1), "off_color": grid(3),
                "emo_color": grid(3)}
    p = {"sdf": grid(1), "off_color": grid(6), "emo_color": grid(6),
         "off_rgbnet": _mlp(rng, [20, 16, 16, 3]),
         "emo_rgbnet": _mlp(rng, [20, 16, 16, 3])}
    if kind in ("voxurff", "esrnerf"):
        p["tonemapper"] = _mlp(rng, [3, 8, 3])
    if kind == "esrnerf":
        p["brdf"] = grid(6)
        p["brdfnet"] = _mlp(rng, [24, 16, 5])
        p["emitnet"] = _mlp(rng, [24, 16, 3])
        p["envmap"] = {k: rng.normal(size=(16, n)).astype(np.float32)
                       for k, n in (("mus", 3), ("lambdas", 1),
                                    ("lobes", 3))}
    return p


def _state_dict(kind, seed=0):
    """The reference's ``model.state_dict()``: torch tensors."""
    return {k: torch.from_numpy(v) for k, v in
            timp.reference_state_dict(_params(kind, seed), kind).items()}


def _reference_ckpt(kind, seed=0, cfg=None):
    rng = np.random.default_rng(seed + 100)
    t = torch.from_numpy
    return {
        "renderer": {
            "cfg": cfg, "near": 0.5, "far": t(np.float32([4.0])),
            "xyz_min": t(rng.normal(size=3).astype(np.float32)),
            "xyz_max": t(rng.normal(size=3).astype(np.float32)),
            "s_val": torch.tensor(123.5), "num_voxels": 210,
            "mask_density": t(rng.normal(size=(1, 1, 4, 5, 6)).astype(
                np.float32)),
            "mask_xyz_min": t(np.float32([-1, -1, -1])),
            "mask_xyz_max": t(np.float32([1, 1, 1])),
            "mask_alpha_init": 1e-6,
            "params": _state_dict(kind, seed),
        },
        "trainer": {"global_step": 4999,
                    "batch_st": 8192,
                    "data_idxs": t(rng.permutation(50).astype(np.int64)),
                    "optimizer": {"state": {}, "param_groups": []}},
    }


def _assert_bitwise(got, want, path=""):
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), path
        for k in want:
            _assert_bitwise(got[k], want[k], f"{path}/{k}")
        return
    if want is None or isinstance(want, (int, float)):
        assert type(got) is type(want) and got == want, path
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, path
    np.testing.assert_array_equal(got, want, err_msg=path)


@pytest.mark.parametrize("kind", timp.KINDS)
def test_convert_state_dict_matches_jax(kind):
    state = _state_dict(kind, seed=1)
    got = timp.convert_state_dict(state, kind)
    _assert_bitwise(got, jimp.convert_state_dict(state, kind))
    _assert_bitwise(got, _params(kind, seed=1))  # the layouts invert


@pytest.mark.parametrize("kind", timp.KINDS)
def test_convert_checkpoint_matches_jax(kind):
    ref = _reference_ckpt(kind, seed=2)
    got = timp.convert_checkpoint(ref, kind)
    _assert_bitwise(got, jimp.convert_checkpoint(ref, kind))
    assert got["trainer"]["global_step"] == 4999
    assert got["renderer"]["mask_density"].shape == (4, 5, 6, 1)


def test_kind_inference_matches_jax():
    def jax_infer(path):  # scripts/import_reference_ckpt.py's loop
        low = path.lower()
        for frag, k in jimp.STAGE_KINDS:
            if frag in low:
                return k
        return None

    assert timp.STAGE_KINDS == jimp.STAGE_KINDS and timp.KINDS == jimp.KINDS
    paths = ["logs/giftbox_w/alphamask.AlphaMask/0/last.ckpt",
             "logs/giftbox_w/coarse.Coarse/0/last.ckpt",
             "logs/giftbox_w/fine.Fine/0/last.ckpt",
             "logs/giftbox_w/fine.LTS/0/last.ckpt",
             "logs/giftbox_w/fine.PDRA/0/last.ckpt",
             "runs/LTS_run/last.ckpt", "runs/unknown/last.ckpt"]
    want = ["dvgo", "voxurfc", "voxurff", "esrnerf", "esrnerf", "esrnerf",
            None]
    assert [timp.infer_kind(p) for p in paths] == want
    assert [jax_infer(p) for p in paths] == want
    with pytest.raises(ValueError, match="unknown model kind"):
        timp.convert_state_dict({}, "nerf")


def test_entry_point_imports_a_checkpoint_whose_cfg_class_is_absent(
        tmp_path):
    ref = _reference_ckpt("esrnerf", seed=3)
    src = tmp_path / "logs" / "fine.LTS" / "last.ckpt"
    src.parent.mkdir(parents=True)
    save_with_absent_cfg_class(ref, str(src))
    with pytest.raises(ModuleNotFoundError):  # what a plain load does
        torch.load(str(src), weights_only=False)
    dst = tmp_path / "out" / "last.ckpt"
    env = {**os.environ, "PYTHONPATH": REPO}
    r = subprocess.run(
        [sys.executable, "-m", "esrnerf_tpu_torch.scripts."
         "import_reference_ckpt", str(src), str(dst)],
        capture_output=True, text=True, timeout=300, env=env, cwd=REPO)
    assert r.returncode == 0, r.stdout + r.stderr[-2000:]
    assert "kind=esrnerf" in r.stdout
    got = ckpt_io.load_checkpoint(str(dst))
    _assert_bitwise(got, jimp.convert_checkpoint(ref, "esrnerf"))
    loaded = timp.load_reference(str(src))
    cfg = loaded["renderer"]["cfg"]
    assert type(cfg).__module__ == "omegaconf.dictconfig"
    assert cfg.__dict__["_content"] == {"app": {"cls": "fine.LTS"}}
    # an unknown kind is refused with the kinds named
    r = subprocess.run(
        [sys.executable, "-m", "esrnerf_tpu_torch.scripts."
         "import_reference_ckpt", str(tmp_path / "x.ckpt"), str(dst)],
        capture_output=True, text=True, timeout=300, env=env, cwd=REPO)
    assert r.returncode == 2 and "dvgo|voxurfc|voxurff|esrnerf" in r.stdout
