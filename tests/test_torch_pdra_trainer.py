"""The port's PDRA trainer and relighting phases against the JAX package, on
the CPU at micro scale: the regroup's split, ``filter_edit_rays`` on a
test-written disc mask (and the dilation bitwise to OpenCV's), the PDRA
checkpoint handoff in both directions with two train steps after each,
and the chain LTS -> PDRA -> test_nv -> the three relighting phases
through ``esrnerf_tpu_torch.run`` (``system.device=cpu``)."""

import json
import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esrnerf_tpu.apps.pdra import PDRA as JPDRA
from esrnerf_tpu.config import customize_cfg as jcustomize
from esrnerf_tpu.config import load_cfg as jload
from esrnerf_tpu.data.sampler import RayGroupManager as JGroups
from esrnerf_tpu_torch import run as trun
from esrnerf_tpu_torch.apps import pdra as tpdra
from esrnerf_tpu_torch.apps.pdra import PDRA as TPDRA
from esrnerf_tpu_torch.config import customize_cfg as tcustomize
from esrnerf_tpu_torch.config import load_cfg as tload
from esrnerf_tpu_torch.data.sampler import RayGroupManager as TGroups
from esrnerf_tpu_torch.data.synthetic import write_scene
from esrnerf_tpu_torch.models import voxurf_base as tvb
from esrnerf_tpu_torch.models.esrnerf import ESRNeRF as TESRNeRF
from esrnerf_tpu_torch.utils import checkpoint as tckpt
from esrnerf_tpu_torch.utils.convert import params_to_numpy
from test_torch_common import REPO
from test_torch_lts_trainer import _leaves, _same_batch

pytestmark = pytest.mark.quick

PDRA_CFG = os.path.join(REPO, "cfg/exp/esrnerf/giftbox_w/pdra.yaml")
WH, N_TRAIN, N_TEST = 24, 4, 2
# cfg/app/pdra.yaml cut to CPU size: a 16^3 grid, 2-layer 32-wide heads,
# 16 LTS points x 4 secondary rays, 64 + 64 rays a step (the fine-tune's
# too), budgets with overflow 0 on the ball, a regroup every 2 steps and
# k_val near the middle of the seeded emissions
PDRA_MICRO = [
    "app.model.rgbnet_width=32", "app.model.rgbnet_depth=2",
    "app.model.tonemap_width=32", "app.model.tonemap_depth=2",
    "app.model.brdfnet_width=32", "app.model.brdfnet_depth=2",
    "app.model.num_ltspts=16", "app.model.num_2ndrays=4",
    "app.model.points_budget_masked_per_ray=432",
    "app.model.points_budget_per_ray=16",
    "app.model.points_budget_masked_per_2ndray=128",
    "app.model.points_budget_per_2ndray=16",
    "app.trainer.s_start=40", "app.trainer.uncert_batch_size=64",
    "app.trainer.cert_batch_size=64", "app.trainer.group_interval=2",
    "app.trainer.prog_start=0.69", "app.eval.uncert_batch_size=64",
    "app.eval.cert_batch_size=64", "app.eval.batch_size=288",
    "app.eval.n_iters=3", "app.eval.cache_march_ppr=8",
]


def _common(root, name):
    return [f"data.root={root}/data", "data.cls=esrnerf.ESRNeRF",
            "data.scene=synth_ball", f"log.root={root}/{name}", "log.name=t",
            "log.offline=true", "system.debug=true", "system.mesh_axes=[]",
            "system.compute_dtype=float32", "system.tqdm_iters=1",
            "app.trainer.N_vis=1"]


def _lts_ckpt(path, seed=0):
    """An LTS-stage checkpoint (the JAX schema) of a 16^3 ESRNeRF: a
    radius-0.5 sphere SDF inside a radius-0.7 occupancy ball, seeded heads
    and random colour and BRDF grids, every train ray in its pool."""
    cfg = tload(PDRA_CFG, ["app.phase=train", "data.cls=x", "data.root=x",
                           "data.scene=x", *PDRA_MICRO], root_dir=REPO)
    g = np.linspace(-1, 1, 16)
    x, y, z = np.meshgrid(g, g, g, indexing="ij")
    dens = np.where(np.sqrt(x**2 + y**2 + z**2) < 0.7, 20.0,
                    -20.0).astype(np.float32)[..., None]
    lo, hi = np.full(3, -1, np.float32), np.ones(3, np.float32)
    meta = {"mask_xyz_min": lo, "mask_xyz_max": hi, "mask_alpha_init": 1e-6,
            "mask_density": dens}
    model = TESRNeRF(cfg, 0.5, 6.0, lo, hi,
                     tvb.make_mask_cache(dens, lo, hi, 1e-6, 1e-3, 3,
                                         device="cpu"),
                     40.0, 4096, meta)
    params = params_to_numpy(model.init_params(
        torch.Generator().manual_seed(seed)))
    X, Y, Z = model.geo.world_size
    x, y, z = np.mgrid[-1:1:X * 1j, -1:1:Y * 1j, -1:1:Z * 1j]
    params["sdf"] = (np.sqrt(x**2 + y**2 + z**2) - 0.5).astype(
        np.float32)[..., None]
    rng = np.random.default_rng(seed)
    for k in ("off_color", "emo_color", "brdf"):
        params[k] = rng.normal(scale=0.3, size=params[k].shape).astype(
            np.float32)
    tckpt.save_checkpoint(path, {
        "renderer": {"cfg": {}, **model.export_meta(), "params": params},
        "trainer": {"global_step": 0, "batch_st": 0,
                    "data_idxs": np.arange(N_TRAIN * WH * WH)},
    })
    return path


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("pdra"))
    write_scene(f"{root}/data", wh=WH, n_train=N_TRAIN, n_test=N_TEST)
    return root, _lts_ckpt(f"{root}/lts.ckpt")


def _cfgs(root, name, *extra):
    ov = [*_common(root, name), *PDRA_MICRO, *extra]
    return (jcustomize(jload(PDRA_CFG, ov, root_dir=REPO)),
            tcustomize(tload(PDRA_CFG, ov + ["system.device=cpu"],
                             root_dir=REPO)))


def _load(cls, cfg):
    app = cls(cfg)
    app.load_dataset()
    app.load_model()
    return app


def _rows(app):
    with open(os.path.join(app.cfg.log["dir"], "metrics.jsonl")) as f:
        return [json.loads(ln) for ln in f]


# --------------------------------------------------------------- regroup


@pytest.fixture(scope="module")
def started(scene):
    """JAX and port PDRA runs started from the same LTS checkpoint (each
    regroups at k_val and shuffles before its first step)."""
    root, lts = scene
    jcfg, tcfg = _cfgs(root, "handoff", "app.phase=train",
                       f"app.trainer.ckpt={lts}")
    return _load(JPDRA, jcfg), _load(TPDRA, tcfg)


def test_regroup_split_matches_reference(started):
    """The port moves the same rays to the certain pool as JAX, and both
    shuffle them alike. A ray whose emission lies within the eval forward's
    tolerance of k_val could go either way: there is none here (the
    margin is checked, and such rays would be named)."""
    j, t = started
    assert j.global_step == t.global_step == 0
    n = N_TRAIN * WH * WH
    assert 0 < t.sampler.cert_data_num < n
    near = []
    with torch.no_grad():
        data = t.train_dataset.all_data
        emit, ovf = t.renderer.eval_emit(
            t.params, *(torch.as_tensor(data[k]) for k in
                        ("rays_o", "rays_d", "viewdirs")),
            t.s_val_at(0))
        assert float(ovf) == 0.0
        gap = np.abs(emit.numpy().max(-1) - t.k_val)
        near = np.nonzero(gap <= 1e-4 * t.k_val + 1e-5)[0].tolist()
    assert near == [], f"rays within tolerance of k_val: {near}"
    for k, v in j.sampler.state().items():
        np.testing.assert_array_equal(t.sampler.state()[k], v, err_msg=k)
    _same_batch(t.sampler.sample(), j.sampler.sample())


# ---------------------------------------------------- handoff both ways


def _same_params(tparams, jparams):
    lj, lt = _leaves(jax.tree.map(np.asarray, jparams)), \
        _leaves(params_to_numpy(tparams))
    assert lj.keys() == lt.keys()
    for k in lj:
        np.testing.assert_array_equal(lt[k], lj[k], err_msg=k)


def test_pdra_checkpoint_handoff_both_ways(scene, started):
    """JAX's PDRA checkpoint (after its step-0 regroup) resumes in the port
    with the same parameters, optimizer state, pools and next batch, and
    the port trains two steps from it (regrouping on the second); the
    port's checkpoint then resumes in the JAX PDRA the same way, and JAX
    trains two steps from it."""
    root, _ = scene
    j, _ = started
    j.save(os.path.join(j.ckpt_dir(), "last.ckpt"))
    jcfg, tcfg = _cfgs(root, "handoff", "app.phase=train",
                       "app.trainer.n_iters=3", "app.trainer.save_every=3",
                       "app.trainer.vis_every=100")
    t = _load(TPDRA, tcfg)  # resumes from the JAX last.ckpt
    assert t.global_step == 1 and t.renderer.pdra_mode
    _same_params(t.params, j.params)
    for tt, jj in ((t.opt_state.mu, j.opt_state.mu),
                   (t.opt_state.nu, j.opt_state.nu)):
        _same_params(tt, jj)
    for k, v in j.sampler.state().items():
        np.testing.assert_array_equal(t.sampler.state()[k], v, err_msg=k)
    t.process()  # steps 1 and 2, then its checkpoint
    assert t.global_step == 2
    rows = [r for r in _rows(t) if "train/metric/srgb/MSE" in r]
    assert [r["step"] for r in rows] == [1, 2]
    assert all(r["train/metric/etc/overflow"] == 0.0 for r in rows)
    assert any("train/metric/etc/n_certain" in r and r["step"] == 1
               for r in _rows(t))  # the regroup at step 1

    j2 = _load(JPDRA, _cfgs(root, "handoff", "app.phase=train",
                            "app.trainer.n_iters=5",
                            "app.trainer.save_every=100",
                            "app.trainer.vis_every=100")[0])
    assert j2.global_step == 3
    _same_params(t.params, j2.params)
    for k, v in t.sampler.state().items():
        np.testing.assert_array_equal(j2.sampler.state()[k], v, err_msg=k)
    j2.process()  # steps 3 and 4
    assert j2.global_step == 4
    assert np.isfinite(float(j2.params["sdf"].sum()))


# --------------------------------------------------------- edit rays


def _disc(cx, cy, r):
    yy, xx = np.mgrid[0:WH, 0:WH]
    return ((xx - cx) ** 2 + (yy - cy) ** 2 <= r * r).astype(np.float32)


@pytest.mark.parametrize("ks", [10, 3])
def test_dilation_matches_opencv(ks):
    """The port's dilation bitwise to ``cv2.dilate`` with a ``ks`` x ``ks``
    window (even ``ks``: the asymmetric window)."""
    rng = np.random.default_rng(ks)
    for m in (_disc(7.0, 12.0, 3.0), _disc(0.0, 23.0, 2.0),
              (rng.uniform(size=(WH, WH + 5)) > 0.95).astype(np.float32)
              * rng.uniform(size=(WH, WH + 5)).astype(np.float32)):
        want = cv2.dilate(m, np.ones((ks, ks)), iterations=1)
        got = tpdra.dilate_like_cv2(m, ks)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def relight_apps(scene, started):
    """JAX and port PDRA apps in ``test_nvic`` on the JAX run's
    checkpoint."""
    root, _ = scene
    j, _ = started
    ckpt = os.path.join(j.ckpt_dir(), "last.ckpt")
    if not os.path.exists(ckpt):
        j.save(ckpt)
    jcfg, tcfg = _cfgs(root, "relight", "app.phase=test_nvic",
                       f"app.eval.ckpt={ckpt}")
    return _load(JPDRA, jcfg), _load(TPDRA, tcfg)


@pytest.mark.parametrize("ks", [10, 3])
def test_filter_edit_rays_matches_reference(relight_apps, ks):
    """Two lights on test-written disc masks (an intensity-and-colour edit,
    then an off light over part of it): ``keep``, the modes, colours and
    intensities of both pools bitwise equal to JAX's, after the ``-f``
    camera projection, the clipped bilinear taps and the dilation."""
    j, t = relight_apps
    data = dict(j.test_dataset[0])
    data["em_masks"] = np.stack([_disc(17.0, 12.0, 1.0).reshape(-1),
                                 _disc(15.0, 8.0, 0.5).reshape(-1)])
    data["em_modes"] = np.array([4, 0])
    data["em_colors"] = np.array([[0.6, 0.8], [0.1, 0.2]], np.float32)
    data["em_intensities"] = np.array([0.37, 2.0], np.float32)
    out = []
    for app, groups in ((j, JGroups), (t, TGroups)):
        app.mask_dilation_ks = ks
        s = groups(app.cfg, app.train_dataset.all_data, list(app.data_keys),
                   64, 64, uncert_data_idxs=app._eval_uncert_idxs,
                   cert_data_idxs=app._eval_cert_idxs,
                   seed=app.cfg.system["seed"])
        out.append(app.filter_edit_rays(s, data))
    js, ts = out
    n = len(j._eval_uncert_idxs)
    assert 0 < js.uncert_data_num < n  # the discs keep some rays only
    assert set(np.asarray(js.uncert_data["em_modes"])) == {0, 4}
    assert ts.keys == js.keys
    for pool in ("uncert_data", "cert_data"):
        for k in ("em_modes", "em_colors", "em_intensities", "rays_o"):
            w, g = getattr(js, pool)[k], getattr(ts, pool)[k]
            assert g.dtype == w.dtype, (pool, k)
            np.testing.assert_array_equal(g, w, err_msg=f"{pool} {k}")
    for k, v in js.state().items():
        np.testing.assert_array_equal(ts.state()[k], v, err_msg=k)


# --------------------------------------------- the chain through run.main


def test_run_main_pdra_train_and_relight_on_cpu(scene, monkeypatch):
    """PDRA from the LTS checkpoint: train with two regroups, test_nv with
    the IoU, checkpoint, resume, then test_nv of the saved checkpoint and
    the three relighting phases on both test images. Every image's
    fine-tune starts from the checkpoint's emo grid, and moves it."""
    root, lts = scene
    base = ["-cn", PDRA_CFG, *_common(root, "chain"), *PDRA_MICRO,
            "system.device=cpu"]
    train = base + ["app.phase=train", f"app.trainer.ckpt={lts}",
                    "app.trainer.save_every=4", "app.trainer.vis_every=4"]
    app = trun.main(train + ["app.trainer.n_iters=4"])
    assert isinstance(app, TPDRA) and app.global_step == 3
    rows = _rows(app)
    assert all(np.isfinite(v) for r in rows for v in r.values())
    assert [r["step"] for r in rows if "train/metric/etc/k_val" in r] == \
        [0, 1, 3]
    steps = [r for r in rows if "train/metric/srgb/MSE" in r]
    assert [r["step"] for r in steps] == [0, 1, 2, 3]
    assert all(r["train/metric/etc/overflow"] == 0.0 for r in steps)
    iou = [r for r in rows if "test_nv/metric/etc/IoU" in r]
    assert len(iou) == 1 and 0.0 < iou[0]["test_nv/metric/etc/IoU"] <= 1.0
    ckpt = os.path.join(app.cfg.log["dir"], "checkpoints", "last.ckpt")
    t = tckpt.load_checkpoint(ckpt)["trainer"]
    assert {"uncert_batch_st", "cert_batch_st", "uncert_data_idxs",
            "cert_data_idxs"} <= set(t)

    app2 = trun.main(train + ["app.trainer.n_iters=5"])
    assert app2.global_step == 4
    ev = trun.main(base + ["app.phase=test_nv", f"app.eval.ckpt={ckpt}"])
    assert 0.0 < _rows(ev)[-1]["test_nv/metric/etc/IoU"] <= 1.0

    starts = []
    real = tpdra.build_finetune_step

    def recording(model, opt, w, *args):  # built once per test image
        step, calls = real(model, opt, w, *args), []

        def first(trainable, *a, **kw):
            if not calls:
                starts.append(trainable["emo_color"].detach().clone().numpy())
            calls.append(1)
            return step(trainable, *a, **kw)
        return first

    monkeypatch.setattr(tpdra, "build_finetune_step", recording)
    want = tckpt.load_checkpoint(ckpt)["renderer"]["params"]["emo_color"]
    for phase in ("test_nvc", "test_nvi", "test_nvic"):
        starts.clear()
        a = trun.main(base + [f"app.phase={phase}", f"app.eval.ckpt={ckpt}"])
        assert len(starts) == N_TEST
        for got in starts:  # image 2 starts where image 1 did
            np.testing.assert_array_equal(got, want)
        assert np.abs(params_to_numpy(a.params["emo_color"]) - want).max() > 0
        np.testing.assert_array_equal(params_to_numpy(a.params["emit_color"]),
                                      want)
        r = _rows(a)[-1]
        for k in ("lin/PSNR", "lin/SSIM", "etc/emo_MSE_first",
                  "etc/emo_MSE_last"):
            assert np.isfinite(r[f"{phase}/metric/{k}"]), k
        assert r[f"{phase}/metric/etc/emo_MSE_last"] < \
            r[f"{phase}/metric/etc/emo_MSE_first"]
        assert a.timings["ft_overflow_max"] == 0.0
        img = os.path.join(a.cfg.log["dir"], "image", f"{4:010}", "lin",
                           "rgb_gamma", "001.png")
        assert os.path.getsize(img) > 0
