"""The port's upstream trainers (AlphaMask, Coarse) against the JAX package,
on the CPU at micro scale: one train step of each from the same parameters
and batch, the checkpoint handoff in both directions (a JAX alphamask
checkpoint into the port's coarse stage; the port's coarse checkpoint into
either fine stage), and the three-stage chain alphamask -> coarse -> fine
through ``esrnerf_tpu_torch.run`` (``system.device=cpu``), each stage
finding the previous one's checkpoint by path."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esrnerf_tpu.apps.alphamask import AlphaMask as JAlphaMask
from esrnerf_tpu.apps.coarse import Coarse as JCoarse
from esrnerf_tpu.apps.fine import Fine as JFine
from esrnerf_tpu.config import customize_cfg as jcustomize
from esrnerf_tpu.config import load_cfg as jload
from esrnerf_tpu.models.dvgo import DVGO as JDVGO
from esrnerf_tpu.optim import Adam as JAdam
from esrnerf_tpu.optim.adam import make_pervoxel_lr as jpervoxel
from esrnerf_tpu_torch import run as trun
from esrnerf_tpu_torch.apps.alphamask import build_alphamask_train_step
from esrnerf_tpu_torch.apps.coarse import Coarse as TCoarse
from esrnerf_tpu_torch.apps.coarse import build_coarse_train_step
from esrnerf_tpu_torch.apps.fine import Fine as TFine
from esrnerf_tpu_torch.config import customize_cfg as tcustomize
from esrnerf_tpu_torch.config import load_cfg as tload
from esrnerf_tpu_torch.data.synthetic import write_scene
from esrnerf_tpu_torch.models.dvgo import DVGO as TDVGO
from esrnerf_tpu_torch.optim import Adam as TAdam
from esrnerf_tpu_torch.optim import exp_decay_factor
from esrnerf_tpu_torch.ops import ray as tray
from esrnerf_tpu_torch.utils import checkpoint as tckpt
from esrnerf_tpu_torch.utils import png
from esrnerf_tpu_torch.utils.convert import params_from_jax, params_to_numpy
from test_torch_common import REPO

pytestmark = pytest.mark.quick


def stage_cfg(stage):
    return os.path.join(REPO, f"cfg/exp/esrnerf/giftbox_w/{stage}.yaml")


# the three stages cut to CPU size on a 40x40 scene; f32 heads
MICRO = {
    "alphamask": ["app.model.num_voxels=8000", "app.trainer.batch_size=256"],
    "coarse": ["app.model.num_voxels=16384", "app.trainer.batch_size=128",
               "app.model.rgbnet_width=32"],
    "fine": ["app.trainer.num_voxels=8000", "app.trainer.batch_size=128",
             "app.trainer.pg_scale=[]", "app.model.rgbnet_width=32",
             "app.model.rgbnet_depth=2", "app.model.tonemap_width=32"],
}


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = tmp_path_factory.mktemp("upstream")
    write_scene(str(root / "data"), wh=40, n_train=4, n_test=1)
    return str(root)


def common(root, name):
    return [f"data.root={root}/data", "data.cls=esrnerf.ESRNeRF",
            "data.scene=synth_ball", f"log.root={root}/{name}", "log.name=t",
            "log.offline=true", "system.debug=true", "system.mesh_axes=[]",
            "system.compute_dtype=float32", "app.eval.batch_size=400"]


def both_cfgs(root, name, stage, extra=()):
    ov = ["app.phase=train", *common(root, name), *MICRO[stage], *extra]
    return (jcustomize(jload(stage_cfg(stage), ov, root_dir=REPO)),
            tcustomize(tload(stage_cfg(stage), ov + ["system.device=cpu"],
                             root_dir=REPO)))


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree)}


def assert_adam_step_close(lrs, mu_j, mu_t, p_j, p_t):
    """Adam's first moments within 1e-4 of each leaf's largest; the
    parameters where the moment is well above its rounding (the first
    step moves each by about lr * sign(g), so a near-zero gradient's sign
    is noise) within 2e-4 x lr."""
    mu_j, mu_t, p_j, p_t = (_leaves(x) for x in (mu_j, mu_t, p_j, p_t))
    assert mu_j.keys() == mu_t.keys()
    for k in mu_j:
        scale = np.abs(mu_j[k]).max()
        assert scale > 0, k
        assert np.abs(mu_t[k] - mu_j[k]).max() <= 1e-4 * scale, k
        sel = np.abs(mu_j[k]) > 1e-3 * scale
        np.testing.assert_allclose(p_t[k][sel], p_j[k][sel], rtol=1e-6,
                                   atol=2e-4 * lrs[k.split("/")[0]],
                                   err_msg=k)


def _t(x):
    return torch.as_tensor(np.asarray(x))


def face_decided(geo, rays_o, rays_d, eps=1e-5):
    """Rays of the DVGO-style filter whose occupied samples all lie within
    ``eps`` of a bbox face (so the inside test of those samples, not the
    mask, decides whether the ray is kept)."""
    pts, outb = tray.sample_rays_dvgo(
        _t(rays_o), _t(rays_d), geo.xyz_min_t, geo.xyz_max_t, geo.near,
        geo.far, geo.stepsize, geo.voxel_size, geo.n_samples)
    occ = geo.mask_cache.query(pts)
    face = (((pts - geo.xyz_min_t).abs() < eps)
            | ((pts - geo.xyz_max_t).abs() < eps)).any(-1)
    core = (~outb & occ & ~face).any(-1)
    return (~core & (occ & face).any(-1)).numpy()


# ------------------------------------------------------------- train steps


def test_alphamask_train_step_matches_reference(scene):
    """One JAX AlphaMask step (its key's uniform draw is the rays' shift)
    and one port step from the same parameters, per-voxel LR and batch."""
    jcfg, tcfg = both_cfgs(scene, "am_step", "alphamask")
    ja = JAlphaMask(jcfg)
    ja.load_dataset()
    data = ja.train_dataset.all_data
    near, far = ja.train_dataset.near_far
    lo, hi = ja._compute_bbox(data)
    jm = JDVGO(jcfg, near, far, lo, hi)
    tm = TDVGO(tcfg, near, far, lo, hi, device="cpu")
    assert tm.world_size == jm.world_size and tm.n_samples == jm.n_samples

    rng = np.random.default_rng(0)
    params = jax.tree.map(np.asarray, jm.init_params())
    params["density"] = rng.normal(12.0, 3.0, params["density"].shape
                                   ).astype(np.float32)
    for g in ("off_color", "emo_color"):
        params[g] = rng.normal(size=params[g].shape).astype(np.float32)
    cnt = rng.integers(0, 5, params["density"].shape).astype(np.float32)
    pick = rng.choice(len(data["rgbs"]), 256, replace=False)  # both modes
    b = {k: data[k][pick] for k in ja.data_keys}
    assert 0 < b["em_modes"].sum() < 256
    key = jax.random.PRNGKey(3)
    shift = np.asarray(jax.random.uniform(key, (256, 1), jnp.float32))
    lrs = dict(jcfg.app.trainer.lrs)

    ja.renderer, ja.opt = jm, JAdam(lrs)
    pj = jax.tree.map(jnp.asarray, params)
    pj, sj, mse_j = ja._build_train_step()(
        pj, ja.opt.init(pj), {k: jnp.asarray(v) for k, v in b.items()},
        jnp.float32(0.7), {"density": jpervoxel(jnp.asarray(cnt))}, key)

    opt = TAdam(lrs)
    pt = params_from_jax(params, "cpu")
    pt, st, mse_t = build_alphamask_train_step(tm, opt, tcfg, "cpu")(
        pt, opt.init(pt), {k: _t(v) for k, v in b.items()}, 0.7,
        {"density": params_from_jax(cnt, "cpu") / float(cnt.max())},
        rand_shift=_t(shift))
    np.testing.assert_allclose(float(mse_t), float(mse_j), rtol=1e-5)
    assert_adam_step_close(lrs, sj.mu, params_to_numpy(st.mu), pj,
                           params_to_numpy(pt))


@pytest.fixture(scope="module")
def jax_alphamask_ckpt(scene):
    """A JAX AlphaMask checkpoint: its own set-up (bbox, near-camera mask,
    view counts) with a density ball of radius 0.8 written in."""
    jcfg, _ = both_cfgs(scene, "handoff", "alphamask")
    ja = JAlphaMask(jcfg)
    ja.load_dataset()
    ja.load_model()
    xyz = np.asarray(ja.renderer.grid_xyz())
    ball = np.linalg.norm(xyz, axis=-1) < 0.8
    ja.params = {**ja.params, "density": jnp.asarray(np.where(
        ball, 20.0, -20.0).astype(np.float32)[..., None])}
    path = os.path.join(ja.ckpt_dir(), "last.ckpt")
    ja.save(path)
    return path


def test_coarse_from_jax_alphamask_and_its_step_match_reference(
        scene, jax_alphamask_ckpt):
    """From a JAX alphamask checkpoint the port's Coarse gets JAX's bbox,
    mask cache and kept-ray mask (and so the same batches); one step from
    the same parameters then matches JAX's step. The port's checkpoint of
    that step loads in the JAX Fine and in the port's, which warm-start
    the same SDF from it.

    A ray's first sample lies on the bbox face, where an ulp decides
    whether it is inside: XLA contracts the sampler's multiply-adds into
    FMAs under jit and not in eager mode, so on this scene the JAX step
    (jitted) and JAX's own eager forward differ by 1e-2 in some rays'
    colours wherever the mask is occupied at the face, while the port
    matches the eager forward to 2e-7. The bbox is therefore scaled by 2.5
    (not 1.05) here, which keeps its faces off the mask's occupied cells
    (the ball of radius 0.8, dilated by the mask's 3-voxel max pool)."""
    extra = [f"app.trainer.ckpt={jax_alphamask_ckpt}",
             "app.trainer.world_bound_scale=2.5"]
    jcfg, tcfg = both_cfgs(scene, "handoff", "coarse", extra)
    jc, tc = JCoarse(jcfg), TCoarse(tcfg)
    for app in (jc, tc):
        app.load_dataset()
        app.load_model()
    jg, tg = jc.renderer.geo, tc.renderer.geo
    np.testing.assert_array_equal(tg.xyz_min, jg.xyz_min)
    np.testing.assert_array_equal(tg.xyz_max, jg.xyz_max)
    assert tg.world_size == jg.world_size and tg.n_samples == jg.n_samples
    for a, b in [(tg.mask_cache.density, jg.mask_cache.density),
                 (tg.mask_cache.occ_sup, jg.mask_cache.occ_sup),
                 (tc.renderer._nonempty, jc.renderer._nonempty)]:
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # the kept-ray mask: each sampler holds its filter's rays
    d = tc.train_dataset.all_data
    keep_j = jg.filter_rays_in_maskcache(d["rays_o"], d["rays_d"], 400)
    keep_t = tg.filter_rays_in_maskcache(d["rays_o"], d["rays_d"], 400)
    assert 0 < keep_t.sum() < len(keep_t)
    for app, keep in ((jc, keep_j), (tc, keep_t)):
        np.testing.assert_array_equal(np.sort(app.sampler.data_idxs),
                                      np.nonzero(keep)[0])
    # the masks agree except on rays whose only occupied samples lie on a
    # face, where the inside test is decided by an ulp
    flip = np.nonzero(keep_t != keep_j)[0]
    assert len(flip) <= 2e-3 * len(keep_t), flip
    assert face_decided(tg, d["rays_o"][flip], d["rays_d"][flip]).all()

    # one step each from JAX's parameters on JAX's batch
    params = jax.tree.map(np.asarray, jc.params)
    tc.params = params_from_jax(params, "cpu")
    tc.opt_state = tc.opt.init(tc.params)
    bj = jc.sampler.sample()
    bt = {k: v.copy() for k, v in bj.items()}
    s_val = jc.s_val_at(0)
    jc.params, jc.opt_state, aux_j = jc._build_train_step()(
        jax.tree.map(jnp.asarray, params), jc.opt_state,
        {k: jnp.asarray(v) for k, v in bj.items()}, jnp.float32(s_val),
        {k: jnp.float32(1.0) for k in jc.lrs}, jnp.float32(1.0),
        jnp.float32(jc.tvs["sdf"]), jnp.float32(jc.tvs["smooth_grad"]))
    tc.params, tc.opt_state, aux_t = build_coarse_train_step(
        tc.renderer, tc.opt, tcfg, "cpu")(
        tc.params, tc.opt_state, tc.place_batch(bt), s_val,
        dict(tc.lr_scales), 1.0, float(tc.tvs["sdf"]),
        float(tc.tvs["smooth_grad"]))
    np.testing.assert_allclose(float(aux_t[0]), float(aux_j[0]), rtol=1e-5)
    assert float(aux_t[1]) == float(aux_j[1]) == 0.0
    assert_adam_step_close(jc.lrs, jc.opt_state.mu,
                           params_to_numpy(tc.opt_state.mu), jc.params,
                           params_to_numpy(tc.params))

    # the port's coarse checkpoint -> both fine stages
    path = os.path.join(tc.ckpt_dir(), "last.ckpt")
    tc.save(path)
    fj, ft = both_cfgs(scene, "handoff_fine", "fine",
                       [f"app.trainer.ckpt={path}"])
    jf, tf = JFine(fj), TFine(ft)
    for app in (jf, tf):
        app.load_dataset()
        app.load_model()
    assert tf.renderer.geo.world_size == jf.renderer.geo.world_size
    np.testing.assert_array_equal(tf.renderer.geo.xyz_min,
                                  jf.renderer.geo.xyz_min)
    # a 125-tap blur summed in another order (as in the fine tests)
    np.testing.assert_allclose(tf.params["sdf"].numpy(),
                               np.asarray(jf.params["sdf"]), rtol=1e-5,
                               atol=1e-5)


# ----------------------------------------------------- the chain, by path


def _rows(app):
    with open(os.path.join(app.cfg.log["dir"], "metrics.jsonl")) as f:
        return [json.loads(ln) for ln in f]


def _assert_eval_files(app, step, mesh):
    d = app.cfg.log["dir"]
    with open(os.path.join(d, "text", f"{step:010}", "mean.txt")) as f:
        mean = f.read()
    for key in ("srgb/PSNR", "srgb/SSIM", "srgb/LPIPS_ALEX"):
        assert key in mean
    img = png.read(os.path.join(d, "image", f"{step:010}", "srgb", "rgb",
                                "000.png"))
    assert img.shape == (40, 40, 3)
    ply = os.path.join(d, "mesh", f"{step:010}", "mesh.ply")
    if mesh:
        with open(ply, "rb") as f:
            head = f.read(200).decode("latin1")
        assert int(head.split("element vertex ")[1].split()[0]) > 0


def test_run_main_chains_alphamask_coarse_fine_on_cpu(scene):
    """Three stages through the port's entry point with one log root and
    name: coarse and fine start from the previous stage's ``last.ckpt``
    by path. Alphamask trains, evaluates and saves; coarse trains with a
    ``decay_steps`` entry at step 1, saves at step 1, resumes to step 3
    and its checkpoint is evaluated (test_nv); fine takes two steps."""
    args = lambda stage, *ov: [
        "-cn", stage_cfg(stage), *common(scene, "chain"), *MICRO[stage],
        "system.device=cpu", "system.tqdm_iters=1", "app.trainer.N_vis=1",
        *ov]
    # density LR x10 so 40 steps reach an occupancy coarse can use
    am = trun.main(args("alphamask", "app.phase=train",
                        "app.trainer.n_iters=40", "app.trainer.lrs.density=1.0"))
    train = [r for r in _rows(am) if "train/metric/srgb/MSE" in r]
    assert [r["step"] for r in train] == list(range(40))
    assert train[-1]["train/metric/srgb/MSE"] < train[0]["train/metric/srgb/MSE"]
    _assert_eval_files(am, 39, mesh=False)
    assert os.path.exists(os.path.join(am.cfg.log["dir"], "checkpoints",
                                       "last.ckpt"))

    ov = ["app.trainer.decay_steps={1: {sdf: 0.5}}",
          "app.trainer.save_every=2", "app.trainer.vis_every=100"]
    co = trun.main(args("coarse", "app.phase=train", "app.trainer.n_iters=2",
                        *ov))
    # the bbox shrunk to alphamask's occupancy
    assert (co.renderer.geo.xyz_max <= am.renderer.xyz_max + 1e-3).all()
    assert (co.renderer.geo.xyz_min >= am.renderer.xyz_min - 1e-3).all()
    ckpt = os.path.join(co.cfg.log["dir"], "checkpoints", "last.ckpt")
    t = tckpt.load_checkpoint(ckpt)["trainer"]
    decay = exp_decay_factor(co.lr_decay)
    assert t["global_step"] == 1
    np.testing.assert_allclose(t["lr_scales"]["sdf"], 0.5 * decay ** 2)
    np.testing.assert_allclose(t["lr_scales"]["off_color"], decay ** 2)
    co2 = trun.main(args("coarse", "app.phase=train", "app.trainer.n_iters=4",
                         *ov))
    assert co2.global_step == 3
    rows = [r for r in _rows(co2) if "train/metric/srgb/MSE" in r]
    assert [r["step"] for r in rows] == [0, 1, 2, 3]
    assert all(r["train/metric/etc/overflow"] == 0.0 for r in rows)
    assert all(np.isfinite(v) for r in _rows(co2) for v in r.values())
    _assert_eval_files(co2, 3, mesh=True)
    ev = trun.main(args("coarse", "app.phase=test_nv",
                        f"app.eval.ckpt={ckpt}"))
    assert ev.global_step == 3 and ev.timings["mesh_verts"] > 0

    fi = trun.main(args("fine", "app.phase=train", "app.trainer.n_iters=2",
                        "app.model.points_budget_per_ray=96"))
    rows = [r for r in _rows(fi) if "train/metric/srgb/MSE" in r]
    assert [r["step"] for r in rows] == [0, 1]
    assert all(np.isfinite(v) for r in rows for v in r.values())
    assert fi.renderer.geo.xyz_min.tolist() == \
        co2.renderer.geo.xyz_min.tolist()
