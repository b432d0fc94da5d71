"""The port's alphamask slice against the JAX package, on the CPU at small
size: the DVGO sampler and weights, the TV loss, the LR helpers, the DVGO
renderer (forwards, the loss's gradients, the near-camera mask and the
view counts). Inputs come from seeded numpy generators; the JAX parameters
are moved across (the two packages' RNGs differ)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esrnerf_tpu.config import load_cfg as jload
from esrnerf_tpu.models.dvgo import DVGO as JDVGO
from esrnerf_tpu.ops import grid as jgrid
from esrnerf_tpu.ops import ray as jray
from esrnerf_tpu.ops import render as jrender
from esrnerf_tpu.ops import tv as jtv
from esrnerf_tpu.optim import exp_decay_factor as jexp_decay
from esrnerf_tpu.optim.adam import make_pervoxel_lr as jpervoxel
from esrnerf_tpu_torch.apps.alphamask import alphamask_loss
from esrnerf_tpu_torch.config import load_cfg as tload
from esrnerf_tpu_torch.models.dvgo import DVGO as TDVGO
from esrnerf_tpu_torch.ops import ray as tray
from esrnerf_tpu_torch.ops import render as trender
from esrnerf_tpu_torch.ops import tv as ttv
from esrnerf_tpu_torch.optim import exp_decay_factor as texp_decay
from esrnerf_tpu_torch.optim import make_pervoxel_lr as tpervoxel
from esrnerf_tpu_torch.utils.convert import params_from_jax
from test_torch_common import REPO, rays

pytestmark = pytest.mark.quick

# cfg/app/alphamask.yaml cut to CPU size: 20^3 voxels
OVERRIDES = ["app.phase=train", "data.cls=x", "data.root=x", "data.scene=x",
             "app.model.num_voxels=8000", "system.compute_dtype=float32",
             "system.mesh_axes=[]"]
NEAR, FAR = 0.5, 4.0
LO, HI = [-1.0, -1.0, -1.0], [1.0, 1.0, 1.0]


def dvgo_rays(n=64, seed=0):
    """The bench's rays toward the ball, with four that miss the bbox and
    four with a zero direction component."""
    b = rays(n, seed)
    b["rays_o"][:4] = [3.0, 0.0, 0.0]
    b["rays_d"][:4] = [0.0, 1.0, 0.3]
    b["rays_d"][4:8, 1] = 0.0
    b["viewdirs"] = (b["rays_d"] / np.linalg.norm(
        b["rays_d"], axis=-1, keepdims=True)).astype(np.float32)
    return b


@pytest.fixture(scope="module")
def models():
    jcfg = jload("cfg/app/alphamask.yaml", OVERRIDES, root_dir=REPO)
    tcfg = tload("cfg/app/alphamask.yaml", OVERRIDES, root_dir=REPO)
    jm = JDVGO(jcfg, NEAR, FAR, LO, HI)
    tm = TDVGO(tcfg, NEAR, FAR, LO, HI, device="cpu")
    assert tm.world_size == jm.world_size == (20, 20, 20)
    assert tm.n_samples == jm.n_samples
    assert tm.voxel_size == jm.voxel_size and tm.act_shift == jm.act_shift
    params = jax.tree.map(np.asarray, jm.init_params())
    rng = np.random.default_rng(11)
    # around the -act_shift (13.8) that gives alpha 1/2 at interval 1
    params["density"] = rng.normal(12.0, 3.0, params["density"].shape
                                   ).astype(np.float32)
    for g in ("off_color", "emo_color"):
        params[g] = rng.normal(size=params[g].shape).astype(np.float32)
    return jm, tm, params


def _t(x):
    return torch.as_tensor(np.asarray(x))


# -------------------------------------------------------------- stateless


def test_sample_rays_dvgo_and_max_samples_match_reference():
    b = dvgo_rays()
    shift = np.random.default_rng(1).uniform(size=(64, 1)).astype(np.float32)
    lo, hi = np.asarray(LO, np.float32), np.asarray(HI, np.float32)
    for rs in (None, shift):
        pj, oj = jray.sample_rays_dvgo(
            jnp.asarray(b["rays_o"]), jnp.asarray(b["rays_d"]),
            jnp.asarray(lo), jnp.asarray(hi), NEAR, FAR, 0.5, 0.1, 73,
            rand_shift=None if rs is None else jnp.asarray(rs))
        pt, ot = tray.sample_rays_dvgo(
            _t(b["rays_o"]), _t(b["rays_d"]), _t(lo), _t(hi), NEAR, FAR, 0.5,
            0.1, 73, rand_shift=None if rs is None else _t(rs))
        # XLA:CPU contracts |d|'s multiply-adds into FMAs, torch does
        # not: points within an ulp, and the mask equal wherever a point
        # is not within 1e-6 of a bbox face
        pj, oj = np.asarray(pj), np.asarray(oj)
        np.testing.assert_allclose(pt.numpy(), pj, rtol=1e-6, atol=1e-6)
        edge = (np.abs(np.abs(pj) - 1.0) < 1e-6).any(-1)
        np.testing.assert_array_equal(ot.numpy()[~edge], oj[~edge])
        assert ot[:4].all() and not ot.all()
    for args in [(LO, HI, 0.1, 0.5), ([-1, -2, 0], [3, 1, 0.5], 0.037, 0.5)]:
        assert tray.max_samples_along_diag(*args) == \
            jray.max_samples_along_diag(*args)


def test_ray_marching_weights_dvgo_matches_reference():
    rng = np.random.default_rng(2)
    alpha = rng.uniform(0, 0.3, (64, 73)).astype(np.float32)
    alpha[rng.uniform(size=alpha.shape) < 0.3] = 0.0
    alpha[5, 10] = 1.0  # clamps 1 - alpha to 1e-10
    wj, cj = jrender.ray_marching_weights_dvgo(jnp.asarray(alpha))
    a = _t(alpha).requires_grad_(True)
    wt, ct = trender.ray_marching_weights_dvgo(a)
    # 73-long cumulative products in another association: rtol 1e-5
    np.testing.assert_allclose(wt.detach().numpy(), np.asarray(wj),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(ct.detach().numpy(), np.asarray(cj),
                               rtol=1e-5, atol=1e-7)
    assert ct.shape == (64, 74)
    # gradient of a weighted sum of both outputs
    cw = rng.normal(size=(64, 73)).astype(np.float32)
    cc = rng.normal(size=(64, 74)).astype(np.float32)
    gj = jax.grad(lambda x: (jrender.ray_marching_weights_dvgo(x)[0] * cw).sum()
                  + (jrender.ray_marching_weights_dvgo(x)[1] * cc).sum())(
        jnp.asarray(alpha))
    ((wt * _t(cw)).sum() + (ct * _t(cc)).sum()).backward()
    scale = np.abs(np.asarray(gj)).max()
    np.testing.assert_allclose(a.grad.numpy(), np.asarray(gj), rtol=1e-4,
                               atol=1e-5 * scale)


@pytest.mark.parametrize("masked", [False, True])
def test_total_variation_and_its_gradient_match_reference(masked):
    rng = np.random.default_rng(3)
    v = rng.normal(size=(9, 7, 11, 3)).astype(np.float32)
    mask = rng.uniform(size=(9, 7, 11)) < 0.6 if masked else None
    jf = lambda x: jtv.total_variation(
        x, None if mask is None else jnp.asarray(mask))
    vt = _t(v).requires_grad_(True)
    got = ttv.total_variation(vt, None if mask is None else _t(mask))
    # sums of ~2,000 terms in another order
    np.testing.assert_allclose(float(got), float(jf(jnp.asarray(v))),
                               rtol=1e-5)
    got.backward()
    np.testing.assert_allclose(vt.grad.numpy(),
                               np.asarray(jax.grad(jf)(jnp.asarray(v))),
                               rtol=1e-5, atol=1e-9)
    # on a grid with flat runs the gradient at |0| is the reference's +1
    z = np.zeros((4, 3, 5, 1), np.float32)
    z[2:] = 1.0
    zt = _t(z).requires_grad_(True)
    ttv.total_variation(zt, None if mask is None else _t(mask[:4, :3, :5]))\
        .backward()
    np.testing.assert_allclose(zt.grad.numpy(), np.asarray(jax.grad(
        lambda x: jtv.total_variation(
            x, None if mask is None else jnp.asarray(mask[:4, :3, :5])))(
        jnp.asarray(z))), rtol=1e-5)
    assert zt.grad.abs().sum() > 0
    if masked:  # an empty mask divides by 1
        empty = np.zeros((9, 7, 11), bool)
        assert float(ttv.total_variation(_t(v), _t(empty))) == \
            float(jtv.total_variation(jnp.asarray(v), jnp.asarray(empty))) \
            == 0.0


def test_lr_helpers_match_reference():
    assert texp_decay(20) == jexp_decay(20)
    cnt = np.random.default_rng(4).integers(0, 9, (5, 6, 7, 1)).astype(
        np.float32)
    np.testing.assert_array_equal(tpervoxel(_t(cnt)).numpy(),
                                  np.asarray(jpervoxel(jnp.asarray(cnt))))


# ------------------------------------------------------------------- DVGO


def test_forward_training_matches_reference(models):
    jm, tm, params = models
    b = dvgo_rays(seed=5)
    shift = np.random.default_rng(6).uniform(size=(64, 1)).astype(np.float32)
    oj = jm.forward_training(jax.tree.map(jnp.asarray, params),
                             jnp.asarray(b["rays_o"]), jnp.asarray(b["rays_d"]),
                             jnp.asarray(b["em_modes"]), None,
                             rand_shift=jnp.asarray(shift))
    ot = tm.forward_training(params_from_jax(params, "cpu"), _t(b["rays_o"]),
                             _t(b["rays_d"]), _t(b["em_modes"]),
                             rand_shift=_t(shift))
    assert ot.keys() == oj.keys()
    # sigmoid/softplus/exp to a few ulps, a 73-long cumprod: rtol 1e-5
    for k in oj:
        np.testing.assert_allclose(ot[k].detach().numpy(), np.asarray(oj[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    w = np.asarray(oj["etc/weights"])
    assert (w[:4] == 0).all() and w.max() > 0.05  # misses and opaque spots


@pytest.mark.parametrize("em", [0, 1])
def test_forward_evaluate_matches_reference(models, em):
    jm, tm, params = models
    b = dvgo_rays(seed=7)
    oj = jm.forward_evaluate(jax.tree.map(jnp.asarray, params),
                             jnp.asarray(b["rays_o"]), jnp.asarray(b["rays_d"]),
                             jnp.int32(em))
    ot = tm.forward_evaluate(params_from_jax(params, "cpu"), _t(b["rays_o"]),
                             _t(b["rays_d"]), em)
    assert ot.keys() == oj.keys()
    for k in oj:
        np.testing.assert_allclose(ot[k].numpy(), np.asarray(oj[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)


def _jax_alphamask_loss(model, p, batch, shift, w_ent, w_rgbper, white_bg):
    """The loss of ``esrnerf_tpu/apps/alphamask.py:157-179`` on one device
    with the rays' shifts given."""
    res = model.forward_training(p, batch["rays_o"], batch["rays_d"],
                                 batch["em_modes"], None, rand_shift=shift)
    pred = jnp.clip(res["srgb/rgb"] + res["etc/white_bg"] * white_bg, 0, 1)
    mse = jnp.mean((pred - batch["rgbs"]) ** 2)
    pout = jnp.clip(res["etc/alphainv_cum"][..., -1], 1e-6, 1 - 1e-6)
    ent = jnp.mean(-(pout * jnp.log(pout) + (1 - pout) * jnp.log(1 - pout)))
    rgbper = ((res["srgb/raw_rgb"] - batch["rgbs"][:, None, :]) ** 2).sum(-1)
    rgbper_loss = jnp.mean(
        (rgbper * jax.lax.stop_gradient(res["etc/weights"])).sum(-1))
    return mse + w_ent * ent + w_rgbper * rgbper_loss, mse


def test_alphamask_loss_gradients_match_jax_grad(models):
    """Loss and every group's gradient; the grid gradients go through the
    splat's plain version here and K-3 on the card."""
    jm, tm, params = models
    b = dvgo_rays(seed=8)
    shift = np.random.default_rng(9).uniform(size=(64, 1)).astype(np.float32)
    kw = dict(w_ent=0.01, w_rgbper=0.1, white_bg=1.0)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    (lj, mj), gj = jax.value_and_grad(
        lambda p: _jax_alphamask_loss(jm, p, jb, jnp.asarray(shift), **kw),
        has_aux=True)(jax.tree.map(jnp.asarray, params))
    pt = {k: v.requires_grad_(True) for k, v in
          params_from_jax(params, "cpu").items()}
    lt, mt = alphamask_loss(tm, pt, {k: _t(v) for k, v in b.items()},
                            rand_shift=_t(shift), **kw)
    lt.backward()
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-5)
    np.testing.assert_allclose(float(mt), float(mj), rtol=1e-5)
    # per group: within 1e-4 of the group's largest |g| (scatter-adds of
    # ~4,700 points in another order)
    for g in params:
        want = np.asarray(gj[g])
        scale = np.abs(want).max()
        assert scale > 0, g
        np.testing.assert_allclose(pt[g].grad.numpy(), want, rtol=0,
                                   atol=1e-4 * scale, err_msg=g)


def test_maskout_near_cam_vox_matches_reference(models):
    jm, tm, params = models
    cams = np.asarray([[0.0, 0.0, 1.2], [-0.9, 0.8, 0.0], [2.0, 2.0, 2.0]],
                      np.float32)
    pj = jm.maskout_near_cam_vox(jax.tree.map(jnp.asarray, params),
                                 jnp.asarray(cams))
    pt = tm.maskout_near_cam_vox(params_from_jax(params, "cpu"), _t(cams))
    # jnp.linspace's lo * (1 - t) + hi * t is an FMA on XLA:CPU: the voxel
    # centres within an ulp, the mask equal away from the near sphere
    xyz = np.asarray(jm.grid_xyz())
    np.testing.assert_allclose(tm.grid_xyz().numpy(), xyz, rtol=0, atol=1e-7)
    dist = np.sqrt(((xyz[..., None, :] - cams) ** 2).sum(-1)).min(-1)
    far = np.abs(dist - jm.near) > 1e-5
    d = pt["density"].numpy()
    np.testing.assert_array_equal(d[far], np.asarray(pj["density"])[far])
    assert 0 < (d == -100.0).sum() < d.size
    np.testing.assert_array_equal(pt["off_color"].numpy(), params["off_color"])


def _camera_views(n_img=3, n_px=400, seed=10):
    """``[n_img, n_px, 3]`` rays: per view, one camera on a radius-2.5
    shell and rays toward random targets in the bbox."""
    rng = np.random.default_rng(seed)
    ro, rd = [], []
    for _ in range(n_img):
        c = rng.normal(size=3)
        c = c / np.linalg.norm(c) * 2.5
        tgt = rng.uniform(-0.8, 0.8, (n_px, 3))
        ro.append(np.broadcast_to(c, (n_px, 3)))
        rd.append(tgt - c)
    return (np.asarray(ro, np.float32), np.asarray(rd, np.float32))


def test_voxel_count_views_matches_reference_by_the_band_rule(models):
    """Per view, the summed splat weight ``w`` within rtol 1e-5 of JAX's; the
    counts (views with ``w > 1``) equal wherever every view's ``|w - 1|``
    exceeds 1e-4. Sums in another order can move ``w`` across 1 inside
    that band; the test reports how many voxels fall in it."""
    jm, tm, _ = models
    ro, rd = _camera_views()
    mn, mx = jnp.asarray(jm.xyz_min), jnp.asarray(jm.xyz_max)

    def jax_w(ro_img, rd_img):
        pts, _ = jray.sample_rays_dvgo(
            jnp.asarray(ro_img), jnp.asarray(rd_img), mn, mx, jm.near, jm.far,
            jm.stepsize, jm.voxel_size, jm.n_samples)
        ones = jnp.ones((*jm.world_size, 1), jnp.float32)
        return np.asarray(jax.grad(
            lambda g: jgrid.grid_sample_3d(g, pts, mn, mx).sum())(ones))

    band = np.zeros(jm.world_size + (1,), bool)
    for i in range(len(ro)):
        wt = tm.view_weights(ro[i], rd[i], 150).numpy()
        wj = jax_w(ro[i], rd[i])
        # hundreds of trilinear weights per voxel summed in another order
        # at points an ulp apart (the FMA in |d|): rtol 1e-5
        np.testing.assert_allclose(wt, wj, rtol=1e-5, atol=1e-6)
        band |= (np.abs(wt - 1) <= 1e-4) | (np.abs(wj - 1) <= 1e-4)
    cj = np.asarray(jm.voxel_count_views(ro, rd, 150))
    ct = tm.voxel_count_views(ro, rd, 150).numpy()
    print(f"voxel_count_views: {int(band.sum())} of {band.size} voxels "
          "within 1e-4 of w = 1")
    assert 0 < (cj > 0).sum() and (cj == len(ro)).sum() > 0
    np.testing.assert_array_equal(ct[~band], cj[~band])
