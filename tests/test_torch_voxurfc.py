"""The port's coarse-stage renderer against the JAX package, on the CPU at
small size: VoxurfC's training and eval forwards, its TV terms and their
gradients, the coarse step's per-group gradients, the bbox from the
alphamask density, the DVGO-style training-ray filter, and the entropy
term's last-ray quirk. The JAX parameters are moved across."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esrnerf_tpu.apps.coarse import Coarse as JCoarse
from esrnerf_tpu.apps.coarse import \
    compute_bbox_by_coarse_geo as jbbox
from esrnerf_tpu.config import load_cfg as jload
from esrnerf_tpu.models import voxurf_base as jvb
from esrnerf_tpu.models.voxurfc import VoxurfC as JVoxurfC
from esrnerf_tpu_torch.apps.alphamask import entropy_last
from esrnerf_tpu_torch.apps.coarse import build_coarse_train_step, coarse_loss
from esrnerf_tpu_torch.apps.coarse import \
    compute_bbox_by_coarse_geo as tbbox
from esrnerf_tpu_torch.config import load_cfg as tload
from esrnerf_tpu_torch.models import voxurf_base as tvb
from esrnerf_tpu_torch.models.voxurfc import VoxurfC as TVoxurfC
from esrnerf_tpu_torch.utils.convert import params_from_jax
from test_torch_common import REPO, ball_density, rays

pytestmark = pytest.mark.quick

# cfg/app/coarse.yaml cut to CPU size: 32^3 voxels, 32-wide heads of the
# stage's depth 3, f32 heads; the stage's budgets and per-sample phase 1
OVERRIDES = ["app.phase=train", "data.cls=x", "data.root=x", "data.scene=x",
             "app.model.num_voxels=32768", "app.model.rgbnet_width=32",
             "system.compute_dtype=float32", "system.mesh_axes=[]"]
S_VAL = 20.0
KW = dict(w_ent=0.001, w_tvd=0.001, w_tvc=0.01, white_bg=1.0)
GROUPS = ("sdf", "off_color", "emo_color", "off_rgbnet", "emo_rgbnet")


def load_cfgs(extra=()):
    ov = OVERRIDES + list(extra)
    return (jload("cfg/app/coarse.yaml", ov, root_dir=REPO),
            tload("cfg/app/coarse.yaml", ov, root_dir=REPO))


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = load_cfgs()
    dens = ball_density()
    jmc = jvb.make_mask_cache(dens, [-1] * 3, [1] * 3, 1e-6, 1e-3, 3)
    tmc = tvb.make_mask_cache(dens, [-1] * 3, [1] * 3, 1e-6, 1e-3, 3,
                              device="cpu")
    jm = JVoxurfC(jcfg, 0.5, 4.0, [-1] * 3, [1] * 3, jmc, S_VAL)
    tm = TVoxurfC(tcfg, 0.5, 4.0, [-1] * 3, [1] * 3, tmc, S_VAL)
    assert tm.geo.world_size == jm.geo.world_size == (32, 32, 32)
    assert tm.geo.phase1_block == 1 and tm.dim0 == jm.dim0
    np.testing.assert_array_equal(tm._nonempty.numpy(),
                                  np.asarray(jm._nonempty))
    params = jax.tree.map(np.asarray, jm.init_params(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(7)
    X, Y, Z = jm.geo.world_size
    x, y, z = np.mgrid[-1:1:X * 1j, -1:1:Y * 1j, -1:1:Z * 1j]
    r = np.sqrt(x**2 + y**2 + z**2)
    params["sdf"] = (r - 0.5 + rng.normal(scale=0.03, size=r.shape)
                     ).astype(np.float32)[..., None]
    for g in ("off_color", "emo_color"):
        params[g] = rng.normal(scale=0.3, size=params[g].shape).astype(
            np.float32)
    return jm, tm, params


def _t(x):
    return torch.as_tensor(np.asarray(x))


def test_init_params_layout_matches_reference(models):
    jm, tm, _ = models
    pj = jm.init_params(jax.random.PRNGKey(0))
    pt = tm.init_params(torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(pt["sdf"].numpy(), np.asarray(pj["sdf"]))
    for g in ("off_rgbnet", "emo_rgbnet"):
        assert {k: tuple(v.shape) for k, v in pt[g].items()} == \
            {k: tuple(v.shape) for k, v in pj[g].items()}
        last = f"b{len(pt[g]) // 2 - 1}"
        assert not pt[g][last].any() and not np.asarray(pj[g][last]).any()


def test_forward_training_matches_reference(models):
    jm, tm, params = models
    b = rays(seed=3)
    oj = jax.jit(jm.forward_training)(
        jax.tree.map(jnp.asarray, params), *(jnp.asarray(b[k]) for k in (
            "rays_o", "rays_d", "viewdirs", "em_modes")), jnp.float32(S_VAL))
    ot = tm.forward_training(
        params_from_jax(params, "cpu"), *(_t(b[k]) for k in (
            "rays_o", "rays_d", "viewdirs", "em_modes")), S_VAL)
    # the port adds its march's counts (what a data-parallel step folds)
    assert ot.keys() == oj.keys() | {"etc/counts"}
    assert float(ot["etc/overflow"]) == float(oj["etc/overflow"]) == 0.0
    # the budget utilisations within an ulp (XLA's reciprocal multiply)
    for k in ("etc/k1_frac", "etc/k2_frac"):
        np.testing.assert_allclose(float(ot[k]), float(oj[k]), rtol=1e-6,
                                   err_msg=k)
    # the march's alphas at rtol 1e-4 (XLA:CPU's tanh sigmoid), the heads'
    # sigmoids and the segment sums after them
    for k in ("etc/alphainv_cum", "etc/white_bg", "srgb/rgb"):
        np.testing.assert_allclose(ot[k].detach().numpy(), np.asarray(oj[k]),
                                   rtol=1e-4, atol=1e-5, err_msg=k)
    assert float(np.asarray(oj["etc/white_bg"]).min()) < 0.5


@pytest.mark.parametrize("em", [0, 1])
def test_forward_evaluate_matches_reference(models, em):
    jm, tm, params = models
    b = rays(seed=4)
    rot = np.asarray([[0.0, 0.6, 0.8], [1.0, 0.0, 0.0], [0.0, 0.8, -0.6]],
                     np.float32)
    oj = jax.jit(jm.forward_evaluate)(
        jax.tree.map(jnp.asarray, params), *(jnp.asarray(b[k]) for k in (
            "rays_o", "rays_d", "viewdirs")), jnp.int32(em), jnp.asarray(rot),
        jnp.float32(S_VAL))
    ot = tm.forward_evaluate(
        params_from_jax(params, "cpu"), *(_t(b[k]) for k in (
            "rays_o", "rays_d", "viewdirs")), em, _t(rot), S_VAL)
    assert ot.keys() == oj.keys()
    for k in oj:
        np.testing.assert_allclose(ot[k].numpy(), np.asarray(oj[k]),
                                   rtol=1e-4, atol=1e-5, err_msg=k)


def test_tv_terms_and_their_gradients_match_reference(models):
    jm, tm, params = models
    jp = jax.tree.map(jnp.asarray, params)
    pt = {k: v.requires_grad_(True) for k, v in
          params_from_jax(params, "cpu").items() if not isinstance(v, dict)}
    for name, jf, tf in [
        ("density", lambda p: jm.density_total_variation(p, 0.1, 0.05),
         lambda p: tm.density_total_variation(p, 0.1, 0.05)),
        ("color", jm.color_total_variation, tm.color_total_variation),
    ]:
        vj, gj = jax.jit(jax.value_and_grad(jf))(jp)
        vt = tf(pt)
        # masked means over ~30,000 terms summed in another order
        np.testing.assert_allclose(float(vt), float(vj), rtol=1e-5,
                                   err_msg=name)
        gt = torch.autograd.grad(vt, [pt[g] for g in ("sdf", "off_color",
                                                      "emo_color")],
                                 allow_unused=True)
        for g, got in zip(("sdf", "off_color", "emo_color"), gt):
            want = np.asarray(gj[g])
            if not np.abs(want).max():
                assert got is None or not got.any(), (name, g)
                continue
            np.testing.assert_allclose(
                got.numpy(), want, rtol=1e-4,
                atol=1e-6 * np.abs(want).max(), err_msg=f"{name} {g}")


class _GradsOut:
    """Optimizer stand-in whose step returns the gradients it is given."""

    def step(self, params, grads, state, lr_scales=None):
        return grads, state


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree)}


def test_coarse_step_gradients_match_reference(models):
    """The JAX ``Coarse`` step body and the port's on one batch with the TV
    terms on: the loss terms, and every group's gradient within 1e-4 of the
    group's largest |g| (scatter-adds in another order)."""
    jm, tm, params = models
    b = rays(seed=5)
    jcfg, tcfg = load_cfgs()
    jc = JCoarse(jcfg)
    jc.renderer, jc.opt = jm, _GradsOut()
    jstep = jc._build_train_step()
    scales = {g: 1.0 for g in GROUPS}
    gj, _, aux_j = jstep(jax.tree.map(jnp.asarray, params), None,
                         {k: jnp.asarray(v) for k, v in b.items()},
                         jnp.float32(S_VAL),
                         {k: jnp.float32(1.0) for k in scales},
                         jnp.float32(1.0), jnp.float32(0.1),
                         jnp.float32(0.05))
    tstep = build_coarse_train_step(tm, _GradsOut(), tcfg, device="cpu")
    gt, _, aux_t = tstep(params_from_jax(params, "cpu"), None,
                         {k: _t(v) for k, v in b.items()}, S_VAL, scales,
                         1.0, 0.1, 0.05)
    np.testing.assert_allclose(float(aux_t[0]), float(aux_j[0]), rtol=1e-5)
    assert float(aux_t[1]) == float(aux_j[1]) == 0.0
    # under jit XLA divides the survivor counts by the constant budgets as
    # a multiply by their reciprocals: within an ulp
    np.testing.assert_allclose([float(a) for a in aux_t[2:]],
                               [float(a) for a in aux_j[2:]], rtol=1e-6)
    for grp in GROUPS:
        lj, lt = _leaves(gj[grp]), _leaves(gt[grp])
        scale = max(np.abs(v).max() for v in lj.values())
        assert scale > 0, grp
        for k in lj:
            np.testing.assert_allclose(lt[k], lj[k], rtol=0,
                                       atol=1e-4 * scale, err_msg=f"{grp}{k}")


def test_entropy_term_reads_the_last_ray_only(models):
    """As in the reference, the entropy term is the binary entropy of the
    batch's last ray's transmittance: rays before it change the loss only
    through the MSE."""
    _, tm, params = models
    b = {k: _t(v) for k, v in rays(seed=6).items()}
    p = params_from_jax(params, "cpu")
    # the batch's last ray: one that grazes the surface (an informative
    # entropy)
    with torch.no_grad():
        t = tm.forward_training(p, b["rays_o"], b["rays_d"], b["viewdirs"],
                                b["em_modes"], S_VAL)["etc/alphainv_cum"]
    i = int(torch.argmin(torch.abs(t - 0.5)))
    order = torch.cat([torch.arange(i), torch.arange(i + 1, len(t)),
                       torch.tensor([i])])
    b = {k: v[order] for k, v in b.items()}
    kw = dict(KW, w_tvd=0.0, w_tvc=0.0)

    def ent(batch):
        with torch.no_grad():
            l1, (mse1, *_) = coarse_loss(tm, p, batch, S_VAL, 0.0, 0.1, 0.05,
                                         **dict(kw, w_ent=1.0))
            l0, (mse0, *_) = coarse_loss(tm, p, batch, S_VAL, 0.0, 0.1, 0.05,
                                         **dict(kw, w_ent=0.0))
        assert float(mse1) == float(mse0)
        return float(l1 - l0)

    res = tm.forward_training(p, b["rays_o"], b["rays_d"], b["viewdirs"],
                              b["em_modes"], S_VAL)
    last = res["etc/alphainv_cum"][-1]
    assert 0.01 < float(last) < 0.99  # a ray with an informative entropy
    np.testing.assert_allclose(ent(b), float(entropy_last(last)), rtol=1e-5)
    # the other rays reversed: the same entropy term
    n = b["rays_o"].shape[0]
    perm = torch.cat([torch.arange(n - 2, -1, -1), torch.tensor([n - 1])])
    np.testing.assert_allclose(ent({k: v[perm] for k, v in b.items()}),
                               ent(b), rtol=1e-5)
    # and a different last ray: another value
    swap = torch.cat([torch.arange(1, n), torch.tensor([0])])
    assert abs(ent({k: v[swap] for k, v in b.items()}) - ent(b)) > 1e-4


def test_compute_bbox_by_coarse_geo_matches_reference():
    rng = np.random.default_rng(8)
    dens = np.full((13, 11, 17, 1), -20.0, np.float32)
    dens[3:9, 2:8, 5:12] = rng.normal(8.0, 4.0, (6, 6, 7, 1))
    lo = np.asarray([-1.2, -0.9, -1.5], np.float32)
    hi = np.asarray([1.1, 0.7, 1.3], np.float32)
    act_shift = float(np.log(1 / (1 - 1e-6) - 1))
    for thres in (1e-3, 0.3):
        want = jbbox(lo, hi, dens, act_shift, thres)
        got = tbbox(lo, hi, dens, act_shift, thres)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    assert (want[0] > lo).any() and (want[1] < hi).any()


def test_dvgo_style_ray_filter_matches_reference(models):
    jm, tm, _ = models
    b = rays(512, seed=9)
    rd = b["rays_d"].copy()
    rd[::4] = -b["rays_o"][::4] * 0.1 + np.array([3.0, 0, 0], np.float32)
    want = jm.geo.filter_rays_in_maskcache(b["rays_o"], rd, 100)
    got = tm.geo.filter_rays_in_maskcache(b["rays_o"], rd, 100)
    assert 0 < want.sum() < len(want)
    np.testing.assert_array_equal(got, want)
    # the default style is DVGO's, as in the reference
    np.testing.assert_array_equal(tm.geo.filter_rays_in_maskcache(
        b["rays_o"], rd, 100, style="dvgo"), got)
