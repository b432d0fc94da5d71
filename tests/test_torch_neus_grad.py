"""The ``neus_alpha: grad`` march path and the flat render helpers against
the JAX package, on the CPU at small size: the grad- and interp-variant
NeuS alphas (dense and flat), the flat transmittance scan and
``segment_mean``, values and VJPs; one VoxurfF fine step and one VoxurfC
coarse step with ``app.model.neus_alpha=grad`` (32^3, 64 rays), and their
eval forwards; the march's mode contract, and ESRNeRF (LTS, PDRA)
refusing the grad variant as the reference's march does. The JAX
parameters are moved across."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esrnerf_tpu.apps.coarse import Coarse as JCoarse
from esrnerf_tpu.apps.fine import Fine as JFine
from esrnerf_tpu.config import load_cfg as jload
from esrnerf_tpu.models import voxurf_base as jvb
from esrnerf_tpu.models.voxurfc import VoxurfC as JVoxurfC
from esrnerf_tpu.models.voxurff import VoxurfF as JVoxurfF
from esrnerf_tpu.ops import render as jr
from esrnerf_tpu_torch.apps.coarse import build_coarse_train_step
from esrnerf_tpu_torch.apps.fine import build_fine_train_step
from esrnerf_tpu_torch.config import load_cfg as tload
from esrnerf_tpu_torch.models import voxurf_base as tvb
from esrnerf_tpu_torch.models.esrnerf import ESRNeRF as TESRNeRF
from esrnerf_tpu_torch.models.voxurfc import VoxurfC as TVoxurfC
from esrnerf_tpu_torch.models.voxurff import VoxurfF as TVoxurfF
from esrnerf_tpu_torch.ops import render as tr
from esrnerf_tpu_torch.utils.convert import params_from_jax, params_to_numpy
from test_torch_common import OVERRIDES as FINE_CPU
from test_torch_common import REPO, ball_density, rays

pytestmark = pytest.mark.quick

GRAD = ["app.model.neus_alpha=grad"]
# cfg/app/coarse.yaml cut to CPU size, as tests/test_torch_voxurfc.py
COARSE_CPU = ["app.phase=train", "data.cls=x", "data.root=x", "data.scene=x",
              "app.model.num_voxels=32768", "app.model.rgbnet_width=32",
              "system.compute_dtype=float32", "system.mesh_axes=[]"]
FINE_GROUPS = ("sdf", "off_color", "emo_color", "off_rgbnet", "emo_rgbnet",
               "tonemapper")
COARSE_GROUPS = ("sdf", "off_color", "emo_color", "off_rgbnet", "emo_rgbnet")


def _t(x):
    return torch.as_tensor(np.asarray(x))


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


def _assert_group_grads(g_t, g_j, groups):
    """Every group's gradient within 1e-4 of the group's largest |g|
    (scatter-adds summed in another order)."""
    for grp in groups:
        lj, lt = _leaves(g_j[grp]), _leaves(g_t[grp])
        assert lj.keys() == lt.keys()
        scale = max(np.abs(v).max() for v in lj.values())
        assert scale > 0, grp
        for k in lj:
            err = np.abs(lt[k] - lj[k]).max() / scale
            assert err <= 1e-4, (grp, k, err)


def _surface_params(tm, seed=7):
    """The port's ``init_params`` (the same tree as JAX's) as numpy, with a
    noisy sphere SDF inside the occupancy ball and nonzero colour grids,
    so every group gets a real gradient."""
    params = params_to_numpy(tm.init_params(torch.Generator().manual_seed(0)))
    rng = np.random.default_rng(seed)
    X, Y, Z = tm.geo.world_size
    x, y, z = np.mgrid[-1:1:X * 1j, -1:1:Y * 1j, -1:1:Z * 1j]
    r = np.sqrt(x**2 + y**2 + z**2)
    params["sdf"] = (r - 0.5 + rng.normal(scale=0.03, size=r.shape)
                     ).astype(np.float32)[..., None]
    for g in ("off_color", "emo_color"):
        params[g] = rng.normal(scale=0.3, size=params[g].shape).astype(
            np.float32)
    return params


@pytest.fixture(scope="module")
def mask_caches():
    dens = ball_density()
    return (jvb.make_mask_cache(dens, [-1] * 3, [1] * 3, 1e-6, 1e-3, 3),
            tvb.make_mask_cache(dens, [-1] * 3, [1] * 3, 1e-6, 1e-3, 3,
                                device="cpu"))


# ------------------------------------------------------- the render helpers


def _flat_case(seed=0, n_rays=12, n_steps=20):
    """A flat compacted list in ray-major order with holes, an empty ray,
    runs of one entry and pads (``ray_id == n_rays``, alpha 0) at the
    end."""
    rng = np.random.default_rng(seed)
    ray, step = [], []
    for r_ in range(n_rays):
        if r_ == 3:
            continue  # a ray with no entry
        k = 1 if r_ == 5 else int(rng.integers(2, n_steps))
        s = np.sort(rng.choice(n_steps, k, replace=False))
        ray += [r_] * k
        step += list(s)
    n_pad = 7
    ray = np.asarray(ray + [n_rays] * n_pad, np.int32)
    step = np.asarray(step + [0] * n_pad, np.int32)
    K = len(ray)
    valid = (rng.random(K) < 0.8) & (ray < n_rays)
    return {
        "ray": ray, "step": step, "valid": valid,
        "sdf": rng.normal(scale=0.05, size=K).astype(np.float32),
        "grad": rng.normal(size=(K, 3)).astype(np.float32),
        "vd": rng.normal(size=(K, 3)).astype(np.float32),
        "alpha": np.where(ray < n_rays, rng.uniform(0, 0.6, K), 0.0).astype(
            np.float32),
        "n_rays": n_rays, "n_steps": n_steps,
    }


def _vjp_pair(jf, tf, args, ct, argnums):
    """Values and VJPs (w.r.t. ``argnums`` of ``args``) of the JAX and the
    port function on the same numpy inputs and cotangent ``ct``."""
    out_j, vjp = jax.vjp(jax.jit(lambda *a: jf(*[
        a[argnums.index(i)] if i in argnums else jnp.asarray(x)
        for i, x in enumerate(args)])),
        *[jnp.asarray(args[i]) for i in argnums])
    gj = vjp(jnp.asarray(ct))
    tin = [_t(x) for x in args]
    for i in argnums:
        tin[i] = tin[i].clone().requires_grad_(True)
    out_t = tf(*tin)
    gt = torch.autograd.grad(out_t, [tin[i] for i in argnums], _t(ct))
    return (np.asarray(out_j), out_t.detach().numpy(),
            [np.asarray(g) for g in gj], [g.numpy() for g in gt])


@pytest.mark.parametrize("dense_views", [False, True])
def test_neus_alpha_grad_matches_reference(dense_views):
    """Dense grad-variant alpha, view directions ``[N, 3]`` broadcast or
    ``[N, S, 3]``: values and the VJP to sdf and gradients. rtol 1e-5 /
    atol 1e-6: the sigmoid is XLA's own expansion, the rest the same float
    operations."""
    rng = np.random.default_rng(1)
    N, S = 16, 24
    sdf = rng.normal(scale=0.05, size=(N, S)).astype(np.float32)
    grads = rng.normal(size=(N, S, 3)).astype(np.float32)
    vd = rng.normal(size=(N, S, 3) if dense_views else (N, 3)).astype(
        np.float32)
    mask = rng.random((N, S)) < 0.7
    ct = rng.normal(size=(N, S)).astype(np.float32)
    vj, vt, gj, gt = _vjp_pair(
        lambda s, g, v, m: jr.neus_alpha_grad(s, g, v, 0.02, m, 40.0),
        lambda s, g, v, m: tr.neus_alpha_grad(s, g, v, 0.02, m, 40.0),
        [sdf, grads, vd, mask], ct, [0, 1])
    assert (vt[~mask] == 0).all() and vt[mask].max() > 0.01
    np.testing.assert_allclose(vt, vj, rtol=1e-5, atol=1e-6)
    for a, b in zip(gt, gj):
        np.testing.assert_allclose(a, b, rtol=1e-5,
                                   atol=1e-6 * np.abs(b).max())


def test_neus_alpha_grad_flat_matches_reference():
    c = _flat_case(2)
    ct = np.random.default_rng(3).normal(size=c["sdf"].shape).astype(
        np.float32)
    vj, vt, gj, gt = _vjp_pair(
        lambda s, g, v, m: jr.neus_alpha_grad_flat(s, g, v, 0.02, m, 40.0),
        lambda s, g, v, m: tr.neus_alpha_grad_flat(s, g, v, 0.02, m, 40.0),
        [c["sdf"], c["grad"], c["vd"], c["valid"]], ct, [0, 1, 2])
    np.testing.assert_allclose(vt, vj, rtol=1e-5, atol=1e-6)
    for a, b in zip(gt, gj):
        np.testing.assert_allclose(a, b, rtol=1e-5,
                                   atol=1e-6 * np.abs(b).max())


def test_neus_alpha_interp_flat_matches_reference():
    """Each valid entry pairs with the next / previous valid entry of its
    own ray, holes skipped; single entries and ray ends pair with
    themselves. Against the JAX function and against the dense variant on
    the scattered layout."""
    c = _flat_case(4)
    ct = np.random.default_rng(5).normal(size=c["sdf"].shape).astype(
        np.float32)
    vj, vt, gj, gt = _vjp_pair(
        lambda s, r, m: jr.neus_alpha_interp_flat(s, r, m, 30.0),
        lambda s, r, m: tr.neus_alpha_interp_flat(s, r, m, 30.0),
        [c["sdf"], c["ray"], c["valid"]], ct, [0])
    np.testing.assert_allclose(vt, vj, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(gt[0], gj[0], rtol=1e-5,
                               atol=1e-6 * np.abs(gj[0]).max())
    # the dense variant on the (ray, step) layout gives the same alphas
    n, s = c["n_rays"], c["n_steps"]
    live = c["ray"] < n
    sdf_d = np.zeros((n, s), np.float32)
    val_d = np.zeros((n, s), bool)
    sdf_d[c["ray"][live], c["step"][live]] = c["sdf"][live]
    val_d[c["ray"][live], c["step"][live]] = c["valid"][live]
    dense = tr.neus_alpha_interp(_t(sdf_d), _t(val_d), 30.0).numpy()
    np.testing.assert_array_equal(vt[live],
                                  dense[c["ray"][live], c["step"][live]])


@pytest.mark.parametrize("early_exit", [1e-3, None])
def test_alpha2weights_flat_matches_reference(early_exit):
    """The flat scan through the dense bridge: weights and ``alphainv_last``
    (1 on the empty ray) and their VJP to the alphas, against the JAX
    function (its scan's plain version on the CPU). Values rtol 1e-6 (the
    products in another association); the VJP atol 1e-6 of its max."""
    c = _flat_case(6)
    rng = np.random.default_rng(7)
    ct_w = rng.normal(size=c["alpha"].shape).astype(np.float32)
    ct_l = rng.normal(size=(c["n_rays"],)).astype(np.float32)
    n, s = c["n_rays"], c["n_steps"]
    args = (jnp.asarray(c["ray"]), jnp.asarray(c["step"]))
    (wj, lj), vjp = jax.vjp(jax.jit(lambda a: jr.alpha2weights_flat(
        a, *args, n, s, early_exit)), jnp.asarray(c["alpha"]))
    (gj,) = vjp((jnp.asarray(ct_w), jnp.asarray(ct_l)))
    a = _t(c["alpha"]).requires_grad_(True)
    wt, lt = tr.alpha2weights_flat(a, _t(c["ray"]).long(),
                                   _t(c["step"]).long(), n, s, early_exit)
    (gt,) = torch.autograd.grad((wt, lt), a, (_t(ct_w), _t(ct_l)))
    wt, lt = wt.detach(), lt.detach()
    assert float(lt[3]) == 1.0 == float(lj[3])
    np.testing.assert_allclose(wt.detach().numpy(), np.asarray(wj),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(lt.detach().numpy(), np.asarray(lj),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=0,
                               atol=1e-6 * np.abs(np.asarray(gj)).max())


@pytest.mark.parametrize("channels", [None, 3])
def test_segment_mean_matches_reference(channels):
    rng = np.random.default_rng(8)
    shape = (9, 13) if channels is None else (9, 13, channels)
    v = rng.normal(size=shape).astype(np.float32)
    w = rng.random((9, 13)).astype(np.float32)
    ct = rng.normal(size=(9,) if channels is None else (9, channels)).astype(
        np.float32)
    vj, vt, gj, gt = _vjp_pair(jr.segment_mean, tr.segment_mean, [v, w], ct,
                               [0, 1])
    # 13-term sums in another order
    np.testing.assert_allclose(vt, vj, rtol=1e-6, atol=1e-6)
    for a, b in zip(gt, gj):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)


# --------------------------------------------- the fine and coarse steps


@pytest.fixture(scope="module")
def fine(mask_caches):
    ov = FINE_CPU + GRAD
    jcfg = jload("cfg/app/fine.yaml", ov, root_dir=REPO)
    tcfg = tload("cfg/app/fine.yaml", ov, root_dir=REPO)
    jmc, tmc = mask_caches
    jm = JVoxurfF(jcfg, 0.5, 4.0, [-1] * 3, [1] * 3, jmc, 80.0, 32**3)
    tm = TVoxurfF(tcfg, 0.5, 4.0, [-1] * 3, [1] * 3, tmc, 80.0, 32**3)
    assert jm.neus_alpha == tm.neus_alpha == "grad"
    return jcfg, tcfg, jm, tm, _surface_params(tm)


def test_fine_step_with_grad_alpha_matches_reference(fine):
    """One fine step body (TV terms on, dense): loss terms within rtol 1e-5,
    the march counters equal, overflow 0, every group's gradient within
    1e-4 of its max."""
    jcfg, tcfg, jm, tm, params = fine
    b = rays(seed=11)
    f = JFine.__new__(JFine)  # the step body only
    f.cfg, f.renderer, f.opt = jcfg, jm, _GradsOut()
    f.weight_entropy_last = jcfg.app.trainer.weight_entropy_last
    f.weight_linear = jcfg.app.trainer.weight_linear
    f.white_bg, f.train_bs = 1.0, len(b["rgbs"])
    args = (40.0, 1.0, 0.05, 0.01 * 0.1 / 64, True)
    gj, _, aux_j = f._build_train_step()(
        jax.tree.map(jnp.asarray, params), None,
        {k: jnp.asarray(v) for k, v in b.items()}, jnp.float32(args[0]),
        {k: jnp.float32(1.0) for k in params}, *map(jnp.float32, args[1:4]),
        jnp.bool_(args[4]))
    step = build_fine_train_step(tm, _GradsOut(), tcfg, device="cpu")
    gt, _, aux_t = step(params_from_jax(params, "cpu"), None,
                        {k: _t(v) for k, v in b.items()}, args[0],
                        {k: 1.0 for k in params}, *args[1:])
    aux_j = [float(a) for a in aux_j]
    aux_t = [float(a) for a in aux_t]
    assert aux_t[2] == aux_j[2] == 0.0 and aux_t[3] > 0
    # the counters within an ulp (XLA's reciprocal multiply under jit)
    np.testing.assert_allclose(aux_t[3:], aux_j[3:], rtol=1e-6)
    np.testing.assert_allclose(aux_t[:2], aux_j[:2], rtol=1e-5)
    _assert_group_grads(params_to_numpy(gt), jax.tree.map(np.asarray, gj),
                        FINE_GROUPS)


def test_fine_eval_with_grad_alpha_matches_reference(fine):
    """The fine eval forward with the grad variant, rtol 1e-4 / atol 1e-5
    (the eval forwards' tolerance: XLA:CPU's tanh sigmoid in the march
    alphas)."""
    _, _, jm, tm, params = fine
    b = rays(seed=12)
    rot = np.eye(3, dtype=np.float32)
    oj = jax.jit(jm.forward_evaluate)(
        jax.tree.map(jnp.asarray, params), *(jnp.asarray(b[k]) for k in (
            "rays_o", "rays_d", "viewdirs")), jnp.int32(1), jnp.asarray(rot),
        jnp.float32(40.0))
    ot = tm.forward_evaluate(params_from_jax(params, "cpu"), *(
        _t(b[k]) for k in ("rays_o", "rays_d", "viewdirs")), 1, _t(rot), 40.0)
    assert ot.keys() == oj.keys()
    assert float(np.asarray(oj["etc/white_bg"]).min()) < 0.5
    for k in oj:
        np.testing.assert_allclose(ot[k].numpy(), np.asarray(oj[k]),
                                   rtol=1e-4, atol=1e-5, err_msg=k)


@pytest.fixture(scope="module")
def coarse(mask_caches):
    ov = COARSE_CPU + GRAD
    jcfg = jload("cfg/app/coarse.yaml", ov, root_dir=REPO)
    tcfg = tload("cfg/app/coarse.yaml", ov, root_dir=REPO)
    jmc, tmc = mask_caches
    jm = JVoxurfC(jcfg, 0.5, 4.0, [-1] * 3, [1] * 3, jmc, 20.0)
    tm = TVoxurfC(tcfg, 0.5, 4.0, [-1] * 3, [1] * 3, tmc, 20.0)
    assert jm.neus_alpha == tm.neus_alpha == "grad"
    return jcfg, tcfg, jm, tm, _surface_params(tm)


def test_coarse_step_with_grad_alpha_matches_reference(coarse):
    """One coarse step body with the TV terms off (they do not read the
    march; tests/test_torch_voxurfc.py holds them, and JAX compiles the
    step three times faster without them): loss within rtol 1e-5, overflow
    0, the counters within an ulp (XLA's reciprocal multiply under jit),
    every group's gradient within 1e-4 of its max."""
    jcfg, tcfg, jm, tm, params = coarse
    b = rays(seed=13)
    jc = JCoarse(jcfg)
    jc.renderer, jc.opt = jm, _GradsOut()
    zero = lambda *a: jnp.float32(0.0)
    jm.density_total_variation = jm.color_total_variation = zero
    gj, _, aux_j = jc._build_train_step()(
        jax.tree.map(jnp.asarray, params), None,
        {k: jnp.asarray(v) for k, v in b.items()}, jnp.float32(20.0),
        {k: jnp.float32(1.0) for k in COARSE_GROUPS}, jnp.float32(0.0),
        jnp.float32(0.1), jnp.float32(0.05))
    step = build_coarse_train_step(tm, _GradsOut(), tcfg, device="cpu")
    gt, _, aux_t = step(params_from_jax(params, "cpu"), None,
                        {k: _t(v) for k, v in b.items()}, 20.0,
                        {k: 1.0 for k in COARSE_GROUPS}, 0.0, 0.1, 0.05)
    np.testing.assert_allclose(float(aux_t[0]), float(aux_j[0]), rtol=1e-5)
    assert float(aux_t[1]) == float(aux_j[1]) == 0.0
    np.testing.assert_allclose([float(a) for a in aux_t[2:]],
                               [float(a) for a in aux_j[2:]], rtol=1e-6)
    _assert_group_grads(params_to_numpy(gt), jax.tree.map(np.asarray, gj),
                        COARSE_GROUPS)


def test_coarse_eval_with_grad_alpha_matches_reference(coarse):
    _, _, jm, tm, params = coarse
    b = rays(seed=14)
    rot = np.eye(3, dtype=np.float32)
    oj = jax.jit(jm.forward_evaluate)(
        jax.tree.map(jnp.asarray, params), *(jnp.asarray(b[k]) for k in (
            "rays_o", "rays_d", "viewdirs")), jnp.int32(0), jnp.asarray(rot),
        jnp.float32(20.0))
    ot = tm.forward_evaluate(params_from_jax(params, "cpu"), *(
        _t(b[k]) for k in ("rays_o", "rays_d", "viewdirs")), 0, _t(rot), 20.0)
    assert ot.keys() == oj.keys()
    for k in oj:
        np.testing.assert_allclose(ot[k].numpy(), np.asarray(oj[k]),
                                   rtol=1e-4, atol=1e-5, err_msg=k)


# ------------------------------------------------------------ the contract


def test_march_refuses_grad_without_a_grid_and_unknown_modes(fine):
    _, _, _, tm, params = fine
    b = {k: _t(v) for k, v in rays(n=8, seed=15).items()}
    sdf = params_from_jax(params, "cpu")["sdf"]
    args = (sdf, b["rays_o"], b["rays_d"], b["viewdirs"], 40.0, 1e-4)
    with pytest.raises(ValueError, match="gradient_grid"):
        tm.geo.march(*args, "grad", style="fine")
    with pytest.raises(ValueError, match="unknown neus_alpha"):
        tm.geo.march(*args, "nearest", style="fine")


@pytest.mark.parametrize("stage", ["lts", "pdra"])
def test_esrnerf_refuses_grad_alpha(stage, mask_caches):
    """The reference's LTS and PDRA marches take no gradient grid (its
    march asserts on one); the port refuses the config up front."""
    ov = ["app.phase=train", "data.cls=x", "data.root=x", "data.scene=x",
          "app.model.rgbnet_width=32", "app.model.tonemap_width=32",
          "app.model.brdfnet_width=32", "system.compute_dtype=float32",
          "system.mesh_axes=[]"] + GRAD
    tcfg = tload(f"cfg/app/{stage}.yaml", ov, root_dir=REPO)
    _, tmc = mask_caches
    with pytest.raises(ValueError, match="app.model.neus_alpha"):
        TESRNeRF(tcfg, 0.5, 4.0, [-1] * 3, [1] * 3, tmc, 40.0, 32**3)
