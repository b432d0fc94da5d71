"""The LTS slice against the JAX reference on the same parameters, batch and
random draws (the port on the CPU, plain versions of the kernels):
``ESRNeRF.forward_training`` output by output, and one LTS train step's
loss terms, march counters and every parameter group's gradient, with the
dense and the sparse SDF TV gradient."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esrnerf_tpu.apps.lts import LTS as JLTS
from esrnerf_tpu.config import load_cfg as jload
from esrnerf_tpu.models import voxurf_base as jvb
from esrnerf_tpu.models.esrnerf import ESRNeRF as JESRNeRF
from esrnerf_tpu_torch.apps.lts import build_lts_train_step, masked_mse
from esrnerf_tpu_torch.config import load_cfg as tload
from esrnerf_tpu_torch.models import voxurf_base as tvb
from esrnerf_tpu_torch.models.esrnerf import ESRNeRF as TESRNeRF
from esrnerf_tpu_torch.models.esrnerf import LTSDraws
from esrnerf_tpu_torch.utils.convert import params_from_jax, params_to_numpy
from test_torch_common import REPO, ball_density, rays

pytestmark = pytest.mark.quick

# cfg/app/lts.yaml cut to CPU size: 32^3 grids, 64 rays, 2-layer 32-wide
# heads, 16 LTS points x 4 secondary rays, f32 heads, budgets with
# overflow 0 on the ball scene (surf_band_factor 14 as configured)
LTS_CPU = [
    "app.phase=train", "data.cls=x", "data.root=x", "data.scene=x",
    "app.model.points_budget_masked_per_ray=432",
    "app.model.points_budget_per_ray=16",
    "app.model.points_budget_masked_per_2ndray=128",
    "app.model.points_budget_per_2ndray=16",
    "app.model.phase1_block=8",
    "app.model.rgbnet_width=32", "app.model.rgbnet_depth=2",
    "app.model.tonemap_width=32", "app.model.tonemap_depth=2",
    "app.model.brdfnet_width=32", "app.model.brdfnet_depth=2",
    "app.model.num_ltspts=16", "app.model.num_2ndrays=4",
    "system.compute_dtype=float32", "system.mesh_axes=[]",
]
NUM_VOXELS = 32**3
S_VAL = 40.0
GROUPS = ("sdf", "off_color", "emo_color", "off_rgbnet", "emo_rgbnet",
          "tonemapper", "brdf", "brdfnet", "emitnet", "envmap")


def lts_cfgs(extra=()):
    ov = LTS_CPU + list(extra)
    return (jload("cfg/app/lts.yaml", ov, root_dir=REPO),
            tload("cfg/app/lts.yaml", ov, root_dir=REPO))


def lts_models(extra=()):
    jcfg, tcfg = lts_cfgs(extra)
    dens = ball_density()
    jmc = jvb.make_mask_cache(dens, [-1, -1, -1], [1, 1, 1], 1e-6, 1e-3, 3)
    tmc = tvb.make_mask_cache(dens, [-1, -1, -1], [1, 1, 1], 1e-6, 1e-3, 3,
                              device="cpu")
    jm = JESRNeRF(jcfg, 0.5, 4.0, [-1, -1, -1], [1, 1, 1], jmc, S_VAL,
                  NUM_VOXELS)
    tm = TESRNeRF(tcfg, 0.5, 4.0, [-1, -1, -1], [1, 1, 1], tmc, S_VAL,
                  NUM_VOXELS)
    return jcfg, tcfg, jm, tm


def lts_params(jm, seed=7):
    """JAX ``init_params`` with a surface inside the occupancy ball and
    nonzero colour and BRDF grids, so every group gets a real gradient."""
    params = jax.tree.map(np.asarray, jm.init_params(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(seed)
    X, Y, Z = jm.geo.world_size
    x, y, z = np.mgrid[-1:1:X * 1j, -1:1:Y * 1j, -1:1:Z * 1j]
    r = np.sqrt(x**2 + y**2 + z**2)
    params["sdf"] = (r - 0.5 + rng.normal(scale=0.03, size=r.shape)
                     ).astype(np.float32)[..., None]
    for g in ("off_color", "emo_color", "brdf"):
        params[g] = rng.normal(scale=0.3, size=params[g].shape).astype(
            np.float32)
    return params


def lts_batch(n=64, seed=0):
    b = rays(n, seed)
    b["uncert_masks"] = np.random.default_rng(seed + 1).uniform(size=n) > 0.3
    return b


def jax_draws(jm, key, n_rays):
    """The four draws of the JAX ``forward_training`` for ``key``."""
    k_sel, k_scat, k_neps, k_eeps = jax.random.split(key, 4)
    K2 = n_rays * jm.geo.points_per_ray
    P, n2 = jm.num_ltspts, jm.num_2ndrays
    return LTSDraws(*(torch.as_tensor(np.array(a)) for a in (
        jax.random.uniform(k_sel, (K2,)),
        jax.random.normal(k_scat, (P, n2 + 1, 3)),
        jax.random.normal(k_neps, (K2, 3)),
        jax.random.normal(k_eeps, (K2, 3)))))


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg, jm, tm = lts_models()
    params = lts_params(jm)
    return jcfg, tcfg, jm, tm, params, lts_batch()


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree)}


def test_forward_training_matches_reference(setup):
    jcfg, _, jm, tm, params, b = setup
    key = jax.random.PRNGKey(3)
    ne, ee = 0.01, 0.001
    keys = ("rays_o", "rays_d", "viewdirs", "em_modes", "uncert_masks")
    want = jax.jit(lambda p, *a: jm.forward_training(
        p, *a, jnp.float32(S_VAL), ne, ee, key))(
        jax.tree.map(jnp.asarray, params), *(jnp.asarray(b[k]) for k in keys))
    with torch.no_grad():
        got = tm.forward_training(
            params_from_jax(params, device="cpu"),
            *(torch.as_tensor(b[k]) for k in keys), S_VAL, ne, ee,
            draws=jax_draws(jm, key, len(b["rays_o"])))
    # the port adds both marches' counts (what a data-parallel step folds)
    assert set(got) == set(want) | {"etc/counts", "etc/counts_2nd"}
    assert float(want["etc/overflow"]) == 0.0
    valid = np.asarray(want["lin/pbr/valid"])
    assert valid.sum() > 0
    for k in ("lin/pbr/valid", "etc/point_valid", "etc/overflow",
              "etc/k2_frac", "etc/k2_frac_2nd"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    # k1 = count / budget: jitted XLA multiplies by the reciprocal
    for k in ("etc/k1_frac", "etc/k1_frac_2nd"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=2.4e-7)
    assert float(want["etc/k2_frac_2nd"]) > 0  # the secondary march hits
    # the fine step's bounds: forward outputs rtol 1e-4 / atol 1e-5 (the
    # march alphas' sigmoid, tests/test_torch_march.py); the LTS targets
    # only on valid slots (pad slots are masked out of every loss)
    for k, w in want.items():
        g = got[k].numpy()
        w = np.asarray(w)
        if k.startswith("lin/pbr/") and k != "lin/pbr/valid":
            g, w = g[valid], w[valid]
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5, err_msg=k)


class _GradsOut:
    """Optimizer stand-in whose step returns the gradients it is given."""

    def step(self, params, grads, state, lr_scales=None):
        return grads, state


def _step_args(tv_dense):
    return S_VAL, 1.0, 0.05, 0.01 * 0.1 / 64, tv_dense


def jax_lts_grads(jcfg, jm, params, b, args, key):
    """One JAX LTS step body on ``params`` and batch ``b`` with the step
    arguments ``args`` (s_val, tv, smooth_grad_tv, sdf_tv_w, tv_dense):
    ``(grads, aux)``."""
    f = JLTS.__new__(JLTS)  # the step body only
    f.cfg, f.renderer, f.opt = jcfg, jm, _GradsOut()
    tr = jcfg.app.trainer
    f.weight_entropy_last, f.weight_linear = (tr.weight_entropy_last,
                                              tr.weight_linear)
    f.weight_lts, f.weight_normal_smooth = tr.weight_lts, \
        tr.weight_normal_smooth
    f.normal_eps, f.emit_eps = tr.normal_eps, tr.emit_eps
    f.white_bg = float(jcfg.data["white_bg"])
    f.train_bs = len(b["rgbs"])
    s_val, tv, sg, sdf_w, dense = args
    grads, _, aux = f._build_train_step()(
        jax.tree.map(jnp.asarray, params), None,
        {k: jnp.asarray(v) for k, v in b.items()}, jnp.float32(s_val),
        jax.tree.map(lambda _: jnp.float32(1.0), {k: 0 for k in params}),
        jnp.float32(tv), jnp.float32(sg), jnp.float32(sdf_w),
        jnp.bool_(dense), key)
    return jax.tree.map(np.asarray, grads), [float(a) for a in aux]


def port_lts_grads(tcfg, tm, params, b, args, draws):
    """The port's LTS step on the same inputs, fed the JAX step's draws."""
    s_val, tv, sg, sdf_w, dense = args
    step = build_lts_train_step(tm, _GradsOut(), tcfg, device="cpu")
    out, _, aux = step(params_from_jax(params, device="cpu"), None,
                       {k: torch.as_tensor(v) for k, v in b.items()}, s_val,
                       {k: 1.0 for k in params}, tv, sg, sdf_w, dense,
                       draws=draws)
    return params_to_numpy(out), [float(a) for a in aux]


def assert_lts_step_close(g_j, aux_j, g_t, aux_t):
    """Both marches without overflow; k2 counts equal, k1 to the jitted
    reciprocal's rounding; the four MSEs to the fine step's rtol; every
    group's gradient to 1e-4 of its largest entry."""
    assert aux_j[4] == aux_t[4] == 0.0  # overflow, both marches
    assert aux_t[6] == aux_j[6] and aux_t[8] == aux_j[8]  # k2, k2_2nd
    np.testing.assert_allclose([aux_t[5], aux_t[7]], [aux_j[5], aux_j[7]],
                               rtol=2.4e-7)  # k1, k1_2nd
    # mse, lin_mse, off_mse, emo_mse: the fine step's rtol
    np.testing.assert_allclose(aux_t[:4], aux_j[:4], rtol=1e-5)
    for grp in GROUPS:
        lj, lt = _leaves(g_j[grp]), _leaves(g_t[grp])
        assert lj.keys() == lt.keys()
        scale = max(np.abs(v).max() for v in lj.values())
        assert scale > 0, grp
        for k in lj:
            err = np.abs(lt[k] - lj[k]).max() / scale
            assert err <= 1e-4, (grp, k, err)


@pytest.mark.parametrize("tv_dense", [True, False])
def test_lts_step_grads_match_reference(setup, tv_dense):
    key = jax.random.PRNGKey(11)
    jcfg, tcfg, jm, tm, params, b = setup
    args = _step_args(tv_dense)
    g_j, aux_j = jax_lts_grads(jcfg, jm, params, b, args, key)
    g_t, aux_t = port_lts_grads(tcfg, tm, params, b, args,
                                jax_draws(jm, key, len(b["rgbs"])))
    assert_lts_step_close(g_j, aux_j, g_t, aux_t)


@pytest.mark.parametrize("n_real", [3, 40])
def test_select_lts_points_matches_top_k(n_real):
    """The P lowest scores among non-pad rows, ascending, ties to the lower
    index (pads score 2): ``jax.lax.top_k`` of the negated scores, sorted;
    with fewer real rows than P the pads fill the tail as invalid."""
    K, P = 64, 16
    u = np.random.default_rng(n_real).uniform(size=K).astype(np.float32)
    u[5] = u[9]  # a tie
    pad = np.arange(K) >= n_real
    scores = np.where(pad, 2.0, u).astype(np.float32)
    _, sel_j = jax.lax.top_k(-jnp.asarray(scores), P)
    sel_j = np.sort(np.asarray(sel_j))

    class _M:
        pass

    m = _M()
    m.pad = torch.as_tensor(pad)
    sel_t, valid_t = TESRNeRF._select_lts_points(torch.as_tensor(u), m, P)
    np.testing.assert_array_equal(sel_t.numpy(), sel_j)
    np.testing.assert_array_equal(valid_t.numpy(), ~pad[sel_j])
    assert valid_t.sum() == min(n_real, P)


def test_masked_mse_counts_only_valid_rows():
    a = torch.tensor([[1.0, 2.0], [3.0, 4.0], [9.0, 9.0]])
    b = torch.zeros_like(a)
    v = torch.tensor([True, True, False])
    assert float(masked_mse(a, b, v)) == pytest.approx((1 + 4 + 9 + 16) / 4)
    assert float(masked_mse(a, b, torch.zeros(3, dtype=torch.bool))) == 0.0
