"""The port's slice as a whole: one fine-stage train step
(``esrnerf_tpu_torch.apps.fine.build_fine_train_step``, plain versions on
the CPU) against the JAX ``Fine`` step body on the same parameters and
batch -- loss terms, the gradients of all six groups, Adam, and the
parameters after a full step -- plus the heads, the optimizer and the
entry points' device rule."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esrnerf_tpu.apps.fine import Fine
from esrnerf_tpu.models import mlp as jmlp
from esrnerf_tpu.models import voxurf_base as jvb
from esrnerf_tpu.models.voxurff import VoxurfF as JVoxurfF
from esrnerf_tpu.optim import Adam as JAdam
from esrnerf_tpu.optim import CosineLR as JCosineLR
from esrnerf_tpu_torch.apps.fine import build_fine_train_step
from esrnerf_tpu_torch.models import mlp as tmlp
from esrnerf_tpu_torch.models import voxurf_base as tvb
from esrnerf_tpu_torch.models.voxurff import VoxurfF as TVoxurfF
from esrnerf_tpu_torch.optim import Adam as TAdam
from esrnerf_tpu_torch.optim import CosineLR as TCosineLR
from esrnerf_tpu_torch.utils.convert import params_from_jax, params_to_numpy
from test_torch_common import (NUM_VOXELS, S_VAL, ball_density,
                               load_both_cfgs, rays)

pytestmark = pytest.mark.quick

GROUPS = ("sdf", "off_color", "emo_color", "off_rgbnet", "emo_rgbnet",
          "tonemapper")


class _GradsOut:
    """Optimizer stand-in whose step returns the gradients it is given, so
    a step body hands back its final (TV-added) gradients."""

    def step(self, params, grads, state, lr_scales=None):
        return grads, state


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree)}


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = load_both_cfgs()
    dens = ball_density()
    jmc = jvb.make_mask_cache(dens, [-1, -1, -1], [1, 1, 1], 1e-6, 1e-3, 3)
    tmc = tvb.make_mask_cache(dens, [-1, -1, -1], [1, 1, 1], 1e-6, 1e-3, 3,
                              device="cpu")
    jm = JVoxurfF(jcfg, 0.5, 4.0, [-1, -1, -1], [1, 1, 1], jmc, S_VAL,
                  NUM_VOXELS)
    tm = TVoxurfF(tcfg, 0.5, 4.0, [-1, -1, -1], [1, 1, 1], tmc, S_VAL,
                  NUM_VOXELS)
    params = jax.tree.map(np.asarray, jm.init_params(jax.random.PRNGKey(0)))
    # a surface inside the occupancy ball and nonzero color grids, so every
    # group gets a real gradient
    rng = np.random.default_rng(7)
    X, Y, Z = jm.geo.world_size
    x, y, z = np.mgrid[-1:1:X * 1j, -1:1:Y * 1j, -1:1:Z * 1j]
    r = np.sqrt(x**2 + y**2 + z**2)
    params["sdf"] = (r - 0.5 + rng.normal(scale=0.03, size=r.shape)
                     ).astype(np.float32)[..., None]
    for g in ("off_color", "emo_color"):
        params[g] = rng.normal(scale=0.3, size=params[g].shape).astype(
            np.float32)
    return jcfg, tcfg, jm, tm, params, rays()


def _step_args(tv_dense):
    # s_val 40: no sample of this batch lies within float noise of the
    # 1e-4 fastcolor threshold (the survivor sets are identical)
    return 40.0, 1.0, 0.05, 0.01 * 0.1 / 64, tv_dense


def _jax_grads(setup, tv_dense):
    jcfg, _, jm, _, params, b = setup
    f = Fine.__new__(Fine)  # the step body only: no data, no checkpoint
    f.cfg, f.renderer, f.opt = jcfg, jm, _GradsOut()
    f.weight_entropy_last = jcfg.app.trainer.weight_entropy_last
    f.weight_linear = jcfg.app.trainer.weight_linear
    f.white_bg, f.train_bs = 1.0, len(b["rgbs"])
    s_val, tv, sg, sdf_w, dense = _step_args(tv_dense)
    grads, _, aux = f._build_train_step()(
        jax.tree.map(jnp.asarray, params), None,
        {k: jnp.asarray(v) for k, v in b.items()}, jnp.float32(s_val),
        {k: jnp.float32(1.0) for k in params}, jnp.float32(tv),
        jnp.float32(sg), jnp.float32(sdf_w), jnp.bool_(dense))
    return jax.tree.map(np.asarray, grads), [float(a) for a in aux]


@pytest.fixture(scope="module")
def jax_dense(setup):
    return _jax_grads(setup, True)


def _port_step(setup, opt, tv_dense):
    _, tcfg, _, tm, params, b = setup
    tp = params_from_jax(params, device="cpu")
    state = opt.init(tp) if isinstance(opt, TAdam) else None
    s_val, tv, sg, sdf_w, dense = _step_args(tv_dense)
    step = build_fine_train_step(tm, opt, tcfg, device="cpu")
    out, _, aux = step(tp, state, {k: torch.as_tensor(v) for k, v in b.items()},
                       s_val, {k: 1.0 for k in params}, tv, sg, sdf_w, dense)
    return params_to_numpy(out), [float(a) for a in aux]


@pytest.mark.parametrize("tv_dense", [True, False])
def test_fine_step_grads_match_reference(setup, jax_dense, tv_dense):
    g_j, aux_j = jax_dense if tv_dense else _jax_grads(setup, False)
    g_t, aux_t = _port_step(setup, _GradsOut(), tv_dense)
    mse_j, lin_j, ovf_j, k1_j, k2_j = aux_j
    mse_t, lin_t, ovf_t, k1_t, k2_t = aux_t
    assert ovf_j == 0.0 and ovf_t == 0.0
    assert (k1_t, k2_t) == (k1_j, k2_j)
    np.testing.assert_allclose([mse_t, lin_t], [mse_j, lin_j], rtol=1e-5)
    for grp in GROUPS:
        lj, lt = _leaves(g_j[grp]), _leaves(g_t[grp])
        assert lj.keys() == lt.keys()
        scale = max(np.abs(v).max() for v in lj.values())
        assert scale > 0, grp
        for k in lj:
            err = np.abs(lt[k] - lj[k]).max() / scale
            assert err <= 1e-4, (grp, k, err)


def test_fine_full_step_params_match_reference(setup, jax_dense):
    jcfg, tcfg, _, _, params, _ = setup
    lrs = dict(jcfg.app.trainer.lrs)
    g_j, _ = jax_dense
    jopt = JAdam(lrs)
    p_j, _ = jopt.step(jax.tree.map(jnp.asarray, params),
                       jax.tree.map(jnp.asarray, g_j),
                       jopt.init(jax.tree.map(jnp.asarray, params)),
                       lr_scales={k: jnp.float32(1.0) for k in params})
    p_t, _ = _port_step(setup, TAdam(lrs), True)
    # Adam's first step moves every element by ~lr*sign(g): compare where
    # the gradient is well above its noise level
    for grp in GROUPS:
        gl, pj, pt = _leaves(g_j[grp]), _leaves(p_j[grp]), _leaves(p_t[grp])
        scale = max(np.abs(v).max() for v in gl.values())
        for k in gl:
            sel = np.abs(gl[k]) > 1e-3 * scale
            assert sel.any(), (grp, k)
            np.testing.assert_allclose(pt[k][sel], pj[k][sel], rtol=1e-6,
                                       atol=1e-4 * lrs[grp], err_msg=k)


def test_adam_matches_reference():
    rng = np.random.default_rng(0)
    params = {
        "grid": rng.normal(size=(4, 5, 3, 2)).astype(np.float32),
        "head": {"w0": rng.normal(size=(6, 4)).astype(np.float32),
                 "b0": rng.normal(size=(4,)).astype(np.float32)},
        "frozen": rng.normal(size=(3,)).astype(np.float32),
    }
    lrs = {"grid": 0.1, "head": 0.003, "frozen": 0.0}
    per_lr = {"grid": rng.uniform(size=(4, 5, 3, 2)).astype(np.float32)}
    jopt, topt = JAdam(lrs), TAdam(lrs)
    pj = jax.tree.map(jnp.asarray, params)
    sj = jopt.init(pj)
    pt = params_from_jax(params, device="cpu")
    st = topt.init(pt)
    assert set(st.mu) == {"grid", "head"}
    for it in range(3):
        g = jax.tree.map(
            lambda p: rng.normal(size=p.shape).astype(np.float32), params)
        g["grid"][0, 0] = 0.0
        scales = {"grid": 0.5 + it, "head": 1.0}
        pj, sj = jopt.step(pj, jax.tree.map(jnp.asarray, g), sj,
                           lr_scales={k: jnp.float32(v)
                                      for k, v in scales.items()},
                           per_lr={"grid": jnp.asarray(per_lr["grid"])})
        pt, st = topt.step(pt, params_from_jax(g, device="cpu"), st,
                           lr_scales=scales,
                           per_lr={"grid": torch.as_tensor(per_lr["grid"])})
    for tree_t, tree_j in [(pt, pj), (st.mu, sj.mu), (st.nu, sj.nu)]:
        lt, lj = _leaves(params_to_numpy(tree_t)), _leaves(tree_j)
        for k in lj:
            np.testing.assert_allclose(lt[k], lj[k], rtol=1e-5, atol=1e-6,
                                       err_msg=k)
    assert int(st.step["grid"]) == 3
    np.testing.assert_array_equal(pt["frozen"].numpy(), params["frozen"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlp_matches_reference(dtype):
    rng = np.random.default_rng(1)
    dims = [23, 32, 32, 3]
    p = jax.tree.map(np.asarray,
                     jmlp.init_mlp(jax.random.PRNGKey(3), dims))
    x = rng.normal(size=(200, 23)).astype(np.float32)
    ct = rng.normal(size=(200, 3)).astype(np.float32)
    jd = jnp.bfloat16 if dtype == "bfloat16" else None
    td = torch.bfloat16 if dtype == "bfloat16" else None
    out_j, vjp = jax.vjp(lambda pp: jmlp.apply_mlp(pp, jnp.asarray(x),
                                                   compute_dtype=jd),
                         jax.tree.map(jnp.asarray, p))
    g_j = _leaves(vjp(jnp.asarray(ct))[0])
    pt = {k: torch.tensor(v).requires_grad_(True) for k, v in p.items()}
    out_t = tmlp.apply_mlp(pt, torch.as_tensor(x), compute_dtype=td)
    (out_t * torch.as_tensor(ct)).sum().backward()
    # bf16: operands round identically, but f32 sums in another order can
    # flip a bf16 rounding of an activation (one bf16 ulp, 2^-8)
    tol = 1e-5 if td is None else 2e-2
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                               rtol=tol, atol=tol)
    for k, v in pt.items():
        np.testing.assert_allclose(v.grad.numpy(), g_j[k], rtol=tol,
                                   atol=tol * np.abs(g_j[k]).max())
    init = tmlp.init_mlp(torch.Generator().manual_seed(0), dims)
    assert {k: tuple(v.shape) for k, v in init.items()} == \
        {k: v.shape for k, v in p.items()}
    assert float(init["w0"].abs().max()) <= 1 / np.sqrt(23)


def test_cosine_lr_matches_reference():
    kw = dict(n_iters=100, warm_up_iters=10, warm_up_min_ratio=0.1,
              const_warm_up=False, cos_min_ratio=0.05)
    jl, tl = JCosineLR(**kw, cur_step=3), TCosineLR(**kw, cur_step=3)
    assert [jl.decay_factor for _ in range(30)] == \
        [tl.decay_factor for _ in range(30)]


def test_entry_points_default_to_cuda(setup, monkeypatch):
    """Without CUDA, an entry point called without device='cpu' raises
    instead of quietly running on the CPU."""
    _, tcfg, _, tm, params, _ = setup
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_fine_train_step(tm, TAdam({"sdf": 1.0}), tcfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params_from_jax(params)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tvb.make_mask_cache(ball_density(), [-1] * 3, [1] * 3, 1e-6, 1e-3, 3)


def test_params_round_trip(setup):
    params = setup[4]
    back = params_to_numpy(params_from_jax(params, device="cpu"))
    lj, lb = _leaves(params), _leaves(back)
    assert lj.keys() == lb.keys()
    for k in lj:
        np.testing.assert_array_equal(lb[k], lj[k])
