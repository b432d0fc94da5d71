"""The PDRA slice's model pieces against the JAX reference (the port on the
CPU, plain versions of the kernels), from the same parameters, rays and
random draws: the HSV pair, the emission-mask IoU, ``march_ray_slots``,
``eval_emit`` / ``eval_esp``, ``forward_finetune`` on both of its paths
(outputs and the emo branch's gradients) and one PDRA train step (loss
terms and every group's gradient). f32 throughout, TF32 off."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esrnerf_tpu.apps.lts import masked_mse as jmasked_mse
from esrnerf_tpu.apps.pdra import PDRA as JPDRA
from esrnerf_tpu.ops.image import hsv_to_rgb as jhsv_to_rgb
from esrnerf_tpu.ops.image import rgb_to_hsv as jrgb_to_hsv
from esrnerf_tpu.utils.metrics import IoU as jIoU
from esrnerf_tpu_torch.apps.pdra import (build_finetune_step,
                                         build_pdra_train_step, masked_l1)
from esrnerf_tpu_torch.models.esrnerf import FinetuneDraws
from esrnerf_tpu_torch.ops.image import hsv_to_rgb, rgb_to_hsv
from esrnerf_tpu_torch.utils.convert import params_from_jax, params_to_numpy
from esrnerf_tpu_torch.utils.metrics import IoU
from test_torch_lts_step import (GROUPS, S_VAL, _GradsOut, _leaves,
                                 jax_draws, lts_batch, lts_models, lts_params)

pytestmark = pytest.mark.quick

# cfg/app/pdra.yaml's loss weights on the LTS test's CPU-size model
PDRA_W = ["app.trainer.weight_lts_l=50.0", "app.trainer.weight_lts_r=1.0",
          "app.trainer.weight_emit_supp=0.1",
          "app.trainer.weight_emit_smooth=0.1"]
FT = ("emo_color", "emo_rgbnet")
RAY_KEYS = ("rays_o", "rays_d", "viewdirs")


# ------------------------------------------------------------ HSV and IoU


def _rgb_cases():
    rng = np.random.default_rng(0)
    rgb = rng.uniform(0, 2, (500, 3)).astype(np.float32)
    rgb[:20] = rgb[:20, :1]           # grey: deltac == 0
    rgb[20:40, 1] = rgb[20:40, 0]     # ties of the max (first index wins)
    rgb[40:60, 2] = rgb[40:60, 1]
    rgb[60:70] = 0.0
    rgb[70:80, 0] = 0.0               # hue near 0 and 1 (the floor-mod)
    return rgb


def test_hsv_pair_matches_reference():
    """rgb -> hsv -> rgb at 1e-6 against JAX, with grey rows, ties of the
    maximal channel and hues that wrap."""
    rgb = _rgb_cases()
    hsv_j = np.asarray(jrgb_to_hsv(jnp.asarray(rgb)))
    hsv_t = rgb_to_hsv(torch.as_tensor(rgb)).numpy()
    np.testing.assert_allclose(hsv_t, hsv_j, rtol=1e-6, atol=1e-6)
    rng = np.random.default_rng(1)
    hsv = np.concatenate([hsv_j, rng.uniform(0, 1, (200, 3))], 0).astype(
        np.float32)
    hsv[-5:, 0] = [0.0, 1.0, 1 / 6, 5 / 6, 0.99999994]
    np.testing.assert_allclose(hsv_to_rgb(torch.as_tensor(hsv)).numpy(),
                               np.asarray(jhsv_to_rgb(jnp.asarray(hsv))),
                               rtol=1e-6, atol=1e-6)


def test_iou_matches_reference_exactly():
    rng = np.random.default_rng(2)
    for a, b in ((rng.uniform(size=(9, 7)) > 0.5, rng.uniform(size=63) > 0.3),
                 (np.zeros(5, bool), np.zeros(5, bool))):
        b = b.reshape(a.shape)
        assert IoU(a, b) == jIoU(a, b)


# ------------------------------------------------------------------ model


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg, jm, tm = lts_models(PDRA_W)
    jm.pdra_mode = tm.pdra_mode = True
    params = lts_params(jm)
    # the fine-tune's frozen emission snapshot, here not equal to emo_color
    params["emit_color"] = np.random.default_rng(8).normal(
        scale=0.3, size=params["emo_color"].shape).astype(np.float32)
    return jcfg, tcfg, jm, tm, params


def _jit(fn, *args):
    return jax.jit(fn)(*args)


@pytest.mark.parametrize("ppr", [3, 32])
def test_march_ray_slots_matches_reference(setup, ppr):
    """Slots, valid, counts and dropped bitwise; the slot points at the
    march's rtol 1e-4 / atol 1e-5. ppr 3 drops samples, 32 keeps all."""
    _, _, jm, tm, params = setup
    b = lts_batch(64, seed=2)
    want = _jit(lambda sdf, *a: jm.geo.march_ray_slots(
        sdf, *a, jnp.float32(S_VAL), jm.fastcolor_thres, jm.neus_alpha, ppr),
        jnp.asarray(params["sdf"]), *(jnp.asarray(b[k]) for k in RAY_KEYS))
    got = tm.geo.march_ray_slots(
        torch.as_tensor(params["sdf"]), *(torch.as_tensor(b[k])
                                           for k in RAY_KEYS),
        S_VAL, tm.fastcolor_thres, tm.neus_alpha, ppr)
    (pj, vj, (cj, dj)), (pt, vt, (ct, dt)) = want, got
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))
    assert np.asarray(cj).sum() > 0
    assert (np.asarray(dj).sum() > 0) == (ppr == 3)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=1e-4,
                               atol=1e-5)
    assert not np.asarray(pt)[~np.asarray(vj)].any()  # empty slots are 0


def test_eval_emit_and_esp_match_reference(setup):
    """Both probes at the eval forward's rtol 1e-4 / atol 1e-5, overflow
    equal; eval_emit also from the ``emit_color`` grid."""
    _, _, jm, tm, params = setup
    b = lts_batch(64, seed=5)
    jp = jax.tree.map(jnp.asarray, params)
    tp = params_from_jax(params, device="cpu")
    args_j = [jnp.asarray(b[k]) for k in RAY_KEYS]
    args_t = [torch.as_tensor(b[k]) for k in RAY_KEYS]
    for key in ("emo_color", "emit_color"):
        ej, oj = _jit(lambda p, *a: jm.eval_emit(
            p, *a, jnp.float32(S_VAL), emit_grid_key=key), jp, *args_j)
        et, ot = tm.eval_emit(tp, *args_t, S_VAL, emit_grid_key=key)
        assert float(ot) == float(oj) == 0.0
        assert float(np.asarray(ej).max()) > 0
        np.testing.assert_allclose(et.numpy(), np.asarray(ej), rtol=1e-4,
                                   atol=1e-5, err_msg=key)
    sj, oj = _jit(lambda p, *a: jm.eval_esp(p, *a, jnp.float32(S_VAL)), jp,
                  *args_j)
    st, ot = tm.eval_esp(tp, *args_t, S_VAL)
    assert float(ot) == float(oj)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=1e-4,
                               atol=1e-5)


def _ft_batch(n=64, seed=3):
    b = lts_batch(n, seed)
    r = np.random.default_rng(seed + 10)
    b["em_modes"] = r.integers(0, 5, n)  # off, on, i-, c-, ic-change
    b["em_intensities"] = r.uniform(0.2, 2.0, n).astype(np.float32)
    b["em_colors"] = r.uniform(0, 1, (n, 2)).astype(np.float32)
    return b


def _ft_draws(jm, key, n_rows):
    k_sel, k_scat = jax.random.split(key)
    return FinetuneDraws(*(torch.as_tensor(np.array(a)) for a in (
        jax.random.uniform(k_sel, (n_rows,)),
        jax.random.normal(k_scat, (jm.num_ltspts, jm.num_2ndrays + 1, 3)))))


@pytest.mark.parametrize("cached", [False, True])
def test_forward_finetune_matches_reference(setup, cached):
    """Both paths (the per-step march, and slots from ``march_ray_slots``
    with interleaved pads): every output at 1e-4 / 1e-5 (targets on valid
    rows), and the gradients of ``emo_color`` / ``emo_rgbnet`` of the
    fine-tune loss within 1e-4 of each group's max."""
    jcfg, _, jm, tm, params = setup
    b = _ft_batch()
    ppr = 8
    keys = RAY_KEYS + ("em_modes", "em_intensities", "em_colors")
    jb = {k: jnp.asarray(b[k]) for k in keys}
    tb = {k: torch.as_tensor(b[k]) for k in keys}
    ft = {}
    if cached:
        pts, ok, _ = _jit(lambda sdf, *a: jm.geo.march_ray_slots(
            sdf, *a, jnp.float32(S_VAL), jm.fastcolor_thres, jm.neus_alpha,
            ppr), jnp.asarray(params["sdf"]), *(jb[k] for k in RAY_KEYS))
        ft = {"ft_pts": np.array(pts), "ft_valid": np.array(ok)}
        assert (~ft["ft_valid"][:, 0] & ft["ft_valid"].any(1)).sum() == 0
        n_rows = 64 * ppr
    else:
        n_rows = 64 * jm.geo.points_per_ray
    key = jax.random.PRNGKey(21)
    w = 0.5  # cfg/app/pdra.yaml's app.eval.weight_lts
    train_j = {k: jax.tree.map(jnp.asarray, params[k]) for k in FT}
    frozen_j = {k: jnp.asarray(v) if not isinstance(v, dict)
                else jax.tree.map(jnp.asarray, v)
                for k, v in params.items() if k not in FT}

    def jloss(p):
        res = jm.forward_finetune(
            p, frozen_j, *(jb[k] for k in keys), jnp.float32(S_VAL), key,
            ft_pts=None if not cached else jnp.asarray(ft["ft_pts"]),
            ft_valid=None if not cached else jnp.asarray(ft["ft_valid"]))
        return w * jmasked_mse(res["lin/pbr/emo"], res["lin/pbr/emo_hat"],
                               res["lin/pbr/valid"]), res

    (loss_j, res_j), g_j = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        train_j)

    tp = params_from_jax(params, device="cpu")
    train_t = {k: tp[k] for k in FT}
    frozen_t = {k: v for k, v in tp.items() if k not in FT}
    draws = _ft_draws(jm, key, n_rows)
    ft_t = {k: torch.as_tensor(v) for k, v in ft.items()}
    with torch.no_grad():
        res_t = tm.forward_finetune(train_t, frozen_t, *(tb[k] for k in keys),
                                    S_VAL, draws=draws, **ft_t)
    # the port adds the secondary march's counts (what a data-parallel
    # step folds)
    assert set(res_t) == set(res_j) | {"etc/counts_2nd"}
    valid = np.asarray(res_j["lin/pbr/valid"])
    assert valid.sum() > 0 and float(res_j["etc/overflow"]) == 0.0
    np.testing.assert_array_equal(res_t["lin/pbr/valid"].numpy(), valid)
    assert float(res_t["etc/overflow"]) == 0.0
    for k in ("lin/pbr/emo", "lin/pbr/emo_hat"):
        np.testing.assert_allclose(res_t[k].numpy()[valid],
                                   np.asarray(res_j[k])[valid], rtol=1e-4,
                                   atol=1e-5, err_msg=k)

    step = build_finetune_step(tm, _GradsOut(), w)
    g_t, _, (loss_t, ovf_t) = step(train_t, None, frozen_t, tb, S_VAL,
                                   draws=draws, **ft_t)
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-4)
    g_t, g_j = params_to_numpy(g_t), jax.tree.map(np.asarray, g_j)
    for grp in FT:
        lj, lt = _leaves(g_j[grp]), _leaves(g_t[grp])
        scale = max(np.abs(v).max() for v in lj.values())
        assert scale > 0, grp
        for k in lj:
            err = np.abs(lt[k] - lj[k]).max() / scale
            assert err <= 1e-4, (grp, k, err)


# ------------------------------------------------------------ PDRA step


def _np_masked_l1(a, b, v):
    v = np.asarray(v, np.float64)[:, None]
    return float((np.abs(np.asarray(a, np.float64) - b) * v).sum()
                 / max(v.sum() * a.shape[-1], 1.0))


def test_pdra_step_matches_reference(setup):
    """One PDRA step (pdra_mode, certain and uncertain rays, dense TV)
    from JAX's draws: the loss terms at rtol 1e-5 (the JAX step's aux; the
    emo pair's second half, the suppression and the emission smoothness
    from the JAX forward of the same key), both marches' counters, and
    every group's gradient within 1e-4 of its max."""
    jcfg, tcfg, jm, tm, params = setup
    params = {k: v for k, v in params.items() if k != "emit_color"}
    b = lts_batch(64, seed=4)
    key = jax.random.PRNGKey(13)
    s_val, tv, sg, sdf_w, dense = S_VAL, 1.0, 0.05, 0.01 * 0.1 / 64, True

    f = JPDRA.__new__(JPDRA)  # the step body only
    f.cfg, f.renderer, f.opt = jcfg, jm, _GradsOut()
    tr = jcfg.app.trainer
    for a in ("weight_entropy_last", "weight_linear", "weight_lts",
              "weight_normal_smooth", "normal_eps", "emit_eps",
              "weight_lts_l", "weight_lts_r", "weight_emit_supp",
              "weight_emit_smooth"):
        setattr(f, a, tr[a])
    f.white_bg, f.train_uncert_bs, f.train_cert_bs = 1.0, 64, 0
    # the JAX forward of the same key first: the JAX step donates its
    # parameters
    jp = jax.tree.map(jnp.asarray, params)
    fkeys = ("rays_o", "rays_d", "viewdirs", "em_modes", "uncert_masks")
    res_j = jax.tree.map(np.asarray, jax.jit(lambda p, *a: jm.forward_training(
        p, *a, jnp.float32(s_val), tr.normal_eps, tr.emit_eps, key))(
        jp, *(jnp.asarray(b[k]) for k in fkeys)))

    jp = jax.tree.map(jnp.asarray, params)
    g_j, _, aux_j = f._build_train_step()(
        jp, None, {k: jnp.asarray(v) for k, v in b.items()},
        jnp.float32(s_val),
        jax.tree.map(lambda _: jnp.float32(1.0), {k: 0 for k in params}),
        jnp.float32(tv), jnp.float32(sg), jnp.float32(sdf_w),
        jnp.bool_(dense), key)
    aux_j = [float(a) for a in aux_j]

    step = build_pdra_train_step(tm, _GradsOut(), tcfg, device="cpu")
    g_t, _, aux_t = step(params_from_jax(params, device="cpu"), None,
                         {k: torch.as_tensor(v) for k, v in b.items()}, s_val,
                         {k: 1.0 for k in params}, tv, sg, sdf_w, dense,
                         draws=jax_draws(jm, key, 64))
    aux_t = [float(a) for a in aux_t]
    assert aux_j[4] == aux_t[4] == 0.0  # overflow, both marches
    assert aux_t[6] == aux_j[6] and aux_t[8] == aux_j[8]  # k2, k2_2nd
    np.testing.assert_allclose([aux_t[5], aux_t[7]], [aux_j[5], aux_j[7]],
                               rtol=2.4e-7)  # k1, k1_2nd
    # mse, lin_mse, off_l1, emo_l1
    np.testing.assert_allclose(aux_t[:4], aux_j[:4], rtol=1e-5)
    cert = ~b["uncert_masks"]
    assert 0 < cert.sum() < 64
    em = res_j["etc/emit_marched"].astype(np.float64)
    want = [
        _np_masked_l1(res_j["lin/pbr/emo"], res_j["lin/pbr/emo_hat"],
                      res_j["lin/pbr/valid"]),
        float((em**2 * cert[:, None]).sum() / max(cert.sum() * 3, 1)),
        _np_masked_l1(res_j["etc/emit"], res_j["etc/emit_eps"],
                      res_j["etc/point_valid"]),
    ]
    assert min(want) > 0
    np.testing.assert_allclose(aux_t[9:], want, rtol=1e-5)
    g_j, g_t = jax.tree.map(np.asarray, g_j), params_to_numpy(g_t)
    for grp in GROUPS:
        lj, lt = _leaves(g_j[grp]), _leaves(g_t[grp])
        assert lj.keys() == lt.keys()
        scale = max(np.abs(v).max() for v in lj.values())
        assert scale > 0, grp
        for k in lj:
            err = np.abs(lt[k] - lj[k]).max() / scale
            assert err <= 1e-4, (grp, k, err)


def test_masked_l1_counts_only_valid_rows():
    a = torch.tensor([[1.0, -2.0], [3.0, 4.0], [9.0, 9.0]])
    v = torch.tensor([True, True, False])
    assert float(masked_l1(a, torch.zeros_like(a), v)) == pytest.approx(2.5)
    assert float(masked_l1(a, a, torch.zeros(3, dtype=torch.bool))) == 0.0
