"""Parity of the port's mask cache and two-phase march
(``esrnerf_tpu_torch.models.voxurf_base``, plain versions on the CPU) with
the JAX reference on the same inputs: identical survivor sets and budget
counters, weights and transmittance within float tolerance."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esrnerf_tpu.models import voxurf_base as jvb
from esrnerf_tpu_torch.models import voxurf_base as tvb
from test_torch_common import ball_density, load_both_cfgs, rays

pytestmark = pytest.mark.quick


def _geos(blk):
    jcfg, tcfg = load_both_cfgs([f"app.model.phase1_block={blk}",
                                 "app.model.num_voxels=32768"])
    dens = ball_density()
    jmc = jvb.make_mask_cache(dens, [-1, -1, -1], [1, 1, 1], 1e-6, 1e-3, 3)
    tmc = tvb.make_mask_cache(dens, [-1, -1, -1], [1, 1, 1], 1e-6, 1e-3, 3,
                              device="cpu")
    jg = jvb.VoxurfGeometry(jcfg, 0.5, 4.0, [-1, -1, -1], [1, 1, 1], jmc)
    tg = tvb.VoxurfGeometry(tcfg, 0.5, 4.0, [-1, -1, -1], [1, 1, 1], tmc)
    return jg, tg


def _sdf(world_size, seed=1):
    """A sphere of radius 0.5 (inside the occupancy ball) plus noise, so
    rays cross the surface with a spread of alphas."""
    X, Y, Z = world_size
    x, y, z = np.mgrid[-1:1:X * 1j, -1:1:Y * 1j, -1:1:Z * 1j]
    r = np.sqrt(x**2 + y**2 + z**2)
    noise = np.random.default_rng(seed).normal(scale=0.05, size=r.shape)
    return (r - 0.5 + noise).astype(np.float32)[..., None]


def test_mask_cache_matches_reference():
    jg, tg = _geos(8)
    jmc, tmc = jg.mask_cache, tg.mask_cache
    for a, b in [(tmc.density, jmc.density), (tmc.occ_sup, jmc.occ_sup),
                 (tg.occ64, jmc.occ64), (tg._mask_sup_blk, jg._mask_sup_blk)]:
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert tmc.act_shift == jmc.act_shift
    np.testing.assert_array_equal(tg.nonempty_mask().numpy(),
                                  np.asarray(jg.nonempty_mask()))
    pts = np.random.default_rng(0).uniform(-1.1, 1.1, (5000, 3))
    pts = pts.astype(np.float32)
    np.testing.assert_array_equal(tmc.query(torch.as_tensor(pts)).numpy(),
                                  np.asarray(jmc.query(jnp.asarray(pts))))
    np.testing.assert_array_equal(
        tmc.query_nearest(torch.as_tensor(pts)).numpy(),
        np.asarray(jmc.query_nearest(jnp.asarray(pts))))
    assert tg.world_size == jg.world_size and tg.n_samples == jg.n_samples


def test_fixed_size_nonzero_matches_jnp():
    rng = np.random.default_rng(3)
    for p, size in [(0.3, 100), (0.9, 100), (0.0, 7)]:
        m = rng.uniform(size=(20, 17)) < p
        want = np.asarray(jnp.nonzero(jnp.asarray(m).reshape(-1), size=size,
                                      fill_value=-1)[0])
        got = tvb.fixed_size_nonzero(torch.as_tensor(m), size).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("style,blk", [("fine", 8), ("coarse", 8),
                                       ("fine", 1)])
def test_march_matches_reference(style, blk):
    jg, tg = _geos(blk)
    sdf = _sdf(jg.world_size)
    b = rays()
    s_val, thres = 40.0, 1e-4

    jm = jax.jit(lambda g, o, d, v: jg.march(
        g, o, d, v, s_val, thres, "interp", style=style))(
        jnp.asarray(sdf), jnp.asarray(b["rays_o"]), jnp.asarray(b["rays_d"]),
        jnp.asarray(b["viewdirs"]))
    tm = tg.march(torch.as_tensor(sdf), torch.as_tensor(b["rays_o"]),
                  torch.as_tensor(b["rays_d"]), torch.as_tensor(b["viewdirs"]),
                  s_val, thres, "interp", style=style)

    assert float(jm.overflow) == 0.0, "budget too small for the test"
    for name in ("n_valid", "overflow", "k1_frac", "k2_frac"):
        assert float(getattr(tm, name)) == float(getattr(jm, name)), name
    nv = int(jm.n_valid)
    assert 0 < nv < tm.pts.shape[0]

    # identical survivor sets, as sorted (ray_id, step_id)
    def keyed(m, pad):
        rid = np.asarray(m.ray_id)[~pad]
        sid = np.asarray(m.step_id)[~pad]
        order = np.lexsort((sid, rid))
        return rid[order], sid[order], order

    jpad, tpad = np.asarray(jm.pad), tm.pad.numpy()
    jr, js, jo = keyed(jm, jpad)
    tr, ts, to = keyed(tm, tpad)
    np.testing.assert_array_equal(tr, jr)
    np.testing.assert_array_equal(ts, js)
    def matched(name):
        return (getattr(tm, name).detach().numpy()[~tpad][to],
                np.asarray(getattr(jm, name))[~jpad][jo])

    np.testing.assert_allclose(*matched("weights"), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(*matched("sdf"), rtol=1e-5, atol=1e-7)
    # alpha = (prev_cdf - next_cdf + 1e-5) / (prev_cdf + 1e-5) divides by a
    # small sigmoid; XLA:CPU's sigmoid (0.5 + 0.5 tanh) carries ~3e-8
    # absolute error there, torch's is exact to the last bit: rtol 1e-4
    np.testing.assert_allclose(*matched("alpha"), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tm.pts.numpy()[~tpad][to],
                               np.asarray(jm.pts)[~jpad][jo],
                               rtol=1e-6, atol=1e-6)
    for name in ("alphainv_last", "cum_weights"):
        np.testing.assert_allclose(getattr(tm, name).detach().numpy(),
                                   np.asarray(getattr(jm, name)),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
    # the port keeps the cell-sorted row order and the collapsed pad tail
    np.testing.assert_array_equal(tm.ray_id.numpy(), np.asarray(jm.ray_id))
    np.testing.assert_array_equal(tm.pts.numpy()[nv:],
                                  np.broadcast_to(tm.pts.numpy()[nv - 1],
                                                  (len(tpad) - nv, 3)))


def test_segment_sums_and_sdf_features():
    jg, tg = _geos(8)
    sdf = _sdf(jg.world_size, seed=4)
    b = rays(seed=2)
    tm = tg.march(torch.as_tensor(sdf), torch.as_tensor(b["rays_o"]),
                  torch.as_tensor(b["rays_d"]), torch.as_tensor(b["viewdirs"]),
                  40.0, 1e-4, "interp", style="fine")
    pts = tm.pts.detach().numpy()
    vals = np.random.default_rng(5).normal(size=(len(pts), 3))
    vals = vals.astype(np.float32)
    jm_like = jvb.March(
        pts=jnp.asarray(pts), ray_id=jnp.asarray(tm.ray_id.numpy()),
        step_id=None, weights=jnp.asarray(tm.weights.detach().numpy()),
        alpha=None, sdf=None, pad=None, alphainv_last=None, cum_weights=None,
        n_rays=tm.n_rays, overflow=None, n_valid=None, k1_frac=None,
        k2_frac=None)
    np.testing.assert_allclose(
        tg.segment_to_rays(tm, torch.as_tensor(vals)).detach().numpy(),
        np.asarray(jg.segment_to_rays(jm_like, jnp.asarray(vals))),
        rtol=1e-5, atol=1e-6)

    disp = (0.5, 1.0, 1.5, 2.0)
    got = tg.sample_sdfeat_grad_normal(torch.as_tensor(sdf),
                                       torch.as_tensor(pts), disp)
    want = jg.sample_sdfeat_grad_normal(jnp.asarray(sdf), jnp.asarray(pts),
                                        disp)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-5)
