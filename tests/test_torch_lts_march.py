"""Parity of the LTS stage's march pieces with the JAX reference on the same
inputs (the port on the CPU): the surface-band cull (``band_occ64``,
``query_nearest64``) bitwise on axes that are not multiples of 64, and the
banded march with per-sample and block phase 1, explicit budgets and a
near-plane override (the secondary march's arguments)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esrnerf_tpu.models import voxurf_base as jvb
from esrnerf_tpu_torch.models import voxurf_base as tvb
from test_torch_common import ball_density, load_both_cfgs, rays

pytestmark = pytest.mark.quick

BAND = ["app.model.surf_band_factor=14.0", "app.model.num_voxels=32768"]


def _geos(blk):
    jcfg, tcfg = load_both_cfgs(BAND + [f"app.model.phase1_block={blk}"])
    dens = ball_density()
    jmc = jvb.make_mask_cache(dens, [-1, -1, -1], [1, 1, 1], 1e-6, 1e-3, 3)
    tmc = tvb.make_mask_cache(dens, [-1, -1, -1], [1, 1, 1], 1e-6, 1e-3, 3,
                              device="cpu")
    jg = jvb.VoxurfGeometry(jcfg, 0.5, 4.0, [-1, -1, -1], [1, 1, 1], jmc)
    tg = tvb.VoxurfGeometry(tcfg, 0.5, 4.0, [-1, -1, -1], [1, 1, 1], tmc)
    return jg, tg


def _sdf(shape, seed=1, radius=0.5):
    X, Y, Z = shape
    x, y, z = np.mgrid[-1:1:X * 1j, -1:1:Y * 1j, -1:1:Z * 1j]
    r = np.sqrt(x**2 + y**2 + z**2)
    noise = np.random.default_rng(seed).normal(scale=0.05, size=r.shape)
    return (r - radius + noise).astype(np.float32)[..., None]


@pytest.mark.parametrize("shape", [(40, 70, 130), (32, 32, 32), (64, 33, 65)])
@pytest.mark.parametrize("s_val", [40.0, 220.0])
def test_band_occ64_and_query_nearest64_bitwise(shape, s_val):
    jg, tg = _geos(8)
    sdf = _sdf(shape, seed=sum(shape))
    want = np.asarray(jg.band_occ64(jnp.asarray(sdf), jnp.float32(s_val)))
    got = tg.band_occ64(torch.as_tensor(sdf), s_val).numpy()
    assert got.shape == (66, 66, 66)
    np.testing.assert_array_equal(got, want)
    assert 0 < want.sum() < jg.mask_cache.occ64.sum()  # a real cull

    pts = np.random.default_rng(4).uniform(-1.2, 1.2, (20000, 3))
    pts = pts.astype(np.float32)
    np.testing.assert_array_equal(
        tg.query_nearest64(torch.as_tensor(got), torch.as_tensor(pts)).numpy(),
        np.asarray(jg.query_nearest64(jnp.asarray(want), jnp.asarray(pts))))


@pytest.mark.parametrize("box,ref_misses", [
    (((-0.95, -0.3, -0.2), (0.6, 0.95, 0.9)), True),  # inside the mask's box
    (((-1.3, -0.2, -1.1), (0.3, 1.4, 0.9)), True),    # past it on some faces
    (((-4.0, -3.0, -2.5), (3.5, 4.0, 3.0)), False),   # ~4x the mask's box
])
def test_occ64_on_a_model_box_is_a_superset_of_the_mask_tap(box, ref_misses):
    """A stage after coarse has the coarse stage's box, not the mask
    cache's. The geometry's ``occ64`` (``resample_occ64`` on its own box)
    holds every point that the mask cache's nearest tap holds, on points
    over the box (a march samples inside it); the reference's ``occ64``,
    resampled on the mask's box and tapped on the model's partition,
    misses some where the model's box is the smaller."""
    lo, hi = (np.asarray(v, np.float32) for v in box)
    jcfg, tcfg = load_both_cfgs(BAND + ["app.model.phase1_block=8"])
    dens = ball_density()
    mc = tvb.make_mask_cache(dens, [-1, -1, -1], [1, 1, 1], 1e-6, 1e-3, 3,
                             device="cpu")
    tg = tvb.VoxurfGeometry(tcfg, 0.5, 4.0, lo, hi, mc)
    jmc = jvb.make_mask_cache(dens, [-1, -1, -1], [1, 1, 1], 1e-6, 1e-3, 3)
    pts = np.random.default_rng(2).uniform(lo, hi, (200000, 3))
    pts = torch.as_tensor(pts.astype(np.float32))
    want = mc.query_nearest(pts).numpy()
    assert 0 < want.sum() < len(want)
    got = tg.query_nearest64(tg.occ64, pts).numpy()
    assert not (want & ~got).any()
    assert got.sum() < 4 * want.sum()  # a cull still
    ref = tg.query_nearest64(torch.as_tensor(np.asarray(jmc.occ64)),
                             pts).numpy()
    assert (want & ~ref).any() == ref_misses


def _secondary_rays(n, seed):
    """Rays leaving points near the SDF's surface in random directions,
    as the LTS secondary march sees them."""
    r = np.random.default_rng(seed)
    p = r.normal(size=(n, 3))
    p = p / np.linalg.norm(p, axis=-1, keepdims=True) * 0.52
    d = r.normal(size=(n, 3))
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    return p.astype(np.float32), d.astype(np.float32)


def _compare(jm, tm):
    for name in ("n_valid", "overflow"):
        assert float(getattr(tm, name)) == float(getattr(jm, name)), name
    # k = count / budget: jitted XLA multiplies by the budget's reciprocal
    # (one ulp off the division); the counts themselves are equal
    for name in ("k1_frac", "k2_frac"):
        np.testing.assert_allclose(float(getattr(tm, name)),
                                   float(getattr(jm, name)), rtol=2.4e-7,
                                   err_msg=name)
    nv = int(jm.n_valid)
    assert 0 < nv < tm.pts.shape[0]
    np.testing.assert_array_equal(tm.ray_id.numpy(), np.asarray(jm.ray_id))
    np.testing.assert_array_equal(tm.step_id.numpy(), np.asarray(jm.step_id))
    np.testing.assert_array_equal(tm.pad.numpy(), np.asarray(jm.pad))
    np.testing.assert_allclose(tm.pts.numpy(), np.asarray(jm.pts),
                               rtol=1e-6, atol=1e-6)
    # alpha divides by a small sigmoid, where XLA:CPU's (0.5 + 0.5 tanh)
    # carries ~3e-8 absolute error (the fine march's alpha tolerance,
    # tests/test_torch_march.py); a weight is alpha times a transmittance
    # <= 1, so it takes the same bounds
    for name in ("alpha", "weights"):
        np.testing.assert_allclose(getattr(tm, name).detach().numpy(),
                                   np.asarray(getattr(jm, name)), rtol=1e-4,
                                   atol=1e-5, err_msg=name)
    np.testing.assert_allclose(tm.alphainv_last.detach().numpy(),
                               np.asarray(jm.alphainv_last), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("blk", [1, 8])
def test_banded_march_matches_reference(blk):
    """The primary march with the band cull: identical survivors (rows,
    in the cell-sorted order), counters and budgets' utilisations."""
    jg, tg = _geos(blk)
    sdf = _sdf(jg.world_size)
    b = rays()
    s_val, thres = 80.0, 1e-4
    args = [b[k] for k in ("rays_o", "rays_d", "viewdirs")]
    jm = jax.jit(lambda g, o, d, v: jg.march(
        g, o, d, v, s_val, thres, "interp", style="fine"))(
        jnp.asarray(sdf), *map(jnp.asarray, args))
    tm = tg.march(torch.as_tensor(sdf), *map(torch.as_tensor, args), s_val,
                  thres, "interp", style="fine")
    assert float(jm.overflow) == 0.0
    _compare(jm, tm)


@pytest.mark.parametrize("blk", [1, 8])
@pytest.mark.parametrize("k2,k1", [(8, 48), (2, 8)])
def test_secondary_march_budgets_and_near_match_reference(blk, k2, k1):
    """The secondary march's call: ``k_budget``, ``k1_budget`` and
    ``near_override`` from points on the surface; the small budgets
    overflow and both sides drop the same samples."""
    jg, tg = _geos(blk)
    sdf = _sdf(jg.world_size, seed=3)
    o, d = _secondary_rays(96, seed=5)
    s_val, thres = 80.0, 1e-4
    kw = dict(style="fine", k_budget=96 * k2, k1_budget=96 * k1,
              near_override=1e-5)
    jm = jax.jit(lambda g, o_, d_: jg.march(
        g, o_, d_, d_, s_val, thres, "interp", **kw))(
        jnp.asarray(sdf), jnp.asarray(o), jnp.asarray(d))
    tm = tg.march(torch.as_tensor(sdf), torch.as_tensor(o), torch.as_tensor(d),
                  torch.as_tensor(d), s_val, thres, "interp", **kw)
    # K1 is rounded up to whole blocks
    assert tm.k1_frac * ((96 * k1 + blk - 1) // blk * blk) == \
        pytest.approx(float(jm.k1_frac) * ((96 * k1 + blk - 1) // blk * blk))
    if k2 == 2:
        assert float(jm.overflow) > 0.0
    _compare(jm, tm)
