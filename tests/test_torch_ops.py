"""Parity of the PyTorch port's ops (``esrnerf_tpu_torch.ops``, plain
versions on the CPU) with the JAX reference (``esrnerf_tpu.ops``) on the
same numpy inputs: the transmittance scan, the splat and gather with their
autograd pieces, and the stateless ops around them."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esrnerf_tpu.ops import grid as jgrid
from esrnerf_tpu.ops import image as jimage
from esrnerf_tpu.ops import ray as jray
from esrnerf_tpu.ops import render as jrender
from esrnerf_tpu.ops import scan as jscan
from esrnerf_tpu.ops import splat as jsplat
from esrnerf_tpu.ops import tv as jtv
from esrnerf_tpu_torch.ops import grid as tgrid
from esrnerf_tpu_torch.ops import image as timage
from esrnerf_tpu_torch.ops import ray as tray
from esrnerf_tpu_torch.ops import render as trender
from esrnerf_tpu_torch.ops import scan as tscan
from esrnerf_tpu_torch.ops import splat as tsplat
from esrnerf_tpu_torch.ops import tv as ttv

pytestmark = pytest.mark.quick


def T(x, dtype=None):
    t = torch.as_tensor(np.asarray(x))
    return t if dtype is None else t.to(dtype)


def close(a, b, rtol, atol):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    np.testing.assert_allclose(a, np.asarray(b), rtol=rtol, atol=atol)


# ------------------------------------------------------------------- scan


def _scan_inputs(seed, N=37, S=53):
    rng = np.random.default_rng(seed)
    alpha = rng.uniform(0, 0.9, (N, S)).astype(np.float32)
    alpha[3, 10] = 1.0  # saturated sample
    alpha[5] = 0.0  # empty ray
    alpha[7] = 0.9999  # deep early exit
    alpha = np.where(rng.uniform(size=(N, S)) > 0.3, alpha, 0.0)
    ctw = rng.normal(size=(N, S)).astype(np.float32)
    ctl = rng.normal(size=(N,)).astype(np.float32)
    return alpha.astype(np.float32), ctw, ctl


def _scan_port(alpha, ctw, ctl, ee):
    a = T(alpha).requires_grad_(True)
    w, last = tscan.alpha2weights_scan(a, ee)
    ((w * T(ctw)).sum() + (last * T(ctl)).sum()).backward()
    return w, last, a.grad


def _scan_jax(alpha, ctw, ctl, ee):
    def loss(x):
        w, last = jscan.alpha2weights_pallas(x, ee)
        return (w * ctw).sum() + (last * ctl).sum()

    w, last = jscan.alpha2weights_pallas(jnp.asarray(alpha), ee)
    return w, last, jax.grad(loss)(jnp.asarray(alpha))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("ee", [1e-3, -1.0])
def test_scan_matches_reference(seed, ee):
    alpha, ctw, ctl = _scan_inputs(seed)
    w_t, last_t, g_t = _scan_port(alpha, ctw, ctl, ee)
    w_j, last_j, g_j = _scan_jax(alpha, ctw, ctl, ee)
    close(w_t, w_j, 1e-5, 1e-7)
    close(last_t, last_j, 1e-5, 1e-7)
    close(g_t, g_j, 1e-4, 1e-5)


def test_scan_matches_interpreted_kernel(monkeypatch):
    """Against the reference's Pallas kernel itself (interpret mode)."""
    alpha, ctw, ctl = _scan_inputs(3, N=9, S=24)
    monkeypatch.setenv("ESR_SCAN_INTERPRET", "1")
    w_j, last_j, g_j = _scan_jax(alpha, ctw, ctl, 1e-3)
    w_t, last_t, g_t = _scan_port(alpha, ctw, ctl, 1e-3)
    close(w_t, w_j, 1e-5, 1e-7)
    close(last_t, last_j, 1e-5, 1e-7)
    close(g_t, g_j, 1e-4, 1e-5)


@pytest.mark.parametrize("ee", [1e-3, None])
def test_scan_equals_dense_alpha2weights(ee):
    alpha, _, _ = _scan_inputs(4)
    mask = np.random.default_rng(9).uniform(size=alpha.shape) > 0.2
    w_t, last_t = trender.alpha2weights(T(alpha), T(mask), ee)
    w_j, last_j = jrender.alpha2weights(jnp.asarray(alpha),
                                        jnp.asarray(mask), ee)
    close(w_t, w_j, 1e-5, 1e-7)
    close(last_t, last_j, 1e-5, 1e-7)
    am = np.where(mask, alpha, 0.0).astype(np.float32)
    w_s, last_s = tscan.alpha2weights_scan(T(am), -1.0 if ee is None else ee)
    close(w_s, w_t.detach(), 1e-5, 1e-7)
    close(last_s, last_t.detach(), 1e-5, 1e-7)


# -------------------------------------------------------- splat (K-3)


def _streams(rng, M, S, C, n_cells):
    base = np.sort(rng.integers(-4, n_cells, size=M)).astype(np.int32)
    vals = rng.standard_normal((S, C, M)).astype(np.float32)
    offsets = tuple(int(o) for o in rng.integers(0, 300, size=S))
    for s in range(S):
        idx = base + offsets[s]
        vals[s, :, (idx < 0) | (idx >= n_cells)] = 0.0
    return base, vals, offsets


@pytest.mark.parametrize("M,S,C,n_cells,n_valid", [
    (1000, 8, 1, 5000, None),
    (3000, 3, 6, 70000, 2100),
    (17, 2, 2, 40000, 9),
])
def test_sorted_streams_splat(M, S, C, n_cells, n_valid):
    rng = np.random.default_rng(0)
    base, vals, offsets = _streams(rng, M, S, C, n_cells)
    nv = None if n_valid is None else np.int32(n_valid)
    out_t = tsplat.sorted_streams_splat(
        T(base), T(vals), offsets, n_cells,
        n_valid=None if nv is None else T(nv))
    out_j = jsplat.sorted_streams_splat(
        jnp.asarray(base), jnp.asarray(vals), offsets, n_cells,
        n_valid=None if nv is None else jnp.asarray(nv))
    close(out_t, out_j, 1e-5, 1e-5)
    keep = M if n_valid is None else n_valid
    ref = tsplat.splat_oracle(base[:keep], vals[:, :, :keep], offsets,
                              n_cells)
    close(out_t, ref, 1e-5, 1e-5)


def test_sorted_scatter_1d_and_bool():
    rng = np.random.default_rng(2)
    size, M, nv = 900, 300, 260
    idx = np.sort(rng.choice(size - 1, M, replace=False)).astype(np.int32)
    idx[nv:] = size - 1  # pad tail lands on a droppable dump cell
    x = rng.normal(size=M).astype(np.float32)
    b = rng.uniform(size=M) > 0.5
    ct = rng.normal(size=size).astype(np.float32)

    xt = T(x).requires_grad_(True)
    out_t = tsplat.sorted_scatter_1d(T(idx), xt, size, n_valid=T(np.int32(nv)))
    (out_t * T(ct)).sum().backward()
    f = lambda v: jsplat.sorted_scatter_1d(jnp.asarray(idx), v, size,
                                           n_valid=jnp.int32(nv))
    out_j, vjp = jax.vjp(f, jnp.asarray(x))
    close(out_t, out_j, 1e-6, 1e-7)
    close(xt.grad, vjp(jnp.asarray(ct))[0], 1e-6, 1e-7)

    bt = tsplat.sorted_scatter_1d(T(idx), T(b), size, n_valid=T(np.int32(nv)))
    bj = jsplat.sorted_scatter_1d(jnp.asarray(idx), jnp.asarray(b), size,
                                  n_valid=jnp.int32(nv))
    assert bt.dtype == torch.bool
    np.testing.assert_array_equal(bt.numpy(), np.asarray(bj))


def test_sorted_gather_rows():
    rng = np.random.default_rng(3)
    R, C, M, nv = 700, 3, 500, 430
    table = rng.normal(size=(R, C)).astype(np.float32)
    idx = np.sort(rng.integers(0, R, M)).astype(np.int32)
    ct = rng.normal(size=(M, C)).astype(np.float32)
    ct[nv:] = 0.0  # the contract: pad rows carry zero cotangents

    tt = T(table).requires_grad_(True)
    out_t = tsplat.sorted_gather_rows(tt, T(idx), n_valid=T(np.int32(nv)))
    (out_t * T(ct)).sum().backward()
    out_j, vjp = jax.vjp(
        lambda t: jsplat.sorted_gather_rows(t, jnp.asarray(idx),
                                            jnp.int32(nv)),
        jnp.asarray(table))
    close(out_t, out_j, 0, 0)
    close(tt.grad, vjp(jnp.asarray(ct))[0], 1e-5, 1e-6)


def test_permute_rows():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(50, 4)).astype(np.float32)
    perm = rng.permutation(50)
    inv = np.argsort(perm)
    xt = T(x).requires_grad_(True)
    out = tsplat.permute_rows(xt, T(perm), T(inv))
    ct = rng.normal(size=(50, 4)).astype(np.float32)
    (out * T(ct)).sum().backward()
    close(out, x[perm], 0, 0)
    close(xt.grad, ct[inv], 0, 0)


# -------------------------------------------------------- gather (K-4)


@pytest.mark.parametrize("raw", [False, True])
@pytest.mark.parametrize("n_valid", [None, 2048 + 7])
def test_sorted_corner_gather(raw, n_valid):
    rng = np.random.default_rng(5)
    R, M = 30000, 6144
    C = 1 if raw else 3
    offsets = (0, 1, 17, 18, 289, 290, 306, 307)
    table = rng.standard_normal((R, C)).astype(np.float32)
    # include reads past both table ends (clipped, as the plain gather)
    base = np.sort(rng.integers(-5, R - 100, size=M)).astype(np.int32)
    w = None if raw else rng.standard_normal((M, 8)).astype(np.float32)
    nv = None if n_valid is None else np.int32(n_valid)
    out_t = tsplat.sorted_corner_gather(
        T(table), T(base), None if raw else T(w), offsets, raw=raw,
        n_valid=None if nv is None else T(nv))
    out_j = jsplat.sorted_corner_gather(
        jnp.asarray(table), jnp.asarray(base),
        None if raw else jnp.asarray(w), offsets, raw=raw,
        n_valid=None if nv is None else jnp.asarray(nv))
    # XLA:CPU may fuse the weighted sum into FMAs: last-bit differences
    close(out_t, out_j, 1e-6, 1e-6)
    if n_valid is not None:
        # whole 2048-row chunks at or after n_valid read zeros
        assert np.all(out_t.numpy()[4096:] == 0.0)
        assert np.any(out_t.numpy()[2048:4096] != 0.0)


# ------------------------------------------------ trilinear sample / splat


def _sorted_pts(rng, shape3, M):
    pts = rng.uniform(0.001, 0.999, size=(M, 3)).astype(np.float32)
    pts[:5] = 1.0
    pts[5:10] = 0.0
    idx = np.floor(pts * (np.array(shape3) - 1)).astype(np.int64)
    base = (idx[:, 0] * shape3[1] + idx[:, 1]) * shape3[2] + idx[:, 2]
    return pts[np.argsort(base, kind="stable")]


def test_trilinear_splat_is_grid_sample_adjoint():
    rng = np.random.default_rng(2)
    shape = (9, 8, 7, 3)
    pts = rng.uniform(-0.1, 1.1, size=(400, 3)).astype(np.float32)
    ct = rng.standard_normal((400, 3)).astype(np.float32)
    mn, mx = np.zeros(3, np.float32), np.ones(3, np.float32)
    out_t = tsplat.trilinear_splat(shape, T(pts), T(ct), T(mn), T(mx))
    _, vjp = jax.vjp(lambda g: jgrid.grid_sample_3d_impl(
        g, jnp.asarray(pts), jnp.asarray(mn), jnp.asarray(mx)),
        jnp.zeros(shape))
    close(out_t, vjp(jnp.asarray(ct))[0], 2e-4, 2e-5)


def test_grid_sample_3d_forward_and_grad():
    rng = np.random.default_rng(8)
    shape = (10, 9, 8, 2)
    grid = rng.standard_normal(shape).astype(np.float32)
    pts = rng.uniform(-1.1, 1.1, size=(300, 3)).astype(np.float32)
    ct = rng.standard_normal((300, 2)).astype(np.float32)
    mn, mx = -np.ones(3, np.float32), np.ones(3, np.float32)
    gt = T(grid).requires_grad_(True)
    out_t = tgrid.grid_sample_3d(gt, T(pts), T(mn), T(mx))
    (out_t * T(ct)).sum().backward()
    out_j, vjp = jax.vjp(lambda g: jgrid.grid_sample_3d(
        g, jnp.asarray(pts), jnp.asarray(mn), jnp.asarray(mx)),
        jnp.asarray(grid))
    close(out_t, out_j, 1e-5, 1e-6)
    close(gt.grad, vjp(jnp.asarray(ct))[0], 2e-4, 2e-5)
    impl_t = tgrid.grid_sample_3d_impl(T(grid), T(pts), T(mn), T(mx),
                                       "border")
    impl_j = jgrid.grid_sample_3d_impl(jnp.asarray(grid), jnp.asarray(pts),
                                       jnp.asarray(mn), jnp.asarray(mx),
                                       "border")
    close(impl_t, impl_j, 1e-5, 1e-6)


def test_sorted_trilinear_sample_multi():
    rng = np.random.default_rng(11)
    shape3, widths = (10, 9, 8), (6, 6)
    grids = [rng.standard_normal((*shape3, c)).astype(np.float32)
             for c in widths]
    pts = _sorted_pts(rng, shape3, 500)
    mn, mx = np.zeros(3, np.float32), np.ones(3, np.float32)
    nv = np.int32(470)
    cts = [rng.standard_normal((500, c)).astype(np.float32) for c in widths]
    for ct in cts:
        ct[nv:] = 0.0  # pad rows carry zero cotangents

    gts = [T(g).requires_grad_(True) for g in grids]
    outs_t = tsplat.sorted_trilinear_sample_multi(gts, T(pts), T(mn), T(mx),
                                                  T(nv))
    sum((o * T(c)).sum() for o, c in zip(outs_t, cts)).backward()
    outs_j, vjp = jax.vjp(
        lambda gs: jsplat.sorted_trilinear_sample_multi(
            gs, jnp.asarray(pts), jnp.asarray(mn), jnp.asarray(mx),
            jnp.asarray(nv)),
        tuple(jnp.asarray(g) for g in grids))
    dgs = vjp(tuple(jnp.asarray(c) for c in cts))[0]
    for ot, oj, gt, dg in zip(outs_t, outs_j, gts, dgs):
        close(ot, oj, 1e-6, 1e-7)
        close(gt.grad, dg, 2e-4, 2e-5)


@pytest.mark.parametrize("n_valid", [None, 2000])
def test_displaced_taps_forward_and_backward(n_valid):
    rng = np.random.default_rng(13)
    shape = (20, 18, 16, 1)
    M = 2600
    grid = rng.standard_normal(shape).astype(np.float32)
    pts = _sorted_pts(rng, shape[:3], M) * 2.2 - 1.1  # some out of bbox
    mn, mx = -np.ones(3, np.float32), np.ones(3, np.float32)
    disp = (0.5, 1.0, 1.5, 2.0)
    ct = rng.standard_normal((M, 6, 4)).astype(np.float32)
    nv = None if n_valid is None else np.int32(n_valid)
    if nv is not None:
        ct[nv:] = 0.0

    gt = T(grid).requires_grad_(True)
    out_t = tgrid.displaced_taps(gt, T(pts), T(mn), T(mx), disp,
                                 None if nv is None else T(nv))
    (out_t * T(ct)).sum().backward()
    out_j, vjp = jax.vjp(
        lambda g: jgrid.displaced_taps(
            g, jnp.asarray(pts), jnp.asarray(mn), jnp.asarray(mx), disp,
            None if nv is None else jnp.asarray(nv)),
        jnp.asarray(grid))
    rows = M if nv is None else 2048  # later chunks are pad (zeros) here
    close(out_t[:rows], np.asarray(out_j)[:rows], 1e-5, 1e-5)
    if nv is not None:
        assert np.all(out_t.detach().numpy()[2048:] == 0.0)
    close(gt.grad, vjp(jnp.asarray(ct))[0], 2e-4, 2e-5)


# ------------------------------------------------------- stateless ops


def _rays(n, seed=0):
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n, 3)).astype(np.float32)
    o = o / np.linalg.norm(o, axis=-1, keepdims=True) * 2
    d = (rng.normal(scale=0.4, size=(n, 3)).astype(np.float32) - o)
    d[0, 1] = 0.0  # zero component
    return o, d


def test_ray_aabb_and_dense_sampling():
    o, d = _rays(40)
    mn, mx = -np.ones(3, np.float32), np.ones(3, np.float32)
    tt = tray.ray_aabb(T(o), T(d), T(mn), T(mx), 0.5, 1e9)
    tj = jray.ray_aabb(jnp.asarray(o), jnp.asarray(d), jnp.asarray(mn),
                       jnp.asarray(mx), 0.5, 1e9)
    for a, b in zip(tt, tj):
        close(a, b, 1e-6, 1e-6)
    rt = tray.sample_rays_dense(T(o), T(d), T(mn), T(mx), 0.5, 1e9, 0.05, 60)
    rj = jray.sample_rays_dense(jnp.asarray(o), jnp.asarray(d),
                                jnp.asarray(mn), jnp.asarray(mx), 0.5, 1e9,
                                0.05, 60)
    close(rt.pts, rj.pts, 1e-5, 1e-5)
    np.testing.assert_array_equal(rt.valid.numpy(), np.asarray(rj.valid))
    close(rt.n_valid, rj.n_valid, 0, 0)


def test_neus_alpha_interp():
    rng = np.random.default_rng(6)
    sdf = rng.normal(scale=0.3, size=(30, 40)).astype(np.float32)
    mask = rng.uniform(size=(30, 40)) > 0.4
    mask[3] = False
    ct = rng.normal(size=(30, 40)).astype(np.float32)
    st = T(sdf).requires_grad_(True)
    a_t = trender.neus_alpha_interp(st, T(mask), 25.0)
    (a_t * T(ct)).sum().backward()
    a_j, vjp = jax.vjp(lambda s: jrender.neus_alpha_interp(
        s, jnp.asarray(mask), 25.0), jnp.asarray(sdf))
    close(a_t, a_j, 1e-5, 1e-6)
    close(st.grad, vjp(jnp.asarray(ct))[0], 1e-4, 1e-5)


def test_gamma_and_tv_grad():
    rng = np.random.default_rng(7)
    img = rng.uniform(-0.1, 1.5, (50, 3)).astype(np.float32)
    close(timage.apply_gamma_curve(T(img)),
          jimage.apply_gamma_curve(jnp.asarray(img)), 1e-6, 1e-6)
    grid = rng.normal(scale=0.7, size=(7, 6, 5, 1)).astype(np.float32)
    sparse = np.where(rng.uniform(size=grid.shape) > 0.5, 1.0, 0.0)
    mask = rng.uniform(size=grid.shape[:3]) > 0.3
    for kw_t, kw_j in [
        ({}, {}),
        ({"sparse_grad": T(sparse)}, {"sparse_grad": jnp.asarray(sparse)}),
        ({"nonempty_mask": T(mask)}, {"nonempty_mask": jnp.asarray(mask)}),
    ]:
        close(ttv.tv_grad(T(grid), 0.3, 0.2, 0.1, **kw_t),
              jtv.tv_grad(jnp.asarray(grid), 0.3, 0.2, 0.1, **kw_j),
              1e-6, 1e-7)


@pytest.mark.parametrize("ks", [3, 5])
def test_pooling_and_smoothing(ks):
    rng = np.random.default_rng(ks)
    grid = rng.normal(size=(9, 8, 7, 2)).astype(np.float32)
    close(tgrid.max_pool_3d_same(T(grid), ks),
          jgrid.max_pool_3d_same(jnp.asarray(grid), ks), 0, 0)
    kern = jgrid.make_gradient_smooth_kernel_3d()
    np.testing.assert_array_equal(tgrid.make_gradient_smooth_kernel_3d(),
                                  kern)
    close(tgrid.conv3d_replicate(T(grid), kern),
          jgrid.conv3d_replicate(jnp.asarray(grid), kern), 1e-5, 1e-6)
    nonsep = rng.uniform(size=(3, 3, 3)).astype(np.float32)
    close(tgrid.conv3d_replicate(T(grid), nonsep),
          jgrid.conv3d_replicate(jnp.asarray(grid), nonsep), 1e-5, 1e-5)
