"""Parity of the port's PBR functions (``esrnerf_tpu_torch.ops.pbr``) and
its coordinate-differentiable SDF sampler
(``ops.grid.grid_sample_3d_coordgrad``) with the JAX reference on the same
numpy inputs and, for the random ones, the same draws.

Tolerance: the PBR functions within 1e-6 of each output's largest
magnitude (rtol 1e-6, atol 1e-6 x max |want|): XLA's and PyTorch's exp,
sqrt, pow and reductions round differently in the last bits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esrnerf_tpu.ops import grid as jgrid
from esrnerf_tpu.ops import pbr as jpbr
from esrnerf_tpu_torch.ops import grid as tgrid
from esrnerf_tpu_torch.ops import pbr as tpbr

pytestmark = pytest.mark.quick

ACTS = ("softplus", "relu", "abs", "exp", "sigmoid")


def _close(got, want, rtol=1e-6):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale)


def _unit(rng, n):
    v = rng.normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _surface(n=512, seed=0):
    """BRDF inputs as the models give them: sigmoid materials, unit
    normals, hemisphere incoming and outgoing directions."""
    rng = np.random.default_rng(seed)
    normal = _unit(rng, n)
    win, wout = _unit(rng, n), _unit(rng, n)
    win = np.where((win * normal).sum(-1, keepdims=True) < 0, -win, win)
    wout = np.where((wout * normal).sum(-1, keepdims=True) < 0, -wout, wout)
    u = rng.uniform(0.02, 0.98, size=(n, 5)).astype(np.float32)
    return dict(albedo=u[:, :3], roughness=u[:, 3:4], metallic=u[:, 4:5],
                normal=normal, win=win.astype(np.float32),
                wout=wout.astype(np.float32))


def _both(fn_j, fn_t, args):
    return (fn_j(*(jnp.asarray(a) for a in args)),
            fn_t(*(torch.as_tensor(a) for a in args)))


def test_dot_and_normalize_match_reference():
    rng = np.random.default_rng(1)
    a = rng.normal(size=(64, 3)).astype(np.float32)
    b = rng.normal(size=(64, 3)).astype(np.float32)
    a[0] = 0.0  # normalize's eps floor
    want, got = _both(jpbr.dot, tpbr.dot, (a, b))
    _close(got, want)
    want, got = _both(jpbr.normalize, tpbr.normalize, (a,))
    _close(got, want)


def test_diffuse_scattering_from_the_same_draws():
    """The port's deterministic half given the JAX draw of the same key:
    the JAX function's output exactly, and hemisphere directions."""
    rng = np.random.default_rng(2)
    normal = _unit(rng, 40)
    key = jax.random.PRNGKey(5)
    want = jpbr.diffuse_scattering(key, jnp.asarray(normal), 7)
    draws = np.array(jax.random.normal(key, (40, 7, 3), jnp.float32))
    got = tpbr.diffuse_scattering(torch.as_tensor(draws),
                                  torch.as_tensor(normal))
    _close(got, want)
    assert bool(((got * torch.as_tensor(normal)[:, None]).sum(-1) >= 0).all())
    gen = torch.Generator().manual_seed(0)
    d = tpbr.scattering_draws(gen, (40,), 7)
    assert d.shape == (40, 7, 3)


def test_fibonacci_matches_reference():
    for n in (1, 7, 256):
        np.testing.assert_array_equal(tpbr.fibonacci_hemisphere(n),
                                      jpbr.fibonacci_hemisphere(n))
        np.testing.assert_array_equal(tpbr.fibonacci_hemisphere(n, up=False),
                                      jpbr.fibonacci_hemisphere(n, up=False))
        np.testing.assert_array_equal(tpbr.fibonacci_sphere(n),
                                      jpbr.fibonacci_sphere(n))
    normal = _unit(np.random.default_rng(3), 30)
    _close(tpbr.diffuse_scattering_fib(torch.as_tensor(normal), 9),
           jpbr.diffuse_scattering_fib(jnp.asarray(normal), 9))


@pytest.mark.parametrize("name", ["disney", "micro", "tensoir"])
def test_brdfs_match_reference(name):
    s = _surface()
    if name == "disney":
        args = [s[k] for k in ("albedo", "roughness", "metallic", "normal",
                               "win", "wout")]
        want, got = _both(jpbr.disney_reflection, tpbr.disney_reflection,
                          args)
    else:
        args = [s[k] for k in ("albedo", "roughness", "normal", "win",
                               "wout")]
        fj, ft = {"micro": (jpbr.micro_reflection, tpbr.micro_reflection),
                  "tensoir": (jpbr.tensoir_reflection,
                              tpbr.tensoir_reflection)}[name]
        want, got = _both(fj, ft, args)
    assert np.isfinite(np.asarray(want)).all()
    _close(got, want)


@pytest.mark.parametrize("act", ACTS)
def test_sg_envmap_and_init_match_reference(act):
    """``init_sg_params`` from the JAX draws of one key, then the envmap at
    unit directions."""
    key = jax.random.PRNGKey(4)
    want_p = jpbr.init_sg_params(key, 48, act)
    k1, k2, k3 = jax.random.split(key, 3)
    draws = (jax.random.normal(k1, (48, 3)), jax.random.normal(k2, (48, 1)),
             jax.random.normal(k3, (48, 3)))
    got_p = tpbr.init_sg_params(tuple(torch.as_tensor(np.array(d))
                                      for d in draws), act)
    for k in ("mus", "lambdas", "lobes"):
        _close(got_p[k], want_p[k])
    dirs = _unit(np.random.default_rng(6), 300)
    jact = {"softplus": jax.nn.softplus, "relu": jax.nn.relu, "abs": jnp.abs,
            "exp": jnp.exp, "sigmoid": jax.nn.sigmoid}[act]
    want = jpbr.sg_envmap(want_p["mus"], want_p["lambdas"], want_p["lobes"],
                          jnp.asarray(dirs), activation=jact)
    got = tpbr.sg_envmap(got_p["mus"], got_p["lambdas"], got_p["lobes"],
                         torch.as_tensor(dirs),
                         activation=tpbr.ACTIVATIONS[act])
    _close(got, want)
    gen = torch.Generator().manual_seed(0)
    assert [tuple(d.shape) for d in tpbr.init_sg_draws(gen, 48)] == \
        [(48, 3), (48, 1), (48, 3)]


# ---------------------------------------------- grid_sample_3d_coordgrad


@pytest.fixture(scope="module")
def coordgrad_inputs():
    rng = np.random.default_rng(8)
    grid = rng.normal(size=(9, 7, 11, 1)).astype(np.float32)
    # inside, on faces and outside the bbox (zero padding)
    pts = rng.uniform(-1.15, 1.15, size=(400, 3)).astype(np.float32)
    pts[:5] = [[-1, -1, -1], [1, 1, 1], [1, 0.3, -1], [0, 0, 0],
               [-0.5, 1.0, 0.25]]
    ct_v = rng.normal(size=(400,)).astype(np.float32)
    ct_g = rng.normal(size=(400, 3)).astype(np.float32)
    lo = np.array([-1, -0.9, -1.1], np.float32)
    hi = np.array([1, 1.05, 0.95], np.float32)
    return grid, pts, ct_v, ct_g, lo, hi


def test_coordgrad_values_and_spatial_gradient(coordgrad_inputs):
    """Values and closed-form spatial gradient within float rounding of the
    JAX function; the value equals the trilinear sampler's and the
    gradient equals autograd's derivative of the value w.r.t. ``xyz``."""
    grid, pts, _, _, lo, hi = coordgrad_inputs
    vj, gj = jgrid.grid_sample_3d_coordgrad(
        jnp.asarray(grid), jnp.asarray(pts), jnp.asarray(lo), jnp.asarray(hi))
    x = torch.as_tensor(pts).requires_grad_(True)
    vt, gt = tgrid.grid_sample_3d_coordgrad(
        torch.as_tensor(grid), x, torch.as_tensor(lo), torch.as_tensor(hi))
    np.testing.assert_allclose(vt.detach().numpy(), np.asarray(vj),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(gt.detach().numpy(), np.asarray(gj),
                               rtol=1e-5, atol=1e-5)
    plain = tgrid.grid_sample_3d_impl(torch.as_tensor(grid),
                                      torch.as_tensor(pts),
                                      torch.as_tensor(lo),
                                      torch.as_tensor(hi))[:, 0]
    np.testing.assert_allclose(vt.detach().numpy(), plain.numpy(), rtol=1e-6,
                               atol=1e-6)
    (dx,) = torch.autograd.grad(vt.sum(), x)
    np.testing.assert_allclose(dx.numpy(), gt.detach().numpy(), rtol=1e-5,
                               atol=1e-5)


def test_coordgrad_vjp_in_grid_and_xyz(coordgrad_inputs):
    """Both outputs' VJP w.r.t. the grid and w.r.t. ``xyz`` against
    ``jax.vjp`` of the JAX function."""
    grid, pts, ct_v, ct_g, lo, hi = coordgrad_inputs
    _, vjp = jax.vjp(lambda g, p: jgrid.grid_sample_3d_coordgrad(
        g, p, jnp.asarray(lo), jnp.asarray(hi)),
        jnp.asarray(grid), jnp.asarray(pts))
    dg_j, dp_j = vjp((jnp.asarray(ct_v), jnp.asarray(ct_g)))
    g = torch.as_tensor(grid).requires_grad_(True)
    p = torch.as_tensor(pts).requires_grad_(True)
    v, gr = tgrid.grid_sample_3d_coordgrad(g, p, torch.as_tensor(lo),
                                           torch.as_tensor(hi))
    dg_t, dp_t = torch.autograd.grad(
        (v * torch.as_tensor(ct_v)).sum() + (gr * torch.as_tensor(ct_g)).sum(),
        (g, p))
    for got, want in ((dg_t, dg_j), (dp_t, dp_j)):
        scale = float(np.abs(np.asarray(want)).max())
        assert scale > 0
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5 * scale)
