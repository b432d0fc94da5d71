"""The transmittance scan (K-1 forward, K-2 backward) against the JAX
package, on the ``[N, S]`` cases of ``tests/test_torch_scan_oracle.py``.

Their sequential float32 numpy oracle is held to the JAX package's Pallas
kernels themselves (interpret mode), and the port's ``alpha2weights_scan``
(plain versions on the CPU) to the JAX package and to the oracle. Gradients
are compared with ``assert_grad_close``, whose atol scales with each case's
gradients. ``tests/test_torch_cuda.py`` runs the same cases through the
kernels on the card, on both routes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esrnerf_tpu.ops import scan as jscan
from esrnerf_tpu_torch.ops import scan as tscan
from test_torch_scan_oracle import (SCAN_CASES, assert_grad_close, scan_case,
                                    scan_bwd_oracle, scan_fwd_oracle)

pytestmark = pytest.mark.quick


def _jax_scan(alpha, ctw, ctl, ee):
    (w, last), vjp = jax.vjp(lambda x: jscan.alpha2weights_pallas(x, ee),
                             jnp.asarray(alpha))
    (g,) = vjp((jnp.asarray(ctw), jnp.asarray(ctl)))
    return np.asarray(w), np.asarray(last), np.asarray(g)


@pytest.mark.parametrize("name", list(SCAN_CASES))
def test_oracle_matches_interpreted_kernel(monkeypatch, name):
    """The oracle against the reference's Pallas kernels themselves
    (interpret mode). The forward is bitwise; XLA:CPU may contract the
    backward's ``T*c - q`` and ``A + w*c`` into FMAs, hence rtol 1e-5 /
    atol 1e-6 (scaled to the case's gradients) there."""
    alpha, ctw, ctl, ee = scan_case(name)
    monkeypatch.setenv("ESR_SCAN_INTERPRET", "1")
    w_j, last_j, g_j = _jax_scan(alpha, ctw, ctl, ee)
    w_o, tin_o, last_o = scan_fwd_oracle(alpha, ee)
    np.testing.assert_array_equal(w_o, w_j)
    np.testing.assert_array_equal(last_o, last_j)
    g_o = scan_bwd_oracle(alpha, tin_o, ctw, ctl, ee)
    assert_grad_close(g_o, g_j, 1e-5, 1e-6)


@pytest.mark.parametrize("name", list(SCAN_CASES))
def test_port_matches_jax_and_oracle(name):
    """The port's ``alpha2weights_scan`` (forward and autograd backward)
    against the JAX package (its plain path on the CPU) at the tolerances
    of ``test_torch_ops.py``, and against the oracle: the forward at rtol
    1e-6 / atol 1e-7 (PyTorch's CPU cumprod carries its products in
    double; on the card it carries them in float, in sample order, and K-1
    equals the plain version bitwise), the backward at rtol 1e-4 / atol
    1e-5 scaled to the case's gradients (the plain version sums the tail
    as a cumsum difference)."""
    alpha, ctw, ctl, ee = scan_case(name)
    a = torch.as_tensor(alpha).requires_grad_(True)
    w, last = tscan.alpha2weights_scan(a, ee)
    (g,) = torch.autograd.grad((w, last), a, (torch.as_tensor(ctw),
                                              torch.as_tensor(ctl)))
    w, last, g = (x.detach().numpy() for x in (w, last, g))
    w_j, last_j, g_j = _jax_scan(alpha, ctw, ctl, ee)
    np.testing.assert_allclose(w, w_j, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(last, last_j, rtol=1e-5, atol=1e-7)
    assert_grad_close(g, g_j, 1e-4, 1e-5)
    w_o, tin_o, last_o = scan_fwd_oracle(alpha, ee)
    np.testing.assert_allclose(w, w_o, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(last, last_o, rtol=1e-6, atol=1e-7)
    _, tin, _ = tscan._fwd_plain(torch.as_tensor(alpha), ee)
    np.testing.assert_allclose(tin.numpy(), tin_o, rtol=1e-6, atol=1e-7)
    assert_grad_close(g, scan_bwd_oracle(alpha, tin_o, ctw, ctl, ee), 1e-4,
                      1e-5)


def test_plain_versions_keep_the_layout():
    """The plain versions take and return ``[N, S]`` (contiguous), and
    match the reference's ``[S, N]`` jnp mirrors transposed (XLA's and
    PyTorch's CPU cumprods round differently: rtol 1e-6 / atol 1e-7)."""
    alpha, ctw, ctl, ee = scan_case("band24")
    w, tin, last = tscan._fwd_plain(torch.as_tensor(alpha), ee)
    assert w.shape == tin.shape == alpha.shape and last.shape == (96,)
    assert w.is_contiguous() and tin.is_contiguous()
    w_j, tin_j, last_j = jscan._fwd_jnp(ee, jnp.asarray(alpha.T))
    for got, want in ((w, np.asarray(w_j).T), (tin, np.asarray(tin_j).T),
                      (last, np.asarray(last_j)[0])):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
    d = tscan._bwd_plain(torch.as_tensor(alpha), tin, torch.as_tensor(ctw),
                         torch.as_tensor(ctl), ee)
    assert d.shape == alpha.shape and d.is_contiguous()
    d_j = jscan._bwd_jnp(ee, jnp.asarray(alpha.T), jnp.asarray(tin.numpy().T),
                         jnp.asarray(ctw.T), jnp.asarray(ctl[None]))
    assert_grad_close(d.numpy(), np.asarray(d_j).T, 1e-4, 1e-5)
