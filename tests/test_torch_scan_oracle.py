"""Transmittance-scan (K-1 forward, K-2 backward) cases, their sequential
float32 numpy oracle and the gradient check, free of JAX so that the card's
tests (``tests/test_torch_cuda.py``) import them on a machine without it.

The cases are shaped like the edges of the kernels' ``[N, S]`` design: N no
multiple of the 32-ray block, S no multiple of 4 (the cp.async route) or of
the 32-sample tile, S = 1, rays that exit at their first sample, no exit at
all (``ee = -1``), alpha exactly 1, all-zero rays, the 24-alpha bands
``chip_smoke.py`` draws (transmittances ending near the 1e-3 threshold), the
fine step's opaque surfaces with sparse cotangents of order 1e-5, and rows
longer than the kernels' ring of tiles.

The oracle does the kernels' operations in their order.
``tests/test_torch_scan_cases.py`` holds it to the JAX package's Pallas
kernels and the port to both.
"""

import numpy as np
import pytest

pytestmark = pytest.mark.quick

# id: (N, S, early exit, alpha pattern)
SCAN_CASES = {
    "n45_s40": (45, 40, 1e-3, "random"),  # S: a tail tile of 8 samples
    "s37_cp_async": (64, 37, 1e-3, "random"),  # S % 4 != 0
    "s1": (33, 1, 1e-3, "random"),
    "exit_first": (40, 24, 1e-3, "exit_first"),
    "no_exit": (50, 44, -1.0, "random"),
    "alpha_one": (40, 36, 1e-3, "alpha_one"),
    "alpha_one_no_exit": (34, 20, -1.0, "alpha_one"),
    "zero_rays": (37, 32, 1e-3, "zero_rays"),
    "band24": (96, 64, 1e-3, "band24"),
    # the fine step's inputs: surfaces of alpha exactly 1 (T is 0 behind
    # them), cotangents zero but for a few kept samples
    "opaque_sparse_ct": (80, 96, 1e-3, "opaque"),
    # ten tiles: the ring of stages wraps; the second with a tail
    "band24_ring": (70, 300, 1e-3, "band24"),
    "band24_ring_cp_async": (33, 301, 1e-3, "band24"),
}


def band24(rng, N, S):
    """Per ray a band of 24 alphas in [0, 0.5) at a random depth, zeros
    elsewhere: ``chip_smoke.py``'s scan inputs, whose transmittance ends
    near the 1e-3 early-exit threshold."""
    alpha = np.zeros((N, S), np.float32)
    start = rng.integers(0, max(1, S - 24), N)
    for j in range(24):
        cols = np.minimum(start + j, S - 1)
        alpha[np.arange(N), cols] = rng.uniform(0, 0.5, N)
    return alpha


def scan_case(name, seed=0):
    """``(alpha [N, S], ct_w [N, S], ct_last [N], ee)``, float32."""
    N, S, ee, kind = SCAN_CASES[name]
    rng = np.random.default_rng(seed)
    if kind in ("band24", "opaque"):
        alpha = band24(rng, N, S)
    else:
        alpha = rng.uniform(0, 0.9, (N, S)).astype(np.float32)
        alpha = np.where(rng.uniform(size=(N, S)) > 0.3, alpha, 0.0)
    if kind == "exit_first":
        alpha[::2, 0] = 0.9995  # T leaves the first sample at 5e-4
    elif kind == "alpha_one":
        for r, s in ((0, 0), (3, S // 2), (5, S - 1), (7, 1), (9, S // 3)):
            alpha[r, s] = 1.0
    elif kind == "zero_rays":
        alpha[::2] = 0.0
    ctw = rng.normal(size=(N, S)).astype(np.float32)
    ctl = rng.normal(size=(N,)).astype(np.float32)
    if kind == "opaque":
        alpha[::2, S // 2] = 1.0
        ctw = np.where(rng.uniform(size=(N, S)) < 0.05, 1e-5 * ctw, 0.0)
        ctl = 1e-5 * ctl
    return alpha.astype(np.float32), ctw.astype(np.float32), ctl, ee


def scan_fwd_oracle(alpha, ee):
    """K-1 as a sequential float32 loop over the samples, vectorised over
    rays: ``(w, t_in [N, S], last [N])``."""
    alpha = np.asarray(alpha, np.float32)
    ee, one, zero = np.float32(ee), np.float32(1), np.float32(0)
    T = np.ones(alpha.shape[0], np.float32)
    w, tin = np.empty_like(alpha), np.empty_like(alpha)
    for s in range(alpha.shape[1]):
        a_eff = np.where(T >= ee, alpha[:, s], zero)
        tin[:, s] = T
        w[:, s] = a_eff * T
        T = T * (one - a_eff)
    return w, tin, T


def scan_bwd_oracle(alpha, tin, ctw, ctl, ee):
    """K-2 as a sequential float32 loop from the last sample to the
    first: ``d_alpha [N, S]``."""
    alpha, tin, ctw = (np.asarray(x, np.float32) for x in (alpha, tin, ctw))
    ee, one, zero = np.float32(ee), np.float32(1), np.float32(0)
    d = np.zeros_like(alpha)
    if alpha.shape[1] == 0:
        return d
    tl = tin[:, -1]
    A = (tl * (one - np.where(tl >= ee, alpha[:, -1], zero))) * ctl
    for s in reversed(range(alpha.shape[1])):
        T = tin[:, s]
        live = T >= ee
        a_eff = np.where(live, alpha[:, s], zero)
        grad = T * ctw[:, s] - A / np.maximum(one - a_eff, np.float32(1e-10))
        d[:, s] = np.where(live, grad, zero)
        A = A + (a_eff * T) * ctw[:, s]
    return d


def assert_grad_close(got, want, rtol, atol):
    """``got`` within ``rtol`` and an ``atol`` scaled to the case's
    gradients: ``atol * min(1, max |want|)``. Unit-scale cotangents keep
    ``atol`` itself; the sparse 1e-5 cotangents of the fine step scale it
    down with their gradients, so a wrong gradient cannot hide under it."""
    got, want = (np.asarray(x, np.float32) for x in (got, want))
    scale = min(1.0, float(np.abs(want).max(initial=0.0)))
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol * scale)


@pytest.mark.parametrize("name", list(SCAN_CASES))
def test_grad_check_catches_wrong_gradients(name):
    """At every tolerance the scan's tests use, the check refuses a
    gradient halved or zeroed (the oracle's own), on every case, the
    sparse-cotangent one included."""
    alpha, ctw, ctl, ee = scan_case(name)
    _, tin, _ = scan_fwd_oracle(alpha, ee)
    g = scan_bwd_oracle(alpha, tin, ctw, ctl, ee)
    assert np.abs(g).max() > 0
    for rtol, atol in ((1e-4, 1e-5), (1e-5, 1e-6)):
        assert_grad_close(g, g, rtol, atol)
        for wrong in (0.5 * g, np.zeros_like(g)):
            with pytest.raises(AssertionError):
                assert_grad_close(wrong, g, rtol, atol)
