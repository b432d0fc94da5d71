"""The port's CUDA kernels against their plain PyTorch versions on the card,
at small shapes. Marked ``cuda``: they skip without a GPU. On a machine
with one, run them without the JAX test setup:

    python -m pytest tests/test_torch_cuda.py -q --noconftest
"""

import numpy as np
import pytest
import torch

from test_torch_splat_gather_cases import (GATHER_CASES, SPLAT_CASES,
                                           gather_case, splat_case)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (the port's CUDA kernels)")
    return torch.device("cuda", 0)


def _close(a, b, rtol, atol):
    np.testing.assert_allclose(a.detach().cpu().numpy(),
                               b.detach().cpu().numpy(), rtol=rtol, atol=atol)


def test_scan_kernels(dev):
    from esrnerf_tpu_torch.ops import kernels
    from esrnerf_tpu_torch.ops import scan as scanops

    rng = np.random.default_rng(0)
    a = torch.as_tensor(rng.uniform(0, 0.9, (53, 700)).astype(np.float32),
                        device=dev)
    a[10, 3] = 1.0
    ctw = torch.randn(53, 700, device=dev)
    ctl = torch.randn(700, device=dev)
    n0 = kernels.launches["scan_fwd"]
    for got, want in zip(scanops.scan_forward(a, 1e-3),
                         scanops._fwd_plain(a, 1e-3)):
        _close(got, want, 1e-5, 1e-6)
    assert kernels.launches["scan_fwd"] == n0 + 1
    _, tin, _ = scanops._fwd_plain(a, 1e-3)
    _close(scanops.scan_backward(a, tin, ctw, ctl, 1e-3),
           scanops._bwd_plain(a, tin, ctw, ctl, 1e-3), 1e-4, 1e-5)


@pytest.mark.parametrize("C,S,n_valid", [(1, 8, None), (6, 8, 5000),
                                         (2, 1, 77)])
def test_splat_kernel(dev, C, S, n_valid):
    from esrnerf_tpu_torch.ops import splat as splatops

    rng = np.random.default_rng(1)
    M, n_cells = 6000, 20000
    base = torch.as_tensor(np.sort(rng.integers(-5, n_cells, M)),
                           device=dev)
    vals = torch.randn(S, C, M, device=dev)
    offs = tuple(int(o) for o in rng.integers(0, 300, S))
    nv = None if n_valid is None else torch.tensor(n_valid, device=dev)
    got = splatops.sorted_streams_splat(base, vals, offs, n_cells, nv)
    want = splatops._splat_plain(base, vals, offs,
                                 torch.zeros((n_cells, C), device=dev), nv)
    _close(got, want, 5e-4, 5e-5)


@pytest.mark.parametrize("raw", [False, True])
def test_gather_kernel(dev, raw):
    from esrnerf_tpu_torch.ops import splat as splatops

    rng = np.random.default_rng(2)
    R, M = 30000, 6144
    C = 1 if raw else 12
    offs = (0, 1, 17, 18, 289, 290, 306, 307)
    table = torch.randn(R, C, device=dev)
    base = torch.as_tensor(np.sort(rng.integers(-5, R, M)), device=dev)
    w = None if raw else torch.rand(M, 8, device=dev)
    nv = torch.tensor(2048 + 7, device=dev)
    got = splatops.sorted_corner_gather(table, base, w, offs, raw, nv)
    want = splatops._gather_plain(table, base, w, offs, raw, nv)
    _close(got, want, 0, 0)
    assert float(got[4096:].abs().max()) == 0.0


@pytest.mark.parametrize("name", list(SPLAT_CASES))
def test_splat_kernel_cases(dev, name):
    from esrnerf_tpu_torch.ops import kernels
    from esrnerf_tpu_torch.ops import splat as splatops

    base, vals, offs, n_cells, n_valid = splat_case(name)
    base, vals = torch.as_tensor(base, device=dev), torch.as_tensor(
        vals, device=dev)
    nv = None if n_valid is None else torch.tensor(n_valid, device=dev)
    n0 = kernels.launches["splat"]
    got = splatops.sorted_streams_splat(base, vals, offs, n_cells, nv)
    assert kernels.launches["splat"] == n0 + 1
    want = splatops._splat_plain(
        base, vals, offs, torch.zeros((n_cells, vals.shape[1]), device=dev),
        nv)
    _close(got, want, 5e-4, 5e-5)


@pytest.mark.parametrize("name", list(GATHER_CASES))
def test_gather_kernel_cases(dev, name):
    from esrnerf_tpu_torch.ops import kernels
    from esrnerf_tpu_torch.ops import splat as splatops

    table, base, w, offs, raw, n_valid = gather_case(name)
    table, base = torch.as_tensor(table, device=dev), torch.as_tensor(
        base, device=dev)
    w = None if raw else torch.as_tensor(w, device=dev)
    nv = None if n_valid is None else torch.tensor(n_valid, device=dev)
    key = "gather_raw" if raw else "gather_weighted"
    n0 = kernels.launches[key]
    got = splatops.sorted_corner_gather(table, base, w, offs, raw, nv)
    assert kernels.launches[key] == n0 + 1
    _close(got, splatops._gather_plain(table, base, w, offs, raw, nv), 0, 0)


@pytest.mark.parametrize("tight", [True, False])
def test_gather_grid_kernel(dev, tight):
    from esrnerf_tpu_torch.ops import gather_bench as gb
    from esrnerf_tpu_torch.ops import kernels
    from esrnerf_tpu_torch.scripts.bench_gather_grid import make_inputs

    a = {k: torch.as_tensor(v, device=dev)
         for k, v in make_inputs(tight, nch=4).items()}
    # lanes below, inside and past their windows
    a["idx"][::3] -= 700
    n0 = kernels.launches["gather_grid"]
    got = gb.gather_grid(a["tbl"], a["idx"], a["w0"], a["gf"], a["gl"])
    assert kernels.launches["gather_grid"] == n0 + 1
    want = gb._gather_grid_plain(a["tbl"].reshape(-1), a["idx"], a["w0"],
                                 a["gf"], a["gl"])
    _close(got, want, 0, 0)


@pytest.mark.parametrize("mode", ["dma", "build", "full"])
def test_gather_parts_kernel(dev, mode):
    from esrnerf_tpu_torch.ops import gather_bench as gb
    from esrnerf_tpu_torch.scripts.bench_gather_parts import make_table

    tbl = torch.as_tensor(make_table(3), device=dev)
    got = gb.gather_parts(tbl, mode, 3)
    want = gb._gather_parts_plain(tbl.reshape(-1), mode, 3)
    _close(got, want, 0, 1e-6)
