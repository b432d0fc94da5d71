"""The gather microbenchmarks' kernels, K-5 (``scripts/bench_gather_grid.py``)
and K-6 (``scripts/bench_gather_parts.py``): the port's plain versions
(``esrnerf_tpu_torch.ops.gather_bench``) against the scripts' own Pallas
bodies run in interpret mode on the CPU, on random tables from a seeded
numpy generator. The port's entry points run on the CPU at a cut size."""

import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from esrnerf_tpu_torch.ops import gather_bench as gb
from test_torch_common import REPO

pytestmark = pytest.mark.quick

sys.path.insert(0, os.path.join(REPO, "scripts"))
import bench_gather_grid as k5  # noqa: E402
import bench_gather_parts as k6  # noqa: E402


def _k5_inputs(nch, rng):
    """Chunks whose windows start off a tile boundary, spans of a few tiles
    (the body's loop runs) or less, and lanes that fall below the window,
    past its end and past GCAP."""
    w0 = (np.arange(nch) * gb.GCAP + 50).astype(np.int32)
    gf = w0[:, None] + rng.integers(0, 1500, (nch, 16))
    gf[:, -1] = w0 + gb.GCAP - 200  # lanes past GCAP
    gl = gf + rng.integers(0, 700, (nch, 16))
    idx = gf[:, :, None] + rng.integers(-300, 900, (nch, 16, gb.GROUP))
    tiles = nch * gb.NCAP_T + gb.EXT_T + 8
    tbl = rng.normal(size=(tiles, 1, gb.GROUP)).astype(np.float32)
    return (w0, gf.astype(np.int32), gl.astype(np.int32),
            idx.reshape(nch * 16, gb.GROUP).astype(np.int32), tbl)


def _k5_pallas(nch, w0, gf, gl, idx, tbl):
    """The pallas_call of bench_gather_grid.run, interpreted."""
    fn = pl.pallas_call(
        functools.partial(k5.body, jax.lax.Precision.HIGHEST, False),
        grid_spec=pltpu.PrefetchScalarGridSpec(
            num_scalar_prefetch=3,
            grid=(nch,),
            in_specs=[pl.BlockSpec(memory_space=pl.ANY),
                      pl.BlockSpec(memory_space=pl.ANY)],
            out_specs=pl.BlockSpec((1, k5.K * k5.W, 2048),
                                   lambda c, *_: (c, 0, 0)),
            scratch_shapes=[
                pltpu.VMEM((16, k5.GROUP), jnp.int32),
                pltpu.VMEM((k5.NCAP_T + k5.EXT_T, 1, k5.GROUP), jnp.float32),
                pltpu.VMEM((3, 1, k5.GROUP), jnp.float32),
                pltpu.SemaphoreType.DMA((3,)),
            ],
        ),
        out_shape=jax.ShapeDtypeStruct((nch, k5.K * k5.W, 2048), jnp.float32),
        interpret=True,
    )
    return np.asarray(fn(*map(jnp.asarray, (w0, gf, gl, idx, tbl))))


def test_gather_grid_matches_pallas_body():
    rng = np.random.default_rng(0)
    w0, gf, gl, idx, tbl = _k5_inputs(1, rng)
    want = _k5_pallas(1, w0, gf, gl, idx, tbl)
    got = gb.gather_grid(*map(torch.as_tensor, (tbl, idx, w0, gf, gl)))
    assert got.shape == want.shape
    # every branch of the body is taken: hits, misses and the span loop
    assert (want == 0).mean() > 0.1 and (want != 0).mean() > 0.3
    np.testing.assert_array_equal(got.numpy(), want)


def _k6_pallas(mode, tbl, monkeypatch, npiece=2):
    monkeypatch.setattr(k6, "NPIECE", npiece)
    fn = pl.pallas_call(
        functools.partial(k6.body, mode, jax.lax.Precision.HIGHEST),
        grid_spec=pltpu.PrefetchScalarGridSpec(
            num_scalar_prefetch=0,
            grid=(1,),
            in_specs=[pl.BlockSpec(memory_space=pl.ANY)],
            out_specs=pl.BlockSpec((1, k6.K * k6.W, 2048),
                                   lambda c: (c, 0, 0)),
            scratch_shapes=[
                pltpu.VMEM((k6.NCAP_T + k6.EXT_T, 1, k6.GROUP), jnp.float32),
                pltpu.SemaphoreType.DMA,
            ],
        ),
        out_shape=jax.ShapeDtypeStruct((1, k6.K * k6.W, 2048), jnp.float32),
        interpret=True,
    )
    return np.asarray(fn(jnp.asarray(tbl)))


@pytest.mark.parametrize("mode", ["full", "build", "dma"])
def test_gather_parts_matches_pallas_body(mode, monkeypatch):
    rng = np.random.default_rng(0)
    tiles = 2 * gb.NCAP_T + gb.EXT_T + 8
    tbl = rng.normal(size=(tiles, 1, gb.GROUP)).astype(np.float32)
    want = _k6_pallas(mode, tbl, monkeypatch)
    got = gb.gather_parts(torch.as_tensor(tbl), mode, npiece=2).numpy()
    assert got.shape == want.shape
    if mode == "full":
        assert (want != 0).any()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("mode", ["full", "build", "dma"])
def test_gather_parts_zero_pieces_matches_pallas_body(mode, monkeypatch):
    """No piece swept: the body's loop never runs and the output is zeros.
    The body's copy is traced at one piece's size, so its table holds one
    piece; the port takes just the EXT_T tiles the contract needs."""
    rng = np.random.default_rng(2)
    tbl = rng.normal(size=(gb.NCAP_T + gb.EXT_T, 1, gb.GROUP)).astype(
        np.float32)
    want = _k6_pallas(mode, tbl, monkeypatch, npiece=0)
    got = gb.gather_parts(torch.as_tensor(tbl[:gb.EXT_T]), mode,
                          npiece=0).numpy()
    assert got.shape == want.shape == (1, gb.K * gb.W, gb.LANES)
    assert not want.any()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", ["full", "build", "dma"])
@pytest.mark.parametrize("npiece", [0, 1, 3])
def test_gather_parts_exact_table(mode, npiece):
    """A table of exactly npiece * GCAP + 256 words is enough (the last
    piece's two extra tiles end at its last word) and gives the result of
    a padded table; one tile fewer is refused."""
    rng = np.random.default_rng(3)
    tiles = npiece * gb.NCAP_T + gb.EXT_T
    padded = rng.normal(size=(tiles + 8, 1, gb.GROUP)).astype(np.float32)
    exact = torch.as_tensor(padded[:tiles].copy())
    assert exact.numel() == npiece * gb.GCAP + 256
    got = gb.gather_parts(exact, mode, npiece)
    assert torch.equal(got, gb.gather_parts(torch.as_tensor(padded), mode,
                                            npiece))
    if mode == "full" and npiece:
        assert bool((got != 0).any())
    with pytest.raises(ValueError, match="table needs"):
        gb.gather_parts(exact[:-1], mode, npiece)


def test_gather_parts_when_is_full_and_bad_inputs_raise():
    rng = np.random.default_rng(1)
    tbl = torch.as_tensor(rng.normal(
        size=(gb.NCAP_T + gb.EXT_T, 1, gb.GROUP)).astype(np.float32))
    assert torch.equal(gb.gather_parts(tbl, "when", 1),
                       gb.gather_parts(tbl, "full", 1))
    with pytest.raises(ValueError, match="table needs"):
        gb.gather_parts(tbl, "full", 2)
    with pytest.raises(ValueError, match="unknown mode"):
        gb.gather_parts(tbl, "matmul", 1)


@pytest.mark.parametrize("name", ["bench_gather_grid", "bench_gather_parts"])
def test_bench_entry_points_on_cpu(name, capsys):
    import importlib

    mod = importlib.import_module(f"esrnerf_tpu_torch.scripts.{name}")
    assert mod.main(["--device", "cpu", "--size", "2", "--reps", "1"]) == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if "ms total" in ln]
    assert len(lines) == 3, lines
