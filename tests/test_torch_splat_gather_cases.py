"""Splat (K-3) and corner-gather (K-4) cases shaped like the inputs the
kernels' designs lean on -- long runs of equal rows, the displaced taps'
24 window streams, C of 1, 6 and 12, rows off both table ends, ``n_valid``
inside a 2048-row chunk and on its edge, unsorted bases, and sizes that
are no multiple of any tile -- held on the CPU to the JAX package's
``sorted_streams_splat`` / ``sorted_corner_gather`` (their plain
reference) and to numpy oracles. ``tests/test_torch_cuda.py`` runs the
same cases through the kernels on the card.

Also records, for one fine step at micro scale, which splat call sites
pass an ascending ``base`` (the kernels stay correct without it).
"""

import numpy as np
import pytest
import torch

from esrnerf_tpu_torch.ops import splat as tsplat

pytestmark = pytest.mark.quick


def corner_offsets(shape):
    """The 8 trilinear corner row shifts of an ``[X, Y, Z]`` grid."""
    _, Y, Z = shape
    return tuple((d >> 2 & 1) * Y * Z + (d >> 1 & 1) * Z + (d & 1)
                 for d in range(8))


def taps_offsets(shape, axis, W=6):
    """The displaced taps' 4W window streams along ``axis``:
    ``db*sb + dc*sc + jj*sa`` (``ops/splat.py::displaced_taps_splat``)."""
    _, Y, Z = shape
    strides = (Y * Z, Z, 1)
    b, c = [ax for ax in range(3) if ax != axis]
    return tuple(db * strides[b] + dc * strides[c] + jj * strides[axis]
                 for db in (0, 1) for dc in (0, 1) for jj in range(W))


# id: (M, n_cells, offsets, C, n_valid, base: sorted range or "walk")
SPLAT_CASES = {
    # ~8 updates per cell: runs of equal rows across warps and tiles
    "runs_c1": (4000, 500, corner_offsets((5, 10, 10)), 1, None, (0, 500)),
    "runs_c6_nv_edge": (4000, 500, corner_offsets((5, 10, 10)), 6, 2048,
                        (0, 500)),
    "taps24_nv_mid": (6001, 12 * 13 * 14, taps_offsets((12, 13, 14), 1), 1,
                      3001, (-20, 12 * 13 * 14)),
    "c12_both_ends": (2500, 3000, (-300, 0, 7, 250), 12, None, (-400, 3100)),
    # a ray-major order (the SDF grid gradient's): short runs, jumps back
    "unsorted_c2_nv_edge": (5000, 800, corner_offsets((8, 10, 10)), 2, 4096,
                            "walk"),
    # the march's gather adjoints (3 columns in the coarse style): unique
    # ascending rows
    "unique_s1_c3_nv_mid": (3001, 9000, (0,), 3, 2500, "unique"),
}

# id: (raw, M, grid shape, offsets, C, n_valid); bases run past both ends
GATHER_CASES = {
    "raw24_nv_mid": (True, 6001, (12, 13, 14), taps_offsets((12, 13, 14), 2),
                     1, 2048 + 7),
    "raw24_y_nv_edge": (True, 6001, (12, 13, 14),
                        taps_offsets((12, 13, 14), 1), 1, 4096),
    "w12_runs_nv_edge": (False, 6001, (10, 11, 12), corner_offsets((10, 11, 12)),
                         12, 4096),
    "w6_nv_mid": (False, 5000, (10, 11, 12), corner_offsets((10, 11, 12)), 6,
                  2048 + 7),
    "w1_all_valid": (False, 2500, (10, 11, 12), corner_offsets((10, 11, 12)),
                     1, None),
    "raw10_generic": (True, 3001, (10, 11, 12), taps_offsets((10, 11, 12), 0,
                                                             W=2)[:10], 1,
                      None),
}


def splat_case(name, seed=0):
    """``(base [M] i32, vals [S, C, M] f32, offsets, n_cells, n_valid)``;
    a fifth of the values are exact zeros."""
    M, n_cells, offsets, C, n_valid, spec = SPLAT_CASES[name]
    rng = np.random.default_rng(seed)
    if spec == "walk":
        steps = rng.choice([0, 0, 1, -1, 10, -10, 100], size=M)
        base = np.clip(400 + np.cumsum(steps), -50, n_cells + 50)
    elif spec == "unique":
        base = np.sort(rng.choice(n_cells - 1, M, replace=False))
        base[n_valid:] = n_cells - 1  # pad tail on a droppable dump row
    else:
        base = np.sort(rng.integers(spec[0], spec[1], M))
    vals = rng.standard_normal((len(offsets), C, M)).astype(np.float32)
    vals[rng.uniform(size=vals.shape) < 0.2] = 0.0
    return base.astype(np.int32), vals, offsets, n_cells, n_valid


def gather_case(name, seed=0):
    """``(table [R, C], base [M] i32, weights [M, D] or None, offsets, raw,
    n_valid)``."""
    raw, M, shape, offsets, C, n_valid = GATHER_CASES[name]
    rng = np.random.default_rng(seed)
    R = int(np.prod(shape))
    table = rng.standard_normal((R, C)).astype(np.float32)
    base = np.sort(rng.integers(-30, R + 5, M)).astype(np.int32)
    w = None if raw else rng.uniform(-1, 1, (M, len(offsets))).astype(
        np.float32)
    return table, base, w, offsets, raw, n_valid


@pytest.fixture(scope="module")
def jsplat():
    from esrnerf_tpu.ops import splat

    return splat


@pytest.mark.parametrize("name", list(SPLAT_CASES))
def test_splat_case(jsplat, name):
    import jax.numpy as jnp

    base, vals, offsets, n_cells, n_valid = splat_case(name)
    out_t = tsplat.sorted_streams_splat(
        torch.as_tensor(base), torch.as_tensor(vals), offsets, n_cells,
        n_valid=None if n_valid is None else torch.tensor(n_valid))
    out_j = jsplat.sorted_streams_splat(
        jnp.asarray(base), jnp.asarray(vals), offsets, n_cells,
        n_valid=None if n_valid is None else jnp.int32(n_valid))
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), rtol=1e-5,
                               atol=1e-5)
    keep = len(base) if n_valid is None else n_valid
    ref = jsplat.splat_oracle(base[:keep], vals[:, :, :keep], offsets,
                              n_cells)
    np.testing.assert_allclose(out_t.numpy(), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", list(GATHER_CASES))
def test_gather_case(jsplat, name):
    import jax.numpy as jnp

    table, base, w, offsets, raw, n_valid = gather_case(name)
    out_t = tsplat.sorted_corner_gather(
        torch.as_tensor(table), torch.as_tensor(base),
        None if raw else torch.as_tensor(w), offsets, raw=raw,
        n_valid=None if n_valid is None else torch.tensor(n_valid)).numpy()
    out_j = jsplat.sorted_corner_gather(
        jnp.asarray(table), jnp.asarray(base),
        None if raw else jnp.asarray(w), offsets, raw=raw,
        n_valid=None if n_valid is None else jnp.int32(n_valid))
    # XLA:CPU may fuse the weighted sum into FMAs: last-bit differences
    np.testing.assert_allclose(out_t, np.asarray(out_j), rtol=1e-6, atol=1e-6)
    # numpy in the plain version's order: bitwise
    R = table.shape[0]
    rows = [table[np.clip(base.astype(np.int64) + o, 0, R - 1)]
            for o in offsets]
    if raw:
        ref = np.stack([r[:, 0] for r in rows], -1)
    else:
        ref = np.zeros((len(base), table.shape[1]), np.float32)
        for d, r in enumerate(rows):
            ref = ref + w[:, d:d + 1] * r
    if n_valid is not None:
        chunk = np.arange(len(base)) // tsplat.GATHER_CHUNK
        ref[chunk * tsplat.GATHER_CHUNK >= n_valid] = 0.0
    np.testing.assert_array_equal(out_t, ref)


def test_step_splat_sites_base_order(monkeypatch):
    """One fine step (micro scale, CPU): every splat launch and whether its
    live ``base`` rows are ascending. All are but the SDF grid gradient,
    whose samples come in ray-major order. The y- and x-axis taps' window
    base (``i0b*sb + i0c*sc + w0*sa``) is ascending in cell order only
    while no window is clamped at a grid face, which holds here (the
    samples stay inside the ball) but not in general."""
    import chip_smoke
    from esrnerf_tpu_torch.apps.fine import build_fine_train_step
    from esrnerf_tpu_torch.models import voxurf_base as tvb
    from esrnerf_tpu_torch.models.voxurff import VoxurfF
    from test_torch_common import (NUM_VOXELS, S_VAL, ball_density,
                                   load_both_cfgs, rays)

    _, cfg = load_both_cfgs()
    mc = tvb.make_mask_cache(ball_density(), [-1, -1, -1], [1, 1, 1], 1e-6,
                             1e-3, 3, device="cpu")
    model = VoxurfF(cfg, 0.5, 4.0, [-1, -1, -1], [1, 1, 1], mc, S_VAL,
                    NUM_VOXELS)
    params = model.init_params(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(7)
    for g in ("off_color", "emo_color"):
        params[g] = torch.as_tensor(rng.normal(
            scale=0.3, size=params[g].shape).astype(np.float32))

    seen = []
    plain = tsplat._splat_plain

    def recording(base, vals, offsets, out, n_valid=None):
        n = len(base) if n_valid is None else int(n_valid)
        b = base[:n].long()
        seen.append((chip_smoke.call_site(depth=1), tuple(vals.shape[:2]),
                     bool((b[1:] >= b[:-1]).all())))
        return plain(base, vals, offsets, out, n_valid)

    monkeypatch.setattr(tsplat, "_splat_plain", recording)

    class _GradsOut:
        def step(self, params, grads, state, lr_scales=None):
            return grads, state

    step = build_fine_train_step(model, _GradsOut(), cfg, device="cpu")
    batch = {k: torch.as_tensor(v) for k, v in rays().items()}
    step(params, None, batch, 40.0, {k: 1.0 for k in params}, 1.0, 0.05,
         0.01 * 0.1 / 64, True)
    got = sorted((site.split(" ")[1], sc, asc) for site, sc, asc in seen)
    assert got == sorted([
        ("_SortedScatter.forward", (1, 1), True),  # to_dense(sdf)
        ("sorted_scatter_1d", (1, 1), True),  # to_dense(exact), bool
        ("_SortedGatherRows.backward", (1, 2), True),  # gather_back
        ("_SortedGatherRows.backward", (1, 6), True),  # pack2
        ("_GridSample3d.backward", (8, 1), False),  # SDF grid, ray-major
        ("_SortedTrilinearSampleMulti.backward", (8, 6), True),  # off_color
        ("_SortedTrilinearSampleMulti.backward", (8, 6), True),  # emo_color
        ("_DisplacedTaps.backward", (24, 1), True),  # z axis
        ("_DisplacedTaps.backward", (24, 1), True),  # y axis
        ("_DisplacedTaps.backward", (24, 1), True),  # x axis
    ]), got


@pytest.mark.parametrize("got_kind", ["same", "rounded", "nothing",
                                      "stream_dropped"])
def test_replay_splat_check_at_gradient_scale(got_kind):
    """``chip_smoke.py`` holds each replayed K-3 launch to its plain version
    on the plain result's scale. At the step's gradient scale (~1e-13) a
    fixed atol of 5e-5 passes a kernel that wrote nothing; the scaled
    check fails it, and one that dropped a stream, and passes rounding."""
    import chip_smoke

    base, vals, offsets, n_cells, n_valid = splat_case("taps24_nv_mid")
    vals = vals * np.float32(1e-13)
    nv = torch.tensor(n_valid)

    def splat(v):
        out = torch.zeros((n_cells, v.shape[1]))
        return tsplat._splat_plain(torch.as_tensor(base), torch.as_tensor(v),
                                   offsets, out, nv)

    want = splat(vals)
    if got_kind == "same":
        got = splat(vals)
    elif got_kind == "rounded":
        got = want * (1 + 1e-6 * torch.as_tensor(
            np.random.default_rng(1).uniform(-1, 1, want.shape),
            dtype=torch.float32))
    elif got_kind == "nothing":
        got = torch.zeros_like(want)
    else:
        dropped = vals.copy()
        dropped[5] = 0.0
        got = splat(dropped)
    # the fixed tolerance cannot tell any of them apart
    chip_smoke.assert_close("fixed", got, want, 5e-4, 5e-5)
    if got_kind in ("same", "rounded"):
        assert chip_smoke.assert_splat_close("scaled", got, want) <= 1e-17
    else:
        with pytest.raises(AssertionError, match="outside"):
            chip_smoke.assert_splat_close("scaled", got, want)
    with pytest.raises(AssertionError, match="all zero"):
        chip_smoke.assert_splat_close("zero", got, torch.zeros_like(want))
