"""The port's CUDA kernels against their plain PyTorch versions on the card,
at small shapes. Marked ``cuda``: they skip without a GPU. On a machine
with one, run them without the JAX test setup:

    python -m pytest tests/test_torch_cuda.py -q --noconftest
"""

import numpy as np
import pytest
import torch

from test_torch_scan_oracle import (SCAN_CASES, assert_grad_close,
                                    scan_bwd_oracle, scan_case,
                                    scan_fwd_oracle)
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
    a = torch.as_tensor(rng.uniform(0, 0.9, (700, 53)).astype(np.float32),
                        device=dev)
    a[3, 10] = 1.0
    ctw = torch.randn(700, 53, device=dev)
    ctl = torch.randn(700, device=dev)
    n0 = kernels.launches["scan_fwd"]
    for got, want in zip(scanops.scan_forward(a, 1e-3),
                         scanops._fwd_plain(a, 1e-3)):
        _close(got, want, 1e-5, 1e-6)
    assert kernels.launches["scan_fwd"] == n0 + 1
    _, tin, _ = scanops._fwd_plain(a, 1e-3)
    _close(scanops.scan_backward(a, tin, ctw, ctl, 1e-3),
           scanops._bwd_plain(a, tin, ctw, ctl, 1e-3), 1e-4, 1e-5)


def _scan_case_on(dev, name):
    alpha, ctw, ctl, ee = scan_case(name)
    return (alpha, ctw, ctl, ee,
            *(torch.as_tensor(x, device=dev) for x in (alpha, ctw, ctl)))


def _off16(t):
    """A contiguous copy of ``t`` whose base lies 4 bytes past a 16-byte
    boundary: the scan kernels then take the cp.async route."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = flat[1:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.parametrize("route", ["auto", "cp_async"])
@pytest.mark.parametrize("name", list(SCAN_CASES))
def test_scan_kernel_cases(dev, name, route):
    """K-1 and K-2 bitwise against the sequential float32 oracle, K-1
    bitwise against its plain version, K-2 within rtol 1e-4 / atol 1e-5
    (scaled to the case's gradients) of its plain version (a cumsum
    difference). ``auto`` takes the TMA route wherever S is a multiple of
    4; ``cp_async`` feeds alpha from a base off 16 bytes, which takes the
    other."""
    from esrnerf_tpu_torch.ops import kernels
    from esrnerf_tpu_torch.ops import scan as scanops

    alpha, ctw, ctl, ee, a, cw, cl = _scan_case_on(dev, name)
    S = alpha.shape[1]
    if route == "cp_async":
        a = _off16(a)
    assert kernels.scan_tma_ok(S, a) == (route == "auto" and S % 4 == 0)
    n0 = dict(kernels.launches)
    w, tin, last = kernels.scan_fwd(a, ee)
    w_o, tin_o, last_o = scan_fwd_oracle(alpha, ee)
    for got, want in ((w, w_o), (tin, tin_o), (last, last_o)):
        np.testing.assert_array_equal(got.cpu().numpy(), want)
    for got, want in zip((w, tin, last), scanops._fwd_plain(a, ee)):
        _close(got, want, 0, 0)
    d = kernels.scan_bwd(a, tin, cw, cl, ee)
    np.testing.assert_array_equal(
        d.cpu().numpy(), scan_bwd_oracle(alpha, tin_o, ctw, ctl, ee))
    assert_grad_close(d.cpu(), scanops._bwd_plain(a, tin, cw, cl, ee).cpu(),
                      1e-4, 1e-5)
    assert kernels.launches["scan_fwd"] == n0["scan_fwd"] + 1
    assert kernels.launches["scan_bwd"] == n0["scan_bwd"] + 1


def test_scan_kernel_refusals_and_ring(dev):
    """A strided, non-f32 or non-2-D tensor is refused (no quiet
    conversion); at the fine step's shape two blocks' rings fit an SM."""
    from esrnerf_tpu_torch.ops import kernels

    alpha, ctw, ctl, ee, a, cw, cl = _scan_case_on(dev, "band24")
    tin = kernels.scan_fwd(a, ee)[1]
    with pytest.raises(ValueError, match="contiguous"):
        kernels.scan_fwd(a.t(), ee)
    with pytest.raises(ValueError, match="float32"):
        kernels.scan_fwd(a.double(), ee)
    with pytest.raises(ValueError, match=r"\[N, S\]"):
        kernels.scan_fwd(a.reshape(-1), ee)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.scan_bwd(a, tin, cw.t().contiguous().t(), cl, ee)
    props = torch.cuda.get_device_properties(dev)
    for backward in (False, True):
        ring = kernels.scan_config(896, 8192, backward)
        assert 1 <= ring["stages"] <= 4
        assert 2 * ring["smem_bytes"] <= getattr(
            props, "shared_memory_per_multiprocessor", 233472)


def test_scan_autograd_strided_cotangent(dev):
    """The march stacks the weights with other columns, so autograd hands
    the scan a strided ``ct_w``: the gradient on the card equals the CPU's
    plain versions (rtol 1e-4 / atol 1e-5)."""
    from esrnerf_tpu_torch.ops import scan as scanops

    alpha, _, _, ee = scan_case("band24_ring")
    rng = np.random.default_rng(5)
    ct = rng.normal(size=alpha.shape + (2,)).astype(np.float32)
    ctl = rng.normal(size=alpha.shape[:1]).astype(np.float32)
    grads = []
    for d in (torch.device("cpu"), dev):
        a = torch.as_tensor(alpha, device=d).requires_grad_(True)
        w, last = scanops.alpha2weights_scan(a, ee)
        stacked = torch.stack([a, w], -1)
        loss = ((stacked * torch.as_tensor(ct, device=d)).sum()
                + (last * torch.as_tensor(ctl, device=d)).sum())
        grads.append(torch.autograd.grad(loss, a)[0])
    _close(grads[1], grads[0], 1e-4, 1e-5)


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


def _exact_parts_table(dev, npiece):
    """A random table of exactly npiece * GCAP + 256 words (whole tiles),
    followed in its allocation by NaN words: a kernel reading past the end
    of what the contract allows would return NaN."""
    from esrnerf_tpu_torch.ops import gather_bench as gb

    need = npiece * gb.GCAP + gb.EXT_T * gb.GROUP
    gen = torch.Generator(device=dev).manual_seed(npiece)
    buf = torch.full((need + 4096,), float("nan"), device=dev)
    buf[:need] = torch.randn(need, generator=gen, device=dev)
    return buf[:need].view(-1, 1, gb.GROUP)


@pytest.mark.parametrize("npiece", [0, 1, 3, 64, 769])
@pytest.mark.parametrize("mode", ["dma", "build", "full"])
def test_gather_parts_kernel(dev, mode, npiece):
    """K-6 on a table of exactly the words it may read: build and full
    bitwise equal to the plain version, dma all zeros, one launch a call.
    At 769 pieces t0 = (13p + 7g + k) mod 768 wraps, so a lane meets the
    same window twice."""
    from esrnerf_tpu_torch.ops import gather_bench as gb
    from esrnerf_tpu_torch.ops import kernels

    tbl = _exact_parts_table(dev, npiece)
    key = f"gather_parts_{mode}"
    for call in range(2):
        n0 = kernels.launches[key]
        got = gb.gather_parts(tbl, mode, npiece)
        assert kernels.launches[key] == n0 + 1
        torch.cuda.synchronize(dev)
        assert got.shape == (1, gb.K * gb.W, gb.LANES)
        if mode == "dma":
            assert not bool(got.any())
        else:
            want = gb._gather_parts_plain(tbl.reshape(-1), mode, npiece)
            assert bool(torch.isfinite(got).all())
            assert torch.equal(got, want)
            if mode == "full" and npiece:
                assert bool((got != 0).any())


def test_gather_parts_unaligned_table(dev):
    """A table 4 bytes off a 16-byte boundary: the launch helper refuses it,
    the op copies it to an aligned base and gives the aligned result."""
    from esrnerf_tpu_torch.ops import gather_bench as gb
    from esrnerf_tpu_torch.ops import kernels

    tbl = _exact_parts_table(dev, 3)
    off = torch.empty(tbl.numel() + 1, device=dev)[1:].view_as(tbl)
    off.copy_(tbl)
    with pytest.raises(ValueError, match="16-byte"):
        kernels.gather_parts(off, "full", 3)
    for mode in gb.MODES:
        assert torch.equal(gb.gather_parts(off, mode, 3),
                           gb.gather_parts(tbl, mode, 3))


# ------------------------------------------------- the alphamask stage's K-3


@pytest.mark.parametrize("C", [1, 3])
def test_splat_kernel_on_dvgo_points(dev, C):
    """K-3 as DVGO's grid gradient (``trilinear_splat``) on the alphamask
    step's kind of input: 2^21 + 12,345 unsorted points over a 101x97x103
    grid, about 40% outside the bbox and 12,288 exactly on its faces,
    against the plain version at rtol 5e-4 / atol 5e-5 of its max (float
    atomics add in another order)."""
    from esrnerf_tpu_torch.ops import kernels
    from esrnerf_tpu_torch.ops import splat as splatops

    rng = np.random.default_rng(C)
    M, shape = 2**21 + 12345, (101, 97, 103, C)
    pts = rng.uniform(-1.25, 1.25, (M, 3)).astype(np.float32)
    for a in range(3):  # the min face on x, the max faces on y and z
        pts[4096 * a:4096 * (a + 1), a] = -1.0 if a == 0 else 1.0
    ct = rng.normal(size=(M, C)).astype(np.float32)
    mn, mx = np.full(3, -1, np.float32), np.ones(3, np.float32)
    out = []
    for d in (dev, torch.device("cpu")):
        on = lambda x: torch.as_tensor(x, device=d)
        n0 = kernels.launches["splat"]
        out.append(splatops.trilinear_splat(shape, on(pts), on(ct), on(mn),
                                            on(mx)).cpu())
        assert kernels.launches["splat"] == n0 + (d.type == "cuda")
    got, want = out
    assert float(want.abs().max()) > 0
    _close(got, want, 5e-4, 5e-5 * float(want.abs().max()))
    # the faces' corners outside the grid were dropped, the ones on it kept
    assert float(want[0].abs().sum()) > 0 and float(want[:, -1].abs().sum()) > 0


def test_voxel_count_views_on_card_matches_cpu(dev):
    """DVGO's view counts on the card (K-3 with atomics) against the CPU
    (plain version): per view the summed weight ``w`` within rtol 1e-5 /
    atol 2e-5 (the card's elementwise kernels contract the sampler's
    multiply-adds into FMAs: points an ulp apart move a sample's corner
    weights by ~3e-6 at this grid's 50 voxels per 2 units);
    the counts equal wherever every view's ``|w - 1|`` exceeds 1e-4. The
    number of voxels inside that band is printed."""
    from esrnerf_tpu_torch.config import load_cfg
    from esrnerf_tpu_torch.models.dvgo import DVGO

    cfg = load_cfg("cfg/app/alphamask.yaml",
                   ["app.phase=train", "data.cls=x", "data.root=x",
                    "data.scene=x", "app.model.num_voxels=125000"])
    rng = np.random.default_rng(10)
    ro, rd = [], []
    for _ in range(4):
        c = rng.normal(size=3)
        c = c / np.linalg.norm(c) * 2.5
        ro.append(np.broadcast_to(c, (16384, 3)))
        rd.append(rng.uniform(-0.8, 0.8, (16384, 3)) - c)
    ro, rd = np.asarray(ro, np.float32), np.asarray(rd, np.float32)
    models = [DVGO(cfg, 0.5, 4.0, [-1] * 3, [1] * 3, device=d)
              for d in (dev, "cpu")]
    band = np.zeros(models[0].world_size + (1,), bool)
    for i in range(len(ro)):
        wd, wc = (m.view_weights(ro[i], rd[i], 4096).cpu().numpy()
                  for m in models)
        np.testing.assert_allclose(wd, wc, rtol=1e-5, atol=2e-5)
        band |= (np.abs(wd - 1) <= 1e-4) | (np.abs(wc - 1) <= 1e-4)
    cd, cc = (m.voxel_count_views(ro, rd, 4096).cpu().numpy()
              for m in models)
    print(f"voxel_count_views: {int(band.sum())} of {band.size} voxels "
          "within 1e-4 of w = 1")
    assert (cc == len(ro)).sum() > 0
    np.testing.assert_array_equal(cd[~band], cc[~band])


# ------------------------------------------------------------ the LTS step


def test_small_lts_step_on_card_matches_cpu(dev):
    """One small LTS step (32^3, 64 rays, 16 LTS points x 4 secondary
    rays) on the card against the same step on the CPU from the same
    parameters, batch and random draws: the loss terms at rtol 1e-4, both
    marches' counters equal, every group's gradient within 1e-4 of its
    max |g| (``chip_smoke.check_small_lts_step``, run from the repo root)."""
    import chip_smoke
    from esrnerf_tpu_torch.ops import kernels

    n0 = dict(kernels.launches)
    res = chip_smoke.check_small_lts_step(dev)
    assert res["overflow"] == 0.0 and res["k2_frac_2nd"] > 0.0
    assert res["max_grad_err_rel"] <= 1e-4
    for k in ("scan_fwd", "scan_bwd", "splat", "gather_weighted",
              "gather_raw"):
        assert kernels.launches[k] > n0[k], k


# ------------------------------------------------ the PDRA step, relighting


@pytest.mark.parametrize("C", [6, 24])
def test_gather_kernel_pdra_widths(dev, C):
    """The fine-tune's 6-channel emo-only gather and the relight render's
    24-channel fused gather (off, emo, BRDF, emit_color) through K-4,
    bitwise to the plain version, with a pad tail."""
    from esrnerf_tpu_torch.ops import kernels
    from esrnerf_tpu_torch.ops import splat as splatops

    rng = np.random.default_rng(C)
    R, M = 40000, 9000
    offs = (0, 1, 17, 18, 289, 290, 306, 307)
    table = torch.randn(R, C, device=dev)
    base = torch.as_tensor(np.sort(rng.integers(-5, R, M)), device=dev)
    w = torch.rand(M, 8, device=dev)
    nv = torch.tensor(3 * 2048 + 11, device=dev)
    n0 = kernels.launches["gather_weighted"]
    got = splatops.sorted_corner_gather(table, base, w, offs, False, nv)
    assert kernels.launches["gather_weighted"] == n0 + 1
    _close(got, splatops._gather_plain(table, base, w, offs, False, nv), 0, 0)
    assert float(got[4 * 2048:].abs().max()) == 0.0


def test_small_pdra_step_on_card_matches_cpu(dev):
    """One small PDRA step (32^3, 64 rays, certain and uncertain) on the
    card against the same step on the CPU from the same parameters, batch
    and draws: the loss terms at rtol 1e-4, both marches' counters equal,
    every group's gradient within 1e-4 of its max |g|
    (``chip_smoke.check_small_pdra_step``, run from the repo root)."""
    import chip_smoke
    from esrnerf_tpu_torch.ops import kernels

    n0 = dict(kernels.launches)
    res = chip_smoke.check_small_pdra_step(dev)
    assert res["overflow"] == 0.0 and res["emit_supp"] > 0.0
    assert res["max_grad_err_rel"] <= 1e-4
    for k in ("scan_fwd", "scan_bwd", "splat", "gather_weighted",
              "gather_raw"):
        assert kernels.launches[k] > n0[k], k


def test_small_finetune_on_card_matches_cpu(dev):
    """One small relighting fine-tune step on the card against the CPU, on
    both paths (per-step march; slots from ``march_ray_slots``, equal to
    the CPU's): the loss at rtol 1e-4 and the emo branch's gradients
    within 1e-4 of their max (``chip_smoke.check_small_finetune``)."""
    import chip_smoke
    from esrnerf_tpu_torch.ops import kernels

    n0 = dict(kernels.launches)
    res = chip_smoke.check_small_finetune(dev)
    for path in ("march", "cached"):
        assert res[path]["overflow"] == 0.0
        assert res[path]["max_grad_err_rel"] <= 1e-4
    for k in ("scan_fwd", "splat", "gather_weighted", "gather_raw"):
        assert kernels.launches[k] > n0[k], k
