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


# ------------------------------------------------------ the fused eval heads

# the CPU tests' cuts of cfg/app/fine.yaml that the fused heads kernel is not
# built for (32-wide f32 heads); without them the model has the fine widths
_CPU_HEAD_CUTS = ("app.model.rgbnet_", "app.model.tonemap_",
                  "system.compute_dtype")
# largest gap of a fused per-ray sum to the eager one, over the eager sum's
# largest magnitude: the two sum the same exact bf16 products in another
# order, so an activation near a bf16 rounding boundary may round the other
# way (one bf16 ulp) and move its row's outputs. Read on an H100 at 9,800
# and 262,144 live rows: <= 7.5e-5 (the eager heads on the card against the
# same on the CPU: <= 3.1e-5)
HEADS_GAP = 3e-4


def _fine_heads_model(dev):
    from esrnerf_tpu_torch.config import load_cfg
    from esrnerf_tpu_torch.models import voxurf_base as tvb
    from esrnerf_tpu_torch.models.voxurff import VoxurfF
    from test_torch_common import (NUM_VOXELS, OVERRIDES, REPO, S_VAL,
                                   ball_density)

    cfg = load_cfg("cfg/app/fine.yaml",
                   [o for o in OVERRIDES if not o.startswith(_CPU_HEAD_CUTS)],
                   root_dir=REPO)
    mc = tvb.make_mask_cache(ball_density(), [-1, -1, -1], [1, 1, 1], 1e-6,
                             1e-3, 3, device=dev)
    model = VoxurfF(cfg, 0.5, 4.0, [-1, -1, -1], [1, 1, 1], mc, S_VAL,
                    NUM_VOXELS)
    return model, model.init_params(torch.Generator(device=dev).manual_seed(0))


def _heads_rows(dev, M, n_rays, n_valid, seed, pad=np.nan):
    """Random head rows, live before ``n_valid`` on the first three
    quarters of the rays (the rest have no live row); the pad rows' inputs
    are ``pad``, their ray id ``n_rays`` and weight 0, as the march's."""
    import types

    rng = np.random.default_rng(seed)
    live = max(1, 3 * n_rays // 4)
    ray_id = np.full(M, n_rays, np.int64)
    ray_id[:n_valid] = rng.integers(0, live, n_valid)
    step_id = np.zeros(M, np.int64)
    step_id[:n_valid] = rng.integers(0, 432, n_valid)
    w = np.zeros(M, np.float32)
    w[:n_valid] = rng.uniform(0, 1, n_valid)
    # feat, off_gv, emo_gv, nrm: the order of VoxurfF._eval_heads
    x = [rng.normal(size=(M, c)).astype(np.float32) for c in (79, 6, 6)]
    x.append(rng.uniform(0, 1, (M, 3)).astype(np.float32))
    for a in x:
        a[n_valid:] = pad
    on = lambda a: torch.as_tensor(a, device=dev)
    m = types.SimpleNamespace(weights=on(w), ray_id=on(ray_id),
                              step_id=on(step_id), n_rays=n_rays,
                              n_valid=on(np.int32(n_valid)))
    return m, [on(a) for a in x], live


def _heads_gap(got: dict, want: dict) -> dict:
    return {k: float((got[k] - want[k]).abs().max())
            / max(float(want[k].abs().max()), 1e-30) for k in want}


@pytest.mark.parametrize("M,n_rays,n_valid", [
    (4096, 256, 0), (4096, 256, 1), (4096, 256, 63), (4096, 256, 64),
    (4096, 256, 65), (262144, 16384, 9800), (262144, 16384, 262144)])
def test_fused_eval_heads_match_the_eager_heads(dev, M, n_rays, n_valid):
    """The fused heads kernel against the eager heads on random rows and
    heads of the fine widths, every output within ``HEADS_GAP``; the sums
    of rays with no live row exactly 0; NaN inputs in the pad rows change
    nothing (the kernel never reads them)."""
    from esrnerf_tpu_torch.ops import kernels
    from esrnerf_tpu_torch.utils import profiling

    model, params = _fine_heads_model(dev)
    m, x, live = _heads_rows(dev, M, n_rays, n_valid, seed=M + n_valid)
    n0 = kernels.launches["eval_heads"]
    profiling.reset()
    got = model._eval_heads(params, m, *x)
    assert kernels.launches["eval_heads"] == n0 + 1
    assert profiling.snapshot()["counters"] == {"eval.heads_fused": 1}
    want = dict(zip(got, model._eval_heads_eager(params, m, *x)))
    assert {k: v.shape for k, v in got.items()} == {
        k: v.shape for k, v in want.items()}
    gap = _heads_gap(got, want)
    assert max(gap.values()) <= HEADS_GAP, gap
    for k, v in got.items():
        assert not v[live:].any(), k
        assert bool(torch.isfinite(v).all()), k
    m2, x2, _ = _heads_rows(dev, M, n_rays, n_valid, seed=M + n_valid,
                            pad=0.0)
    gap_pad = _heads_gap(model._eval_heads(params, m2, *x2), got)
    assert max(gap_pad.values()) <= 1e-6, gap_pad


def test_fused_eval_forward_matches_the_eager_forward(dev):
    """The fine eval forward on a 32^3 ball with heads of the fine widths,
    fused against eager, every output within ``HEADS_GAP`` (the march and
    the features are the same ops on both sides)."""
    from esrnerf_tpu_torch.models.voxurff import EVAL_SUMS
    from test_torch_common import S_VAL, rays

    model, params = _fine_heads_model(dev)
    X, Y, Z = model.geo.world_size
    x, y, z = np.mgrid[-1:1:X * 1j, -1:1:Y * 1j, -1:1:Z * 1j]
    r = np.sqrt(x**2 + y**2 + z**2)
    params["sdf"] = torch.as_tensor((r - 0.5).astype(np.float32)[..., None],
                                    device=dev)
    g = torch.Generator(device=dev).manual_seed(1)
    for k in ("off_color", "emo_color"):
        params[k] = torch.rand(params[k].shape, generator=g, device=dev)
    b = {k: torch.as_tensor(v, device=dev) for k, v in rays(512).items()}
    args = (params, b["rays_o"], b["rays_d"], b["viewdirs"], 1,
            torch.eye(3, device=dev), S_VAL)
    fused = model.forward_evaluate(*args)
    model._eval_heads = lambda *a: dict(zip(
        EVAL_SUMS, model._eval_heads_eager(*a)))
    eager = model.forward_evaluate(*args)
    assert list(fused) == list(eager)
    assert float(eager["lin/on_rgb"].abs().max()) > 0
    gap = _heads_gap(fused, eager)
    assert max(gap.values()) <= HEADS_GAP, gap


# largest gap of the card's fused eval forward to the JAX package's on the
# CPU, per output key over the JAX output's largest magnitude, at the fine
# widths with bf16 heads: bf16 roundings of activations that f32 sums in
# another order move across a rounding boundary. Read on an H100: <= 7.2e-5
# (the port's eager heads on the CPU against JAX: <= 1.2e-4)
JAX_EVAL_GAP = 3e-4


@pytest.mark.parametrize("em", [0, 1])
def test_fused_eval_forward_matches_the_jax_forward(dev, em):
    """The fine eval forward at the fine widths with bf16 heads: the port on
    the card (the fused heads kernel, counted as ``eval.heads_fused``)
    against ``esrnerf_tpu``'s ``VoxurfF.forward_evaluate`` run by JAX on
    the CPU, from the same parameters and rays (the set-up of
    ``tests/test_torch_fine_trainer.py::test_forward_evaluate_matches_
    reference`` without its head cuts). Every output key within
    ``JAX_EVAL_GAP`` of the JAX output's largest magnitude, the same keys
    and overflow 0 on both sides."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    assert jax.default_backend() == "cpu"
    import jax.numpy as jnp

    from esrnerf_tpu.config import load_cfg as jload
    from esrnerf_tpu.models import voxurf_base as jvb
    from esrnerf_tpu.models.voxurff import VoxurfF as JVoxurfF
    from esrnerf_tpu_torch.config import load_cfg as tload
    from esrnerf_tpu_torch.models import voxurf_base as tvb
    from esrnerf_tpu_torch.models.voxurff import VoxurfF as TVoxurfF
    from esrnerf_tpu_torch.utils import profiling
    from esrnerf_tpu_torch.utils.convert import params_from_jax
    from test_torch_common import (NUM_VOXELS, OVERRIDES, REPO, S_VAL,
                                   ball_density, rays)

    ov = [o for o in OVERRIDES if not o.startswith(_CPU_HEAD_CUTS)]
    jcfg = jload("cfg/app/fine.yaml", ov, root_dir=REPO)
    tcfg = tload("cfg/app/fine.yaml", ov, root_dir=REPO)
    dens = ball_density()
    box = ([-1, -1, -1], [1, 1, 1])
    jm = JVoxurfF(jcfg, 0.5, 4.0, *box,
                  jvb.make_mask_cache(dens, *box, 1e-6, 1e-3, 3), S_VAL,
                  NUM_VOXELS)
    tm = TVoxurfF(tcfg, 0.5, 4.0, *box,
                  tvb.make_mask_cache(dens, *box, 1e-6, 1e-3, 3, device=dev),
                  S_VAL, NUM_VOXELS)
    params = jax.tree.map(np.asarray, jm.init_params(jax.random.PRNGKey(0)))
    assert params["off_rgbnet"]["w0"].shape == (85, 192)
    rng = np.random.default_rng(7)
    X, Y, Z = jm.geo.world_size
    x, y, z = np.mgrid[-1:1:X * 1j, -1:1:Y * 1j, -1:1:Z * 1j]
    r = np.sqrt(x**2 + y**2 + z**2)
    params["sdf"] = (r - 0.5 + rng.normal(scale=0.03, size=r.shape)
                     ).astype(np.float32)[..., None]
    for g in ("off_color", "emo_color"):
        params[g] = rng.normal(scale=0.3, size=params[g].shape).astype(
            np.float32)
    b = rays(512)
    rot = np.asarray([[0.0, 0.6, 0.8], [1.0, 0.0, 0.0], [0.0, 0.8, -0.6]],
                     np.float32)
    oj = jm.forward_evaluate(
        jax.tree.map(jnp.asarray, params), jnp.asarray(b["rays_o"]),
        jnp.asarray(b["rays_d"]), jnp.asarray(b["viewdirs"]), jnp.int32(em),
        jnp.asarray(rot), jnp.float32(S_VAL))
    on = lambda a: torch.as_tensor(a, device=dev)
    profiling.reset()
    ot = tm.forward_evaluate(
        params_from_jax(params, device=dev), on(b["rays_o"]), on(b["rays_d"]),
        on(b["viewdirs"]), em, on(rot), S_VAL)
    assert profiling.snapshot()["counters"] == {"eval.heads_fused": 1}
    assert ot.keys() == oj.keys()
    assert float(ot["etc/overflow"]) == float(oj["etc/overflow"]) == 0.0
    assert float(np.abs(np.asarray(oj["lin/on_rgb"])).max()) > 0
    gap = {k: float(np.abs(ot[k].cpu().numpy() - np.asarray(oj[k])).max())
           / max(float(np.abs(np.asarray(oj[k])).max()), 1e-30) for k in oj}
    print("fused eval forward against JAX, gap / max:", gap)
    assert max(gap.values()) <= JAX_EVAL_GAP, gap


def test_eval_heads_on_the_card_refuse_heads_the_kernel_lacks(dev):
    """On the card the eval forward runs the fused heads or raises: the CPU
    tests' 32-wide f32 heads raise, they never fall back to the eager
    heads."""
    from esrnerf_tpu_torch.config import load_cfg
    from esrnerf_tpu_torch.models import voxurf_base as tvb
    from esrnerf_tpu_torch.models.voxurff import VoxurfF
    from esrnerf_tpu_torch.utils import profiling
    from test_torch_common import (NUM_VOXELS, OVERRIDES, REPO, S_VAL,
                                   ball_density, rays)

    cfg = load_cfg("cfg/app/fine.yaml", OVERRIDES, root_dir=REPO)
    mc = tvb.make_mask_cache(ball_density(), [-1, -1, -1], [1, 1, 1], 1e-6,
                             1e-3, 3, device=dev)
    model = VoxurfF(cfg, 0.5, 4.0, [-1, -1, -1], [1, 1, 1], mc, S_VAL,
                    NUM_VOXELS)
    params = model.init_params(torch.Generator(device=dev).manual_seed(0))
    b = {k: torch.as_tensor(v, device=dev) for k, v in rays(64).items()}
    profiling.reset()
    with pytest.raises(ValueError, match="built for"):
        model.forward_evaluate(params, b["rays_o"], b["rays_d"],
                               b["viewdirs"], 0, torch.eye(3, device=dev),
                               S_VAL)
    assert "eval.heads_eager" not in profiling.snapshot()["counters"]
