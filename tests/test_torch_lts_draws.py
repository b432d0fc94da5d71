"""The LTS forward's keyed draws (``esrnerf_tpu_torch/ops/keyed.py``,
``ESRNeRF.keyed_rows`` / ``select_keyed`` / ``keyed_scatter``): a head
row's draws follow its (ray, sample), not its place in the march's order;
a sample that leaves the live rows moves at most one chosen point; a
rank's rows at its ray offset draw world 1's numbers; a run resumed at a
step draws what an unbroken run draws there; the uniforms' and normals'
moments; and the explicit-draws forward as it was. JAX-free; the CPU and
CUDA check skips without a card."""

import os
import types

import numpy as np
import pytest
import torch

from esrnerf_tpu_torch.config import load_cfg
from esrnerf_tpu_torch.models import voxurf_base as vb
from esrnerf_tpu_torch.models.esrnerf import ESRNeRF, LTSDraws
from esrnerf_tpu_torch.ops import keyed

pytestmark = pytest.mark.quick

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# cfg/app/lts.yaml at 20^3 voxels, 16-wide heads, 32 rays, 8 surface
# points x 4 secondary rays, f32 heads, budgets with overflow 0
TINY = ["app.phase=train", "data.cls=x", "data.root=x", "data.scene=x",
        "app.model.points_budget_masked_per_ray=256",
        "app.model.points_budget_per_ray=16",
        "app.model.points_budget_masked_per_2ndray=96",
        "app.model.points_budget_per_2ndray=16",
        "app.model.phase1_block=8",
        "app.model.rgbnet_width=16", "app.model.rgbnet_depth=2",
        "app.model.tonemap_width=16", "app.model.tonemap_depth=2",
        "app.model.brdfnet_width=16", "app.model.brdfnet_depth=2",
        "app.model.num_ltspts=8", "app.model.num_2ndrays=4",
        "system.compute_dtype=float32", "system.mesh_axes=[]"]
S_VAL = 40.0


@pytest.fixture(autouse=True)
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def tiny(n_rays=32):
    """The model, its parameters (a noisy r = 0.5 sphere SDF, random colour
    and BRDF grids) and a batch of rays at the ball, all from fixed
    seeds."""
    cfg = load_cfg("cfg/app/lts.yaml", TINY, root_dir=REPO)
    g = np.linspace(-1, 1, 16)
    xx, yy, zz = np.meshgrid(g, g, g, indexing="ij")
    dens = np.where(np.sqrt(xx**2 + yy**2 + zz**2) < 0.7, 20.0,
                    -20.0).astype(np.float32)[..., None]
    mc = vb.make_mask_cache(dens, [-1] * 3, [1] * 3, 1e-6, 1e-3, 3,
                            device="cpu")
    m = ESRNeRF(cfg, 0.5, 4.0, [-1] * 3, [1] * 3, mc, S_VAL, 20**3)
    p = m.init_params(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    X, Y, Z = m.geo.world_size
    x, y, z = np.mgrid[-1:1:X * 1j, -1:1:Y * 1j, -1:1:Z * 1j]
    p["sdf"] = torch.as_tensor((np.sqrt(x**2 + y**2 + z**2) - 0.5 + rng.normal(
        scale=0.03, size=x.shape)).astype(np.float32)[..., None])
    for k in ("off_color", "emo_color", "brdf"):
        p[k] = torch.as_tensor(rng.normal(scale=0.3, size=p[k].shape)
                               .astype(np.float32))
    o = rng.normal(size=(n_rays, 3)).astype(np.float32)
    o = o / np.linalg.norm(o, axis=-1, keepdims=True) * 2
    d = rng.normal(scale=0.3, size=(n_rays, 3)).astype(np.float32) - o
    b = {"rays_o": o, "rays_d": d,
         "viewdirs": d / np.linalg.norm(d, axis=-1, keepdims=True),
         "em_modes": rng.integers(0, 2, n_rays),
         "uncert_masks": rng.uniform(size=n_rays) > 0.3,
         "rgbs": rng.uniform(0, 1, (n_rays, 3)).astype(np.float32)}
    return cfg, m, p, {k: torch.as_tensor(v) for k, v in b.items()}


@pytest.fixture(scope="module")
def marched():
    cfg, m, p, b = tiny()
    mk = m.geo.march(p["sdf"], b["rays_o"], b["rays_d"], b["viewdirs"],
                     S_VAL, m.fastcolor_thres, m.neus_alpha, style="fine")
    assert float(mk.overflow) == 0 and int(mk.n_valid) > 3 * m.n_lts_points
    return m, mk


def _chosen(m, mk, key, pad=None):
    pad = mk.pad if pad is None else pad
    draws, _, pos = m.keyed_rows(key, mk._replace(pad=pad))
    sel, _ = m.select_keyed(draws.select, pos, pad, m.n_lts_points)
    return {(int(mk.ray_id[i]), int(mk.step_id[i])) for i in sel}


def test_draws_follow_the_row_not_its_place(marched):
    """Any order of the march's rows gives each (ray, sample) the same
    score, perturbations and scattering normals, and the same chosen
    points."""
    m, mk = marched
    key = keyed.DrawKey(2**31 + 7, 12)
    perm = torch.randperm(mk.pad.shape[0], generator=torch.Generator()
                          .manual_seed(1))
    mp = mk._replace(ray_id=mk.ray_id[perm], step_id=mk.step_id[perm],
                     pad=mk.pad[perm])
    (d, h, _), (dp, hp, _) = m.keyed_rows(key, mk), m.keyed_rows(key, mp)
    for a, b in zip(d, dp):
        if a is not None:
            assert torch.equal(a[perm], b)
    assert torch.equal(m.keyed_scatter(h[perm]), m.keyed_scatter(hp))
    assert _chosen(m, mk, key) == _chosen(m, mp, key)
    assert len(_chosen(m, mk, key)) == m.n_lts_points


def test_a_sample_leaving_the_live_rows_moves_at_most_one_point(marched):
    """Each of 24 live rows (the chosen ones first) taken out of the live
    rows in turn: the chosen set loses at most that row and gains at most
    one other."""
    m, mk = marched
    key = keyed.DrawKey(5, 3)
    base = _chosen(m, mk, key)
    live = (~mk.pad).nonzero()[:, 0]
    chosen = [i for i in live.tolist()
              if (int(mk.ray_id[i]), int(mk.step_id[i])) in base]
    rest = [i for i in live.tolist() if i not in chosen]
    for i in chosen[:12] + rest[:12]:
        pad = mk.pad.clone()
        pad[i] = True
        got = _chosen(m, mk, key, pad)
        assert len(base - got) <= 1 and len(got - base) <= 1, i
        assert (int(mk.ray_id[i]), int(mk.step_id[i])) not in got


def test_a_ranks_rows_draw_world_ones_numbers(marched):
    """The rows of rays 8r .. 8r + 7 marched as rank r of 4 (local rays 0
    .. 7, the rank's offset 8r) draw what world 1 draws for them, and take
    the same places in the global (ray, sample) order."""
    m, mk = marched
    key = keyed.DrawKey(77, 4)
    d1, h1, pos1 = m.keyed_rows(key, mk)
    for r in range(4):
        rows = (mk.ray_id >= 8 * r) & (mk.ray_id < 8 * r + 8) & ~mk.pad
        local = mk._replace(ray_id=mk.ray_id[rows] - 8 * r,
                            step_id=mk.step_id[rows], pad=mk.pad[rows],
                            n_rays=8)
        sh = types.SimpleNamespace(rank=r, n=4)
        d4, h4, pos4 = m.keyed_rows(key, local, sh)
        assert torch.equal(h4, h1[rows]) and torch.equal(pos4, pos1[rows])
        for a, b in zip(d4, d1):
            if a is not None:
                assert torch.equal(a, b[rows])


class _NoUpdate:
    """An optimizer that leaves the parameters as they are."""

    def step(self, params, grads, state, lr_scales=None):
        return params, state


def test_a_resumed_run_draws_what_an_unbroken_run_draws():
    """The trainer's key of step k (``LTS.draw_key``: the run's seed and
    the global step) gives a step at k the same loss terms whether steps
    0 .. k - 1 ran before it in the process or not."""
    from esrnerf_tpu_torch.apps.lts import LTS, build_lts_train_step

    def run(steps):
        cfg, m, p, b = tiny()
        step = build_lts_train_step(m, _NoUpdate(), cfg, device="cpu")
        app = types.SimpleNamespace(cfg=cfg, global_step=0)
        for app.global_step in steps:
            _, _, aux = step(p, None, b, S_VAL, {k: 1.0 for k in p}, 0.0,
                             0.0, 0.0, True, key=LTS.draw_key(app))
        return [float(a) for a in aux]

    unbroken, resumed = run(range(3)), run([2])
    assert unbroken == resumed
    assert run([1]) != resumed


def test_uniform_and_normal_moments():
    """10^5 draws of each kind: uniforms in [0, 1) with mean 1/2 and
    variance 1/12, normals with mean 0 and variance 1, each within five
    standard errors (uniform mean 4.6e-3, variance 1.2e-3; normal mean
    1.6e-2, variance 2.3e-2), and adjacent lanes uncorrelated (|r| <
    1.6e-2, five standard errors)."""
    ray = torch.arange(50_000)
    h = keyed.lanes(keyed.row_hash(keyed.DrawKey(9, 1), ray, ray % 891), 4)
    u = keyed.uniform(h[:, :2]).reshape(-1).double()
    assert 0.0 <= float(u.min()) and float(u.max()) < 1.0
    assert abs(float(u.mean()) - 0.5) < 4.6e-3
    assert abs(float(u.var()) - 1 / 12) < 1.2e-3
    z = keyed.normal(keyed.lanes(h[:, 0], 4)).reshape(-1).double()
    assert z.numel() == 100_000 and bool(torch.isfinite(z).all())
    assert abs(float(z.mean())) < 1.6e-2
    assert abs(float(z.var()) - 1.0) < 2.3e-2
    a, b = keyed.uniform(h[:, 0]).double(), keyed.uniform(h[:, 1]).double()
    assert abs(float(torch.corrcoef(torch.stack([a, b]))[0, 1])) < 1.6e-2


# each output's sum from the explicit-draws forward before the draws were
# keyed (the same model, parameters, rays and draws)
EXPLICIT = {
    "etc/alphainv_cum": 3.7509310487657785, "etc/brdf": 1271.245383799076,
    "etc/brdf_eps": 1270.8062517344952, "etc/counts": 4546.0,
    "etc/counts_2nd": 3482.0, "etc/emit": 1082.9581607580185,
    "etc/emit_eps": 1082.9723960757256, "etc/emit_marched": 58.54589141230099,
    "etc/k1_frac": 0.5787671208381653, "etc/k1_frac_2nd": 0.2568493187427521,
    "etc/k2_frac": 0.67578125, "etc/k2_frac_2nd": 0.06640625,
    "etc/normal": 26.059408343280666, "etc/normal_eps": 74.55794893857092,
    "etc/overflow": 0.0, "etc/point_valid": 346.0,
    "etc/white_bg": 3.7509310487657785, "lin/pbr/emo": 31.951227128505707,
    "lin/pbr/emo_hat": 32.485809445381165, "lin/pbr/off": 36.01270753145218,
    "lin/pbr/off_hat": 6.5211302898824215, "lin/pbr/valid": 16.0,
    "lin/rgb": 97.37540978030302, "srgb/rgb": 40.46650754683651}


def test_explicit_draws_give_the_forward_as_before():
    """The forward fed explicit row-ordered draws (as the JAX-parity tests
    feed JAX's) against its sums before the draws were keyed: counts
    exact, values at rtol 1e-5 (the CPU's summation order under another
    thread count)."""
    from esrnerf_tpu_torch.utils import profiling

    _, m, p, b = tiny()
    K = 32 * 16
    g = torch.Generator().manual_seed(5)
    draws = LTSDraws(torch.rand((K,), generator=g),
                     torch.randn((8, 5, 3), generator=g),
                     torch.randn((K, 3), generator=g),
                     torch.randn((K, 3), generator=g))
    before = profiling.snapshot()["counters"].get("lts.draws_given", 0)
    out = m.forward_training(p, b["rays_o"], b["rays_d"], b["viewdirs"],
                             b["em_modes"], b["uncert_masks"], S_VAL, 0.01,
                             0.001, draws=draws)
    assert set(out) == set(EXPLICIT)
    for k, want in EXPLICIT.items():
        got = float(out[k].double().sum())
        assert got == pytest.approx(want, rel=1e-5, abs=1e-9), k
    assert profiling.snapshot()["counters"]["lts.draws_given"] == before + 1


@pytest.mark.cuda
def test_the_same_bits_on_cpu_and_cuda():
    """Row states, lanes and uniforms bit for bit on the card; normals
    within 2 ulp (the card's log and cos)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    ray = torch.arange(8192).repeat_interleave(8)
    sample = torch.arange(ray.numel()) % 891
    key = keyed.DrawKey(2**31 + 5, 39_999)
    cpu = keyed.lanes(keyed.row_hash(key, ray, sample), 13)
    dev = keyed.lanes(keyed.row_hash(key, ray.cuda(), sample.cuda()), 13)
    assert torch.equal(cpu, dev.cpu())
    assert torch.equal(keyed.uniform(cpu), keyed.uniform(dev).cpu())
    torch.testing.assert_close(keyed.normal(dev).cpu(), keyed.normal(cpu),
                               rtol=2.4e-7, atol=1e-6)
