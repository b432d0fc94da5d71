"""The port's fine-stage trainer slice against the JAX package, on the CPU
at micro scale: the PNG codec, the dataset and sampler, the grid resize and
warm start, progressive scaling, the ray filter, the eval forward, the
metrics, the mesh, a checkpoint handoff in both directions, and
``esrnerf_tpu_torch.run`` end to end (``system.device=cpu``)."""

import json
import os
import struct
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from esrnerf_tpu.apps.fine import Fine as JFine
from esrnerf_tpu.config import customize_cfg as jcustomize
from esrnerf_tpu.config import load_cfg as jload
from esrnerf_tpu.data.esrnerf import ESRNeRF as JESRNeRF
from esrnerf_tpu.data.sampler import BatchSampler as JSampler
from esrnerf_tpu.data.synthetic import write_scene as jwrite_scene
from esrnerf_tpu.models import voxurf_base as jvb
from esrnerf_tpu.models.voxurff import VoxurfF as JVoxurfF
from esrnerf_tpu.ops import grid as jgrid
from esrnerf_tpu.utils import lpips_fallback as jlpips
from esrnerf_tpu.utils import mesh as jmesh
from esrnerf_tpu.utils import metrics as jmetrics
from esrnerf_tpu_torch import run as trun
from esrnerf_tpu_torch.apps.fine import Fine as TFine
from esrnerf_tpu_torch.config import customize_cfg as tcustomize
from esrnerf_tpu_torch.config import load_cfg as tload
from esrnerf_tpu_torch.data.esrnerf import ESRNeRF as TESRNeRF
from esrnerf_tpu_torch.data.sampler import BatchSampler as TSampler
from esrnerf_tpu_torch.data.synthetic import write_scene as twrite_scene
from esrnerf_tpu_torch.models import voxurf_base as tvb
from esrnerf_tpu_torch.models.voxurff import VoxurfF as TVoxurfF
from esrnerf_tpu_torch.ops import grid as tgrid
from esrnerf_tpu_torch.utils import checkpoint as tckpt
from esrnerf_tpu_torch.utils import lpips_fallback as tlpips
from esrnerf_tpu_torch.utils import mesh as tmesh
from esrnerf_tpu_torch.utils import metrics as tmetrics
from esrnerf_tpu_torch.utils import png
from esrnerf_tpu_torch.utils.convert import params_from_jax, params_to_numpy
from test_torch_common import (NUM_VOXELS, REPO, S_VAL, ball_density,
                               load_both_cfgs, rays)

pytestmark = pytest.mark.quick

FINE_CFG = os.path.join(REPO, "cfg/exp/esrnerf/giftbox_w/fine.yaml")


# ------------------------------------------------------------------ codecs


def _png_with_filters(img: np.ndarray) -> bytes:
    """A PNG whose rows cycle through all five filter types."""
    H, W, C = img.shape
    x = img.reshape(H, W * C).astype(np.int32)
    rows = []
    for y in range(H):
        f = y % 5
        up = x[y - 1] if y else np.zeros(W * C, np.int32)
        left = np.concatenate([np.zeros(C, np.int32), x[y, :-C]])
        ul = np.concatenate([np.zeros(C, np.int32), up[:-C]])
        if f == 0:
            pred = np.zeros_like(up)
        elif f == 1:
            pred = left
        elif f == 2:
            pred = up
        elif f == 3:
            pred = (left + up) // 2
        else:
            p = left + up - ul
            pa, pb, pc = abs(p - left), abs(p - up), abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, up, ul))
        rows.append(bytes([f]) + ((x[y] - pred) & 0xFF).astype(np.uint8)
                    .tobytes())

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8,
                                         {3: 2, 4: 6}[C], 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(rows)))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("C", [1, 3, 4])
def test_png_codec_against_pil(C, tmp_path):
    rng = np.random.default_rng(C)
    img = (rng.uniform(size=(21, 19, C)) * 255).astype(np.uint8)
    img[:7] = np.linspace(0, 255, 19).astype(np.uint8)[None, :, None]
    img = img[..., 0] if C == 1 else img
    ours, pils = str(tmp_path / "ours.png"), str(tmp_path / "pil.png")
    png.write(ours, img)
    Image.fromarray(img).save(pils)
    for path in (ours, pils):
        np.testing.assert_array_equal(png.read(path), img)
        np.testing.assert_array_equal(np.asarray(Image.open(path)), img)
    if C > 1:
        mixed = str(tmp_path / "filters.png")
        with open(mixed, "wb") as f:
            f.write(_png_with_filters(img))
        np.testing.assert_array_equal(np.asarray(Image.open(mixed)), img)
        np.testing.assert_array_equal(png.read(mixed), img)


# ---------------------------------------------------------- data, sampler


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """The JAX package's synthetic scene (PIL PNGs) and the port's copy."""
    root = tmp_path_factory.mktemp("scene")
    jroot = jwrite_scene(str(root / "jax"), wh=24, n_train=4, n_test=1)
    troot = twrite_scene(str(root / "port"), wh=24, n_train=4, n_test=1)
    return jroot, troot


def _data_cfgs(root, extra=()):
    ov = ["app.phase=train", "data.cls=esrnerf.ESRNeRF", f"data.root={root}",
          "data.scene=synth_ball", *extra]
    return jload(FINE_CFG, ov, root_dir=REPO), tload(FINE_CFG, ov,
                                                     root_dir=REPO)


@pytest.mark.parametrize("phase", ["train", "test_nv", "test_nvc",
                                   "test_nvi", "test_nvic"])
def test_dataset_arrays_match_reference(scene, phase):
    jroot, troot = scene
    jcfg, tcfg = _data_cfgs(jroot)
    jd = JESRNeRF(jcfg, phase)
    for root in (jroot, troot):  # PIL-written and port-written files
        td = TESRNeRF(_data_cfgs(root)[1], phase)
        assert td.image_size == jd.image_size and len(td) == len(jd)
        assert td.all_data.keys() == jd.all_data.keys()
        for k, v in jd.all_data.items():
            np.testing.assert_array_equal(td.all_data[k], v, err_msg=k)
    if phase.startswith("test_nv") and phase != "test_nv":
        assert "em_masks" in td.all_data  # the relighting edits
    with pytest.raises(ValueError, match="unknown phase"):
        TESRNeRF(tcfg, "test_nvx")


def test_batch_sampler_matches_reference(scene):
    jroot, _ = scene
    data = JESRNeRF(_data_cfgs(jroot)[0], "train").all_data
    keys = ["rgbs", "rays_o", "rays_d", "viewdirs", "em_modes"]
    keep = np.random.default_rng(3).uniform(size=len(data["rgbs"])) > 0.3
    js, ts = JSampler(None, data, keys, 500, seed=5), \
        TSampler(None, data, keys, 500, seed=5)
    for s in (js, ts):
        s.filter(keep)
        s.shuffle()
    for _ in range(6):  # crosses an epoch boundary (reshuffle)
        jb, tb = js.sample(), ts.sample()
        for k in keys:
            np.testing.assert_array_equal(tb[k], jb[k])
    st = ts.state()
    assert st["batch_st"] == js.state()["batch_st"]
    np.testing.assert_array_equal(st["data_idxs"], js.state()["data_idxs"])
    # resume from the state gives the same next batch
    js2 = JSampler(None, data, keys, 500, seed=5, **js.state())
    ts2 = TSampler(None, data, keys, 500, seed=5, **st)
    np.testing.assert_array_equal(ts2.sample()["rgbs"], js2.sample()["rgbs"])


# --------------------------------------------------------------- model ops


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = load_both_cfgs()
    dens = ball_density()
    jmc = jvb.make_mask_cache(dens, [-1, -1, -1], [1, 1, 1], 1e-6, 1e-3, 3)
    tmc = tvb.make_mask_cache(dens, [-1, -1, -1], [1, 1, 1], 1e-6, 1e-3, 3,
                              device="cpu")
    jm = JVoxurfF(jcfg, 0.5, 4.0, [-1, -1, -1], [1, 1, 1], jmc, S_VAL,
                  NUM_VOXELS)
    tm = TVoxurfF(tcfg, 0.5, 4.0, [-1, -1, -1], [1, 1, 1], tmc, S_VAL,
                  NUM_VOXELS)
    params = jax.tree.map(np.asarray, jm.init_params(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(7)
    X, Y, Z = jm.geo.world_size
    x, y, z = np.mgrid[-1:1:X * 1j, -1:1:Y * 1j, -1:1:Z * 1j]
    r = np.sqrt(x**2 + y**2 + z**2)
    params["sdf"] = (r - 0.5 + rng.normal(scale=0.03, size=r.shape)
                     ).astype(np.float32)[..., None]
    for g in ("off_color", "emo_color"):
        params[g] = rng.normal(scale=0.3, size=params[g].shape).astype(
            np.float32)
    return jm, tm, params


def test_resize_and_gaussian_kernel_match_reference():
    rng = np.random.default_rng(0)
    g = rng.normal(size=(9, 7, 11, 3)).astype(np.float32)
    for size in [(17, 13, 21), (5, 7, 6), (1, 7, 3)]:
        want = np.asarray(jgrid.resize_trilinear(jnp.asarray(g), size))
        got = tgrid.resize_trilinear(torch.as_tensor(g), size, slab=4)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    for k, s in [(5, 1.0), (3, 0.5)]:
        np.testing.assert_array_equal(tgrid.make_gaussian_kernel_3d(k, s),
                                      jgrid.make_gaussian_kernel_3d(k, s))


def test_load_coarse_sdf_and_scale_volume_grid_match_reference(models):
    jm, tm, params = models
    rng = np.random.default_rng(2)
    coarse = rng.normal(size=(20, 20, 20, 1)).astype(np.float32)
    # values up to ~10 through a 125-tap blur summed in another order:
    # a few f32 ulps of the magnitude
    np.testing.assert_allclose(
        tm.load_coarse_sdf(coarse, 0.3).numpy(),
        np.asarray(jm.load_coarse_sdf(coarse, 0.3)), rtol=1e-5, atol=1e-5)

    # a fresh pair of models: scaling mutates the geometry
    jcfg, tcfg = load_both_cfgs()
    dens = ball_density()
    jm2 = JVoxurfF(jcfg, 0.5, 4.0, [-1] * 3, [1] * 3, jvb.make_mask_cache(
        dens, [-1] * 3, [1] * 3, 1e-6, 1e-3, 3), S_VAL, NUM_VOXELS)
    tm2 = TVoxurfF(tcfg, 0.5, 4.0, [-1] * 3, [1] * 3, tvb.make_mask_cache(
        dens, [-1] * 3, [1] * 3, 1e-6, 1e-3, 3, device="cpu"), S_VAL,
        NUM_VOXELS)
    pj = jm2.scale_volume_grid(jax.tree.map(jnp.asarray, params),
                               int(NUM_VOXELS * 4.096))
    pt = tm2.scale_volume_grid(params_from_jax(params, device="cpu"),
                               int(NUM_VOXELS * 4.096))
    assert tm2.geo.world_size == jm2.geo.world_size != (32, 32, 32)
    assert tm2.geo.n_samples == jm2.geo.n_samples
    assert tm2.num_voxels == jm2.num_voxels
    np.testing.assert_array_equal(tm2._nonempty.numpy(),
                                  np.asarray(jm2._nonempty))
    np.testing.assert_array_equal(tm2.geo._mask_sup_blk.numpy(),
                                  np.asarray(jm2.geo._mask_sup_blk))
    for k in ("sdf", "off_color", "emo_color"):
        np.testing.assert_allclose(pt[k].numpy(), np.asarray(pj[k]),
                                   rtol=1e-6, atol=1e-6, err_msg=k)


def test_ray_filter_and_sdf_grad_match_reference(models):
    jm, tm, params = models
    b = rays(512, seed=3)
    rd = b["rays_d"].copy()
    rd[::4] = -b["rays_o"][::4] * 0.1 + np.array([3.0, 0, 0], np.float32)
    want = jm.geo.filter_rays_in_maskcache(b["rays_o"], rd, 100,
                                           style="voxurf")
    got = tm.geo.filter_rays_in_maskcache(b["rays_o"], rd, 100)
    assert 0 < want.sum() < len(want)
    np.testing.assert_array_equal(got, want)

    pts = np.random.default_rng(4).uniform(-0.9, 0.9, (3000, 3)).astype(
        np.float32)
    sj, gj = jm.geo.sample_sdf_grad(jnp.asarray(params["sdf"]),
                                    jnp.asarray(pts))
    st, gt = tm.geo.sample_sdf_grad(torch.as_tensor(params["sdf"]),
                                    torch.as_tensor(pts))
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("em", [0, 1])
def test_forward_evaluate_matches_reference(models, em):
    jm, tm, params = models
    b = rays()
    rot = np.asarray([[0.0, 0.6, 0.8], [1.0, 0.0, 0.0], [0.0, 0.8, -0.6]],
                     np.float32)
    oj = jm.forward_evaluate(
        jax.tree.map(jnp.asarray, params), jnp.asarray(b["rays_o"]),
        jnp.asarray(b["rays_d"]), jnp.asarray(b["viewdirs"]), jnp.int32(em),
        jnp.asarray(rot), jnp.float32(S_VAL))
    ot = tm.forward_evaluate(
        params_from_jax(params, device="cpu"), torch.as_tensor(b["rays_o"]),
        torch.as_tensor(b["rays_d"]), torch.as_tensor(b["viewdirs"]), em,
        torch.as_tensor(rot), S_VAL)
    assert ot.keys() == oj.keys()
    assert float(ot["etc/overflow"]) == float(oj["etc/overflow"]) == 0.0
    for k in oj:
        np.testing.assert_allclose(ot[k].numpy(), np.asarray(oj[k]),
                                   rtol=1e-4, atol=1e-5, err_msg=k)


# ----------------------------------------------------------- metrics, mesh


def test_ssim_and_lpips_fallback_match_reference():
    rng = np.random.default_rng(5)
    a = rng.uniform(size=(40, 36, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(scale=0.1, size=a.shape), 0, 1).astype(
        np.float32)
    assert tmetrics.rgb_ssim(a, b, 1) == jmetrics.rgb_ssim(a, b, 1)
    assert tmetrics.loss2psnr(0.01) == jmetrics.loss2psnr(0.01)
    for shape in [(3, 40, 36), (3, 20, 24)]:  # the second is tiled up
        x = rng.uniform(-1, 1, shape).astype(np.float32)
        y = np.clip(x + rng.normal(scale=0.2, size=shape), -1, 1).astype(
            np.float32)
        np.testing.assert_allclose(tlpips.rand_lpips(x, y),
                                   jlpips.rand_lpips(x, y), rtol=1e-5)


def test_mesh_matches_reference(tmp_path):
    n = 20
    g = np.linspace(-1, 1, n, dtype=np.float32)
    xx, yy, zz = np.meshgrid(g, g, g, indexing="ij")
    field = (0.6 - np.sqrt(xx**2 + 1.3 * yy**2 + zz**2)).astype(np.float32)
    vj, tj = jmesh._marching_tets_numpy(field, 0.0)
    vt, tt = tmesh.marching_cubes(torch.as_tensor(field), 0.0)
    assert len(tj) > 100
    np.testing.assert_array_equal(vt, vj)
    np.testing.assert_array_equal(tt, tj)

    def query(pts):
        return 0.6 - torch.sqrt((pts * pts).sum(-1))

    uj = jmesh.extract_fields(np.full(3, -1.0), np.ones(3), 17,
                              lambda p: query(torch.as_tensor(p)).numpy(), 8)
    ut = tmesh.extract_fields(np.full(3, -1.0), np.ones(3), 17, query,
                              max_points=600, device="cpu")
    np.testing.assert_array_equal(ut.numpy(), uj)

    pj, pt = str(tmp_path / "j.ply"), str(tmp_path / "t.ply")
    jmesh.export_ply(pj, vj, tj)
    tmesh.export_ply(pt, vt, tt)
    assert open(pj, "rb").read() == open(pt, "rb").read()


# -------------------------------------------- trainer, handoff, entry point

MICRO = [
    "data.cls=esrnerf.ESRNeRF", "data.scene=synth_ball", "log.name=t",
    "log.offline=true", "system.compute_dtype=float32", "system.mesh_axes=[]",
    "system.debug=true", "app.trainer.num_voxels=4096",
    "app.trainer.batch_size=64", "app.trainer.s_start=40",
    "app.model.rgbnet_width=32", "app.model.rgbnet_depth=2",
    "app.model.tonemap_width=32", "app.model.tonemap_depth=2",
    "app.model.points_budget_masked_per_ray=432",
    "app.model.points_budget_per_ray=16", "app.eval.batch_size=288",
]


def write_coarse_ckpt(path, mask_res=16, coarse_res=24):
    """A coarse-stage checkpoint in the JAX package's schema: an occupancy
    ball of radius 0.7 as the mask density and a sphere SDF."""
    def radius(n):
        g = np.linspace(-1, 1, n)
        x, y, z = np.meshgrid(g, g, g, indexing="ij")
        return np.sqrt(x**2 + y**2 + z**2)

    lo, hi = np.full(3, -1, np.float32), np.ones(3, np.float32)
    tckpt.save_checkpoint(path, {
        "renderer": {
            "cfg": {}, "near": 0.5, "far": 6.0, "xyz_min": lo, "xyz_max": hi,
            "s_val": 20.0, "mask_xyz_min": lo, "mask_xyz_max": hi,
            "mask_alpha_init": 1e-6,
            "mask_density": np.where(radius(mask_res) < 0.7, 20.0, -20.0)
            .astype(np.float32)[..., None],
            "params": {"sdf": (radius(coarse_res) - 0.5).astype(
                np.float32)[..., None]},
        },
        "trainer": {"global_step": 0},
    })
    return path


@pytest.fixture(scope="module")
def run_dir(scene, tmp_path_factory):
    root = tmp_path_factory.mktemp("runs")
    coarse = write_coarse_ckpt(str(root / "coarse.ckpt"))
    return scene[1], str(root), coarse


def _trainer_cfgs(run_dir, name, extra=()):
    data_root, root, coarse = run_dir
    ov = ["app.phase=train", *MICRO, f"data.root={data_root}",
          f"log.root={root}/{name}", f"app.trainer.ckpt={coarse}",
          "app.trainer.pg_scale=[]", *extra]
    return (jcustomize(jload(FINE_CFG, ov, root_dir=REPO)),
            tcustomize(tload(FINE_CFG, ov + ["system.device=cpu"],
                             root_dir=REPO)))


def _jax_steps(f, step, n):
    """n iterations of the JAX Fine.learn loop body; returns the aux rows."""
    out = []
    for _ in range(n):
        gs = f.global_step
        batch = f.place_batch(f.sampler.sample())
        tv = 1.0 if (f.tv_from < gs < f.tv_end and gs % f.tv_every == 0) \
            else 0.0
        f.params, f.opt_state, aux = step(
            f.params, f.opt_state, batch, jnp.float32(f.s_val_at(gs)),
            {k: jnp.float32(v) for k, v in f.lr_scales.items()},
            jnp.float32(tv), jnp.float32(f.tvs["smooth_grad"]),
            jnp.float32(f.weight_tv_density * f.tvs["sdf"] / f.train_bs),
            jnp.bool_(gs < f.tv_dense_before))
        out.append([float(a) for a in aux])
        decay = f.lr_scheduler.decay_factor
        for k in f.lr_scales:
            f.lr_scales[k] *= decay
        f.global_step += 1
    return out


def _port_steps(f, n):
    from esrnerf_tpu_torch.apps.fine import build_fine_train_step

    step = build_fine_train_step(f.renderer, f.opt, f.cfg, device="cpu")
    out = []
    for _ in range(n):
        gs = f.global_step
        batch = f.place_batch(f.sampler.sample())
        tv = 1.0 if (f.tv_from < gs < f.tv_end and gs % f.tv_every == 0) \
            else 0.0
        f.params, f.opt_state, aux = step(
            f.params, f.opt_state, batch, f.s_val_at(gs), dict(f.lr_scales),
            tv, float(f.tvs["smooth_grad"]),
            float(f.weight_tv_density * f.tvs["sdf"] / f.train_bs),
            gs < f.tv_dense_before)
        out.append([float(a) for a in aux])
        decay = f.lr_scheduler.decay_factor
        for k in f.lr_scales:
            f.lr_scales[k] *= decay
        f.global_step += 1
    return out


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree)}


def test_checkpoint_handoff_both_ways(run_dir):
    """A JAX Fine checkpoint resumes in the port and both take the same
    next 2 steps; the port's checkpoint then loads in the JAX Fine eval and
    both render the same chunk from it."""
    jcfg, tcfg = _trainer_cfgs(run_dir, "handoff")
    jf = JFine(jcfg)
    jf.load_dataset()
    jf.load_model()
    jstep = jf._build_train_step()
    _jax_steps(jf, jstep, 1)
    jf.global_step -= 1  # the loop's step index at save time
    jf.save(os.path.join(jf.ckpt_dir(), "last.ckpt"))
    jf.global_step += 1

    tf = TFine(tcfg)  # same log dir: resumes from the JAX last.ckpt
    tf.load_dataset()
    tf.load_model()
    assert tf.global_step == jf.global_step == 1
    assert tf.lr_scales == jf.lr_scales
    aux_j = _jax_steps(jf, jstep, 2)
    aux_t = _port_steps(tf, 2)
    for aj, at in zip(aux_j, aux_t):
        assert aj[2] == at[2] == 0.0  # overflow
        assert aj[3:] == at[3:]  # identical survivor counts
        np.testing.assert_allclose(at[:2], aj[:2], rtol=1e-5)
    # Adam moments within the step test's gradient tolerance; parameters
    # where the first moment is well above its noise
    mu_j, mu_t = _leaves(jf.opt_state.mu), _leaves(params_to_numpy(
        tf.opt_state.mu))
    pj, pt = _leaves(jf.params), _leaves(params_to_numpy(tf.params))
    for k in mu_j:
        scale = np.abs(mu_j[k]).max()
        assert scale > 0, k
        assert np.abs(mu_t[k] - mu_j[k]).max() <= 1e-4 * scale, k
        sel = np.abs(mu_j[k]) > 1e-3 * scale
        lr = jf.lrs[k.split("/")[0]]
        np.testing.assert_allclose(pt[k][sel], pj[k][sel], rtol=1e-6,
                                   atol=2e-4 * lr, err_msg=k)

    # port checkpoint -> the JAX eval
    tf.global_step -= 1
    path = os.path.join(tf.ckpt_dir(), "last.ckpt")
    tf.save(path)
    ecfg = jload(FINE_CFG, ["app.phase=test_nv", *MICRO,
                            f"data.root={run_dir[0]}",
                            f"log.root={run_dir[1]}/eval",
                            f"app.eval.ckpt={path}"], root_dir=REPO)
    je = JFine(jcustomize(ecfg))
    je.load_model()
    assert je.global_step == tf.global_step
    assert je.renderer.geo.world_size == tf.renderer.geo.world_size
    lj, lt = _leaves(je.params), _leaves(params_to_numpy(tf.params))
    for k in lj:
        np.testing.assert_array_equal(lj[k], lt[k], err_msg=k)
    b = rays(64, seed=9)
    rot = np.eye(3, dtype=np.float32)
    oj = je.renderer.forward_evaluate(
        je.params, *(jnp.asarray(b[k]) for k in ("rays_o", "rays_d",
                                                 "viewdirs")),
        jnp.int32(1), jnp.asarray(rot), jnp.float32(40.0))
    ot = tf.renderer.forward_evaluate(
        tf.params, *(torch.as_tensor(b[k]) for k in ("rays_o", "rays_d",
                                                     "viewdirs")),
        1, torch.as_tensor(rot), 40.0)
    for k in ("srgb/rgb", "lin/rgb", "etc/depth"):
        np.testing.assert_allclose(ot[k].numpy(), np.asarray(oj[k]),
                                   rtol=1e-4, atol=1e-5, err_msg=k)


def test_run_main_end_to_end_on_cpu(run_dir, monkeypatch):
    ov = ["app.trainer.pg_scale=[2]", "app.trainer.n_iters=4",
          "app.trainer.save_every=2", "app.trainer.vis_every=4",
          "app.trainer.N_vis=1", "system.tqdm_iters=1"]
    args = ["-cn", FINE_CFG, "app.phase=train", *MICRO,
            f"data.root={run_dir[0]}", f"log.root={run_dir[1]}/e2e",
            f"app.trainer.ckpt={run_dir[2]}", *ov]
    app = trun.main(args + ["system.device=cpu"])
    ld = app.cfg.log["dir"]
    rows = [json.loads(ln) for ln in open(os.path.join(ld, "metrics.jsonl"))]
    train = [r for r in rows if "train/metric/srgb/MSE" in r]
    assert [r["step"] for r in train] == [0, 1, 2, 3]
    assert all(np.isfinite(v) for r in rows for v in r.values())
    assert all(r["train/metric/etc/overflow"] == 0.0 for r in train)
    # progressive scaling at step 2
    assert train[1]["train/metric/etc/num_voxels"] < \
        train[2]["train/metric/etc/num_voxels"]
    mean = open(os.path.join(ld, "text", f"{3:010}", "mean.txt")).read()
    for key in ("srgb/PSNR", "srgb/SSIM", "srgb/LPIPS_ALEX"):
        assert key in mean
    head = open(os.path.join(ld, "mesh", f"{3:010}", "mesh.ply"), "rb").read(
        200).decode("latin1")
    n_vert = int(head.split("element vertex ")[1].split()[0])
    assert n_vert > 0
    assert os.path.exists(os.path.join(ld, "checkpoints", "last.ckpt"))
    assert png.read(os.path.join(ld, "image", f"{3:010}", "srgb", "rgb",
                                 "000.png")).shape == (24, 24, 3)

    # resume continues from the saved step; test_nv evaluates the ckpt
    app2 = trun.main(args + ["system.device=cpu", "app.trainer.n_iters=5"])
    assert app2.global_step == 4
    app3 = trun.main(["-cn", FINE_CFG, "app.phase=test_nv", *MICRO,
                      f"data.root={run_dir[0]}", f"log.root={run_dir[1]}/e2e",
                      f"app.eval.ckpt={ld}/checkpoints/last.ckpt",
                      "system.device=cpu"])
    assert app3.timings["mesh_verts"] > 0

    # without system.device=cpu the entry point asks for CUDA
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        trun.main(args)
    with pytest.raises(KeyError, match="unknown app.cls"):
        trun.main(["-cn", os.path.join(REPO, "cfg/app/pdra.yaml"),
                   "app.phase=train", "app.cls=fine.Unregistered",
                   "data.cls=x", "data.root=x", "data.scene=x",
                   "system.device=cpu"])
