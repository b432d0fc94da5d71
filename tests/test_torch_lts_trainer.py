"""The port's LTS trainer slice against the JAX package, on the CPU at micro
scale: the two-pool ``RayGroupManager``, the eval forward with the PBR
points, the chunked decomposition, ``Fine``'s eval hooks, the checkpoint
handoff in both directions, and the chain fine -> LTS through
``esrnerf_tpu_torch.run`` (``system.device=cpu``)."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esrnerf_tpu.apps.lts import LTS as JLTS
from esrnerf_tpu.config import customize_cfg as jcustomize
from esrnerf_tpu.config import load_cfg as jload
from esrnerf_tpu.data.sampler import RayGroupManager as JGroups
from esrnerf_tpu_torch import run as trun
from esrnerf_tpu_torch.apps.fine import Fine as TFine
from esrnerf_tpu_torch.apps.lts import LTS as TLTS
from esrnerf_tpu_torch.config import customize_cfg as tcustomize
from esrnerf_tpu_torch.config import load_cfg as tload
from esrnerf_tpu_torch.data.sampler import RayGroupManager as TGroups
from esrnerf_tpu_torch.data.synthetic import write_scene
from esrnerf_tpu_torch.utils import checkpoint as tckpt
from esrnerf_tpu_torch.utils import png
from esrnerf_tpu_torch.utils.convert import params_from_jax, params_to_numpy
from test_torch_common import REPO, rays
from test_torch_lts_step import S_VAL, lts_models, lts_params

pytestmark = pytest.mark.quick

KEYS = ["rgbs", "rays_o", "rays_d", "viewdirs", "em_modes"]


def _stage_cfg(stage):
    return os.path.join(REPO, f"cfg/exp/esrnerf/giftbox_w/{stage}.yaml")


# ------------------------------------------------------- RayGroupManager


def _pool(n, seed=0):
    r = np.random.default_rng(seed)
    return {"rgbs": r.uniform(size=(n, 3)).astype(np.float32),
            "rays_o": r.normal(size=(n, 3)).astype(np.float32),
            "rays_d": r.normal(size=(n, 3)).astype(np.float32),
            "viewdirs": r.normal(size=(n, 3)).astype(np.float32),
            "em_modes": r.integers(0, 2, n)}


def _same_batch(tb, jb):
    assert tb.keys() == jb.keys()
    for k in jb:
        np.testing.assert_array_equal(tb[k], jb[k], err_msg=k)


def _same_state(ts, js):
    for k, v in js.items():
        np.testing.assert_array_equal(ts[k], v, err_msg=k)


@pytest.mark.parametrize("u_bs,c_bs", [(100, 0), (60, 40), (250, 30)])
def test_ray_group_manager_matches_reference(u_bs, c_bs):
    """Same seed, same batches and ``uncert_masks``: the LTS start (cert
    batch 0), filters moving rays to the certain pool, pools smaller than
    their batch (wrap-around fill), an empty pool borrowing from the other,
    and a resume from ``state()``."""
    data = _pool(300)
    idxs = np.random.default_rng(1).permutation(300)[:220]
    mk = lambda cls, **kw: cls(None, data, KEYS, u_bs, c_bs,
                               uncert_data_idxs=idxs, seed=3, **kw)
    js, ts = mk(JGroups), mk(TGroups)
    js.shuffle(), ts.shuffle()
    filt = np.random.default_rng(2)
    for i in range(7):
        _same_batch(ts.sample(), js.sample())
        if i in (1, 3):  # rays leave the uncertain pool
            keep = filt.uniform(size=ts.uncert_data_num) > (0.5 if i == 1
                                                           else 0.9)
            js.filter(keep), ts.filter(keep)
        _same_state(ts.state(), js.state())
    st = js.state()
    rs = dict(uncert_batch_st=st["uncert_batch_st"],
              cert_batch_st=st["cert_batch_st"],
              uncert_data_idxs=st["uncert_data_idxs"],
              cert_data_idxs=st["cert_data_idxs"])
    js2, ts2 = (cls(None, data, KEYS, u_bs, c_bs, seed=3, **rs)
                for cls in (JGroups, TGroups))
    for _ in range(3):
        _same_batch(ts2.sample(), js2.sample())


def test_ray_group_manager_empty_uncertain_pool_borrows():
    data = _pool(50)
    mk = lambda cls: cls(None, data, KEYS, 16, 8,
                         uncert_data_idxs=np.arange(50), seed=0)
    js, ts = mk(JGroups), mk(TGroups)
    for s in (js, ts):
        s.filter(np.zeros(50, bool))  # every ray certain
    for _ in range(3):
        tb, jb = ts.sample(), js.sample()
        _same_batch(tb, jb)
        assert len(tb["rgbs"]) == 24 and not tb["uncert_masks"].any()


# --------------------------------------------------------- eval pieces


@pytest.fixture(scope="module")
def eval_setup():
    _, tcfg, jm, tm = lts_models()
    params = lts_params(jm, seed=9)
    b = rays(64, seed=4)
    rot = np.eye(3, dtype=np.float32)[[1, 2, 0]]
    want = jax.jit(lambda p, o, d, v, r: jm.forward_evaluate(
        p, o, d, v, jnp.int32(1), r, jnp.float32(S_VAL), render_pbr=True))(
        jax.tree.map(jnp.asarray, params),
        *(jnp.asarray(b[k]) for k in ("rays_o", "rays_d", "viewdirs")),
        jnp.asarray(rot))
    tp = params_from_jax(params, device="cpu")
    got = tm.forward_evaluate(
        tp, *(torch.as_tensor(b[k]) for k in ("rays_o", "rays_d",
                                                "viewdirs")),
        1, torch.as_tensor(rot), S_VAL, render_pbr=True)
    return tcfg, jm, tm, params, tp, want, got


def test_forward_evaluate_with_pbr_points_matches_reference(eval_setup):
    _, _, _, _, _, want, got = eval_setup
    assert set(got) == set(want)
    assert float(want["etc/overflow"]) == 0.0
    # the eval forward's bounds (tests/test_torch_fine_trainer.py)
    for k, w in want.items():
        if k == "pbr_points":
            continue
        np.testing.assert_allclose(got[k].numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    pj, pt = want["pbr_points"], got["pbr_points"]
    assert set(pt) == set(pj)
    for k in ("ray_id", "pad"):
        np.testing.assert_array_equal(pt[k].numpy(), np.asarray(pj[k]))
    for k in pj:
        np.testing.assert_allclose(pt[k].numpy(), np.asarray(pj[k]),
                                   rtol=1e-4, atol=1e-5, err_msg=k)


def test_lts_eval_chunk_matches_reference(eval_setup):
    _, jm, tm, params, tp, want, _ = eval_setup
    pj = want["pbr_points"]
    nv = int((~np.asarray(pj["pad"])).sum())
    sl = slice(0, min(nv, 48))
    args = [np.asarray(pj[k])[sl] for k in ("pts", "viewdirs", "normal",
                                            "basecolor", "roughness",
                                            "metallic")]
    key = jax.random.PRNGKey(2)
    wj = jax.jit(lambda p, *a: jm.lts_eval_chunk(p, key, *a,
                                                 jnp.float32(S_VAL)))(
        jax.tree.map(jnp.asarray, params), *map(jnp.asarray, args))
    draws = torch.as_tensor(np.array(jax.random.normal(
        key, (len(args[0]), tm.num_2ndrays, 3))))
    wt = tm.lts_eval_chunk(tp, draws, *map(torch.as_tensor, args), S_VAL)
    assert set(wt) == set(wj)
    assert float(wj["etc/overflow"]) == float(wt["etc/overflow"]) == 0.0
    for k in wj:
        np.testing.assert_allclose(wt[k].numpy(), np.asarray(wj[k]),
                                   rtol=1e-4, atol=1e-5, err_msg=k)
    assert float(np.abs(np.asarray(wj["lin/env_dir"])).max()) > 0


def _bare_lts(cls, cfg, renderer, params, chunk):
    """An LTS app holding only what its eval decomposition reads."""
    app = cls.__new__(cls)
    app.cfg, app.renderer, app.params, app.chunk_sz = cfg, renderer, \
        params, chunk
    app.device = torch.device("cpu")
    return app


def test_decompose_pbr_matches_reference(eval_setup, monkeypatch):
    """The chunked decomposition per ray, the port fed the JAX draws of
    each chunk (the port skips the chunks past the pad tail: their weights
    are 0)."""
    tcfg, jm, tm, params, tp, want, got = eval_setup
    jcfg = jload("cfg/app/lts.yaml", ["system.mesh_axes=[]", "data.cls=x",
                                      "data.root=x", "data.scene=x"],
                 root_dir=REPO)
    japp = _bare_lts(JLTS, jcfg, jm, jax.tree.map(jnp.asarray, params), 256)
    res_j = japp._decompose_pbr(want["pbr_points"], 64, jnp.float32(S_VAL))

    key, subs = jax.random.PRNGKey(0), []
    for _ in range(4):
        key, sub = jax.random.split(key)
        subs.append(sub)
    calls = iter(subs)
    monkeypatch.setattr(
        TLTS, "_lts_chunk_draws", lambda self, gen, k: torch.as_tensor(
            np.array(jax.random.normal(next(calls), (k, tm.num_2ndrays, 3)))))
    tapp = _bare_lts(TLTS, tcfg, tm, tp, 256)
    res_t = tapp._decompose_pbr(got["pbr_points"], 64, S_VAL)
    assert set(res_t) == set(res_j)
    for k in res_j:
        w = np.asarray(res_j[k])
        assert w.shape == (64, 3)
        np.testing.assert_allclose(res_t[k].numpy(), w, rtol=1e-4, atol=1e-5,
                                   err_msg=k)
    assert float(np.abs(np.asarray(res_j["lin/env_effects"])).max()) > 0


# ----------------------------------------------- the chain through run.main

# the fine and LTS stages cut to CPU size on a 24x24 scene; f32 heads
FINE_MICRO = [
    "app.trainer.num_voxels=4096", "app.trainer.batch_size=64",
    "app.trainer.s_start=40", "app.trainer.pg_scale=[]",
    "app.model.rgbnet_width=32", "app.model.rgbnet_depth=2",
    "app.model.tonemap_width=32", "app.model.tonemap_depth=2",
    "app.model.points_budget_masked_per_ray=432",
    "app.model.points_budget_per_ray=16",
]
LTS_MICRO = FINE_MICRO[1:4] + FINE_MICRO[4:] + [
    "app.model.brdfnet_width=32", "app.model.brdfnet_depth=2",
    "app.model.num_ltspts=16", "app.model.num_2ndrays=4",
    "app.model.points_budget_masked_per_2ndray=128",
    "app.model.points_budget_per_2ndray=16",
]


def _common(root, name):
    return [f"data.root={root}/data", "data.cls=esrnerf.ESRNeRF",
            "data.scene=synth_ball", f"log.root={root}/{name}", "log.name=t",
            "log.offline=true", "system.debug=true", "system.mesh_axes=[]",
            "system.compute_dtype=float32", "system.tqdm_iters=1",
            "app.eval.batch_size=288", "app.trainer.N_vis=1"]


def _coarse_ckpt(path):
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
            "mask_density": np.where(radius(16) < 0.7, 20.0, -20.0)
            .astype(np.float32)[..., None],
            "params": {"sdf": (radius(24) - 0.5).astype(np.float32)[..., None]},
        },
        "trainer": {"global_step": 0},
    })
    return path


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    """A scene and a port fine run (2 steps) in ``<root>/chain`` and, by the
    same log name, in ``<root>/handoff``: the LTS runs find them by path."""
    root = str(tmp_path_factory.mktemp("lts"))
    write_scene(f"{root}/data", wh=24, n_train=4, n_test=1)
    coarse = _coarse_ckpt(f"{root}/coarse.ckpt")
    for name in ("chain", "handoff"):
        fine = trun.main(["-cn", _stage_cfg("fine"), "app.phase=train",
                          *_common(root, name), *FINE_MICRO,
                          f"app.trainer.ckpt={coarse}",
                          "app.trainer.n_iters=2",
                          "app.trainer.vis_every=100", "system.device=cpu"])
    return root, os.path.join(fine.cfg.log["dir"], "checkpoints",
                              "last.ckpt")


def _lts_args(root, name, *extra):
    return ["-cn", _stage_cfg("lts"), *_common(root, name), *LTS_MICRO,
            *extra]


def _rows(app):
    with open(os.path.join(app.cfg.log["dir"], "metrics.jsonl")) as f:
        return [json.loads(ln) for ln in f]


def test_run_main_chains_fine_to_lts_on_cpu(chain, monkeypatch):
    """LTS from the fine stage's checkpoint by path: train (the envmap PNGs
    and the mesh in its eval), checkpoint, resume, then test_nv of the
    saved checkpoint."""
    root, _ = chain
    args = _lts_args(root, "chain", "app.phase=train",
                     "app.trainer.save_every=2", "app.trainer.vis_every=2",
                     "system.device=cpu")
    app = trun.main(args + ["app.trainer.n_iters=2"])
    assert isinstance(app, TLTS)
    ld = app.cfg.log["dir"]
    rows = _rows(app)
    train = [r for r in rows if "train/metric/srgb/MSE" in r]
    assert [r["step"] for r in train] == [0, 1]
    assert all(np.isfinite(v) for r in rows for v in r.values())
    for r in train:
        assert r["train/metric/etc/overflow"] == 0.0
        assert r["train/metric/etc/k2_frac_2nd"] > 0.0
    step_dir = f"{1:010}"
    for name in ("envmap.png", "envmap_gamma.png"):
        img = png.read(os.path.join(ld, "image", step_dir, "etc", name))
        assert img.shape == (128, 256, 3)
    assert png.read(os.path.join(ld, "image", step_dir, "lin", "basecolor",
                                 "000.png")).shape == (24, 24, 3)
    mean = open(os.path.join(ld, "text", step_dir, "mean.txt")).read()
    assert "srgb/PSNR" in mean
    head = open(os.path.join(ld, "mesh", step_dir, "mesh.ply"), "rb").read(
        200).decode("latin1")
    assert int(head.split("element vertex ")[1].split()[0]) > 0
    ckpt = os.path.join(ld, "checkpoints", "last.ckpt")
    payload = tckpt.load_checkpoint(ckpt)
    assert set(payload["renderer"]["params"]) >= {"brdf", "brdfnet",
                                                  "emitnet", "envmap"}
    assert set(payload["renderer"]["params"]["envmap"]) == {
        "mus", "lambdas", "lobes"}

    app2 = trun.main(args + ["app.trainer.n_iters=3"])
    assert app2.global_step == 2
    assert [r["step"] for r in _rows(app2)
            if "train/metric/srgb/MSE" in r] == [0, 1, 2]
    app3 = trun.main(_lts_args(root, "chain", "app.phase=test_nv",
                               f"app.eval.ckpt={ckpt}", "system.device=cpu"))
    assert app3.global_step == 2 and app3.timings["mesh_verts"] > 0
    ev = _rows(app3)[-1]
    assert np.isfinite(ev["test_nv/metric/srgb/PSNR"])

    # without system.device=cpu the entry point asks for CUDA
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        trun.main(_lts_args(root, "nocuda", "app.phase=train"))


def _jax_lts(cfg):
    j = JLTS(jcustomize(cfg))
    j.load_dataset()
    j.load_model()
    return j


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree)}


def test_lts_checkpoint_handoff_both_ways(chain):
    """A JAX LTS checkpoint (from the port's fine checkpoint) resumes in the
    port with the same parameters, optimizer state, schedule and next
    batch; the port's LTS checkpoint then resumes in the JAX LTS the same
    way."""
    ov = ["app.phase=train", *_common(chain[0], "handoff"), *LTS_MICRO]
    j = _jax_lts(jload(_stage_cfg("lts"), ov, root_dir=REPO))
    assert j.global_step == 0
    j.save(os.path.join(j.ckpt_dir(), "last.ckpt"))

    t = TLTS(tcustomize(tload(_stage_cfg("lts"), ov + ["system.device=cpu"],
                              root_dir=REPO)))
    t.load_dataset()
    t.load_model()  # resumes from the JAX last.ckpt
    assert t.global_step == 1 and t.lr_scales == j.lr_scales
    lj, lt = _leaves(j.params), _leaves(params_to_numpy(t.params))
    assert lj.keys() == lt.keys()
    for k in lj:
        np.testing.assert_array_equal(lt[k], lj[k], err_msg=k)
    for tree_t, tree_j in ((t.opt_state.mu, j.opt_state.mu),
                           (t.opt_state.nu, j.opt_state.nu)):
        for k, v in _leaves(tree_j).items():
            np.testing.assert_array_equal(_leaves(params_to_numpy(tree_t))[k],
                                          v, err_msg=k)
    _same_batch(t.sampler.sample(), j.sampler.sample())

    # the port's checkpoint at step 1 (parameters moved off the JAX ones):
    # the JAX LTS resumes from it
    t.params["brdf"] = t.params["brdf"] + 0.5
    t.params["envmap"]["mus"] = t.params["envmap"]["mus"] * 2.0
    t.global_step = 1
    t.save(os.path.join(t.ckpt_dir(), "last.ckpt"))
    j2 = _jax_lts(jload(_stage_cfg("lts"), ov, root_dir=REPO))
    assert j2.global_step == 2
    lj2 = _leaves(j2.params)
    for k, v in _leaves(params_to_numpy(t.params)).items():
        np.testing.assert_array_equal(lj2[k], v, err_msg=k)
    np.testing.assert_array_equal(j2.sampler.uncert_data_idxs,
                                  t.sampler.uncert_data_idxs)
    assert j2.sampler.uncert_batch_st == t.sampler.uncert_batch_st


def test_fine_eval_hooks_leave_fine_unchanged(chain, tmp_path):
    """``Fine``'s eval chunk is the renderer's forward as it was (keys and
    values), its pre-composite hook returns the images untouched and its
    scene hook writes nothing."""
    root, ckpt = chain
    cfg = tcustomize(tload(_stage_cfg("fine"), [
        "app.phase=test_nv", *_common(root, "hooks"), *FINE_MICRO,
        f"app.eval.ckpt={ckpt}", "system.device=cpu"], root_dir=REPO))
    f = TFine(cfg)
    f.load_dataset()
    f.load_model()
    b = rays(64, seed=6)
    args = [torch.as_tensor(b[k]) for k in ("rays_o", "rays_d", "viewdirs")]
    rot = torch.eye(3)
    want = f.renderer.forward_evaluate(f.params, *args, 1, rot, 40.0)
    got = f._eval_chunk(*args, 1, rot, 40.0)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy())
    imgs, metrics = {k: v.numpy() for k, v in want.items()}, {"a": [1.0]}
    assert f._pre_composite_hook(imgs, {}, metrics) is imgs
    assert metrics == {"a": [1.0]}
    f._scene_extra_images({"image": str(tmp_path)})
    assert os.listdir(tmp_path) == []
