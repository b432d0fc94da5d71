"""The port's ``system.parallel=gspmd`` and ``system.param_shard=fsdp``
layouts on 4 spawned gloo ranks on the CPU, free of JAX: the ranks run
this module's task functions through ``tests/test_torch_parallel_ranks.py``'s
:class:`RankPool` (one world for the module, one torch thread a rank).

- Under ``gspmd`` each stage's step and the relighting fine-tune at world 4
  equal the port's step at world 1 on the same global batch and generator,
  with the real random draws (random scattering, the perturbation eps of
  the configs, fewer surface points than head rows): loss terms rtol
  1e-5, each gradient group within 1e-4 of its largest entry, overflow 0,
  and the march counters world 1's fractions (rtol 1e-6); after 2 Adam
  steps at lr 0.01 the parameters where Adam resolves the gradients
  (each step's at least 0.1 of its leaf's largest) within rtol 2e-4 /
  atol 1e-6 (``tests/test_torch_parallel.py``'s rule).
- ``fsdp`` against replicated parameters, both under ``gspmd`` at world
  4: the parameters after 3 Adam steps within rtol 1e-6 / atol 1e-7 (the
  JAX package's ``tests/test_parallel.py``); the slabs' shapes; a
  checkpoint written from slabs byte-identical to one written from the
  whole state; the entry point training, rescaling and resuming under
  ``fsdp`` as on one process.
- The budgets stay per rank: a rank whose block overflows its share
  reports overflow where world 1's buffer does not.
"""

import os

import numpy as np
import pytest
import torch

from esrnerf_tpu_torch import run as trun
from esrnerf_tpu_torch.data.synthetic import write_scene
from esrnerf_tpu_torch.parallel.mesh import (ParamLayout, ShardHelpers,
                                            fsdp_shards)
from chip_smoke import write_coarse_ckpt
from test_torch_parallel_ranks import (FINE_CFG, MICRO, RankPool,
                                       _assert_grads_close,
                                       _assert_ranks_agree, _leaves,
                                       from_numpy, one_thread, run_steps,
                                       to_numpy)

pytestmark = pytest.mark.quick

# the LTS family with its real draws: random scattering, the configs'
# perturbation eps and smoothness weight, 48 surface points chosen among
# the ranks' head rows
REAL = ["app.model.ray_sampling=random", "app.trainer.normal_eps=0.01",
        "app.trainer.emit_eps=0.001", "app.trainer.weight_normal_smooth=0.001",
        "app.model.num_ltspts=48"]
KINDS = ("fine", "fine_sparse", "alphamask", "coarse", "lts", "pdra",
         "finetune", "finetune_march")
EXTRA = {k: (REAL if k in ("lts", "pdra", "finetune") else []) for k in KINDS}
# aux positions: loss terms, overflow, counter fractions
TERMS = {"fine": [0, 1], "fine_sparse": [0, 1], "alphamask": [0],
         "coarse": [0], "lts": [0, 1, 2, 3], "pdra": [0, 1, 2, 3, 9, 10, 11],
         "finetune": [0], "finetune_march": [0]}
OVERFLOW = {"fine": 2, "fine_sparse": 2, "alphamask": None, "coarse": 1,
            "lts": 4, "pdra": 4, "finetune": 1, "finetune_march": 1}
FRACS = {"fine": [3, 4], "fine_sparse": [3, 4], "alphamask": [],
         "coarse": [2, 3], "lts": [5, 6, 7, 8], "pdra": [5, 6, 7, 8],
         "finetune": [], "finetune_march": []}


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    pool = RankPool(4, tmp_path_factory.mktemp("gspmd_world4"))
    yield pool
    pool.close()


# ------------------------------------------------------------------ tasks


def gspmd_steps(kind, mode="grads", n_steps=1, fsdp=False, extra=(),
                sh=ShardHelpers()):
    """``run_steps`` of ``kind`` under ``gspmd`` (``fsdp`` slabs or not)
    with the kind's real-draw overrides and ``extra``; ``finetune_march``
    is the fine-tune on its own march (no slot cache)."""
    march = kind == "finetune_march"
    kind = "finetune" if march else kind
    return run_steps(kind, mode, n_steps, sh=sh, extra=EXTRA[kind] + list(
        extra), gspmd=True, fsdp=fsdp, ft_cached=not march)


def slab_layout(sh=ShardHelpers()):
    """The fsdp layout of a tree of a dividing grid, a non-dividing grid,
    an MLP and a vector, and of its Adam state: each leaf's shape on the
    rank, the whole tree gathered back, and the paths that shard."""
    from esrnerf_tpu_torch.optim import Adam

    rng = np.random.default_rng(0)
    whole = {"sdf": rng.normal(size=(32, 8, 8, 1)),
             "odd": rng.normal(size=(30, 8, 8, 3)),
             "net": {"w": rng.normal(size=(32, 8, 8)), "b": rng.normal(
                 size=(32,))}}
    whole = from_numpy({k: v for k, v in whole.items()})
    layout = ParamLayout(ShardHelpers(sh.n, sh.rank, gspmd=True), fsdp=True)
    placed = layout.place(whole)
    opt = Adam({"sdf": 0.1, "odd": 0.1, "net": 0.1})
    state = opt.init(placed)
    return {"shapes": {"/".join(p): tuple(x.shape)
                       for p, x in _paths(placed)},
            "mu_shapes": {"/".join(p): tuple(x.shape)
                          for p, x in _paths(state.mu)},
            "paths": sorted("/".join(p) for p in layout.paths),
            "gathered": to_numpy(layout.gather(placed)),
            "whole": to_numpy(whole)}


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in _paths(v, prefix + (k,))]
    return [(prefix, tree)]


def fsdp_entry(args, ckpt_b, sh=ShardHelpers()):
    """``run.main(args)`` on the rank (a fine run under ``gspmd`` +
    ``fsdp``), then its state saved once more from whole tensors with a
    replicated layout (rank 0 writes ``ckpt_b``); returns the rank's log
    dir, step, the shapes it holds, and its parameters and moments
    gathered."""
    from esrnerf_tpu_torch.utils import checkpoint as ckpt_io

    app = trun.main(args)
    held = {"/".join(p): tuple(x.shape) for p, x in _paths(app.params)}
    mu_held = {"/".join(p): tuple(x.shape)
               for p, x in _paths(app.opt_state.mu)}
    paths = sorted("/".join(p) for p in app.layout.paths)
    with app.whole_params(state=True):
        whole = (app.params, app.opt_state)
    app.params, app.opt_state = whole
    app.layout = ParamLayout(app.shard_helpers())
    # the config as it was at the run's last save (the end of the run
    # points app.eval.ckpt at that checkpoint)
    last = os.path.join(app.cfg.log["dir"], "checkpoints", "last.ckpt")
    app.cfg.app["eval"]["ckpt"] = ckpt_io.load_checkpoint(last)[
        "renderer"]["cfg"]["app"]["eval"]["ckpt"]
    # the stage's own payload, written without the (finished) run's log
    app.save_timed = lambda path, payload: (
        ckpt_io.save_checkpoint(path, payload) if app.is_writer else None)
    app.save(ckpt_b)
    return {"log_dir": app.cfg.log["dir"], "step": app.global_step,
            "held": held, "mu_held": mu_held, "paths": paths,
            "voxels": app.renderer.num_voxels,
            "params": to_numpy(whole[0]), "mu": to_numpy(whole[1].mu)}


# ------------------------------------------------------------------ tests


@pytest.mark.parametrize("kind", KINDS)
def test_gspmd_step_world4_matches_world1(world4, kind):
    """One step of each stage (fine with dense and sparse SDF TV,
    alphamask, coarse, LTS, PDRA) and of the fine-tune (on its cached
    slots and on its own march) under ``gspmd`` on 4 ranks, 16 of the 64 rays each, against the step on one process over
    all 64 with the same generator: the LTS family's real draws are world
    1's, its surface points world 1's choice; the gradients (TV terms
    added), the loss terms and the counters are world 1's."""
    res = world4.run(gspmd_steps, kind)
    _assert_ranks_agree(res)
    g1, aux1 = gspmd_steps(kind)
    g4, aux4 = res[0]
    i = OVERFLOW[kind]
    if i is not None:
        assert aux1[i] == 0.0 and aux4[i] == 0.0
    np.testing.assert_allclose([aux4[j] for j in TERMS[kind]],
                               [aux1[j] for j in TERMS[kind]], rtol=1e-5)
    np.testing.assert_allclose([aux4[j] for j in FRACS[kind]],
                               [aux1[j] for j in FRACS[kind]], rtol=1e-6)
    assert all(0.0 < aux1[j] <= 1.0 for j in FRACS[kind])
    _assert_grads_close(g4, g1, 1e-4)


@pytest.mark.parametrize("kind", ["lts", "finetune", "finetune_march"])
def test_gspmd_ranks_without_a_chosen_point(world4, kind):
    """Two surface points over 4 ranks (LTS, the fine-tune on its cached
    slots and on its own march): the ranks none of whose rows is chosen
    run their LTS on one masked slot, which no loss reads and whose
    secondary samples they leave out, so the loss terms, the gradients
    and the counters (the secondary march's fractions too) are still world
    1's."""
    few = ["app.model.num_ltspts=2"]
    res = world4.run(gspmd_steps, kind, "grads", 1, False, few)
    _assert_ranks_agree(res)
    g1, aux1 = gspmd_steps(kind, extra=few)
    g4, aux4 = res[0]
    np.testing.assert_allclose(aux4, aux1, rtol=1e-5)
    _assert_grads_close(g4, g1, 1e-4)


def _assert_adam_params_close(p_t, p_ref, grads_ref):
    """Parameters where Adam resolves the gradients (each step's at least
    0.1 of its leaf's largest) within rtol 2e-4 / atol 1e-6."""
    lr_, lt = _leaves(p_ref), _leaves(p_t)
    assert lr_.keys() == lt.keys()
    for k in lr_:
        sel = np.ones(lr_[k].shape, bool)
        for g in grads_ref:
            gk = _leaves(g)[k]
            sel &= np.abs(gk) >= 0.1 * np.abs(gk).max()
        assert sel.any(), k
        np.testing.assert_allclose(lt[k][sel], lr_[k][sel], rtol=2e-4,
                                   atol=1e-6, err_msg=k)


@pytest.mark.parametrize("kind", ["lts", "pdra"])
def test_gspmd_adam_world4_matches_world1(world4, kind):
    """Two Adam steps (lr 0.01) of the LTS and PDRA steps under ``gspmd``
    with their real draws on 4 ranks against one process: the loss terms
    and the parameters where Adam resolves the gradients."""
    res = world4.run(gspmd_steps, kind, "adam", 2)
    _assert_ranks_agree([r[1:] for r in res])
    aux_4, p_4, _ = res[0]
    aux_1, p_1, g_1 = gspmd_steps(kind, "adam", 2)
    for a4, a1 in zip(aux_4, aux_1):
        np.testing.assert_allclose([a4[j] for j in TERMS[kind]],
                                   [a1[j] for j in TERMS[kind]], rtol=1e-5)
    _assert_adam_params_close(p_4, p_1, g_1)


@pytest.mark.parametrize("kind", ["alphamask", "fine_sparse", "lts"])
def test_fsdp_matches_replicated_world4(world4, kind):
    """Three Adam steps under ``gspmd`` on 4 ranks with the grids and
    their moments as X-slabs (alphamask's per-voxel LR sliced with its
    density; the sparse SDF TV taken on the gathered grid) against the
    same with replicated parameters: rtol 1e-6 / atol 1e-7."""
    rep = world4.run(gspmd_steps, kind, "adam", 3, False)
    sh = world4.run(gspmd_steps, kind, "adam", 3, True)
    _assert_ranks_agree([r[1] for r in sh])
    for a_s, a_r in zip(sh[0][0], rep[0][0]):
        np.testing.assert_allclose(a_s, a_r, rtol=1e-6, atol=1e-7)
    lr_, ls = _leaves(rep[0][1]), _leaves(sh[0][1])
    assert lr_.keys() == ls.keys()
    for k in lr_:
        np.testing.assert_allclose(ls[k], lr_[k], rtol=1e-6, atol=1e-7,
                                   err_msg=k)


def test_fsdp_slabs_follow_the_sharding_rule(world4):
    """A leaf of three or more dims whose X divides the world is kept as
    the rank's X / 4 slab, and so are its Adam moments; a grid of X = 30,
    an MLP vector and everything below three dims stay whole; gathering
    gives the whole tree back bitwise. At world 1 nothing shards."""
    res = world4.run(slab_layout)
    for r, got in enumerate(res):
        assert got["paths"] == ["net/w", "sdf"]
        assert got["shapes"] == {"sdf": (8, 8, 8, 1), "odd": (30, 8, 8, 3),
                                 "net/w": (8, 8, 8), "net/b": (32,)}
        assert got["mu_shapes"] == got["shapes"]
        for k, v in _leaves(got["whole"]).items():
            np.testing.assert_array_equal(_leaves(got["gathered"])[k], v)
    one = slab_layout()
    assert one["paths"] == [] and one["shapes"]["sdf"] == (32, 8, 8, 1)
    assert fsdp_shards(torch.zeros(8, 2, 2), 4)
    assert not fsdp_shards(torch.zeros(8, 2, 2), 1)
    assert not fsdp_shards(torch.zeros(6, 2, 2), 4)
    assert not fsdp_shards(torch.zeros(8, 2), 4)


@pytest.mark.parametrize("dense", [True, False])
def test_fsdp_sdf_tv_of_a_slab_from_its_rows(dense):
    """The SDF TV gradient of a rank's X-slab, taken from the slab's rows
    of the whole grid (one row of neighbours each side), equals the same
    rows of the whole grid's, dense and sparse on the slab's gradient, for
    every rank of 2 and 4 and for the whole grid."""
    from esrnerf_tpu_torch.ops.tv import tv_grad

    rng = np.random.default_rng(7)
    grid = torch.as_tensor(rng.normal(size=(16, 6, 5, 2)).astype(np.float32))
    grad = torch.as_tensor(rng.normal(size=grid.shape).astype(np.float32))
    grad[rng.uniform(size=grid.shape) < 0.5] = 0.0
    whole = tv_grad(grid, 0.3, 0.2, 0.1,
                    sparse_grad=None if dense else grad)
    for n in (1, 2, 4):
        b = 16 // n
        for lo in range(0, 16, b):
            got = tv_grad(grid, 0.3, 0.2, 0.1,
                          sparse_grad=None if dense else grad[lo:lo + b],
                          x_rows=(lo, lo + b))
            torch.testing.assert_close(got, whole[lo:lo + b], rtol=0, atol=0)


def test_gspmd_reports_a_ranks_local_overflow(world4):
    """The march budgets stay per rank at the block's share: at 15 head
    samples a ray the 64-ray fine batch's 948 survivors fit world 1's
    buffer of 960, while the first rank's block of 16 rays keeps 252 for
    its share of 240, and the gspmd step reports that overflow (a global
    fraction above 0)."""
    tight = ["app.model.points_budget_per_ray=15"]
    g1, aux1 = gspmd_steps("fine", extra=tight)
    res = world4.run(gspmd_steps, "fine", "grads", 1, False, tight)
    _assert_ranks_agree(res)
    assert aux1[2] == 0.0
    assert 0.0 < res[0][1][2] < 1.0


@pytest.fixture(scope="module")
def fsdp_setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("fsdp_entry")
    data = write_scene(str(root / "data"), wh=24, n_train=4, n_test=1)
    coarse = write_coarse_ckpt(str(root / "coarse.ckpt"), 16, 24)
    ov = [o for o in MICRO
          if not o.startswith(("log.name", "system.mesh_axes",
                               "app.trainer.num_voxels"))]
    # 4,096 voxels rescaled at step 2 to 8,192 (grids of X 16 -> 20: both
    # divide 4 ranks)
    args = lambda name, n, layout: [
        "-cn", FINE_CFG, "app.phase=train", *ov, "system.mesh_axes=[data]",
        f"data.root={data}", f"log.root={root}/{name}",
        f"app.trainer.ckpt={coarse}", "app.trainer.num_voxels=8192",
        "app.trainer.pg_scale=[2]", "app.trainer.scale_ratio=2",
        f"app.trainer.n_iters={n}", "app.trainer.save_every=3",
        "app.trainer.vis_every=100", "app.trainer.N_vis=1",
        "system.tqdm_iters=1", "system.device=cpu", *layout]
    return root, args


def test_fsdp_entry_point_world4_trains_rescales_checkpoints_resumes(
        world4, fsdp_setup):
    """``run.main`` under ``gspmd`` + ``fsdp`` on 4 ranks: the grids and
    moments held as slabs through a rescale (the rule applied to the new
    shapes), a checkpoint byte-identical to the one written from the whole
    state with a replicated layout, a resume from it, and the parameters
    of the one-process run (the entry-point rule of
    ``tests/test_torch_parallel_ranks.py``)."""
    from esrnerf_tpu_torch.utils import checkpoint as ckpt_io

    root, args = fsdp_setup
    layout = ["system.parallel=gspmd", "system.param_shard=fsdp"]
    one = [trun.main(args("one", n, []) + ["log.name=t"]) for n in (3, 4)]
    ckpt_b = str(root / "replicated.ckpt")
    r3 = world4.run(fsdp_entry, args("four", 3, layout), ckpt_b)
    name = os.path.basename(os.path.dirname(r3[0]["log_dir"]))
    ckpt_a = os.path.join(r3[0]["log_dir"], "checkpoints", "last.ckpt")
    with open(ckpt_a, "rb") as fa, open(ckpt_b, "rb") as fb:
        assert fa.read() == fb.read()
    payload = ckpt_io.load_checkpoint(ckpt_a)
    assert payload["renderer"]["params"]["sdf"].shape[0] == 20
    r4 = world4.run(fsdp_entry, args("four", 4, layout)
                    + [f"log.name={name}"], ckpt_b)
    for res, app, n in zip((r3, r4), one, (3, 4)):
        got = res[0]
        assert got["step"] == app.global_step == n - 1
        assert got["voxels"] == app.renderer.num_voxels
        # the grids and their moments held as X / 4 slabs
        assert {"sdf", "off_color", "emo_color"} <= set(got["paths"])
        for k in ("sdf", "off_color", "emo_color"):
            assert got["held"][k][0] == 5 and got["mu_held"][k][0] == 5
        _assert_ranks_agree([r["params"] for r in res])
        mo, mt = _leaves(to_numpy(app.opt_state.mu)), _leaves(got["mu"])
        po, pt = _leaves(to_numpy(app.params)), _leaves(got["params"])
        for k in mo:
            scale = np.abs(mo[k]).max()
            assert np.abs(mt[k] - mo[k]).max() <= 1e-5 * scale, k
            sel = np.abs(mo[k]) >= 0.1 * scale
            assert sel.any(), k
            np.testing.assert_allclose(pt[k][sel], po[k][sel], rtol=2e-4,
                                       atol=1e-6, err_msg=k)
