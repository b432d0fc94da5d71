"""The port's ``system.parallel=gspmd`` + ``system.param_shard=fsdp`` steps
on 4 spawned gloo ranks on the CPU against the JAX package's ``gspmd``
layout: its stage step bodies under plain ``jit`` on 4 of the 8 virtual
CPU devices ``conftest.py`` provides, the batch sharded over the data
axis and the parameters and Adam moments placed by
``place_params_fsdp``. Both compute world 1's step: the JAX side by
XLA's partitioning, the port by each rank marching its block of rays and
folding the rest (``esrnerf_tpu_torch.parallel.mesh``).

The ranks import no JAX: they run the tasks of
``tests/test_torch_parallel_ranks.py``. The cases: the DVGO alphamask step
at 32^3 (the set-up of the JAX package's ``tests/test_parallel.py``
fsdp test; the rays' sample shifts are the JAX key's uniform draw), the
fine step, and the LTS step fed the world-1 draws of the JAX step's key
(as ``tests/test_torch_lts_step.py`` does), each through 2 Adam steps at
lr 0.01 in f32, with the tolerances of ``tests/test_torch_parallel.py``:
losses rtol 1e-4, the first step's gradients within 1e-5 of each
group's largest of the port on one process, and the parameters rtol 2e-4
/ atol 1e-6 against JAX and against the port on one process where Adam
resolves the gradients. A checkpoint the port writes under ``fsdp`` loads
into the JAX package with whole grids, equal to the port's own reading.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from esrnerf_tpu.apps.alphamask import AlphaMask as JAlphaMask
from esrnerf_tpu.apps.fine import Fine as JFine
from esrnerf_tpu.apps.lts import LTS as JLTS
from esrnerf_tpu.config import load_cfg as jload
from esrnerf_tpu.models import voxurf_base as jvb
from esrnerf_tpu.models.dvgo import DVGO as JDVGO
from esrnerf_tpu.models.esrnerf import ESRNeRF as JESRNeRF
from esrnerf_tpu.models.voxurff import VoxurfF as JVoxurfF
from esrnerf_tpu.optim import Adam as JAdam
from esrnerf_tpu.parallel import get_mesh, place_params_fsdp, shard_batch
from esrnerf_tpu.utils.checkpoint import load_checkpoint as jload_ckpt
from test_torch_common import REPO, ball_density
from test_torch_lts_step import jax_draws
from test_torch_parallel_gspmd import REAL, fsdp_entry, fsdp_setup
from test_torch_parallel_ranks import (N_RAYS, S_VAL, STEP_CFG, TV_ARGS,
                                       RankPool, _assert_grads_close,
                                       _assert_ranks_agree, _leaves,
                                       one_thread, run_steps, step_batch,
                                       step_cfg, step_model, step_params,
                                       to_numpy)

pytestmark = pytest.mark.quick

N_DEV = 4
EXTRA = {"alphamask": [], "fine": [], "lts": REAL}
GSPMD = ["system.parallel=gspmd", "system.param_shard=fsdp",
         "system.mesh_axes=[data]"]


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    pool = RankPool(4, tmp_path_factory.mktemp("fsdp_world4"))
    yield pool
    pool.close()


def _jax_app(kind):
    """The JAX stage (its step body only), its model and the port's seeded
    parameters as numpy (the two packages' trees are the same)."""
    path, ov = STEP_CFG[kind]
    jcfg = jload(path, list(ov) + EXTRA[kind] + GSPMD, root_dir=REPO)
    box = (0.5, 4.0, [-1, -1, -1], [1, 1, 1])
    if kind == "alphamask":
        jm = JDVGO(jcfg, *box)
    else:
        jmc = jvb.make_mask_cache(ball_density(), [-1, -1, -1], [1, 1, 1],
                                  1e-6, 1e-3, 3)
        jm = (JVoxurfF if kind == "fine" else JESRNeRF)(
            jcfg, *box, jmc, S_VAL, 32**3)
    params = to_numpy(step_params(
        kind, step_model(kind, step_cfg(kind, EXTRA[kind])), seed=7))
    cls = {"alphamask": JAlphaMask, "fine": JFine, "lts": JLTS}[kind]
    app = cls.__new__(cls)
    app.cfg, app.renderer = jcfg, jm
    app.opt = JAdam({k: 0.01 for k in params})
    tr = jcfg.app.trainer
    app.weight_entropy_last = tr.weight_entropy_last
    if kind == "alphamask":
        app.weight_rgbper = tr.weight_rgbper
    else:
        app.weight_linear = tr.weight_linear
    if kind == "lts":
        app.weight_lts = tr.weight_lts
        app.weight_normal_smooth = tr.weight_normal_smooth
        app.normal_eps, app.emit_eps = tr.normal_eps, tr.emit_eps
    app.white_bg = float(jcfg.data["white_bg"])
    app.train_bs = N_RAYS
    app._mesh = get_mesh(devices=jax.devices()[:N_DEV])
    assert app.parallel_mode == "gspmd" and app.num_shards == 1
    return app, params


def _jax_gspmd_steps(kind, n_steps=2):
    """``n_steps`` of the JAX stage's step under ``gspmd`` with
    ``place_params_fsdp``; returns the aux per step, the parameters, and
    the global batch and draws the port is fed."""
    app, params = _jax_app(kind)
    mesh = app._mesh
    key = jax.random.PRNGKey(3)
    b = step_batch(kind)
    draws = None
    if kind == "alphamask":
        b["rand_shift"] = np.asarray(
            jax.random.uniform(key, (N_RAYS, 1), jnp.float32))
    if kind == "lts":
        draws = [np.asarray(d) for d in jax_draws(app.renderer, key, N_RAYS)]
    step = app._build_train_step()
    p = place_params_fsdp(jax.tree.map(jnp.asarray, params), mesh)
    s = place_params_fsdp(app.opt.init(p), mesh)
    grid = "density" if kind == "alphamask" else "sdf"
    assert p[grid].sharding.spec[0] == "data"
    keys = [k for k in b if k != "rand_shift"]
    jb = shard_batch({k: jnp.asarray(b[k]) for k in keys}, mesh)
    if kind == "alphamask":
        extra = (jnp.float32(1.0),
                 {"density": jnp.full(params["density"].shape, 0.5,
                                      jnp.float32)}, key)
    else:
        extra = (jnp.float32(S_VAL), {k: jnp.float32(1.0) for k in params},
                 *(jnp.float32(a) for a in TV_ARGS), jnp.bool_(True))
        if kind == "lts":
            extra += (key,)
    auxes = []
    for _ in range(n_steps):
        p, s, aux = step(p, s, jb, *extra)
        auxes.append([float(a) for a in
                      (aux if isinstance(aux, tuple) else (aux,))])
    return auxes, jax.tree.map(np.asarray, p), params, b, draws


@pytest.mark.parametrize("kind", ["alphamask", "fine", "lts"])
def test_fsdp_step_world4_matches_jax_gspmd(world4, kind):
    """Two Adam steps of the alphamask, fine and LTS steps on 4 port
    ranks under ``gspmd`` + ``fsdp`` against JAX's ``gspmd`` step with
    ``place_params_fsdp`` on 4 devices, from the same parameters, batch
    and draws; the first step's gradients against the port on one
    process."""
    aux_j, p_j, params, b, draws = _jax_gspmd_steps(kind)
    kw = dict(extra=EXTRA[kind], batch_np=b, draws_np=draws)
    res = world4.run(run_steps, kind, "adam", 2, params, 0, gspmd=True,
                     fsdp=True, **kw)
    _assert_ranks_agree([r[1:] for r in res])
    aux_t, p_t, g_t = res[0]
    aux_1, p_1, g_1 = run_steps(kind, "adam", 2, params, **kw)
    n_terms = {"alphamask": 1, "fine": 2, "lts": 4}[kind]
    ovf = {"alphamask": None, "fine": 2, "lts": 4}[kind]
    for a_t, a_j in zip(aux_t, aux_j):
        if ovf is not None:
            assert a_t[ovf] == 0.0 and a_j[ovf] == 0.0
        np.testing.assert_allclose(a_t[:n_terms], a_j[:n_terms], rtol=1e-4)
    _assert_grads_close(g_t[0], g_1[0], 1e-5)
    for p_ref in (p_j, p_1):
        lr_, lt = _leaves(p_ref), _leaves(p_t)
        assert lr_.keys() == lt.keys()
        for k in lr_:
            sel = np.ones(lr_[k].shape, bool)
            for g in g_1:
                gk = _leaves(g)[k]
                sel &= np.abs(gk) >= 0.1 * np.abs(gk).max()
            assert sel.any(), k
            np.testing.assert_allclose(lt[k][sel], lr_[k][sel], rtol=2e-4,
                                       atol=1e-6, err_msg=k)


def test_fsdp_checkpoint_loads_into_jax(world4, fsdp_setup):
    """A fine run under ``gspmd`` + ``fsdp`` on 4 ranks writes whole
    ``[X, Y, Z, C]`` grids and Adam moments in the shared schema: the JAX
    package's loader reads the same arrays as the port's."""
    from esrnerf_tpu_torch.utils import checkpoint as ckpt_io

    root, args = fsdp_setup
    res = world4.run(fsdp_entry, args("jax_load", 2, GSPMD[:2]),
                     str(root / "jax_load_replicated.ckpt"))
    path = os.path.join(res[0]["log_dir"], "checkpoints", "last.ckpt")
    pj, pt = jload_ckpt(path), ckpt_io.load_checkpoint(path)
    for part in ("params",):
        lj = _leaves(pj["renderer"][part])
        lt = _leaves(pt["renderer"][part])
        assert lj.keys() == lt.keys()
        for k in lj:
            np.testing.assert_array_equal(lj[k], lt[k], err_msg=k)
    mj, mt = _leaves(pj["trainer"]["optimizer"].mu), _leaves(
        pt["trainer"]["optimizer"].mu)
    for k in mt:
        np.testing.assert_array_equal(mj[k], mt[k], err_msg=k)
    assert lt["sdf"].shape[:3] == (16, 16, 16)
    assert mt["sdf"].shape == lt["sdf"].shape
    np.testing.assert_array_equal(lt["sdf"], res[0]["params"]["sdf"])
