"""The port's data-parallel fine and LTS steps on 4 spawned gloo ranks on
the CPU (``esrnerf_tpu_torch.parallel.mesh``) against the JAX package's
step bodies under ``shard_map`` on 4 of the 8 virtual CPU devices
``conftest.py`` provides: the same layout shard for shard (contiguous
blocks of the batch, the global last ray on the last shard, each shard
selecting its share of the LTS surface points).

The ranks import no JAX: they run the tasks of
``tests/test_torch_parallel_ranks.py`` (which also holds the data-parallel
path to the port on one device). Everything runs in f32, through 2 Adam
steps at lr 0.01 (the JAX package's own cross-layout test,
``tests/test_parallel.py``), with its tolerances: losses rtol 1e-4,
the first step's gradients within 1e-5 of each group's largest of the
port on one device, and the parameters rtol 2e-4 / atol 1e-6 against JAX
and against the port on one device where Adam resolves the gradients
(each step's at least 0.1 of its leaf's largest: Adam's second step turns
a gradient error d into a move of about lr * d / |g|).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from esrnerf_tpu.apps.fine import Fine as JFine
from esrnerf_tpu.apps.lts import LTS as JLTS
from esrnerf_tpu.config import load_cfg as jload
from esrnerf_tpu.models import voxurf_base as jvb
from esrnerf_tpu.models.esrnerf import ESRNeRF as JESRNeRF
from esrnerf_tpu.models.voxurff import VoxurfF as JVoxurfF
from esrnerf_tpu.optim import Adam as JAdam
from esrnerf_tpu.parallel import get_mesh, replicated, shard_batch
from test_torch_common import REPO, ball_density
from test_torch_parallel_ranks import (N_RAYS, S_VAL, STEP_CFG, TV_ARGS,
                                       RankPool, _assert_grads_close,
                                       _assert_ranks_agree, _leaves,
                                       one_thread, run_steps, step_batch,
                                       step_cfg, step_model, step_params,
                                       to_numpy)

pytestmark = pytest.mark.quick


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    pool = RankPool(4, tmp_path_factory.mktemp("world4"))
    yield pool
    pool.close()


def _jax_setup(kind):
    """The JAX model of the kind and the port's seeded parameters as numpy
    (the two packages' parameter trees are the same)."""
    path, ov = STEP_CFG[kind]
    jcfg = jload(path, list(ov), root_dir=REPO)
    jmc = jvb.make_mask_cache(ball_density(), [-1, -1, -1], [1, 1, 1], 1e-6,
                              1e-3, 3)
    cls = JVoxurfF if kind == "fine" else JESRNeRF
    jm = cls(jcfg, 0.5, 4.0, [-1, -1, -1], [1, 1, 1], jmc, S_VAL, 32**3)
    params = to_numpy(step_params(kind, step_model(kind, step_cfg(kind)),
                                  seed=7))
    return jcfg, jm, params


def _jax_steps(kind, jcfg, jm, params, n_steps=2, n_dev=4):
    """The JAX stage's own step body under ``shard_map`` on 4 devices:
    ``n_steps`` Adam steps, every group at lr 0.01 (as the JAX package's
    cross-layout test)."""
    tr = jcfg.app.trainer
    app = (JFine if kind == "fine" else JLTS).__new__(
        JFine if kind == "fine" else JLTS)  # the step body only
    app.cfg, app.renderer = jcfg, jm
    app.opt = JAdam({k: 0.01 for k in params})
    app.weight_entropy_last, app.weight_linear = (tr.weight_entropy_last,
                                                  tr.weight_linear)
    if kind == "lts":
        app.weight_lts = tr.weight_lts
        app.weight_normal_smooth = tr.weight_normal_smooth
        app.normal_eps, app.emit_eps = tr.normal_eps, tr.emit_eps
    app.white_bg = float(jcfg.data["white_bg"])
    app.train_bs = N_RAYS
    mesh = get_mesh(devices=jax.devices()[:n_dev])
    app._mesh = mesh
    assert app.parallel_mode == "shard_map" and app.num_shards == n_dev
    step = app._build_train_step()
    p = jax.device_put(jax.tree.map(jnp.asarray, params), replicated(mesh))
    s = jax.device_put(app.opt.init(p), replicated(mesh))
    b = shard_batch({k: jnp.asarray(v) for k, v in step_batch(kind).items()},
                    mesh)
    extra = (jnp.float32(S_VAL), {k: jnp.float32(1.0) for k in params},
             *(jnp.float32(a) for a in TV_ARGS), jnp.bool_(True))
    if kind == "lts":
        extra += (jax.random.PRNGKey(3),)
    auxes = []
    for _ in range(n_steps):
        p, s, aux = step(p, s, b, *extra)
        auxes.append([float(a) for a in aux])
    if kind == "lts":
        assert jm.lts_points_divisor == n_dev
    return auxes, jax.tree.map(np.asarray, p)


@pytest.mark.parametrize("kind", ["fine", "lts"])
def test_step_world4_matches_jax_shard_map(world4, kind):
    """Two Adam steps of the fine and the LTS step on 4 port ranks against
    the JAX package's step bodies under ``shard_map`` on 4 devices, from
    the same parameters and batch: shard for shard the same layout
    (contiguous blocks, the global last ray on the last shard, each shard
    selecting ``num_ltspts / 4`` surface points)."""
    jcfg, jm, params = _jax_setup(kind)
    aux_j, p_j = _jax_steps(kind, jcfg, jm, params)
    res = world4.run(run_steps, kind, "adam", 2, params)
    _assert_ranks_agree([r[1:] for r in res])
    aux_t, p_t, g_t = res[0]
    aux_1, p_1, g_1 = run_steps(kind, "adam", 2, params)
    n_terms = 2 if kind == "fine" else 4
    ovf = 2 if kind == "fine" else 4
    for a_t, a_j in zip(aux_t, aux_j):
        assert a_t[ovf] == 0.0 and a_j[ovf] == 0.0
        np.testing.assert_allclose(a_t[:n_terms], a_j[:n_terms], rtol=1e-4)
    # the first step's gradients against the one-device port's (the second
    # step's start from parameters that differ by Adam's rounding)
    _assert_grads_close(g_t[0], g_1[0], 1e-5)
    # the parameters where Adam resolves the gradients: its second step
    # moves an element by about lr * m / sqrt(v), so a gradient error d
    # moves it by about lr * d / |g|; with the gradients held within 1e-5
    # of their max (d) and lr 0.01, that is within the atol 1e-6 where
    # |g| >= 0.1 of the max at both steps
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
