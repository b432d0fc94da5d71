"""The rank side of the port's data-parallel tests, free of JAX: spawned
gloo ranks import this module (by name) and run its tasks.

:class:`RankPool` starts ``n`` ranks with the ``spawn`` method, each
joining one gloo process group through a ``file://`` rendezvous in a
temporary directory (no port, so test workers running side by side cannot
collide) with a collective timeout, and serves tasks: every rank runs the
same module-level function (of this module or another test module, found
by name) with its :class:`ShardHelpers`, and the pool returns the results
by rank. The same functions run in the test process
with the world-1 helpers, for the one-device result.

The tests here (one world of 4 ranks for the module, one of 2 for the
entry point) hold the data-parallel path to the port on one device, all in
f32; ``tests/test_torch_parallel.py`` holds it to the JAX package's
``shard_map`` steps. Tolerances:

- ``ShardHelpers`` against one process: rtol 1e-6 (sums in another
  order), the identity gradients exact;
- the stages' steps at world 4 against world 1: loss terms rtol 1e-5, each
  gradient group within 1e-5 of its largest entry, overflow 0 on both;
- the eval sweeps: rtol 1e-5 / atol 1e-6 (the JAX package's
  ``tests/test_parallel.py``);
- the entry point at world 2 against one process, after 4 steps and after
  a resume: Adam's first moments within 1e-5 of each leaf's largest, the
  parameters where that moment is at least 0.1 of it within rtol 2e-4 /
  atol 1e-6.
"""

import datetime
import importlib
import json
import multiprocessing as mp
import os
import queue
import time
import traceback

import numpy as np
import pytest
import torch
import torch.distributed as dist

from esrnerf_tpu_torch import run as trun
from esrnerf_tpu_torch.data.synthetic import write_scene
from esrnerf_tpu_torch.parallel.mesh import (ShardHelpers, check_parallel_cfg,
                                            pad_to_multiple, shard_rows,
                                            sharded_train_step)
from esrnerf_tpu_torch.utils import profiling
from chip_smoke import write_coarse_ckpt
from test_torch_common import OVERRIDES, REPO, ball_density, rays

pytestmark = pytest.mark.quick

# ------------------------------------------------------------ the rank pool


class RankPool:
    """``n`` spawned gloo ranks serving tasks (module-level functions of
    a test module taking ``sh=``); collectives time out after
    ``timeout_s``, so ranks that disagree fail instead of hanging."""

    def __init__(self, n: int, tmpdir: str, timeout_s: float = 120.0):
        ctx = mp.get_context("spawn")
        init = "file://" + os.path.join(str(tmpdir), "rendezvous")
        self.n = n
        self.inqs = [ctx.Queue() for _ in range(n)]
        self.outq = ctx.Queue()
        self.procs = [ctx.Process(target=_serve, daemon=True,
                                  args=(r, n, init, timeout_s, self.inqs[r],
                                        self.outq))
                      for r in range(n)]
        for p in self.procs:
            p.start()

    def run(self, fn, *args, wait_s: float = 600.0, **kwargs):
        """``fn(*args, **kwargs, sh=<rank's helpers>)`` on every rank; the
        results in rank order. A rank's exception is raised here with its
        traceback."""
        for q in self.inqs:
            q.put((fn.__module__, fn.__name__, args, kwargs))
        got = {}
        deadline = time.monotonic() + wait_s
        while len(got) < self.n:
            try:
                rank, ok, val = self.outq.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(self.procs)
                        if not p.is_alive()]
                if dead or time.monotonic() > deadline:
                    raise RuntimeError(f"ranks {dead} died, or the task "
                                       f"outlasted {wait_s} s")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{val}")
            got[rank] = val
        return [got[r] for r in range(self.n)]

    def close(self):
        for q in self.inqs:
            q.put(None)
        for p in self.procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)


def _serve(rank, n, init, timeout_s, inq, outq):
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=init, rank=rank, world_size=n,
        timeout=datetime.timedelta(seconds=timeout_s))
    sh = ShardHelpers(n, rank)
    try:
        while True:
            task = inq.get()
            if task is None:
                break
            module, name, args, kwargs = task
            try:
                fn = getattr(importlib.import_module(module), name)
                outq.put((rank, True, fn(*args, **kwargs, sh=sh)))
            except BaseException:  # reported to the parent, which raises
                outq.put((rank, False, traceback.format_exc()))
    finally:
        dist.destroy_process_group()


# ------------------------------------------------------------------ helpers


def to_numpy(tree):
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return [to_numpy(v) for v in tree]
    return tree.detach().cpu().numpy() if torch.is_tensor(tree) else tree


def from_numpy(tree):
    if isinstance(tree, dict):
        return {k: from_numpy(v) for k, v in tree.items()}
    return torch.as_tensor(np.array(tree))


def helpers_case(seed=0, sh=ShardHelpers()):
    """Every ``ShardHelpers`` reduction on the rank's rows of one global
    array, and one recipe-B step of a toy least-squares loss."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(8, 3)).astype(np.float32)
    Y = rng.normal(size=(8,)).astype(np.float32)
    x = torch.as_tensor(shard_rows(X, sh.rank, sh.n))
    y = torch.as_tensor(shard_rows(Y, sh.rank, sh.n))
    out = {}

    w = torch.ones(3, requires_grad=True)
    s = sh.gsum((x * w).sum())
    (g,) = torch.autograd.grad(s, w)
    out["gsum"], out["gsum_local_grad"] = float(s.detach()), g.numpy()
    out["gmean"] = float(sh.gmean(x))
    out["gmax"] = float(sh.gmax(x.max()))
    v = x[-1].sum() * w.sum()
    last = sh.glast(v)
    (g,) = torch.autograd.grad(last, w)
    out["glast"], out["glast_local_grad"] = float(last.detach()), g.numpy()

    # recipe B: global loss on every rank, local gradient, one sum
    w = torch.tensor([0.5, -1.0, 2.0], requires_grad=True)
    loss = sh.gmean((x @ w - y) ** 2)
    (g,) = torch.autograd.grad(loss, w)
    out["toy_loss"] = float(loss.detach())
    out["toy_grad"] = sh.all_reduce_grads({"w": g})["w"].numpy()

    # one flat bucket per dtype
    tree = {"a": x.clone(), "b": {"c": x[:, :1].double() * 2}}
    red = sh.all_reduce_grads(tree)
    out["bucket_a"], out["bucket_c"] = red["a"].numpy(), red["b"]["c"].numpy()
    out["gather"] = sh.gather_rows(x).numpy()

    # the generic data-parallel step: mean loss, mean gradient, Adam
    from esrnerf_tpu_torch.optim import Adam

    params = {"w": torch.tensor([0.5, -1.0, 2.0])}
    opt = Adam({"w": 0.1})
    state = opt.init(params)
    step = sharded_train_step(
        lambda p, b: ((b["x"] @ p["w"] - b["y"]) ** 2).mean(), opt, sh)
    params, state, loss = step(params, state, {"x": x, "y": y})
    out["dp_step_loss"], out["dp_step_w"] = float(loss), params["w"].numpy()
    return out


# ------------------------------------------------ the stages' small steps


class GradsOut:
    """Optimizer stand-in whose step returns the (all-reduced, TV-added)
    gradients it is given."""

    def step(self, params, grads, state, lr_scales=None, per_lr=None):
        return grads, state


class Recorded:
    """An optimizer that keeps each step's gradients (as numpy)."""

    def __init__(self, opt):
        self.opt, self.grads = opt, []

    def init(self, params):
        return self.opt.init(params)

    def step(self, params, grads, state, **kw):
        self.grads.append(to_numpy(grads))
        return self.opt.step(params, grads, state, **kw)


N_RAYS = 64
FT_PPR = 8
# the layout-invariant recipe of the LTS and PDRA steps (the JAX package's
# tests/test_parallel.py): Fibonacci scattering, eps 0 (the perturbation
# draws multiplied away), num_ltspts = the whole march budget so every
# rank selects every one of its slots; the smoothness weight 0 (with eps 0
# it is a degenerate a - a = 0 term)
LTS_DP = [
    "app.phase=train", "data.cls=x", "data.root=x", "data.scene=x",
    "app.model.points_budget_masked_per_ray=432",
    "app.model.points_budget_per_ray=24",
    "app.model.points_budget_masked_per_2ndray=64",
    "app.model.points_budget_per_2ndray=8",
    "app.model.phase1_block=8",
    "app.model.rgbnet_width=32", "app.model.rgbnet_depth=2",
    "app.model.tonemap_width=32", "app.model.tonemap_depth=2",
    "app.model.brdfnet_width=32", "app.model.brdfnet_depth=2",
    "app.model.num_2ndrays=2", f"app.model.num_ltspts={N_RAYS * 24}",
    "app.model.ray_sampling=fib", "app.trainer.normal_eps=0.0",
    "app.trainer.emit_eps=0.0", "app.trainer.weight_normal_smooth=0.0",
    f"app.trainer.batch_size={N_RAYS}", "system.compute_dtype=float32",
]
UPSTREAM = ["app.phase=train", "data.cls=x", "data.root=x", "data.scene=x",
            "system.compute_dtype=float32", "app.model.num_voxels=32768"]
# 24 head samples a ray: a shard of 16 rays keeps all its samples (16
# overflow a shard's budget on the ball)
FINE_DP = OVERRIDES + ["app.model.points_budget_per_ray=24"]
STEP_CFG = {
    "fine": ("cfg/app/fine.yaml", FINE_DP),
    "fine_sparse": ("cfg/app/fine.yaml", FINE_DP),
    "alphamask": ("cfg/app/alphamask.yaml", UPSTREAM),
    "coarse": ("cfg/app/coarse.yaml",
               UPSTREAM + ["app.model.rgbnet_width=32"]),
    "lts": ("cfg/app/lts.yaml", LTS_DP),
    "pdra": ("cfg/app/pdra.yaml", LTS_DP),
    "finetune": ("cfg/app/pdra.yaml",
                 LTS_DP + [f"app.model.num_ltspts={N_RAYS * FT_PPR}"]),
}
# step arguments (s_val, TV on, smooth-grad TV, SDF TV weight) of the
# voxurf steps: s_val 40 keeps every sample off the fastcolor threshold
S_VAL = 40.0
TV_ARGS = (1.0, 0.05, 0.01 * 0.1 / N_RAYS)
NO_AXES = [o for o in OVERRIDES if not o.startswith("system.mesh_axes")]


def step_cfg(kind, extra=()):
    from esrnerf_tpu_torch.config import load_cfg

    path, ov = STEP_CFG[kind]
    return load_cfg(path, list(ov) + list(extra), root_dir=REPO)


def _mask_cache():
    from esrnerf_tpu_torch.models.voxurf_base import make_mask_cache

    return make_mask_cache(ball_density(), [-1, -1, -1], [1, 1, 1], 1e-6,
                           1e-3, 3, device="cpu")


def step_model(kind, cfg):
    """The kind's model on the CPU over the ball scene (32^3 grids)."""
    from esrnerf_tpu_torch.models.dvgo import DVGO
    from esrnerf_tpu_torch.models.esrnerf import ESRNeRF
    from esrnerf_tpu_torch.models.voxurfc import VoxurfC
    from esrnerf_tpu_torch.models.voxurff import VoxurfF

    box = (0.5, 4.0, [-1, -1, -1], [1, 1, 1])
    if kind == "alphamask":
        return DVGO(cfg, *box, device="cpu")
    if kind == "coarse":
        return VoxurfC(cfg, *box, _mask_cache(), s_val=20.0)
    if kind.startswith("fine_") or kind == "fine":
        return VoxurfF(cfg, *box, _mask_cache(), S_VAL, 32**3)
    model = ESRNeRF(cfg, *box, _mask_cache(), S_VAL, 32**3)
    model.pdra_mode = kind in ("pdra", "finetune")
    return model


def step_params(kind, model, seed=0):
    """Seeded parameters with a sphere SDF inside the ball and random
    colour (and BRDF) grids, so every group gets a gradient."""
    rng = np.random.default_rng(seed)
    if kind == "alphamask":
        p = model.init_params()
        p["density"] = torch.as_tensor(rng.normal(
            12.0, 3.0, p["density"].shape).astype(np.float32))
        grids = ("off_color", "emo_color")
    else:
        p = model.init_params(torch.Generator().manual_seed(seed))
        grids = ("off_color", "emo_color") + (("brdf",) if "brdf" in p
                                              else ())
        if "sdf" in p and kind != "coarse":
            X, Y, Z = model.geo.world_size
            x, y, z = np.mgrid[-1:1:X * 1j, -1:1:Y * 1j, -1:1:Z * 1j]
            r = np.sqrt(x**2 + y**2 + z**2)
            p["sdf"] = torch.as_tensor((r - 0.5 + rng.normal(
                scale=0.03, size=r.shape)).astype(np.float32)[..., None])
    for g in grids:
        p[g] = torch.as_tensor(rng.normal(
            scale=1.0 if kind == "alphamask" else 0.3,
            size=p[g].shape).astype(np.float32))
    return p


def step_batch(kind, seed=0):
    """The kind's global batch (numpy): ``rays``, with the uncertainty
    masks of LTS (random) and PDRA (the first half uncertain, as the
    two-pool sampler concatenates), the fine-tune's edits, alphamask's
    sample shifts."""
    b = rays(N_RAYS, seed)
    r = np.random.default_rng(seed + 1)
    if kind == "alphamask":
        b["rand_shift"] = r.uniform(size=(N_RAYS, 1)).astype(np.float32)
    if kind == "lts":
        b["uncert_masks"] = r.uniform(size=N_RAYS) > 0.3
    if kind in ("pdra", "finetune"):
        b["uncert_masks"] = np.arange(N_RAYS) < N_RAYS // 2
    if kind == "finetune":
        b["em_modes"] = r.integers(0, 5, N_RAYS)
        b["em_intensities"] = r.uniform(0.2, 2.0, N_RAYS).astype(np.float32)
        b["em_colors"] = r.uniform(0, 1, (N_RAYS, 2)).astype(np.float32)
    return b


def run_steps(kind, mode="grads", n_steps=1, params_np=None, seed=0,
              sh=ShardHelpers(), extra=(), gspmd=False, fsdp=False,
              batch_np=None, draws_np=None, ft_cached=True):
    """``n_steps`` of the kind's train step on the rank's block of the
    global batch. ``mode`` 'grads': one step whose optimizer returns the
    step's gradients -> ``(grads, aux)``; 'adam': Adam steps at the
    learning rate 0.01 -> ``(aux per step, params, gradients per
    step)``. ``params_np``
    (numpy) replaces the seeded parameters; ``extra`` overrides follow the
    kind's. The LTS-family steps draw from the rank's generator (the
    recipe makes the draws irrelevant under ``shard_map``), or take
    ``draws_np`` (world 1's ``LTSDraws`` as numpy) at every step;
    ``batch_np`` replaces the kind's global batch; ``ft_cached`` False
    runs the fine-tune on its own march instead of the cached slots.
    ``gspmd``: the world-size-independent layout (world 1's draws);
    ``fsdp``: the grids and their moments as the rank's X-slabs (the
    returned parameters and gradients gathered whole)."""
    from esrnerf_tpu_torch.apps.alphamask import build_alphamask_train_step
    from esrnerf_tpu_torch.apps.coarse import build_coarse_train_step
    from esrnerf_tpu_torch.apps.fine import build_fine_train_step
    from esrnerf_tpu_torch.apps.lts import build_lts_train_step
    from esrnerf_tpu_torch.apps.pdra import (FT_GROUPS, build_finetune_step,
                                             build_pdra_train_step)
    from esrnerf_tpu_torch.optim import Adam

    from esrnerf_tpu_torch.parallel.mesh import ParamLayout

    cfg = step_cfg(kind, extra)
    model = step_model(kind, cfg)
    if gspmd:
        sh = ShardHelpers(sh.n, sh.rank, gspmd=True)
    layout = ParamLayout(sh, fsdp=fsdp)
    params = (from_numpy(params_np) if params_np is not None
              else step_params(kind, model, seed))
    b = step_batch(kind, seed) if batch_np is None else dict(batch_np)
    draws = None
    if draws_np is not None:
        from esrnerf_tpu_torch.models.esrnerf import LTSDraws

        draws = LTSDraws(*(torch.as_tensor(np.asarray(d)) for d in draws_np))
    # every group at lr 0.01, as the JAX package's cross-layout test
    opt = (GradsOut() if mode == "grads"
           else Recorded(Adam({k: 0.01 for k in params})))
    frozen = None
    if kind == "finetune":
        frozen = {k: v for k, v in params.items() if k not in FT_GROUPS}
        frozen["emit_color"] = params["emo_color"].clone()
        params = {k: params[k] for k in FT_GROUPS}
        pts, ok, _ = model.geo.march_ray_slots(
            frozen["sdf"], *(torch.as_tensor(b[k]) for k in
                             ("rays_o", "rays_d", "viewdirs")),
            S_VAL, model.fastcolor_thres, model.neus_alpha, FT_PPR)
        b["ft_pts"], b["ft_valid"] = pts.numpy(), ok.numpy()
    params = layout.place(params)
    state = opt.init(params) if mode == "adam" else None
    rows = {k: torch.as_tensor(shard_rows(v, sh.rank, sh.n))
            for k, v in b.items()}
    if hasattr(model, "lts_points_divisor"):
        model.lts_points_divisor = 1 if gspmd else sh.n
    gen = sh.fold_generator("cpu", seed, 0)
    lr1 = {k: 1.0 for k in params}
    if kind in ("fine", "fine_sparse"):
        step = build_fine_train_step(model, opt, cfg, device="cpu", sh=sh,
                                     layout=layout)
        call = lambda p, s: step(p, s, rows, S_VAL, lr1, *TV_ARGS,
                                 kind == "fine")
    elif kind == "alphamask":
        step = build_alphamask_train_step(model, opt, cfg, device="cpu",
                                          sh=sh, layout=layout)
        per_lr = {"density": torch.full_like(params["density"], 0.5)}
        call = lambda p, s: step(p, s, rows, 1.0, per_lr,
                                 rand_shift=rows["rand_shift"])
    elif kind == "coarse":
        step = build_coarse_train_step(model, opt, cfg, device="cpu", sh=sh,
                                       layout=layout)
        call = lambda p, s: step(p, s, rows, 20.0, lr1, 1.0, 0.1, 0.05)
    elif kind in ("lts", "pdra"):
        build = build_lts_train_step if kind == "lts" \
            else build_pdra_train_step
        step = build(model, opt, cfg, device="cpu", sh=sh, layout=layout)
        call = lambda p, s: step(p, s, rows, S_VAL, lr1, *TV_ARGS, True,
                                 draws=draws, generator=gen)
    else:
        step = build_finetune_step(model, opt, 0.5, sh, layout)
        call = lambda p, s: step(
            p, s, frozen, rows, S_VAL, generator=gen,
            ft_pts=rows["ft_pts"] if ft_cached else None,
            ft_valid=rows["ft_valid"] if ft_cached else None)
    auxes = []
    for _ in range(n_steps):
        params, state, aux = call(params, state)
        auxes.append([float(a) for a in
                      (aux if isinstance(aux, tuple) else (aux,))])
    if mode == "grads":
        return to_numpy(layout.gather(params)), auxes[0]
    return (auxes, to_numpy(layout.gather(params)),
            [to_numpy(layout.gather(from_numpy(g))) for g in opt.grads])


# --------------------------------------------------------- the eval sweeps


class _TestImages:
    """The test dataset's one field ``render_image`` reads."""

    def __init__(self, w, h):
        self.image_size = (w, h)


def eval_sweeps(seed=0, sh=ShardHelpers()):
    """The LTS stage's eval sweeps on a tiny ESRNeRF, each through the
    app's data-parallel chunk path: ``render_image`` of a 10 x 7 image in
    chunks of 32, 32 and 6 rays (the last ragged on a world of 4) through
    ``forward_evaluate`` with the PBR hand-off to the chunked
    ``lts_eval_chunk`` decomposition; ``lts_eval_chunk`` over 32 and over
    30 surface points; ``eval_emit`` and ``eval_esp`` over 64 and over 62
    rays. Returns every output as numpy."""
    from esrnerf_tpu_torch.apps.lts import LTS

    cfg = step_cfg("lts", ["system.device=cpu", "system.mesh_axes=[data]",
                           "app.eval.render_pbr=true",
                           "app.eval.chunk_size=64"])
    app = LTS(cfg)
    assert app.world.n == sh.n
    model = step_model("lts", cfg)
    app.renderer, app.params = model, step_params("lts", model, seed)
    app.test_dataset, app.eval_bs = _TestImages(10, 7), 32
    p = app.params
    pos_rt = torch.eye(3)
    retries0 = profiling.snapshot()["counters"].get("eval.retries", 0)
    b = rays(70, seed)
    out = {}
    imgs = app.render_image(
        b, ("rays_o", "rays_d", "viewdirs"),
        lambda ro, rd, vd: app._eval_chunk(ro, rd, vd, 1, pos_rt, S_VAL))
    out.update({f"image/{k}": v for k, v in imgs.items()})

    rd = {k: torch.as_tensor(b[k][:64]) for k in ("rays_o", "rays_d",
                                                  "viewdirs")}
    with torch.no_grad():
        pbr = model.forward_evaluate(p, rd["rays_o"], rd["rays_d"],
                                     rd["viewdirs"], 1, pos_rt, S_VAL,
                                     render_pbr=True)["pbr_points"]
    keys = ("pts", "viewdirs", "normal", "basecolor", "roughness",
            "metallic")
    # each chunk through the eval retry on overflow, as the trainers run
    # them (a rank's block overflows its own budgets where the whole
    # chunk's budgets do not)
    for k_pts in (32, 30):
        o = app.run_chunk(
            lambda *a: app.eval_chunk_retry(model.lts_eval_chunk, p, None,
                                            *a, S_VAL),
            *(pbr[k][:k_pts] for k in keys))
        out.update({f"lts_eval_chunk{k_pts}/{k}": v for k, v in o.items()})
    for n in (64, 62):
        arr = [b[k][:n] for k in ("rays_o", "rays_d", "viewdirs")]
        for name, probe in (("emit", model.eval_emit),
                            ("esp", model.eval_esp)):
            fn = lambda *a: dict(zip((name, "etc/overflow"), probe(*a)))
            o = app.run_chunk(
                lambda *a: app.eval_chunk_retry(fn, p, *a, S_VAL), *arr)
            out.update({f"eval_{name}{n}/{k}": v for k, v in o.items()})
    out["retries"] = (profiling.snapshot()["counters"].get("eval.retries", 0)
                      - retries0)
    return to_numpy(out)


# ------------------------------------------------------- the entry point


def entry_point(args, sh=ShardHelpers()):
    """``esrnerf_tpu_torch.run.main(args)`` on the rank, counting the
    checkpoints it writes; returns the rank's log dir, step, checkpoint
    writes and parameters."""
    from esrnerf_tpu_torch import run
    from esrnerf_tpu_torch.utils import checkpoint as ckpt_io

    saves = []
    save = ckpt_io.save_checkpoint

    def counted(path, payload):
        saves.append(path)
        return save(path, payload)

    ckpt_io.save_checkpoint = counted
    try:
        app = run.main(args)
    finally:
        ckpt_io.save_checkpoint = save
    return {"log_dir": app.cfg.log["dir"], "step": app.global_step,
            "saves": saves, "params": to_numpy(app.params),
            "mu": to_numpy(app.opt_state.mu)}


def refusals(sh=ShardHelpers()):
    """On a world of ranks: a batch that does not divide it under each
    layout, what ``gspmd`` and ``fsdp`` select, and the empty
    ``mesh_axes`` refusal; each error message (None where nothing
    raised)."""
    from esrnerf_tpu_torch.apps.fine import Fine
    from esrnerf_tpu_torch.config import load_cfg

    base = NO_AXES + ["system.device=cpu", "system.mesh_axes=[data]"]
    out = {}

    def attempt(name, fn):
        try:
            out[name] = fn()
        except ValueError as e:
            out[name] = str(e)

    apps = {name: Fine(load_cfg("cfg/app/fine.yaml", base + ov,
                                root_dir=REPO))
            for name, ov in (("shard_map", []),
                             ("gspmd", ["system.parallel=gspmd"]),
                             ("fsdp", ["system.parallel=gspmd",
                                       "system.param_shard=fsdp"]),
                             ("fsdp_shard_map",
                              ["system.param_shard=fsdp"]))}
    for name, app in apps.items():
        attempt(f"batch/{name}", lambda: app.check_shardable(62))
        attempt(f"place/{name}", lambda: app.place_batch(rays(62)))
        out[f"select/{name}"] = (
            app.parallel_mode, app.num_shards, app.shard_helpers().gspmd,
            app.layout.fsdp)
    attempt("no_axes", lambda: Fine(load_cfg(
        "cfg/app/fine.yaml", base + ["system.mesh_axes=[]"],
        root_dir=REPO)))
    return out


# --------------------------------------------------- tests without a world


def test_world_one_helpers_are_the_identity():
    """At world 1 every helper hands its input back (no process group, no
    launch); ``gmean`` is ``mean``."""
    assert not dist.is_initialized()
    sh = ShardHelpers()
    x = torch.arange(6.0).reshape(2, 3)
    tree = {"a": x, "b": {"c": x[0]}}
    assert sh.gsum(x) is x and sh.gmax(x) is x and sh.glast(x) is x
    assert sh.all_reduce_grads(tree) is tree and sh.gather_rows(x) is x
    assert torch.equal(sh.gmean(x), x.mean())
    assert shard_rows(x, 0, 1) is x
    g1 = sh.fold_generator("cpu", 3, 5)
    g2 = ShardHelpers(4, 2, backend="gloo").fold_generator("cpu", 3, 5)
    assert g1.initial_seed() != g2.initial_seed()
    # gspmd ranks draw world 1's stream
    g3 = ShardHelpers(4, 2, backend="gloo", gspmd=True).fold_generator(
        "cpu", 3, 5)
    assert g1.initial_seed() == g3.initial_seed()


def test_init_distributed_at_world_one_starts_nothing(monkeypatch):
    """Without ``WORLD_SIZE`` (or at 1) no process group starts and the
    current CUDA device is left as it is."""
    from esrnerf_tpu_torch.config import load_cfg
    from esrnerf_tpu_torch.parallel.mesh import init_distributed

    def refuse(_):
        raise AssertionError("set_device at world 1")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "set_device", refuse)
    cfg = load_cfg("cfg/app/fine.yaml", NO_AXES, root_dir=REPO)
    for env in (None, "1"):
        if env is None:
            monkeypatch.delenv("WORLD_SIZE", raising=False)
        else:
            monkeypatch.setenv("WORLD_SIZE", env)
        world = init_distributed(cfg)
        assert (world.rank, world.n, world.backend) == (0, 1, None)
        assert world.device == torch.device("cuda") and world.is_writer
        assert not dist.is_initialized()


def test_layout_refusals_without_a_world():
    """``system.parallel=gspmd`` and ``system.param_shard=fsdp`` pass on a
    world of ranks; empty ``mesh_axes`` raises there (not at world 1), and
    an unknown layout at any world; rows that do not divide the world
    raise."""
    from esrnerf_tpu_torch.config import load_cfg

    base = list(NO_AXES)
    for ov in (["system.parallel=gspmd"], ["system.param_shard=fsdp"],
               ["system.parallel=gspmd", "system.param_shard=fsdp"]):
        cfg = load_cfg("cfg/app/fine.yaml",
                       base + ["system.mesh_axes=[data]"] + ov,
                       root_dir=REPO)
        check_parallel_cfg(cfg, 1)
        check_parallel_cfg(cfg, 4)
    for ov, msg, n_ok in (
            (["system.mesh_axes=[]"], "mesh_axes empty", 1),
            (["system.mesh_axes=[data]", "system.parallel=pjit"],
             "system.parallel=pjit", None),
            (["system.mesh_axes=[data]", "system.param_shard=zero3"],
             "system.param_shard=zero3", None)):
        cfg = load_cfg("cfg/app/fine.yaml", base + ov, root_dir=REPO)
        if n_ok:
            check_parallel_cfg(cfg, n_ok)
        with pytest.raises(ValueError, match=msg):
            check_parallel_cfg(cfg, 4)
    with pytest.raises(ValueError, match="do not divide"):
        shard_rows(np.zeros((6, 3)), 1, 4)
    np.testing.assert_array_equal(shard_rows(np.arange(8), 3, 4), [6, 7])
    assert pad_to_multiple(62, 4) == 64 and pad_to_multiple(64, 4) == 64


# ------------------------------------------------- tests on a world of 4


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The one-device references run on one torch thread, as the ranks do:
    the suite's workers already fill the cores, and a many-thread step
    there spends most of its time waiting for its own threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    pool = RankPool(4, tmp_path_factory.mktemp("world4"))
    yield pool
    pool.close()


def _leaves(tree, prefix=""):
    if isinstance(tree, (dict, list, tuple)):
        out = {}
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
        for k, v in items:
            out.update(_leaves(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree)}


def _assert_ranks_agree(results):
    """Every rank holds the same (all-reduced or gathered) values."""
    first = _leaves(results[0])
    for r in results[1:]:
        for k, v in _leaves(r).items():
            np.testing.assert_array_equal(v, first[k], err_msg=k)


def test_shard_helpers_world4_match_one_process(world4):
    res = world4.run(helpers_case)
    one = helpers_case()
    X = np.random.default_rng(0).normal(size=(8, 3)).astype(np.float32)
    blocks = X.reshape(4, 2, 3)
    for r, got in enumerate(res):
        # values: global on every rank
        for k in ("gsum", "gmean", "gmax", "glast", "toy_loss",
                  "dp_step_loss"):
            np.testing.assert_allclose(got[k], one[k], rtol=1e-6, err_msg=k)
        for k in ("toy_grad", "dp_step_w", "gather"):
            np.testing.assert_allclose(got[k], one[k], rtol=1e-6, atol=1e-7,
                                       err_msg=k)
        # gradients: the identity, so the rank's own rows only
        np.testing.assert_array_equal(got["gsum_local_grad"],
                                      blocks[r].sum(0))
        want = (np.full(3, blocks[r][-1].sum(), np.float32) if r == 3
                else np.zeros(3, np.float32))
        np.testing.assert_array_equal(got["glast_local_grad"], want)
        np.testing.assert_allclose(got["bucket_a"], blocks.sum(0),
                                   rtol=1e-6)
        np.testing.assert_allclose(
            got["bucket_c"], 2 * blocks[..., :1].astype(np.float64).sum(0),
            rtol=1e-12)
    assert res[0]["bucket_c"].dtype == np.float64
    # the sum of the ranks' local gradients is the one-process gradient
    np.testing.assert_allclose(sum(g["gsum_local_grad"] for g in res),
                               one["gsum_local_grad"], rtol=1e-6)


# aux positions: loss terms, overflow, budget fractions
TERMS = {"fine": [0, 1], "fine_sparse": [0, 1], "alphamask": [0],
         "coarse": [0], "lts": [0, 1, 2, 3], "pdra": [0, 1, 2, 3, 9, 10, 11],
         "finetune": [0]}
OVERFLOW = {"fine": 2, "fine_sparse": 2, "alphamask": None, "coarse": 1,
            "lts": 4, "pdra": 4, "finetune": 1}
FRACS = {"fine": [3, 4], "fine_sparse": [3, 4], "alphamask": [],
         "coarse": [2, 3], "lts": [5, 6, 7, 8], "pdra": [5, 6, 7, 8],
         "finetune": []}


def _assert_grads_close(got, want, tol):
    for grp in want:
        lw, lg = _leaves(want[grp]), _leaves(got[grp])
        assert lw.keys() == lg.keys(), grp
        scale = max(np.abs(v).max() for v in lw.values())
        assert scale > 0, grp
        for k in lw:
            err = np.abs(lg[k] - lw[k]).max() / scale
            assert err <= tol, (grp, k, err)


@pytest.mark.parametrize("kind", list(STEP_CFG))
def test_stage_step_world4_matches_one_device(world4, kind):
    """One train step of each stage (fine with dense and sparse SDF TV,
    alphamask, coarse, LTS, PDRA) and of the relighting fine-tune on 4
    ranks, 16 of the 64 rays each, against the step on one device over
    all 64: the all-reduced gradients (TV terms added) and the global
    loss terms."""
    res = world4.run(run_steps, kind)
    _assert_ranks_agree(res)
    g1, aux1 = run_steps(kind)
    g4, aux4 = res[0]
    i = OVERFLOW[kind]
    if i is not None:
        assert aux1[i] == 0.0 and aux4[i] == 0.0
    np.testing.assert_allclose([aux4[j] for j in TERMS[kind]],
                               [aux1[j] for j in TERMS[kind]], rtol=1e-5)
    # budget fractions: the max over the ranks' own, layout-dependent by
    # design; only bounded
    assert all(0.0 < a[j] <= 1.0 for a in (aux1, aux4) for j in FRACS[kind])
    _assert_grads_close(g4, g1, 1e-5)


def test_eval_sweeps_world4_match_one_device(world4):
    """``render_image`` through ``forward_evaluate`` and the PBR
    decomposition, ``lts_eval_chunk``, ``eval_emit`` and ``eval_esp``, each
    chunk split over 4 ranks where it divides (a ragged one runs whole on
    every rank), against one device."""
    res = world4.run(eval_sweeps)
    one = eval_sweeps()
    # a rank retries the chunks its own block overflowed: their number is
    # the rank's
    print("eval retries: one device", one.pop("retries"), "; ranks",
          [r.pop("retries") for r in res])
    _assert_ranks_agree(res)
    assert res[0].keys() == one.keys()
    assert "image/lin/env_dir" in one and one["image/srgb/rgb"].shape == (
        7, 10, 3)
    for k, v in one.items():
        if k.endswith("etc/overflow"):
            assert v == 0.0 and res[0][k] == 0.0, k
        np.testing.assert_allclose(res[0][k], v, rtol=1e-5, atol=1e-6,
                                   err_msg=k)


def test_refusals_on_a_world(world4):
    """On 4 ranks: a batch of 62 fails ``check_shardable`` under
    ``shard_map`` and passes under ``gspmd``, and its rows fail
    ``place_batch`` under both (as JAX's ``device_put``); ``gspmd``
    selects world 1's point selection (1 shard) and global rows; ``fsdp``
    shards the parameters under ``gspmd`` and is ignored under
    ``shard_map``; empty ``mesh_axes`` raises ``ValueError``."""
    for msgs in world4.run(refusals):
        assert msgs["batch/shard_map"] == msgs["batch/fsdp_shard_map"] == (
            "batch_size=62 not divisible by 4 shards; adjust "
            "app.trainer.batch_size or set system.parallel=gspmd")
        assert msgs["batch/gspmd"] is None and msgs["batch/fsdp"] is None
        for name in ("shard_map", "gspmd", "fsdp", "fsdp_shard_map"):
            assert "do not divide over 4 ranks" in msgs[f"place/{name}"]
        assert msgs["select/shard_map"] == ("shard_map", 4, False, False)
        assert msgs["select/fsdp_shard_map"] == ("shard_map", 4, False,
                                                 False)
        assert msgs["select/gspmd"] == ("gspmd", 1, True, False)
        assert msgs["select/fsdp"] == ("gspmd", 1, True, True)
        assert "mesh_axes empty" in msgs["no_axes"]


# ------------------------------------------- the entry point at world 2

# the fine stage at micro size on the synthetic scene
FINE_CFG = os.path.join(REPO, "cfg/exp/esrnerf/giftbox_w/fine.yaml")
MICRO = [
    "data.cls=esrnerf.ESRNeRF", "data.scene=synth_ball", "log.offline=true",
    "system.compute_dtype=float32", "system.debug=true",
    "app.trainer.num_voxels=4096", "app.trainer.batch_size=64",
    "app.trainer.s_start=40", "app.model.rgbnet_width=32",
    "app.model.rgbnet_depth=2", "app.model.tonemap_width=32",
    "app.model.tonemap_depth=2", "app.model.points_budget_masked_per_ray=432",
    "app.model.points_budget_per_ray=16", "app.eval.batch_size=288",
]


@pytest.fixture(scope="module")
def entry_setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("dp_entry")
    data = write_scene(str(root / "data"), wh=24, n_train=4, n_test=1)
    coarse = write_coarse_ckpt(str(root / "coarse.ckpt"), 16, 24)
    ov = [o for o in MICRO
          if not o.startswith(("log.name", "system.mesh_axes"))]
    args = lambda name, n: [
        "-cn", FINE_CFG, "app.phase=train", *ov, "system.mesh_axes=[data]",
        f"data.root={data}", f"log.root={root}/{name}",
        f"app.trainer.ckpt={coarse}", "app.trainer.pg_scale=[]",
        f"app.trainer.n_iters={n}", "app.trainer.save_every=2",
        "app.trainer.vis_every=4", "app.trainer.N_vis=1",
        "system.tqdm_iters=1", "system.device=cpu"]
    return root, args


def test_entry_point_world2_trains_checkpoints_and_resumes(entry_setup):
    """``run.main`` on 2 ranks: one log dir (rank 0's config, its
    clock-stamped ``log.name``), rank 0 alone writing the checkpoints and
    ``metrics.jsonl``, a resume from that checkpoint on both ranks, and the
    parameters of the one-process run."""
    root, args = entry_setup
    one = [trun.main(args("one", n) + ["log.name=t"]) for n in (4, 5)]
    pool = RankPool(2, root)
    try:
        runs = [pool.run(entry_point, args("two", 4))]
        name = os.path.basename(os.path.dirname(runs[0][0]["log_dir"]))
        runs.append(pool.run(entry_point,
                             args("two", 5) + [f"log.name={name}"]))
    finally:
        pool.close()
    for (r0, r1), app, n in zip(runs, one, (4, 5)):
        assert r0["log_dir"] == r1["log_dir"]
        assert r0["step"] == r1["step"] == app.global_step == n - 1
        assert len(r0["saves"]) == 2 - (n == 5) and r1["saves"] == []
        _assert_ranks_agree([r0["params"], r1["params"]])
        # Adam's first moments within 1e-5 of each leaf's largest (the
        # steps' gradient tolerance); the parameters where that moment is
        # at least 0.1 of it (Adam turns a gradient error d into a move of
        # about lr * d / |g|: tests/test_torch_parallel.py)
        mo, mt = _leaves(to_numpy(app.opt_state.mu)), _leaves(r0["mu"])
        po, pt = _leaves(to_numpy(app.params)), _leaves(r0["params"])
        for k in mo:
            scale = np.abs(mo[k]).max()
            assert np.abs(mt[k] - mo[k]).max() <= 1e-5 * scale, k
            sel = np.abs(mo[k]) >= 0.1 * scale
            assert sel.any(), k
            np.testing.assert_allclose(pt[k][sel], po[k][sel], rtol=2e-4,
                                       atol=1e-6, err_msg=k)
    ld = runs[0][0]["log_dir"]
    assert runs[1][0]["log_dir"] == ld
    rows = [json.loads(ln) for ln in open(os.path.join(ld, "metrics.jsonl"))]
    steps = [r["step"] for r in rows if "train/metric/srgb/MSE" in r]
    assert steps == list(range(5))
    assert all(r["train/metric/etc/overflow"] == 0.0 for r in rows
               if "train/metric/etc/overflow" in r)
    assert os.path.exists(os.path.join(ld, "checkpoints", "last.ckpt"))
    assert os.path.exists(os.path.join(ld, "mesh", f"{3:010}", "mesh.ply"))
