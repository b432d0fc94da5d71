"""The LTS stage of the program under test, driven as its trainer drives it.

``Stage`` builds the port's ``ESRNeRF`` on the configuration's ball scene
and its ``LTS`` app, and exposes the loop body of ``LTS.learn`` in the
order it runs: the two-pool sampler's ``sample()`` (``RayGroupManager``,
every ray uncertain, as ``LTS._make_sampler`` builds it), ``place_batch``,
the train step (``build_lts_train_step`` through ``LTS._train_step``) with
the trainer's arguments and its keyed draws (``LTS.draw_key``: the run's
seed and the global step), the learning-rate decay, and the log's
``float()`` reads every ``system.tqdm_iters`` steps.

The scene's mask density and the weights come from the benchmark
(:mod:`benchmark.reference.fine`, :mod:`benchmark.reference.lts`), made
from the seed. Each host batch carries the seed as ``draw_seed`` (dropped
before the batch is placed), so that the reference rebuilds the draws.
"""

from __future__ import annotations

import copy
from typing import Dict, List

import numpy as np
import torch

from benchmark.reference import fine as ref
from benchmark.stages.fine import program_cfg

FAULTS = (None, "half", "frozen", "rowdraws")


class Stage:
    def __init__(self, config: dict, device: torch.device, mark=None):
        from esrnerf_tpu_torch.apps.lts import LTS
        from esrnerf_tpu_torch.models.esrnerf import ESRNeRF
        from esrnerf_tpu_torch.models.voxurf_base import make_mask_cache

        if not hasattr(LTS, "draw_key"):
            raise RuntimeError("this program's LTS trainer draws no keyed "
                               "draws, which the reference rebuilds")
        mark = mark or (lambda what: None)
        mark("imports")
        self.config, self.device = config, device
        self.cfg = cfg = program_cfg(config, device)
        sc = config["scene"]
        self.s_val = float(sc["s_val"])
        mc = make_mask_cache(ref.mask_density(sc)[..., None],
                             sc["mask_xyz_min"], sc["mask_xyz_max"],
                             float(sc["mask_alpha_init"]),
                             float(cfg.app.model["maskcache_thres"]),
                             int(cfg.app.model["mask_ks"]), device=device)
        mark("mask cache")
        self.model = ESRNeRF(cfg, sc["near"], sc["far"], sc["xyz_min"],
                             sc["xyz_max"], mc, self.s_val,
                             int(cfg.app.trainer["num_voxels"]))
        mark("model")
        self.app = LTS(cfg)
        self.app.renderer = self.model
        self.batch_size = int(cfg.app.trainer["batch_size"])
        geo, m = self.model.geo, self.model
        self.K2 = self.batch_size * geo.points_per_ray
        self.K2_2nd = (m.n_lts_points * m.num_2ndrays
                       * m.points_per_2ndray)

    # ------------------------------------------------------------ training

    def start_train(self, weights: dict, pool: Dict[str, np.ndarray],
                    seed: int, first_step: int) -> None:
        from esrnerf_tpu_torch.optim import Adam, CosineLR

        if first_step:
            raise ValueError("the LTS adapter starts at step 0, as the "
                             "trainer from the fine checkpoint")
        app, cfg = self.app, self.cfg
        cfg.system["seed"] = int(seed)
        self.seed = int(seed)
        app.params = weights
        app.opt = Adam(app.lrs)
        app.opt_state = app.opt.init(app.params)
        app.global_step = first_step
        app.lr_scheduler = CosineLR.from_cfg(cfg, first_step)
        app.lr_scales = {k: 1.0 for k in app.lrs}
        app.sampler = app._make_sampler(pool, None)
        app.sampler.shuffle()
        app.place_params()
        self.step_fn = app._train_step()
        self.log_every = int(cfg.system["tqdm_iters"])

    def sample(self) -> Dict[str, np.ndarray]:
        hb = self.app.sampler.sample()
        hb["draw_seed"] = np.asarray(self.seed, dtype=np.int64)
        return hb

    def place(self, batch):
        return self.app.place_batch({k: v for k, v in batch.items()
                                     if k != "draw_seed"})

    def step(self, i: int, batch, fault=None):
        """One train step at global step ``i`` with the trainer's
        arguments. A ``fault`` for the comparison's tests: ``half`` feeds
        the first half of the batch alone; ``frozen`` steps copies of the
        parameters and state and keeps the old ones; ``rowdraws`` feeds
        draws by the march's row order from a generator seeded with the
        step, in place of the keyed draws."""
        if fault not in FAULTS:
            raise ValueError(f"unknown fault {fault!r}")
        app = self.app
        if fault == "half":
            batch = {k: v[: v.shape[0] // 2] for k, v in batch.items()}
        params, state = app.params, app.opt_state
        if fault == "frozen":
            params, state = copy.deepcopy((params, state))
        draws = None
        if fault == "rowdraws":
            gen = torch.Generator(device=self.device).manual_seed(
                self.seed + i)
            draws = self.model.training_draws(gen, self.K2)
        app.global_step = i
        tv_on = (app.tv_from < i < app.tv_end and i % app.tv_every == 0)
        new = self.step_fn(
            params, state, batch, self.s_val,
            dict(app.lr_scales), 1.0 if tv_on else 0.0,
            float(app.tvs["smooth_grad"]),
            float(app.weight_tv_density * app.tvs["sdf"] / app.train_bs),
            i < app.tv_dense_before, draws=draws, key=app.draw_key())
        if fault != "frozen":
            app.params, app.opt_state = new[:2]
        return new[2]

    def after_step(self, i: int, aux) -> None:
        """The loop body after the step: the decay of the learning rates
        and, every ``tqdm_iters`` steps, the log's reads."""
        app = self.app
        decay = app.lr_scheduler.decay_factor
        for k in app.lr_scales:
            app.lr_scales[k] *= decay
        if i in app.decay_steps:
            for k, v in app.decay_steps[i].items():
                app.lr_scales[k] *= v
        if i % self.log_every == 0:
            mse, lin_mse, off_l, emo_l, ovf, k1f, k2f, k1f2, k2f2 = aux[:9]
            float(mse), float(lin_mse), float(off_l), float(emo_l)
            app.track_overflow(ovf)
            float(k1f), float(k2f), float(k1f2), float(k2f2)

    def losses(self, aux) -> List[float]:
        """The step's sRGB, linear, off and emo MSE."""
        return [float(a) for a in aux[:4]]

    def counters(self, aux) -> Dict[str, float]:
        """What the reference's ``train_flops`` counts a step by: the head
        rows of both marches (each phase-2 use of its budget times the
        budget) and the surface points."""
        return {"head_rows": float(aux[6]) * self.K2,
                "head_rows_2nd": float(aux[8]) * self.K2_2nd,
                "points": float(self.model.n_lts_points)}

    def bad(self, aux) -> torch.Tensor:
        """A failed step: a loss not finite, or either march dropping
        samples."""
        return ~torch.isfinite(torch.stack(aux[:4])).all() | (aux[4] > 0)

    def grad_norms(self) -> Dict[str, float]:
        """Per leaf, the norm of the gradient that Adam took in its one
        step so far: ``|m| / (1 - beta1)``."""
        b1 = self.app.opt.betas[0]
        return {n: float(torch.linalg.vector_norm(t)) / (1 - b1)
                for n, t in ref.leaves(self.app.opt_state.mu)}

    def change_norms(self, start: dict) -> Dict[str, float]:
        """Per leaf, the norm of the parameters' change from ``start`` (host
        tensors)."""
        now = dict(ref.leaves(self.app.params))
        return {n: float(torch.linalg.vector_norm(
            now[n] - t.to(self.device))) for n, t in ref.leaves(start)}

    def release(self) -> None:
        app = self.app
        for k in ("params", "opt_state", "sampler"):
            setattr(app, k, None)
        self.step_fn = None
