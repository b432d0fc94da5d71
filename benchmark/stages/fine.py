"""The fine stage of the program under test, driven as its trainer drives it.

``Stage`` builds the port's ``VoxurfF`` on the configuration's ball scene and
its ``Fine`` app (for ``place_batch``, ``eval_chunk_retry`` and the chunk
path of ``render_image``), and exposes the loop body of ``Fine.learn`` in the
order it runs: the sampler's ``sample()``, ``place_batch``, the train step
(``build_fine_train_step``) with the trainer's schedule, the learning-rate
decay, and the log's ``float()`` reads every ``system.tqdm_iters`` steps. The
eval path is ``_eval_chunk`` through ``run_chunk`` with the outputs copied to
the host, as ``render_image`` does.

The scene's mask density and the weights come from the benchmark
(:mod:`benchmark.reference.fine`), made from the seed.
"""

from __future__ import annotations

import copy
from typing import Dict, List

import numpy as np
import torch

from benchmark.reference import fine as ref

DATA_KEYS = ["rgbs", "rays_o", "rays_d", "viewdirs", "em_modes"]


def program_cfg(config: dict, device: torch.device):
    """The program's config object from the configuration file's ``cfg``,
    on ``device``."""
    from esrnerf_tpu_torch.config import Config

    def wrap(node):
        if isinstance(node, dict):
            return Config({k: wrap(v) for k, v in node.items()})
        if isinstance(node, list):
            return [wrap(v) for v in node]
        return node

    cfg = wrap(config["cfg"])
    cfg.system["device"] = device.type
    return cfg


class Stage:
    def __init__(self, config: dict, device: torch.device, mark=None):
        from esrnerf_tpu_torch.apps.fine import Fine
        from esrnerf_tpu_torch.models.voxurf_base import make_mask_cache
        from esrnerf_tpu_torch.models.voxurff import VoxurfF

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
        self.model = VoxurfF(cfg, sc["near"], sc["far"], sc["xyz_min"],
                             sc["xyz_max"], mc, self.s_val,
                             int(cfg.app.trainer["num_voxels"]))
        mark("model")
        self.app = Fine(cfg)
        self.app.renderer = self.model
        tr = cfg.app.trainer
        self.batch_size = int(tr["batch_size"])
        self.K2 = self.batch_size * self.model.geo.points_per_ray

    # ------------------------------------------------------------ training

    def start_train(self, weights: dict, pool: Dict[str, np.ndarray],
                    seed: int, first_step: int) -> None:
        from esrnerf_tpu_torch.apps.fine import build_fine_train_step
        from esrnerf_tpu_torch.data.sampler import BatchSampler
        from esrnerf_tpu_torch.optim import Adam, CosineLR

        app, cfg = self.app, self.cfg
        app.params = weights
        app.opt = Adam(app.lrs)
        app.opt_state = app.opt.init(app.params)
        app.global_step = first_step
        sched = CosineLR.from_cfg(cfg, first_step)
        app.lr_scheduler = sched
        app.lr_scales = {}
        for k in app.lrs:
            s = sched.pre_decay_factor
            for at, groups in app.decay_steps.items():
                if at < first_step and k in groups:
                    s *= groups[k]
            app.lr_scales[k] = s
        app.sampler = BatchSampler(cfg, pool, DATA_KEYS, app.train_bs,
                                   seed=seed)
        app.sampler.shuffle()
        app.place_params()
        self.step_fn = build_fine_train_step(
            self.model, app.opt, cfg, device=self.device,
            sh=app.shard_helpers(), layout=app.layout)
        self.log_every = int(cfg.system["tqdm_iters"])

    def sample(self) -> Dict[str, np.ndarray]:
        return self.app.sampler.sample()

    def place(self, batch):
        return self.app.place_batch(batch)

    def step(self, i: int, batch, fault=None):
        """One train step at global step ``i`` with the trainer's
        arguments. A ``fault`` for the comparison's tests: ``half`` feeds
        the first half of the batch alone; ``frozen`` steps copies of the
        parameters and state and keeps the old ones."""
        app = self.app
        if fault == "half":
            batch = {k: v[: v.shape[0] // 2] for k, v in batch.items()}
        params, state = app.params, app.opt_state
        if fault == "frozen":
            params, state = copy.deepcopy((params, state))
        tv_on = (app.tv_from < i < app.tv_end and i % app.tv_every == 0)
        new = self.step_fn(
            params, state, batch, self.s_val,
            dict(app.lr_scales), 1.0 if tv_on else 0.0,
            float(app.tvs["smooth_grad"]),
            float(app.weight_tv_density * app.tvs["sdf"] / app.train_bs),
            i < app.tv_dense_before)
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
            mse, lin_mse, ovf, k1f, k2f = aux
            float(mse), float(lin_mse)
            app.track_overflow(ovf)
            float(k1f), float(k2f)

    def losses(self, aux) -> List[float]:
        return [float(aux[0]), float(aux[1])]

    def counters(self, aux) -> Dict[str, float]:
        """What the reference's ``train_flops`` counts a step by: the
        samples that reached the heads (the march's phase-2 use of its
        budget times the budget)."""
        return {"head_samples": float(aux[4]) * self.K2}

    def bad(self, aux) -> torch.Tensor:
        """A failed step: a loss not finite, or the march dropping
        samples."""
        return (~torch.isfinite(aux[0]) | ~torch.isfinite(aux[1])
                | (aux[2] > 0))

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

    # ----------------------------------------------------------- rendering

    def start_render(self, weights: dict) -> None:
        self.app.params = weights
        self.app.place_params()

    def render_chunk(self, view: dict, st: int, en: int):
        """One eval chunk of ``view``'s rays ``[st, en)``: its outputs on
        the host and its overflow."""
        app = self.app
        pos_rt = torch.as_tensor(view["pose"], device=self.device)
        em = view["em_mode"]
        out = app.run_chunk(
            lambda ro, rd, vd: app._eval_chunk(ro, rd, vd, em, pos_rt,
                                               self.s_val),
            *(view[k][st:en] for k in ("rays_o", "rays_d", "viewdirs")))
        ovf = out.pop("etc/overflow", None)
        v = app.track_overflow(ovf) if ovf is not None else 0.0
        with torch.profiler.record_function("bench/to_host"):
            return {k: t.cpu().numpy() for k, t in out.items()}, v

    @staticmethod
    def march_counters(counts: torch.Tensor) -> Dict[str, float]:
        """What the reference's ``eval_flops`` counts a march by, from its
        counts: the samples at the heads (phase 2's, up to its budget)."""
        return {"head_samples": float(torch.minimum(counts[1], counts[3]))}

    def observe_march(self, counts: list) -> None:
        """Append each march's counts (a device tensor: samples after phase
        1 and 2, their budgets, dropped) to ``counts``; None stops."""
        geo = self.model.geo
        if counts is None:
            geo.__dict__.pop("march", None)
            return
        inner = type(geo).march.__get__(geo)

        def march(*a, **kw):
            m = inner(*a, **kw)
            counts.append(m.counts)
            return m

        geo.march = march
