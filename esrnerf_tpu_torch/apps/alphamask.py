"""Stage 1 trainer, AlphaMask: low-resolution DVGO occupancy pretraining.

Port of ``esrnerf_tpu/apps/alphamask.py``. The train step
(:func:`build_alphamask_train_step`): ``DVGO.forward_training`` -> MSE plus
the last-transmittance entropy plus the per-point colour loss, each a
global mean over the ranks at world > 1 -> backward -> gradient
all-reduce -> Adam with a per-voxel density LR. The trainer
(:class:`AlphaMask`): the camera-frustum bbox, the near-camera and
view-count density masks, the exponential LR decay, logging, eval and
checkpoints in the JAX package's schema (either package resumes the
other's, and the coarse stage of either starts from them).
"""

from __future__ import annotations

import os
import shutil
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from esrnerf_tpu_torch.apps.base import (AppClass, composite_white_bg,
                                         gathers_params, import_class,
                                         loss_and_grads, srgb_metrics)
from esrnerf_tpu_torch.config import save_cfg
from esrnerf_tpu_torch.data.sampler import BatchSampler
from esrnerf_tpu_torch.models.dvgo import DVGO
from esrnerf_tpu_torch.optim import Adam, exp_decay_factor, make_pervoxel_lr
from esrnerf_tpu_torch.parallel.mesh import (ParamLayout, ShardHelpers,
                                            shard_rows)
from esrnerf_tpu_torch.utils import checkpoint as ckpt_io
from esrnerf_tpu_torch.utils import profiling
from esrnerf_tpu_torch.utils.device import resolve_device
from esrnerf_tpu_torch.utils.metrics import loss2psnr


def entropy_last(alphainv_last: torch.Tensor,
                 mean: Callable = torch.mean) -> torch.Tensor:
    """Mean binary entropy of the last transmittance, clipped to
    ``[1e-6, 1 - 1e-6]``; ``mean`` reduces it (a global mean over the
    ranks: ``ShardHelpers.gmean``)."""
    p = torch.clamp(alphainv_last, 1e-6, 1 - 1e-6)
    return mean(-(p * torch.log(p) + (1 - p) * torch.log(1 - p)))


def alphamask_loss(model: DVGO, params, batch, *, w_ent: float,
                   w_rgbper: float, white_bg: float, generator=None,
                   rand_shift=None, sh: ShardHelpers = ShardHelpers()):
    """``mse + w_ent * entropy(last transmittance) + w_rgbper *
    per-point colour loss`` (the point weights carry no gradient there),
    each a mean over the global batch (``sh``). Returns ``(loss, mse)``."""
    res = model.forward_training(params, batch["rays_o"], batch["rays_d"],
                                 batch["em_modes"], generator=generator,
                                 rand_shift=rand_shift)
    rgbs = batch["rgbs"]
    pred = torch.clamp(res["srgb/rgb"] + res["etc/white_bg"] * white_bg,
                       0.0, 1.0)
    mse = sh.gmean((pred - rgbs) ** 2)
    ent = entropy_last(res["etc/alphainv_cum"][..., -1], mean=sh.gmean)
    rgbper = ((res["srgb/raw_rgb"] - rgbs[:, None, :]) ** 2).sum(-1)
    rgbper_loss = sh.gmean((rgbper * res["etc/weights"].detach()).sum(-1))
    return mse + w_ent * ent + w_rgbper * rgbper_loss, mse


def build_alphamask_train_step(model: DVGO, opt: Adam, cfg, device="cuda",
                               sh: ShardHelpers = ShardHelpers(),
                               layout: Optional[ParamLayout] = None
                               ) -> Callable:
    """The alphamask train step, on one device or (``sh`` of a world of
    ranks) data-parallel over the ranks' blocks of the batch (the MSE
    global, the gradients summed over the ranks before Adam). With a
    ``layout`` of X-slabs (``fsdp``) the parameters, moments and
    ``per_lr`` are the rank's slabs (:func:`~esrnerf_tpu_torch.apps.base.
    loss_and_grads`).

    Returns ``train_step(params, opt_state, batch, lr_scale, per_lr,
    generator=None, rand_shift=None) -> (params, opt_state, mse)``: one
    loss, backward and Adam update (in place) with every group's LR scaled
    by ``lr_scale`` and the per-voxel ``per_lr`` (group -> tensor). The
    rays' sample shifts come from ``generator`` (or ``rand_shift [N,
    1]``). ``mse`` stays on the device. Phases run inside the spans
    ``alphamask/loss``, ``/backward`` and ``/adam``. ``device="cuda"``
    raises without CUDA.
    """
    dev = resolve_device(device)
    if model.device.type != dev.type:
        raise ValueError(f"model lives on {model.device}, step asked for {dev}")
    tr = cfg.app["trainer"]
    kw = dict(w_ent=float(tr["weight_entropy_last"]),
              w_rgbper=float(tr["weight_rgbper"]),
              white_bg=float(cfg.data["white_bg"]))

    def train_step(params, opt_state, batch, lr_scale, per_lr,
                   generator=None, rand_shift=None):
        mse, grads = loss_and_grads(
            lambda p: alphamask_loss(model, p, batch, generator=generator,
                                     rand_shift=rand_shift, sh=sh, **kw),
            params, "alphamask", sh, layout)
        with profiling.span("alphamask/adam"):
            params, opt_state = opt.step(
                params, grads, opt_state,
                lr_scales={g: lr_scale for g in params}, per_lr=per_lr)
        return params, opt_state, mse.detach()

    return train_step


def step_generator(device, seed: int, step: int) -> torch.Generator:
    """The trainer's generator for a run that starts at ``step``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(np.random.SeedSequence([int(seed), int(step)])
                        .generate_state(1)[0]))
    return gen


class AlphaMask(AppClass):
    def __init__(self, cfg):
        super().__init__(cfg)
        tr = cfg.app["trainer"]
        self.train_bs = tr["batch_size"]
        self.n_iters = tr["n_iters"]
        self.lr_decay = tr["lr_decay"]
        self.lrs = dict(tr["lrs"])
        self.world_bound_scale = tr["world_bound_scale"]
        self.vis_every = tr["vis_every"]
        self.N_vis = tr["N_vis"]
        self.save_every = tr["save_every"]
        self.save_all = tr["save_all"]
        self.data_keys = ["rgbs", "rays_o", "rays_d", "em_modes"]
        self.eval_bs = cfg.app["eval"]["batch_size"]

    # ---------------------------------------------------------------- data

    def load_dataset(self) -> None:
        if self.phase not in ("train", "test_nv"):
            raise ValueError("AlphaMask supports train/test_nv only")
        data_cls = import_class("esrnerf_tpu_torch.data." + self.cfg.data["cls"])
        if self.phase == "train":
            self.train_dataset = data_cls(self.cfg, "train")
            self.test_dataset = data_cls(self.cfg, "test_nv")
        else:
            self.test_dataset = data_cls(self.cfg, self.phase)

    # --------------------------------------------------------------- model

    def load_model(self) -> None:
        if self.phase == "train":
            self.load_train_model()
        else:
            self.load_eval_model()

    def _compute_bbox(self, data) -> tuple:
        """The bbox of every training ray's near and far points, scaled by
        ``world_bound_scale`` about its centre."""
        near, far = self.train_dataset.near_far
        ro = data["rays_o"].reshape(-1, 3)
        vd = data["viewdirs"].reshape(-1, 3)
        pts = np.concatenate([ro + vd * near, ro + vd * far], 0)
        xyz_min, xyz_max = pts.min(0), pts.max(0)
        if abs(self.world_bound_scale - 1) > 1e-9:
            shift = (xyz_max - xyz_min) * (self.world_bound_scale - 1) / 2
            xyz_min -= shift
            xyz_max += shift
        return xyz_min, xyz_max

    def _sampler(self, data, **state) -> BatchSampler:
        return BatchSampler(self.cfg, data, self.data_keys, self.train_bs,
                            seed=self.cfg.system["seed"], **state)

    def load_train_model(self) -> None:
        """Fresh (bbox, near-camera mask, view counts) or resumed from this
        run's ``last.ckpt``; there is no previous stage to start from."""
        ckpt, is_resume = self.resolve_train_ckpt()
        data = self.train_dataset.all_data
        near, far = self.train_dataset.near_far
        self.opt = Adam(self.lrs)

        if ckpt is None:
            self.global_step = 0
            t0 = time.perf_counter()
            xyz_min, xyz_max = self._compute_bbox(data)
            self.renderer = DVGO(self.cfg, near, far, xyz_min, xyz_max,
                                 device=self.device)
            params = self.renderer.init_params()
            w, h = self.train_dataset.image_size
            rays_o = data["rays_o"].reshape(-1, w * h, 3)
            rays_d = data["rays_d"].reshape(-1, w * h, 3)
            params = self.renderer.maskout_near_cam_vox(
                params, torch.as_tensor(rays_o[:, 0], device=self.device))
            cnt = self.renderer.voxel_count_views(rays_o, rays_d,
                                                  self.eval_bs)
            params["density"] = torch.where(
                cnt <= 2, torch.full_like(cnt, -100.0), params["density"])
            self.params = params
            self.opt_state = self.opt.init(params)
            self.per_lr = {"density": make_pervoxel_lr(cnt)}
            self.lr_scale = 1.0
            self.sampler = self._sampler(data)
            self.sampler.shuffle()
            self.timings["count_views_s"] = time.perf_counter() - t0
        elif not is_resume:
            raise NotImplementedError("alphamask has no pretrain handoff")
        else:
            payload = ckpt_io.load_checkpoint(ckpt)
            r, t = payload["renderer"], payload["trainer"]
            self.global_step = t["global_step"] + 1
            self.renderer = DVGO(self.cfg, r["near"], r["far"], r["xyz_min"],
                                 r["xyz_max"], device=self.device)
            self.params = ckpt_io.to_device(r["params"], self.device)
            self.opt_state = ckpt_io.to_device(t["optimizer"], self.device)
            self.per_lr = ckpt_io.to_device(t["per_lr"], self.device)
            self.lr_scale = float(t["lr_scale"])
            self.sampler = self._sampler(data, batch_st=t["batch_st"],
                                         data_idxs=t["data_idxs"])
            print(f"resume training from step {self.global_step}")

    def load_eval_model(self) -> None:
        ckpt = self.resolve_eval_ckpt()
        payload = ckpt_io.load_checkpoint(ckpt)
        r = payload["renderer"]
        self.global_step = payload["trainer"]["global_step"]
        self.renderer = DVGO(self.cfg, r["near"], r["far"], r["xyz_min"],
                             r["xyz_max"], device=self.device)
        self.params = ckpt_io.to_device(r["params"], self.device)
        print(f"loaded ckpt {ckpt} @ step {self.global_step}")

    # ---------------------------------------------------------------- train

    def process(self) -> None:
        if self.phase == "train":
            self.learn()
        else:
            self.evaluate()

    def learn(self) -> None:
        decay = exp_decay_factor(self.lr_decay)
        self.check_shardable(self.train_bs)
        self.place_params()
        step_fn = build_alphamask_train_step(self.renderer, self.opt,
                                             self.cfg, device=self.device,
                                             sh=self.shard_helpers(),
                                             layout=self.layout)
        # one stream on every rank: each draws the global batch's sample
        # shifts and keeps its rows, as one device would draw them
        gen = step_generator(self.device, self.cfg.system["seed"],
                             self.global_step)
        ckpt_dir = self.ckpt_dir()
        ckpt_path = os.path.join(ckpt_dir, "last.ckpt")
        logger = self.get_logger()
        logs: Dict[str, List[float]] = {"srgb/MSE": [], "srgb/PSNR": []}
        log_every = int(self.cfg.system["tqdm_iters"])
        t_log, n_since = time.perf_counter(), 0
        host_ms, cap = profiling.HostMs(), profiling.TraceCapture(self.cfg)

        pbar = self.tqdm(range(self.global_step, self.n_iters), colour="green")
        for self.global_step in pbar:
            cap.step(self.global_step)
            batch = self.place_batch(self.sampler.sample())
            shift = torch.rand((self.train_bs, 1), generator=gen,
                               device=self.device)
            self.params, self.opt_state, mse = step_fn(
                self.params, self.opt_state, batch, self.lr_scale,
                self.per_lr, rand_shift=shard_rows(
                    shift, self.world.rank, self.world.n))
            self.lr_scale *= decay
            n_since += 1

            if self.global_step % log_every == 0:
                logs["srgb/MSE"].append(float(mse))
                logs["srgb/PSNR"].append(loss2psnr(float(mse)))
                means = {k: float(np.mean(v)) for k, v in logs.items()}
                logs = {k: [] for k in logs}
                if hasattr(pbar, "set_description"):
                    pbar.set_description(
                        f"Iter {self.global_step:05d} (s) psnr = "
                        f"{means['srgb/PSNR']:.2f} mse = "
                        f"{means['srgb/MSE']:.6f}")
                # DVGO's dense march has no budget: overflow is 0, logged
                # for one metric schema across the stages
                means["etc/overflow"] = 0.0
                now = time.perf_counter()
                means["etc/sec_per_step"] = (now - t_log) / n_since
                means.update(host_ms.read())
                t_log, n_since = now, 0
                logger.log({f"train/metric/{k}": v for k, v in means.items()},
                           step=self.global_step)

            last_it = self.global_step == self.n_iters - 1
            if self.global_step % self.vis_every == self.vis_every - 1 or last_it:
                self.evaluate(self.N_vis)
            if self.global_step % self.save_every == self.save_every - 1 or last_it:
                self.save(ckpt_path)
                if self.save_all and self.is_writer:
                    shutil.copy2(ckpt_path, os.path.join(
                        ckpt_dir, f"{self.pretty_global_step}.ckpt"))

        cap.close()
        self.cfg.app["eval"]["ckpt"] = ckpt_path
        if self.is_writer:
            save_cfg(self.cfg)

    @gathers_params(state=True)
    def save(self, path: str) -> None:
        self.save_timed(path, {
            "renderer": {
                "cfg": self.cfg.to_dict(),
                **self.renderer.export_meta(),
                "params": self.params,
            },
            "trainer": {
                "global_step": self.global_step,
                **self.sampler.state(),
                "optimizer": self.opt_state,
                "per_lr": self.per_lr,
                "lr_scale": self.lr_scale,
            },
        })

    # ----------------------------------------------------------------- eval

    @gathers_params()
    def evaluate(self, N_vis: int = -1) -> None:
        """Renders and sRGB metrics of the test images (all, or about
        ``N_vis`` of them)."""
        t0 = time.perf_counter()
        dirs = self.eval_dirs()
        img_idxes = self.eval_img_idxes(len(self.test_dataset), N_vis)
        width, height = self.test_dataset.image_size
        metrics: Dict[str, List[float]] = {}
        renders: Dict[str, List[np.ndarray]] = {}

        for i in self.tqdm(img_idxes, desc="eval", leave=False):
            data = self.test_dataset[int(i)]
            em = int(np.asarray(data["em_modes"]).reshape(-1)[0])
            imgs = composite_white_bg(self.render_image(
                data, ("rays_o", "rays_d"),
                lambda ro, rd: self.renderer.forward_evaluate(
                    self.params, ro, rd, em)), self.white_bg)
            srgb_metrics(metrics, imgs["srgb/rgb"],
                         data["rgbs"].reshape(height, width, 3))
            for k, v in imgs.items():
                renders.setdefault(k, []).append(
                    (np.clip(v, 0, 1) * 255).astype(np.uint8))

        self.timings["eval_s_per_image"] = \
            (time.perf_counter() - t0) / max(1, len(img_idxes))
        self.save_renders(dirs, renders, metrics)
        self.log_eval(self.test_dataset.phase + "/", {
            **metrics, "etc/eval_s_per_image": [
                self.timings["eval_s_per_image"]]})
