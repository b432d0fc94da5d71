"""Stage 3 trainer, Fine: VoxurfF HDR radiance + learnable tone-mapper.

Port of ``esrnerf_tpu/apps/fine.py``. The train step
(:func:`build_fine_train_step`): ``VoxurfF.forward_training`` -> loss ->
backward -> gradient all-reduce over the ranks (at world > 1) -> SDF TV
gradient -> per-group Adam, with the JAX step body's cross-device
mean/sum/max (:class:`~esrnerf_tpu_torch.parallel.mesh.ShardHelpers`). The
trainer
(:class:`Fine`): warm start from the coarse stage's SDF (rescale, resize,
smooth), the training-ray filter, progressive grid scaling at the
``pg_scale`` steps with a fresh optimizer state, CosineLR with the
``decay_steps``, the budget autotune, logging, eval with linear and gamma
variants, HDR-EXR MSE, SSIM, LPIPS and a mesh, and checkpoints that the
JAX package reads (and that it writes) with resume.
"""

from __future__ import annotations

import os
import shutil
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from esrnerf_tpu_torch.apps.base import (AppClass, gathers_params,
                                         import_class, loss_and_grads)
from esrnerf_tpu_torch.config import save_cfg
from esrnerf_tpu_torch.data.base import LightDict
from esrnerf_tpu_torch.data.sampler import BatchSampler
from esrnerf_tpu_torch.models.voxurf_base import fold_counters, make_mask_cache
from esrnerf_tpu_torch.models.voxurff import VoxurfF
from esrnerf_tpu_torch.ops.image import apply_gamma_curve
from esrnerf_tpu_torch.optim import Adam, CosineLR
from esrnerf_tpu_torch.parallel.mesh import ParamLayout, ShardHelpers
from esrnerf_tpu_torch.utils import checkpoint as ckpt_io
from esrnerf_tpu_torch.utils import mesh as meshutil
from esrnerf_tpu_torch.utils import profiling
from esrnerf_tpu_torch.utils.device import resolve_device
from esrnerf_tpu_torch.utils.metrics import (DTU_CD, loss2psnr, rgb_lpips,
                                             rgb_ssim)


def fine_loss(model, params, batch, s_val, tv_flag, smooth_grad_tv, *,
              w_ent: float, w_lin: float, white_bg: float,
              sh: ShardHelpers = ShardHelpers()):
    """The fine loss: ``mse + w_lin * lin_mse`` plus the last-ray entropy
    term plus ``tv_flag * density_total_variation``, each folded over the
    ranks by ``sh`` (the means global, the entropy the global last ray's,
    the TV divided by the world so the summed gradient holds it once).
    Returns ``(loss, (mse, lin_mse, counts, (overflow, k1_frac,
    k2_frac)))`` with the rank's march counts and its own fractions of
    them."""
    res = model.forward_training(
        params, batch["rays_o"], batch["rays_d"], batch["viewdirs"],
        batch["em_modes"], s_val,
    )
    wbg = res["etc/white_bg"] * white_bg
    srgb = torch.clamp(res["srgb/rgb"] + wbg, 0.0, 1.0)
    lin = torch.clamp(res["lin/rgb"] + wbg, min=0.0)
    rgbs = batch["rgbs"]
    mse = sh.gmean((srgb - rgbs) ** 2)

    lin_tone = torch.where(rgbs >= 1, torch.clamp(lin, max=1.0), lin)
    lin_mse = sh.gmean((apply_gamma_curve(lin_tone) - rgbs) ** 2)
    loss = mse + w_lin * lin_mse

    # the reference's entropy term reads only the batch's last ray
    pout = torch.clamp(res["etc/alphainv_cum"][..., -1], 1e-6, 1 - 1e-6)
    ent = sh.glast(
        -(pout * torch.log(pout) + (1 - pout) * torch.log(1 - pout)).mean())
    loss = loss + w_ent * ent

    if tv_flag:
        tv = model.density_total_variation(params, smooth_grad_tv)
        loss = loss + tv_flag * (tv / sh.n if sh.n > 1 else tv)
    return loss, (mse, lin_mse, res["etc/counts"], (
        res["etc/overflow"], res["etc/k1_frac"], res["etc/k2_frac"]))


def add_sdf_tv_grad(model, sdf, grads, tv_flag, sdf_tv_w, tv_dense,
                    layout: Optional[ParamLayout] = None) -> None:
    """The SDF TV of ``sdf``, the whole grid the loss read, as a gradient
    term added in place to the global (reduced) ``grads["sdf"]``: dense,
    or sparse on that gradient's nonzero pattern (so it sees the
    one-device pattern). With an X-slab ``sdf`` (``fsdp``) the term is the
    rank's slab's."""
    if not tv_flag:
        return
    rows = (layout.rows(sdf) if layout is not None and layout.sharded("sdf")
            else None)
    tv_g = model.sdf_tv_grad(sdf, sdf_tv_w,
                             sparse_grad=None if tv_dense else grads["sdf"],
                             x_rows=rows)
    grads["sdf"] = grads["sdf"] + tv_flag * tv_g


def build_fine_train_step(model, opt, cfg, device="cuda",
                          sh: ShardHelpers = ShardHelpers(),
                          layout: Optional[ParamLayout] = None) -> Callable:
    """The fine train step, on one device or (``sh`` of a world of ranks)
    data-parallel over the ranks' blocks of the batch.

    Returns ``train_step(params, opt_state, batch, s_val, lr_scales,
    tv_flag, smooth_grad_tv, sdf_tv_w, tv_dense) -> (params, opt_state,
    (mse, lin_mse, overflow, k1_frac, k2_frac))`` with the reference's
    argument order. ``batch`` holds ``rays_o, rays_d, viewdirs, em_modes,
    rgbs`` tensors on the model's device; the scalars are Python numbers
    (``tv_dense`` a bool). Parameters and optimizer state are updated in
    place. The aux values stay on the device (no host sync); on a world of
    ranks the losses are global and the counters folded by
    :func:`~esrnerf_tpu_torch.models.voxurf_base.fold_counters`. The
    gradients are summed over the ranks before the SDF TV term
    (:func:`add_sdf_tv_grad`). With an ``fsdp`` ``layout`` the grids and
    their moments are the rank's X-slabs. The phases run inside spans
    (:func:`~esrnerf_tpu_torch.utils.profiling.span`: ``fine/loss``,
    ``fine/backward``, ``fine/grad_allreduce``, ``fine/sdf_tv_grad``,
    ``fine/adam``; the forward's own ``fine/march``, ``fine/features``,
    ``fine/heads`` and the march's ``march/*``) so a profile attributes
    device time to them; a profiled backward is split into
    ``fine/bwd_{loss,heads,features,march}``.

    ``device`` must be the model's device; ``"cuda"`` (the default) raises
    without CUDA. TF32 is switched off for matmuls and cuDNN here, so the
    head matmuls run in full f32.
    """
    dev = resolve_device(device)
    if model.device.type != dev.type:
        raise ValueError(f"model lives on {model.device}, step asked for {dev}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    tr = cfg.app["trainer"]
    w_ent = float(tr["weight_entropy_last"])
    w_lin = float(tr["weight_linear"])
    white_bg = float(cfg.data["white_bg"])

    def train_step(params, opt_state, batch, s_val, lr_scales, tv_flag,
                   smooth_grad_tv, sdf_tv_w, tv_dense):
        whole = {}

        def loss_fn(p):
            whole["sdf"] = p["sdf"].detach()  # gathered under fsdp
            return fine_loss(model, p, batch, s_val, tv_flag, smooth_grad_tv,
                             w_ent=w_ent, w_lin=w_lin, white_bg=white_bg,
                             sh=sh)

        aux, grads = loss_and_grads(loss_fn, params, "fine", sh, layout)
        with torch.no_grad(), profiling.span("fine/sdf_tv_grad"):
            add_sdf_tv_grad(model, whole.pop("sdf"), grads, tv_flag,
                            sdf_tv_w, tv_dense, layout)
        with profiling.span("fine/adam"):
            params, opt_state = opt.step(params, grads, opt_state,
                                         lr_scales=lr_scales)
        mse, lin_mse, counts, fractions = aux
        return params, opt_state, (mse.detach(), lin_mse.detach(),
                                   *fold_counters((counts,), fractions, sh))

    return train_step


def composite_hdr(imgs: Dict[str, np.ndarray],
                  white_bg: float) -> Dict[str, np.ndarray]:
    """The white-background composite of an HDR render: ``lin/*`` images
    plus the background, clipped at 0 and, clipped to [0, 1] and gamma
    curved, as ``<key>_gamma``; the rest clipped to [0, 1] (``etc/white_bg``
    itself only clipped)."""
    wbg = imgs["etc/white_bg"] * white_bg
    final = {}
    for k, v in imgs.items():
        if k == "etc/white_bg":
            final[k] = np.clip(v, 0.0, 1.0)
            continue
        add = wbg[..., None] if v.ndim == 3 else wbg
        if k.startswith("lin/"):
            final[f"{k}_gamma"] = apply_gamma_curve(torch.from_numpy(
                np.clip(v + add, 0.0, 1.0))).numpy()
            final[k] = np.clip(v + add, 0.0, None)
        else:
            final[k] = np.clip(v + add, 0.0, 1.0)
    return final


class Fine(AppClass):
    STAGE_CLS = "fine.Fine"
    PREV_CLS = "coarse.Coarse"
    MODEL_CLS = VoxurfF

    def __init__(self, cfg):
        super().__init__(cfg)
        tr = cfg.app["trainer"]
        self.sdf_reduce = tr["sdf_reduce"]
        self.num_voxels = tr["num_voxels"]
        self.pg_scale = list(tr["pg_scale"])
        self.scale_ratio = tr["scale_ratio"]
        self.s_start = tr["s_start"]
        self.s_inv_ratio = tr["s_inv_ratio"]
        self.step_start = tr["step_start"]
        self.step_end = tr["step_end"]
        self.train_bs = tr["batch_size"]
        self.n_iters = tr["n_iters"]
        self.lrs = dict(tr["lrs"])
        self.decay_steps = {int(k): dict(v)
                            for k, v in tr["decay_steps"].items()}
        self.weight_tv_density = tr["weight_tv_density"]
        self.tvs = dict(tr["tvs"])
        self.tv_from = tr["tv_from"]
        self.tv_end = tr["tv_end"]
        self.tv_every = tr["tv_every"]
        self.tv_dense_before = tr["tv_dense_before"]
        self.vis_every = tr["vis_every"]
        self.N_vis = tr["N_vis"]
        self.save_every = tr["save_every"]
        self.save_all = tr["save_all"]
        if self.step_end < 0:
            self.step_end = self.n_iters * 10
        self.data_keys = ["rgbs", "rays_o", "rays_d", "viewdirs", "em_modes"]
        self.eval_bs = cfg.app["eval"]["batch_size"]

    def s_val_at(self, step: int) -> float:
        return (
            min(step, self.step_end) - self.step_start
        ) / self.s_inv_ratio + self.s_start

    # ----------------------------------------------------------------- data

    def load_dataset(self) -> None:
        data_cls = import_class("esrnerf_tpu_torch.data." + self.cfg.data["cls"])
        if self.phase == "train":
            self.train_dataset = data_cls(self.cfg, "train")
            self.test_dataset = data_cls(self.cfg, "test_nv")
        else:
            self.test_dataset = data_cls(self.cfg, self.phase)

    # ---------------------------------------------------------------- model

    def _build_renderer(self, r: dict, s_val, num_voxels):
        meta = {
            "mask_xyz_min": np.asarray(r["mask_xyz_min"]),
            "mask_xyz_max": np.asarray(r["mask_xyz_max"]),
            "mask_alpha_init": r["mask_alpha_init"],
            "mask_density": np.asarray(r["mask_density"]),
        }
        mask_cache = make_mask_cache(
            meta["mask_density"], meta["mask_xyz_min"], meta["mask_xyz_max"],
            meta["mask_alpha_init"], self.cfg.app.model["maskcache_thres"],
            self.cfg.app.model["mask_ks"], device=self.device,
        )
        return self.MODEL_CLS(
            self.cfg, r["near"], r["far"], np.asarray(r["xyz_min"]),
            np.asarray(r["xyz_max"]), mask_cache, s_val, num_voxels, meta,
        )

    def _init_params(self, prev: dict) -> dict:
        """Fresh heads from ``system.seed`` and the coarse-SDF warm start."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(self.cfg.system["seed"]))
        params = self.renderer.init_params(gen)
        coarse_sdf = np.asarray(prev["renderer"]["params"]["sdf"])
        params["sdf"] = self.renderer.load_coarse_sdf(coarse_sdf,
                                                      self.sdf_reduce)
        return params

    def load_model(self) -> None:
        if self.phase == "train":
            self.load_train_model()
        else:
            self.load_eval_model()

    def _initial_num_voxels(self) -> int:
        if len(self.pg_scale):
            return int(self.num_voxels
                       / (self.scale_ratio ** len(self.pg_scale)))
        return self.num_voxels

    def load_train_model(self) -> None:
        """Fresh from the previous stage's checkpoint (``app.trainer.ckpt``
        or the coarse stage's ``last.ckpt``), or resumed from this run's
        ``last.ckpt``."""
        ckpt, is_resume = self.resolve_train_ckpt()
        if ckpt is None:
            ckpt = self.prev_stage_ckpt()
        data = self.train_dataset.all_data
        payload = ckpt_io.load_checkpoint(ckpt)
        r = payload["renderer"]
        self.opt = Adam(self.lrs)

        if not is_resume:
            self.global_step = 0
            self.renderer = self._build_renderer(r, r["s_val"],
                                                 self._initial_num_voxels())
            self.params = self._init_params(payload)
            self.opt_state = self.opt.init(self.params)
            self.lr_scales = {k: 1.0 for k in self.lrs}
            self.lr_scheduler = CosineLR.from_cfg(self.cfg, 0)
            keep = self.renderer.geo.filter_rays_in_maskcache(
                data["rays_o"], data["rays_d"], self.eval_bs, style="voxurf")
            self.sampler = BatchSampler(
                self.cfg, data, self.data_keys, self.train_bs,
                seed=self.cfg.system["seed"])
            self.sampler.filter(keep)
            self.sampler.shuffle()
        else:
            t = payload["trainer"]
            self.global_step = t["global_step"] + 1
            self.renderer = self._build_renderer(r, r["s_val"],
                                                 r["num_voxels"])
            self.params = ckpt_io.to_device(r["params"], self.device)
            self.opt_state = ckpt_io.to_device(t["optimizer"], self.device)
            self.lr_scales = dict(t["lr_scales"])
            self.lr_scheduler = CosineLR.from_cfg(self.cfg, self.global_step)
            self.sampler = BatchSampler(
                self.cfg, data, self.data_keys, self.train_bs,
                batch_st=t["batch_st"], data_idxs=t["data_idxs"],
                seed=self.cfg.system["seed"])
            print(f"resume training from step {self.global_step}")

    def load_eval_model(self) -> None:
        ckpt = self.resolve_eval_ckpt()
        payload = ckpt_io.load_checkpoint(ckpt)
        r = payload["renderer"]
        self.global_step = payload["trainer"]["global_step"]
        self.renderer = self._build_renderer(r, r["s_val"], r["num_voxels"])
        self.params = ckpt_io.to_device(r["params"], self.device)
        print(f"loaded ckpt {ckpt} @ step {self.global_step}")

    # ---------------------------------------------------------------- train

    def process(self) -> None:
        if self.phase == "train":
            self.learn()
        else:
            self.evaluate()

    def learn(self) -> None:
        self.check_shardable(self.train_bs)
        self.place_params()
        step_fn = build_fine_train_step(self.renderer, self.opt, self.cfg,
                                        device=self.device,
                                        sh=self.shard_helpers(),
                                        layout=self.layout)
        ckpt_dir = self.ckpt_dir()
        ckpt_path = os.path.join(ckpt_dir, "last.ckpt")
        logger = self.get_logger()
        logs: Dict[str, List[float]] = {
            "srgb/MSE": [], "srgb/PSNR": [], "lin/MSE": [], "lin/PSNR": [],
        }
        log_every = int(self.cfg.system["tqdm_iters"])
        t_log, n_since = time.perf_counter(), 0
        host_ms, cap = profiling.HostMs(), profiling.TraceCapture(self.cfg)

        tune_step = self.global_step
        pbar = self.tqdm(range(self.global_step, self.n_iters), colour="green")
        for self.global_step in pbar:
            cap.step(self.global_step)
            if self.global_step in self.pg_scale:
                # whole grids rescaled, then the sharding rule applied to
                # the new shapes (fsdp), and a fresh optimizer state
                self.params = self.layout.place(
                    self.renderer.scale_volume_grid(
                        self.layout.gather(self.params),
                        self.renderer.num_voxels * self.scale_ratio))
                self.opt_state = self.opt.init(self.params)

            batch = self.place_batch(self.sampler.sample())
            s_val = self.s_val_at(self.global_step)
            self.renderer.s_val = s_val
            tv_on = (self.tv_from < self.global_step < self.tv_end
                     and self.global_step % self.tv_every == 0)
            self.params, self.opt_state, (mse, lin_mse, ovf, k1f, k2f) = \
                step_fn(self.params, self.opt_state, batch, s_val,
                        dict(self.lr_scales), 1.0 if tv_on else 0.0,
                        float(self.tvs["smooth_grad"]),
                        float(self.weight_tv_density * self.tvs["sdf"]
                              / self.train_bs),
                        self.global_step < self.tv_dense_before)
            n_since += 1

            if self.global_step == tune_step:
                self.maybe_autotune_budgets({"k1": float(k1f),
                                             "k2": float(k2f)})

            decay = self.lr_scheduler.decay_factor
            for k in self.lr_scales:
                self.lr_scales[k] *= decay
            if self.global_step in self.decay_steps:
                for k, v in self.decay_steps[self.global_step].items():
                    self.lr_scales[k] *= v

            if self.global_step % log_every == 0:
                logs["srgb/MSE"].append(float(mse))
                logs["srgb/PSNR"].append(loss2psnr(float(mse)))
                logs["lin/MSE"].append(float(lin_mse))
                logs["lin/PSNR"].append(loss2psnr(float(lin_mse)))
                means = {k: float(np.mean(v)) for k, v in logs.items()}
                logs = {k: [] for k in logs}
                if hasattr(pbar, "set_description"):
                    pbar.set_description(
                        f"Iter {self.global_step:05d} (s) psnr = "
                        f"{means['srgb/PSNR']:.2f} (l) psnr = "
                        f"{means['lin/PSNR']:.2f}")
                means["etc/overflow"] = self.track_overflow(ovf)
                means["etc/k1_frac"] = float(k1f)
                means["etc/k2_frac"] = float(k2f)
                # wall-clock per step since the last log (the float()
                # reads above end each interval with a synchronise)
                now = time.perf_counter()
                means["etc/sec_per_step"] = (now - t_log) / n_since
                means.update(host_ms.read())
                means["etc/num_voxels"] = self.renderer.num_voxels
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
                "s_val": self.s_val_at(self.global_step),
                "params": self.params,
            },
            "trainer": {
                "global_step": self.global_step,
                **self.sampler.state(),
                "lr_scales": dict(self.lr_scales),
                "optimizer": self.opt_state,
            },
        })

    # ----------------------------------------------------------------- eval

    def _eval_fwd(self) -> Callable:
        """The renderer's eval forward of one chunk of rays (the LTS stage
        passes its options)."""
        return self.renderer.forward_evaluate

    def _eval_chunk(self, ro, rd, vd, em, pos_rt, s_val):
        """One eval chunk through :meth:`eval_chunk_retry`; a
        ``pbr_points`` output is popped and decomposed into images by
        :meth:`_decompose_pbr`."""
        out = self.eval_chunk_retry(self._eval_fwd(), self.params, ro, rd,
                                    vd, em, pos_rt, s_val)
        pbr_pts = out.pop("pbr_points", None)
        if pbr_pts is not None:
            out.update(self._decompose_pbr(pbr_pts, ro.shape[0], s_val))
        return out

    def _decompose_pbr(self, pbr_pts, n_rays: int, s_val):
        """Hook: the chunked LTS decomposition (LTS and PDRA stages)."""
        raise NotImplementedError

    def _scene_extra_images(self, dirs) -> None:
        """Hook: extra scene-level images (the LTS stage's envmap)."""

    def _pre_composite_hook(self, imgs, data, metrics):
        """Hook: per-image processing before the background composite
        (the PDRA stage's emission masks)."""
        return imgs

    @gathers_params()
    def evaluate(self, N_vis: int = -1) -> None:
        """Renders (``forward_evaluate`` runs under ``torch.no_grad``),
        metrics and a mesh of the test images (all, or about ``N_vis`` of
        them), through the hooks :meth:`_decompose_pbr`,
        :meth:`_pre_composite_hook` and :meth:`_scene_extra_images`."""
        t0 = time.perf_counter()
        dirs = self.eval_dirs()
        img_idxes = self.eval_img_idxes(len(self.test_dataset), N_vis)
        width, height = self.test_dataset.image_size

        metrics: Dict[str, List] = {
            **{f"lin/MSE_EXR_{mode}": [] for mode in ["off", "on"]},
            "srgb/MSE": [], "lin/MSE": [], "srgb/PSNR": [], "lin/PSNR": [],
            "srgb/SSIM": [], "lin/SSIM": [],
            "srgb/LPIPS_ALEX": [], "lin/LPIPS_ALEX": [],
        }
        renders: Dict[str, List[np.ndarray]] = {}
        s_val = float(getattr(self.renderer, "s_val", self.s_start))

        for i in self.tqdm(img_idxes, desc="eval", leave=False):
            data = self.test_dataset[int(i)]
            em = int(np.asarray(data["em_modes"]).reshape(-1)[0])
            pos_rt = torch.as_tensor(np.asarray(data["poses"][:3, :3]),
                                     device=self.device)
            imgs = self.render_image(
                data, ("rays_o", "rays_d", "viewdirs"),
                lambda ro, rd, vd: self._eval_chunk(ro, rd, vd, em, pos_rt,
                                                    s_val))
            imgs = composite_hdr(self._pre_composite_hook(imgs, data,
                                                          metrics),
                                 self.white_bg)

            hdrs = data["hdrs"].reshape(height, width, 3)
            rgbs = data["rgbs"].reshape(height, width, 3)
            pred = imgs["srgb/rgb"]
            lin_org = imgs["lin/rgb"]
            lin_gamma = imgs["lin/rgb_gamma"]

            for mode in ["off", "on"]:
                metrics[f"lin/MSE_EXR_{mode}"].append(
                    float(((lin_org - hdrs) ** 2).mean())
                    if LightDict[mode] == em else None)

            mse = float(((pred - rgbs) ** 2).mean())
            lin_mse = float(((lin_gamma - rgbs) ** 2).mean())
            metrics["srgb/MSE"].append(mse)
            metrics["lin/MSE"].append(lin_mse)
            metrics["srgb/PSNR"].append(loss2psnr(mse))
            metrics["lin/PSNR"].append(loss2psnr(lin_mse))
            metrics["srgb/SSIM"].append(rgb_ssim(pred, rgbs, 1))
            metrics["lin/SSIM"].append(rgb_ssim(lin_gamma, rgbs, 1))
            metrics["srgb/LPIPS_ALEX"].append(rgb_lpips(rgbs, pred, "alex"))
            metrics["lin/LPIPS_ALEX"].append(rgb_lpips(rgbs, lin_gamma, "alex"))

            trunc = self.pop_eval_truncation()
            metrics.setdefault("etc/truncated_frac", []).append(
                trunc if trunc > 0 else None)
            if trunc > 0:
                print(f"[eval] image {int(i)}: render TRUNCATED "
                      f"(overflow {trunc:.4f} at max budget scale)")

            for k, v in imgs.items():
                renders.setdefault(k, []).append(
                    (np.clip(v, 0, 1) * 255).astype(np.uint8))
        t_img = time.perf_counter()
        self._scene_extra_images(dirs)
        t_extra = time.perf_counter()

        verts, tris = self.renderer.extract_geometry(
            self.params,
            resolution=min(512, 4 * max(self.renderer.geo.world_size)))
        scale_mat = np.asarray(self.test_dataset.scale_mat)
        verts = verts * scale_mat[0, 0] + scale_mat[:3, 3][None]
        if self.is_writer:
            meshutil.export_ply(os.path.join(dirs["mesh"], "mesh.ply"),
                                verts, tris)
        t_mesh = time.perf_counter()
        scn_metrics = {}
        if getattr(self.test_dataset, "pcd", None) is not None:
            _, _, scn_metrics["mesh/CD"] = DTU_CD(verts, tris,
                                                  *self.test_dataset.pcd)
            self.timings["cd_s"] = time.perf_counter() - t_mesh

        compact = {k: [x for x in v if x is not None]
                   for k, v in metrics.items()}
        compact = {k: v for k, v in compact.items() if v}
        self.save_renders(
            dirs, renders,
            {k: v for k, v in compact.items() if len(v) == len(img_idxes)})
        self.timings.update({
            "eval_s_per_image": (t_img - t0) / max(1, len(img_idxes)),
            "mesh_s": t_mesh - t_extra,
            "mesh_verts": len(verts),
        })
        self.log_eval(self.test_dataset.phase + "/", {
            **compact,
            **{k: [v] for k, v in scn_metrics.items()},
            **{f"etc/{k}": [v] for k, v in self.timings.items()
               if not k.startswith("ckpt")},
        })
