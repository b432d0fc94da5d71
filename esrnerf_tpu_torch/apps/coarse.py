"""Stage 2 trainer, Coarse: VoxurfC SDF pretraining.

Port of ``esrnerf_tpu/apps/coarse.py``. The train step
(:func:`build_coarse_train_step`): ``VoxurfC.forward_training`` -> MSE plus
the entropy term plus (on TV steps) the density and colour TV -> backward
-> gradient all-reduce over the ranks (at world > 1) -> per-group Adam.
The trainer (:class:`Coarse`): the bbox shrunk to the alphamask stage's
occupied voxels, found by path substitution or given as
``app.trainer.ckpt``; the DVGO-style training-ray filter against its mask
cache; the NeuS sharpness schedule; the exponential LR decay with the
``decay_steps`` and the ``tv_updates`` keyed by step; the budget autotune;
eval with a mesh (and the DTU Chamfer distance where the dataset has a
point cloud); checkpoints in the JAX package's schema with resume.
"""

from __future__ import annotations

import os
import shutil
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from esrnerf_tpu_torch.apps.alphamask import entropy_last
from esrnerf_tpu_torch.apps.base import (AppClass, composite_white_bg,
                                         gathers_params, import_class,
                                         loss_and_grads, srgb_metrics)
from esrnerf_tpu_torch.config import save_cfg
from esrnerf_tpu_torch.data.sampler import BatchSampler
from esrnerf_tpu_torch.models.voxurf_base import (fold_counters,
                                                  make_mask_cache)
from esrnerf_tpu_torch.models.voxurfc import VoxurfC
from esrnerf_tpu_torch.optim import Adam, exp_decay_factor
from esrnerf_tpu_torch.parallel.mesh import ParamLayout, ShardHelpers
from esrnerf_tpu_torch.utils import checkpoint as ckpt_io
from esrnerf_tpu_torch.utils import mesh as meshutil
from esrnerf_tpu_torch.utils import profiling
from esrnerf_tpu_torch.utils.device import resolve_device
from esrnerf_tpu_torch.utils.metrics import DTU_CD, loss2psnr


def compute_bbox_by_coarse_geo(mask_xyz_min, mask_xyz_max, density,
                               act_shift, bbox_thres):
    """The bbox of the voxel centres of a ``[X,Y,Z,1]`` numpy density grid
    whose alpha (softplus activation, interval 1) exceeds ``bbox_thres``."""
    X, Y, Z, _ = density.shape
    interp = np.stack(np.meshgrid(
        np.linspace(0, 1, X), np.linspace(0, 1, Y), np.linspace(0, 1, Z),
        indexing="ij"), -1)
    dense_xyz = mask_xyz_min * (1 - interp) + mask_xyz_max * interp
    alpha = 1 - np.exp(-np.logaddexp(0, density[..., 0] + act_shift))
    active = dense_xyz[alpha > bbox_thres]
    if not len(active):
        raise ValueError(
            f"no voxel of the alphamask density has alpha > {bbox_thres}: "
            "the alphamask stage needs more steps")
    return active.min(0), active.max(0)


def coarse_loss(model: VoxurfC, params, batch, s_val, tv_flag, sdf_tv,
                smooth_grad_tv, *, w_ent: float, w_tvd: float, w_tvc: float,
                white_bg: float, sh: ShardHelpers = ShardHelpers()):
    """``mse + w_ent * entropy + tv_flag * (w_tvd * density TV + w_tvc *
    colour TV)``. The entropy term reads the batch's last ray only: the
    reference indexes ``[..., -1]`` into the per-ray transmittance (on a
    world of ranks the global last ray, on the last rank). ``sh`` folds
    the terms over the ranks (the TV divided by the world). Returns
    ``(loss, (mse, counts, (overflow, k1_frac, k2_frac)))`` with the
    rank's march counts and its own fractions of them."""
    res = model.forward_training(
        params, batch["rays_o"], batch["rays_d"], batch["viewdirs"],
        batch["em_modes"], s_val)
    pred = torch.clamp(res["srgb/rgb"] + res["etc/white_bg"] * white_bg,
                       0.0, 1.0)
    mse = sh.gmean((pred - batch["rgbs"]) ** 2)
    loss = mse + w_ent * sh.glast(
        entropy_last(res["etc/alphainv_cum"][..., -1]))
    if tv_flag:
        tv = (w_tvd * model.density_total_variation(params, sdf_tv,
                                                    smooth_grad_tv)
              + w_tvc * model.color_total_variation(params))
        loss = loss + tv_flag * (tv / sh.n if sh.n > 1 else tv)
    return loss, (mse, res["etc/counts"], (
        res["etc/overflow"], res["etc/k1_frac"], res["etc/k2_frac"]))


def build_coarse_train_step(model: VoxurfC, opt: Adam, cfg, device="cuda",
                            sh: ShardHelpers = ShardHelpers(),
                            layout: Optional[ParamLayout] = None
                            ) -> Callable:
    """The coarse train step, on one device or (``sh`` of a world of
    ranks) data-parallel over the ranks' blocks of the batch (global
    losses, counters folded by
    :func:`~esrnerf_tpu_torch.models.voxurf_base.fold_counters`; X-slab
    parameters with an ``fsdp`` ``layout``).

    Returns ``train_step(params, opt_state, batch, s_val, lr_scales,
    tv_flag, sdf_tv, smooth_grad_tv) -> (params, opt_state, (mse,
    overflow, k1_frac, k2_frac))`` with the reference's argument order:
    one loss, backward and per-group Adam update (in place). The aux values
    stay on the device. Phases run inside spans
    (:func:`~esrnerf_tpu_torch.utils.profiling.span`: ``coarse/loss``,
    ``/backward``, ``/adam``; the forward's ``coarse/march``,
    ``/features``, ``/heads``). ``device="cuda"`` raises without CUDA.
    TF32 is switched off, so the head matmuls run in f32.
    """
    dev = resolve_device(device)
    if model.device.type != dev.type:
        raise ValueError(f"model lives on {model.device}, step asked for {dev}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tr = cfg.app["trainer"]
    kw = dict(w_ent=float(tr["weight_entropy_last"]),
              w_tvd=float(tr["weight_tv_density"]),
              w_tvc=float(tr["weight_tv_color"]),
              white_bg=float(cfg.data["white_bg"]))

    def train_step(params, opt_state, batch, s_val, lr_scales, tv_flag,
                   sdf_tv, smooth_grad_tv):
        aux, grads = loss_and_grads(
            lambda p: coarse_loss(model, p, batch, s_val, tv_flag, sdf_tv,
                                  smooth_grad_tv, sh=sh, **kw),
            params, "coarse", sh, layout)
        with profiling.span("coarse/adam"):
            params, opt_state = opt.step(params, grads, opt_state,
                                         lr_scales=lr_scales)
        mse, counts, fractions = aux
        return params, opt_state, (mse.detach(),
                                   *fold_counters((counts,), fractions, sh))

    return train_step


class Coarse(AppClass):
    STAGE_CLS = "coarse.Coarse"
    PREV_CLS = "coarse.AlphaMask"

    def __init__(self, cfg):
        super().__init__(cfg)
        tr = cfg.app["trainer"]
        self.world_bound_scale = tr["world_bound_scale"]
        self.bbox_thres = tr["bbox_thres"]
        self.s_start = tr["s_start"]
        self.s_inv_ratio = tr["s_inv_ratio"]
        self.step_start = tr["step_start"]
        self.step_end = tr["step_end"]
        self.train_bs = tr["batch_size"]
        self.n_iters = tr["n_iters"]
        self.lrs = dict(tr["lrs"])
        self.lr_decay = tr["lr_decay"]
        self.decay_steps = {int(k): dict(v)
                            for k, v in tr["decay_steps"].items()}
        self.tvs = dict(tr["tvs"])
        self.tv_updates = {int(k): dict(v)
                           for k, v in tr["tv_updates"].items()}
        self.tv_from = tr["tv_from"]
        self.tv_end = tr["tv_end"]
        self.tv_every = tr["tv_every"]
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
        if self.phase not in ("train", "test_nv"):
            raise ValueError("Coarse supports train/test_nv only")
        data_cls = import_class("esrnerf_tpu_torch.data." + self.cfg.data["cls"])
        if self.phase == "train":
            self.train_dataset = data_cls(self.cfg, "train")
            self.test_dataset = data_cls(self.cfg, "test_nv")
        else:
            self.test_dataset = data_cls(self.cfg, self.phase)

    # ---------------------------------------------------------------- model

    def _build_renderer(self, meta: dict, s_val: float) -> VoxurfC:
        mask_meta = {
            "mask_xyz_min": np.asarray(meta["mask_xyz_min"]),
            "mask_xyz_max": np.asarray(meta["mask_xyz_max"]),
            "mask_alpha_init": meta["mask_alpha_init"],
            "mask_density": np.asarray(meta["mask_density"]),
        }
        mask_cache = make_mask_cache(
            mask_meta["mask_density"], mask_meta["mask_xyz_min"],
            mask_meta["mask_xyz_max"], mask_meta["mask_alpha_init"],
            self.cfg.app.model["maskcache_thres"],
            self.cfg.app.model["mask_ks"], device=self.device)
        return VoxurfC(self.cfg, meta["near"], meta["far"],
                       np.asarray(meta["xyz_min"]), np.asarray(meta["xyz_max"]),
                       mask_cache, s_val, mask_meta)

    def load_model(self) -> None:
        if self.phase == "train":
            self.load_train_model()
        else:
            self.load_eval_model()

    def _meta_from_alphamask(self, r: dict) -> dict:
        """Renderer metadata from an alphamask checkpoint's renderer part:
        the bbox shrunk to its occupied voxels and its density as the
        mask."""
        mask_alpha_init = r["cfg"]["app"]["model"]["alpha_init"]
        mask_density = np.asarray(r["params"]["density"])
        act_shift = float(np.log(1 / (1 - mask_alpha_init) - 1))
        xyz_min, xyz_max = compute_bbox_by_coarse_geo(
            np.asarray(r["xyz_min"]), np.asarray(r["xyz_max"]),
            mask_density, act_shift, self.bbox_thres)
        if abs(self.world_bound_scale - 1) > 1e-9:
            shift = (xyz_max - xyz_min) * (self.world_bound_scale - 1) / 2
            xyz_min = xyz_min - shift
            xyz_max = xyz_max + shift
        return {
            "near": r["near"], "far": r["far"],
            "xyz_min": xyz_min, "xyz_max": xyz_max,
            "mask_xyz_min": np.asarray(r["xyz_min"]),
            "mask_xyz_max": np.asarray(r["xyz_max"]),
            "mask_alpha_init": mask_alpha_init,
            "mask_density": mask_density,
        }

    def _sampler(self, data, **state) -> BatchSampler:
        return BatchSampler(self.cfg, data, self.data_keys, self.train_bs,
                            seed=self.cfg.system["seed"], **state)

    def load_train_model(self) -> None:
        """Fresh from the alphamask stage's checkpoint (``app.trainer.ckpt``
        or its ``last.ckpt`` by path), or resumed from this run's
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
            self.renderer = self._build_renderer(
                self._meta_from_alphamask(r), self.s_start)
            gen = torch.Generator(device=self.device)
            gen.manual_seed(int(self.cfg.system["seed"]))
            self.params = self.renderer.init_params(gen)
            self.opt_state = self.opt.init(self.params)
            self.lr_scales = {k: 1.0 for k in self.lrs}
            t0 = time.perf_counter()
            keep = self.renderer.geo.filter_rays_in_maskcache(
                data["rays_o"], data["rays_d"], self.eval_bs)
            self.timings["ray_filter_s"] = time.perf_counter() - t0
            self.timings["rays_kept"] = float(keep.mean())
            self.sampler = self._sampler(data)
            self.sampler.filter(keep)
            self.sampler.shuffle()
        else:
            t = payload["trainer"]
            self.global_step = t["global_step"] + 1
            self.renderer = self._build_renderer(r, r["s_val"])
            self.params = ckpt_io.to_device(r["params"], self.device)
            self.opt_state = ckpt_io.to_device(t["optimizer"], self.device)
            self.lr_scales = dict(t["lr_scales"])
            self.tvs = dict(t["tvs"])
            self.sampler = self._sampler(data, batch_st=t["batch_st"],
                                         data_idxs=t["data_idxs"])
            print(f"resume training from step {self.global_step}")

    def load_eval_model(self) -> None:
        ckpt = self.resolve_eval_ckpt()
        payload = ckpt_io.load_checkpoint(ckpt)
        r = payload["renderer"]
        self.global_step = payload["trainer"]["global_step"]
        self.renderer = self._build_renderer(r, r["s_val"])
        self.params = ckpt_io.to_device(r["params"], self.device)
        print(f"loaded ckpt {ckpt} @ step {self.global_step}")

    # ---------------------------------------------------------------- train

    def process(self) -> None:
        if self.phase == "train":
            self.learn()
        else:
            self.evaluate()

    def tv_on(self, step: int) -> bool:
        return self.tv_from < step < self.tv_end and step % self.tv_every == 0

    def learn(self) -> None:
        decay = exp_decay_factor(self.lr_decay)
        self.check_shardable(self.train_bs)
        self.place_params()
        step_fn = build_coarse_train_step(self.renderer, self.opt, self.cfg,
                                          device=self.device,
                                          sh=self.shard_helpers(),
                                          layout=self.layout)
        ckpt_dir = self.ckpt_dir()
        ckpt_path = os.path.join(ckpt_dir, "last.ckpt")
        logger = self.get_logger()
        logs: Dict[str, List[float]] = {"srgb/MSE": [], "srgb/PSNR": []}
        log_every = int(self.cfg.system["tqdm_iters"])
        t_log, n_since = time.perf_counter(), 0
        host_ms, cap = profiling.HostMs(), profiling.TraceCapture(self.cfg)

        tune_step = self.global_step
        pbar = self.tqdm(range(self.global_step, self.n_iters), colour="green")
        for self.global_step in pbar:
            cap.step(self.global_step)
            batch = self.place_batch(self.sampler.sample())
            s_val = self.s_val_at(self.global_step)
            self.renderer.s_val = s_val
            self.params, self.opt_state, (mse, ovf, k1f, k2f) = step_fn(
                self.params, self.opt_state, batch, s_val,
                dict(self.lr_scales),
                1.0 if self.tv_on(self.global_step) else 0.0,
                float(self.tvs["sdf"]), float(self.tvs["smooth_grad"]))
            n_since += 1

            if self.global_step == tune_step:
                self.maybe_autotune_budgets({"k1": float(k1f),
                                             "k2": float(k2f)})
            for k in self.lr_scales:
                self.lr_scales[k] *= decay
            for k, v in self.decay_steps.get(self.global_step, {}).items():
                self.lr_scales[k] *= v
            self.tvs.update(self.tv_updates.get(self.global_step, {}))

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
                means["etc/overflow"] = self.track_overflow(ovf)
                means["etc/k1_frac"] = float(k1f)
                means["etc/k2_frac"] = float(k2f)
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
                "s_val": self.s_val_at(self.global_step),
                "params": self.params,
            },
            "trainer": {
                "global_step": self.global_step,
                **self.sampler.state(),
                "tvs": dict(self.tvs),
                "lr_scales": dict(self.lr_scales),
                "optimizer": self.opt_state,
            },
        })

    # ----------------------------------------------------------------- eval

    @gathers_params()
    def evaluate(self, N_vis: int = -1) -> None:
        """Renders (with the march-budget retry), sRGB metrics and a mesh
        of the test images (all, or about ``N_vis`` of them); with the
        dataset's point cloud, the mesh's Chamfer distance."""
        t0 = time.perf_counter()
        dirs = self.eval_dirs()
        img_idxes = self.eval_img_idxes(len(self.test_dataset), N_vis)
        width, height = self.test_dataset.image_size
        metrics: Dict[str, List] = {}
        renders: Dict[str, List[np.ndarray]] = {}
        s_val = float(getattr(self.renderer, "s_val", self.s_start))

        for i in self.tqdm(img_idxes, desc="eval", leave=False):
            data = self.test_dataset[int(i)]
            em = int(np.asarray(data["em_modes"]).reshape(-1)[0])
            pos_rt = torch.as_tensor(np.asarray(data["poses"][:3, :3]),
                                     device=self.device)
            imgs = composite_white_bg(self.render_image(
                data, ("rays_o", "rays_d", "viewdirs"),
                lambda ro, rd, vd: self.eval_chunk_retry(
                    self.renderer.forward_evaluate, self.params, ro, rd, vd,
                    em, pos_rt, s_val)), self.white_bg)
            srgb_metrics(metrics, imgs["srgb/rgb"],
                         data["rgbs"].reshape(height, width, 3))
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

        verts, tris = self.renderer.extract_geometry(
            self.params,
            resolution=min(512, 4 * max(self.renderer.geo.world_size)))
        scale_mat = np.asarray(self.test_dataset.scale_mat)
        verts = verts * scale_mat[0, 0] + scale_mat[:3, 3][None]
        if self.is_writer:
            meshutil.export_ply(os.path.join(dirs["mesh"], "mesh.ply"),
                                verts, tris)
        t_mesh = time.perf_counter()
        if getattr(self.test_dataset, "pcd", None) is not None:
            _, _, mean_cd = DTU_CD(verts, tris, *self.test_dataset.pcd)
            metrics["mesh/CD"] = [mean_cd]
            self.timings["cd_s"] = time.perf_counter() - t_mesh

        compact = {k: [x for x in v if x is not None]
                   for k, v in metrics.items()}
        compact = {k: v for k, v in compact.items() if v}
        self.save_renders(
            dirs, renders,
            {k: v for k, v in metrics.items() if len(v) == len(img_idxes)})
        self.timings.update({
            "eval_s_per_image": (t_img - t0) / max(1, len(img_idxes)),
            "mesh_s": t_mesh - t_img,
            "mesh_verts": len(verts),
        })
        self.log_eval(self.test_dataset.phase + "/", {
            **compact,
            **{f"etc/{k}": [v] for k, v in self.timings.items()
               if not k.startswith("ckpt")},
        })
