"""Stage 4 trainer, LTS: light-transport-segment inverse rendering on the
ESRNeRF model.

Port of ``esrnerf_tpu/apps/lts.py``. The train step
(:func:`build_lts_train_step`): ``ESRNeRF.forward_training`` -> loss (sRGB
MSE + linear MSE + ``weight_lts`` x the masked off/emo reconstruction MSEs +
the last-ray entropy + the normal-smoothness L1 + TV) -> backward ->
gradient all-reduce over the ranks (at world > 1; under ``shard_map`` each
rank selects its share of the surface points from its own march, under
``gspmd`` the ranks make world 1's choice together) -> SDF TV gradient ->
per-group Adam. The trainer (:class:`LTS`): a warm start of the
overlapping parameter groups from the fine stage's checkpoint (optionally
the BRDF grid from the off colour grid), the two-pool
:class:`~esrnerf_tpu_torch.data.sampler.RayGroupManager` seeded with the
fine stage's ray indices, a fixed NeuS sharpness, the forward's draws keyed
by the run's seed and the global step (:meth:`LTS.draw_key`), checkpoints
that the JAX package reads (and that it writes) with resume, and an eval
that adds the envmap images and, with ``app.eval.render_pbr``, the chunked
PBR decomposition.
"""

from __future__ import annotations

import functools
import os
import shutil
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from esrnerf_tpu_torch.apps.base import gathers_params, loss_and_grads
from esrnerf_tpu_torch.apps.fine import Fine, add_sdf_tv_grad
from esrnerf_tpu_torch.config import save_cfg
from esrnerf_tpu_torch.data.sampler import RayGroupManager
from esrnerf_tpu_torch.models.esrnerf import ESRNeRF
from esrnerf_tpu_torch.models.voxurf_base import (fold_counters,
                                                  march_fractions)
from esrnerf_tpu_torch.ops import pbr as pbrops
from esrnerf_tpu_torch.ops.image import apply_gamma_curve
from esrnerf_tpu_torch.ops.keyed import DrawKey
from esrnerf_tpu_torch.optim import Adam, CosineLR
from esrnerf_tpu_torch.parallel.mesh import ParamLayout, ShardHelpers
from esrnerf_tpu_torch.utils import checkpoint as ckpt_io
from esrnerf_tpu_torch.utils import png
from esrnerf_tpu_torch.utils import profiling
from esrnerf_tpu_torch.utils.device import resolve_device
from esrnerf_tpu_torch.utils.metrics import loss2psnr


def masked_mse(a, b, valid, gsum: Callable = lambda x: x):
    """MSE over the rows where ``valid``, normalised by their count; with
    ``gsum`` (``ShardHelpers.gsum``) the numerator and the count are both
    global, exact where the ranks' valid counts differ."""
    v = valid[:, None].to(a.dtype)
    n = torch.clamp(gsum(v.sum()) * a.shape[-1], min=1.0)
    return gsum((((a - b) ** 2) * v).sum()) / n


def lts_loss(model, params, batch, s_val, tv_flag, smooth_grad_tv, draws,
             generator, *, w_ent: float, w_lin: float, w_lts: float,
             w_nsm: float, white_bg: float, normal_eps: float,
             emit_eps: float, sh: ShardHelpers = ShardHelpers(), key=None):
    """The LTS loss, each term folded over the ranks by ``sh``. Returns
    ``(loss, (mse, lin_mse, off_mse, emo_mse, counts, counts_2nd,
    counters))`` with the rank's counts of both marches and its own five
    counters of them (:func:`lts_counters`)."""
    res = model.forward_training(
        params, batch["rays_o"], batch["rays_d"], batch["viewdirs"],
        batch["em_modes"], batch["uncert_masks"], s_val, normal_eps,
        emit_eps, draws=draws, generator=generator, sh=sh, key=key,
    )
    wbg = res["etc/white_bg"] * white_bg
    srgb = torch.clamp(res["srgb/rgb"] + wbg, 0.0, 1.0)
    lin = torch.clamp(res["lin/rgb"] + wbg, min=0.0)
    rgbs = batch["rgbs"]
    mse = sh.gmean((srgb - rgbs) ** 2)
    lin_tone = torch.where(rgbs >= 1, torch.clamp(lin, max=1.0), lin)
    lin_mse = sh.gmean((apply_gamma_curve(lin_tone) - rgbs) ** 2)
    loss = mse + w_lin * lin_mse

    lv = res["lin/pbr/valid"]
    off_l = masked_mse(res["lin/pbr/off"], res["lin/pbr/off_hat"], lv,
                       sh.gsum)
    emo_l = masked_mse(res["lin/pbr/emo"], res["lin/pbr/emo_hat"], lv,
                       sh.gsum)
    loss = loss + w_lts * (off_l + emo_l)

    # the reference's entropy term reads only the batch's last ray
    pout = torch.clamp(res["etc/alphainv_cum"][..., -1], 1e-6, 1 - 1e-6)
    ent = sh.glast(
        -(pout * torch.log(pout) + (1 - pout) * torch.log(1 - pout)).mean())
    loss = loss + w_ent * ent

    # normal smoothness on the per-point expected gradients, masked to
    # real samples
    pv = res["etc/point_valid"][:, None].to(torch.float32)
    nsm = sh.gsum(
        (torch.abs(res["etc/normal"] - res["etc/normal_eps"]) * pv).sum()) \
        / torch.clamp(sh.gsum(pv.sum()) * 3, min=1.0)
    loss = loss + w_nsm * nsm

    if tv_flag:
        tv = model.density_total_variation(params, smooth_grad_tv)
        loss = loss + tv_flag * (tv / sh.n if sh.n > 1 else tv)
    return loss, (mse, lin_mse, off_l, emo_l, res["etc/counts"],
                  res["etc/counts_2nd"], lts_own_counters(res))


def build_lts_train_step(model, opt, cfg, device="cuda",
                         sh: ShardHelpers = ShardHelpers(),
                         layout: Optional[ParamLayout] = None) -> Callable:
    """The LTS train step, in the shape of
    :func:`~esrnerf_tpu_torch.apps.fine.build_fine_train_step` (``sh``: the
    ranks' reductions; under ``shard_map`` the caller sets
    ``model.lts_points_divisor`` to the world; ``layout``: X-slab
    parameters under ``fsdp``).

    Returns ``train_step(params, opt_state, batch, s_val, lr_scales,
    tv_flag, smooth_grad_tv, sdf_tv_w, tv_dense, draws=None,
    generator=None, key=None) -> (params, opt_state, aux)`` with ``aux =
    (mse, lin_mse, off_mse, emo_mse, overflow, k1_frac, k2_frac,
    k1_frac_2nd, k2_frac_2nd)`` on the device. ``batch`` holds ``rays_o,
    rays_d, viewdirs, em_modes, uncert_masks, rgbs``; the forward's
    randomness is ``draws`` (an :class:`~esrnerf_tpu_torch.models.esrnerf.
    LTSDraws`) or, if None, keyed by ``key`` (a :class:`~esrnerf_tpu_torch.
    ops.keyed.DrawKey`; the trainer's is the run's seed and the global
    step) or by the key that ``generator`` names. The phases run inside
    the ranges ``lts/{loss,backward,sdf_tv_grad,adam}`` and the forward's own
    ``lts/{march,features,heads,brdf,lts,march_2nd}``. TF32 is switched off.
    """
    dev = resolve_device(device)
    if model.device.type != dev.type:
        raise ValueError(f"model lives on {model.device}, step asked for {dev}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    tr = cfg.app["trainer"]
    kw = dict(w_ent=float(tr["weight_entropy_last"]),
              w_lin=float(tr["weight_linear"]),
              w_lts=float(tr["weight_lts"]),
              w_nsm=float(tr["weight_normal_smooth"]),
              white_bg=float(cfg.data["white_bg"]),
              normal_eps=float(tr["normal_eps"]),
              emit_eps=float(tr["emit_eps"]))

    def train_step(params, opt_state, batch, s_val, lr_scales, tv_flag,
                   smooth_grad_tv, sdf_tv_w, tv_dense, draws=None,
                   generator=None, key=None):
        whole = {}

        def loss_fn(p):
            whole["sdf"] = p["sdf"].detach()  # gathered under fsdp
            return lts_loss(model, p, batch, s_val, tv_flag, smooth_grad_tv,
                            draws, generator, sh=sh, key=key, **kw)

        aux, grads = loss_and_grads(loss_fn, params, "lts", sh, layout)
        with torch.no_grad(), profiling.span("lts/sdf_tv_grad"):
            add_sdf_tv_grad(model, whole.pop("sdf"), grads, tv_flag,
                            sdf_tv_w, tv_dense, layout)
        with profiling.span("lts/adam"):
            params, opt_state = opt.step(params, grads, opt_state,
                                         lr_scales=lr_scales)
        return params, opt_state, lts_counters(aux, 4, sh)

    return train_step


def lts_own_counters(res) -> tuple:
    """The LTS forward's five counters of its own two marches: overflow
    (the larger of the two), k1_frac, k2_frac, k1_frac_2nd, k2_frac_2nd."""
    return (res["etc/overflow"], res["etc/k1_frac"], res["etc/k2_frac"],
            res["etc/k1_frac_2nd"], res["etc/k2_frac_2nd"])


def _lts_fractions(both: torch.Tensor) -> tuple:
    """The five counters of two marches' counts, concatenated."""
    first, second = both.chunk(2)
    o1, a1, b1 = march_fractions(first)
    o2, a2, b2 = march_fractions(second)
    return torch.maximum(o1, o2), a1, b1, a2, b2


def lts_counters(aux, n_terms: int, sh: ShardHelpers) -> tuple:
    """The step's aux detached: its first ``n_terms`` loss terms, then the
    five counters (:func:`lts_own_counters`) of the two marches' counts
    and the rank's own counters that follow them, folded over the ranks
    by :func:`~esrnerf_tpu_torch.models.voxurf_base.fold_counters`, then
    anything after them as it is."""
    counts, counts_2nd, own = aux[n_terms:n_terms + 3]
    counters = fold_counters((counts, counts_2nd), own, sh,
                             derive=_lts_fractions)
    return (*(a.detach() for a in aux[:n_terms]), *counters,
            *(a.detach() for a in aux[n_terms + 3:]))


class LTS(Fine):
    STAGE_CLS = "fine.LTS"
    PREV_CLS = "fine.Fine"
    MODEL_CLS = ESRNeRF

    def __init__(self, cfg):
        # Fine reads keys the LTS configs leave out
        tr = cfg.app["trainer"]
        tr.setdefault("sdf_reduce", 1.0)
        tr.setdefault("num_voxels", 0)
        tr.setdefault("pg_scale", [])
        tr.setdefault("scale_ratio", 1.0)
        super().__init__(cfg)
        self.brdf_color_init = tr["brdf_color_init"]
        self.render_pbr = bool(cfg.app["eval"]["render_pbr"])
        self.chunk_sz = int(cfg.app["eval"]["chunk_size"])
        self.envmap_height = int(cfg.app["eval"]["envmap_height"])
        self.envmap_width = int(cfg.app["eval"]["envmap_width"])

    # ---------------------------------------------------------------- model

    def _init_params(self, prev: dict) -> dict:
        """Fresh ESRNeRF parameters from ``system.seed``, the groups the
        fine checkpoint also has taken from it (and, with
        ``brdf_color_init``, the BRDF grid from its off colour grid)."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(self.cfg.system["seed"]))
        params = self.renderer.init_params(gen)
        prev_params = prev["renderer"]["params"]
        for k in params:
            if k in prev_params:
                params[k] = ckpt_io.to_device(prev_params[k], self.device)
        if self.brdf_color_init:
            params["brdf"] = ckpt_io.to_device(prev_params["off_color"],
                                               self.device)
        return params

    def load_train_model(self) -> None:
        """Fresh from the fine stage's checkpoint (``app.trainer.ckpt`` or
        its ``last.ckpt`` by path), or resumed from this run's
        ``last.ckpt``."""
        ckpt, is_resume = self.resolve_train_ckpt()
        if ckpt is None:
            ckpt = self.prev_stage_ckpt()
        data = self.train_dataset.all_data
        payload = ckpt_io.load_checkpoint(ckpt)
        r, t = payload["renderer"], payload["trainer"]
        self.renderer = self._build_renderer(r, r["s_val"], r["num_voxels"])
        self.opt = Adam(self.lrs)
        if not is_resume:
            self.global_step = 0
            self.params = self._init_params(payload)
            self.opt_state = self.opt.init(self.params)
            self.lr_scales = {k: 1.0 for k in self.lrs}
            self.lr_scheduler = CosineLR.from_cfg(self.cfg, 0)
            self.sampler = self._make_sampler(data, t["data_idxs"])
            self.sampler.shuffle()
        else:
            self.global_step = t["global_step"] + 1
            self.params = ckpt_io.to_device(r["params"], self.device)
            self.opt_state = ckpt_io.to_device(t["optimizer"], self.device)
            self.lr_scales = dict(t["lr_scales"])
            self.lr_scheduler = CosineLR.from_cfg(self.cfg, self.global_step)
            self.sampler = self._resume_sampler(data, t)
            print(f"resume training from step {self.global_step}")

    def _make_sampler(self, data, uncert_data_idxs):
        """Every ray starts uncertain; the certain pool's batch is 0."""
        return RayGroupManager(
            self.cfg, data, self.data_keys, self.train_bs, 0,
            uncert_data_idxs=uncert_data_idxs, seed=self.cfg.system["seed"])

    def _resume_sampler(self, data, t):
        """The sampler of a resumed run from its checkpoint's ``trainer``
        part ``t``."""
        return RayGroupManager(
            self.cfg, data, self.data_keys, self.train_bs, 0,
            uncert_batch_st=t["batch_st"], uncert_data_idxs=t["data_idxs"],
            seed=self.cfg.system["seed"])

    # ---------------------------------------------------------------- train

    def _train_step(self) -> Callable:
        """The stage's train step (PDRA: its own loss). On a
        ``shard_map`` world each rank selects its share of the surface
        points."""
        self.check_shardable(self.train_bs)
        self.renderer.lts_points_divisor = self.num_shards
        return build_lts_train_step(self.renderer, self.opt, self.cfg,
                                    device=self.device,
                                    sh=self.shard_helpers(),
                                    layout=self.layout)

    def learn(self) -> None:
        self.place_params()
        step_fn = self._train_step()
        ckpt_dir = self.ckpt_dir()
        ckpt_path = os.path.join(ckpt_dir, "last.ckpt")
        logger = self.get_logger()
        logs: Dict[str, List[float]] = {
            "srgb/MSE": [], "srgb/PSNR": [], "lin/MSE": [], "lin/PSNR": [],
            "lin/pbr/off_MSE": [], "lin/pbr/emo_MSE": [],
        }
        log_every = int(self.cfg.system["tqdm_iters"])
        t_log, n_since = time.perf_counter(), 0
        host_ms, cap = profiling.HostMs(), profiling.TraceCapture(self.cfg)

        tune_step = self.global_step
        pbar = self.tqdm(range(self.global_step, self.n_iters), colour="green")
        for self.global_step in pbar:
            cap.step(self.global_step)
            self.on_step_begin()
            batch = self.place_batch(self.sampler.sample())
            s_val = self.s_val_at(self.global_step)
            self.renderer.s_val = s_val
            tv_on = (self.tv_from < self.global_step < self.tv_end
                     and self.global_step % self.tv_every == 0)
            self.params, self.opt_state, aux = step_fn(
                self.params, self.opt_state, batch, s_val,
                dict(self.lr_scales), 1.0 if tv_on else 0.0,
                float(self.tvs["smooth_grad"]),
                float(self.weight_tv_density * self.tvs["sdf"]
                      / self.train_bs),
                self.global_step < self.tv_dense_before,
                key=self.draw_key())
            mse, lin_mse, off_l, emo_l, ovf, k1f, k2f, k1f2, k2f2 = aux[:9]
            n_since += 1

            if self.global_step == tune_step:
                self.maybe_autotune_budgets(
                    {"k1": float(k1f), "k2": float(k2f),
                     "k1_2nd": float(k1f2), "k2_2nd": float(k2f2)})

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
                logs["lin/pbr/off_MSE"].append(float(off_l))
                logs["lin/pbr/emo_MSE"].append(float(emo_l))
                means = {k: float(np.mean(v)) for k, v in logs.items()}
                logs = {k: [] for k in logs}
                if hasattr(pbar, "set_description"):
                    pbar.set_description(
                        f"Iter {self.global_step:05d} (s) psnr = "
                        f"{means['srgb/PSNR']:.2f} (p) env = "
                        f"{means['lin/pbr/off_MSE']:.5f} em = "
                        f"{means['lin/pbr/emo_MSE']:.5f}")
                means["etc/overflow"] = self.track_overflow(ovf)
                means["etc/k1_frac"] = float(k1f)
                means["etc/k2_frac"] = float(k2f)
                means["etc/k1_frac_2nd"] = float(k1f2)
                means["etc/k2_frac_2nd"] = float(k2f2)
                # wall-clock per step since the last log (the float()
                # reads above end each interval with a synchronise)
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

    def on_step_begin(self) -> None:
        """Hook for the PDRA stage's periodic ray-group updates."""

    def draw_key(self) -> DrawKey:
        """The key of the current step's draws: the run's seed and the
        global step, so a run resumed at a step draws what an unbroken run
        draws there, on any world size (each rank keys its rows by their
        rays' places in the global batch)."""
        return DrawKey(int(self.cfg.system["seed"]), int(self.global_step))

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
                "batch_st": self.sampler.uncert_batch_st,
                "data_idxs": self.sampler.uncert_data_idxs,
                "lr_scales": dict(self.lr_scales),
                "optimizer": self.opt_state,
            },
        })

    # ----------------------------------------------------------------- eval

    def _emit_grid_key(self) -> str:
        return "emit_color" if "emit_color" in self.params else "emo_color"

    def _eval_fwd(self) -> Callable:
        return functools.partial(self.renderer.forward_evaluate,
                                 render_pbr=self.render_pbr,
                                 emit_grid_key=self._emit_grid_key())

    def _lts_chunk_draws(self, generator, k: int):
        """The scattering's normal draws of one decomposition chunk of
        ``k`` points (None with Fibonacci sampling)."""
        if self.renderer.ray_sampling in ("fib", "fibo", "fibonacci"):
            return None
        return pbrops.scattering_draws(generator, (k,),
                                       self.renderer.num_2ndrays)

    def _decompose_pbr(self, pbr_pts, n_rays: int, s_val):
        """Chunked per-point LTS decomposition -> per-ray images, weighted
        by the march's weights. Chunks past the pad tail (weight 0) are
        skipped."""
        model = self.renderer
        chunk = self.chunk_sz
        n_live = int(torch.count_nonzero(~pbr_pts["pad"]))
        gen = torch.Generator(device=self.device).manual_seed(0)
        parts: Dict[str, List[torch.Tensor]] = {}
        for st in range(0, n_live, chunk):
            en = min(st + chunk, pbr_pts["pts"].shape[0])
            sl = slice(st, en)
            out = self.eval_chunk_retry(
                model.lts_eval_chunk, self.params,
                self._lts_chunk_draws(gen, en - st), pbr_pts["pts"][sl],
                pbr_pts["viewdirs"][sl], pbr_pts["normal"][sl],
                pbr_pts["basecolor"][sl], pbr_pts["roughness"][sl],
                pbr_pts["metallic"][sl], s_val)
            self.track_overflow(out.pop("etc/overflow"))
            for k, v in out.items():
                parts.setdefault(k, []).append(v)

        n_pts = min(-(-n_live // chunk) * chunk, pbr_pts["pts"].shape[0])
        w = pbr_pts["weights"][:n_pts, None]
        rid = pbr_pts["ray_id"][:n_pts]

        def per_ray(vals):
            acc = torch.zeros((n_rays + 1, 3), dtype=torch.float32,
                              device=vals.device)
            return acc.index_add(0, rid, w * vals)[:n_rays]

        names = ("lin/env_dir", "lin/env_indir", "lin/env_effects",
                 "lin/emit_(in)dir")
        res = {k: (per_ray(torch.cat(parts[k], 0)) if k in parts else
                   torch.zeros((n_rays, 3), device=self.device))
               for k in names}
        res["lin/emit_effects"] = res["lin/emit_(in)dir"] + per_ray(
            pbr_pts["emit"][:n_pts])
        return res

    def _scene_extra_images(self, dirs) -> None:
        """The SG envmap as ``etc/envmap.png`` and its gamma-curved
        ``etc/envmap_gamma.png`` (rank 0)."""
        if not self.is_writer:
            return
        with torch.no_grad():
            env = self.renderer.render_envmap(self.params, self.envmap_height,
                                              self.envmap_width)
            env = torch.clamp(env, 0.0, 1.0).cpu()
            gamma = apply_gamma_curve(env)
        edir = os.path.join(dirs["image"], "etc")
        os.makedirs(edir, exist_ok=True)
        png.write(os.path.join(edir, "envmap.png"),
                  (env.numpy() * 255).astype(np.uint8))
        png.write(os.path.join(edir, "envmap_gamma.png"),
                  (gamma.numpy() * 255).astype(np.uint8))
