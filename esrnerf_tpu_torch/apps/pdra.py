"""Stage 5 trainer, PDRA: progressive discovery of reflection areas, and the
relighting evaluation phases.

Port of ``esrnerf_tpu/apps/pdra.py``. The threshold
schedule ``k_val = prog_start + prog_slope * min(step, prog_end_step)``
drives a regroup every ``group_interval`` steps (and at step 0): the
uncertain rays' emission is rendered again (``ESRNeRF.eval_emit``) and the
rays whose largest channel is at most ``k_val`` move to the certain pool.
The train step (:func:`build_pdra_train_step`) is the LTS step with the
asymmetric L1 pair in place of the emission MSE, an emission-suppression
term on certain rays and an emission-smoothness term. The relighting
phases (``test_nvc``, ``test_nvi``, ``test_nvic``) fine-tune the emissive
branch per test image against edited targets (:meth:`PDRA.filter_edit_rays`,
:func:`build_finetune_step`) and render with the frozen ``emit_color``
snapshot; ``test_nv`` adds the emission-mask IoU to the LTS eval.

On a world of data-parallel ranks the train step runs on each rank's block
of the uncertain + certain batch, the fine-tune on its block of the edit
batch when that divides over the ranks (else every rank runs the whole
batch), and the regroup, edit-filter and slot-cache sweeps split each
chunk over the ranks (:meth:`AppClass.run_chunk`), so every rank holds the
same pools.
"""

from __future__ import annotations

import functools
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from esrnerf_tpu_torch.apps.base import (gathers_params, import_class,
                                         loss_and_grads)
from esrnerf_tpu_torch.apps.fine import add_sdf_tv_grad, composite_hdr
from esrnerf_tpu_torch.apps.lts import (LTS, lts_counters, lts_own_counters,
                                        masked_mse)
from esrnerf_tpu_torch.data.base import LightDict
from esrnerf_tpu_torch.data.sampler import RayGroupManager
from esrnerf_tpu_torch.models.voxurf_base import fold_counters
from esrnerf_tpu_torch.ops.image import apply_gamma_curve
from esrnerf_tpu_torch.optim import Adam
from esrnerf_tpu_torch.optim.adam import tree_map
from esrnerf_tpu_torch.parallel.mesh import (ParamLayout, ShardHelpers,
                                            pad_to_multiple, shard_rows)
from esrnerf_tpu_torch.utils import checkpoint as ckpt_io
from esrnerf_tpu_torch.utils import profiling
from esrnerf_tpu_torch.utils.device import resolve_device
from esrnerf_tpu_torch.utils.metrics import IoU, loss2psnr, rgb_lpips, rgb_ssim

FT_GROUPS = ("emo_color", "emo_rgbnet")


def masked_l1(a, b, valid, gsum: Callable = lambda x: x):
    """L1 over the rows where ``valid``, normalised by their count (both
    global with ``gsum``, as :func:`~esrnerf_tpu_torch.apps.lts.
    masked_mse`)."""
    v = valid[:, None].to(a.dtype)
    n = torch.clamp(gsum(v.sum()) * a.shape[-1], min=1.0)
    return gsum((torch.abs(a - b) * v).sum()) / n


def pdra_loss(model, params, batch, s_val, tv_flag, smooth_grad_tv, draws,
              generator, *, w_ent: float, w_lin: float, w_lts: float,
              w_lts_l: float, w_lts_r: float, w_nsm: float, w_esm: float,
              w_esupp: float, white_bg: float, normal_eps: float,
              emit_eps: float, sh: ShardHelpers = ShardHelpers(),
              key=None):
    """The PDRA loss, each term folded over the ranks by ``sh``. Returns
    ``(loss, (mse, lin_mse, off_l1, emo_l1, counts, counts_2nd, counters,
    emo_r1, emit_supp, emit_smooth))``: the LTS loss's aux, then the other
    PDRA terms."""
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

    # the asymmetric pair: emo_l1 moves the target, emo_r1 the emo head
    lv = res["lin/pbr/valid"]
    emo, emo_hat = res["lin/pbr/emo"], res["lin/pbr/emo_hat"]
    off_l = masked_l1(res["lin/pbr/off"], res["lin/pbr/off_hat"], lv,
                      sh.gsum)
    emo_l = masked_l1(emo.detach(), emo_hat, lv, sh.gsum)
    emo_r = masked_l1(emo, emo_hat.detach(), lv, sh.gsum)
    loss = loss + w_lts * (off_l + w_lts_l * emo_l + w_lts_r * emo_r)

    # emission suppression on the certain rays (a global count)
    cert = (~batch["uncert_masks"])[:, None].to(torch.float32)
    denom = torch.clamp(sh.gsum(cert.sum()) * 3, min=1.0)
    em_supp = sh.gsum(((res["etc/emit_marched"] ** 2) * cert).sum()) / denom
    loss = loss + w_esupp * em_supp

    # the reference's entropy term reads only the batch's last ray
    pout = torch.clamp(res["etc/alphainv_cum"][..., -1], 1e-6, 1 - 1e-6)
    ent = sh.glast(
        -(pout * torch.log(pout) + (1 - pout) * torch.log(1 - pout)).mean())
    loss = loss + w_ent * ent

    # normal and emission smoothness, masked to real samples
    pv = res["etc/point_valid"][:, None].to(torch.float32)

    def pt_l1(a, b):
        n = torch.clamp(sh.gsum(pv.sum()) * a.shape[-1], min=1.0)
        return sh.gsum((torch.abs(a - b) * pv).sum()) / n

    loss = loss + w_nsm * pt_l1(res["etc/normal"], res["etc/normal_eps"])
    esm = pt_l1(res["etc/emit"], res["etc/emit_eps"])
    loss = loss + w_esm * esm

    if tv_flag:
        tv = model.density_total_variation(params, smooth_grad_tv)
        loss = loss + tv_flag * (tv / sh.n if sh.n > 1 else tv)
    return loss, (mse, lin_mse, off_l, emo_l, res["etc/counts"],
                  res["etc/counts_2nd"], lts_own_counters(res), emo_r,
                  em_supp, esm)


def build_pdra_train_step(model, opt, cfg, device="cuda",
                          sh: ShardHelpers = ShardHelpers(),
                          layout: Optional[ParamLayout] = None) -> Callable:
    """The PDRA train step (``sh``: the ranks' reductions; ``layout``:
    X-slab parameters under ``fsdp``), in the shape of
    :func:`~esrnerf_tpu_torch.apps.lts.build_lts_train_step`: the same
    arguments (``batch`` with ``uncert_masks``), the LTS step's nine aux
    values then :func:`pdra_loss`'s other terms, and the ranges
    ``pdra/{loss,backward,sdf_tv_grad,adam}`` beside the forward's own
    ``lts/*``. The model must be in PDRA mode (``model.pdra_mode``). TF32 is
    switched off."""
    dev = resolve_device(device)
    if model.device.type != dev.type:
        raise ValueError(f"model lives on {model.device}, step asked for {dev}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    tr = cfg.app["trainer"]
    kw = dict(w_ent=float(tr["weight_entropy_last"]),
              w_lin=float(tr["weight_linear"]),
              w_lts=float(tr["weight_lts"]),
              w_lts_l=float(tr["weight_lts_l"]),
              w_lts_r=float(tr["weight_lts_r"]),
              w_nsm=float(tr["weight_normal_smooth"]),
              w_esm=float(tr["weight_emit_smooth"]),
              w_esupp=float(tr["weight_emit_supp"]),
              white_bg=float(cfg.data["white_bg"]),
              normal_eps=float(tr["normal_eps"]),
              emit_eps=float(tr["emit_eps"]))

    def train_step(params, opt_state, batch, s_val, lr_scales, tv_flag,
                   smooth_grad_tv, sdf_tv_w, tv_dense, draws=None,
                   generator=None, key=None):
        whole = {}

        def loss_fn(p):
            whole["sdf"] = p["sdf"].detach()  # gathered under fsdp
            return pdra_loss(model, p, batch, s_val, tv_flag, smooth_grad_tv,
                             draws, generator, sh=sh, key=key, **kw)

        aux, grads = loss_and_grads(loss_fn, params, "pdra", sh, layout)
        with torch.no_grad(), profiling.span("pdra/sdf_tv_grad"):
            add_sdf_tv_grad(model, whole.pop("sdf"), grads, tv_flag,
                            sdf_tv_w, tv_dense, layout)
        with profiling.span("pdra/adam"):
            params, opt_state = opt.step(params, grads, opt_state,
                                         lr_scales=lr_scales)
        return params, opt_state, lts_counters(aux, 4, sh)

    return train_step


def build_finetune_step(model, opt, weight_lts: float,
                        sh: ShardHelpers = ShardHelpers(),
                        layout: Optional[ParamLayout] = None) -> Callable:
    """The relighting fine-tune step: ``ft_step(trainable, opt_state,
    frozen, batch, s_val, draws=None, generator=None, ft_pts=None,
    ft_valid=None) -> (trainable, opt_state, (loss, overflow))``.
    ``trainable`` holds ``emo_color`` and ``emo_rgbnet``; ``batch`` the
    rays, ``em_modes``, ``em_intensities`` and ``em_colors``. The loss is
    ``weight_lts`` x the masked MSE of the emo head against its edited
    target (numerator and count global over the ranks of ``sh``, the
    secondary march's overflow folded by
    :func:`~esrnerf_tpu_torch.models.voxurf_base.fold_counters`); Adam
    updates ``trainable`` in place (its ``emo_color`` an X-slab with an
    ``fsdp`` ``layout``). Ranges ``relight/{loss,backward,adam}`` and the
    forward's own."""

    def ft_step(trainable, opt_state, frozen, batch, s_val, draws=None,
                generator=None, ft_pts=None, ft_valid=None):
        def loss_fn(p):
            res = model.forward_finetune(
                p, frozen, batch["rays_o"], batch["rays_d"],
                batch["viewdirs"], batch["em_modes"], batch["em_intensities"],
                batch["em_colors"], s_val, draws=draws, generator=generator,
                ft_pts=ft_pts, ft_valid=ft_valid, sh=sh)
            loss = weight_lts * masked_mse(
                res["lin/pbr/emo"], res["lin/pbr/emo_hat"],
                res["lin/pbr/valid"], sh.gsum)
            return loss, (loss, res["etc/counts_2nd"], res["etc/overflow"])

        (loss, counts, overflow), grads = loss_and_grads(
            loss_fn, trainable, "relight", sh, layout)
        with profiling.span("relight/adam"):
            trainable, opt_state = opt.step(trainable, grads, opt_state)
        return trainable, opt_state, (
            loss.detach(), fold_counters((counts,), (overflow,), sh)[0])

    return ft_step


def dilate_like_cv2(mask: np.ndarray, ks: int) -> np.ndarray:
    """``cv2.dilate(mask, np.ones((ks, ks)), iterations=1)`` of a 2-D
    float array: the max over a ``ks`` x ``ks`` window anchored at
    ``ks // 2``, ``dst[y] = max(src[y - ks // 2 .. y + ks - 1 - ks // 2])``
    on each axis (for an even ``ks`` the window reaches one pixel further
    back than forward), pixels outside the image left out."""
    a = np.asarray(mask)
    lo, hi = ks // 2, ks - 1 - ks // 2
    out = a
    for axis in (0, 1):
        pad = [(0, 0), (0, 0)]
        pad[axis] = (lo, hi)
        p = np.pad(out, pad, constant_values=-np.inf)
        win = np.lib.stride_tricks.sliding_window_view(p, ks, axis=axis)
        out = win.max(-1)
    return out.astype(a.dtype)


class PDRA(LTS):
    STAGE_CLS = "fine.PDRA"
    PREV_CLS = "fine.LTS"

    def __init__(self, cfg):
        tr = cfg.app["trainer"]
        # PDRA configures a batch per pool instead of batch_size
        tr.setdefault("batch_size", tr["uncert_batch_size"])
        super().__init__(cfg)
        self.group_interval = int(tr["group_interval"])
        self.prog_start = float(tr["prog_start"])
        self.prog_slope = float(tr["prog_slope"])
        self.prog_end_step = int(tr["prog_end_step"])
        if self.prog_end_step == -1:
            self.prog_end_step = int(tr["n_iters"])
        self.train_uncert_bs = int(tr["uncert_batch_size"])
        self.train_cert_bs = int(tr["cert_batch_size"])

        ev = cfg.app["eval"]
        self.eval_uncert_bs = int(ev["uncert_batch_size"])
        self.eval_cert_bs = int(ev["cert_batch_size"])
        self.eval_niters = int(ev["n_iters"])
        self.mask_dilation_ks = int(ev["mask_dilation_ks"])
        self.eval_lrs = dict(ev["lrs"])
        self.eval_weight_lts = float(ev["weight_lts"])

    @property
    def k_val(self) -> float:
        return (min(self.global_step, self.prog_end_step) * self.prog_slope
                + self.prog_start)

    # ----------------------------------------------------------------- data

    def load_dataset(self) -> None:
        data_cls = import_class("esrnerf_tpu_torch.data." + self.cfg.data["cls"])
        # the relighting phases fine-tune on the train rays
        self.train_dataset = data_cls(self.cfg, "train")
        self.test_dataset = data_cls(
            self.cfg, "test_nv" if self.phase == "train" else self.phase)

    # ---------------------------------------------------------------- model

    def _make_sampler(self, data, uncert_data_idxs):
        return RayGroupManager(
            self.cfg, data, self.data_keys, self.train_uncert_bs,
            self.train_cert_bs, uncert_data_idxs=uncert_data_idxs,
            seed=self.cfg.system["seed"])

    def _resume_sampler(self, data, t):
        return RayGroupManager(
            self.cfg, data, self.data_keys, self.train_uncert_bs,
            self.train_cert_bs, uncert_batch_st=t["uncert_batch_st"],
            cert_batch_st=t["cert_batch_st"],
            uncert_data_idxs=t["uncert_data_idxs"],
            cert_data_idxs=t["cert_data_idxs"], seed=self.cfg.system["seed"])

    def load_train_model(self) -> None:
        """LTS's warm start (or this run's resume), in PDRA mode; a fresh
        run regroups at ``k_val`` and shuffles before its first step."""
        super().load_train_model()
        self.renderer.pdra_mode = True
        if self.global_step == 0:
            self.update_ray_groups(self.k_val)
            self.sampler.shuffle()

    def load_eval_model(self) -> None:
        """The checkpoint's renderer and parameters (on the device, never
        trained in place), and its pools: the relighting fine-tune samples
        the train rays of both."""
        ckpt = self.resolve_eval_ckpt()
        payload = ckpt_io.load_checkpoint(ckpt)
        r, t = payload["renderer"], payload["trainer"]
        self.global_step = t["global_step"]
        self.renderer = self._build_renderer(r, r["s_val"], r["num_voxels"])
        self.renderer.pdra_mode = True
        self.params = ckpt_io.to_device(r["params"], self.device)
        self._ckpt_params = self.params
        self._eval_s_val = float(r["s_val"])
        self._eval_uncert_idxs = t.get("uncert_data_idxs", t.get("data_idxs"))
        self._eval_cert_idxs = t.get("cert_data_idxs", np.arange(0))
        print(f"loaded ckpt {ckpt} @ step {self.global_step}")

    # ------------------------------------------------------------ ray groups

    def _chunks(self, data, bs, keys=("rays_o", "rays_d", "viewdirs")):
        """``(st, en, host arrays)`` over ``data`` in chunks of ``bs`` rays,
        a short tail chunk tiled cyclically to ``bs`` (the march's budgets
        are per chunk)."""
        n = len(data[keys[0]])
        for st in range(0, n, bs):
            en = min(st + bs, n)
            idx = np.resize(np.arange(st, en), bs)
            yield st, en, [data[k][idx] for k in keys]

    def _probe_fn(self, probe, name: str, s_val) -> Callable:
        """``fn(ro, rd, vd) -> {name, etc/overflow}`` of a per-ray probe
        (``eval_emit``, ``eval_esp``) for :meth:`run_chunk`, through
        :meth:`eval_chunk_retry`."""
        def out(*a):
            return dict(zip((name, "etc/overflow"), probe(*a)))

        return lambda ro, rd, vd: self.eval_chunk_retry(
            out, self.params, ro, rd, vd, s_val)

    @gathers_params()
    def update_ray_groups(self, k_val: float) -> None:
        """Render the uncertain pool's emission again and move the rays
        whose largest channel is at most ``k_val`` to the certain pool.
        A chunk that overflows its march budgets runs again with larger
        ones (:meth:`eval_chunk_retry`). On a world of ranks each renders
        its block of every chunk; all get the whole pool's emission."""
        t0 = time.perf_counter()
        pool = self.sampler.uncert_data
        emission = np.zeros((len(pool["rays_o"]), 3), np.float32)
        s_val = self.s_val_at(self.global_step)
        emit_fn = self._probe_fn(self.renderer.eval_emit, "emit", s_val)

        for st, en, arrays in self._chunks(pool, self.eval_uncert_bs):
            out = self.run_chunk(emit_fn, *arrays)
            self.track_overflow(out["etc/overflow"])
            emission[st:en] = out["emit"][:en - st].cpu().numpy()

        keep_uncertain = emission.max(-1) > k_val
        n_before = self.sampler.uncert_data_num
        self.sampler.filter(keep_uncertain)
        dt = time.perf_counter() - t0
        self.timings["regroup_s"] = dt
        self.timings["regroup_rays"] = n_before
        self.get_logger().log({
            "train/metric/etc/k_val": k_val,
            "train/metric/etc/n_uncertain": self.sampler.uncert_data_num,
            "train/metric/etc/n_certain": self.sampler.cert_data_num,
            "train/metric/etc/regroup_s": dt,
        }, step=self.global_step)
        print(f"[pdra] k_val={k_val:.4f} uncertain {n_before} -> "
              f"{self.sampler.uncert_data_num} (certain "
              f"{self.sampler.cert_data_num})")

    def on_step_begin(self) -> None:
        if self.global_step % self.group_interval == self.group_interval - 1:
            self.update_ray_groups(self.k_val)

    # ---------------------------------------------------------------- train

    def _train_step(self) -> Callable:
        self.check_shardable(self.train_uncert_bs + self.train_cert_bs)
        self.renderer.lts_points_divisor = self.num_shards
        return build_pdra_train_step(self.renderer, self.opt, self.cfg,
                                     device=self.device,
                                     sh=self.shard_helpers(),
                                     layout=self.layout)

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

    # ------------------------------------------------------------ relighting

    def filter_edit_rays(self, sampler: RayGroupManager,
                         test_data) -> RayGroupManager:
        """Give each uncertain train ray the edit of the light whose
        dilated mask its expected surface point projects into in the test
        camera (mode, colour, intensity); keep only those rays uncertain.
        The certain pool keeps mode 0 (off)."""
        w, h = self.train_dataset.image_size
        f = self.train_dataset.focal_length
        w2c = np.linalg.inv(np.asarray(test_data["poses"], np.float64))
        K = np.array([[-f, 0.0, w / 2.0 - 0.5], [0.0, f, h / 2.0 - 0.5],
                      [0.0, 0.0, 1.0]], np.float64)
        ks = self.mask_dilation_ks
        em_masks = np.stack([
            dilate_like_cv2(m, ks)
            for m in np.asarray(test_data["em_masks"]).reshape(-1, h, w)])
        em_modes = np.asarray(test_data["em_modes"]).reshape(-1)

        pool = sampler.uncert_data
        n = len(pool["rays_o"])
        keep = np.zeros(n, bool)
        modes = np.ones(n, np.int64)
        colors = np.zeros((n, 2), np.float32)
        intensities = np.zeros(n, np.float32)
        s_val = self.s_val_at(self.global_step)
        esp_fn = self._probe_fn(self.renderer.eval_esp, "esp", s_val)

        for st, en, arrays in self._chunks(pool, self.eval_bs):
            out = self.run_chunk(esp_fn, *arrays)
            self.track_overflow(out["etc/overflow"])
            esp = out["esp"][:en - st].cpu().numpy()

            hom = np.concatenate([esp, np.ones_like(esp[:, :1])], -1).T
            xyz = w2c @ hom
            cam = xyz[:3] / xyz[-1:]
            xyz = K @ cam
            img = (xyz[:2] / xyz[-1:]).T  # [b, 2] (x, y)
            inb = ~((img[:, 0] < 0) | (img[:, 1] < 0)
                    | (img[:, 0] > (w - 1)) | (img[:, 1] > (h - 1)))
            ix = np.clip(img[:, 0], 0, w - 1)
            iy = np.clip(img[:, 1], 0, h - 1)
            # bilinear sample of each light's dilated mask
            x0 = np.floor(ix).astype(int)
            x1 = np.minimum(x0 + 1, w - 1)
            y0 = np.floor(iy).astype(int)
            y1 = np.minimum(y0 + 1, h - 1)
            fx, fy = ix - x0, iy - y0
            for li, mgrid in enumerate(em_masks):
                mv = (mgrid[y0, x0] * (1 - fx) * (1 - fy)
                      + mgrid[y0, x1] * fx * (1 - fy)
                      + mgrid[y1, x0] * (1 - fx) * fy
                      + mgrid[y1, x1] * fx * fy)
                sel = np.arange(st, en)[inb & (mv > 0)]
                keep[sel] = True
                mode = int(em_modes[li])
                modes[sel] = mode
                if mode == LightDict["off"]:
                    intensities[sel] = 0.0
                if mode in (LightDict["i_change"], LightDict["ic_change"]):
                    intensities[sel] = float(np.asarray(
                        test_data["em_intensities"]).reshape(-1)[li])
                if mode in (LightDict["c_change"], LightDict["ic_change"]):
                    colors[sel] = np.asarray(
                        test_data["em_colors"]).reshape(-1, 2)[li][:2]

        pool["em_modes"] = modes
        pool["em_colors"] = colors
        pool["em_intensities"] = intensities
        nc = sampler.cert_data_num
        sampler.cert_data["em_modes"] = np.zeros(nc, np.int64)
        sampler.cert_data["em_colors"] = np.zeros((nc, 2), np.float32)
        sampler.cert_data["em_intensities"] = np.zeros(nc, np.float32)
        sampler.keys = list(sampler.keys) + ["em_colors", "em_intensities"]
        sampler.filter(keep)
        return sampler

    def _cache_march_slots(self, sampler, sdf, s_val):
        """Each pool's rays' surviving samples against the frozen SDF as
        the extra sampler keys ``ft_pts`` / ``ft_valid`` (``ppr`` slots a
        ray, ``app.eval.cache_march_ppr``); chunks of
        ``app.eval.cache_march_chunk`` rays at most (a multiple of the
        world, split over the ranks), a short tail padded with copies of
        its last ray."""
        ev = self.cfg.app["eval"]
        ppr = int(ev.get("cache_march_ppr", 16))
        model = self.renderer
        pool_max = max(sampler.uncert_data_num, sampler.cert_data_num, 1)
        chunk = min(int(ev.get("cache_march_chunk", 4096)),
                    pad_to_multiple(pool_max, self.world.n))

        def slots(ro, rd, vd):
            p, ok, (cnt, drop) = model.geo.march_ray_slots(
                sdf, ro, rd, vd, s_val, model.fastcolor_thres,
                model.neus_alpha, ppr)
            return {"pts": p, "ok": ok, "cnt": cnt, "drop": drop}

        dropped = []
        for pool in (sampler.uncert_data, sampler.cert_data):
            n = len(pool["rays_o"])
            pts_l, ok_l = [], []
            for st in range(0, n, chunk):
                en = min(st + chunk, n)
                idx = np.concatenate([np.arange(st, en),
                                      np.full(chunk - (en - st), en - 1)])
                out = self.run_chunk(slots, *(pool[k][idx] for k in
                                              ("rays_o", "rays_d",
                                               "viewdirs")))
                pts_l.append(out["pts"][:en - st].cpu().numpy())
                ok_l.append(out["ok"][:en - st].cpu().numpy())
                # real rays only: the padded tail repeats one ray
                c = out["cnt"][:en - st].cpu().numpy().astype(np.float64)
                d = out["drop"][:en - st].cpu().numpy().astype(np.float64)
                dropped.append(d.sum() / max(c.sum(), 1.0))
            pool["ft_pts"] = (np.concatenate(pts_l, 0) if pts_l
                              else np.zeros((0, ppr, 3), np.float32))
            pool["ft_valid"] = (np.concatenate(ok_l, 0) if ok_l
                                else np.zeros((0, ppr), bool))
        if dropped and max(dropped) > 0:
            print(f"[relight finetune] march cache dropped {max(dropped):.3f}"
                  " of real samples in its worst chunk (raise "
                  "app.eval.cache_march_ppr to keep more)")
        for k in ("ft_pts", "ft_valid"):
            if k not in sampler.keys:
                sampler.keys = list(sampler.keys) + [k]
        return max(dropped, default=0.0)

    def finetune_radiance(self, test_data) -> List[float]:
        """Fine-tune the emissive branch for one test image against its
        edited targets; returns the per-step losses. Every image starts
        from the checkpoint's ``emo_color`` and ``emo_rgbnet`` (clones: the
        optimizer updates in place) and renders its edit with a frozen
        ``emit_color`` clone of the checkpoint's ``emo_color``."""
        t0 = time.perf_counter()
        ckpt = self._ckpt_params
        frozen = {k: v for k, v in ckpt.items() if k not in FT_GROUPS}
        frozen["emit_color"] = ckpt["emo_color"].clone()
        trainable = {k: tree_map(torch.clone, ckpt[k]) for k in FT_GROUPS}
        self.params = {**frozen, **trainable}
        s_val = self._eval_s_val

        sampler = RayGroupManager(
            self.cfg, self.train_dataset.all_data, list(self.data_keys),
            self.eval_uncert_bs, self.eval_cert_bs,
            uncert_data_idxs=self._eval_uncert_idxs,
            cert_data_idxs=self._eval_cert_idxs,
            seed=self.cfg.system["seed"])
        sampler = self.filter_edit_rays(sampler, test_data)
        t_filter = time.perf_counter()

        cached = bool(self.cfg.app["eval"].get("cache_march", True))
        if cached:
            self.timings["ft_cache_dropped"] = self._cache_march_slots(
                sampler, frozen["sdf"], s_val)
        t_cache = time.perf_counter()

        opt = Adam(self.eval_lrs)
        # data-parallel when the edit batch divides over the ranks; else
        # every rank runs the whole batch alike
        n = self.world.n
        sh = (self.shard_helpers()
              if (self.eval_uncert_bs + self.eval_cert_bs) % n == 0
              else ShardHelpers())
        # fsdp: the trainable emo grid and its moments as X-slabs
        layout = ParamLayout(sh, fsdp=self.layout.fsdp)
        trainable = layout.place(trainable)
        opt_state = opt.init(trainable)
        self.renderer.lts_points_divisor = 1 if sh.gspmd else sh.n
        step = build_finetune_step(self.renderer, opt, self.eval_weight_lts,
                                   sh, layout)
        seed = int(self.cfg.system["seed"])
        if sh.n > 1 and not sh.gspmd:  # shard_map ranks draw apart
            seed = int(np.random.SeedSequence([seed, sh.rank])
                       .generate_state(1)[0])
        gen = torch.Generator(device=self.device).manual_seed(seed)
        losses, ovfs = [], []
        for _ in self.tqdm(range(self.eval_niters), desc="finetune",
                           leave=False):
            batch = {k: self.to_device(shard_rows(v, sh.rank, sh.n))
                     for k, v in sampler.sample().items()}
            trainable, opt_state, (loss, ovf) = step(
                trainable, opt_state, frozen, batch, s_val, generator=gen,
                ft_pts=batch.get("ft_pts"), ft_valid=batch.get("ft_valid"))
            losses.append(loss)
            ovfs.append(ovf)
        losses = torch.stack(losses).cpu().tolist() if losses else []
        if ovfs:
            self.track_overflow(torch.stack(ovfs).max())
        self.params = {**frozen, **layout.gather(trainable)}
        t_end = time.perf_counter()
        self.timings.update({
            "ft_filter_s": t_filter - t0, "ft_cache_s": t_cache - t_filter,
            "ft_steps_s": t_end - t_cache,
            "ft_overflow_max": float(max(ovfs)) if ovfs else 0.0,
            "ft_n_edit_rays": sampler.uncert_data_num,
        })
        if losses:
            print(f"[relight finetune] emo_MSE {losses[0]:.5f} -> "
                  f"{losses[-1]:.5f}")
        return losses

    # ----------------------------------------------------------------- eval

    def evaluate(self, N_vis: int = -1) -> None:
        if self.phase in ("test_nvc", "test_nvi", "test_nvic"):
            self._evaluate_relight(N_vis)
        else:
            self._evaluate_nv(N_vis)

    def _evaluate_nv(self, N_vis: int = -1) -> None:
        """The LTS eval plus the emission-mask IoU."""
        self._iou_acc = [0, 0]
        super().evaluate(N_vis)
        if self._iou_acc[1] > 0:
            self.get_logger().log(
                {f"{self.test_dataset.phase}/metric/etc/IoU":
                 self._iou_acc[0] / max(1, self._iou_acc[1])},
                step=self.global_step)

    def _pre_composite_hook(self, imgs, data, metrics):
        """Mask the rendered emission by ``k_val`` and add the image's
        intersection and union with the ground-truth emission area."""
        if "lin/emit" not in imgs:
            return imgs
        emit = imgs["lin/emit"]
        mask = (emit > self.k_val).any(-1)
        imgs["lin/emit"] = emit * mask[..., None]
        if "areas" in data and hasattr(self, "_iou_acc"):
            areas = np.asarray(data["areas"]).reshape(mask.shape)
            _, inter, union = IoU(mask, areas)
            self._iou_acc[0] += inter
            self._iou_acc[1] += union
        return imgs

    def _evaluate_relight(self, N_vis: int = -1) -> None:
        """Per test image: the fine-tune, then a render with every light on
        and the emission read from ``emit_color``; linear-gamma metrics."""
        dirs = self.eval_dirs()
        img_idxes = self.eval_img_idxes(len(self.test_dataset), N_vis)
        width, height = self.test_dataset.image_size
        metrics: Dict[str, List] = {
            "lin/MSE": [], "lin/PSNR": [], "lin/SSIM": [],
            "lin/LPIPS_ALEX": [], "etc/emo_MSE_first": [],
            "etc/emo_MSE_last": [],
        }
        renders: Dict[str, List[np.ndarray]] = {}
        s_val = self._eval_s_val
        relight_fwd = functools.partial(self.renderer.forward_evaluate,
                                        emit_grid_key="emit_color")
        per_image = []

        for i in self.tqdm(img_idxes, desc="eval", leave=False):
            t0 = time.perf_counter()
            data = self.test_dataset[int(i)]
            losses = self.finetune_radiance(data)
            t_ft = time.perf_counter()
            pos_rt = torch.as_tensor(np.asarray(data["poses"][:3, :3]),
                                     device=self.device)

            def fwd(ro, rd, vd):
                out = self.eval_chunk_retry(relight_fwd, self.params, ro, rd,
                                            vd, 1, pos_rt, s_val)
                out.pop("pbr_points", None)
                return out

            imgs = composite_hdr(self.render_image(
                data, ("rays_o", "rays_d", "viewdirs"), fwd), self.white_bg)

            rgbs = data["rgbs"].reshape(height, width, 3)
            lin_gamma = imgs["lin/rgb_gamma"]
            mse = float(((lin_gamma - rgbs) ** 2).mean())
            metrics["lin/MSE"].append(mse)
            metrics["lin/PSNR"].append(loss2psnr(mse))
            metrics["lin/SSIM"].append(rgb_ssim(lin_gamma, rgbs, 1))
            metrics["lin/LPIPS_ALEX"].append(rgb_lpips(rgbs, lin_gamma,
                                                       "alex"))
            metrics["etc/emo_MSE_first"].append(losses[0] if losses else None)
            metrics["etc/emo_MSE_last"].append(losses[-1] if losses else None)

            trunc = self.pop_eval_truncation()
            metrics.setdefault("etc/truncated_frac", []).append(
                trunc if trunc > 0 else None)
            if trunc > 0:
                print(f"[eval] image {int(i)}: render TRUNCATED "
                      f"(overflow {trunc:.4f} at max budget scale)")
            for k, v in imgs.items():
                renders.setdefault(k, []).append(
                    (np.clip(v, 0, 1) * 255).astype(np.uint8))
            t_end = time.perf_counter()
            per_image.append({"s": t_end - t0, "finetune_s": t_ft - t0,
                              "render_s": t_end - t_ft})

        self.timings["relight_s_per_image"] = float(np.mean(
            [p["s"] for p in per_image])) if per_image else 0.0
        self.timings["relight_images"] = per_image
        self.save_renders(dirs, renders, {
            k: v for k, v in metrics.items()
            if len(v) == len(img_idxes) and None not in v})
        self.log_eval(self.test_dataset.phase + "/", metrics)
