"""Stage-trainer base class.

Port of ``esrnerf_tpu/apps/base.py``. A stage owns ``load_dataset() /
load_model() / process()`` plus its train loop, losses, eval and
checkpoints. Shared here: the device (``system.device``: ``cpu``, or else
CUDA), batch placement through pinned host memory, the loss-and-gradient
helper of the train steps (:func:`loss_and_grads`), checkpoint path
resolution (resume first, then the explicit checkpoint, then the previous
stage's by path substitution), timed checkpoint writes, the eval retry on
march-budget overflow, the one-shot budget autotune, chunked eval rendering
with the white-background composite and the sRGB metrics, the eval
artifact layout (``text/ image/ video/ mesh/`` under the log dir) and
media writing.

Data parallelism (:mod:`esrnerf_tpu_torch.parallel.mesh`, a world of more
than one rank under ``torchrun``): :meth:`AppClass.place_batch` keeps the
rank's block of a batch's rows, the train steps fold their losses and
gradients with :meth:`AppClass.shard_helpers` (``system.parallel``:
``shard_map`` or ``gspmd``), :meth:`AppClass.place_params` keeps the
parameters and Adam moments replicated or, with ``system.param_shard=fsdp``
under ``gspmd``, as X-slabs (:attr:`AppClass.layout`), which
:meth:`AppClass.whole_params` gathers for an eval, a mesh or a checkpoint;
the eval sweeps split each chunk over the ranks and gather the rows back
(:meth:`AppClass.run_chunk`), and rank 0 alone writes logs, checkpoints and
eval files. At world 1 none of it adds a launch.

There is no compile cache: the march reads its budgets from the live
renderer at every call, so a scaled or autotuned budget takes effect on
the next call.
"""

from __future__ import annotations

import contextlib
import functools
import math
import os
import time
import warnings
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from esrnerf_tpu_torch.parallel.mesh import (ParamLayout, ShardHelpers,
                                            check_parallel_cfg,
                                            current_world, parallel_layout,
                                            shard_rows)
from esrnerf_tpu_torch.utils import checkpoint as ckpt_io
from esrnerf_tpu_torch.utils import png
from esrnerf_tpu_torch.utils import profiling
from esrnerf_tpu_torch.utils.logging import Logger, tqdm_safe
from esrnerf_tpu_torch.utils.metrics import loss2psnr, rgb_lpips, rgb_ssim


def import_class(class_path: str) -> Any:
    module_name, cls_name = class_path.rsplit(".", 1)
    module = __import__(module_name, fromlist=[cls_name])
    return getattr(module, cls_name)


def tree_leaves(tree, prefix=()) -> List[Tuple[tuple, torch.Tensor]]:
    """``(path, tensor)`` for every leaf of a nested dict."""
    if isinstance(tree, dict):
        out = []
        for k, v in tree.items():
            out += tree_leaves(v, prefix + (k,))
        return out
    return [(prefix, tree)]


def tree_unflatten(paths, values) -> Dict:
    out: Dict = {}
    for path, v in zip(paths, values):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return out


def loss_and_grads(loss_fn: Callable, params, tag: str,
                   sh: Optional[ShardHelpers] = None,
                   layout: Optional[ParamLayout] = None):
    """``loss_fn(p) -> (loss, aux)`` on a differentiable copy of the
    parameter tree; returns ``(aux, grads)`` with ``grads`` shaped like
    ``params`` (zeros where a leaf got no gradient). The loss and the
    backward run inside the spans ``<tag>/loss`` and ``<tag>/backward``;
    where ``loss_fn`` marks its phases (:func:`~esrnerf_tpu_torch.utils.
    profiling.bwd_mark`), a profiled backward is split into the ranges
    ``<tag>/bwd_<phase>``, the loss terms' as ``<tag>/bwd_loss``. On a
    world of ranks (``sh``) the gradients are then
    summed over the ranks (``<tag>/grad_allreduce``): ``loss_fn`` folds its
    terms with ``sh`` (recipe B), so the sum is the global gradient.

    With a ``layout`` whose leaves are X-slabs (``fsdp``), ``loss_fn``
    sees the whole grids (``<tag>/all_gather``), the backward
    reduce-scatters their gradients to the slabs, and only the replicated
    leaves go through the all-reduce."""
    flat = tree_leaves(params)
    paths = [p for p, _ in flat]
    leaves = [t.detach().requires_grad_(True) for _, t in flat]
    slabs = [i for i, p in enumerate(paths)
             if layout is not None and p in layout.paths]
    inputs = list(leaves)
    if slabs:
        with profiling.span(f"{tag}/all_gather"):
            whole = layout.gather_for_grad([leaves[i] for i in slabs])
        for i, w in zip(slabs, whole):
            inputs[i] = w
    with profiling.span(f"{tag}/loss"), \
            profiling.split_backward(tag) as split:
        loss, aux = loss_fn(tree_unflatten(paths, inputs))
        if split is not None and split.phases:
            loss = profiling.bwd_mark("loss", loss)
    with profiling.span(f"{tag}/backward"):
        gl = torch.autograd.grad(loss, leaves, allow_unused=True)
        if split is not None:
            split.close()
    gl = [torch.zeros_like(t) if g is None else g for t, g in zip(leaves, gl)]
    if sh is not None and sh.n > 1:
        with profiling.span(f"{tag}/grad_allreduce"):
            sh.all_reduce_grads({i: g for i, g in enumerate(gl)
                                 if i not in slabs})
    return aux, tree_unflatten(paths, gl)


def gathers_params(state: bool = False) -> Callable:
    """Decorator: the method runs inside :meth:`AppClass.whole_params` (an
    eval, a regroup or, with ``state``, a checkpoint reads the whole
    grids)."""

    def deco(method: Callable) -> Callable:
        @functools.wraps(method)
        def wrapped(self, *args, **kw):
            with self.whole_params(state):
                return method(self, *args, **kw)

        return wrapped

    return deco


def composite_white_bg(imgs: Dict[str, np.ndarray],
                       white_bg: float) -> Dict[str, np.ndarray]:
    """Every render plus ``etc/white_bg * white_bg``, clipped to [0, 1];
    ``etc/white_bg`` itself only clipped."""
    wbg = imgs["etc/white_bg"] * white_bg
    out = {}
    for k, v in imgs.items():
        if k == "etc/white_bg":
            out[k] = np.clip(v, 0.0, 1.0)
        else:
            out[k] = np.clip(v + (wbg[..., None] if v.ndim == 3 else wbg),
                             0.0, 1.0)
    return out


def srgb_metrics(metrics: Dict[str, List], pred: np.ndarray,
                 rgbs: np.ndarray) -> None:
    """Append the image's sRGB MSE, PSNR, SSIM and LPIPS (alex)."""
    mse = float(((pred - rgbs) ** 2).mean())
    metrics.setdefault("srgb/MSE", []).append(mse)
    metrics.setdefault("srgb/PSNR", []).append(loss2psnr(mse))
    metrics.setdefault("srgb/SSIM", []).append(rgb_ssim(pred, rgbs, 1))
    metrics.setdefault("srgb/LPIPS_ALEX", []).append(
        rgb_lpips(rgbs, pred, "alex"))


class AppClass:
    def __init__(self, cfg):
        self.cfg = cfg
        self.phase = cfg.app["phase"]
        self.white_bg = float(cfg.data["white_bg"])
        self.global_step = int(cfg.get("global_step", 0))
        self.logger: Optional[Logger] = None
        self.world = current_world(cfg)
        check_parallel_cfg(cfg, self.world.n)
        self.device = self.world.device
        mode, shard = parallel_layout(cfg)
        self._sh = ShardHelpers(self.world.n, self.world.rank,
                                backend=self.world.backend,
                                gspmd=mode == "gspmd")
        # fsdp under gspmd only: shard_map keeps the parameters replicated
        self.layout = ParamLayout(self._sh,
                                  fsdp=shard == "fsdp" and mode == "gspmd")
        self._whole: set = set()  # what whole_params has gathered
        # wall-clock seconds of the last eval, mesh and checkpoint
        self.timings: Dict[str, float] = {}

    # -------------------------------------------------------------- contract

    def load_dataset(self) -> None:
        raise NotImplementedError

    def load_model(self) -> None:
        raise NotImplementedError

    def process(self) -> None:
        raise NotImplementedError

    # --------------------------------------------------------------- helpers

    @property
    def pretty_global_step(self) -> str:
        return f"{self.global_step:010}"

    # ---------------------------------------------------------- parallelism

    @property
    def parallel_mode(self) -> str:
        """'single' (one rank), or on data-parallel ranks
        ``system.parallel``: 'shard_map' or 'gspmd'."""
        return ("single" if self.world.n == 1
                else parallel_layout(self.cfg)[0])

    @property
    def num_shards(self) -> int:
        """The shards a step's LTS point selection is split into: the
        world under ``shard_map``, 1 under ``gspmd`` (world 1's choice),
        as the JAX package's. The ranks split the rows in both
        (``world.n``)."""
        return self.world.n if self.parallel_mode == "shard_map" else 1

    @property
    def is_writer(self) -> bool:
        """Rank 0 writes logs, checkpoints and eval files."""
        return self.world.is_writer

    def shard_helpers(self) -> ShardHelpers:
        """The cross-rank reductions of the train-step bodies (the identity
        at world 1)."""
        return self._sh

    def check_shardable(self, batch_size: int) -> None:
        """Under ``shard_map`` a batch must divide the world (``gspmd``
        passes, as the JAX package's; :meth:`place_batch` still refuses
        rows that do not divide)."""
        if self.parallel_mode == "shard_map" and batch_size % self.num_shards:
            raise ValueError(
                f"batch_size={batch_size} not divisible by "
                f"{self.num_shards} shards; adjust app.trainer.batch_size "
                "or set system.parallel=gspmd")

    def place_params(self) -> None:
        """Parameters, Adam moments and a per-voxel LR (``per_lr``, where
        the stage has one) as the layout keeps them: replicated, or under
        ``fsdp`` each dividing grid as the rank's X-slab (the JAX package's
        ``place_replicated``). A trainer calls it once its whole tree is
        loaded (fresh, resumed or from the previous stage) and again after
        a rescale."""
        self.params = self.layout.place(self.params)
        if getattr(self, "opt_state", None) is not None:
            self.opt_state = self.layout.place_state(self.opt_state)
        if getattr(self, "per_lr", None) is not None:
            self.per_lr = self.layout.slice(self.per_lr)

    @contextlib.contextmanager
    def whole_params(self, state: bool = False):
        """Context: ``params`` and, with ``state``, ``opt_state`` and
        ``per_lr`` gathered into whole grids (under ``fsdp``; else as they
        are), the rank's slabs back on exit. An eval, a mesh or a regroup
        runs inside it, a checkpoint with ``state``; every rank enters it
        (the gathers are collectives). A nested use gathers only what the
        outer one left out."""
        names = [k for k in ("params",) + (("opt_state", "per_lr") if state
                                           else ())
                 if getattr(self, k, None) is not None
                 and k not in self._whole]
        if not self.layout.paths or not names:
            yield
            return
        keep = {k: getattr(self, k) for k in names}
        for k in names:
            gather = (self.layout.gather_state if k == "opt_state"
                      else self.layout.gather)
            setattr(self, k, gather(keep[k]))
        self._whole |= set(names)
        try:
            yield
        finally:
            self._whole -= set(names)
            for k, v in keep.items():
                setattr(self, k, v)

    def to_device(self, array) -> torch.Tensor:
        """Host array -> tensor on the device. On CUDA it goes through
        pinned memory with a non-blocking copy, so the host never waits on
        the stream for it. A tensor is moved as it is."""
        if isinstance(array, torch.Tensor):
            return array.to(self.device)
        t = torch.from_numpy(np.ascontiguousarray(array))
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def place_batch(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """A host batch on the device: the rank's contiguous block of its
        rows on a world of ranks (every rank samples the same global
        batch). Rows that do not divide the world raise ``ValueError``
        under either layout. Runs in the span ``data/place``."""
        n, r = self.world.n, self.world.rank
        with profiling.span("data/place"):
            return {k: self.to_device(shard_rows(v, r, n))
                    for k, v in batch.items()}

    def place_ray_chunk(self, *arrays) -> Tuple[List[torch.Tensor], bool]:
        """``(tensors on the device, split)`` for one eval chunk (leading dim
        = rays or points): the rank's block of the rows when every array's
        rows divide over the ranks, else the whole chunk on every rank (a
        ragged tail)."""
        n, r = self.world.n, self.world.rank
        split = n > 1 and all(a.shape[0] % n == 0 for a in arrays)
        return ([self.to_device(shard_rows(a, r, n) if split else a)
                 for a in arrays], split)

    def gather_rows(self, out: Dict[str, torch.Tensor],
                    split: bool) -> Dict[str, torch.Tensor]:
        """The outputs of a split chunk put back together on every rank:
        each row output gathered in rank order, each 0-d output (an
        overflow) the maximum over the ranks."""
        if not split:
            return out
        sh = self._sh
        return {k: sh.gmax(v) if v.dim() == 0 else sh.gather_rows(v)
                for k, v in out.items()}

    def run_chunk(self, fn: Callable, *arrays) -> Dict[str, torch.Tensor]:
        """``fn(*tensors) -> {name: rows or 0-d}`` over one eval chunk,
        data-parallel (:meth:`place_ray_chunk`, :meth:`gather_rows`).
        ``fn`` runs on the rank alone (no collective inside it, so its
        retries may differ between ranks); every rank gets every row."""
        args, split = self.place_ray_chunk(*arrays)
        return self.gather_rows(fn(*args), split)

    def scaled_budgets(self, scale: int):
        """Context: the marches' compaction budgets (primary, and the
        secondary march's where the renderer has one) multiplied by
        ``scale`` on the live renderer."""

        @contextlib.contextmanager
        def cm():
            names = ("points_per_ray", "points_per_ray_masked",
                     "points_per_2ndray", "points_per_2ndray_masked")
            objs = [self.renderer, getattr(self.renderer, "geo", None)]
            saved = []
            for o in objs:
                for nm in names:
                    if o is not None and nm in vars(o):
                        saved.append((o, nm, getattr(o, nm)))
                        setattr(o, nm, int(getattr(o, nm)) * scale)
            try:
                yield
            finally:
                for o, nm, v in saved:
                    setattr(o, nm, v)

        return cm()

    def eval_chunk_retry(self, fwd, *args, max_scale=4):
        """Run one eval chunk; on march-budget overflow run it again with
        the budgets x2, then x4, instead of rendering it truncated. Past
        ``max_scale`` the chunk renders truncated and the worst overflow is
        kept for :meth:`pop_eval_truncation`. The returned dict still
        carries ``etc/overflow``. Counts ``eval.chunks`` once a call and
        ``eval.retries`` once a re-march; the host's wait on the overflow
        is the span ``eval/overflow_wait``."""
        profiling.count("eval.chunks")
        scale = 1
        while True:
            with self.scaled_budgets(scale):
                out = fwd(*args)
            ovf = out.get("etc/overflow")
            if ovf is None:
                return out
            with profiling.span("eval/overflow_wait"):
                clean = float(ovf) <= 0.0
            if clean:
                return out
            if scale >= max_scale:
                v = float(ovf)
                self._eval_trunc_frac = max(
                    getattr(self, "_eval_trunc_frac", 0.0), v)
                if not getattr(self, "_trunc_warned", False):
                    warnings.warn(
                        f"eval chunk still overflows {v:.4f} at the max "
                        f"budget scale x{max_scale} — rendering truncated; "
                        "raise app.model.points_budget_* for this scene")
                    self._trunc_warned = True
                return out
            scale *= 2
            profiling.count("eval.retries")

    def pop_eval_truncation(self) -> float:
        """Worst truncated-overflow fraction since the last call (0.0 when
        every chunk rendered in full)."""
        v = getattr(self, "_eval_trunc_frac", 0.0)
        self._eval_trunc_frac = 0.0
        return v

    def track_overflow(self, ovf) -> float:
        """March budget overflow (fraction of surviving samples dropped);
        warns the first time it is above 0."""
        v = float(ovf)
        if v > 0.0 and not getattr(self, "_overflow_warned", False):
            warnings.warn(
                f"[{type(self).__name__} step {getattr(self, 'global_step', '?')}] "
                f"march overflow {v:.4f}: points_budget_* too small for "
                "this scene — surviving samples are being dropped and PSNR "
                "will silently degrade; raise app.model.points_budget_per_ray"
            )
            self._overflow_warned = True
        return v

    def maybe_autotune_budgets(self, fracs: dict) -> bool:
        """One-shot march-budget resize from the first measured step's
        utilisation (``etc/k*_frac``), with ``app.model.budget_autotune``:
        each budget moves toward ``budget_autotune_target`` utilisation
        (default 0.65), K1-type budgets in whole phase-1 blocks; growth is
        bounded by 1/target and a shrink keeps at least two blocks. Keys
        ``k1`` and ``k2`` (primary march), and ``k1_2nd`` and ``k2_2nd``
        (the ESRNeRF secondary march). Returns True if a budget changed;
        the next march call uses it."""
        m = self.cfg.app["model"]
        if not m.get("budget_autotune", False) or getattr(
                self, "_budgets_tuned", False):
            return False
        self._budgets_tuned = True
        target = float(m.get("budget_autotune_target", 0.65))
        model = self.renderer
        geo = getattr(model, "geo", model)
        blk = max(1, int(getattr(geo, "phase1_block", 1)))

        def size(old, frac, mult, lo):
            if not np.isfinite(frac) or frac <= 0:
                return max(lo, mult)
            new = math.ceil(old * min(frac, 1.0) / target / mult) * mult
            return max(lo, new)

        plan = [
            ("k1", geo, "points_per_ray_masked", blk, 2 * blk),
            ("k2", geo, "points_per_ray", 4, 4),
        ]
        if hasattr(model, "points_per_2ndray"):
            plan += [
                ("k1_2nd", model, "points_per_2ndray_masked", blk, 2 * blk),
                ("k2_2nd", model, "points_per_2ndray", 4, 4),
            ]
        changed = []
        for key, obj, attr, mult, lo in plan:
            if key not in fracs:
                continue
            old = int(getattr(obj, attr))
            new = size(old, float(fracs[key]), mult, lo)
            if new != old:
                setattr(obj, attr, new)
                changed.append(f"{attr} {old}->{new}")
        if changed:
            print("[budget autotune] " + ", ".join(changed)
                  + f" (target {target:.2f} utilization)")
        return bool(changed)

    def get_logger(self) -> Logger:
        """The run's logger; silent on ranks other than 0."""
        if self.logger is None:
            self.logger = Logger(self.cfg, enabled=self.is_writer)
        return self.logger

    def ckpt_dir(self) -> str:
        """The checkpoint dir, with a ``checkpoints`` symlink to it in the
        log dir (made by rank 0)."""
        link = os.path.join(self.cfg.log["dir"], "checkpoints")
        real = os.path.abspath(self.cfg.log["ckpt_dir"])
        if not self.is_writer:
            return real
        os.makedirs(real, exist_ok=True)
        if not os.path.exists(link):
            os.makedirs(os.path.dirname(link), exist_ok=True)
            try:
                os.symlink(real, link, target_is_directory=True)
            except OSError:
                pass
        return real

    def resolve_train_ckpt(self) -> tuple:
        """(ckpt_path or None, is_resume): this run's last.ckpt first, else
        the configured ``app.trainer.ckpt``."""
        last = os.path.join(self.cfg.log["dir"], "checkpoints", "last.ckpt")
        if os.path.exists(last):
            return last, True
        cand = self.cfg.app["trainer"].get("ckpt")
        if cand and os.path.exists(cand):
            return cand, False
        return None, False

    def prev_stage_ckpt(self) -> str:
        """The previous stage's ``last.ckpt``: this run's checkpoint path
        with the stage class name (``STAGE_CLS``, part of the log group)
        replaced by the previous stage's (``PREV_CLS``)."""
        cand = os.path.join(
            self.cfg.log["dir"], "checkpoints", "last.ckpt"
        ).replace(self.STAGE_CLS, self.PREV_CLS)
        if not os.path.exists(cand):
            raise FileNotFoundError(
                f"{self.STAGE_CLS} needs the previous-stage ckpt "
                f"(looked at {cand}); pass app.trainer.ckpt explicitly")
        return cand

    def save_timed(self, path: str, payload: Dict[str, Any]) -> None:
        """Write a checkpoint (rank 0; every rank waits for it, so a resume
        on any rank finds the file); its seconds and bytes go to
        ``timings`` and the log."""
        if self.is_writer:
            t0 = time.perf_counter()
            ckpt_io.save_checkpoint(path, payload)
            self.timings["ckpt_s"] = time.perf_counter() - t0
            self.timings["ckpt_bytes"] = os.path.getsize(path)
            self.get_logger().log({f"train/metric/etc/{k}": v
                                   for k, v in self.timings.items()
                                   if k.startswith("ckpt")},
                                  step=self.global_step)
        self._sh.barrier()

    def render_image(self, data: Dict[str, np.ndarray],
                     keys: Sequence[str], fwd: Callable) -> Dict[str, np.ndarray]:
        """One test image through ``fwd(*chunk)`` in chunks of
        ``eval_bs`` rays, where ``chunk`` holds the image's ``keys`` on the
        device (the rank's block of them, :meth:`run_chunk`). Returns each
        output as an ``[H, W]`` or ``[H, W, C]`` array; an ``etc/overflow``
        output is tracked and left out."""
        width, height = self.test_dataset.image_size
        n = len(data["rgbs"])
        results: Dict[str, List[np.ndarray]] = {}
        for st in range(0, n, self.eval_bs):
            en = min(st + self.eval_bs, n)
            out = self.run_chunk(fwd, *(data[k][st:en] for k in keys))
            ovf = out.pop("etc/overflow", None)
            if ovf is not None:
                self.track_overflow(ovf)
            for k, v in out.items():
                results.setdefault(k, []).append(v.cpu().numpy())

        def to_img(chunks):
            a = np.concatenate(chunks, 0).reshape(height, width, -1)
            return a[..., 0] if a.shape[-1] == 1 else a

        return {k: to_img(v) for k, v in results.items()}

    def resolve_eval_ckpt(self) -> str:
        """``app.eval.ckpt``, else the last.ckpt next to the config file
        the run was started from."""
        ckpt = self.cfg.app["eval"].get("ckpt")
        if ckpt is None:
            cn = self.cfg.get("__config_name__", "")
            ckpt = str(os.path.join(os.path.dirname(cn), "checkpoints",
                                    "last.ckpt"))
        if not os.path.exists(ckpt):
            raise FileNotFoundError(f"wrong ckpt path: {ckpt}")
        return ckpt

    def eval_dirs(self) -> Dict[str, str]:
        """The eval's ``text/ image/ video/ mesh/`` dirs (made by rank
        0)."""
        dirs = {}
        for kind in ("text", "image", "video", "mesh"):
            d = os.path.join(self.cfg.log["dir"], kind, self.pretty_global_step)
            if self.is_writer:
                os.makedirs(d, exist_ok=True)
            dirs[kind] = d
        return dirs

    def eval_img_idxes(self, n_images: int, N_vis: int) -> np.ndarray:
        """Eval image subsample: all images, or about ``N_vis`` of them."""
        if N_vis > 0:
            interval = max(1, n_images // math.ceil(N_vis / 2))
            return np.sort(np.concatenate(
                [np.arange(0, n_images, interval),
                 np.arange(1, n_images, interval)]))
        return np.arange(0, n_images)

    def save_renders(
        self,
        dirs: Dict[str, str],
        renders: Dict[str, List[np.ndarray]],
        metrics: Dict[str, List[float]],
    ) -> None:
        """One PNG per image per key, one video per key where imageio
        imports, and ``mean.txt`` with the metrics' means and per-image
        rows (rank 0)."""
        if not self.is_writer:
            return
        for k, v in renders.items():
            rdir = os.path.join(dirs["image"], *k.split("/"))
            os.makedirs(rdir, exist_ok=True)
            for i, img in enumerate(v):
                png.write(os.path.join(rdir, f"{i:03d}.png"), img)

        vids = self._write_videos(dirs, renders)
        # still-image mirror: first/middle/last frame (the video has all)
        def _sample(v):
            idx = sorted({0, len(v) // 2, len(v) - 1}) if len(v) else []
            return [v[i] for i in idx]

        self.get_logger().log_media(
            step=self.global_step,
            images={f"{self.phase}/image/{k}": _sample(v)
                    for k, v in renders.items()},
            videos=vids,
        )

        with open(os.path.join(dirs["text"], "mean.txt"), "w") as f:
            ks = sorted(metrics.keys())
            # None marks rows where a metric does not apply: skipped in the
            # means, written as "-" per image
            def mean_of(k):
                vals = [x for x in metrics[k] if x is not None]
                return float(np.mean(vals)) if vals else float("nan")

            f.write("Image metrics: \n"
                    + ", ".join(f"{k}: {mean_of(k)}" for k in ks) + "\n")
            n = len(next(iter(metrics.values()))) if metrics else 0
            for i in range(n):
                f.write(f"Index {i}, " + ", ".join(
                    f"{k}: " + ("-" if metrics[k][i] is None
                                else f"{float(metrics[k][i])}")
                    for k in ks) + "\n")

    def _write_videos(self, dirs, renders) -> Dict[str, str]:
        """mp4 (or gif) per render key through imageio; without imageio
        one line says the videos were skipped."""
        try:
            import imageio.v2 as imageio
        except ImportError:
            print("[eval] imageio is not installed: videos skipped "
                  "(the PNGs are written)")
            return {}
        vids = {}
        for k, v in renders.items():
            parts = k.split("/")
            vdir = os.path.join(dirs["video"], *parts[:-1])
            os.makedirs(vdir, exist_ok=True)
            path = os.path.join(vdir, f"{parts[-1]}.mp4")
            try:
                imageio.mimwrite(path, v, fps=30, codec="h264", quality=10)
            except Exception:  # no h264 encoder: a gif instead
                path = os.path.join(vdir, f"{parts[-1]}.gif")
                imageio.mimwrite(path, v, fps=30)
            vids[f"{self.phase}/video/{k}"] = path
        return vids

    def log_eval(self, prefix: str, metrics: Dict[str, List[float]]) -> None:
        # None entries mark images where a metric does not apply
        logs = {}
        for k, v in metrics.items():
            vals = [x for x in v if x is not None]
            if vals:
                logs[prefix + "metric/" + k] = float(np.mean(vals))
        self.get_logger().log(logs, step=self.global_step)

    def tqdm(self, it, **kw):
        return tqdm_safe(it, self.cfg, **kw)
