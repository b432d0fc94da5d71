"""Stage-trainer base class for one device.

Port of ``esrnerf_tpu/apps/base.py`` without the mesh and sharding
helpers. A stage owns ``load_dataset() / load_model() / process()`` plus
its train loop, losses, eval and checkpoints. Shared here: the device
(``system.device``: ``cpu``, or else CUDA), batch placement through pinned
host memory, checkpoint path resolution (resume first, then the explicit
checkpoint, then the previous stage's), the eval retry on march-budget
overflow, the one-shot budget autotune, the eval artifact layout (``text/
image/ video/ mesh/`` under the log dir) and media writing.

There is no compile cache: the march reads its budgets from the live
renderer at every call, so a scaled or autotuned budget takes effect on
the next call.
"""

from __future__ import annotations

import contextlib
import math
import os
import warnings
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from esrnerf_tpu_torch.utils import png
from esrnerf_tpu_torch.utils.device import resolve_device
from esrnerf_tpu_torch.utils.logging import Logger, tqdm_safe


def import_class(class_path: str) -> Any:
    module_name, cls_name = class_path.rsplit(".", 1)
    module = __import__(module_name, fromlist=[cls_name])
    return getattr(module, cls_name)


def device_from_cfg(cfg) -> torch.device:
    """``system.device`` ``cpu`` -> the CPU; anything else (``cuda``, the
    JAX configs' ``tpu``, unset) -> CUDA, which raises without a GPU."""
    dev = str(cfg.system.get("device") or "cuda").lower()
    return resolve_device("cpu" if dev.startswith("cpu") else "cuda")


class AppClass:
    def __init__(self, cfg):
        self.cfg = cfg
        self.phase = cfg.app["phase"]
        self.white_bg = float(cfg.data["white_bg"])
        self.global_step = int(cfg.get("global_step", 0))
        self.logger: Optional[Logger] = None
        self.device = device_from_cfg(cfg)

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

    def to_device(self, array: np.ndarray) -> torch.Tensor:
        """Host array -> tensor on the device. On CUDA it goes through
        pinned memory with a non-blocking copy, so the host never waits on
        the stream for it."""
        t = torch.from_numpy(np.ascontiguousarray(array))
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def place_batch(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        return {k: self.to_device(v) for k, v in batch.items()}

    def scaled_budgets(self, scale: int):
        """Context: the march's compaction budgets multiplied by ``scale``
        on the live renderer."""

        @contextlib.contextmanager
        def cm():
            names = ("points_per_ray", "points_per_ray_masked")
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
        carries ``etc/overflow``."""
        scale = 1
        while True:
            with self.scaled_budgets(scale):
                out = fwd(*args)
            ovf = out.get("etc/overflow")
            if ovf is None or float(ovf) <= 0.0:
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
            self._overflow_retries = getattr(self, "_overflow_retries", 0) + 1

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
        ``k1`` and ``k2``. Returns True if a budget changed; the next march
        call uses it."""
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
        if self.logger is None:
            self.logger = Logger(self.cfg)
        return self.logger

    def ckpt_dir(self) -> str:
        """The checkpoint dir, with a ``checkpoints`` symlink to it in the
        log dir."""
        link = os.path.join(self.cfg.log["dir"], "checkpoints")
        real = os.path.abspath(self.cfg.log["ckpt_dir"])
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
        dirs = {}
        for kind in ("text", "image", "video", "mesh"):
            d = os.path.join(self.cfg.log["dir"], kind, self.pretty_global_step)
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
        rows."""
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
