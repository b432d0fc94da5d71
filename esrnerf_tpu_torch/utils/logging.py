"""Scalar and media logging with optional wandb, console progress, and
seeding.

Port of ``esrnerf_tpu/utils/logging.py``. Scalars always land in
``metrics.jsonl`` under the log dir; when wandb imports and ``log.offline``
is unset they also go to wandb, with eval media. Media are written to disk
by the trainers either way (``text/``, ``image/``, ``video/``, ``mesh/``).
On a world of data-parallel ranks, rank 0 logs and shows the progress bar;
the other ranks' loggers and bars are silent.
"""

from __future__ import annotations

import json
import os
import random
import sys
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

try:  # pragma: no cover - environment dependent
    import wandb as _wandb
except Exception:  # noqa: BLE001
    _wandb = None


def _is_rank0() -> bool:
    import torch.distributed as dist

    return not (dist.is_available() and dist.is_initialized()) \
        or dist.get_rank() == 0


class Logger:
    """Scalar/media logger. One instance per run; with ``enabled`` False
    (a rank other than 0) it opens nothing and writes nothing."""

    def __init__(self, cfg, enabled: bool = True):
        self.cfg = cfg
        self.dir = cfg.log["dir"]
        self._jsonl = None
        self._wandb_run = None
        if not enabled:
            return
        os.makedirs(self.dir, exist_ok=True)
        self._jsonl = open(os.path.join(self.dir, "metrics.jsonl"), "a")
        if _wandb is not None and not cfg.log.get("offline", False):
            try:
                self._wandb_run = _wandb.init(
                    entity=cfg.log.get("entity"),
                    project=cfg.log.get("project"),
                    group=cfg.log.get("group"),
                    name=cfg.log.get("name"),
                    job_type=cfg.app.get("phase"),
                    dir=self.dir,
                    config=cfg.to_dict(),
                    resume="auto",
                )
            except Exception as e:  # noqa: BLE001
                print(f"wandb init failed ({e!r}); logging to JSONL only")

    def log(self, scalars: Dict[str, Any], step: int) -> None:
        if self._jsonl is None:
            return
        clean = {
            k: float(v)
            for k, v in scalars.items()
            if isinstance(v, (int, float, np.floating, np.integer))
        }
        rec = {"step": int(step), "t": time.time(), **clean}
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()
        if self._wandb_run is not None:
            self._wandb_run.log(clean, step=step)

    def log_media(
        self,
        step: int,
        images: Optional[Dict[str, Any]] = None,
        videos: Optional[Dict[str, str]] = None,
    ) -> None:
        """Push eval media to wandb when live: ``images`` key -> uint8 HWC
        array (or a list of them), ``videos`` key -> path of a video."""
        if self._wandb_run is None:
            return
        payload: Dict[str, Any] = {}
        for k, v in (images or {}).items():
            imgs = v if isinstance(v, (list, tuple)) else [v]
            payload[k] = [_wandb.Image(np.asarray(im)) for im in imgs]
        for k, path in (videos or {}).items():
            if os.path.exists(path):
                payload[k] = _wandb.Video(path)
        if payload:
            self._wandb_run.log(payload, step=step)

    def finish(self) -> None:
        if self._jsonl is not None:
            self._jsonl.close()
        if self._wandb_run is not None:
            self._wandb_run.finish()


def tqdm_safe(iterator, cfg=None, **kwargs):
    """tqdm progress over ``iterator`` honouring ``system.debug`` (no bar)
    and ``system.tqdm_iters``; the bare iterator when tqdm is missing or on
    a rank other than 0."""
    debug = bool(cfg and cfg.get_path("system.debug"))
    if debug or not _is_rank0():
        return iterator
    try:
        from tqdm.auto import tqdm
    except Exception:  # noqa: BLE001
        return iterator
    miniters = cfg.get_path("system.tqdm_iters", 10) if cfg else 10
    return tqdm(iterator, miniters=miniters, file=sys.stdout,
                dynamic_ncols=True, **kwargs)


def seed_everything(seed: int) -> None:
    """Seed Python's ``random``, numpy's global generator and torch (all
    devices). The trainers also draw from explicit generators made from
    the same seed."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)
