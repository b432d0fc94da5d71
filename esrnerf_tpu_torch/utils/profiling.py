"""Tracing and profiling hooks. Port of ``esrnerf_tpu/utils/profiling.py``.

A step timer that reports steps/s and rays/s over a sliding window, and an
optional ``torch.profiler`` trace of a window of steps, set by the config
keys ``system.profile_dir``, ``system.profile_from`` and
``system.profile_steps`` (as the JAX package's ``jax.profiler`` capture).
No trainer calls either; a caller ticks and steps them itself.
"""

from __future__ import annotations

import os
import time
from collections import deque
from typing import Dict, Optional

import torch


class StepTimer:
    """Sliding-window throughput counter. Call ``tick(n_rays)`` once per
    completed step (after synchronising on its result)."""

    def __init__(self, window: int = 50):
        self.window = window
        self.times: deque = deque(maxlen=window + 1)
        self.rays: deque = deque(maxlen=window)
        self.times.append(time.perf_counter())

    def tick(self, n_rays: int) -> None:
        self.times.append(time.perf_counter())
        self.rays.append(n_rays)

    def stats(self) -> Dict[str, float]:
        if len(self.times) < 2:
            return {"steps_per_sec": 0.0, "rays_per_sec": 0.0}
        dt = self.times[-1] - self.times[0]
        n = len(self.times) - 1
        return {
            "steps_per_sec": n / dt if dt > 0 else 0.0,
            "rays_per_sec": sum(self.rays) / dt if dt > 0 else 0.0,
        }


class TraceCapture:
    """A ``torch.profiler`` trace of steps ``[start, start + n)`` of a run,
    written as a Chrome trace (``trace_<start>.json``) into ``profile_dir``.

    Enable through the config: ``system.profile_dir=<dir>
    system.profile_from=100 system.profile_steps=5``; call :meth:`step`
    with the global step before each step runs, and :meth:`close` at the
    end. Open the trace in ``chrome://tracing`` or Perfetto. The device's
    kernels are traced where CUDA is available, the host's ops always.
    """

    def __init__(self, cfg):
        sysc = cfg.get("system", {}) or {}
        self.dir: Optional[str] = sysc.get("profile_dir")
        self.start = int(sysc.get("profile_from", 10))
        self.n = int(sysc.get("profile_steps", 5))
        self.path: Optional[str] = None
        self._prof = None

    def step(self, global_step: int) -> None:
        if self.dir is None:
            return
        if global_step == self.start and self._prof is None:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=acts)
            self._prof.start()
        elif self._prof is not None and global_step >= self.start + self.n:
            self._stop()

    def _stop(self) -> None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._prof.stop()
        os.makedirs(self.dir, exist_ok=True)
        self.path = os.path.join(self.dir, f"trace_{self.start}.json")
        self._prof.export_chrome_trace(self.path)
        self._prof = None
        print(f"[profile] trace written to {self.path}")

    def close(self) -> None:
        if self._prof is not None:
            self._stop()
