"""Tracing and profiling hooks: the port's spans and counters, the backward
split by forward phase, and a ``torch.profiler`` trace of a window of steps.

:func:`span` times a phase on the host clock into an in-memory record (per
name: the count, the total and a ring of the last :data:`RING` durations)
and, only while a torch profiler records, also opens a ``record_function``
range of the same name, so the trace puts the device's operations under it.
With no profiler recording a span costs about a microsecond (a bare
``record_function`` ten). :func:`count` adds to a host-side counter;
:func:`snapshot` reads both, :func:`reset` clears them, and
:class:`HostMs` exports each span's mean host ms between two reads (the
trainers log it as ``etc/host_ms/<span>``). No span or counter synchronises
the device, allocates on it or launches anything.

The autograd engine runs a backward from its own thread, as one range on
the caller's. :func:`split_backward` and :func:`bwd_mark` name its parts:
a forward marks the tensors at its phase boundaries, and in the backward
each mark closes the range of the phase after it and opens
``<tag>/bwd_<phase>``. Marks exist only while a profiler records; with none
the autograd graph is the unmarked one.

:class:`TraceCapture` writes a Chrome trace of steps ``system.profile_from``
.. ``+ system.profile_steps`` into ``system.profile_dir``; every stage's
``learn`` steps it.
"""

from __future__ import annotations

import contextlib
import contextvars
import os
import threading
import time
from collections import deque
from typing import Dict, Iterator, List, Optional, Tuple

import torch
import torch.autograd.profiler as _autograd_profiler

RING = 4096  # durations kept per span name


class _Record:
    """Per span name ``[count, total ns, ring of ns]``, and the counters."""

    def __init__(self):
        self.lock = threading.Lock()
        self.spans: Dict[str, list] = {}
        self.counters: Dict[str, float] = {}

    def add(self, name: str, ns: int) -> None:
        with self.lock:
            s = self.spans.get(name)
            if s is None:
                s = self.spans[name] = [0, 0, deque(maxlen=RING)]
            s[0] += 1
            s[1] += ns
            s[2].append(ns)

    def count(self, name: str, n: float) -> None:
        with self.lock:
            self.counters[name] = self.counters.get(name, 0) + n

    def totals(self) -> Dict[str, Tuple[int, int]]:
        with self.lock:
            return {k: (s[0], s[1]) for k, s in self.spans.items()}


_RECORD = _Record()


def profiler_on() -> bool:
    """Whether a torch profiler records (torch's own flag)."""
    return _autograd_profiler._is_profiler_enabled


class span:
    """Context manager: the block's host duration into the record under
    ``name`` and, while a profiler records, a ``record_function`` range of
    that name around it."""

    __slots__ = ("name", "t0", "rf")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> "span":
        self.rf = None
        if _autograd_profiler._is_profiler_enabled:
            self.rf = _autograd_profiler.record_function(self.name)
            self.rf.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        _RECORD.add(self.name, time.perf_counter_ns() - self.t0)
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
            self.rf = None


def count(name: str, n: float = 1) -> None:
    """Add ``n`` to the host-side counter ``name``."""
    _RECORD.count(name, n)


def snapshot() -> dict:
    """``{"spans": {name: {"count", "total_ns", "ns": [last durations]}},
    "counters": {name: value}}``, a copy."""
    with _RECORD.lock:
        return {"spans": {k: {"count": s[0], "total_ns": s[1],
                              "ns": list(s[2])}
                          for k, s in _RECORD.spans.items()},
                "counters": dict(_RECORD.counters)}


def reset() -> None:
    """Clear every span's record and every counter."""
    with _RECORD.lock:
        _RECORD.spans.clear()
        _RECORD.counters.clear()


class HostMs:
    """Each span's mean host ms over its calls since the last :meth:`read`
    (since construction at first), keyed ``etc/host_ms/<span>``."""

    def __init__(self):
        self.last = _RECORD.totals()

    def read(self) -> Dict[str, float]:
        now = _RECORD.totals()
        out = {}
        for k, (n, ns) in now.items():
            n0, ns0 = self.last.get(k, (0, 0))
            if n > n0:
                out[f"etc/host_ms/{k}"] = (ns - ns0) / (n - n0) / 1e6
        self.last = now
        return out


# ----------------------------------------------- the backward by forward phase


class _Split:
    """The ranges ``<tag>/bwd_<phase>`` of one backward. Marks are indexed
    in the order the forward made them; the backward meets them in reverse
    (the engine runs the ready node of the highest sequence number first,
    so every node made after a mark runs before it), and a mark opens its
    phase only when it comes before every phase opened so far."""

    def __init__(self, tag: str):
        self.tag = tag
        self.phases: List[Optional[str]] = []
        self.at: Optional[int] = None
        self.open: Optional[span] = None

    def enter(self, idx: int) -> None:
        if self.at is not None and idx >= self.at:
            return
        self.at = idx
        self.close()
        phase = self.phases[idx]
        if phase is not None:
            self.open = span(f"{self.tag}/bwd_{phase}")
            self.open.__enter__()

    def close(self) -> None:
        if self.open is not None:
            self.open.__exit__(None, None, None)
            self.open = None


class _Mark(torch.autograd.Function):
    """Identity on views of its tensors; its backward switches the split's
    range and passes the gradients through untouched."""

    @staticmethod
    def forward(ctx, split, idx, *xs):
        ctx.split, ctx.idx = split, idx
        ctx.set_materialize_grads(False)
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        ctx.split.enter(ctx.idx)
        return (None, None, *grads)


_SPLIT: contextvars.ContextVar = contextvars.ContextVar("split",
                                                       default=None)


@contextlib.contextmanager
def split_backward(tag: str) -> Iterator[Optional[_Split]]:
    """Context of a forward whose backward is split by phase: inside it
    :func:`bwd_mark` marks tensors for the ranges ``<tag>/bwd_<phase>``.
    Yields the split, or None where no profiler records (marks are then
    no-ops). The caller closes the split once the backward has run."""
    split = _Split(tag) if profiler_on() else None
    token = _SPLIT.set(split)
    try:
        yield split
    finally:
        _SPLIT.reset(token)


def bwd_mark(phase: Optional[str], *xs: torch.Tensor):
    """``xs`` as they are (one tensor, or a tuple of them) or, inside an
    active :func:`split_backward`, as views whose backward opens the range
    ``<tag>/bwd_<phase>`` once every phase made after them has run. Mark a
    phase's outputs where the next phase takes them; ``phase=None`` marks a
    first phase's inputs and closes the last range."""
    split = _SPLIT.get()
    if split is None or not any(x.requires_grad for x in xs):
        return xs[0] if len(xs) == 1 else xs
    split.phases.append(phase)
    out = _Mark.apply(split, len(split.phases) - 1, *xs)
    return out[0] if len(xs) == 1 else out


# ---------------------------------------------------------- the trace capture


class TraceCapture:
    """A ``torch.profiler`` trace of steps ``[start, start + n)`` of a run,
    written as a Chrome trace (``trace_<start>.json``) into ``profile_dir``.

    Enable through the config: ``system.profile_dir=<dir>
    system.profile_from=100 system.profile_steps=5``; call :meth:`step`
    with the global step before each step runs, and :meth:`close` at the
    end. Open the trace in ``chrome://tracing`` or Perfetto. The device's
    kernels are traced where CUDA is available, the host's ops always.
    Without ``profile_dir`` both calls do nothing.
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
