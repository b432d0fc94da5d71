"""Data parallelism over ranks with ``torch.distributed``.

Port of ``esrnerf_tpu/parallel/mesh.py``'s ``shard_map`` path: one process
per rank (``torchrun``), each marching its own contiguous block of the
global ray batch with the renderer's local budgets. Parameters and
optimizer state are replicated; every loss term folds its numerator and
count across ranks ("recipe B", :class:`ShardHelpers`), the gradients are
all-reduced once, and each rank runs the identical Adam step.

    torchrun --standalone --nproc_per_node=N -m esrnerf_tpu_torch.run \\
        -cn <cfg> app.phase=train

Backends: NCCL when every rank has a card of its own (``WORLD_SIZE`` <=
``torch.cuda.device_count()``); gloo when ranks share a card
(``cuda:LOCAL_RANK % count``) or run on the CPU (``system.device=cpu``).
gloo reduces in host memory, so the helpers stage CUDA tensors through
pinned host buffers for it. At world 1 nothing here runs: the helpers are
the identity and no process group exists.

The JAX package's other layouts, ``system.parallel=gspmd`` and
``system.param_shard=fsdp`` (grids and Adam moments sharded over ranks),
are not ported: both raise here (ROADMAP item 18).
"""

from __future__ import annotations

import datetime
import os
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

# seconds a collective may wait for the other ranks before it raises
TIMEOUT_S = 900


@dataclass
class World:
    """This process's place in the run: ``rank`` of ``n`` on ``device``,
    over ``backend`` (None at world 1)."""

    rank: int
    n: int
    device: torch.device
    backend: Optional[str] = None

    @property
    def is_writer(self) -> bool:
        """Rank 0 writes the run's files; the other ranks write nothing."""
        return self.rank == 0


def pad_to_multiple(n: int, m: int) -> int:
    """Smallest multiple of m that is >= n."""
    return ((n + m - 1) // m) * m


def check_parallel_cfg(cfg, n: int) -> None:
    """Refuse the layouts the port has no path for, at a world of ``n``."""
    if n <= 1:
        return
    sysc = cfg.system
    if not tuple(sysc.get("mesh_axes") or ()):
        raise ValueError(
            f"a world of {n} ranks with system.mesh_axes empty: the data "
            "axis is what the ranks split; set system.mesh_axes=[data]")
    mode = str(sysc.get("parallel") or "shard_map")
    if mode != "shard_map":
        raise ValueError(
            f"system.parallel={mode} is not ported to torch.distributed "
            "(ROADMAP item 18); the port's data-parallel path is shard_map")
    if str(sysc.get("param_shard") or "none") == "fsdp":
        raise ValueError(
            "system.param_shard=fsdp (sharded grids and Adam moments) is not "
            "ported to torch.distributed (ROADMAP item 18)")


def _device(cfg, local_rank: int, n: int) -> torch.device:
    dev = str(cfg.system.get("device") or "cuda").lower()
    if dev.startswith("cpu"):
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass system.device=cpu to run the "
            "plain PyTorch versions on the CPU")
    count = torch.cuda.device_count()
    return torch.device("cuda", local_rank % count if n > count
                        else local_rank)


def current_world(cfg) -> World:
    """The world of this process: rank, size and backend of the default
    process group, the device from ``system.device`` and ``LOCAL_RANK``;
    rank 0 of 1 when no process group exists. ``system.device`` ``cpu``
    means the CPU; anything else (``cuda``, the JAX configs' ``tpu``,
    unset) CUDA, which raises without a GPU."""
    if not (dist.is_available() and dist.is_initialized()) \
            or dist.get_world_size() == 1:
        from esrnerf_tpu_torch.utils.device import resolve_device

        dev = str(cfg.system.get("device") or "cuda").lower()
        return World(0, 1, resolve_device("cpu" if dev.startswith("cpu")
                                          else "cuda"))
    rank, n = dist.get_rank(), dist.get_world_size()
    local = int(os.environ.get("LOCAL_RANK", rank))
    return World(rank, n, _device(cfg, local, n), dist.get_backend())


def init_distributed(cfg, timeout_s: float = TIMEOUT_S) -> World:
    """Start the default process group from ``torchrun``'s ``RANK``,
    ``WORLD_SIZE`` and ``LOCAL_RANK`` (``env://`` rendezvous) when
    ``WORLD_SIZE`` > 1 and none exists yet, and return this rank's world.
    NCCL when each rank has a card of its own, else gloo (ranks sharing a
    card, or ``system.device=cpu``). A group that already exists (started
    by the caller) is used as it is."""
    n = int(os.environ.get("WORLD_SIZE", "1"))
    if dist.is_initialized():
        n = dist.get_world_size()
    check_parallel_cfg(cfg, n)
    if n > 1 and not dist.is_initialized():
        rank = int(os.environ["RANK"])
        dev = _device(cfg, int(os.environ.get("LOCAL_RANK", rank)), n)
        nccl = dev.type == "cuda" and n <= torch.cuda.device_count()
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(
            "nccl" if nccl else "gloo", rank=rank, world_size=n,
            timeout=datetime.timedelta(seconds=timeout_s))
    world = current_world(cfg)
    if world.n > 1 and world.device.type == "cuda":
        torch.cuda.set_device(world.device)
    return world


def shard_rows(x, rank: int, n: int):
    """Rank ``rank``'s contiguous block of ``x``'s rows (numpy or torch),
    as ``P("data")`` splits a batch: block ``i`` to rank ``i``, so the
    global last row is on the last rank. ``x`` at world 1 as it is."""
    if n == 1:
        return x
    m = x.shape[0]
    if m % n:
        raise ValueError(f"{m} rows do not divide over {n} ranks")
    b = m // n
    return x[rank * b:(rank + 1) * b]


class ShardHelpers:
    """Cross-rank reductions for a train-step body, the identity at world
    1 (no process group, no launch), so one step body serves both. The
    scheme ("recipe B", as the JAX package's):

    - every data-dependent loss term is ``gsum(numerator) / global count``;
    - parameter-only terms (the density TV) are divided by ``n``, so the
      summed gradient holds them once;
    - :meth:`gsum`'s backward is the identity, so each rank's gradient is
      its local rows' share of the global loss; :meth:`all_reduce_grads`
      sums those shares once after the backward;
    - the optimizer then runs identically on every rank.

    ``group``: the process group (None: the default one); ``backend`` of
    that group. With gloo, CUDA tensors are staged through pinned host
    memory (one reusable buffer per dtype for the gradients)."""

    def __init__(self, n: int = 1, rank: int = 0, group=None,
                 backend: Optional[str] = None):
        self.n, self.rank, self.group = n, rank, group
        self.backend = backend or (dist.get_backend(group) if n > 1
                                   else None)
        self._host: Dict[torch.dtype, torch.Tensor] = {}

    def _staged(self, t: torch.Tensor) -> bool:
        return self.backend == "gloo" and t.is_cuda

    def reduce(self, t: torch.Tensor, op=dist.ReduceOp.SUM) -> torch.Tensor:
        """A new tensor: ``t`` reduced over the ranks with ``op`` (no
        gradient)."""
        t = t.detach()
        if self._staged(t):
            h = t.cpu()
            dist.all_reduce(h, op, group=self.group)
            return h.to(t.device)
        out = t.clone()
        dist.all_reduce(out, op, group=self.group)
        return out

    def gsum(self, x: torch.Tensor) -> torch.Tensor:
        """Cross-rank sum; its gradient is the identity (recipe B: each
        rank's local numerator enters the global sum once). A plain
        ``all_reduce`` inside autograd would give the gradients ``n``
        times too large."""
        if self.n == 1:
            return x
        return _GSum.apply(x, self)

    def gmean(self, x: torch.Tensor) -> torch.Tensor:
        """Global mean of a per-rank tensor (equal-sized blocks); at world 1
        ``x.mean()``."""
        if self.n == 1:
            return x.mean()
        return self.gsum(x.sum()) / (x.numel() * self.n)

    def gmax(self, x: torch.Tensor) -> torch.Tensor:
        """Cross-rank maximum, no gradient."""
        if self.n == 1:
            return x
        return self.reduce(x, dist.ReduceOp.MAX)

    def glast(self, x: torch.Tensor) -> torch.Tensor:
        """The value on the last rank (the global last row's quirks). The
        gradient flows back through the ``where``, so only the last rank's
        carries the term."""
        if self.n == 1:
            return x
        last = torch.tensor(self.rank == self.n - 1, device=x.device)
        return self.gsum(torch.where(last, x, torch.zeros_like(x)))

    def fold_generator(self, device, seed: int, step: int) -> torch.Generator:
        """The rank's generator of a run from ``step`` on: seeded from
        ``(seed, step)`` at world 1, ``(seed, step, rank)`` on a larger
        world, so ranks draw apart."""
        key = [int(seed), int(step)] + ([self.rank] if self.n > 1 else [])
        s = int(np.random.SeedSequence(key).generate_state(1)[0])
        return torch.Generator(device=device).manual_seed(s)

    def all_reduce_grads(self, tree):
        """Sum a gradient tree over the ranks in place with one collective
        per dtype over one flat buffer (not one per leaf: the fine step's
        gradients are 872 MB at 256^3). Returns ``tree``."""
        if self.n == 1:
            return tree
        by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
        for _, g in _leaves(tree):
            by_dtype.setdefault(g.dtype, []).append(g)
        for dtype, leaves in by_dtype.items():
            total = sum(g.numel() for g in leaves)
            staged = self._staged(leaves[0])
            if staged:
                buf = self._host.get(dtype)
                if buf is None or buf.numel() < total:
                    buf = self._host[dtype] = torch.empty(
                        total, dtype=dtype, pin_memory=True)
                flat = buf[:total]
            else:
                flat = torch.empty(total, dtype=dtype,
                                   device=leaves[0].device)
            o = 0
            for g in leaves:
                flat[o:o + g.numel()].copy_(g.reshape(-1),
                                            non_blocking=staged)
                o += g.numel()
            if staged:
                torch.cuda.current_stream(leaves[0].device).synchronize()
            dist.all_reduce(flat, group=self.group)
            o = 0
            for g in leaves:
                g.copy_(flat[o:o + g.numel()].view_as(g), non_blocking=staged)
                o += g.numel()
        return tree

    def gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's block of rows, in rank order (equal-sized blocks),
        on every rank."""
        if self.n == 1:
            return x
        src = x.detach().cpu() if self._staged(x) else x.detach().contiguous()
        parts = [torch.empty_like(src) for _ in range(self.n)]
        dist.all_gather(parts, src, group=self.group)
        return torch.cat(parts, 0).to(x.device)

    def barrier(self) -> None:
        if self.n > 1:
            dist.barrier(group=self.group)


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in _leaves(v, prefix + (k,))]
    return [(prefix, tree)]


class _GSum(torch.autograd.Function):
    """``all_reduce(SUM)`` forward, identity backward (JAX
    ``_psum_id_grad``)."""

    @staticmethod
    def forward(ctx, x, sh):
        return sh.reduce(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


def sharded_train_step(loss_fn: Callable, opt, sh: ShardHelpers) -> Callable:
    """The generic data-parallel step of the JAX package's
    ``sharded_train_step``: ``step(params, opt_state, batch) -> (params,
    opt_state, loss)`` where ``loss_fn(params, batch)`` is the mean over
    the rank's block of rows (equal blocks on every rank). The loss and the
    gradients are averaged over the ranks, then every rank runs the same
    Adam update (in place)."""
    from esrnerf_tpu_torch.apps.base import loss_and_grads

    def step(params, opt_state, batch):
        def both(p):
            v = loss_fn(p, batch)
            return v, v

        loss, grads = loss_and_grads(both, params, "dp", sh)
        if sh.n > 1:
            for _, g in _leaves(grads):
                g.div_(sh.n)
            loss = sh.reduce(loss) / sh.n
        params, opt_state = opt.step(params, grads, opt_state)
        return params, opt_state, loss.detach()

    return step
