"""Data parallelism over ranks with ``torch.distributed``.

Port of ``esrnerf_tpu/parallel/mesh.py``: one process per rank
(``torchrun``), each marching its own contiguous block of the global ray
batch with the renderer's per-rank budgets. Every loss term folds its
numerator and count across ranks ("recipe B", :class:`ShardHelpers`), the
gradients are summed over the ranks once, and each rank runs the identical
Adam step.

    torchrun --standalone --nproc_per_node=N -m esrnerf_tpu_torch.run \\
        -cn <cfg> app.phase=train [system.parallel=gspmd] \\
        [system.param_shard=fsdp]

Two step layouts (``system.parallel``):

- ``shard_map`` (the default): each rank's step is the one-device step on
  its block. Random draws are the rank's own (the LTS family's keyed by
  their rays' places in the global batch, a generator's by
  :meth:`ShardHelpers.fold_generator`), the LTS surface points are split
  between the ranks (``num_ltspts / n`` a rank) and the march counters
  are the maximum of the ranks' own fractions. The result depends on the
  world size.
- ``gspmd``: the step at world n equals the step at world 1 on the same
  global batch and key, up to summation order, as JAX's ``jit`` of the
  one-device step body does. The draws are world 1's: keyed by the global
  ray, or explicit draws of which each rank takes its rows by their place
  in world 1's order (:meth:`ShardHelpers.global_positions`); the LTS
  surface points are
  world 1's lowest scores over all ranks (:meth:`ShardHelpers.
  select_lowest`); the counters are global fractions. The march budgets
  stay per rank at the block's share, so a rank whose block overflows its
  share reports overflow where one buffer for the whole batch might not.

Parameters (``system.param_shard``, under ``gspmd``): replicated, or
``fsdp`` (:class:`ParamLayout`): every leaf of three or more dims whose
leading dim divides the world is kept as the rank's contiguous X-slab, as
are its Adam moments; a step all-gathers the slabs into the whole grid and
its backward reduce-scatters the grid's gradient, so each rank gets the
global gradient of its own slab. ``shard_map`` keeps the parameters
replicated and ignores the flag, as the JAX package does.

Backends: NCCL when every rank has a card of its own (``WORLD_SIZE`` <=
``torch.cuda.device_count()``); gloo when ranks share a card
(``cuda:LOCAL_RANK % count``) or run on the CPU (``system.device=cpu``).
gloo reduces in host memory, so the helpers stage CUDA tensors through
host buffers for it. At world 1 nothing here runs: the helpers are the
identity and no process group exists.
"""

from __future__ import annotations

import datetime
import os
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from esrnerf_tpu_torch.utils import profiling

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


PARALLEL_MODES = ("shard_map", "gspmd")
PARAM_SHARDS = ("none", "fsdp")


def parallel_layout(cfg) -> tuple:
    """``(system.parallel, system.param_shard)`` with their defaults
    (``shard_map``, ``none``)."""
    sysc = cfg.system
    return (str(sysc.get("parallel") or "shard_map"),
            str(sysc.get("param_shard") or "none"))


def check_parallel_cfg(cfg, n: int) -> None:
    """Refuse a layout the port has no path for, at a world of ``n``: an
    unknown ``system.parallel`` or ``system.param_shard``, or empty
    ``system.mesh_axes`` on more than one rank."""
    mode, shard = parallel_layout(cfg)
    if mode not in PARALLEL_MODES:
        raise ValueError(f"system.parallel={mode}: one of {PARALLEL_MODES}")
    if shard not in PARAM_SHARDS:
        raise ValueError(
            f"system.param_shard={shard}: one of {PARAM_SHARDS}")
    if n > 1 and not tuple(cfg.system.get("mesh_axes") or ()):
        raise ValueError(
            f"a world of {n} ranks with system.mesh_axes empty: the data "
            "axis is what the ranks split; set system.mesh_axes=[data]")


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
    memory (one reusable buffer per dtype for the gradients). ``gspmd``:
    the step layout whose result does not depend on the world size (world
    1's draws, point selection and counters; the module's docstring)."""

    def __init__(self, n: int = 1, rank: int = 0, group=None,
                 backend: Optional[str] = None, gspmd: bool = False):
        self.n, self.rank, self.group = n, rank, group
        self.gspmd = bool(gspmd)
        self.backend = backend or (dist.get_backend(group) if n > 1
                                   else None)
        self._host: Dict[torch.dtype, torch.Tensor] = {}

    @property
    def global_rows(self) -> bool:
        """True where a step must place its rows in world 1's order
        (``gspmd`` on more than one rank)."""
        return self.gspmd and self.n > 1

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
        ``(seed, step)`` at world 1 and under ``gspmd`` (every rank draws
        world 1's tensors), ``(seed, step, rank)`` on a larger ``shard_map``
        world, so ranks draw apart."""
        key = [int(seed), int(step)] + (
            [self.rank] if self.n > 1 and not self.gspmd else [])
        s = int(np.random.SeedSequence(key).generate_state(1)[0])
        return torch.Generator(device=device).manual_seed(s)

    def all_reduce_grads(self, tree):
        """Sum a gradient tree over the ranks in place, through one flat
        buffer per dtype (the fine step's gradients are 872 MB at 256^3):
        one collective over the leaves of fewer than three dims together,
        then one over each grid (a leaf of three or more dims), so a grid
        is summed in the order that ``fsdp``'s reduce-scatter of it sums
        (:meth:`reduce_scatter_flat`; the same bits on gloo). Returns
        ``tree``."""
        if self.n == 1:
            return tree
        by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
        for _, g in _leaves(tree):
            by_dtype.setdefault(g.dtype, []).append(g)
        for dtype, leaves in by_dtype.items():
            leaves = ([g for g in leaves if g.dim() < 3]
                      + [g for g in leaves if g.dim() >= 3])
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
            # segment ends: the small leaves' together, then each grid's
            ends, o = [], 0
            for i, g in enumerate(leaves):
                flat[o:o + g.numel()].copy_(g.reshape(-1),
                                            non_blocking=staged)
                o += g.numel()
                if g.dim() >= 3 or i + 1 == len(leaves) \
                        or leaves[i + 1].dim() >= 3:
                    ends.append(o)
            if staged:
                torch.cuda.current_stream(leaves[0].device).synchronize()
            for a, b in zip([0] + ends[:-1], ends):
                if b > a:
                    dist.all_reduce(flat[a:b], group=self.group)
            o = 0
            for g in leaves:
                g.copy_(flat[o:o + g.numel()].view_as(g), non_blocking=staged)
                o += g.numel()
        return tree

    def gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's block of rows (equal-sized blocks) stacked in rank
        order, on every rank: one ``all_gather_into_tensor``, no gradient;
        ``x`` at world 1."""
        if self.n == 1:
            return x
        src = x.detach().contiguous()
        staged = self._staged(src)
        if staged:
            src = _pinned_copy(src)
        out = torch.empty((self.n * src.shape[0], *src.shape[1:]),
                          dtype=src.dtype, device=src.device,
                          pin_memory=staged)
        dist.all_gather_into_tensor(out, src, group=self.group)
        return out.to(x.device, non_blocking=True) if staged else out

    def reduce_scatter_flat(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over the ranks of ``x``'s rank-th block of rows (dim 0
        divides the world), one ``reduce_scatter_tensor``; no gradient."""
        if self.n == 1:
            return x.detach()
        src = x.detach().contiguous()
        staged = self._staged(src)
        if staged:
            src = _pinned_copy(src)
        out = torch.empty((src.shape[0] // self.n, *src.shape[1:]),
                          dtype=src.dtype, device=src.device,
                          pin_memory=staged)
        dist.reduce_scatter_tensor(out, src, dist.ReduceOp.SUM,
                                   group=self.group)
        return out.to(x.device, non_blocking=True) if staged else out

    def global_positions(self, keys: torch.Tensor) -> torch.Tensor:
        """Each of the rank's rows' place in world 1's order. ``keys``
        (int64, ascending, the same count on every rank) are the rank's
        rows sorted stably by key over ray-major rows; world 1 sorts the
        union the same way, and the ranks hold ascending ray blocks, so a
        row with key ``c`` sits after every row of a smaller key, after the
        rows of key ``c`` on lower ranks, and at its own offset among the
        rank's rows of key ``c``. One all-gather of the keys."""
        local = torch.arange(keys.numel(), device=keys.device)
        if self.n == 1:
            return local
        allk = self.gather_rows(keys).reshape(self.n, -1)
        below = torch.searchsorted(torch.sort(allk.reshape(-1)).values, keys)
        pos = below + local - torch.searchsorted(keys, keys)
        if self.rank:
            lower = allk[:self.rank].contiguous()
            k = keys.expand(self.rank, -1).contiguous()
            pos = pos + (torch.searchsorted(lower, k, right=True)
                         - torch.searchsorted(lower, k)).sum(0)
        return pos

    def select_lowest(self, scores: torch.Tensor, pos: torch.Tensor,
                      P: int) -> tuple:
        """World 1's choice of the ``P`` lowest ``scores`` over every
        rank's rows, ties to the lower position ``pos`` (a stable argsort
        of the scores over rows in position order), from one all-gather of
        each rank's own ``P`` lowest (score, position) pairs. Returns
        ``(rows, slots)``: this rank's chosen rows (indices into
        ``scores``) ascending in position, and each one's place among all
        ``P`` chosen rows in ascending position."""
        order = torch.argsort(pos)
        order = order.index_select(
            0, torch.argsort(scores.index_select(0, order), stable=True))
        cand = order[:P]
        pairs = torch.stack([scores.index_select(0, cand).double(),
                             pos.index_select(0, cand).double()], -1)
        if cand.numel() < P:  # fewer rows than P: never-chosen fillers
            fill = pairs.new_tensor([float("inf"), float("inf")])
            pairs = torch.cat([pairs, fill.expand(P - cand.numel(), 2)])
        allp = self.gather_rows(pairs)
        o = torch.argsort(allp[:, 1])
        o = o.index_select(0, torch.argsort(allp[o, 0], stable=True))[:P]
        chosen = torch.sort(allp[o, 1]).values
        chosen = chosen[torch.isfinite(chosen)]
        mine = pairs[:cand.numel(), 1].contiguous()
        slot = torch.searchsorted(chosen, mine)
        hit = chosen.index_select(
            0, torch.clamp(slot, max=max(chosen.numel() - 1, 0))) == mine
        rows, slots = cand[hit], slot[hit]
        o = torch.argsort(slots)
        return rows.index_select(0, o), slots.index_select(0, o)

    def barrier(self) -> None:
        if self.n > 1:
            dist.barrier(group=self.group)


def _pinned_copy(t: torch.Tensor) -> torch.Tensor:
    """A CUDA tensor in pinned host memory (the caching host allocator
    reuses the buffer), the copy finished before gloo reads it."""
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    h.copy_(t, non_blocking=True)
    torch.cuda.current_stream(t.device).synchronize()
    return h


def fsdp_shards(x: torch.Tensor, n: int) -> bool:
    """The JAX package's ``fsdp_param_sharding`` rule: a leaf of three or
    more dims whose leading dim divides a world of ``n`` > 1 ranks is
    split into X-slabs; everything else stays replicated."""
    return n > 1 and x.dim() >= 3 and x.shape[0] % n == 0


class ParamLayout:
    """How a rank keeps a stage's parameter tree: whole (replicated), or,
    with ``fsdp`` on a world of ranks, every leaf that :func:`fsdp_shards`
    as its contiguous X-slab ``[r X / n : (r + 1) X / n]``. :meth:`place`
    records the sharded leaves by path; the same paths then pick the slabs
    of any tree of that structure (Adam's moments, the gradients, the
    per-voxel LR). :meth:`gather` puts the whole grids back together (no
    gradient); :meth:`gather_for_grad` does it inside a step, its backward
    reduce-scattering the grids' gradients (:class:`_GatherSlabs`).
    Without ``fsdp``, or at world 1, every method hands its input back."""

    def __init__(self, sh: ShardHelpers, fsdp: bool = False):
        self.sh = sh
        self.fsdp = bool(fsdp) and sh.n > 1
        self.paths: frozenset = frozenset()

    def sharded(self, path) -> bool:
        return (path if isinstance(path, tuple) else (path,)) in self.paths

    def place(self, tree):
        """A whole tree as the rank keeps it; records which leaves shard
        (by the rule on their shapes: a rescaled grid is placed anew)."""
        if self.fsdp:
            self.paths = frozenset(p for p, x in _leaves(tree)
                                   if fsdp_shards(x, self.sh.n))
        return self.slice(tree)

    def rows(self, x: torch.Tensor) -> tuple:
        """``(lo, hi)``: the X-rows of a whole grid that are the rank's
        slab."""
        b = x.shape[0] // self.sh.n
        return self.sh.rank * b, (self.sh.rank + 1) * b

    def slab(self, x: torch.Tensor) -> torch.Tensor:
        """The rank's X-slab of a whole grid (a copy of its own)."""
        lo, hi = self.rows(x)
        return x.detach()[lo:hi].clone()

    def slice(self, tree):
        """A whole tree of the placed tree's structure cut to the rank's
        slabs at the recorded paths."""
        return _map_leaves(tree, lambda p, x: self.slab(x)
                           if p in self.paths else x)

    def gather(self, tree):
        """The whole tree from the rank's slabs (one all-gather a sharded
        leaf, in path order on every rank)."""
        return _map_leaves(tree, lambda p, x: self.sh.gather_rows(x)
                           if p in self.paths else x)

    def place_state(self, state):
        """An optimizer state (``step``, ``mu``, ``nu``) of whole leaves
        cut to the rank's slabs."""
        if not self.paths:
            return state
        return type(state)(state.step, self.slice(state.mu),
                           self.slice(state.nu))

    def gather_state(self, state):
        if not self.paths:
            return state
        return type(state)(state.step, self.gather(state.mu),
                           self.gather(state.nu))

    def gather_for_grad(self, slabs: List[torch.Tensor]) -> tuple:
        """The whole grids of ``slabs`` (leaves requiring grad) inside a
        step: one autograd node, so its backward, the reduce-scatter of
        every grid's gradient, runs once and in the same order on every
        rank."""
        return _GatherSlabs.apply(self.sh, *slabs)


def _map_leaves(tree, fn, prefix=()):
    if isinstance(tree, dict):
        return {k: _map_leaves(v, fn, prefix + (k,)) for k, v in tree.items()}
    return fn(prefix, tree)


class _GatherSlabs(torch.autograd.Function):
    """All-gather of X-slabs into whole grids; the backward is their
    gradients' reduce-scatter (SUM), so under recipe B each rank gets the
    global gradient of its own slab."""

    @staticmethod
    def forward(ctx, sh, *slabs):
        ctx.sh = sh
        with profiling.span("fsdp/all_gather"):
            return tuple(sh.gather_rows(s) for s in slabs)

    @staticmethod
    def backward(ctx, *grads):
        with profiling.span("fsdp/reduce_scatter"):
            return (None, *(ctx.sh.reduce_scatter_flat(g) for g in grads))


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
