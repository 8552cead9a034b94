"""The p_r x p_c process grid of distributed NMF: one process per rank.

Port of ``pydnmfk_tpu/parallel/mesh.py`` (the reference's communicator
layer, pyDNMFk/dist_comm.py: ``MPI_comm`` with a ``Create_cart`` grid and
its row and column communicators). The JAX package states the contract as
shardings over a device mesh and leaves the collectives to XLA; here every
rank is a process that holds its own blocks, and the collectives are
``torch.distributed`` calls over a row and a column subgroup:

    A : P('r', 'c')   rank (i, j) holds block (i, j)
    W : P('r', None)  row block i, replicated along 'c'
    H : P(None, 'c')  column block j, replicated along 'r'

    W^T W, W^T A   local product, then all-reduced over 'r' (the ranks of
                   a column: the subgroup of this rank's j)
    A H^T, H H^T   local product, then all-reduced over 'c' (the ranks of
                   a row: the subgroup of this rank's i)

Ranks are row-major over the grid, rank = i * p_c + j, as the reference's
``Create_cart``. Blocks are the reference's remainder-balanced ones
(``parallel/partition.py``); nothing is padded.

Two rules, each fixed before the group forms (neither is a retry after a
failure):

* Device rule: a rank runs on ``cuda:(LOCAL_RANK % device_count)``, or on
  the CPU only where the caller asks for it.
* Backend rule: NCCL where every rank of a node has a card of its own
  (``LOCAL_WORLD_SIZE <= device_count``); gloo where ranks share a card
  (NCCL refuses two ranks on one GPU) or run on the CPU. Gloo takes CUDA
  tensors and stages them through the host itself (torch 2.11 on an H100,
  ``bench_torch/grid_comm_probe.py``), so its collectives are timed as the
  host's, not NCCL's.

Replicas stay bitwise equal: a W block is updated on every rank of its row
from sums that the row's all-reduce gave each of them alike, and an H block
on every rank of its column likewise. A sum that replicas use but another
subgroup computes (the norm of a W column sums over 'r', but W's replicas
are the ranks of a row) is taken ``everywhere``: one all-reduce over all
ranks, to which one replica of each block contributes, so that every rank
gets the same bits.
"""
from __future__ import annotations

import datetime
import os
import time
from typing import Optional

import torch
import torch.distributed as dist

from ..config import NotPortedError
from ..utils import timing
from .partition import block_range

ROW_AXIS = "r"
COL_AXIS = "c"


def device_for(device, local_rank: int) -> torch.device:
    """The device rule: ``cuda:(local_rank % device_count)`` unless the
    caller asks for the CPU."""
    device = torch.device(device)
    if device.type == "cpu":
        return device
    if not torch.cuda.is_available():
        raise RuntimeError('no CUDA device is available; pass device="cpu" '
                           "(--cpu) to run the grid on the CPU")
    return torch.device("cuda", local_rank % torch.cuda.device_count())


def backend_for(device: torch.device, local_world_size: int) -> str:
    """The backend rule: NCCL where each rank of a node has its own card,
    else gloo."""
    if (device.type == "cuda"
            and local_world_size <= torch.cuda.device_count()):
        return "nccl"
    return "gloo"


class GridContext:
    """This rank's place in the p_r x p_c grid, its row and column
    subgroups and the grid's collectives; the counterpart of the
    reference's ``params.comm/comm1/row_comm/col_comm`` bundle
    (main.py:62-67). Built on every rank, in the same order, after the
    process group has formed (:func:`initialize`)."""

    def __init__(self, p_r: int, p_c: int, device, p_e: int = 1):
        if p_e != 1:
            raise NotPortedError(f"the ensemble axis p_e={p_e}",
                                 "queue 1 item 15")
        if not dist.is_initialized():
            raise RuntimeError("GridContext needs a process group: call "
                               "parallel.mesh.initialize first")
        world = dist.get_world_size()
        if world != p_r * p_c:
            raise ValueError(f"a {p_r}x{p_c} grid needs {p_r * p_c} ranks, "
                             f"the process group has {world}")
        self.shape = (p_r, p_c)
        self.rank = dist.get_rank()
        self.coords = divmod(self.rank, p_c)
        self.device = torch.device(device)
        self.backend = dist.get_backend()
        rows = [[i * p_c + j for j in range(p_c)] for i in range(p_r)]
        cols = [[i * p_c + j for i in range(p_r)] for j in range(p_c)]
        self._groups = {COL_AXIS: dist.new_subgroups_by_enumeration(rows)[0],
                        ROW_AXIS: dist.new_subgroups_by_enumeration(cols)[0],
                        "rc": None}
        # collectives issued: kind -> [calls, bytes] (utils/timing.py's
        # collective_stats reads it)
        self.stats = {}

    @property
    def n_ranks(self) -> int:
        return self.shape[0] * self.shape[1]

    @property
    def is_proc0(self) -> bool:
        """Whether this rank plays the reference's rank-0 writer role."""
        return self.rank == 0

    def rows(self, m: int):
        """[start, end) of this rank's row block of m rows."""
        return block_range(m, self.shape[0], self.coords[0])

    def cols(self, n: int):
        """[start, end) of this rank's column block of n columns."""
        return block_range(n, self.shape[1], self.coords[1])

    def block(self, X):
        """This rank's block of the last two dims of X (global)."""
        (r0, r1), (c0, c1) = self.rows(X.shape[-2]), self.cols(X.shape[-1])
        return X[..., r0:r1, c0:c1]

    # -- collectives ----------------------------------------------------
    def _run(self, kind, x, call):
        entry = self.stats.setdefault(kind, [0, 0])
        entry[0] += 1
        entry[1] += x.numel() * x.element_size()
        if not timing.ENABLED:
            call()
            return
        timing.sync()
        t0 = time.perf_counter()
        call()
        timing.sync()
        timing.record("dist_comm", time.perf_counter() - t0)

    def sum(self, x: torch.Tensor, over: str, everywhere: bool = False):
        """x summed over the grid axis ``over``: 'r' (the ranks of this
        rank's column), 'c' (of its row) or 'rc' (all ranks); in place on
        x where it is contiguous, and returned. ``everywhere``: the same
        sum with the same bits on every rank of the grid (the ranks of the
        first column, or of the first row, contribute)."""
        x = x.contiguous()
        group = self._groups[over]
        if everywhere and over != "rc":
            i, j = self.coords
            if (j if over == ROW_AXIS else i) != 0:
                x.zero_()
            group = None
        self._run("all-reduce", x, lambda: dist.all_reduce(x, group=group))
        return x

    def max(self, x: torch.Tensor, over: str = "rc"):
        """The elementwise maximum of x over ``over``, in place."""
        x = x.contiguous()
        group = self._groups[over]
        self._run("all-reduce", x, lambda: dist.all_reduce(
            x, op=dist.ReduceOp.MAX, group=group))
        return x

    def broadcast(self, x: torch.Tensor, src: int = 0):
        """Rank ``src``'s x on every rank, in place."""
        x = x.contiguous()
        self._run("broadcast", x, lambda: dist.broadcast(x, src=src))
        return x

    def gather(self, x: torch.Tensor, over: str, dim: int):
        """The blocks of x of the ranks along ``over`` ('r': this rank's
        column, in order of i; 'c': its row, in order of j), concatenated
        along ``dim``, on every one of them. Blocks may differ in length
        along ``dim`` (an uneven or pruned block): their lengths are
        gathered first."""
        group = self._groups[over]
        dim = dim % x.dim()
        lens = self._lengths(x.shape[dim], over)
        shape = list(x.shape)
        shape[dim] = max(lens)
        buf = x.new_zeros(shape)
        buf.narrow(dim, 0, x.shape[dim]).copy_(x)
        parts = [torch.empty_like(buf) for _ in lens]
        self._run("all-gather", buf, lambda: dist.all_gather(parts, buf,
                                                            group=group))
        return torch.cat([p.narrow(dim, 0, n) for p, n in zip(parts, lens)],
                         dim)

    def _lengths(self, length: int, over: str):
        """The lengths of the blocks along ``over``, in its order, whose
        block on this rank is ``length`` long."""
        group = self._groups[over]
        n = torch.tensor([length], dtype=torch.int64, device=self.device)
        lens = [torch.empty_like(n) for _ in range(dist.get_world_size(group))]
        self._run("all-gather", n, lambda: dist.all_gather(lens, n,
                                                          group=group))
        return [int(v) for v in torch.cat(lens).cpu()]

    def span(self, length: int, over: str):
        """(start, end, total) of this rank's block, ``length`` long, among
        the blocks of its column ('r': rows) or of its row ('c': columns),
        which may be uneven or pruned."""
        lens = self._lengths(length, over)
        start = sum(lens[:self.coords[0] if over == ROW_AXIS
                         else self.coords[1]])
        return start, start + length, sum(lens)

    def barrier(self):
        """Every rank waits here for the others (the reference orders rank
        0's writes before the others' reads by its blocking
        collectives)."""
        dist.barrier()


def is_proc0(grid: Optional[GridContext]) -> bool:
    """Whether this process writes: rank 0 of a grid, or the one process
    without one."""
    return grid is None or grid.is_proc0


def sync_processes(grid: Optional[GridContext]) -> None:
    """A barrier on a grid; nothing without one."""
    if grid is not None:
        grid.barrier()


def initialize(p_r: int, p_c: int, device="cuda", *,
               init_method: Optional[str] = None, rank: Optional[int] = None,
               world_size: Optional[int] = None,
               timeout: Optional[float] = None) -> GridContext:
    """This process's GridContext on a p_r x p_c grid, joining the process
    group first where it has not formed: from torchrun's environment
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``,
    ``MASTER_ADDR``, ``MASTER_PORT``), or from ``init_method``, ``rank``
    and ``world_size``. A group over several nodes (torchrun ``--nnodes``,
    the JAX package's ``--multihost``) is the same call. ``timeout`` in
    seconds bounds every collective, so that a rank that died ends the
    others' wait."""
    if not dist.is_initialized():
        if init_method is None and "RANK" not in os.environ:
            raise RuntimeError(
                f"a {p_r}x{p_c} grid runs one process per rank: start "
                f"{p_r * p_c} of them, e.g. python -m torch.distributed.run "
                f"--standalone --nproc_per_node={p_r * p_c} -m "
                f"pydnmfk_tpu_torch --p_r={p_r} --p_c={p_c} ...")
        rank = int(os.environ["RANK"]) if rank is None else rank
        world_size = (int(os.environ["WORLD_SIZE"]) if world_size is None
                      else world_size)
        local_rank = int(os.environ.get("LOCAL_RANK", rank))
        local_size = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
        device = device_for(device, local_rank)
        backend = backend_for(device, local_size)
        kw = {}
        if timeout is not None:
            kw["timeout"] = datetime.timedelta(seconds=timeout)
        if backend == "nccl":
            kw["device_id"] = device
        dist.init_process_group(backend, init_method=init_method or "env://",
                                rank=rank, world_size=world_size, **kw)
    else:
        device = device_for(device, int(os.environ.get(
            "LOCAL_RANK", dist.get_rank())))
    if device.type == "cuda":
        torch.cuda.set_device(device)
    return GridContext(p_r, p_c, device)
