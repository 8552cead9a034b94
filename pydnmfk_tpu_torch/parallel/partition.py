"""Block-partition index math of the p_r x p_c grid, the reference's layout.

Port of ``pydnmfk_tpu/parallel/partition.py``. The reference maps a rank to
remainder-balanced index ranges per dimension (pyDNMFk/utils.py:36-46):

    start = i * (n // k) + min(i, n % k)
    end   = (i + 1) * (n // k) + min(i + 1, n % k)      (half-open)

so the first ``n % k`` blocks are one longer. A rank of the port holds its
own tensor, so these uneven blocks are its layout: unlike the JAX package,
which pads to even tiles for ``NamedSharding`` (``models/nmf.py:292-317``),
it pads nothing. :func:`padded_dim` and :func:`mesh_padding` describe the
JAX package's padding, which the tests use to compare the two.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def block_range(dim: int, nblocks: int, index: int) -> Tuple[int, int]:
    """[start, end) of block ``index`` of ``nblocks`` over ``dim``."""
    q, r = divmod(dim, nblocks)
    return index * q + min(index, r), (index + 1) * q + min(index + 1, r)


def block_shape(dim: int, nblocks: int, index: int) -> int:
    s, e = block_range(dim, nblocks, index)
    return e - s


class BlockPartition:
    """Rank -> block index ranges for a (p_r, p_c) grid over a 2D shape,
    ranks row-major over the grid (the reference's
    ``determine_block_params``, utils.py:15-46)."""

    def __init__(self, rank: int, pgrid: Sequence[int], shape: Sequence[int]):
        self.rank = rank if int(np.prod(pgrid)) > 1 else 0
        self.pgrid = tuple(pgrid)
        self.shape = tuple(shape)

    def ranges(self) -> List[Tuple[int, int]]:
        """Per-dimension [start, end) ranges of this rank's block."""
        coords = np.unravel_index(self.rank, self.pgrid)
        return [block_range(n, k, int(i))
                for n, k, i in zip(self.shape, self.pgrid, coords)]

    def index_range_inclusive(self):
        """(start_inds, end_inds) with inclusive ends, the reference's
        convention (utils.py:36-41)."""
        rng = self.ranges()
        return [s for s, _ in rng], [e - 1 for _, e in rng]

    def block_shape(self) -> List[int]:
        return [e - s for s, e in self.ranges()]

    def slices(self) -> Tuple[slice, ...]:
        return tuple(slice(s, e) for s, e in self.ranges())


def partition_slices(pgrid: Sequence[int], shape: Sequence[int]
                     ) -> List[Tuple[slice, ...]]:
    """Slices of every rank's block, in rank order."""
    n = int(np.prod(pgrid))
    return [BlockPartition(r, pgrid, shape).slices() for r in range(n)]


def padded_dim(dim: int, nblocks: int) -> int:
    """Smallest multiple of nblocks >= dim (the JAX package's tiling)."""
    return -(-dim // nblocks) * nblocks


def mesh_padding(shape: Sequence[int], pgrid: Sequence[int]):
    """Per-dim zero padding that makes ``shape`` tile evenly over
    ``pgrid``, as the JAX package pads for XLA's sharding."""
    return tuple(padded_dim(d, p) - d for d, p in zip(shape, pgrid))


def rank_to_block_order_H(p_r: int, p_c: int) -> List[int]:
    """Reorder gathered H chunks from rank order to column-block order:
    ``i * p_c + j`` over the row-major grid (the reference's
    ``rankidx2blkidx``, utils.py:357, strides by p_r, right only for square
    grids)."""
    return [i * p_c + j for j in range(p_c) for i in range(p_r)]
