"""Device-memory budgeting of the batched NMFk ensemble.

Port of ``pydnmfk_tpu/utils/memory.py``, with its four names and
signatures, computing the port's own model: the one ``models/nmfk.py::
NMFk._ensemble_batch_size`` sizes every batch by. The reference solves the
members one by one (pyDNMFk.py:226-231); the port solves a batch of them
in one launch of each kernel, as many as the budget holds.

* The budget of a rank is ``hbm_budget``, else the ``PYDNMFK_HBM_BUDGET``
  environment variable, of which the batch may fill ``HEADROOM`` less the
  bytes that the whole batch shares; else, on the card, half of its free
  memory (A is on the card already, so neither comes off); else, on the
  CPU, no limit.
* A dense member costs its copy of A at ``a_dtype``; under KL the plain
  products' f32 ratio slab (``kl_chunk`` rows, else the automatic ones,
  else all m); under nnsvd its Gram, eigenvectors and ``eigh``'s workspace
  (three min(m, n)^2 f32 arrays) and the f32 copy of a narrower member
  that the SVD takes; and its factors' working set at their byte width. A
  dense batch shares A at the work precision.
* A sparse member costs its f32 noise draw and data copy, the dual ELL's
  value arrays of both orientations where it runs on the ELL, under KL the
  f32 workspace of K4's ratio where its slab plan takes more than one slab
  (past k = 256: one (dim, w) array, the wider orientation's of those that
  do, ``ops/ell_gather.py::slab_for``), and its factors' working set. A
  sparse batch shares the values and indices, and on a grid also the whole
  flat values, one member's draw of them and the block's slots in them.

On a grid the shapes are a rank's block; the batch is the least that any
rank's memory holds, which is the largest block's (block 0 of the
remainder-balanced layout), and under p_e groups a multiple of p_e, at
least p_e (``pydnmfk_tpu/models/nmfk.py:799-828``).
"""
from __future__ import annotations

import os
from typing import Optional

import torch

from ..ops import ell_gather, linalg
from ..parallel.partition import block_shape

# working-set multiple of the factors per ensemble member: W and H, the MU
# numerators and denominators, the init draws (the JAX package's F_WORK)
F_WORK = 8
# the share of a stated memory budget that the batch may fill
HEADROOM = 0.85
BUDGET_ENV = "PYDNMFK_HBM_BUDGET"


def _item(dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def _device(device) -> torch.device:
    if device is None:
        return torch.device("cuda" if torch.cuda.is_available() else "cpu")
    return torch.device(device)


def stated_budget(hbm_budget: int = 0) -> int:
    """``hbm_budget``, else ``PYDNMFK_HBM_BUDGET``, else 0 (none stated)."""
    return hbm_budget or int(float(os.environ.get(BUDGET_ENV) or 0))


def device_memory_budget(backend=None, hbm_budget: int = 0
                         ) -> Optional[int]:
    """A rank's memory budget in bytes: the stated one
    (:func:`stated_budget`); else, on the card (``backend`` "cuda" or a
    CUDA device; None: the card where there is one), half of its free
    memory; else None, the CPU's "no limit"."""
    stated = stated_budget(hbm_budget)
    if stated:
        return stated
    device = _device(backend)
    if device.type != "cuda":
        return None
    free, _ = torch.cuda.mem_get_info(device)
    return free // 2


def members_within(per_member: int, shared: int, cap: int,
                   hbm_budget: int = 0, device=None) -> int:
    """Members of ``per_member`` bytes that one rank holds, 1 to ``cap``:
    of a stated budget its ``HEADROOM`` less the ``shared`` bytes; of the
    card's free memory half; on the CPU without a stated budget all."""
    stated = stated_budget(hbm_budget)
    if stated:
        share = (stated * HEADROOM - shared) // per_member
    else:
        budget = device_memory_budget(device)
        share = cap if budget is None else budget // per_member
    return max(1, min(int(share), cap))


def round_to_groups(batch: int, cap: int, p_e: int = 1) -> int:
    """A batch of all ensemble groups, 1 to ``cap``, rounded down to a
    multiple of p_e and at least p_e (one member a group)."""
    batch = max(1, min(batch, cap))
    return max(p_e, batch // p_e * p_e)


def dense_member_bytes(m: int, n: int, k: int, ncfg) -> tuple:
    """(bytes of one member, bytes the batch shares) of a dense m x n A (a
    rank's block) at k columns under the NMFConfig ``ncfg``."""
    a_item, w_item = _item(ncfg.a_dtype), _item(ncfg.dtype)
    per_member = m * n * a_item + (m + n) * k * w_item * F_WORK
    if ncfg.norm.lower() == "kl":
        rows = ncfg.kl_chunk or linalg.error_chunk_rows(m, n) or m
        per_member += min(rows, m) * n * 4
    if ncfg.init == "nnsvd":
        per_member += 3 * min(m, n) ** 2 * 4
        if a_item < 4:
            per_member += m * n * 4
    return per_member, m * n * w_item


def sparse_member_bytes(m: int, n: int, nnz: int, k: int, ncfg, ell=None,
                        flat: int = 0, device=None) -> tuple:
    """(bytes of one member, bytes the batch shares) of a sparse m x n A
    (a rank's block) with ``nnz`` entries at k columns: on the dual ELL
    ``ell`` (an ``ops/ell.py::EllSparse``) where it runs on one, and on a
    grid with ``flat`` values in the whole matrix (a SparseGridInput's);
    ``device`` plans K4's slabs (None: the card's)."""
    a_item, w_item = _item(ncfg.a_dtype), _item(ncfg.dtype)
    slots = ws = 0
    if ell is not None:
        slots = sum(x.numel() for x in (ell.rvals, ell.rtail_d, ell.cvals,
                                        ell.ctail_d))
        if ncfg.norm.lower() == "kl":
            device = _device(device)
            ws = max((vals.numel() * 4 for vals, dim_t in
                      ((ell.rvals, n), (ell.cvals, m))
                      if ell_gather.slab_for(dim_t, k, device,
                                             ratio=True)[1] > 1), default=0)
    per_member = (nnz * (a_item + 4) + slots * a_item + ws
                  + (m + n) * k * w_item * F_WORK)
    shared = nnz * (w_item + 8)
    if flat:
        shared += flat * (w_item + 4) + nnz * 8
    return per_member, shared


def ensemble_member_bytes(m: int, n: int, k: int, ncfg, grid_shape=(1, 1),
                          p_e: int = 1) -> int:
    """Bytes one member of a dense m x n A adds to the working set of the
    rank with the largest block of a ``grid_shape`` = (p_r, p_c) grid
    (``p_e`` does not change it)."""
    p_r, p_c = grid_shape
    return dense_member_bytes(block_shape(m, p_r, 0), block_shape(n, p_c, 0),
                              k, ncfg)[0]


def auto_ensemble_batch(m: int, n: int, k: int, n_pert: int, ncfg,
                        grid_shape=(1, 1), p_e: int = 1,
                        budget: Optional[int] = None, device=None) -> int:
    """Members a batched solve of a dense m x n A at k columns takes, of
    all p_e groups of a (p_r, p_c) grid together, at most ``n_pert``: the
    largest block's share of ``budget`` (None: ``PYDNMFK_HBM_BUDGET``, else
    the card's half of its free memory, else all), p_e times, as
    ``NMFk`` sizes it where no ``ensemble_batch`` is set."""
    p_r, p_c = grid_shape
    per_member, shared = dense_member_bytes(
        block_shape(m, p_r, 0), block_shape(n, p_c, 0), k, ncfg)
    share = members_within(per_member, shared, n_pert, budget or 0, device)
    return round_to_groups(share * p_e, n_pert, p_e)


def auto_ensemble_batch_sparse(m: int, n: int, nnz: int, k: int,
                               n_pert: int, ncfg,
                               budget: Optional[int] = None, *, ell=None,
                               device=None) -> int:
    """Members a batched solve of a sparse m x n A with ``nnz`` entries
    takes on one rank, at most ``n_pert``: as :func:`auto_ensemble_batch`,
    by :func:`sparse_member_bytes` (``ell``: the dual ELL it runs on)."""
    per_member, shared = sparse_member_bytes(m, n, nnz, k, ncfg, ell,
                                             device=device)
    return members_within(per_member, shared, n_pert, budget or 0, device)
