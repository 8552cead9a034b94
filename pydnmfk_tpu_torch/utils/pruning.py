"""Zero-row/column pruning of the data matrix, the matching factor prune and
the unprune after the fit.

Port of ``pydnmfk_tpu/utils/pruning.py:20-80`` (reference
``data_operations.zero_idx_prune / prune_all / unprune_factors``,
pyDNMFk/utils.py:117-217). The keep-masks come from one device reduction and
go to the host, because pruning changes the shapes; the gathers and the
scatter back run on the device (``index_select``, ``index_copy``).

On a p_r x p_c grid (``grid``) each rank prunes its blocks: a row of block
(i, j) is kept where it is nonzero in any block of row i (the masks are
all-reduced with MAX over 'c'), a column where it is nonzero in any block
of column j (over 'r'), so every rank of a row prunes its rows alike, and
every rank of a column its columns. The returned PruneState holds the
whole matrix's masks (gathered), which unprune the gathered factors.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class PruneState:
    row_mask: np.ndarray      # bool (m,) True = kept
    col_mask: np.ndarray      # bool (n,) True = kept
    n_rows_full: int
    n_cols_full: int

    @property
    def pruned(self) -> bool:
        """True where some row or column was taken out."""
        return not (self.row_mask.all() and self.col_mask.all())


def zero_masks(A: torch.Tensor, grid=None) -> tuple[np.ndarray, np.ndarray]:
    """Boolean keep-masks of the rows and columns of A with at least one
    nonzero (reference zero_idx_prune, utils.py:117-135): both reductions
    on A's device, one copy to the host. On a grid the masks of this
    rank's block rows and columns in the whole matrix."""
    m = A.shape[0]
    nz = A != 0
    rows, cols = nz.any(dim=1), nz.any(dim=0)
    if grid is not None:
        rows = grid.max(rows.to(torch.float32), "c") > 0
        cols = grid.max(cols.to(torch.float32), "r") > 0
    masks = torch.cat([rows, cols]).cpu().numpy()
    return masks[:m], masks[m:]


def _whole_state(row_mask, col_mask, grid, device) -> "PruneState":
    """The PruneState of the whole matrix from this rank's block masks."""
    t = lambda mask: torch.from_numpy(mask.astype(np.float32)).to(device)
    rows = grid.gather(t(row_mask), "r", 0).cpu().numpy() > 0
    cols = grid.gather(t(col_mask), "c", 0).cpu().numpy() > 0
    return PruneState(rows, cols, rows.size, cols.size)


def _take(A, row_mask, col_mask):
    idx = lambda mask: torch.from_numpy(np.nonzero(mask)[0]).to(A.device)
    return A.index_select(0, idx(row_mask)).index_select(1, idx(col_mask))


def prune_A(A: torch.Tensor, grid=None):
    """Prune only A (rows and columns); the factors do not exist yet. The
    NMFk pipeline prunes once before sampling: uniform multiplicative and
    Poisson noise both map zeros to zeros, so every perturbed copy has A's
    zero masks (``pydnmfk_tpu/utils/pruning.py:51-65``). Returns (A,
    PruneState); on a grid A is this rank's block and the state the whole
    matrix's."""
    A, _, _, state = prune_all(A, None, None, grid)
    return A, state


def prune_all(A: torch.Tensor, W, H, grid=None):
    """Prune A (rows and columns), W (rows) and H (columns); W and H may be
    None. Returns the pruned arrays and the PruneState that undoes it
    (reference prune_all, utils.py:158-176); on a grid the blocks and the
    whole matrix's state."""
    row_mask, col_mask = zero_masks(A, grid)
    state = (PruneState(row_mask, col_mask, *A.shape) if grid is None
             else _whole_state(row_mask, col_mask, grid, A.device))
    if not state.pruned:
        return A, W, H, state
    A = _take(A, row_mask, col_mask).contiguous()
    if W is not None:
        ridx = torch.from_numpy(np.nonzero(row_mask)[0]).to(W.device)
        cidx = torch.from_numpy(np.nonzero(col_mask)[0]).to(H.device)
        W = W.index_select(0, ridx).contiguous()
        H = H.index_select(1, cidx).contiguous()
    return A, W, H, state


def unprune_factors(W: torch.Tensor, H: torch.Tensor, state: PruneState):
    """Put back zero rows of W and zero columns of H (reference
    unprune_factors, utils.py:202-217)."""
    if not state.pruned:
        return W, H
    k = W.shape[1]
    ridx = torch.from_numpy(np.nonzero(state.row_mask)[0]).to(W.device)
    cidx = torch.from_numpy(np.nonzero(state.col_mask)[0]).to(H.device)
    Wf = W.new_zeros((state.n_rows_full, k)).index_copy_(0, ridx, W)
    Hf = H.new_zeros((k, state.n_cols_full)).index_copy_(1, cidx, H)
    return Wf, Hf


def unprune_columns(col: np.ndarray, state: PruneState) -> np.ndarray:
    """A per-column vector of the pruned matrix at the full width, zero at
    the pruned columns (``pydnmfk_tpu/models/nmf.py:574-577``)."""
    full = np.zeros(state.n_cols_full, dtype=col.dtype)
    full[state.col_mask] = col
    return full
