"""Zero-row/column pruning of the data matrix, the matching factor prune and
the unprune after the fit.

Port of ``pydnmfk_tpu/utils/pruning.py:20-80`` (reference
``data_operations.zero_idx_prune / prune_all / unprune_factors``,
pyDNMFk/utils.py:117-217) on one device. The keep-masks come from one device
reduction and go to the host, because pruning changes the shapes; the
gathers and the scatter back run on the device (``index_select``,
``index_copy``).
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


def zero_masks(A: torch.Tensor) -> tuple[np.ndarray, np.ndarray]:
    """Boolean keep-masks of the rows and columns of A with at least one
    nonzero (reference zero_idx_prune, utils.py:117-135): both reductions
    on A's device, one copy to the host."""
    m = A.shape[0]
    nz = A != 0
    masks = torch.cat([nz.any(dim=1), nz.any(dim=0)]).cpu().numpy()
    return masks[:m], masks[m:]


def _take(A, row_mask, col_mask):
    idx = lambda mask: torch.from_numpy(np.nonzero(mask)[0]).to(A.device)
    return A.index_select(0, idx(row_mask)).index_select(1, idx(col_mask))


def prune_A(A: torch.Tensor):
    """Prune only A (rows and columns); the factors do not exist yet. The
    NMFk pipeline prunes once before sampling: uniform multiplicative and
    Poisson noise both map zeros to zeros, so every perturbed copy has A's
    zero masks (``pydnmfk_tpu/utils/pruning.py:51-65``). Returns (A,
    PruneState)."""
    row_mask, col_mask = zero_masks(A)
    state = PruneState(row_mask, col_mask, *A.shape)
    if not state.pruned:
        return A, state
    return _take(A, row_mask, col_mask).contiguous(), state


def prune_all(A: torch.Tensor, W: torch.Tensor, H: torch.Tensor):
    """Prune A (rows and columns), W (rows) and H (columns). Returns the
    pruned arrays and the PruneState that undoes it (reference prune_all,
    utils.py:158-176)."""
    A, state = prune_A(A)
    if not state.pruned:
        return A, W, H, state
    ridx = torch.from_numpy(np.nonzero(state.row_mask)[0]).to(W.device)
    cidx = torch.from_numpy(np.nonzero(state.col_mask)[0]).to(H.device)
    return (A, W.index_select(0, ridx).contiguous(),
            H.index_select(1, cidx).contiguous(), state)


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
