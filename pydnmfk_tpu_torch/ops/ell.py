"""Dual ELL sparse A: the card's format for the very sparse regime.

Port of ``pydnmfk_tpu/ops/ell.py``. Capped-width ELLPACK in both
orientations, plus COO tails:

    rvals/rcols : (m, w_r)  per-row values / column indices (CSR-ELL)
    rtail_*     : (t_r,)    entries beyond the per-row width cap
    cvals/crows : (n, w_c)  per-column values / row indices (CSC-ELL)
    ctail_*     : (t_c,)    entries beyond the per-column width cap

The width is capped at a high quantile of the nnz-per-line counts, so a
heavy tail of long lines costs a few COO entries and not a padded slot in
every line. Padding slots carry (val=0, idx=0) and are inert in every
product. The value arrays may carry a leading member axis over shared
indices (the NMFk ensemble).

The products are gathers of factor rows (``ops/ell_gather.py``, kernel K4
on the card) plus the COO tails, which stay plain torch as the JAX package
runs them outside any kernel:

    A @ H^T = gather(rvals, rcols, H^T)        + tail scatter over rows
    W^T @ A = gather(cvals, crows, W)^T        + tail scatter over cols

The KL ratio U = A / (W H + eps) is formed per orientation from the same
gathered rows (U is zero wherever A is), so each KL product costs one
gather. Unlike the JAX package, no gate keeps the kernel off: K4 runs on
every ELL product on the card, single solves and ensembles alike. On a
p_r x p_c grid each rank packs its own block (:func:`grid_ell_pack`), and
``acc`` returns a product's partial sums for the grid to add up.
"""
from __future__ import annotations

import numpy as np
import torch

from . import sparse
from .ell_gather import ell_gather_product
from .linalg import acc_dtype

# Time model constants, as chip_smoke.py's [model] line reads them on one
# H100 80GB HBM3 at a 700 W power limit: K4's mean over its two plain
# orientations at the NYTimes bag-of-words shape (300000 x 102660, 69.6 M
# nnz), and the mean of K1, K2a and K2b at 57600 x 38400, both at k = 32
ELL_S_PER_SLOT = 1.75e-11   # K4 seconds per gathered slot (one nonzero)
DENSE_S_PER_ELEM = 4.96e-12  # K1/K2 seconds per element of A

# a grid block's ELL slots a nonzero, at most (grid_ell_pack): a block
# whose occupied lines pass the cap policy may still hold mostly empty ones
GRID_MAX_SLOTS = 16

FIELDS = ("rvals", "rcols", "rtail_d", "rtail_r", "rtail_c",
          "cvals", "crows", "ctail_d", "ctail_r", "ctail_c")


class EllSparse:
    """Dual-orientation capped-width ELLPACK matrix (module docstring)."""

    _pydnmfk_sparse = True            # recognized by linalg.is_sparse

    def __init__(self, rvals, rcols, rtail_d, rtail_r, rtail_c,
                 cvals, crows, ctail_d, ctail_r, ctail_c, shape, nse):
        self.rvals = rvals
        self.rcols = rcols
        self.rtail_d = rtail_d
        self.rtail_r = rtail_r
        self.rtail_c = rtail_c
        self.cvals = cvals
        self.crows = crows
        self.ctail_d = ctail_d
        self.ctail_r = ctail_r
        self.ctail_c = ctail_c
        self.shape = (int(shape[0]), int(shape[1]))
        self.nse = int(nse)

    @property
    def dtype(self):
        return self.rvals.dtype

    @property
    def device(self):
        return self.rvals.device

    @property
    def data(self):
        """Flat values covering every entry once (padding slots are zero,
        inert in sums and norms)."""
        return torch.cat([self.rvals.flatten(-2), self.rtail_d], -1)

    def astype(self, dtype) -> "EllSparse":
        values = ("rvals", "rtail_d", "cvals", "ctail_d")
        return EllSparse(*(getattr(self, f).to(dtype) if f in values
                           else getattr(self, f) for f in FIELDS),
                         self.shape, self.nse)

    def to(self, device) -> "EllSparse":
        return EllSparse(*(getattr(self, f).to(device) for f in FIELDS),
                         self.shape, self.nse)


def ell_pack(A: sparse.SparseTriplet, max_blowup: float = 4.0,
             return_perms: bool = False, cap_q: float = 0.995, w_cap=None,
             max_tail_frac: float = 0.25, occupied: bool = False):
    """Triplet -> EllSparse, in torch on A's device.

    The ELL width of each orientation is the ``cap_q`` quantile of the
    nnz-per-line counts (``w_cap`` overrides it); entries beyond it go to
    the COO tails. Returns None when even the capped storage blows up
    (> max_blowup * mean + 8) or the tails pass ``max_tail_frac`` of nnz;
    ``occupied=True`` takes the mean over the lines that hold a nonzero
    (a grid's block, :func:`grid_ell_pack`).
    The arrays equal those of ``pydnmfk_tpu/ops/ell.py::ell_pack``: the
    quantile is numpy's, on the (dim,) counts brought to the host, and the
    order is a stable sort by line.

    ``return_perms=True`` also returns (rperm (m, w_r), cperm (n, w_c),
    rtail_perm (t_r,), ctail_perm (t_c,)): slot -> original nnz index
    (padding slots = nnz), through which the NMFk ensemble gathers its
    perturbed flat values into both orientations (:func:`ell_with_data`)."""
    m, n = A.shape
    rows, cols, vals = A.rows.long(), A.cols.long(), A.data
    nnz = vals.shape[-1]
    if nnz == 0:
        return None
    dev = vals.device

    def pack(keys, others, dim):
        counts = torch.bincount(keys, minlength=dim)
        top = max(int(counts.max()), 1)
        w = int(w_cap) if w_cap else max(
            int(np.quantile(counts.cpu().numpy(), cap_q)), 1)
        w = min(w, top)
        lines = int((counts > 0).sum()) if occupied else dim
        if w > max_blowup * max(nnz / lines, 1.0) + 8:
            return None
        order = torch.argsort(keys, stable=True)
        ks, os_, vs = keys[order], others[order], vals[order]
        starts = torch.cumsum(counts, 0) - counts
        slot = torch.arange(nnz, device=dev) - starts[ks]
        main = slot < w
        tail = ~main
        if int(tail.sum()) > max_tail_frac * nnz:
            return None                  # too heavy-tailed: not worth ELL
        at = ks[main] * w + slot[main]
        v = torch.zeros(dim * w, dtype=vals.dtype, device=dev)
        i = torch.zeros(dim * w, dtype=torch.int32, device=dev)
        p = torch.full((dim * w,), nnz, dtype=torch.int32, device=dev)
        v[at] = vs[main]
        i[at] = os_[main].to(torch.int32)
        p[at] = order[main].to(torch.int32)
        return (v.view(dim, w), i.view(dim, w), vs[tail],
                ks[tail].to(torch.int32), os_[tail].to(torch.int32),
                p.view(dim, w), order[tail].to(torch.int32))

    r = pack(rows, cols, m)
    c = pack(cols, rows, n) if r is not None else None
    if c is None:
        return None
    E = EllSparse(r[0], r[1], r[2], r[3], r[4],
                  c[0], c[1], c[2], c[4], c[3],     # ctail: (d, row, col)
                  (m, n), nnz)
    if return_perms:
        return E, r[5], c[5], r[6], c[6]
    return E


def grid_ell_pack(block: sparse.SparseTriplet):
    """:func:`ell_pack` of a rank's block of a sparse A on a grid, with its
    perms (``pydnmfk_tpu/ops/ell.py::grid_ell_pack``, the same cap
    policy). The JAX package shares one width per orientation across
    blocks, as XLA's SPMD shapes need; each rank here packs its own block
    at its own widths, and counts the blow-up over the lines that hold a
    nonzero: a block of a matrix whose row panels each use a share of the
    columns (a topic model's documents) has mostly empty column lines,
    which would pull the mean line under the width of the lines it holds.
    Those lines then cost padding slots that K4 gathers from row 0
    (``PERF.md`` times K4 on such a block against the triplet), at most
    ``GRID_MAX_SLOTS`` a nonzero in either orientation. A block
    with no nonzeros packs as lines of one padding slot and no tails, so
    that an empty block does not refuse the grid's ELL. None where the
    block refuses."""
    if block.nse:
        packed = ell_pack(block, return_perms=True, occupied=True)
        too_many = lambda vals: (vals.numel() > GRID_MAX_SLOTS * block.nse
                                 + 8 * vals.shape[0])
        if packed and (too_many(packed[0].rvals) or too_many(packed[0].cvals)):
            return None
        return packed
    (m, n), dev = block.shape, block.device
    line = lambda dim, dt: torch.zeros((dim, 1), dtype=dt, device=dev)
    none = lambda dt: torch.zeros(0, dtype=dt, device=dev)
    i32, dt = torch.int32, block.dtype
    E = EllSparse(line(m, dt), line(m, i32), none(dt), none(i32), none(i32),
                  line(n, dt), line(n, i32), none(dt), none(i32), none(i32),
                  (m, n), 0)
    return E, line(m, i32), line(n, i32), none(i32), none(i32)


def ell_with_data(E: EllSparse, rperm, cperm, rtail_perm, ctail_perm, data):
    """E's pattern carrying the flat nnz values ``data`` ((..., nnz), in the
    triplet's order), gathered into both orientations through
    ``ell_pack``'s slot -> nnz perms; padding slots get zero."""
    padded = torch.cat([data, data.new_zeros((*data.shape[:-1], 1))], -1)
    return EllSparse(padded[..., rperm], E.rcols, data[..., rtail_perm],
                     E.rtail_r, E.rtail_c, padded[..., cperm], E.crows,
                     data[..., ctail_perm], E.ctail_r, E.ctail_c, E.shape,
                     E.nse)


def ell_a_ht(A: EllSparse, H, acc: bool = False):
    """A @ H^T -> (..., m, k)."""
    out = ell_gather_product(A.rvals, A.rcols, H.mT.contiguous())
    if A.rtail_d.shape[-1]:
        out = out + sparse.a_ht(A.rtail_d, A.rtail_r, A.rtail_c, H,
                                A.shape[0])
    return sparse.rounded(out, A, H, acc)


def ell_wt_a(A: EllSparse, W, acc: bool = False):
    """W^T @ A -> (..., k, n)."""
    out = ell_gather_product(A.cvals, A.crows, W.contiguous())
    if A.ctail_d.shape[-1]:
        out = out + sparse.wt_a(A.ctail_d, A.ctail_r, A.ctail_c, W,
                                A.shape[1]).mT
    return sparse.rounded(out.mT, A, W, acc)


def ell_kl_uht(A: EllSparse, W, H, eps, acc: bool = False):
    """(A / (WH + eps)) @ H^T -> (..., m, k); U shares A's pattern."""
    out = ell_gather_product(A.rvals, A.rcols, H.mT.contiguous(),
                             W.contiguous(), eps)
    if A.rtail_d.shape[-1]:
        wh = sparse.sddmm(W, H, A.rtail_r, A.rtail_c)
        u = A.rtail_d.to(wh.dtype) / (wh + eps)
        out = out + sparse.a_ht(u, A.rtail_r, A.rtail_c, H, A.shape[0])
    return sparse.rounded(out, A, W, acc)


def ell_kl_wtu(A: EllSparse, W, H, eps, acc: bool = False):
    """W^T @ (A / (WH + eps)) -> (..., k, n)."""
    out = ell_gather_product(A.cvals, A.crows, W.contiguous(),
                             H.mT.contiguous(), eps)
    if A.ctail_d.shape[-1]:
        wh = sparse.sddmm(W, H, A.ctail_r, A.ctail_c)
        u = A.ctail_d.to(wh.dtype) / (wh + eps)
        out = out + sparse.wt_a(u, A.ctail_r, A.ctail_c, W, A.shape[1]).mT
    return sparse.rounded(out.mT, A, W, acc)


def ell_col_sqsum(A: EllSparse):
    """Per-column sum of squares -> (..., n)."""
    c = A.cvals.to(acc_dtype(A.cvals.dtype))
    out = (c * c).sum(-1)
    if A.ctail_d.shape[-1]:
        out = out + sparse.col_sqsum(A.ctail_d, A.ctail_c, A.shape[1])
    return out


def ell_time_model(m: int, n: int, nse: int, k: int) -> tuple:
    """(t_ell, t_dense): rough seconds of one A-sized product on the card,
    by the ELL gather path (K4) and by the dense kernels (K1/K2).

    K4 gathers one k-float row of the factor table per nonzero, served from
    L2, so its time grows with the slots and, past one 128-byte row (k >
    32), with the row's bytes. K1/K2 at k = 32 are bound by f32 FMAs on the
    CUDA cores, so their time grows with m * n. The constants are the
    card's own (module top). Coarse on purpose: it only has to find the
    side of a crossover near a density of DENSE_S_PER_ELEM /
    ELL_S_PER_SLOT (about 0.28 at k = 32)."""
    t_ell = nse * ELL_S_PER_SLOT * max(1.0, k / 32)
    t_dense = m * n * DENSE_S_PER_ELEM
    return t_ell, t_dense
