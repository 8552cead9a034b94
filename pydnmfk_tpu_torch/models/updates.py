"""One-step NMF updates (MU-Fro, MU-KL, HALS) and the BCD solver.

Port of ``pydnmfk_tpu/models/updates.py``; the numerical semantics are the
reference's (dist_nmf.py:715-751, :803-849, :873-934 and :951-1047). Inputs
are one matrix or a stack with the ensemble member as the leading axis
(JAX's vmap). A sparse A takes the products of its format
(``ops/linalg.py`` dispatches the FRO products; :func:`mu_kl_step` picks the
KL ones).

On a p_r x p_c grid (``grid``) A, W and H are this rank's blocks and every
product over W's rows or H's columns is all-reduced (``ops/linalg.py``):
the MU steps issue four all-reduces a step (A H^T and H H^T over 'c',
W^T A and W^T W over 'r'; KL: U H^T and H's row sums, W^T U and W's column
sums), HALS one more per W column (its norm), BCD's restore-or-extrapolate
choice is rank 0's objective, broadcast, so that every rank chooses alike.
"""
from __future__ import annotations

import torch

from ..ops import cuda_lib, kl, linalg


def mu_fro_step(A, W, H, eps, W_update: bool = True, grid=None):
    """Two-pass MU-Fro step: A is read once for A H^T and once for W^T A."""
    if W_update:
        HHT = linalg.gram_t(H, grid)
        AHT = linalg.matmul_AHT(A, H, grid)
        W = W * AHT / (linalg.matmul(W, HHT) + eps)
    WTW = linalg.gram(W, grid)
    WTA = linalg.matmul_WTA(W, A, grid)
    # reference: H *= AtW / (H^T W^T W)^T == WTW @ H (WTW symmetric)
    H = H * WTA / (linalg.matmul(WTW, H) + eps)
    return W, H


def mu_kl_step(A, W, H, eps, W_update: bool = True, chunk: int = 0,
               grid=None):
    """MU-KL step over the ratio products. On CUDA the products are kernels
    K2a/K2b where they take A's and the factors' dtypes
    (``cuda_lib.kernel_types``: f32 factors with an f32, bf16, f16 or uint8
    A; bf16 or f16 factors with a bf16, f16 or uint8 A); an f32 A under
    half factors, and f64 anywhere, keep the plain products (the kernels
    accumulate in f32, as ``pydnmfk_tpu/models/nmf.py:200-208`` keeps f64
    off its Pallas kernels). ``chunk`` bounds the plain products' ratio slab
    to that many rows.

    A sparse A takes its format's products: the dual ELL's gathers (kernel
    K4 on CUDA, ``ops/ell.py``) or the triplet's, over nnz chunks
    (``ops/sparse.py``). U exists only on A's nonzeros, so ``chunk`` does
    not apply. On a grid A is this rank's block in either format, and the
    block's partial products are summed over 'c' (U H^T) and 'r' (W^T U)
    (``updates.py:57-80``)."""
    if linalg.is_sparse(A):
        uht, wtu = _sparse_kl_products(A, W, grid)
    elif grid is not None:
        plain = A.is_cuda and not cuda_lib.kernel_types(A.dtype, W.dtype)
        uht = lambda a, w, h, e: kl.kl_uht_sharded(a, w, h, e, grid, chunk,
                                                   plain)
        wtu = lambda a, w, h, e: kl.kl_wtu_sharded(a, w, h, e, grid, chunk,
                                                   plain)
    elif A.is_cuda and not cuda_lib.kernel_types(A.dtype, W.dtype):
        uht = lambda a, w, h, e: kl.kl_uht_plain(a, w, h, e, chunk)
        wtu = lambda a, w, h, e: kl.kl_wtu_plain(a, w, h, e, chunk)
    else:
        uht = lambda a, w, h, e: kl.kl_uht(a, w, h, e, chunk)
        wtu = lambda a, w, h, e: kl.kl_wtu(a, w, h, e, chunk)
    if W_update:
        # H's row sums serve only the W replicas of this rank's row
        h_rowsum = linalg.sum_axis(H, -1, grid, everywhere=False)  # (..., k)
        UHT = uht(A, W, H, eps)                           # (..., m, k)
        W = W * UHT / (h_rowsum.unsqueeze(-2) + eps)
    w_colsum = linalg.sum_axis(W, -2, grid, everywhere=False)      # (..., k)
    WTU = wtu(A, W, H, eps)                               # uses the updated W
    H = H * WTU / (w_colsum.unsqueeze(-1) + eps)
    return W, H


def _sparse_kl_products(A, W, grid):
    """The KL products (U H^T, W^T U) of a sparse A's format, on a grid
    each block's partial product summed in its subgroup and rounded once
    (``ops/ell.py::gell_kl_*``, ``ops/sparse.py::rs_kl_*``)."""
    from ..ops import ell, sparse
    if isinstance(A, ell.EllSparse):
        uht, wtu = ell.ell_kl_uht, ell.ell_kl_wtu
    else:
        nc = sparse.nnz_chunk_size(A.nse, W.shape[-1])
        uht = lambda a, w, h, e, acc=False: sparse.kl_uht_sparse(
            a, w, h, e, nc, acc)
        wtu = lambda a, w, h, e, acc=False: sparse.kl_wtu_sparse(
            a, w, h, e, nc, acc)
    if grid is None:
        return uht, wtu

    def summed(f, over):
        return lambda a, w, h, e: grid.sum(f(a, w, h, e, acc=True), over).to(
            torch.promote_types(a.dtype, w.dtype))

    return summed(uht, "c"), summed(wtu, "r")


# ---------------------------------------------------------------------------
# HALS, Frobenius norm (reference FRO_HALS_update_{W,H}: 1D
# dist_nmf.py:873-934). The sweeps are Gauss-Seidel chains over the k
# columns of W and rows of H: each step is a few small products on the
# device, with no host read, so a stack of members sweeps in lockstep.
# ---------------------------------------------------------------------------
def _l2(v: torch.Tensor, grid=None) -> torch.Tensor:
    """Per-member L2 norm of the vectors v (..., m), as (..., 1), summed at
    the accumulation dtype (``linalg.sqnorm`` of one vector); on a grid v
    is a W column's row block, summed over 'r' everywhere."""
    va = v.to(linalg.acc_dtype(v.dtype))
    ss = (va * va).sum(-1, keepdim=True)
    if grid is not None:
        ss = grid.sum(ss, "r", everywhere=True)
    return torch.sqrt(ss).to(v.dtype)


def _unit(v: torch.Tensor, grid=None) -> torch.Tensor:
    """v over its L2 norm where the norm is positive (reference :889-893)."""
    ss = _l2(v, grid)
    return torch.where(ss > 0, v / ss, v)


def _hals_w_cols(W, HHT, AHT, eps, lo: int, hi: int, grid=None):
    """The reference's column-by-column W sweep over columns [lo, hi)
    (``updates.py:104-117``)."""
    W = W.clone()
    for kk in range(lo, hi):
        v = (W[..., kk] * HHT[..., kk, kk, None] + AHT[..., kk]
             - linalg.matmul(W, HHT[..., :, kk, None])[..., 0])
        W[..., kk] = _unit(v.clamp_min(eps), grid)
    return W


def _hals_h_rows(H, WTW, WTA, eps, lo: int, hi: int):
    """The reference's row-by-row H sweep over rows [lo, hi)
    (``updates.py:120-131``); reference :912 relies on L2-normalized W
    columns (WTW[kk, kk] = 1)."""
    H = H.clone()
    for kk in range(lo, hi):
        v = (H[..., kk, :] + WTA[..., kk, :]
             - linalg.matmul(WTW[..., kk, None, :], H)[..., 0, :])
        H[..., kk, :] = v.clamp_min(eps)
    return H


def _hals_w_blocked(W, HHT, AHT, eps, B: int, grid=None):
    """The same Gauss-Seidel W sweep by delayed updates in blocks of B
    columns (``updates.py:134-175``): P = W_old HHT once, an in-block
    (m, B) correction per column and one rank-B update of P per block.
    Only the summation order differs from the column sweep; the ragged
    tail k % B takes the column sweep."""
    k = W.shape[-1]
    nb = k // B
    P = linalg.matmul(W, HHT)                        # (..., m, k), W old
    W = W.clone()
    cols = torch.arange(B, device=W.device)
    for b in range(nb):
        b0 = b * B
        Wblk = W[..., b0:b0 + B]
        HHT_blk = HHT[..., b0:b0 + B, :]
        D = W.new_zeros((*W.shape[:-1], B))
        for t in range(B):
            j = b0 + t
            hseg = HHT_blk[..., :, j]
            mask = (cols < t).to(D.dtype)
            corr = linalg.matmul(D, (hseg.to(D.dtype) * mask)[..., None])
            w_old = Wblk[..., t]
            v = (w_old * hseg[..., t, None] + AHT[..., j]
                 - (P[..., j] + corr[..., 0]))
            D[..., t] = _unit(v.clamp_min(eps), grid) - w_old
        W[..., b0:b0 + B] = Wblk + D
        P = P + linalg.matmul(D, HHT_blk)
    if k % B:
        W = _hals_w_cols(W, HHT, AHT, eps, nb * B, k, grid)
    return W


def _hals_h_blocked(H, WTW, WTA, eps, B: int):
    """The blocked H sweep (``updates.py:178-212``), the mirror of
    :func:`_hals_w_blocked` without the normalization."""
    k = H.shape[-2]
    nb = k // B
    P = linalg.matmul(WTW, H)                        # (..., k, n), H old
    H = H.clone()
    rows = torch.arange(B, device=H.device)
    for b in range(nb):
        b0 = b * B
        Hblk = H[..., b0:b0 + B, :]
        WTW_blk = WTW[..., :, b0:b0 + B]
        D = H.new_zeros((*H.shape[:-2], B, H.shape[-1]))
        for t in range(B):
            j = b0 + t
            wseg = WTW_blk[..., j, :]
            mask = (rows < t).to(D.dtype)
            corr = linalg.matmul((wseg.to(D.dtype) * mask)[..., None, :], D)
            h_old = Hblk[..., t, :]
            v = h_old + WTA[..., j, :] - (P[..., j, :] + corr[..., 0, :])
            D[..., t, :] = v.clamp_min(eps) - h_old
        H[..., b0:b0 + B, :] = Hblk + D
        P = P + linalg.matmul(WTW_blk, D)
    if k % B:
        H = _hals_h_rows(H, WTW, WTA, eps, nb * B, k)
    return H


def hals_step(A, W, H, eps, W_update: bool = True, block=None, grid=None):
    """One HALS step (``updates.py:215-247``). ``block``: 0 or None is the
    reference's column sweep; 0 < block < k the delayed-update blocks of
    that size. A is read twice (A H^T, W^T A), through the kernels of its
    format where it is sparse (K4 on CUDA for the dual ELL)."""
    k = W.shape[-1]
    B = block or 0
    blocked = 0 < B < k
    if W_update:
        HHT = linalg.gram_t(H, grid)
        AHT = linalg.matmul_AHT(A, H, grid)
        W = (_hals_w_blocked(W, HHT, AHT, eps, B, grid) if blocked
             else _hals_w_cols(W, HHT, AHT, eps, 0, k, grid))
    WTW = linalg.gram(W, grid)
    WTA = linalg.matmul_WTA(W, A, grid)
    H = (_hals_h_blocked(H, WTW, WTA, eps, B) if blocked
         else _hals_h_rows(H, WTW, WTA, eps, 0, k))
    return W, H


# ---------------------------------------------------------------------------
# BCD with Nesterov-style extrapolation, Frobenius norm (reference
# FRO_BCD_update: 1D dist_nmf.py:951-1047). Unlike MU and HALS this is a
# whole inner solver.
# ---------------------------------------------------------------------------
def bcd_solve(A, W, H, eps, itr: int = 1000, rw: float = 1.0,
              obj_mode: str = "gram", chunk: int = 0, grid=None,
              col_mask=None):
    """The BCD inner loop of ``updates.py:270-368``; returns the last
    iterate (W, H), as JAX does, also where the last step restored.

    ``obj_mode`` picks the objective 0.5 ||A - W H||^2 that decides between
    restore and extrapolate: "gram" takes it from products the step
    already has, 0.5 (||A||^2 - 2 <W, A H^T> + <W^T W, H H^T>), with no
    third pass over A (its f32 resolution is about sqrt(2 eps) of the
    relative error); "residual" sums the residual over slabs of ``chunk``
    rows (0: whole), so the m x n residual never exists whole.

    On a stack every member restores or extrapolates on its own (JAX's
    ``lax.cond`` under vmap): both branches are taken and ``torch.where``
    picks per member, with no host read. The restore branch needs H_old's
    H H^T and A H^T; the state holds them at all times (HHT == gram_t(H_old),
    AHT == matmul_AHT(A, H_old): at init, after an extrapolate, which sets
    H_old = H, and after a restore, which keeps both), so the restore reads
    no A. ``eps`` is unused: the final clip is the caller's.

    ``col_mask`` (bool (K,) or (b, K)) marks the active columns of a
    K-padded solve (``models/nmf.py::_solve``): the masked-out columns of
    W are all zero, and their sums, 0, divide as 1 in the L1
    normalization (``updates.py:313-319``); the active columns keep the
    reference's unguarded division."""
    del eps
    sdt = torch.float64 if A.dtype == torch.float64 else torch.float32
    # (..., 1, 1); on a grid a block sharded along ``over``
    sq = lambda X, over="rc": linalg.sqnorm(X, grid, over)[..., None, None]
    sq_rep = lambda X: linalg.sqnorm(X)[..., None, None]   # replicated X
    acc = linalg.acc_dtype(A.dtype)
    # init (reference initWandH :951-969): scale so |W| = |H| = |A|^(1/2)
    Xnorm = sq(A)
    scale = torch.sqrt(torch.sqrt(Xnorm))
    W = W / torch.sqrt(sq(W, "r")).to(W.dtype) * scale.to(W.dtype)
    H = H / torch.sqrt(sq(H, "c")).to(H.dtype) * scale.to(H.dtype)
    Wm, Hm, W_old, H_old = W, H, W, H
    HHT, AHT = linalg.gram_t(H, grid), linalg.matmul_AHT(A, H, grid)
    obj_old = 0.5 * Xnorm
    t_old = HHTnorm = WTWnorm = torch.ones_like(Xnorm, dtype=sdt)
    for _ in range(itr):
        # W: projected Lipschitz-gradient step, then the L1 column
        # normalization of reference :1004-1011 (no eps guard)
        HHTnorm_old, HHTnorm = HHTnorm, torch.sqrt(sq_rep(HHT))
        GW = linalg.matmul(Wm, HHT) - AHT
        W = torch.clamp_min(Wm - GW / HHTnorm.to(GW.dtype), 0.0)
        colsum = linalg.sum_axis(W, axis=-2, grid=grid)
        if col_mask is not None:
            colsum = torch.where(col_mask, colsum, 1)
        W = W / colsum.unsqueeze(-2)
        WTW = linalg.gram(W, grid)
        # H
        WTWnorm_old, WTWnorm = WTWnorm, torch.sqrt(sq_rep(WTW))
        GH = linalg.matmul(WTW, Hm) - linalg.matmul_WTA(W, A, grid)
        H = torch.clamp_min(Hm - GH / WTWnorm.to(GH.dtype), 0.0)
        HHT_new = linalg.gram_t(H, grid)
        AHT_new = linalg.matmul_AHT(A, H, grid)
        if obj_mode == "gram":
            cross = (W.to(acc) * AHT_new.to(acc)).sum((-2, -1), keepdim=True)
            if grid is not None:
                cross = grid.sum(cross, "r")
            wh2 = (WTW.to(acc) * HHT_new.to(acc)).sum((-2, -1), keepdim=True)
            obj = 0.5 * (Xnorm - 2.0 * cross + wh2)
        else:
            obj = 0.5 * linalg.residual_sqnorm(A, W, H, chunk,
                                               grid)[..., None, None]
        if grid is not None:
            # WTW and HHT_new come from two subgroups: the group's first
            # rank's objective decides for its ranks (each ensemble group
            # holds other members)
            obj = grid.broadcast(obj)
        # restore or extrapolate (reference :1029-1047)
        t = (1.0 + torch.sqrt(1.0 + 4.0 * t_old ** 2)) / 2.0
        restore = obj >= obj_old
        w_ext = torch.minimum((t_old - 1.0) / t,
                              rw * torch.sqrt(HHTnorm_old / HHTnorm))
        h_ext = torch.minimum((t_old - 1.0) / t,
                              rw * torch.sqrt(WTWnorm_old / WTWnorm))
        Wm = torch.where(restore, W_old, W + w_ext.to(W.dtype) * (W - W_old))
        Hm = torch.where(restore, H_old, H + h_ext.to(H.dtype) * (H - H_old))
        W_old = torch.where(restore, W_old, W)
        H_old = torch.where(restore, H_old, H)
        HHT = torch.where(restore, HHT, HHT_new)
        AHT = torch.where(restore, AHT, AHT_new)
        obj_old = torch.where(restore, obj_old, obj)
        t_old = torch.where(restore, t_old, t)
    return W, H
