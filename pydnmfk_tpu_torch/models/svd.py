"""Truncated SVD and NNDSVD (non-negative SVD) initialization.

Port of ``pydnmfk_tpu/models/svd.py`` (reference ``DistSVD``,
pyDNMFk/dist_svd.py:9-267). The top k singular triplets come from one
``eigh`` of the smaller Gram matrix while min(m, n) <= 8192, else from
randomized subspace iteration.

On a p_r x p_c grid (``grid``) A stays in its blocks, as the reference
keeps it rank-sharded (dist_svd.py:89-94, :112-115; JAX ``svd.py:60-175``):
the Gram of the short side is the blocks' panel products summed over the
grid (each rank gathers the row panel, or column panel, of A that its
block lies in: min(m, n) <= 8192 bounds it); the randomized path's
products A Z and A^T Q are local products of A's block, summed over 'c'
(or 'r') and gathered over the other axis, so that the panels, the ``eigh``
and U, S, V are whole and the same on every rank, and each rank keeps its
blocks of the NNDSVD factors. NNDSVD's +/-
construction (reference :233-256) is sign-invariant for flag 1, so the
eigenvectors' arbitrary signs do not reach its factors; the reference's
``UP_norm / p`` processor-count scale (:250-251) is a uniform column scale
that the final L1 normalize-by-W cancels, and is dropped, as in JAX.
"""
from __future__ import annotations

import torch

from ..ops import linalg

_EXACT_GRAM_LIMIT = 8192   # eigh of the Gram up to this min(m, n)


def _panel_qr(Y: torch.Tensor) -> torch.Tensor:
    """Orthonormal basis of a tall panel by dense reduced QR at the
    accumulation dtype (an exactly low-rank A breaks Cholesky-QR)."""
    return torch.linalg.qr(Y.to(linalg.acc_dtype(Y.dtype)), mode="reduced")[0]


def _spans(A, grid):
    """((r0, r1, m), (c0, c1, n)): where A, or this rank's block of it on a
    grid (``GridContext.span``), lies."""
    if grid is None:
        m, n = A.shape[-2:]
        return (0, m, m), (0, n, n)
    return grid.span(A.shape[-2], "r"), grid.span(A.shape[-1], "c")


def _a_times(A, Z, grid=None, spans=None):
    """A Z for a Z (..., n, b) that every rank holds whole; on a grid A is
    this rank's block (at ``spans``) and A Z comes back whole on every
    rank."""
    if grid is None:
        return linalg.matmul(A, Z)
    c0, c1, _ = spans[1]
    part = grid.sum(linalg.matmul(A, Z[..., c0:c1, :]), "c")
    return grid.gather(part, "r", -2)


def _at_times(A, Q, grid=None, spans=None):
    """A^T Q for a Q (..., m, b) that every rank holds whole; on a grid
    whole on every rank."""
    if grid is None:
        return linalg.matmul(A.mT, Q)
    r0, r1, _ = spans[0]
    part = grid.sum(linalg.matmul(A.mT, Q[..., r0:r1, :]), "r")
    return grid.gather(part, "c", -2)


def _svd_gram(A: torch.Tensor, k: int, grid=None, spans=None):
    """Exact top-k SVD by ``eigh`` of the smaller Gram matrix, singular
    values in descending order; A may be a stack (..., m, n). Returns (S
    (..., k), U (..., m, k), Vt (..., k, n)). On a grid A is this rank's
    block (at ``spans``), and S, U and Vt are whole."""
    spans = spans or _spans(A, grid)
    m, n = spans[0][2], spans[1][2]
    Af = A.to(linalg.acc_dtype(A.dtype))
    tall = m >= n
    if grid is None:
        G = linalg.gram(Af) if tall else linalg.gram_t(Af)
    elif tall:
        panel = grid.gather(Af, "c", -1)             # A's row panel i
        G = grid.sum(linalg.matmul(panel.mT, panel), "r", everywhere=True)
    else:
        panel = grid.gather(Af, "r", -2)             # A's column panel j
        G = grid.sum(linalg.matmul(panel, panel.mT), "c", everywhere=True)
    evals, evecs = torch.linalg.eigh(G)              # ascending
    X = evecs.flip(-1)[..., :k]
    S = torch.sqrt(evals.flip(-1)[..., :k].clamp_min(0.0))
    if tall:
        V = X
        U = _a_times(Af, V, grid, spans) / S.clamp_min(1e-30).unsqueeze(-2)
    else:
        U = X
        V = _at_times(Af, U, grid, spans) / S.clamp_min(1e-30).unsqueeze(-2)
    return S, U, V.mT


def _svd_randomized(A: torch.Tensor, generator: torch.Generator, k: int,
                    iters: int = 12, oversample: int = 10, tol: float = 1e-4,
                    grid=None, spans=None):
    """Randomized subspace iteration for a large min(m, n): a panel of b =
    k + oversample columns along the long axis, re-orthonormalized after
    each X (X^T Q) product, until its rotation sqrt((b - ||Q^T Q'||_F^2) /
    b) falls to ``tol`` or after ``iters`` steps. The stop test reads that
    one number on the host each step (at most ``iters`` reads, at init
    only). The Gaussian start comes from ``generator``, so the panel
    differs from JAX's; the subspace it converges to does not. On a grid
    A is this rank's block (at ``spans``); the panels are whole on every
    rank, and so is the stop test's number."""
    spans = spans or _spans(A, grid)
    m, n = spans[0][2], spans[1][2]
    b = min(k + oversample, min(m, n))
    acc = linalg.acc_dtype(A.dtype)
    Af = A.to(acc)
    tall = m >= n
    # X Z and X^T Q of X = A or A^T, the long axis leading
    X_times = (lambda Z: _a_times(Af, Z, grid, spans)) if tall else (
        lambda Z: _at_times(Af, Z, grid, spans))
    Xt_times = (lambda Q: _at_times(Af, Q, grid, spans)) if tall else (
        lambda Q: _a_times(Af, Q, grid, spans))
    G = torch.randn((n if tall else m, b), generator=generator, dtype=acc,
                    device=A.device)
    Q = _panel_qr(X_times(G))
    i, delta = 0, float("inf")
    while i < iters and delta > tol:
        Qn = _panel_qr(X_times(Xt_times(Q)))
        ovl = linalg.matmul(Q.mT, Qn)                # (b, b)
        delta = float(torch.sqrt(torch.clamp_min(
            b - (ovl * ovl).sum(), 0.0) / b))
        Q, i = Qn, i + 1
    Bs, Bu, Bvt = _svd_gram(Xt_times(Q).mT, k)       # Q^T X: (b, small)
    U_big = linalg.matmul(Q, Bu)                     # (big, k)
    if tall:
        return Bs, U_big, Bvt
    return Bs, Bvt.mT, U_big.mT


def _nnsvd_from_svd(S, U, Vt, eps: float, flag: int = 1):
    """NNDSVD factors from SVD factors (reference :233-256), then the L1
    normalize-by-W of reference :68-78; works on a stack."""
    if flag == 0:
        W = U.clamp_min(0.0)
        H = (S.unsqueeze(-1) * Vt).clamp_min(0.0)
    else:
        V = Vt.mT
        UP, UN = U.clamp_min(0.0), (-U).clamp_min(0.0)
        VP, VN = V.clamp_min(0.0), (-V).clamp_min(0.0)
        norm = lambda X: torch.sqrt((X * X).sum(-2, keepdim=True))
        UP_n, UN_n, VP_n, VN_n = norm(UP), norm(UN), norm(VP), norm(VN)
        S = S.unsqueeze(-2)
        mp = torch.sqrt(UP_n * VP_n * S)
        mn = torch.sqrt(UN_n * VN_n * S)
        use_p = mp > mn
        W = torch.where(use_p, mp * UP / (UP_n + eps), mn * UN / (UN_n + eps))
        H = torch.where(use_p, mp * VP / (VP_n + eps),
                        mn * VN / (VN_n + eps)).mT
    s = W.sum(-2, keepdim=True) + eps
    return W / s, H * s.mT


def _blocks(W, H, spans):
    """This rank's blocks (at ``spans``) of whole W (..., m, k) and H
    (..., k, n)."""
    (r0, r1, _), (c0, c1, _) = spans
    return W[..., r0:r1, :], H[..., c0:c1]


def nnsvd_factors(A: torch.Tensor, k: int, eps: float, flag: int = 1,
                  grid=None):
    """NNDSVD init (W, H) of one matrix or of every member of a stack
    (..., m, n) at once, by the exact Gram path (``svd.py:200-205``, which
    JAX vmaps over the ensemble). On a grid A is this rank's block of the
    stack, and (W, H) its blocks."""
    spans = _spans(A, grid)
    W, H = _nnsvd_from_svd(*_svd_gram(A, k, grid, spans), eps, flag)
    return _blocks(W, H, spans)


class DistSVD:
    """The reference DistSVD's API (svd, nnsvd, rel_error) on one device,
    or on this rank's block of A on a grid (``svd.py:208-258``)."""

    def __init__(self, k: int = 4,
                 eps: float = float(torch.finfo(torch.float32).eps),
                 seed: int = 0, grid=None):
        self.k = k
        self.eps = eps
        self.seed = seed
        self.grid = grid

    def svd(self, A: torch.Tensor, spans=None):
        """Top-k singular triplets: (S (k,), U (m, k), Vt (k, n)), whole on
        every rank of a grid."""
        spans = spans or _spans(A, self.grid)
        if min(spans[0][2], spans[1][2]) <= _EXACT_GRAM_LIMIT:
            return _svd_gram(A, self.k, self.grid, spans)
        generator = torch.Generator(A.device)
        generator.manual_seed(self.seed)
        return _svd_randomized(A, generator, self.k, grid=self.grid,
                               spans=spans)

    def rel_error(self, A, U, S, Vt) -> float:
        """||A - U diag(S) Vt||_F / ||A||_F (reference :188-197), over row
        slabs (``linalg.relative_error``); U and Vt whole."""
        Ub, Vtb = _blocks(U * S, Vt, _spans(A, self.grid))
        chunk = linalg.error_chunk_rows(*A.shape)
        return float(linalg.relative_error(A, Ub, Vtb, chunk, self.grid))

    def nnsvd(self, A: torch.Tensor, flag: int = 1, verbose: int = 0):
        """Boutsidis-style NNDSVD factors (reference :199-267): (W, H),
        L1-normalized by W (on a grid this rank's blocks); with
        ``verbose`` also a dict of the SVD's and the NNDSVD's
        reconstruction errors."""
        spans = _spans(A, self.grid)
        S, U, Vt = self.svd(A, spans)
        W, H = _nnsvd_from_svd(S, U, Vt, self.eps, flag)
        blocks = _blocks(W, H, spans)
        if not verbose:
            return blocks
        errors = {"recon_err_svd": self.rel_error(A, U, S, Vt),
                  # the W scale cancels against H's
                  "recon_err_nnsvd": self.rel_error(
                      A, W, torch.ones(self.k, dtype=W.dtype,
                                       device=W.device), H)}
        return blocks, errors
