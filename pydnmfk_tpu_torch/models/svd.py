"""Truncated SVD and NNDSVD (non-negative SVD) initialization.

Port of ``pydnmfk_tpu/models/svd.py`` (reference ``DistSVD``,
pyDNMFk/dist_svd.py:9-267) on one device, where A is never sharded. The top
k singular triplets come from one ``eigh`` of the smaller Gram matrix while
min(m, n) <= 8192, else from randomized subspace iteration. NNDSVD's +/-
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


def _svd_gram(A: torch.Tensor, k: int):
    """Exact top-k SVD by ``eigh`` of the smaller Gram matrix, singular
    values in descending order; A may be a stack (..., m, n). Returns (S
    (..., k), U (..., m, k), Vt (..., k, n))."""
    m, n = A.shape[-2:]
    Af = A.to(linalg.acc_dtype(A.dtype))
    tall = m >= n
    G = linalg.gram(Af) if tall else linalg.gram_t(Af)
    evals, evecs = torch.linalg.eigh(G)              # ascending
    X = evecs.flip(-1)[..., :k]
    S = torch.sqrt(evals.flip(-1)[..., :k].clamp_min(0.0))
    if tall:
        V = X
        U = linalg.matmul(Af, V) / S.clamp_min(1e-30).unsqueeze(-2)
    else:
        U = X
        V = linalg.matmul(Af.mT, U) / S.clamp_min(1e-30).unsqueeze(-2)
    return S, U, V.mT


def _svd_randomized(A: torch.Tensor, generator: torch.Generator, k: int,
                    iters: int = 12, oversample: int = 10, tol: float = 1e-4):
    """Randomized subspace iteration for a large min(m, n): a panel of b =
    k + oversample columns along the long axis, re-orthonormalized after
    each X (X^T Q) product, until its rotation sqrt((b - ||Q^T Q'||_F^2) /
    b) falls to ``tol`` or after ``iters`` steps. The stop test reads that
    one number on the host each step (at most ``iters`` reads, at init
    only). The Gaussian start comes from ``generator``, so the panel
    differs from JAX's; the subspace it converges to does not."""
    m, n = A.shape
    b = min(k + oversample, min(m, n))
    acc = linalg.acc_dtype(A.dtype)
    Af = A.to(acc)
    tall = m >= n
    X = Af if tall else Af.mT                        # long axis leading
    G = torch.randn((X.shape[1], b), generator=generator, dtype=acc,
                    device=A.device)
    Q = _panel_qr(linalg.matmul(X, G))
    i, delta = 0, float("inf")
    while i < iters and delta > tol:
        Qn = _panel_qr(linalg.matmul(X, linalg.matmul(X.mT, Q)))
        ovl = linalg.matmul(Q.mT, Qn)                # (b, b)
        delta = float(torch.sqrt(torch.clamp_min(
            b - (ovl * ovl).sum(), 0.0) / b))
        Q, i = Qn, i + 1
    Bs, Bu, Bvt = _svd_gram(linalg.matmul(Q.mT, X), k)   # (b, small)
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


def nnsvd_factors(A: torch.Tensor, k: int, eps: float, flag: int = 1):
    """NNDSVD init (W, H) of one matrix or of every member of a stack
    (..., m, n) at once, by the exact Gram path (``svd.py:200-205``, which
    JAX vmaps over the ensemble)."""
    return _nnsvd_from_svd(*_svd_gram(A, k), eps, flag)


class DistSVD:
    """The reference DistSVD's API (svd, nnsvd, rel_error) on one device
    (``svd.py:208-258`` without the mesh)."""

    def __init__(self, k: int = 4,
                 eps: float = float(torch.finfo(torch.float32).eps),
                 seed: int = 0):
        self.k = k
        self.eps = eps
        self.seed = seed

    def svd(self, A: torch.Tensor):
        """Top-k singular triplets: (S (k,), U (m, k), Vt (k, n))."""
        if min(A.shape) <= _EXACT_GRAM_LIMIT:
            return _svd_gram(A, self.k)
        generator = torch.Generator(A.device)
        generator.manual_seed(self.seed)
        return _svd_randomized(A, generator, self.k)

    def rel_error(self, A, U, S, Vt) -> float:
        """||A - U diag(S) Vt||_F / ||A||_F (reference :188-197), over row
        slabs (``linalg.relative_error``)."""
        chunk = linalg.error_chunk_rows(*A.shape)
        return float(linalg.relative_error(A, U * S, Vt, chunk))

    def nnsvd(self, A: torch.Tensor, flag: int = 1, verbose: int = 0):
        """Boutsidis-style NNDSVD factors (reference :199-267): (W, H),
        L1-normalized by W; with ``verbose`` also a dict of the SVD's and
        the NNDSVD's reconstruction errors."""
        S, U, Vt = self.svd(A)
        W, H = _nnsvd_from_svd(S, U, Vt, self.eps, flag)
        if not verbose:
            return W, H
        errors = {"recon_err_svd": self.rel_error(A, U, S, Vt),
                  # the W scale cancels against H's
                  "recon_err_nnsvd": self.rel_error(
                      A, W, torch.ones(self.k, dtype=W.dtype,
                                       device=W.device), H)}
        return (W, H), errors
