"""Linear-algebra primitives of the NMF updates.

Port of ``pydnmfk_tpu/ops/linalg.py`` on one device. The dense products stay
plain PyTorch, as the JAX package leaves them to XLA. Every function takes a
single matrix or a stack of them with the ensemble member as the leading
axis. A sparse A (``ops/sparse.py`` triplet, ``ops/ell.py`` dual ELL) takes
the sparse products, and its errors come from the Gram identity, so the
dense m x n residual never exists.

Precision policy (``pydnmfk_tpu/ops/linalg.py:60-88``): f32 products run
in true f32 (TF32 off, PyTorch's default for matrix products); f64 runs in
f64. A bf16 or f16 product sums in f32 and returns its half dtype. Mixed
floats (a bf16- or f16-stored A against an f32 factor) round both operands
to the narrower dtype, sum in f32 and return the wider dtype. A
uint8-quantized A (:func:`quantize_uint8`) takes the integer rule: bf16
operands (exact for 8-bit values), f32 sums, the factor's dtype out. On the
CPU a half operand is widened exactly to f32 for the product; on the card
the half operands go to cuBLAS as they are, summed in f32, so an A-sized
half operand is never copied to f32.
"""
from __future__ import annotations

import contextlib

import torch

HALF = (torch.bfloat16, torch.float16)


def is_sparse(x) -> bool:
    """True for the port's sparse formats (SparseTriplet, EllSparse)."""
    return getattr(x, "_pydnmfk_sparse", False)


def acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """Accumulate low-precision values in f32; keep f64."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Matrix product with f32 (or f64) sums, by the module's precision
    policy. Same-dtype f32/f64 operands multiply as they are; an integer
    operand takes the integer rule (:func:`_matmul_int`)."""
    if a.dtype == b.dtype and a.dtype in (torch.float32, torch.float64):
        return torch.matmul(a, b)
    if not (a.dtype.is_floating_point and b.dtype.is_floating_point):
        return _matmul_int(a, b)
    narrow, wide = ((a.dtype, b.dtype)
                    if torch.finfo(a.dtype).bits <= torch.finfo(b.dtype).bits
                    else (b.dtype, a.dtype))
    return _product(a.to(narrow), b.to(narrow), wide)


def _product(a: torch.Tensor, b: torch.Tensor, out: torch.dtype):
    """a @ b of two operands of one dtype, summed at the accumulation dtype
    of ``out`` and returned at ``out``."""
    acc = acc_dtype(out)
    if a.dtype not in HALF:
        return torch.matmul(a.to(acc), b.to(acc)).to(out)
    if a.device.type != "cuda" or acc != torch.float32:
        # exact: a product of two half values is an f32 value
        return torch.matmul(a.to(acc), b.to(acc)).to(out)
    with f32_sums():
        if out == a.dtype:
            return torch.matmul(a, b)
        # f32 out of half operands (cuBLAS's only mixed output); a small
        # operand of any other rank is widened
        if a.dim() == b.dim() == 2:
            return torch.mm(a, b, out_dtype=torch.float32).to(out)
        if a.dim() == b.dim() == 3:
            return torch.bmm(a, b, out_dtype=torch.float32).to(out)
        return torch.matmul(a.float(), b.float()).to(out)


@contextlib.contextmanager
def f32_sums():
    """Inside the block cuBLAS sums half products in f32, as the JAX
    package's ``preferred_element_type`` asks (reduced-precision reductions
    off); the caller's settings come back when it ends."""
    m = torch.backends.cuda.matmul
    saved = (m.allow_bf16_reduced_precision_reduction,
             m.allow_fp16_reduced_precision_reduction)
    m.allow_bf16_reduced_precision_reduction = False
    m.allow_fp16_reduced_precision_reduction = False
    try:
        yield
    finally:
        (m.allow_bf16_reduced_precision_reduction,
         m.allow_fp16_reduced_precision_reduction) = saved


def _matmul_int(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The integer rule of ``pydnmfk_tpu/ops/linalg.py:60-80``: an 8-bit
    operand meets a non-f64 factor as bf16 operands (exact for 8-bit values)
    with f32 sums, and the result takes the float side's dtype; wider
    integers, or f64 factors, compute at the accumulation dtype."""
    int_dt, wide = ((a.dtype, b.dtype) if not a.dtype.is_floating_point
                    else (b.dtype, a.dtype))
    if not wide.is_floating_point:
        wide = torch.float32
    if int_dt.itemsize == 1 and wide != torch.float64:
        bf = torch.bfloat16
        return _product(a.to(bf), b.to(bf), wide)
    acc = acc_dtype(wide)
    return torch.matmul(a.to(acc), b.to(acc)).to(wide)


def gram(X: torch.Tensor) -> torch.Tensor:
    """X^T X -> (k, k)."""
    return matmul(X.mT, X)


def gram_t(X: torch.Tensor) -> torch.Tensor:
    """X X^T -> (k, k) for row-major factors H (k, n)."""
    return matmul(X, X.mT)


def matmul_WTA(W: torch.Tensor, A) -> torch.Tensor:
    """W^T A -> (k, n)."""
    if is_sparse(A):
        from . import ell, sparse
        if isinstance(A, ell.EllSparse):
            return ell.ell_wt_a(A, W)
        return sparse.wt_a_triplet(A, W,
                                   sparse.nnz_chunk_size(A.nse, W.shape[-1]))
    return matmul(W.mT, A)


def matmul_AHT(A, H: torch.Tensor) -> torch.Tensor:
    """A H^T -> (m, k)."""
    if is_sparse(A):
        from . import ell, sparse
        if isinstance(A, ell.EllSparse):
            return ell.ell_a_ht(A, H)
        return sparse.a_ht_triplet(A, H,
                                   sparse.nnz_chunk_size(A.nse, H.shape[-2]))
    return matmul(A, H.mT)


def sqnorm(X) -> torch.Tensor:
    """Squared Frobenius norm with f32/f64 accumulation; one value per
    member for a stack. A sparse X sums its stored values (padding slots of
    an ELL X are zero)."""
    if is_sparse(X):
        d = X.data.to(acc_dtype(X.dtype))
        return (d * d).sum(-1)
    Xa = X.to(acc_dtype(X.dtype))
    return (Xa * Xa).sum((-2, -1))


def fro_norm(X) -> torch.Tensor:
    """Frobenius norm with f32/f64 accumulation (``linalg.py:147-148``)."""
    return torch.sqrt(sqnorm(X))


def sum_axis(X: torch.Tensor, axis: int) -> torch.Tensor:
    return X.to(acc_dtype(X.dtype)).sum(dim=axis).to(X.dtype)


def _residual_sums(A, W, H, chunk, per_column, with_den=True):
    """Sums of (A - WH)^2 and A^2 (unless not ``with_den``) over rows, for
    all columns or per column, over row slabs of ``chunk`` rows so that the
    m x n residual (and W H) never exists whole; slicing A makes views,
    never a copy. As in ``linalg.py:164-212``, the direct residual (no
    chunk) is taken at the operands' dtype and a slab's at the
    accumulation dtype, which differ only for half operands."""
    acc = acc_dtype(A.dtype)
    m = A.shape[0]
    direct = not chunk or chunk >= m
    step = m if direct else chunk
    shape = (A.shape[1],) if per_column else ()
    num = torch.zeros(shape, dtype=acc, device=A.device)
    den = torch.zeros(shape, dtype=acc, device=A.device)
    dims = (0,) if per_column else (0, 1)
    for r0 in range(0, m, step):
        wh = matmul(W[r0:r0 + step], H)
        a = A[r0:r0 + step]
        if direct:
            r = (a - wh).to(acc)
        else:
            r = a.to(acc) - wh.to(acc)
        a = a.to(acc)
        num += (r * r).sum(dim=dims)
        if with_den:
            den += (a * a).sum(dim=dims)
    return num, den


def residual_sqnorm(A: torch.Tensor, W: torch.Tensor, H: torch.Tensor,
                    chunk: int = 0) -> torch.Tensor:
    """||A - W H||_F^2 of a dense A, one value per member for a stack;
    ``chunk`` as in :func:`relative_error`."""
    if A.dim() == 3:
        return torch.stack([residual_sqnorm(a, w, h, chunk)
                            for a, w, h in zip(A, W, H)])
    return _residual_sums(A, W, H, chunk, per_column=False,
                          with_den=False)[0]


def relative_error(A: torch.Tensor, W: torch.Tensor, H: torch.Tensor,
                   chunk: int = 0) -> torch.Tensor:
    """||A - W H||_F / ||A||_F (reference pyDNMF.py:204-210); one value per
    member for a stack. ``chunk`` > 0 bounds the residual to that many rows
    (linalg.py:193-207)."""
    if is_sparse(A):
        return _sparse_relative_error(A, W, H)
    if A.dim() == 3:
        return torch.stack([relative_error(a, w, h, chunk)
                            for a, w, h in zip(A, W, H)])
    num, den = _residual_sums(A, W, H, chunk, per_column=False)
    return torch.sqrt(num) / torch.sqrt(den)


def column_error(A: torch.Tensor, W: torch.Tensor, H: torch.Tensor,
                 chunk: int = 0) -> torch.Tensor:
    """Per-column relative L2 error, length n (reference pyDNMF.py:220-239).
    ``chunk`` as in relative_error."""
    if is_sparse(A):
        return _sparse_column_error(A, W, H)
    num, den = _residual_sums(A, W, H, chunk, per_column=True)
    return torch.sqrt(num / den)


def error_chunk_rows(m: int, n: int, budget_elems: int = 1 << 27) -> int:
    """Row chunk for the error passes and the plain KL products: 0 (direct)
    while an m x n slab stays under ``budget_elems`` elements (512 MB at
    f32), else a multiple of 8 rows that keeps each slab inside it
    (linalg.py:225-233, single device)."""
    if m * n <= budget_elems:
        return 0
    return max(8, (budget_elems // max(n, 1)) // 8 * 8)


def kl_divergence(A: torch.Tensor, W: torch.Tensor, H: torch.Tensor,
                  eps: float, chunk: int = 0) -> torch.Tensor:
    """Generalized KL divergence D(A || WH) = sum(A log(A / WH) - A + WH)
    of a dense A (``pydnmfk_tpu/ops/linalg.py:236-242``), summed at the
    accumulation dtype; one value per member for a stack. ``chunk`` > 0
    takes rows in slabs of that many, so that W H never exists whole."""
    if A.dim() == 3:
        return torch.stack([kl_divergence(a, w, h, eps, chunk)
                            for a, w, h in zip(A, W, H)])
    acc = acc_dtype(W.dtype if not A.dtype.is_floating_point else A.dtype)
    m = A.shape[0]
    step = m if not chunk or chunk >= m else chunk
    total = torch.zeros((), dtype=acc, device=A.device)
    for r0 in range(0, m, step):
        wh = matmul(W[r0:r0 + step], H).to(acc) + eps
        a = A[r0:r0 + step].to(acc)
        total += (torch.where(a > 0, a * torch.log((a + eps) / wh), 0.0)
                  - a + wh).sum()
    return total


def quantize_uint8(A: torch.Tensor):
    """Global-scale uint8 quantization of a nonnegative A
    (``pydnmfk_tpu/ops/linalg.py:245-284``): Q = clip(round(A / s), 0, 255)
    with s = max(A) / 255 in f32 (1 where the max is 0). Returns (Q, s), s a
    0-d f32 tensor. ``torch.round`` rounds half to even, as ``jnp.round``
    does, so Q equals the JAX package's. Rows go in slabs of
    :func:`error_chunk_rows`, so no full-size f32 temporary exists."""
    scale = A.max().to(torch.float32) / 255.0
    scale = torch.where(scale > 0, scale, torch.ones_like(scale))

    def q_block(a):
        return torch.round(a.to(torch.float32) / scale).clamp_(0, 255).to(
            torch.uint8)

    m = A.shape[-2]
    chunk = error_chunk_rows(m, A.shape[-1])
    if not chunk or chunk >= m:
        return q_block(A), scale
    Q = torch.empty(A.shape, dtype=torch.uint8, device=A.device)
    for r0 in range(0, m, chunk):
        Q[..., r0:r0 + chunk, :] = q_block(A[..., r0:r0 + chunk, :])
    return Q, scale


def normalize_features(W: torch.Tensor, H: torch.Tensor, eps: float):
    """L1-normalize W columns, rescale H rows (reference pyDNMF.py:184-194)."""
    s = sum_axis(W, axis=-2).unsqueeze(-2)            # (..., 1, k)
    return W / (s + eps), H * s.mT


# ---------------------------------------------------------------------------
# Sparse-A error identities (linalg.py:295-331). ||A - WH||^2 expands to
#   ||A||^2 - 2 <A, WH> + ||WH||^2
# with <A, WH> = sum(H o (W^T A)) and ||WH||^2 = sum((W^T W) o (H H^T)):
# every term is nnz- or k-sized. f32 cancellation limits the resolution to
# about 1e-3 of the relative error, fine for NMF errors of 1e-2..1.
# ---------------------------------------------------------------------------
def _sparse_relative_error(A, W, H):
    acc = acc_dtype(W.dtype)
    WTA = matmul_WTA(W, A).to(acc)
    a2 = sqnorm(A)
    cross = (H.to(acc) * WTA).sum((-2, -1))
    wh2 = (gram(W).to(acc) * gram_t(H).to(acc)).sum((-2, -1))
    num = (a2 - 2.0 * cross + wh2).clamp_min(0.0)
    return torch.sqrt(num) / torch.sqrt(a2)


def _sparse_column_error(A, W, H):
    from . import ell, sparse
    acc = acc_dtype(W.dtype)
    Ha = H.to(acc)
    cross = (Ha * matmul_WTA(W, A).to(acc)).sum(-2)          # (..., n)
    wh2 = (Ha * matmul(gram(W).to(acc), Ha)).sum(-2)
    if isinstance(A, ell.EllSparse):
        a2 = ell.ell_col_sqsum(A)
    else:
        a2 = sparse.col_sqsum(A.data, A.cols, A.shape[1])
    num = (a2 - 2.0 * cross + wh2).clamp_min(0.0)
    return torch.sqrt(num / a2.clamp_min(torch.finfo(acc).tiny))
