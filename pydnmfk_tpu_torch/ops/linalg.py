"""Dense linear-algebra primitives of the NMF updates.

Port of the dense parts of ``pydnmfk_tpu/ops/linalg.py``. These stay plain
PyTorch, as the JAX package leaves them to XLA. Every function takes a single
matrix or a stack of them with the ensemble member as the leading axis.

Precision policy: f32 products run in true f32 (TF32 off, PyTorch's default
for matrix products); f64 runs in f64. A bf16-stored A meets an f32 factor as
the JAX package's mixed-precision rule has it: both operands rounded to bf16,
products summed in f32, result in f32.
"""
from __future__ import annotations

import torch


def acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """Accumulate low-precision values in f32; keep f64."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Matrix product with f32 (or f64) accumulation.

    Same-dtype f32/f64 operands multiply as they are. Mixed dtypes round both
    operands to the narrower one, accumulate in the wider one's accumulation
    dtype and return the wider dtype (``pydnmfk_tpu/ops/linalg.py:81-88``):
    bf16 operands are widened exactly to f32 before the f32 product."""
    if a.dtype == b.dtype and a.dtype in (torch.float32, torch.float64):
        return torch.matmul(a, b)
    narrow, wide = ((a.dtype, b.dtype)
                    if torch.finfo(a.dtype).bits <= torch.finfo(b.dtype).bits
                    else (b.dtype, a.dtype))
    acc = acc_dtype(wide)
    out = torch.matmul(a.to(narrow).to(acc), b.to(narrow).to(acc))
    return out.to(wide)


def gram(X: torch.Tensor) -> torch.Tensor:
    """X^T X -> (k, k)."""
    return matmul(X.mT, X)


def gram_t(X: torch.Tensor) -> torch.Tensor:
    """X X^T -> (k, k) for row-major factors H (k, n)."""
    return matmul(X, X.mT)


def matmul_WTA(W: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
    """W^T A -> (k, n)."""
    return matmul(W.mT, A)


def matmul_AHT(A: torch.Tensor, H: torch.Tensor) -> torch.Tensor:
    """A H^T -> (m, k)."""
    return matmul(A, H.mT)


def sum_axis(X: torch.Tensor, axis: int) -> torch.Tensor:
    return X.to(acc_dtype(X.dtype)).sum(dim=axis).to(X.dtype)


def _residual_sums(A, W, H, chunk, per_column):
    """Sums of (A - WH)^2 and A^2 over rows, for all columns or per column,
    over row slabs of ``chunk`` rows so that the m x n residual (and W H)
    never exists whole; slicing A makes views, never a copy."""
    acc = acc_dtype(A.dtype)
    m = A.shape[0]
    step = chunk if chunk and chunk < m else m
    shape = (A.shape[1],) if per_column else ()
    num = torch.zeros(shape, dtype=acc, device=A.device)
    den = torch.zeros(shape, dtype=acc, device=A.device)
    dims = (0,) if per_column else (0, 1)
    for r0 in range(0, m, step):
        a = A[r0:r0 + step].to(acc)
        r = a - matmul(W[r0:r0 + step], H).to(acc)
        num += (r * r).sum(dim=dims)
        den += (a * a).sum(dim=dims)
    return num, den


def relative_error(A: torch.Tensor, W: torch.Tensor, H: torch.Tensor,
                   chunk: int = 0) -> torch.Tensor:
    """||A - W H||_F / ||A||_F (reference pyDNMF.py:204-210); one value per
    member for a stack. ``chunk`` > 0 bounds the residual to that many rows
    (linalg.py:193-207)."""
    if A.dim() == 3:
        return torch.stack([relative_error(a, w, h, chunk)
                            for a, w, h in zip(A, W, H)])
    num, den = _residual_sums(A, W, H, chunk, per_column=False)
    return torch.sqrt(num) / torch.sqrt(den)


def column_error(A: torch.Tensor, W: torch.Tensor, H: torch.Tensor,
                 chunk: int = 0) -> torch.Tensor:
    """Per-column relative L2 error, length n (reference pyDNMF.py:220-239).
    ``chunk`` as in relative_error."""
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


def normalize_features(W: torch.Tensor, H: torch.Tensor, eps: float):
    """L1-normalize W columns, rescale H rows (reference pyDNMF.py:184-194)."""
    s = sum_axis(W, axis=-2).unsqueeze(-2)            # (..., 1, k)
    return W / (s + eps), H * s.mT
