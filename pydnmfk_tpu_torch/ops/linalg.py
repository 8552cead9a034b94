"""Linear-algebra primitives of the NMF updates.

Port of ``pydnmfk_tpu/ops/linalg.py``. The dense products stay plain
PyTorch, as the JAX package leaves them to XLA. Every function takes a
single matrix or a stack of them with the ensemble member as the leading
axis. A sparse A (``ops/sparse.py`` triplet, ``ops/ell.py`` dual ELL) takes
the sparse products, and its errors come from the Gram identity, so the
dense m x n residual never exists.

On a p_r x p_c grid (``grid``, a ``parallel/mesh.py::GridContext``) the
operands are this rank's blocks: A's block (i, j), W's row block i, H's
column block j. A product or sum over W's rows is the local one all-reduced
over 'r', over H's columns over 'c', over all of A over both, with the
partial sums at the accumulation dtype (``linalg.py:93-160``). The
products (W^T A, A H^T) and Grams stay in their subgroup, whose members are
the replicas that use them; the small sums (norms, column sums) are taken
``everywhere``, the same bits on every rank of the group, because
replicas along the other axis use them too (``parallel/mesh.py``). No sum
here leaves the rank's ensemble group, whose members are its own.

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


def result_dtype(a: torch.dtype, b: torch.dtype) -> torch.dtype:
    """The dtype of :func:`matmul`'s result for operands of these dtypes."""
    if not (a.is_floating_point and b.is_floating_point):
        wide = b if not a.is_floating_point else a
        return wide if wide.is_floating_point else torch.float32
    return a if torch.finfo(a).bits >= torch.finfo(b).bits else b


def matmul(a: torch.Tensor, b: torch.Tensor, acc: bool = False
           ) -> torch.Tensor:
    """Matrix product with f32 (or f64) sums, by the module's precision
    policy. Same-dtype f32/f64 operands multiply as they are; an integer
    operand takes the integer rule (:func:`_matmul_int`). ``acc`` returns
    the sums at the accumulation dtype instead of :func:`result_dtype`
    (a grid's partial products, summed across ranks before rounding)."""
    if a.dtype == b.dtype and a.dtype in (torch.float32, torch.float64):
        return torch.matmul(a, b)
    if not (a.dtype.is_floating_point and b.dtype.is_floating_point):
        return _matmul_int(a, b, acc)
    narrow, wide = ((a.dtype, b.dtype)
                    if torch.finfo(a.dtype).bits <= torch.finfo(b.dtype).bits
                    else (b.dtype, a.dtype))
    return _product(a.to(narrow), b.to(narrow),
                    acc_dtype(wide) if acc else wide)


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


def _matmul_int(a: torch.Tensor, b: torch.Tensor, acc: bool = False
                ) -> torch.Tensor:
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
        return _product(a.to(bf), b.to(bf), acc_dtype(wide) if acc else wide)
    out = torch.matmul(a.to(acc_dtype(wide)), b.to(acc_dtype(wide)))
    return out if acc else out.to(wide)


def _summed(a, b, grid, over):
    """a @ b, on a grid the local product summed over ``over`` in its
    subgroup at the accumulation dtype, then rounded once."""
    if grid is None:
        return matmul(a, b)
    return grid.sum(matmul(a, b, acc=True), over).to(
        result_dtype(a.dtype, b.dtype))


def gram(X: torch.Tensor, grid=None) -> torch.Tensor:
    """X^T X -> (k, k); on a grid X is a row block, summed over 'r'."""
    return _summed(X.mT, X, grid, "r")


def gram_t(X: torch.Tensor, grid=None) -> torch.Tensor:
    """X X^T -> (k, k) for row-major factors H (k, n); on a grid X is a
    column block, summed over 'c'."""
    return _summed(X, X.mT, grid, "c")


def _sparse_product(A, F, orient: str, grid):
    """W^T A (``orient`` "wta", F = W) or A H^T ("aht", F = H) of a sparse
    A through its format's products: the dual ELL's gathers (K4 on the
    card) or the triplet's scatters. On a grid A is this rank's block, and
    its partial product, unrounded, is summed over 'r' (W^T A) or 'c'
    (A H^T) in its subgroup, then rounded once (``ops/sparse.py::rs_*``,
    ``ops/ell.py::gell_*``)."""
    from . import ell, sparse
    acc = grid is not None
    if isinstance(A, ell.EllSparse):
        f = ell.ell_wt_a if orient == "wta" else ell.ell_a_ht
        part = f(A, F, acc=acc)
    else:
        f = sparse.wt_a_triplet if orient == "wta" else sparse.a_ht_triplet
        k = F.shape[-1] if orient == "wta" else F.shape[-2]
        part = f(A, F, sparse.nnz_chunk_size(A.nse, k), acc=acc)
    if grid is None:
        return part
    return grid.sum(part, "r" if orient == "wta" else "c").to(
        torch.promote_types(A.dtype, F.dtype))


def matmul_WTA(W: torch.Tensor, A, grid=None) -> torch.Tensor:
    """W^T A -> (k, n); on a grid the (k, n_j) block, summed over 'r'."""
    if is_sparse(A):
        return _sparse_product(A, W, "wta", grid)
    if grid is not None:
        return _summed(W.mT, A, grid, "r")
    return matmul(W.mT, A)


def matmul_AHT(A, H: torch.Tensor, grid=None) -> torch.Tensor:
    """A H^T -> (m, k); on a grid the (m_i, k) block, summed over 'c'."""
    if is_sparse(A):
        return _sparse_product(A, H, "aht", grid)
    if grid is not None:
        return _summed(A, H.mT, grid, "c")
    return matmul(A, H.mT)


def sqnorm(X, grid=None, over: str = "rc") -> torch.Tensor:
    """Squared Frobenius norm with f32/f64 accumulation; one value per
    member for a stack. A sparse X sums its stored values (padding slots of
    an ELL X are zero). On a grid X is a block sharded along ``over``: A
    over 'rc', a W block over 'r', an H block over 'c'."""
    if is_sparse(X):
        d = X.data.to(acc_dtype(X.dtype))
        s = (d * d).sum(-1)
    else:
        Xa = X.to(acc_dtype(X.dtype))
        s = (Xa * Xa).sum((-2, -1))
    return s if grid is None else grid.sum(s, over, everywhere=True)


def fro_norm(X) -> torch.Tensor:
    """Frobenius norm with f32/f64 accumulation (``linalg.py:147-148``)."""
    return torch.sqrt(sqnorm(X))


def sum_axis(X: torch.Tensor, axis: int, grid=None,
             everywhere: bool = True) -> torch.Tensor:
    """Sums of X along ``axis``; on a grid X is a block sharded along it,
    a W block summed over its rows (axis -2, over 'r') or an H block over
    its columns (axis -1, over 'c'), ``everywhere`` unless only the
    subgroup uses the sums."""
    s = X.to(acc_dtype(X.dtype)).sum(dim=axis)
    if grid is not None:
        over = "r" if axis % X.dim() == X.dim() - 2 else "c"
        s = grid.sum(s, over, everywhere=everywhere)
    return s.to(X.dtype)


def col_sqnorms(X: torch.Tensor, grid=None) -> torch.Tensor:
    """Squared L2 norms of X's columns with f32/f64 accumulation
    (``linalg.py:155-158``): (n,) of one matrix, (b, n) of a stack of b
    members; on a grid X is a block of rows, summed over 'r'."""
    Xa = X.to(acc_dtype(X.dtype))
    s = (Xa * Xa).sum(-2)
    return s if grid is None else grid.sum(s, "r", everywhere=True)


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


def _member_sums(A, W, H, chunk, with_den=True):
    """:func:`_residual_sums` over all columns, per member of a stack:
    (num, den) of shape (b,), or scalars for one matrix."""
    if A.dim() == 3:
        sums = [_residual_sums(a, w, h, chunk, False, with_den)
                for a, w, h in zip(A, W, H)]
        return tuple(torch.stack(s) for s in zip(*sums))
    return _residual_sums(A, W, H, chunk, False, with_den)


def residual_sqnorm(A: torch.Tensor, W: torch.Tensor, H: torch.Tensor,
                    chunk: int = 0, grid=None) -> torch.Tensor:
    """||A - W H||_F^2 of a dense A, one value per member for a stack;
    ``chunk`` as in :func:`relative_error`; on a grid summed over all
    ranks."""
    num = _member_sums(A, W, H, chunk, with_den=False)[0]
    return num if grid is None else grid.sum(num, "rc")


def relative_error(A: torch.Tensor, W: torch.Tensor, H: torch.Tensor,
                   chunk: int = 0, grid=None) -> torch.Tensor:
    """||A - W H||_F / ||A||_F (reference pyDNMF.py:204-210); one value per
    member for a stack. ``chunk`` > 0 bounds the residual to that many rows
    (linalg.py:193-207). On a grid the blocks' sums are all-reduced over
    all ranks at once, so every rank gets the same error (and a ``tol``
    stop the same iteration)."""
    if is_sparse(A):
        return _sparse_relative_error(A, W, H, grid)
    num, den = _member_sums(A, W, H, chunk)
    if grid is not None:
        num, den = grid.sum(torch.stack([num, den]), "rc")
    return torch.sqrt(num) / torch.sqrt(den)


def column_error(A: torch.Tensor, W: torch.Tensor, H: torch.Tensor,
                 chunk: int = 0, grid=None) -> torch.Tensor:
    """Per-column relative L2 error, length n (reference pyDNMF.py:220-239).
    ``chunk`` as in relative_error. On a grid the errors of this rank's
    column block, summed over 'r'."""
    if is_sparse(A):
        return _sparse_column_error(A, W, H, grid)
    num, den = _residual_sums(A, W, H, chunk, per_column=True)
    if grid is not None:
        num, den = grid.sum(torch.stack([num, den]), "r")
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
                  eps: float, chunk: int = 0, grid=None) -> torch.Tensor:
    """Generalized KL divergence D(A || WH) = sum(A log(A / WH) - A + WH)
    of a dense A (``pydnmfk_tpu/ops/linalg.py:236-242``), summed at the
    accumulation dtype; one value per member for a stack. ``chunk`` > 0
    takes rows in slabs of that many, so that W H never exists whole. On a
    grid the blocks' sums are all-reduced over all ranks."""
    if grid is not None:
        return grid.sum(kl_divergence(A, W, H, eps, chunk), "rc")
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


def quantize_uint8(A: torch.Tensor, grid=None):
    """Global-scale uint8 quantization of a nonnegative A
    (``pydnmfk_tpu/ops/linalg.py:245-284``): Q = clip(round(A / s), 0, 255)
    with s = max(A) / 255 in f32 (1 where the max is 0). Returns (Q, s), s a
    0-d f32 tensor. ``torch.round`` rounds half to even, as ``jnp.round``
    does, so Q equals the JAX package's. Rows go in slabs of
    :func:`error_chunk_rows`, so no full-size f32 temporary exists. On a
    grid the max is all ranks' (an all-reduce with MAX), so each block's Q
    is its block of the 1x1 Q."""
    top = A.max().to(torch.float32)
    if grid is not None:
        top = grid.max(top.reshape(1))[0]
    scale = top / 255.0
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


def normalize_features(W: torch.Tensor, H: torch.Tensor, eps: float,
                       grid=None):
    """L1-normalize W columns, rescale H rows (reference pyDNMF.py:184-194);
    on a grid W's column sums are all-reduced over 'r' everywhere."""
    s = sum_axis(W, axis=-2, grid=grid).unsqueeze(-2)   # (..., 1, k)
    return W / (s + eps), H * s.mT


# ---------------------------------------------------------------------------
# Sparse-A error identities (linalg.py:295-331). ||A - WH||^2 expands to
#   ||A||^2 - 2 <A, WH> + ||WH||^2
# with <A, WH> = sum(H o (W^T A)) and ||WH||^2 = sum((W^T W) o (H H^T)):
# every term is nnz- or k-sized. f32 cancellation limits the resolution to
# about 1e-3 of the relative error, fine for NMF errors of 1e-2..1.
# On a grid each term is a sum over the blocks: rank (i, j) adds
# sum(A_ij^2), sum(H_j o W_i^T A_ij) and sum((W_i^T W_i) o (H_j H_j^T)),
# so one all-reduce of its three partial sums (over all ranks for the
# error, over 'r' for a column's) gives every term, the same bits on every
# rank, and no product is summed on its own.
# ---------------------------------------------------------------------------
def _sparse_terms(A, W, H, dims):
    """Rank-local (||A||^2, <A, WH>, ||WH||^2), summed over ``dims`` of
    the (..., k, n) products: all of them for the error, the rows (-2) for
    per-column terms."""
    from . import ell, sparse
    acc = acc_dtype(W.dtype)
    Ha = H.to(acc)
    WTA = _sparse_product(A, W, "wta", None).to(acc)
    cross = (Ha * WTA).sum(dims)
    if dims == -2:
        wh2 = (Ha * matmul(gram(W).to(acc), Ha)).sum(-2)
        if isinstance(A, ell.EllSparse):
            a2 = ell.ell_col_sqsum(A)
        else:
            a2 = sparse.col_sqsum(A.data, A.cols, A.shape[1])
    else:
        wh2 = (gram(W).to(acc) * gram_t(H).to(acc)).sum((-2, -1))
        a2 = sqnorm(A)
    return a2.to(acc), cross, wh2


def _sparse_relative_error(A, W, H, grid=None):
    a2, cross, wh2 = _sparse_terms(A, W, H, (-2, -1))
    if grid is not None:
        a2, cross, wh2 = grid.sum(torch.stack([a2, cross, wh2]), "rc")
    num = (a2 - 2.0 * cross + wh2).clamp_min(0.0)
    return torch.sqrt(num) / torch.sqrt(a2)


def _sparse_column_error(A, W, H, grid=None):
    a2, cross, wh2 = _sparse_terms(A, W, H, -2)
    if grid is not None:
        a2, cross, wh2 = grid.sum(torch.stack([a2, cross, wh2]), "r")
    num = (a2 - 2.0 * cross + wh2).clamp_min(0.0)
    return torch.sqrt(num / a2.clamp_min(torch.finfo(a2.dtype).tiny))
