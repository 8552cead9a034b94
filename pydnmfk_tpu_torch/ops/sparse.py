"""Sparse A as a canonical triplet, its products, and the choice of format.

Port of ``pydnmfk_tpu/ops/sparse.py``. A sparse A is a
:class:`SparseTriplet`: values ``data``, int32 ``rows`` and ``cols``,
unique (row, col) pairs in row-major order, as ``utils/io.py::_read_sparse``
makes a BCOO. ``data`` may carry a leading member axis, (B, nnz) over shared
indices: the NMFk ensemble perturbs only the values.

The products are gathers and scatter-adds over the nnz entries, as the JAX
package writes them with gathers and ``segment_sum``: the dense m x n
product never exists, and a stack of members is one more leading axis. Every
scatter-add sums each output line's entries in a fixed order
(:func:`line_plan`, :func:`ordered_sum`), which depends on the index array
alone: the same product on the same inputs gives the same bits on the card,
as XLA's scatters do on a TPU, and a member's bits do not depend on how many
members share the stack.
KL on sparse data is exact against the dense formula: the ratio
U = A / (W H + eps) is zero wherever A is, so U shares A's pattern and both
KL products touch only the nnz entries (reference: dist_nmf.py:803-811).
The (nnz, k) gather slabs are cut into nnz chunks once they would pass
about 512 MB (:func:`nnz_chunk_size`).

This is the CPU's format. On the card, :func:`densify_for_backend` turns a
triplet into the dual ELL format of ``ops/ell.py`` (kernel K4) or a dense A,
by the time model of ``ops/ell.py::ell_time_model``. On a p_r x p_c grid a
rank holds its block (:class:`SparseGridInput`), in the format that
:func:`grid_format` agrees on with the other ranks, and is never
densified.
"""
from __future__ import annotations

import warnings

import torch

from .linalg import acc_dtype


class SparseTriplet:
    """Canonical COO matrix of ``shape`` (m, n); ``data`` is (nnz,) or a
    member stack (B, nnz) over the shared ``rows``/``cols``."""

    _pydnmfk_sparse = True            # recognized by linalg.is_sparse

    def __init__(self, data, rows, cols, shape):
        self.data = data
        self.rows = rows
        self.cols = cols
        self.shape = (int(shape[0]), int(shape[1]))

    @property
    def nse(self) -> int:
        return int(self.rows.shape[0])

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def device(self):
        return self.data.device

    def with_data(self, data) -> "SparseTriplet":
        return SparseTriplet(data, self.rows, self.cols, self.shape)

    def astype(self, dtype) -> "SparseTriplet":
        return self.with_data(self.data.to(dtype))

    def to(self, device) -> "SparseTriplet":
        return SparseTriplet(self.data.to(device), self.rows.to(device),
                             self.cols.to(device), self.shape)


# entries that one thread sums in order before the next level of the sum
RUN = 256


def _levels(key, nlines: int) -> list:
    """The lengths of each level of the ordered sum of entries sorted by
    their line ``key``: each line's entries are cut into runs of at most
    RUN, in order, each run summed in order; then the runs' sums the same
    way, until a line holds at most RUN of them. The last level's lengths
    are the lines' (zero for a line with no entry)."""
    counts = torch.bincount(key, minlength=nlines)
    levels = []
    while counts.numel() and int(counts.max()) > RUN:
        runs = -(-counts // RUN)
        line = torch.repeat_interleave(
            torch.arange(nlines, device=key.device), runs)
        pos = torch.arange(line.numel(), device=key.device) - (
            torch.cumsum(runs, 0) - runs)[line]
        full = counts // RUN
        levels.append(torch.where(pos < full[line], RUN,
                                  (counts - full * RUN)[line]))
        counts = runs
    levels.append(counts)
    return levels


def line_plan(idx, nlines: int, chunk: int = 0) -> list:
    """The fixed order in which a scatter-add over the lines ``idx`` (an
    entry's row or column, 0 <= idx < nlines) sums its entries: the entries
    sorted stably by line, cut into the nnz chunks of ``chunk`` (0: one),
    and for each chunk (sel, levels): ``sel`` the chunk's entries (a slice
    where idx is sorted already, else their indices) and the
    :func:`_levels` of its sum. It depends on idx alone, so it is made once
    and kept on the index tensor (a format's indices are fixed once it is
    built)."""
    cache = idx.__dict__.setdefault("_line_plans", {})
    plan = cache.get((nlines, chunk))
    if plan is None:
        key = idx.long()
        order = None
        if key.numel() > 1 and not bool((key[1:] >= key[:-1]).all()):
            order = torch.argsort(key, stable=True)
            key = key[order]
        plan = [(slice(s, e) if order is None else order[s:e],
                 _levels(key[s:e], nlines))
                for s, e in _spans(key.shape[0], chunk)]
        cache[(nlines, chunk)] = plan
    return plan


def ordered_sum(vals, levels):
    """(..., nlines, d) sums of the entries ``vals`` (..., e, d), sorted by
    line, in :func:`_levels`'s order: every level a segmented sum in which
    one thread adds a segment's values in order (``torch.segment_reduce``
    on data of two or more dims), so that neither the run nor the number of
    leading (member) axes changes the bits."""
    x = vals
    for lengths in levels:
        # segment_reduce reads the data by its strides as if they were the
        # shape's own: a size-1 axis with another stride (a broadcast's
        # result) or a broadcast axis is laid out anew first
        if x.stride() != torch.empty(x.shape, device="meta").stride():
            x = x.clone(memory_format=torch.contiguous_format)
        x = torch.segment_reduce(x, "sum", lengths=lengths.expand(
            *x.shape[:-2], -1), axis=x.dim() - 2, unsafe=True)
    return x


def from_coo(rows, cols, data, shape) -> SparseTriplet:
    """A canonical triplet from COO arrays in any order: sorted row-major,
    duplicate (row, col) pairs summed (``utils/io.py:150-161``)."""
    m, n = int(shape[0]), int(shape[1])
    key = rows.to(torch.int64) * n + cols.to(torch.int64)
    key, order = torch.sort(key, stable=True)
    data = data[order]
    key, inverse = torch.unique_consecutive(key, return_inverse=True)
    if key.numel() < order.numel():
        (_, levels), = line_plan(inverse, key.numel())
        data = ordered_sum(data[:, None], levels)[:, 0]
    return SparseTriplet(data, (key // n).to(torch.int32),
                         (key % n).to(torch.int32), (m, n))


def nnz_chunk_size(nnz: int, k: int, budget_elems: int = 1 << 27) -> int:
    """0 (direct) while the (nnz, k) gather slab stays under
    ``budget_elems`` elements; otherwise an nnz block inside the budget."""
    if nnz * max(k, 1) <= budget_elems:
        return 0
    return max(1024, (budget_elems // max(k, 1)) // 8 * 8)


def _spans(nnz: int, chunk: int):
    """[start, end) of the nnz chunks; one empty span where nnz is 0 (an
    empty block of a grid)."""
    step = chunk if chunk and chunk < nnz else max(nnz, 1)
    return [(s, min(s + step, nnz)) for s in range(0, max(nnz, 1), step)]


def sddmm(W, H, rows, cols, chunk: int = 0):
    """(W @ H) sampled at (rows, cols) -> (..., nnz), accumulated in f32
    (f64 for f64 factors); never forms the dense product."""
    acc = acc_dtype(W.dtype)
    parts = [(W[..., rows[s:e], :].to(acc)
              * H[..., :, cols[s:e]].mT.to(acc)).sum(-1)
             for s, e in _spans(rows.shape[0], chunk)]
    return parts[0] if len(parts) == 1 else torch.cat(parts, -1)


def _scatter(data, idx, other, F, nlines: int, chunk: int, rows_of_f: bool):
    """sum over the entries e of line l: data[..., e] F-row(other[e]) ->
    (..., nlines, k), each line's entries summed in :func:`line_plan`'s
    order; F's rows are its columns (H^T) unless ``rows_of_f``."""
    acc = acc_dtype(F.dtype)
    batch = torch.broadcast_shapes(data.shape[:-1], F.shape[:-2])
    out = None
    for sel, levels in line_plan(idx, nlines, chunk):
        f = F[..., other[sel], :] if rows_of_f else F[..., :, other[sel]].mT
        vals = data[..., sel, None].to(acc) * f.to(acc)
        part = ordered_sum(vals.expand(*batch, -1, -1), levels)
        out = part if out is None else out + part
    return out


def a_ht(data, rows, cols, H, m: int, chunk: int = 0):
    """A @ H^T -> (..., m, k) from triplet A; ordered scatter-add over rows."""
    return _scatter(data, rows, cols, H, m, chunk, rows_of_f=False)


def wt_a(data, rows, cols, W, n: int, chunk: int = 0):
    """W^T @ A -> (..., k, n) from triplet A; ordered scatter-add over cols."""
    return _scatter(data, cols, rows, W, n, chunk, rows_of_f=True).mT


def col_sqsum(data, cols, n: int):
    """Per-column sum of squares -> (..., n), f32/f64 accumulation, each
    column's entries summed in :func:`line_plan`'s order."""
    d = data.to(acc_dtype(data.dtype))
    (sel, levels), = line_plan(cols, n)
    return ordered_sum((d * d)[..., sel, None], levels)[..., 0]


# triplet-facing wrappers (the JAX package's a_ht_bcoo, wt_a_bcoo, ...);
# ``acc`` returns the sums at the accumulation dtype, unrounded (a grid's
# partial products, summed across ranks before rounding)
def rounded(x, A, F, acc: bool):
    """x rounded to A's and F's dtype, or x as summed where ``acc``."""
    return x if acc else x.to(torch.promote_types(A.dtype, F.dtype))


def a_ht_triplet(A: SparseTriplet, H, chunk: int = 0, acc: bool = False):
    return rounded(a_ht(A.data, A.rows, A.cols, H, A.shape[0], chunk), A, H,
                   acc)


def wt_a_triplet(A: SparseTriplet, W, chunk: int = 0, acc: bool = False):
    return rounded(wt_a(A.data, A.rows, A.cols, W, A.shape[1], chunk), A, W,
                   acc)


def kl_uht_sparse(A: SparseTriplet, W, H, eps, chunk: int = 0,
                  acc: bool = False):
    """(A / (W H + eps)) @ H^T; the ratio exists only on the nnz entries."""
    wh = sddmm(W, H, A.rows, A.cols, chunk)
    u = A.data.to(wh.dtype) / (wh + eps)
    return rounded(a_ht(u, A.rows, A.cols, H, A.shape[0], chunk), A, W, acc)


def kl_wtu_sparse(A: SparseTriplet, W, H, eps, chunk: int = 0,
                  acc: bool = False):
    """W^T @ (A / (W H + eps)); see kl_uht_sparse."""
    wh = sddmm(W, H, A.rows, A.cols, chunk)
    u = A.data.to(wh.dtype) / (wh + eps)
    return rounded(wt_a(u, A.rows, A.cols, W, A.shape[1], chunk), A, W, acc)


# ---------------------------------------------------------------------------
# the format of a sparse A on the device
# ---------------------------------------------------------------------------
BUDGET_FRAC = 0.45      # share of the card's memory a dense A may take


def format_ladder(m: int, n: int, nnz: int, k: int, a_bytes: int,
                  budget: float, device_type: str) -> tuple:
    """The formats to try, in order, for a sparse A (a pure function of the
    shapes, so that its CUDA branch is testable without a card):

    * ``"triplet"``: the CPU keeps the triplet (``ops/sparse.py:451-452``);
    * ``"ell"``: the time model prefers the K4 gather path;
    * ``"dense"``: the f32 (or f64) dense A fits the budget;
    * ``"dense_bf16"``: only a bf16 dense A fits (with a warning);
    * ``"ell_beyond"``: nothing dense fits; the ELL path runs at O(nnz).

    An ELL step is skipped when ``ell_pack`` refuses the matrix; when no
    step is left, :func:`densify_for_backend` raises."""
    if device_type == "cpu":
        return ("triplet",)
    from .ell import ell_time_model
    steps = []
    t_ell, t_dense = ell_time_model(m, n, nnz, k)
    if t_ell < t_dense:
        steps.append("ell")
    if m * n * a_bytes <= budget:
        return (*steps, "dense")
    if a_bytes > 2 and m * n * 2 <= budget:
        return (*steps, "dense_bf16")
    return (*steps, "ell_beyond")


def _densify(A: SparseTriplet, dtype):
    dense = torch.zeros(A.shape, dtype=dtype, device=A.device)
    dense[A.rows.long(), A.cols.long()] = A.data.to(dtype)
    return dense


def densify_for_backend(A, k_hint: int = 32, return_perms: bool = False):
    """The execution format of a sparse A on its device
    (``pydnmfk_tpu/ops/sparse.py::densify_for_backend``): the triplet on the
    CPU; on the card the first of :func:`format_ladder`'s steps that
    applies, with the budget ``BUDGET_FRAC`` x the card's total memory. An
    A already in a format (dense or ELL) is returned as it is.
    ``return_perms=True`` returns an ELL choice as ``ell_pack``'s
    (E, rperm, cperm, rtail_perm, ctail_perm), for the NMFk ensemble."""
    if not isinstance(A, SparseTriplet) or A.device.type == "cpu":
        return A
    if A.data.dim() != 1:
        raise ValueError("densify_for_backend takes one matrix, not a "
                         f"member stack (data {tuple(A.data.shape)})")
    m, n = A.shape
    a_bytes = A.data.element_size()
    budget = BUDGET_FRAC * torch.cuda.mem_get_info(A.device)[1]
    ladder = format_ladder(m, n, A.nse, k_hint, a_bytes, budget,
                           A.device.type)
    from .ell import ell_pack
    packed = None
    for step in ladder:
        if step == "dense":
            return _densify(A, A.dtype)
        if step == "dense_bf16":
            warnings.warn(
                f"sparse A densified to bfloat16 ({m * n * 2 / 1e9:.2f} GB; "
                f"{A.dtype} would exceed the {budget / 1e9:.1f} GB budget): "
                "reconstruction errors floor at bf16 resolution")
            return _densify(A, torch.bfloat16)
        if packed is None:            # "ell" or "ell_beyond": pack once
            packed = ell_pack(A, return_perms=True) or False
        if packed:
            if step == "ell_beyond":
                warnings.warn(
                    f"sparse A exceeds the dense budget even at bf16 "
                    f"({m * n * 2 / 1e9:.1f} GB > {budget / 1e9:.1f} GB); "
                    "running the ELL gather path (memory O(nnz))")
            return packed if return_perms else packed[0]
    raise ValueError(
        f"sparse A would densify to {m * n * a_bytes / 1e9:.2f} GB "
        f"(> {budget / 1e9:.1f} GB of the device budget) and its row/column "
        "nnz distribution is too skewed for ELL packing; run it on the CPU "
        '(device="cpu", --cpu), where the triplet path needs O(nnz) memory')


# ---------------------------------------------------------------------------
# a sparse A on a p_r x p_c grid (``pydnmfk_tpu/ops/sparse.py:140-307``)
# ---------------------------------------------------------------------------
class SparseGridInput:
    """This rank's block of a sparse A on a p_r x p_c grid, the counterpart
    of ``pydnmfk_tpu/ops/sparse.py::SparseGridInput``: ``block``, the
    triplet of the rank's rows [r0, r1) and columns [c0, c1)
    (``GridContext.rows``, ``.cols``) with local indices; ``perm``, each
    block entry's index in ``flat`` (int64); ``flat``, the values of the
    whole matrix in the order that the NMFk members perturb them (the 1x1
    triplet's, or a CSR file's storage order); ``global_shape``, the true
    (m, n). ``shape`` and ``nse`` are the block's, as a dense block's are
    on a grid. Unlike the JAX package's bundle nothing is padded, and each
    rank packs its own block: :func:`grid_format` returns the bundle with
    ``agreed`` set and, where the ranks agreed on the dual ELL, ``ell``,
    ``grid_ell_pack``'s (E, rperm, cperm, rtail_perm, ctail_perm) with
    slot -> index into the block's values. ``local`` is the block in the
    agreed format."""

    _pydnmfk_sparse = True            # recognized by linalg.is_sparse

    def __init__(self, block: SparseTriplet, perm, flat, global_shape,
                 ell=None, agreed: bool = False):
        self.block = block
        self.perm = perm
        self.flat = flat
        self.global_shape = (int(global_shape[0]), int(global_shape[1]))
        self.ell = ell
        self.agreed = agreed

    @property
    def local(self):
        return self.block if self.ell is None else self.ell[0]

    @property
    def shape(self):
        return self.block.shape

    @property
    def nse(self) -> int:
        return self.block.nse

    @property
    def dtype(self):
        return self.flat.dtype

    @property
    def device(self):
        return self.block.device

    def astype(self, dtype) -> "SparseGridInput":
        ell = self.ell and (self.ell[0].astype(dtype), *self.ell[1:])
        return SparseGridInput(self.block.astype(dtype), self.perm,
                               self.flat.to(dtype), self.global_shape, ell,
                               self.agreed)

    def to(self, device) -> "SparseGridInput":
        ell = self.ell and tuple(x.to(device) for x in self.ell)
        return SparseGridInput(self.block.to(device), self.perm.to(device),
                               self.flat.to(device), self.global_shape, ell,
                               self.agreed)


def shard_sparse_grid(A: SparseTriplet, grid) -> SparseGridInput:
    """This rank's block of a whole triplet A on ``grid``
    (``pydnmfk_tpu/ops/sparse.py::shard_sparse_grid``), in the port's
    remainder-balanced, unpadded blocks (``parallel/partition.py``): the
    block's entries keep A's order, and ``perm`` is their index in A."""
    (r0, r1), (c0, c1) = grid.rows(A.shape[0]), grid.cols(A.shape[1])
    rows, cols = A.rows, A.cols
    perm = torch.nonzero((rows >= r0) & (rows < r1) & (cols >= c0)
                         & (cols < c1)).flatten()
    block = SparseTriplet(A.data[perm], (rows[perm] - r0).to(torch.int32),
                          (cols[perm] - c0).to(torch.int32),
                          (r1 - r0, c1 - c0))
    return SparseGridInput(block, perm, A.data, A.shape)


def grid_format(A, grid, fmt=None) -> SparseGridInput:
    """This rank's block of a sparse A on ``grid`` in the format that the
    ranks agree on (``pydnmfk_tpu/ops/sparse.py::shard_sparse_for_grid``),
    the one place that NMF and NMFk decide it. ``A`` is a whole triplet,
    cut here (:func:`shard_sparse_grid`), or a bundle (the reader's); a
    bundle that is already agreed comes back as it is. ``fmt`` (a
    ``sparse_grid_format`` that the config has checked) None or "auto"
    takes the dual ELL on the card (kernel K4 on every block) where every
    rank's block packs (``ops/ell.py::grid_ell_pack``), and the triplet on
    the CPU; "ell" and "triplet" force one. Each rank packs its own block,
    at its own widths; one all-reduce over all ranks (of every ensemble
    group, whose blocks are group 0's) agrees on the format,
    so an "ell" that one block refuses raises the ValueError on every rank
    (one rank alone would leave the others waiting in their next
    collective), and an auto choice that a block refuses on the card
    warns on every rank that the triplet's products, which launch no
    kernel, run instead."""
    if isinstance(A, SparseTriplet):
        A = shard_sparse_grid(A, grid)
    elif not isinstance(A, SparseGridInput):
        raise TypeError("a sparse A on a grid is a SparseTriplet or a "
                        f"SparseGridInput, got {type(A).__name__}")
    if A.agreed:
        return A
    agreed = lambda ell=None: SparseGridInput(A.block, A.perm, A.flat,
                                              A.global_shape, ell, True)
    if fmt == "triplet" or (fmt != "ell" and A.device.type == "cpu"):
        return agreed()
    from .ell import grid_ell_pack
    packed = grid_ell_pack(A.block)
    refused = grid.max(torch.tensor([0.0 if packed else 1.0],
                                    dtype=torch.float64, device=A.device),
                       "world")
    if float(refused[0]) == 0:
        return agreed(packed)
    if fmt == "ell":
        raise ValueError(
            "sparse_grid_format='ell' but the matrix does not "
            "ELL-pack (nnz distribution too skewed / tails too "
            "heavy); use 'triplet'")
    warnings.warn(
        "sparse_grid_format auto: a block of the grid does not ELL-pack, "
        "so every rank runs the triplet's products (PyTorch scatters, no "
        "K4 kernel) on the card; pass sparse_grid_format='triplet' to "
        "choose them")
    return agreed()
