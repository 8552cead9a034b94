"""Single NMF: one factorization A ~= W H for a fixed k.

Port of ``pydnmfk_tpu/models/nmf.py``. The iteration loop is a Python loop
over the update step (JAX's ``fori_loop``) and a stack of ensemble members is
a leading batch axis of A, W and H (JAX's ``vmap``), so the kernels see the
whole ensemble in one launch.

On a p_r x p_c grid (``grid``, ``parallel/mesh.py``) each rank fits its
block (i, j) of A with W's row block i and H's column block j, and every
product is all-reduced (``models/updates.py``); K1 and K3 stay off a grid
of more than one rank, as the JAX package's fusion rule turns them off
outside a single shard (nmf.py:226-227), and KL takes K2a/K2b on the block.
A sparse A on a grid is never densified: each rank packs its own block in
the format that ``sparse_grid_format`` and the ranks agree on (the dual
ELL, K4 on the card, or the triplet; ``ops/sparse.py::grid_format``).
The factors come back gathered, on every rank; rank 0 writes them.

Reference semantics kept (pyDNMF.py):
  * eps = finfo(dtype).eps                          (:68-69)
  * clip W, H at eps every 10 iterations            (:155-157, :170-172)
  * final L1 column-normalize W, rescale H          (:184-194)
  * relative error = ||A - WH||_F / ||A||_F         (:204-210)
  * per-column error vector                         (:220-239)
  * rand init: U[0, 1) factors                      (:110-129)
  * nnsvd init, then prune A, W, H; unprune after   (:90-101)
  * BCD collapses the outer loop into its own       (:152)
"""
from __future__ import annotations

import os
from functools import partial
from typing import Optional, Tuple

import numpy as np
import torch

from ..config import NMFConfig, check_device
from ..ops import cuda_lib, fused_kl, fused_mu, linalg, sparse
from ..parallel.mesh import is_proc0, sync_processes
from ..utils import timing
from ..utils.convert import as_tensor
from ..utils.pruning import prune_all, unprune_columns, unprune_factors
from . import updates


def step_for(A, W, norm: str, W_update: bool, chunk: int,
             use_fused: bool | None = None, method: str = "mu",
             hals_block: int | None = None, grid=None):
    """The update step for these operands (``nmf.py:62-78`` and the fusion
    rule of :209-233, restated for the card). HALS takes its own step
    (``updates.hals_step``, FRO only), whose two A-sized products are those
    of the two-pass MU step: plain products of a dense A, K4 for the dual
    ELL. For MU, ``use_fused`` is the config's:

    The kernels take A's and the factors' dtypes where
    ``cuda_lib.kernel_types`` says so: f32 factors with an f32, bf16, f16 or
    uint8 A; bf16 or f16 factors with a bf16, f16 or uint8 A. An A wider
    than its factors (f32 under half factors) and f64 take the plain
    products.

    * FRO with a W update on CUDA takes kernel K1 for k <= 64 and kernel
      dtypes, unless ``use_fused`` is False; otherwise the two-pass step of
      plain products, which is what JAX runs outside any kernel. The
      W-frozen refit is always the two-pass step, as in JAX.
    * KL with ``use_fused=True`` and a W update takes the one-pass step,
      kernel K3 on CUDA, for k <= 64 and kernel dtypes (on the CPU its
      plain version); other dtypes keep the plain products, as
      ``updates.mu_kl_step`` does for K2.
    * Otherwise KL takes the ratio products, kernels K2a/K2b on CUDA for
      kernel dtypes (``updates.mu_kl_step``).
    * A sparse A takes the two-pass steps over its format's products: K4 on
      CUDA for the dual ELL (``ops/ell.py``); K1, K2 and K3 never see it.
    * On a grid of more than one rank K1 and K3 are off: FRO takes the
      two-pass step, KL K2a/K2b on the rank's block.
    """
    if method == "hals":
        return partial(updates.hals_step, W_update=W_update, block=hals_block,
                       grid=grid)
    if linalg.is_sparse(A):
        step = updates.mu_fro_step if norm == "fro" else updates.mu_kl_step
        return partial(step, W_update=W_update, grid=grid)
    k = W.shape[-1]
    kernel_types = cuda_lib.kernel_types(A.dtype, W.dtype)
    one_shard = grid is None or grid.n_ranks == 1
    if norm == "fro":
        if (W_update and use_fused is not False and A.is_cuda and kernel_types
                and k <= fused_mu.MAX_K and one_shard):
            return fused_mu.fused_mu_fro_step
        return partial(updates.mu_fro_step, W_update=W_update, grid=grid)
    if (use_fused and W_update and kernel_types and k <= fused_kl.MAX_K
            and one_shard):
        return partial(fused_kl.fused_mu_kl_step, chunk=chunk)
    return partial(updates.mu_kl_step, W_update=W_update, chunk=chunk,
                   grid=grid)


def mask_wh(W, H, col_mask):
    """W's columns and H's rows outside ``col_mask`` (bool (K,), or (b, K)
    for a stack of b members) set to exact zeros (``nmf.py:55-60``); no
    mask returns them as they are."""
    if col_mask is None:
        return W, H
    return (torch.where(col_mask.unsqueeze(-2), W, 0),
            torch.where(col_mask.unsqueeze(-1), H, 0))


def _solve(A, W, H, eps, *, norm: str, itr: int, W_update: bool, chunk: int,
           use_fused: bool | None = None, tol: float = 0.0,
           tol_check_every: int = 50, err_chunk: int = 0,
           method: str = "mu", bcd_obj: str = "gram",
           hals_block: int | None = None, finalize: bool = True, grid=None,
           col_mask=None):
    """The iteration loop of ``pydnmfk_tpu/models/nmf.py::_solve``. BCD is
    a whole inner solver (``updates.bcd_solve``): it ignores ``W_update``
    and ``tol``, as JAX's does (nmf.py:86-92), and clips once at the end,
    where the reference's loop would clip at i = itr - 1.

    ``finalize=False`` returns the factors as the loop leaves them, without
    the final normalization and error (the error comes back as a zero):
    a chunk of a checkpointed solve, whose last call, with no iterations,
    applies them once (nmf.py:139-146).

    ``col_mask`` (bool (K,), or (b, K) for a stack) marks the active
    columns of a K-padded solve (``nmf.py:40-61``): W's other columns and
    H's other rows are set to exact zeros after every step's eps clip, and
    once after BCD's inner solve and its clip. Zero columns add exact zeros
    to every product the active columns take, so the active columns follow
    the unpadded k-column solve up to summation order. The kernels are
    picked at the padded K."""
    if method == "bcd":
        W, H = updates.bcd_solve(A, W, H, eps, itr=itr, obj_mode=bcd_obj,
                                 chunk=err_chunk, grid=grid,
                                 col_mask=col_mask)
        if (itr - 1) % 10 == 0:
            W, H = W.clamp_min(eps), H.clamp_min(eps)
        W, H = mask_wh(W, H, col_mask)
    else:
        W, H = _iterate(A, W, H, eps, norm, itr, W_update, chunk, use_fused,
                        tol, tol_check_every, err_chunk, method, hals_block,
                        grid, col_mask)
    if not finalize:
        return W, H, torch.zeros((), dtype=linalg.acc_dtype(A.dtype),
                                 device=W.device)
    W, H = linalg.normalize_features(W, H, eps, grid)
    err = linalg.relative_error(A, W, H, err_chunk, grid)
    return W, H, err


def _iterate(A, W, H, eps, norm, itr, W_update, chunk, use_fused, tol,
             tol_check_every, err_chunk, method, hals_block, grid=None,
             col_mask=None):
    """The MU or HALS loop of :func:`_solve`: ``itr`` steps, the eps clip
    at every tenth from the first, then ``col_mask``, or the early stop
    under ``tol`` (on a grid decided from the all-reduced error, alike on
    every rank)."""
    step = step_for(A, W, norm, W_update, chunk, use_fused, method,
                    hals_block, grid)

    def body(i, W, H):
        W, H = step(A, W, H, eps)
        if i % 10 == 0:
            W, H = W.clamp_min(eps), H.clamp_min(eps)
        return mask_wh(W, H, col_mask)

    if tol <= 0.0:
        for i in range(itr):
            W, H = body(i, W, H)
    else:
        # early stop: tol_check_every iterations per outer step, until the
        # relative error improves by less than tol. Members of a stack stop
        # on their own, as under JAX's vmap: a stopped member keeps its
        # factors while the others go on.
        chunk_n = max(1, tol_check_every)
        n_full = itr // chunk_n
        errdt = linalg.acc_dtype(A.dtype)
        big = torch.finfo(errdt).max / 4
        batch = W.shape[:-2]
        err_prev = torch.full(batch, big, dtype=errdt, device=A.device)
        err = torch.full(batch, big / 2, dtype=errdt, device=A.device)

        def advance(i0, i1, live, W, H):
            W1, H1 = W, H
            for i in range(i0, i1):
                W1, H1 = body(i, W1, H1)
            sel = live.reshape(*batch, 1, 1)
            return torch.where(sel, W1, W), torch.where(sel, H1, H)

        for j in range(n_full):
            live = err_prev - err > tol
            if not bool(live.any()):
                break
            W, H = advance(j * chunk_n, (j + 1) * chunk_n, live, W, H)
            new_err = linalg.relative_error(A, W, H, err_chunk, grid)
            err_prev = torch.where(live, err, err_prev)
            err = torch.where(live, new_err, err)
        live = err_prev - err > tol
        if n_full * chunk_n < itr and bool(live.any()):
            W, H = advance(n_full * chunk_n, itr, live, W, H)
    return W, H


def solve(A, W, H, eps, cfg: NMFConfig, finalize: bool = True, grid=None,
          col_mask=None):
    """Run the full iteration loop on one matrix, or on a stack of ensemble
    members along a leading axis of A, W and H (``nmf.py::solve``);
    ``finalize`` and ``col_mask`` as in :func:`_solve` (a stack takes one
    mask row a member, where JAX's ``solve`` refuses a batched mask and its
    ensemble program maps the solve over the rows, nmf.py:170-177); on a
    grid, this rank's blocks. A sparse A comes in the format that its
    caller's ``_prepare`` chose (``ops/sparse.py::densify_for_backend``),
    and needs no row chunks; it takes MU and HALS, and BCD raises JAX's
    ValueError (nmf.py:186-189)."""
    m, n = A.shape[-2:]
    norm, method = cfg.norm.lower(), cfg.method.lower()
    if linalg.is_sparse(A) and method == "bcd":
        raise ValueError(
            "sparse A supports MU (fro/kl) and HALS; the BCD objective "
            "needs the dense residual every inner step")
    if col_mask is not None:
        col_mask = torch.as_tensor(col_mask, device=W.device)
        if (col_mask.dtype != torch.bool or col_mask.shape[-1:] != W.shape[-1:]
                or col_mask.dim() not in (1, W.dim() - 1)
                or col_mask.shape[:-1] not in ((), W.shape[:-2])):
            raise ValueError(f"col_mask must be bool (K,) or (b, K) for W "
                             f"{tuple(W.shape)}, got {col_mask.dtype} "
                             f"{tuple(col_mask.shape)}")
    dense_chunk = 0 if linalg.is_sparse(A) else linalg.error_chunk_rows(m, n)
    # the plain KL products' ratio slab: kl_chunk rows, else automatic
    # (nmf.py:238-242)
    kl_rows = 0 if linalg.is_sparse(A) else (cfg.kl_chunk or dense_chunk)
    return _solve(A, W, H, eps, norm=norm, itr=cfg.itr, W_update=cfg.W_update,
                  chunk=kl_rows if norm == "kl" else 0,
                  use_fused=cfg.use_fused, tol=float(cfg.tol),
                  tol_check_every=int(cfg.tol_check_every),
                  err_chunk=dense_chunk, method=method,
                  bcd_obj=cfg.bcd_obj or "gram", hals_block=cfg.hals_block,
                  finalize=finalize, grid=grid, col_mask=col_mask)


def init_factors_rand(generator: torch.Generator, m: int, n: int, k: int,
                      dtype, device):
    """U[0, 1) factors drawn in f32 (pyDNMF.py:110-129)."""
    W = torch.rand((m, k), generator=generator, device=device)
    H = torch.rand((k, n), generator=generator, device=device)
    return W.to(dtype), H.to(dtype)


class NMF:
    """One NMF fit: init -> iterate -> normalize -> error; mirror of
    ``pydnmfk_tpu.NMF`` on one device, the CUDA card unless ``device``
    says otherwise, or on a p_r x p_c grid of processes (``grid``, whose
    device each rank takes)."""

    def __init__(self, cfg: NMFConfig, device="cuda", grid=None):
        if grid is None and cfg.grid != (1, 1):
            from ..parallel.mesh import initialize
            grid = initialize(*cfg.grid, device)
        self.cfg = cfg
        self.grid = grid
        self.device = grid.device if grid is not None else torch.device(device)
        self.recon_err = None
        self.prune_state = None

    def _prepare(self, A):
        """A on the device at its storage dtype; a uint8 ``a_precision``
        keeps A at the factor dtype here, and ``fit`` quantizes it just
        before the solve (nmf.py:383-386). A sparse A (SparseTriplet or
        EllSparse) goes through the format policy (nmf.py:351-380): the
        triplet stays on the CPU; on the card it becomes the dual ELL or a
        dense A. ``a_precision`` applies to the nnz values of a sparse A,
        uint8 excepted (nmf.py:364-368); a dense A that the policy narrowed
        to bf16 keeps bf16. A sparse A that stays sparse refuses prune and
        nnsvd here, and BCD in :func:`solve`, with the JAX package's
        ValueErrors (nmf.py:358-363, :186-189). On a grid a sparse A is
        this rank's block in its grid format (:meth:`_prepare_grid`)."""
        cfg = self.cfg
        quantized = not cfg.a_dtype.is_floating_point
        if not linalg.is_sparse(A):
            dtype = cfg.dtype if quantized else cfg.a_dtype
            return as_tensor(A).to(self.device, dtype).contiguous()
        if quantized:
            raise ValueError("quantized (uint8) A storage applies to dense A "
                             "(the sparse formats store only the nnz values); "
                             "drop a_precision for sparse inputs")
        if self.grid is not None:
            self._refuse_sparse()
            return self._prepare_grid(A)
        with timing.timed("sparse_format"):
            A = sparse.densify_for_backend(A.to(self.device), k_hint=cfg.k)
        if linalg.is_sparse(A):
            self._refuse_sparse()
            return A.astype(cfg.a_dtype)
        return A if A.dtype == torch.bfloat16 else A.to(cfg.a_dtype)

    def _refuse_sparse(self):
        if self.cfg.prune:
            raise ValueError("prune is not supported with sparse A "
                             "(pruning IS implicit in sparsity)")
        if self.cfg.init == "nnsvd":
            raise ValueError("nnsvd init requires dense A; use "
                             "init='rand' with sparse matrices")

    def _prepare_grid(self, A):
        """This rank's block of a sparse A on the grid, in the format that
        the ranks agree on (nmf.py:430-466; ``ops/sparse.py::grid_format``,
        which cuts a whole SparseTriplet to the block and takes the
        reader's SparseGridInput as the block; a bundle already agreed,
        such as the NMFk refit's, keeps its format). Unlike the JAX
        package, which runs a reader's blocks as triplets, a reader's block
        packs like any other."""
        with timing.timed("sparse_format"):
            A = sparse.grid_format(A.to(self.device), self.grid,
                                   self.cfg.sparse_grid_format)
        return A.local.astype(self.cfg.a_dtype)

    def init_factors(self, A, spans=None):
        """Init factors of A (``nmf.py:319-338``): U[0, 1) draws from a
        generator seeded with ``cfg.seed``, or NNDSVD (``models/svd.py``;
        randomized SVD where min(m, n) > 8192). On a grid A is this rank's
        block, rows [r0, r1) and columns [c0, c1) of the m x n matrix
        (``spans``, ``GridContext.span``): every rank draws the whole W and
        H (k wide) and keeps its blocks, so that the draws are the 1x1
        ones; the NNDSVD runs on the blocks (``svd.py:60-175``)."""
        cfg, grid = self.cfg, self.grid
        if cfg.init == "rand":
            (r0, r1, m), (c0, c1, n) = spans or ((0, A.shape[0], A.shape[0]),
                                                 (0, A.shape[1], A.shape[1]))
            generator = torch.Generator(self.device)
            generator.manual_seed(cfg.seed)
            W, H = init_factors_rand(generator, m, n, cfg.k, cfg.dtype,
                                     self.device)
            return W[r0:r1], H[:, c0:c1]
        from .svd import DistSVD
        W, H = DistSVD(k=cfg.k, eps=cfg.eps, grid=grid).nnsvd(A)
        return W.to(cfg.dtype), H.to(cfg.dtype)

    def fit(self, A, factors: Optional[Tuple] = None, col_mask=None):
        """Returns (W, H, recon_err) as the reference PyNMF.fit does
        (pyDNMF.py:137-182). ``factors`` gives (W0, H0); otherwise
        :meth:`init_factors` makes them from the whole A. ``col_mask``
        (bool (K,)) marks the active columns of K-padded factors, as in
        :func:`_solve` (the NMFk sweep's K-padded refit, nmf.py:341-347);
        it takes no ``solve_checkpoint_every`` (JAX's ValueError,
        :486-491). With ``prune``
        the solve then runs on A without its all-zero rows and columns
        (and W, H without the matching rows and columns), and the returned
        factors are put back at the full shape (nmf.py:426-427,
        :505-512). With a uint8 ``a_precision`` the solve factorizes Q =
        round(A / s): the error and ``column_err`` are Q's, and the
        returned H carries s (nmf.py:477-480, :501-504).

        On a grid A is this rank's block of a dense matrix, a whole sparse
        matrix (a SparseTriplet, which each rank cuts to its block) or this
        rank's block of one (the reader's SparseGridInput), and ``factors``
        this rank's blocks (W's row block, H's column block); the returned
        W and H are whole, gathered on every rank, and rank 0 writes
        them."""
        cfg, grid = self.cfg, self.grid
        check_device(self.device)
        A = self._prepare(A)
        spans = None if grid is None else (grid.span(A.shape[0], "r"),
                                           grid.span(A.shape[1], "c"))
        shape = tuple(A.shape) if grid is None else (spans[0][2],
                                                     spans[1][2])
        with timing.timed("init_factors"):
            if factors is not None:
                W = as_tensor(factors[0]).to(self.device, cfg.dtype)
                H = as_tensor(factors[1]).to(self.device, cfg.dtype)
            else:
                W, H = self.init_factors(A, spans)
        self.prune_state = None
        if cfg.prune:          # _prepare refused a sparse A
            A, W, H, self.prune_state = prune_all(A, W, H, grid)
        a_scale = None
        if not cfg.a_dtype.is_floating_point:     # _prepare refused sparse
            A, a_scale = linalg.quantize_uint8(A, grid)
        with timing.timed("solve"):
            if cfg.solve_checkpoint_every > 0:
                if col_mask is not None:
                    raise ValueError("col_mask is incompatible with "
                                     "solve_checkpoint_every")
                W, H, err = self._solve_checkpointed(A, W.contiguous(),
                                                     H.contiguous(), shape)
            else:
                W, H, err = solve(A, W.contiguous(), H.contiguous(), cfg.eps,
                                  cfg, grid=grid, col_mask=col_mask)
        self.recon_err = float(err)
        self._A, self._W, self._H = A, W, H       # Q-scale, for column_err
        if a_scale is not None:
            H = H * a_scale.to(H.dtype)
        if grid is not None:
            W, H = grid.gather(W, "r", -2), grid.gather(H, "c", -1)
        if self.prune_state is not None:
            W, H = unprune_factors(W, H, self.prune_state)
        if cfg.save_factors:
            from ..utils.io import DataWriter
            with timing.timed("save_factors"):
                if is_proc0(grid):       # the reference's rank-0 writer
                    DataWriter(cfg.results_path,
                               grid.shape if grid else (1, 1)).save_factors(
                                   W, H)
                sync_processes(grid)
        return W, H, self.recon_err

    def _solve_checkpointed(self, A, W, H, shape):
        """The iteration loop in chunks of ``solve_checkpoint_every``
        iterations, each saved to ``results_path`` (``nmf.py:523-561``), so
        that a long factorization survives preemption: a later fit of the
        same configuration resumes from the last save. The chunks skip the
        final normalization and error and one call with no iterations
        applies them, so the trajectory is the unchunked solve's; chunks
        are whole tens, since the eps clip runs at every chunk's
        iteration 0. A uint8 A saves its Q-scale factors."""
        cfg = self.cfg
        if cfg.tol > 0:
            raise ValueError(
                "solve_checkpoint_every is incompatible with tol-based "
                "early stopping (fixed-iteration path only)")
        if cfg.method.lower() == "bcd":
            raise ValueError(
                "solve_checkpoint_every does not support BCD (its inner "
                "solver carries extrapolation state across iterations)")
        every = max(10, (cfg.solve_checkpoint_every // 10) * 10)
        os.makedirs(cfg.results_path, exist_ok=True)
        grid = self.grid
        tag = repr((cfg.k, cfg.itr, cfg.norm.lower(), cfg.method.lower(),
                    cfg.seed, cfg.precision, cfg.a_precision, tuple(shape),
                    grid.shape if grid else (1, 1)))
        from ..utils.checkpoint import solve_checkpointer
        saver = solve_checkpointer(cfg.results_path, cfg.k, tag, grid)
        W, H, i = saver.load(W, H)
        while i < cfg.itr:
            n = min(every, cfg.itr - i)
            W, H, _ = solve(A, W, H, cfg.eps, cfg.replace(itr=n),
                            finalize=False, grid=grid)
            i += n
            saver.save(W, H, i)
        W, H, err = solve(A, W, H, cfg.eps, cfg.replace(itr=0), grid=grid)
        saver.cleanup()
        return W, H, err

    def column_err(self) -> np.ndarray:
        """Per-column relative error of the last fit (pyDNMF.py:220-239),
        taken on the pruned matrices and zero at pruned columns
        (nmf.py:563-577); on a grid gathered, on every rank."""
        m, n = self._A.shape
        col = linalg.column_error(self._A, self._W, self._H,
                                  linalg.error_chunk_rows(m, n), self.grid)
        if self.grid is not None:
            col = self.grid.gather(col, "c", -1)
        col = col.cpu().numpy()
        if self.prune_state is not None:
            return unprune_columns(col, self.prune_state)
        return col
