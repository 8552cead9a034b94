"""Single NMF: one factorization A ~= W H for a fixed k.

Port of ``pydnmfk_tpu/models/nmf.py``. The iteration loop is a Python loop
over the update step (JAX's ``fori_loop``) and a stack of ensemble members is
a leading batch axis of A, W and H (JAX's ``vmap``), so the kernels see the
whole ensemble in one launch.

Reference semantics kept (pyDNMF.py):
  * eps = finfo(dtype).eps                          (:68-69)
  * clip W, H at eps every 10 iterations            (:155-157, :170-172)
  * final L1 column-normalize W, rescale H          (:184-194)
  * relative error = ||A - WH||_F / ||A||_F         (:204-210)
  * per-column error vector                         (:220-239)
  * rand init: U[0, 1) factors                      (:110-129)
"""
from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import numpy as np
import torch

from ..config import NMFConfig, check_device
from ..ops import cuda_lib, fused_kl, fused_mu, linalg, sparse
from ..utils import timing
from . import updates


def step_for(A, W, norm: str, W_update: bool, chunk: int,
             use_fused: bool | None = None):
    """The update step for these operands (``nmf.py:62-75`` and the fusion
    rule of :209-233, restated for the card). ``use_fused`` is the config's:

    * FRO with a W update on CUDA takes kernel K1 for k <= 64 and an f32,
      bf16 or uint8 A with f32 factors, unless ``use_fused`` is False;
      otherwise the two-pass step of plain products, which is what JAX runs
      outside any kernel. The W-frozen refit is always the two-pass step,
      as in JAX.
    * KL with ``use_fused=True`` and a W update takes the one-pass step,
      kernel K3 on CUDA, for k <= 64, a non-f64 A and f32 factors (on the
      CPU its plain version); f64 keeps the plain products, as
      ``updates.mu_kl_step`` does for K2.
    * Otherwise KL takes the ratio products, kernels K2a/K2b on CUDA for an
      f32, bf16 or uint8 A (``updates.mu_kl_step``).
    * A sparse A takes the two-pass steps over its format's products: K4 on
      CUDA for the dual ELL (``ops/ell.py``); K1, K2 and K3 never see it.
    """
    if linalg.is_sparse(A):
        step = updates.mu_fro_step if norm == "fro" else updates.mu_kl_step
        return partial(step, W_update=W_update)
    k = W.shape[-1]
    kernel_types = A.dtype in cuda_lib.A_SUFFIX and W.dtype == torch.float32
    if norm == "fro":
        if (W_update and use_fused is not False and A.is_cuda and kernel_types
                and k <= fused_mu.MAX_K):
            return fused_mu.fused_mu_fro_step
        return partial(updates.mu_fro_step, W_update=W_update)
    if use_fused and W_update and kernel_types and k <= fused_kl.MAX_K:
        return partial(fused_kl.fused_mu_kl_step, chunk=chunk)
    return partial(updates.mu_kl_step, W_update=W_update, chunk=chunk)


def _solve(A, W, H, eps, *, norm: str, itr: int, W_update: bool, chunk: int,
           use_fused: bool | None = None, tol: float = 0.0,
           tol_check_every: int = 50, err_chunk: int = 0):
    """The iteration loop of ``pydnmfk_tpu/models/nmf.py::_solve`` (MU)."""
    step = step_for(A, W, norm, W_update, chunk, use_fused)

    def body(i, W, H):
        W, H = step(A, W, H, eps)
        if i % 10 == 0:
            W, H = W.clamp_min(eps), H.clamp_min(eps)
        return W, H

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
            new_err = linalg.relative_error(A, W, H, err_chunk)
            err_prev = torch.where(live, err, err_prev)
            err = torch.where(live, new_err, err)
        live = err_prev - err > tol
        if n_full * chunk_n < itr and bool(live.any()):
            W, H = advance(n_full * chunk_n, itr, live, W, H)

    W, H = linalg.normalize_features(W, H, eps)
    err = linalg.relative_error(A, W, H, err_chunk)
    return W, H, err


def solve(A, W, H, eps, cfg: NMFConfig):
    """Run the full iteration loop on one matrix, or on a stack of ensemble
    members along a leading axis of A, W and H (``nmf.py::solve``). A
    sparse A comes in the format that its caller's ``_prepare`` chose
    (``ops/sparse.py::densify_for_backend``), and needs no row chunks."""
    m, n = A.shape[-2:]
    norm = cfg.norm.lower()
    dense_chunk = 0 if linalg.is_sparse(A) else linalg.error_chunk_rows(m, n)
    return _solve(A, W, H, eps, norm=norm, itr=cfg.itr, W_update=cfg.W_update,
                  chunk=dense_chunk if norm == "kl" else 0,
                  use_fused=cfg.use_fused, tol=float(cfg.tol),
                  tol_check_every=int(cfg.tol_check_every),
                  err_chunk=dense_chunk)


def init_factors_rand(generator: torch.Generator, m: int, n: int, k: int,
                      dtype, device):
    """U[0, 1) factors drawn in f32 (pyDNMF.py:110-129)."""
    W = torch.rand((m, k), generator=generator, device=device)
    H = torch.rand((k, n), generator=generator, device=device)
    return W.to(dtype), H.to(dtype)


class NMF:
    """One NMF fit: init -> iterate -> normalize -> error; mirror of
    ``pydnmfk_tpu.NMF`` on one device, the CUDA card unless ``device``
    says otherwise."""

    def __init__(self, cfg: NMFConfig, device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        self.recon_err = None

    def _prepare(self, A):
        """A on the device at its storage dtype; a uint8 ``a_precision``
        keeps A at the factor dtype here, and ``fit`` quantizes it just
        before the solve (nmf.py:383-386). A sparse A (SparseTriplet or
        EllSparse) goes through the format policy (nmf.py:351-380): the
        triplet stays on the CPU; on the card it becomes the dual ELL or a
        dense A. ``a_precision`` applies to the nnz values of a sparse A,
        uint8 excepted (nmf.py:364-368); a dense A that the policy narrowed
        to bf16 keeps bf16. The JAX package's other rejections for a sparse
        A (BCD, nnsvd, prune) are the config's: none of them is ported."""
        cfg = self.cfg
        quantized = not cfg.a_dtype.is_floating_point
        if not linalg.is_sparse(A):
            dtype = cfg.dtype if quantized else cfg.a_dtype
            return torch.as_tensor(A).to(self.device, dtype).contiguous()
        if quantized:
            raise ValueError("quantized (uint8) A storage applies to dense A "
                             "(the sparse formats store only the nnz values); "
                             "drop a_precision for sparse inputs")
        with timing.timed("sparse_format"):
            A = sparse.densify_for_backend(A.to(self.device), k_hint=cfg.k)
        if linalg.is_sparse(A):
            return A.astype(cfg.a_dtype)
        return A if A.dtype == torch.bfloat16 else A.to(cfg.a_dtype)

    def fit(self, A, factors: Optional[Tuple] = None):
        """Returns (W, H, recon_err) as the reference PyNMF.fit does
        (pyDNMF.py:137-182). ``factors`` gives (W0, H0); otherwise they are
        drawn from a generator seeded with ``cfg.seed``. With a uint8
        ``a_precision`` the solve factorizes Q = round(A / s): the error and
        ``column_err`` are Q's, and the returned H carries s
        (nmf.py:477-480, :501-504)."""
        cfg = self.cfg
        check_device(self.device)
        A = self._prepare(A)
        m, n = A.shape
        with timing.timed("init_factors"):
            if factors is not None:
                W = torch.as_tensor(factors[0]).to(self.device, cfg.dtype)
                H = torch.as_tensor(factors[1]).to(self.device, cfg.dtype)
            else:
                generator = torch.Generator(self.device)
                generator.manual_seed(cfg.seed)
                W, H = init_factors_rand(generator, m, n, cfg.k, cfg.dtype,
                                         self.device)
        a_scale = None
        if not cfg.a_dtype.is_floating_point:     # _prepare refused sparse
            A, a_scale = linalg.quantize_uint8(A)
        with timing.timed("solve"):
            W, H, err = solve(A, W.contiguous(), H.contiguous(), cfg.eps, cfg)
        self.recon_err = float(err)
        self._A, self._W, self._H = A, W, H       # Q-scale, for column_err
        if a_scale is not None:
            H = H * a_scale.to(H.dtype)
        if cfg.save_factors:
            from ..utils.io import DataWriter
            with timing.timed("save_factors"):
                DataWriter(cfg.results_path).save_factors(W, H)
        return W, H, self.recon_err

    def column_err(self) -> np.ndarray:
        """Per-column relative error of the last fit (pyDNMF.py:220-239)."""
        m, n = self._A.shape
        col = linalg.column_error(self._A, self._W, self._H,
                                  linalg.error_chunk_rows(m, n))
        return col.cpu().numpy()
