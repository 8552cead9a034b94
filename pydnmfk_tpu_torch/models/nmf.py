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

from ..config import NMFConfig
from ..ops import fused_mu, linalg
from ..utils import timing
from . import updates


def step_for(A, W, norm: str, W_update: bool, chunk: int):
    """The update step for these operands (``nmf.py:62-75`` and the fusion
    rule of :209-231, restated for the card):

    * FRO with a W update on CUDA takes kernel K1 for k <= 64 and an f32 or
      bf16 A with f32 factors; otherwise the two-pass step of plain products,
      which is what JAX runs outside any kernel. The W-frozen refit is
      always the two-pass step, as in JAX.
    * KL takes the ratio products, which are kernels K2a/K2b on CUDA for an
      f32 or bf16 A (``updates.mu_kl_step``).
    """
    if norm == "fro":
        if (W_update and A.is_cuda and W.shape[-1] <= fused_mu.MAX_K
                and A.dtype in (torch.float32, torch.bfloat16)
                and W.dtype == torch.float32):
            return fused_mu.fused_mu_fro_step
        return partial(updates.mu_fro_step, W_update=W_update)
    return partial(updates.mu_kl_step, W_update=W_update, chunk=chunk)


def _solve(A, W, H, eps, *, norm: str, itr: int, W_update: bool, chunk: int,
           tol: float = 0.0, tol_check_every: int = 50, err_chunk: int = 0):
    """The iteration loop of ``pydnmfk_tpu/models/nmf.py::_solve`` (MU)."""
    step = step_for(A, W, norm, W_update, chunk)

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
        batch = A.shape[:-2]
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
    members along a leading axis of A, W and H (``nmf.py::solve``)."""
    m, n = A.shape[-2:]
    norm = cfg.norm.lower()
    chunk = linalg.error_chunk_rows(m, n) if norm == "kl" else 0
    return _solve(A, W, H, eps, norm=norm, itr=cfg.itr, W_update=cfg.W_update,
                  chunk=chunk, tol=float(cfg.tol),
                  tol_check_every=int(cfg.tol_check_every),
                  err_chunk=linalg.error_chunk_rows(m, n))


def init_factors_rand(generator: torch.Generator, m: int, n: int, k: int,
                      dtype, device):
    """U[0, 1) factors drawn in f32 (pyDNMF.py:110-129)."""
    W = torch.rand((m, k), generator=generator, device=device)
    H = torch.rand((k, n), generator=generator, device=device)
    return W.to(dtype), H.to(dtype)


class NMF:
    """One NMF fit: init -> iterate -> normalize -> error; mirror of
    ``pydnmfk_tpu.NMF`` on one device."""

    def __init__(self, cfg: NMFConfig, device="cpu"):
        self.cfg = cfg
        self.device = torch.device(device)
        self.recon_err = None

    def fit(self, A, factors: Optional[Tuple] = None):
        """Returns (W, H, recon_err) as the reference PyNMF.fit does
        (pyDNMF.py:137-182). ``factors`` gives (W0, H0); otherwise they are
        drawn from a generator seeded with ``cfg.seed``."""
        cfg = self.cfg
        A = torch.as_tensor(A).to(self.device, cfg.a_dtype).contiguous()
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
        with timing.timed("solve"):
            W, H, err = solve(A, W.contiguous(), H.contiguous(), cfg.eps, cfg)
        self.recon_err = float(err)
        self._A, self._W, self._H = A, W, H
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
