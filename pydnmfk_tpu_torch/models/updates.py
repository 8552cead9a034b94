"""One-step multiplicative updates (Frobenius and KL), dense A.

Port of the dense branches of ``pydnmfk_tpu/models/updates.py::mu_fro_step``
and ``mu_kl_step``; the numerical semantics are the reference's
(dist_nmf.py:715-751 and :803-849). Inputs are one matrix or a stack with the
ensemble member as the leading axis.
"""
from __future__ import annotations

import torch

from ..ops import kl, linalg


def mu_fro_step(A, W, H, eps, W_update: bool = True):
    """Two-pass MU-Fro step: A is read once for A H^T and once for W^T A."""
    if W_update:
        HHT = linalg.gram_t(H)
        AHT = linalg.matmul_AHT(A, H)
        W = W * AHT / (linalg.matmul(W, HHT) + eps)
    WTW = linalg.gram(W)
    WTA = linalg.matmul_WTA(W, A)
    # reference: H *= AtW / (H^T W^T W)^T == WTW @ H (WTW symmetric)
    H = H * WTA / (linalg.matmul(WTW, H) + eps)
    return W, H


def mu_kl_step(A, W, H, eps, W_update: bool = True, chunk: int = 0):
    """MU-KL step over the ratio products. On CUDA the products are kernels
    K2a/K2b for an f32 or bf16 A; an f64 A keeps the plain products, since
    the kernels accumulate in f32 (as ``pydnmfk_tpu/models/nmf.py:200-208``
    keeps f64 off its Pallas kernels). ``chunk`` bounds the plain products'
    ratio slab to that many rows."""
    if A.is_cuda and A.dtype == torch.float64:
        uht, wtu = kl.kl_uht_plain, kl.kl_wtu_plain
    else:
        uht, wtu = kl.kl_uht, kl.kl_wtu
    if W_update:
        h_rowsum = linalg.sum_axis(H, axis=-1)            # (..., k)
        UHT = uht(A, W, H, eps, chunk)                    # (..., m, k)
        W = W * UHT / (h_rowsum.unsqueeze(-2) + eps)
    w_colsum = linalg.sum_axis(W, axis=-2)                # (..., k)
    WTU = wtu(A, W, H, eps, chunk)                        # uses the updated W
    H = H * WTU / (w_colsum.unsqueeze(-1) + eps)
    return W, H
