"""Plain MU NMF (reference pyDNMF.py, dist_nmf.py:715-751, :803-849).

Products go through :class:`Products`: float32 with TF32 off (the
configurations' precision) or, for the control, TF32. A leading axis of
A, W and H is a stack of independent members.
"""
from __future__ import annotations

import contextlib

import torch

EPS = float(torch.finfo(torch.float32).eps)


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32's 10-bit mantissa, to nearest, ties to even."""
    i = x.contiguous().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32)


class Products:
    """Matrix products in float32 (``tf32=False``) or in TF32: on a CUDA
    card the card's own TF32, on the CPU each operand rounded to TF32."""

    def __init__(self, tf32: bool = False):
        self.tf32 = tf32

    @contextlib.contextmanager
    def _mode(self, on_cuda: bool):
        if not on_cuda:
            yield
            return
        m = torch.backends.cuda.matmul
        saved = m.allow_tf32
        m.allow_tf32 = self.tf32
        try:
            yield
        finally:
            m.allow_tf32 = saved

    def __call__(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.tf32 and a.device.type != "cuda":
            a, b = round_tf32(a), round_tf32(b)
        with self._mode(a.device.type == "cuda"):
            return torch.matmul(a, b)


def fro_step(A, W, H, mm, w_update=True):
    """W <- W (A H^T) / (W H H^T + eps); H <- H (W^T A) / (W^T W H + eps),
    H's update taking the new W."""
    if w_update:
        W = W * mm(A, H.mT) / (mm(W, mm(H, H.mT)) + EPS)
    return W, H * mm(W.mT, A) / (mm(mm(W.mT, W), H) + EPS)


def _ratio(A, W, H, mm):
    WH = mm(W, H)
    WH += EPS
    return torch.div(A, WH, out=WH)


def kl_step(A, W, H, mm, w_update=True):
    """W <- W ((A / (W H + eps)) H^T) / (rowsum(H) + eps); H <- H (W^T (A /
    (W H + eps))) / (colsum(W) + eps), H's update taking the new W."""
    if w_update:
        rowsum = H.sum(-1).unsqueeze(-2)
        W = W * mm(_ratio(A, W, H, mm), H.mT) / (rowsum + EPS)
    colsum = W.sum(-2).unsqueeze(-1)
    return W, H * mm(W.mT, _ratio(A, W, H, mm)) / (colsum + EPS)


def iterate(A, W, H, norm: str, itr: int, mm, w_update=True):
    """``itr`` MU steps, both factors clipped at eps at every tenth from
    the first (pyDNMF.py:155-157, :170-172)."""
    step = fro_step if norm == "fro" else kl_step
    for i in range(itr):
        W, H = step(A, W, H, mm, w_update)
        if i % 10 == 0:
            W, H = W.clamp_min(EPS), H.clamp_min(EPS)
    return W, H


def normalize(W, H):
    """W's columns over their sums plus eps, H's rows times them
    (pyDNMF.py:184-194)."""
    s = W.sum(-2, keepdim=True)
    return W / (s + EPS), H * s.mT


def residual_sums(A, W, H, mm, per_column=False, rows=4096):
    """(sum (A - W H)^2, sum A^2) in float64, over all of a matrix, per
    column, or per member of a stack; in row slabs."""
    if A.dim() == 3:
        sums = [residual_sums(a, w, h, mm, per_column, rows)
                for a, w, h in zip(A, W, H)]
        return tuple(torch.stack(s) for s in zip(*sums))
    dims = 0 if per_column else (0, 1)
    num = den = 0.0
    for r0 in range(0, A.shape[0], rows):
        a = A[r0:r0 + rows]
        r = a - mm(W[r0:r0 + rows], H)
        num = num + (r * r).sum(dims, dtype=torch.float64)
        den = den + (a * a).sum(dims, dtype=torch.float64)
    return num, den


def relative_error(A, W, H, mm):
    """||A - W H||_F / ||A||_F, one value a member (pyDNMF.py:204-210)."""
    num, den = residual_sums(A, W, H, mm)
    return torch.sqrt(num / den)


def column_error(A, W, H, mm):
    """The per-column relative error (pyDNMF.py:220-239)."""
    num, den = residual_sums(A, W, H, mm, per_column=True)
    return torch.sqrt(num / den)


def solve(A, W0, H0, norm: str, itr: int, mm):
    """One fit from (W0, H0): (W, H, relative error), W normalized."""
    W, H = iterate(A, W0, H0, norm, itr, mm)
    W, H = normalize(W, H)
    return W, H, relative_error(A, W, H, mm)
