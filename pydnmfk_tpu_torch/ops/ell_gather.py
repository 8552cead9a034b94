"""The ELL gather product: kernel K4 (``csrc/ell_gather.cu``).

Port of ``pydnmfk_tpu/ops/pallas_ell.py`` and of the plain product of
``pydnmfk_tpu/ops/ell.py::_gather_product``. For each member e and line b:

    out[e, b, :] = sum_s coef[e, b, s] * T[e, idx[b, s], :]
    coef = vals[e, b, s]                                       (plain)
    coef = vals[e, b, s] / (<X[e, b, :], T[e, idx[b, s], :]> + eps)   (ratio)

vals (..., dim, w) f32 or bf16; idx (dim, w) int32, shared by the members;
the table T (..., dim_t, k) and X (..., dim, k) f32; out (..., dim, k) f32.
The row orientation of an ELL A takes T = H^T (A H^T, and with X = W the KL
product UHT); the column orientation takes T = W (W^T A, and with X = H^T
the KL product WTU).

:func:`ell_gather_product` dispatches on the tensor's device: for a CPU
tensor it runs :func:`ell_gather_product_plain`; for a CUDA tensor it
launches K4 or raises. The one exception is f64, which takes the plain path
on any device: the kernel accumulates in f32 (``ops/ell.py:284-285``).
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from .cuda_lib import check, load
from .linalg import acc_dtype

# K4 launches since the last reset, by mode (counted where the kernel
# launches)
launches = {"ell_gather": 0, "ell_gather_ratio": 0}

MAX_K = 256         # widest factor row one group of lanes holds


def block_rows(dim: int, w: int, k: int, budget_elems: int = 1 << 26) -> int:
    """Lines per chunk so that the (block, w, k) gather slab of the plain
    product stays under about 256 MB (``ops/ell.py::_block_rows``)."""
    per_row = max(w * k, 1)
    if dim * per_row <= budget_elems:
        return dim
    return max(8, (budget_elems // per_row) // 8 * 8)


def ell_gather_product_plain(vals, idx, T, X=None, eps=0.0):
    """The gather product in plain torch, over line chunks of
    :func:`block_rows`; accumulates in f32 (f64 for an f64 table)."""
    acc = acc_dtype(T.dtype)
    dim, w = idx.shape
    k = T.shape[-1]
    lead = [vals.shape[:-2], T.shape[:-2]]
    if X is not None:
        lead.append(X.shape[:-2])
    batch = torch.broadcast_shapes(*lead)
    out = torch.empty((*batch, dim, k), dtype=acc, device=T.device)
    Ta = T.to(acc)
    step = block_rows(dim, w, k * math.prod(batch))
    for r0 in range(0, dim, step):
        r1 = min(r0 + step, dim)
        g = Ta[..., idx[r0:r1], :]                       # (..., bm, w, k)
        coef = vals[..., r0:r1, :].to(acc)
        if X is not None:
            wh = torch.einsum("...bk,...bwk->...bw", X[..., r0:r1, :].to(acc),
                              g)
            coef = coef / (wh + eps)
        out[..., r0:r1, :] = torch.einsum("...bw,...bwk->...bk", coef, g)
    return out


@functools.lru_cache(maxsize=None)
def _lib():
    lib = load("ell_gather")
    p, i = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.ell_gather_f32, lib.ell_gather_bf16):
        fn.argtypes = [p, p, p, p, ctypes.c_float, i, i, i, i, i, i, p, p]
        fn.restype = i
    lib.ell_gather_error_string.argtypes = [i]
    lib.ell_gather_error_string.restype = ctypes.c_char_p
    return lib


def _launch(vals, idx, T, X, eps):
    ratio = X is not None
    if vals.dim() != T.dim() or vals.dim() not in (2, 3):
        raise ValueError(f"K4 takes vals and T with the same member axis, "
                         f"got {tuple(vals.shape)} and {tuple(T.shape)}")
    single = T.dim() == 2
    if single:
        vals, T = vals[None], T[None]
        X = X[None] if ratio else None
    B, dim, w = vals.shape
    dim_t, k = T.shape[-2:]
    if (idx.shape != (dim, w) or T.shape[0] != B
            or (ratio and X.shape != (B, dim, k))):
        raise ValueError(
            f"K4 shapes: vals {tuple(vals.shape)}, idx {tuple(idx.shape)}, "
            f"T {tuple(T.shape)}, X {None if X is None else tuple(X.shape)}")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"K4 takes 1 <= k <= {MAX_K}, got k={k}")
    if vals.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"K4 takes f32 or bf16 values, got {vals.dtype}")
    if idx.dtype != torch.int32:
        raise TypeError(f"K4 takes int32 indices, got {idx.dtype}")
    named = (("vals", vals), ("idx", idx), ("T", T)) + (
        (("X", X),) if ratio else ())
    for name, t in named:
        if name in ("T", "X") and t.dtype != torch.float32:
            raise TypeError(f"K4 takes an f32 {name}, got {t.dtype}")
        if t.device != vals.device:
            raise ValueError(f"K4: {name} is on {t.device}, vals on "
                             f"{vals.device}")
        if not t.is_contiguous():
            raise ValueError(f"K4 takes a contiguous {name}")
    out = torch.empty((B, dim, k), dtype=torch.float32, device=vals.device)
    lib = _lib()
    fn = lib.ell_gather_f32 if vals.dtype == torch.float32 else lib.ell_gather_bf16
    with torch.cuda.device(vals.device):
        stream = torch.cuda.current_stream(vals.device).cuda_stream
        rc = fn(vals.data_ptr(), idx.data_ptr(), T.data_ptr(),
                X.data_ptr() if ratio else None, float(eps), int(ratio), B,
                dim, w, dim_t, k, out.data_ptr(), stream)
    check(rc, lib, "ell_gather_error_string", "K4 ell_gather")
    launches["ell_gather_ratio" if ratio else "ell_gather"] += 1
    return out[0] if single else out


def ell_gather_product(vals, idx, T, X=None, eps=0.0):
    """The gather product; CPU or f64: plain, CUDA: K4."""
    if (vals.device.type == "cpu"
            or torch.promote_types(T.dtype, vals.dtype) == torch.float64):
        return ell_gather_product_plain(vals, idx, T, X, eps)
    return _launch(vals, idx, T, X, eps)
