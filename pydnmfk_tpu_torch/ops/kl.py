"""The two products of the KL multiplicative update: kernels K2a and K2b
(``csrc/kl_ratio.cu``).

Port of ``pydnmfk_tpu/ops/kl.py`` and ``ops/pallas_kernels.py``. With the
ratio U = A / (W H + eps),

    UHT = U H^T    (m, k)   for the W update    K2a (kl_uht)
    WTU = W^T U    (k, n)   for the H update    K2b (kl_wtu)

:func:`kl_uht` and :func:`kl_wtu` dispatch on the tensor's device: for a CPU
tensor they run the plain versions, which bound U to ``chunk`` rows at a
time (``kl.py::_chunked``); for a CUDA tensor they launch the kernel, which
never writes U to device memory, or raise. Inputs are one matrix or a stack
with the ensemble member as the leading axis. A is f32, bf16 or uint8, and
the ratio is f32 for each of them, as ``pydnmfk_tpu/ops/kl.py:33-34``
divides the integer A by an f32 WH.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .cuda_lib import A_SUFFIX, check, check_operands, load
from .linalg import matmul

# K2a / K2b launches since the last reset (counted where a kernel launches)
launches = {"kl_uht": 0, "kl_wtu": 0}

MAX_K = 256         # widest factor the kernels' shared-memory tiles hold


def _ratio(A, W, H, eps):
    return A / (matmul(W, H) + eps)


def kl_uht_plain(A, W, H, eps, chunk: int = 0):
    """(A / (W H + eps)) H^T over row slabs of ``chunk`` rows (0 = whole)."""
    m = A.shape[-2]
    if not chunk or chunk >= m:
        return matmul(_ratio(A, W, H, eps), H.mT)
    out = torch.empty(W.shape, dtype=torch.result_type(A, W), device=A.device)
    for r0 in range(0, m, chunk):
        a, w = A[..., r0:r0 + chunk, :], W[..., r0:r0 + chunk, :]
        out[..., r0:r0 + chunk, :] = matmul(_ratio(a, w, H, eps), H.mT)
    return out


def kl_wtu_plain(A, W, H, eps, chunk: int = 0):
    """W^T (A / (W H + eps)) over row slabs of ``chunk`` rows (0 = whole)."""
    m = A.shape[-2]
    if not chunk or chunk >= m:
        return matmul(W.mT, _ratio(A, W, H, eps))
    acc = None
    for r0 in range(0, m, chunk):
        a, w = A[..., r0:r0 + chunk, :], W[..., r0:r0 + chunk, :]
        part = matmul(w.mT, _ratio(a, w, H, eps))
        acc = part if acc is None else acc + part
    return acc


@functools.lru_cache(maxsize=None)
def _lib():
    lib = load("kl_ratio")
    p, i = ctypes.c_void_p, ctypes.c_int
    for fn in (getattr(lib, f"kl_{which}_{suffix}")
               for which in ("uht", "wtu") for suffix in A_SUFFIX.values()):
        fn.argtypes = [p, p, p, ctypes.c_float, i, i, i, i, p, p]
        fn.restype = i
    lib.kl_ratio_error_string.argtypes = [i]
    lib.kl_ratio_error_string.restype = ctypes.c_char_p
    return lib


def _launch(which: str, A, W, H, eps):
    single = A.dim() == 2
    if single:
        A, W, H = A[None], W[None], H[None]
    B, m, n = A.shape
    k = W.shape[-1]
    if W.shape != (B, m, k) or H.shape != (B, k, n):
        raise ValueError(f"K2 shapes: A {tuple(A.shape)}, W {tuple(W.shape)}, "
                         f"H {tuple(H.shape)}")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"K2 takes 1 <= k <= {MAX_K}, got k={k}")
    check_operands("K2", A, W=W, H=H)
    shape = (B, m, k) if which == "kl_uht" else (B, k, n)
    out = torch.empty(shape, dtype=torch.float32, device=A.device)
    lib = _lib()
    fn = getattr(lib, f"{which}_{A_SUFFIX[A.dtype]}")
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream(A.device).cuda_stream
        rc = fn(A.data_ptr(), W.data_ptr(), H.data_ptr(), float(eps), B, m,
                n, k, out.data_ptr(), stream)
    check(rc, lib, "kl_ratio_error_string", f"K2 {which}")
    launches[which] += 1
    return out[0] if single else out


def kl_uht(A, W, H, eps, chunk: int = 0):
    """(A / (W H + eps)) H^T; CPU: plain (row-chunked), CUDA: K2a."""
    if A.device.type == "cpu":
        return kl_uht_plain(A, W, H, eps, chunk)
    return _launch("kl_uht", A, W, H, eps)


def kl_wtu(A, W, H, eps, chunk: int = 0):
    """W^T (A / (W H + eps)); CPU: plain (row-chunked), CUDA: K2b."""
    if A.device.type == "cpu":
        return kl_wtu_plain(A, W, H, eps, chunk)
    return _launch("kl_wtu", A, W, H, eps)
