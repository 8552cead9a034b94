"""One-pass Frobenius-MU W pass: kernel K1 (``csrc/fused_mu_fro.cu``).

Port of ``pydnmfk_tpu/ops/fused_mu.py``. The updated W row panel depends
only on its own rows of A H^T,

    W'_i = W_i * (A_i H^T) / (W_i (H H^T) + eps),

so one pass over the row panels of A yields W' and also sums W'^T A and
W'^T W', which the H update needs:

    H' = H * (W'^T A) / ((W'^T W') H + eps).

:func:`fused_w_pass` is the dispatch: for a CPU tensor it runs
:func:`fused_w_pass_plain`, the same maths as two plain products; for a CUDA
tensor it launches K1 or raises. Inputs are one matrix or a stack with the
ensemble member as the leading axis. A is f32, bf16 or uint8 (the quantized
A of ``linalg.quantize_uint8``); each dtype counts its launches under its
own key. A bf16 or uint8 A takes the tensor-core kernel, which gets H
rounded to bf16 here (the JAX package's rule, ``pydnmfk_tpu/ops/
fused_mu.py:170-173``); the plain version rounds the same H inside its
products, so both compute the same function.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import linalg
from .cuda_lib import A_SUFFIX, check, check_operands, load

# K1 launches since the last reset (counted where the kernel is launched):
# f32 A, bf16 A and uint8 A
launches = {"fused_mu_fro": 0, "fused_mu_fro_bf16": 0, "fused_mu_fro_u8": 0}
_KEY = {torch.float32: "fused_mu_fro", torch.bfloat16: "fused_mu_fro_bf16",
        torch.uint8: "fused_mu_fro_u8"}

MAX_K = 64          # the kernel keeps k <= 64 factor columns per thread block


def fused_w_pass_plain(A, W, H, HHT, eps):
    """(W', W'^T A, W'^T W') as two plain products: the reference for K1."""
    AHT = linalg.matmul_AHT(A, H)
    W_new = W * AHT / (linalg.matmul(W, HHT) + eps)
    return W_new, linalg.matmul_WTA(W_new, A), linalg.gram(W_new)


@functools.lru_cache(maxsize=None)
def _lib():
    lib = load("fused_mu_fro")
    p, i = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.fused_mu_fro_f32, lib.fused_mu_fro_bf16,
               lib.fused_mu_fro_u8):
        fn.argtypes = [p, p, p, p, ctypes.c_float, i, i, i, i, p, p, p, p]
        fn.restype = i
    lib.fused_mu_fro_error_string.argtypes = [i]
    lib.fused_mu_fro_error_string.restype = ctypes.c_char_p
    return lib


def _fused_w_pass_cuda(A, W, H, HHT, eps):
    single = A.dim() == 2
    if single:
        A, W, H, HHT = A[None], W[None], H[None], HHT[None]
    B, m, n = A.shape
    k = W.shape[-1]
    if W.shape != (B, m, k) or H.shape != (B, k, n) or HHT.shape != (B, k, k):
        raise ValueError(f"K1 shapes: A {tuple(A.shape)}, W {tuple(W.shape)}, "
                         f"H {tuple(H.shape)}, HHT {tuple(HHT.shape)}")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"K1 takes 1 <= k <= {MAX_K}, got k={k}")
    check_operands("K1", A, W=W, H=H, HHT=HHT)
    if A.dtype != torch.float32:       # the tensor-core kernel's operand
        H = H.to(torch.bfloat16)
    W_out = torch.empty_like(W)
    WTA = torch.zeros((B, k, n), dtype=torch.float32, device=A.device)
    WTW = torch.zeros((B, k, k), dtype=torch.float32, device=A.device)
    lib = _lib()
    fn = getattr(lib, f"fused_mu_fro_{A_SUFFIX[A.dtype]}")
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream(A.device).cuda_stream
        rc = fn(A.data_ptr(), W.data_ptr(), H.data_ptr(), HHT.data_ptr(),
                float(eps), B, m, n, k, W_out.data_ptr(), WTA.data_ptr(),
                WTW.data_ptr(), stream)
    check(rc, lib, "fused_mu_fro_error_string", "K1 fused_mu_fro")
    launches[_KEY[A.dtype]] += 1
    if single:
        return W_out[0], WTA[0], WTW[0]
    return W_out, WTA, WTW


def fused_w_pass(A, W, H, HHT, eps):
    """(W', W'^T A, W'^T W') of one FRO-MU W pass; CPU: plain, CUDA: K1."""
    if A.device.type == "cpu":
        return fused_w_pass_plain(A, W, H, HHT, eps)
    return _fused_w_pass_cuda(A, W, H, HHT, eps)


def fused_mu_fro_step(A, W, H, eps):
    """One full MU-Fro iteration with the W pass reading A once per panel
    (``pydnmfk_tpu/ops/fused_mu.py::fused_mu_fro_step``)."""
    HHT = linalg.gram_t(H)
    W_new, WTA, WTW = fused_w_pass(A, W, H, HHT, eps)
    H_new = H * WTA / (torch.matmul(WTW, H) + eps)
    return W_new, H_new
