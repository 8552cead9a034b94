"""One-pass KL-MU iteration: kernel K3 (``csrc/fused_mu_kl.cu``).

Port of ``pydnmfk_tpu/ops/fused_kl.py``. The updated W row panel depends
only on its own rows,

    W'_i = W_i * (U_i H^T) / (rowsum(H) + eps),   U_i = A_i / (W_i H + eps),

so one pass over the row panels of A yields W' and also sums W'^T U' with
U' = A / (W' H + eps), which the H update needs:

    H' = H * (W'^T U') / (colsum(W') + eps).

:func:`fused_kl_pass` is the dispatch: for a CPU tensor it runs
:func:`fused_kl_pass_plain`; for a CUDA tensor it launches K3 or raises.
Inputs are one matrix or a stack with the ensemble member as the leading
axis. Each A dtype counts its launches under its own key, as K1's do.

Types (``fused_kl.py:52-81``): with an f32 A every product is f32. With a
bf16, f16 or uint8 A the products take bf16 operands with f32 sums: W is
rounded for W H, U for U H^T, W' for W' H, W' and U' for W'^T U', and H for
all of them. A itself is widened exactly to f32 for the ratios. rowsum(H)
and the W' update stay f32. The bf16 rounding of U and U' has no
counterpart in K2's step, so at a narrow A this step differs from
``updates.mu_kl_step`` by more than f32 rounding. For an f16 A the JAX
package rounds the operands to f16 (``matmul_compute_dtype``); the port
keeps bf16 for range: with f32 factors eps is 1.2e-7, and U = A / (W H +
eps) can pass f16's largest value, 65504. The kernel takes H already
rounded to bf16 (cast here, the JAX package's rule,
``pydnmfk_tpu/ops/fused_kl.py:154-155``); the plain version rounds the same
H inside its products, so both compute the same function. The factors are
f32, or bf16 / f16 with a bf16, f16 or uint8 A
(``cuda_lib.kernel_types``): half factors are widened to f32 for the launch,
and W' is rounded once to their dtype.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import linalg
from .cuda_lib import A_SUFFIX, check, check_operands, load
from .linalg import HALF

# K3 launches since the last reset (counted where the kernel is launched):
# f32 A, bf16 A, f16 A and uint8 A
launches = {"fused_mu_kl": 0, "fused_mu_kl_bf16": 0, "fused_mu_kl_f16": 0,
            "fused_mu_kl_u8": 0}
# of them, the launches at k > 32 (the 3xTF32 kernel for an f32 A, the
# tensor-core kernel at KP = 64 for a bf16, f16 or uint8 A), by the same keys
wide_launches = dict.fromkeys(launches, 0)
_KEY = {torch.float32: "fused_mu_kl", torch.bfloat16: "fused_mu_kl_bf16",
        torch.float16: "fused_mu_kl_f16", torch.uint8: "fused_mu_kl_u8"}

MAX_K = 64          # the kernel keeps k <= 64 factor columns per thread block


def _bf16_operands(A) -> bool:
    """True where the products take bf16 operands: a bf16, f16 or 8-bit A
    (``pallas_kernels.py::matmul_compute_dtype`` off the TPU, with f16 kept
    at bf16 for range, module docstring)."""
    return A.dtype in HALF or (not A.dtype.is_floating_point
                               and A.dtype.itemsize == 1)


def fused_kl_pass_plain(A, W, H, hrs, eps, chunk: int = 0):
    """(W', W'^T U') of one KL-MU pass as plain products, the reference for
    K3, over row slabs of ``chunk`` rows (0 = whole): W' of a row depends
    on that row alone, so only the order of WTU's sum depends on it."""
    acc = linalg.acc_dtype(W.dtype)
    if _bf16_operands(A):
        nd = lambda x: x.to(torch.bfloat16).to(acc)
    else:
        nd = lambda x: x
    Hn = nd(H.to(acc))
    den = hrs.to(acc).unsqueeze(-2) + eps
    m = A.shape[-2]
    step = chunk if chunk and chunk < m else m
    W_out = torch.empty_like(W)
    WTU = None
    for r0 in range(0, m, step):
        a = A[..., r0:r0 + step, :].to(acc)
        w = W[..., r0:r0 + step, :].to(acc)
        u = a / (torch.matmul(nd(w), Hn) + eps)
        w_new = w * torch.matmul(nd(u), Hn.mT) / den
        W_out[..., r0:r0 + step, :] = w_new
        wn = nd(w_new)
        part = torch.matmul(wn.mT, nd(a / (torch.matmul(wn, Hn) + eps)))
        WTU = part if WTU is None else WTU + part
    return W_out, WTU


@functools.lru_cache(maxsize=None)
def _lib():
    lib = load("fused_mu_kl")
    p, i = ctypes.c_void_p, ctypes.c_int
    for suffix in A_SUFFIX.values():
        fn = getattr(lib, f"fused_mu_kl_{suffix}")
        fn.argtypes = [p, p, p, p, ctypes.c_float, i, i, i, i, p, p, p]
        fn.restype = i
    lib.fused_mu_kl_error_string.argtypes = [i]
    lib.fused_mu_kl_error_string.restype = ctypes.c_char_p
    return lib


def _fused_kl_pass_cuda(A, W, H, hrs, eps):
    single = A.dim() == 2
    if single:
        A, W, H, hrs = A[None], W[None], H[None], hrs[None]
    B, m, n = A.shape
    k = W.shape[-1]
    if W.shape != (B, m, k) or H.shape != (B, k, n) or hrs.shape != (B, k):
        raise ValueError(f"K3 shapes: A {tuple(A.shape)}, W {tuple(W.shape)}, "
                         f"H {tuple(H.shape)}, hrs {tuple(hrs.shape)}")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"K3 takes 1 <= k <= {MAX_K}, got k={k}")
    check_operands("K3", A, {"W": W, "H": H}, {"hrs": hrs})
    w_dtype = W.dtype
    if w_dtype in HALF:
        W, H = W.float(), H.float()
    if A.dtype != torch.float32:       # the bf16 kernels' operand
        H = H.to(torch.bfloat16)
    W_out = torch.empty_like(W)
    WTU = torch.zeros((B, k, n), dtype=torch.float32, device=A.device)
    lib = _lib()
    fn = getattr(lib, f"fused_mu_kl_{A_SUFFIX[A.dtype]}")
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream(A.device).cuda_stream
        rc = fn(A.data_ptr(), W.data_ptr(), H.data_ptr(), hrs.data_ptr(),
                float(eps), B, m, n, k, W_out.data_ptr(), WTU.data_ptr(),
                stream)
    check(rc, lib, "fused_mu_kl_error_string", "K3 fused_mu_kl")
    launches[_KEY[A.dtype]] += 1
    if k > 32:
        wide_launches[_KEY[A.dtype]] += 1
    W_out = W_out.to(w_dtype)
    if single:
        return W_out[0], WTU[0]
    return W_out, WTU


def fused_kl_pass(A, W, H, hrs, eps, chunk: int = 0):
    """(W', W'^T U') of one KL-MU pass; CPU: plain (row-chunked), CUDA: K3."""
    if A.device.type == "cpu":
        return fused_kl_pass_plain(A, W, H, hrs, eps, chunk)
    return _fused_kl_pass_cuda(A, W, H, hrs, eps)


def fused_mu_kl_step(A, W, H, eps, W_update: bool = True, chunk: int = 0):
    """One full KL-MU iteration with the W pass and W'^T U' in one pass over
    A (``pydnmfk_tpu/ops/fused_kl.py::fused_mu_kl_step``). The W-frozen
    refit takes ``updates.mu_kl_step``, as in JAX."""
    if not W_update:
        from ..models import updates
        return updates.mu_kl_step(A, W, H, eps, W_update=False, chunk=chunk)
    hrs = linalg.sum_axis(H, axis=-1).float()
    W_new, WTU = fused_kl_pass(A, W, H, hrs, eps, chunk)
    w_colsum = linalg.sum_axis(W_new, axis=-2).float()
    H_new = H.float() * WTU / (w_colsum.unsqueeze(-1) + eps)
    return W_new, H_new.to(H.dtype)
