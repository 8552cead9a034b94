"""The second pass of K1 and K3 on the card: W'^T A and W'^T (A / (W' H +
eps)) by column strips, every sum in a fixed order (``csrc/kl_ratio.cu``).

K1 (``ops/fused_mu.py``) and K3 (``ops/fused_kl.py``) run in two passes. The
first, one block a row panel, forms W' (and K1's W'^T W', summed over the
panels in panel order). The second forms the k x n product over all rows,
one block a strip of columns and a range of rows, so that no two blocks add
into one output: the same call on the same inputs gives the same bits. The
TPU kernels carry that sum from one grid step to the next in panel order
(``pydnmfk_tpu/ops/fused_mu.py:80-89``, ``ops/fused_kl.py:83-89``).

The second pass reuses K2b's kernels where they compute its function: for
an f32 A, ``kl_wtu_reg_kernel`` without the ratio (K1, C entry
``kl_wta_f32``) and K2b itself on (A, W', H) (K3, ``kl_wtu_f32``); for a
bf16, f16 or uint8 A, ``strip::wtu_strip_kernel`` on the tensor cores
(``wtu_strip_<A>``), with W' rounded to the products' operand dtype, as the
plain versions round it. It calls the C entries, not ``ops/kl.py``'s
wrappers, so K2's launch counters do not move: each K1 or K3 call counts
once, under its own key.

The rows of a member are split over several blocks where its strips alone
would leave SMs idle (:func:`split_plan`), from one member's shape and the
card alone, never from the number of members: a member's bits do not
depend on how many members share its launch. Split s writes slab s of an
f32 scratch, and the slabs are added in order s = 0, 1, ... .
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import kl
from .cuda_lib import A_SUFFIX, check


def split_plan(shape, k: int, strip: int, chunk: int, sms: int):
    """(splits, rows per split) of the second pass on a stack of ``shape``
    (B, m, n) (or one m x n member) at factor width k, for a kernel that
    takes ``strip`` columns a block and ``chunk`` rows at a time, on a card
    of ``sms`` SMs: a member splits while its strips are fewer than
    ``kl.SPLIT_BLOCKS_PER_SM`` blocks an SM, into enough splits to reach
    them (whole chunks each). B does not enter."""
    m, n = int(shape[-2]), int(shape[-1])
    strips = -(-n // strip)
    target = kl.SPLIT_BLOCKS_PER_SM * sms
    splits = -(-target // strips) if strips < target else 1
    return kl.wtu_split_plan(1, m, n, k, strip, chunk, sms, splits)


@functools.lru_cache(maxsize=None)
def _lib():
    lib = kl._lib()
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.kl_wta_f32.argtypes = [p, p, i, i, i, i, i, p, p, p]
    lib.kl_wta_f32.restype = i
    for suffix in ("bf16", "f16", "u8"):
        fn = getattr(lib, f"wtu_strip_{suffix}")
        fn.argtypes = [p, p, p, ctypes.c_float, i, i, i, i, i, i, p, p, p]
        fn.restype = i
    lib.wtu_pass_geometry.argtypes = [i, i, i, p, p]
    lib.wtu_pass_geometry.restype = i
    return lib


@functools.lru_cache(maxsize=None)
def geometry(a_bytes: int, ratio: bool, k: int) -> tuple:
    """(strip, chunk) of the second pass's kernel for an A of ``a_bytes``
    bytes an element, as the source exports them."""
    lib = _lib()
    strip, chunk = ctypes.c_int(), ctypes.c_int()
    check(lib.wtu_pass_geometry(a_bytes, int(ratio), k, ctypes.byref(strip),
                                ctypes.byref(chunk)),
          lib, "kl_ratio_error_string", "wtu_pass_geometry")
    return strip.value, chunk.value


def wt_pass(A, Wn, H, eps, ratio: bool):
    """The second pass on CUDA tensors: W'^T A (``ratio`` False, K1) or
    W'^T (A / (W' H + eps)) (True, K3), (B, k, n) f32, for A (B, m, n), the
    f32 W' (B, m, k) and, with the ratio, H (B, k, n): f32 with an f32 A,
    bf16 (the operand) with a bf16, f16 or uint8 A (one matrix: 2-D, and
    a 2-D result). All contiguous, on one card; the caller (K1's or K3's
    wrapper) has checked them."""
    if A.dim() == 2:
        return wt_pass(A[None], Wn[None], None if H is None else H[None],
                       eps, ratio)[0]
    B, m, n = A.shape
    k = Wn.shape[-1]
    strip, chunk = geometry(A.element_size(), ratio, k)
    splits, rows = split_plan(A.shape, k, strip, chunk, kl._sms(A.device))
    dev = A.device
    out = torch.empty((B, k, n), dtype=torch.float32, device=dev)
    scratch = (torch.empty((splits, B, k, n), dtype=torch.float32, device=dev)
               if splits > 1 else None)
    sc = None if scratch is None else scratch.data_ptr()
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if A.dtype == torch.float32:
            if ratio:
                rc = lib.kl_wtu_f32(A.data_ptr(), Wn.data_ptr(), H.data_ptr(),
                                    float(eps), B, m, n, k, rows, sc,
                                    out.data_ptr(), stream)
            else:
                rc = lib.kl_wta_f32(A.data_ptr(), Wn.data_ptr(), B, m, n, k,
                                    rows, sc, out.data_ptr(), stream)
        else:
            # W' rounded to the products' operand dtype (f16 for K1 on an
            # f16 A, bf16 otherwise), zero-padded to the kernel's width KP
            op = (torch.float16 if A.dtype == torch.float16 and not ratio
                  else torch.bfloat16)
            kp = next(w for w in (8, 16, 32, 64) if k <= w)
            Wq = torch.zeros((B, m, kp), dtype=op, device=dev)
            Wq[..., :k] = Wn
            fn = getattr(lib, f"wtu_strip_{A_SUFFIX[A.dtype]}")
            rc = fn(A.data_ptr(), Wq.data_ptr(),
                    H.data_ptr() if ratio else None, float(eps), int(ratio),
                    B, m, n, k, rows, sc, out.data_ptr(), stream)
    check(rc, lib, "kl_ratio_error_string",
          "K3 pass 2" if ratio else "K1 pass 2")
    return out
