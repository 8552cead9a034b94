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
with the ensemble member as the leading axis. A is f32, bf16, f16 or uint8, and
the kernels' ratio is f32 for each of them, as ``pydnmfk_tpu/ops/kl.py:33-34``
divides the integer A by an f32 WH. On a p_r x p_c grid
:func:`kl_uht_sharded` and :func:`kl_wtu_sharded` run them on a rank's
blocks and all-reduce the products. The factors are f32, or bf16 / f16 with
a bf16, f16 or uint8 A (``cuda_lib.kernel_types``): half factors are
widened to f32 for the launch (exact, k / n of A's bytes), and the f32 sums
are rounded once to the factor dtype, as the JAX package's ``.astype``
after its kernels does (``pallas_kernels.py:150``, ``:189``). Its plain
path rounds W H, U and each product to the half dtype instead, so at half
factors kernel and plain version differ by that rounding. An f16 A counts
its launches under its own keys.

The kernels take every k >= 1: register kernels up to k = 32, 3xTF32
tensor-core kernels above, and past k = 256 slabs of 256 output columns,
each of which recomputes W H over all of k (``csrc/kl_ratio.cu``).

K2b splits each member's rows over several blocks where its strips of
columns alone would leave SMs idle (the single-member refit of NMFk):
:func:`wtu_split_plan` picks the split from the kernel's geometry (which
the source exports), the wrapper allocates the partial sums, and the kernel
adds them in a fixed order, so two launches give the same bits. The plan
counts the whole stack's blocks, so a member of a stack may sum in another
order than alone; the second pass of K1 and K3, which reuses K2b's kernels,
splits by one member's shape instead (``ops/strip.py``).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .cuda_lib import A_SUFFIX, check, check_operands, load
from .linalg import HALF, matmul

# K2a / K2b launches since the last reset (counted where a kernel launches):
# an f32, bf16 or uint8 A, and an f16 A
launches = {"kl_uht": 0, "kl_wtu": 0, "kl_uht_f16": 0, "kl_wtu_f16": 0}
# of them, the launches at k > 32 (the 3xTF32 kernels), by the same keys
tc_launches = dict.fromkeys(launches, 0)

# K2b's row split, where its strips alone leave SMs idle: aim at this many
# blocks per SM (the refit's member: 4, 8 and 16 measured equal, PERF.md)
SPLIT_BLOCKS_PER_SM = 8


def wtu_split_plan(B: int, m: int, n: int, k: int, strip: int, chunk: int,
                   sms: int, splits: int | None = None):
    """(splits, rows per split) of K2b for B members of m x n at factor
    width k, where the kernel takes ``strip`` columns per block and stages W
    ``chunk`` rows at a time (``kl_wtu_geometry`` of the source; strip 0: no
    split) on a card of ``sms`` SMs. Split s takes rows [s R, min(m, (s +
    1) R)) of every member, R a whole number of chunks. Unless ``splits``
    is given, the members split only while their B x strips blocks are
    fewer than the SMs, and then into enough splits that the blocks reach
    SPLIT_BLOCKS_PER_SM x sms: the (splits, B, k, n) f32 partial sums hold
    fewer than 2 x SPLIT_BLOCKS_PER_SM x sms x strip x k values."""
    if strip == 0:
        return 1, m
    blocks = B * -(-n // strip)
    if splits is None:
        splits = -(-SPLIT_BLOCKS_PER_SM * sms // blocks) if blocks < sms else 1
    splits = min(splits, -(-m // chunk))
    if splits <= 1:
        return 1, m
    rows = -(-m // splits)
    rows = -(-rows // chunk) * chunk
    return -(-m // rows), rows


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
    for suffix in A_SUFFIX.values():
        uht, wtu = getattr(lib, f"kl_uht_{suffix}"), getattr(lib, f"kl_wtu_{suffix}")
        uht.argtypes = [p, p, p, ctypes.c_float, i, i, i, i, p, p]
        # ... k, rows per split, scratch, out, stream
        wtu.argtypes = [p, p, p, ctypes.c_float, i, i, i, i, i, p, p, p]
        uht.restype = wtu.restype = i
    lib.kl_wtu_geometry.argtypes = [i, p, p]
    lib.kl_wtu_geometry.restype = i
    lib.kl_ratio_error_string.argtypes = [i]
    lib.kl_ratio_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def wtu_geometry(k: int) -> tuple:
    """(strip, chunk) of K2b's kernel at factor width k, as the source
    exports them."""
    lib = _lib()
    strip, chunk = ctypes.c_int(), ctypes.c_int()
    check(lib.kl_wtu_geometry(k, ctypes.byref(strip), ctypes.byref(chunk)),
          lib, "kl_ratio_error_string", "K2 kl_wtu_geometry")
    return strip.value, chunk.value


@functools.lru_cache(maxsize=None)
def _sms(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _launch(which: str, A, W, H, eps, splits=None):
    single = A.dim() == 2
    if single:
        A, W, H = A[None], W[None], H[None]
    B, m, n = A.shape
    k = W.shape[-1]
    if W.shape != (B, m, k) or H.shape != (B, k, n):
        raise ValueError(f"K2 shapes: A {tuple(A.shape)}, W {tuple(W.shape)}, "
                         f"H {tuple(H.shape)}")
    if k < 1:
        raise ValueError(f"K2 takes k >= 1, got k={k}")
    check_operands("K2", A, {"W": W, "H": H})
    out_dtype = torch.result_type(A, W)
    if W.dtype in HALF:
        W, H = W.float(), H.float()
    shape = (B, m, k) if which == "kl_uht" else (B, k, n)
    out = torch.empty(shape, dtype=torch.float32, device=A.device)
    lib = _lib()
    fn = getattr(lib, f"{which}_{A_SUFFIX[A.dtype]}")
    args = [A.data_ptr(), W.data_ptr(), H.data_ptr(), float(eps), B, m, n, k]
    if which == "kl_wtu":
        splits, rows = wtu_split_plan(B, m, n, k, *wtu_geometry(k),
                                      _sms(A.device), splits)
        scratch = (torch.empty((splits, B, k, n), dtype=torch.float32,
                               device=A.device) if splits > 1 else None)
        args += [rows, None if scratch is None else scratch.data_ptr()]
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream(A.device).cuda_stream
        rc = fn(*args, out.data_ptr(), stream)
    check(rc, lib, "kl_ratio_error_string", f"K2 {which}")
    key = which + ("_f16" if A.dtype == torch.float16 else "")
    launches[key] += 1
    if k > 32:
        tc_launches[key] += 1
    out = out.to(out_dtype)
    return out[0] if single else out


def kl_uht(A, W, H, eps, chunk: int = 0):
    """(A / (W H + eps)) H^T; CPU: plain (row-chunked), CUDA: K2a."""
    if A.device.type == "cpu":
        return kl_uht_plain(A, W, H, eps, chunk)
    return _launch("kl_uht", A, W, H, eps)


def kl_wtu(A, W, H, eps, chunk: int = 0, splits: int | None = None):
    """W^T (A / (W H + eps)); CPU: plain (row-chunked), CUDA: K2b with
    ``splits`` row splits (None: :func:`wtu_split_plan`'s)."""
    if A.device.type == "cpu":
        return kl_wtu_plain(A, W, H, eps, chunk)
    return _launch("kl_wtu", A, W, H, eps, splits)


def kl_uht_sharded(A, W, H, eps, grid, chunk: int = 0, plain: bool = False):
    """(A / (W H + eps)) H^T on a p_r x p_c grid (``ops/kl.py:61-84``):
    :func:`kl_uht` on this rank's blocks (K2a on CUDA, its plan sized by
    the block; ``plain``: the plain version), summed over 'c' in the
    rank's row, the reference's UHT_glob (dist_nmf.py:320-343)."""
    part = (kl_uht_plain if plain else kl_uht)(A, W, H, eps, chunk)
    return grid.sum(part, "c")


def kl_wtu_sharded(A, W, H, eps, grid, chunk: int = 0, plain: bool = False):
    """W^T (A / (W H + eps)) on a grid (``ops/kl.py:86-102``): K2b on this
    rank's blocks, summed over 'r' in the rank's column (reference
    WTU_glob, dist_nmf.py:293-318)."""
    part = (kl_wtu_plain if plain else kl_wtu)(A, W, H, eps, chunk)
    return grid.sum(part, "r")
