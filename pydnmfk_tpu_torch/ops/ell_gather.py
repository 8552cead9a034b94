"""The ELL gather product: kernel K4 (``csrc/ell_gather.cu``).

Port of ``pydnmfk_tpu/ops/pallas_ell.py`` and of the plain product of
``pydnmfk_tpu/ops/ell.py::_gather_product``. For each member e and line b:

    out[e, b, :] = sum_s coef[e, b, s] * T[e, idx[b, s], :]
    coef = vals[e, b, s]                                       (plain)
    coef = vals[e, b, s] / (<X[e, b, :], T[e, idx[b, s], :]> + eps)   (ratio)

vals (..., dim, w) f32, bf16 or f16; idx (dim, w) int32, shared by the
members; the table T (..., dim_t, k) and X (..., dim, k) f32, or bf16 / f16
factors, which the wrapper widens to f32 (exact; the table is k-sized, not
nnz-sized); out (..., dim, k) f32. f16 values count their launches under
their own keys.
The row orientation of an ELL A takes T = H^T (A H^T, and with X = W the KL
product UHT); the column orientation takes T = W (W^T A, and with X = H^T
the KL product WTU).

:func:`ell_gather_product` dispatches on the tensor's device: for a CPU
tensor it runs :func:`ell_gather_product_plain`; for a CUDA tensor it
launches K4 or raises. The one exception is f64, which takes the plain path
on any device: the kernel accumulates in f32 (``ops/ell.py:284-285``).

At k <= 32 K4 gathers the members of a stack in groups of G, over a table
that :func:`interleave` lays out per group as (dim_t, G, KP): one index then
names one contiguous run of G padded rows. :func:`member_groups` picks G from
the width and the largest group that the kernel exports
(``ell_gather_geometry`` in ``csrc/ell_gather.cu``) and the card's L2 size.
Past 32 K4 covers the output in column slabs, each as wide as
:func:`slab_plan` lets one member's part of the table fit a share of the
L2, over a table that :func:`slab_table` lays out slab after slab. Its ratio
modes take one slab up to the widest, 256 columns; past it they sum each
slot's dot in a pass of their own into an f32 workspace, then run the plain
product on the coefficients.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from .cuda_lib import check, load
from .linalg import HALF, acc_dtype

# K4 launches since the last reset, by mode (counted where the kernel
# launches)
launches = {"ell_gather": 0, "ell_gather_ratio": 0, "ell_gather_f16": 0,
            "ell_gather_ratio_f16": 0}
# of them, by the same keys, the calls past k = 32 (the slab kernels') and,
# of those, the calls that ran in more than one slab; a ratio call in slabs
# counts once, though it takes two passes
wide_launches = dict.fromkeys(launches, 0)
slab_launches = dict.fromkeys(launches, 0)
_VALS = {torch.float32: "f32", torch.bfloat16: "bf16", torch.float16: "f16"}

L2_SHARE = 0.5      # of the card's L2 that one group's table may fill
LINE_BYTES = 128    # the L1's line: one gathered run fills it
MAX_IDLE = 0.25     # of the lanes that a ragged last group may leave idle
SLAB_SHARE = 1.0    # of the card's L2 that one member's slab may fill
MIN_SLAB = 32       # floats: the narrowest slab, rows of one 128-byte line
# the plan of a budget made off the card: the H100's L2 and the kernel's
# widest slab (``ell_gather_geometry``; tests/test_torch_cuda.py holds the
# two equal)
H100_L2_BYTES = 50 * 2 ** 20
MAX_SLAB = 256
# the L2's gather rate for uniform indices, 64- to 256-byte rows of an 8 MB
# table (``bench_torch/gather_probe.cu``, H100 80GB HBM3 at 700 W): no plan
# reads it; ``chip_smoke.py`` and ``k4_bench.py`` print K4's gathers (every
# nonzero's k floats) at this rate as an estimate beside their bound
L2_GATHER_BYTES = 8.27e12


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


def member_groups(B: int, dim_t: int, kp: int, max_group: int,
                  l2_bytes: int) -> int:
    """Members K4 gathers together: the smallest power of two G whose run of
    G rows of ``kp`` floats fills a 128-byte line, or that holds all B
    members, whichever is less; at most ``max_group``
    (``ell_gather_geometry``), and halved until the group's interleaved
    table (``dim_t`` runs) fills at most L2_SHARE of the L2 (one member may
    fill more) and at most MAX_IDLE of the lanes idle in a ragged last
    group; 0 when the kernel takes no groups (``max_group`` 0: k > 32).
    Wider runs gain nothing on a line's wavefront, and idle lanes cost
    issue slots (``bench_torch/gather_probe.cu``, ``k4_bench.py
    --group-sweep``)."""
    if max_group == 0:
        return 0
    g = 1
    while (g < B and 2 * g <= max_group and g * kp * 4 < LINE_BYTES
           and 2 * g * dim_t * kp * 4 <= L2_SHARE * l2_bytes):
        g *= 2
    while g > 1 and idle_lanes(B, g) > MAX_IDLE:
        g //= 2
    return g


def slab_plan(dim_t: int, k: int, l2_bytes: int, max_slab: int,
              ratio: bool = False) -> tuple:
    """(slab width KS, slab count) of K4 at k > 32 on a ``dim_t``-row table:
    one slab of k where k is at most ``max_slab`` (the kernel's widest,
    ``ell_gather_geometry``) and one member's whole table (``dim_t`` rows of
    k floats) fits SLAB_SHARE of the L2, or the product is a ``ratio``: its
    one pass, the dot in registers, beats a dot pass and a plain pass over
    slabs at every width, tables past the L2 included. Else a power of two
    from MIN_SLAB to ``max_slab`` whose slab of the table fits the share
    (the narrowest where none does) and that pads k the least, the widest
    of those. The last slab takes the k - (count - 1) KS columns left.

    From ``bench_torch/k4_bench.py --slab-sweep`` at the NYTimes shape and
    on the topic stack (H100): slabs gather from the L2 where a whole table
    would come from device memory, so a table past the L2 runs faster in
    slabs (W at k = 128, 1.5 L2, 4.99 ms in four against 8.03 in one) and
    one that fits in one (the stack's W at k = 64, 0.98 L2, 3.05 against
    3.52 in two); a slab costs its kernel's width, whatever columns it
    holds (at k = 300, slabs of 32 and 64 took the same time, of 48 and 96
    up to 40 % more; rows of 64 bytes gather at half the rate of 128-byte
    ones, ``bench_torch/gather_probe.cu``)."""
    share = SLAB_SHARE * l2_bytes
    if k <= max_slab and (ratio or 4 * dim_t * k <= share):
        return k, 1
    widths = [w for w in (2 ** i for i in range(5, 9))
              if MIN_SLAB <= w <= max_slab]
    fits = [w for w in widths if 4 * dim_t * w <= share] or widths[:1]
    ks = min(fits, key=lambda w: (-(-k // w) * w, -w))
    return ks, -(-k // ks)


def idle_lanes(B: int, group: int) -> float:
    """The share of the lanes that groups of ``group`` leave without a
    member: the last group holds B % group."""
    slots = -(-B // group) * group
    return 1 - B / slots


def interleave(T, group: int, kp: int):
    """K4's table at k <= 32: T (B, dim_t, k) as a flat f32 tensor that
    holds, group after group of ``group`` members (the last takes the B %
    group left), the members' rows side by side, each padded with zeros to
    ``kp`` floats: (dim_t, gg, kp) for a group of gg. At group 1 and k ==
    kp that is a contiguous T itself, and T is returned uncopied. In plain
    torch; on the card the wrapper makes the same table with one kernel
    (``ell_gather_interleave``)."""
    B, dim_t, k = T.shape
    if group == 1 and k == kp and T.is_contiguous():
        return T
    out = T.new_empty(B * dim_t * kp)
    full = B // group * group
    for e0, e1, g in ((0, full, group), (full, B, B - full)):
        if e1 == e0:
            continue
        dst = out[e0 * dim_t * kp:e1 * dim_t * kp].view(
            (e1 - e0) // g, dim_t, g, kp)
        dst[..., :k].copy_(T[e0:e1].view((e1 - e0) // g, g, dim_t, k)
                           .transpose(1, 2))
        dst[..., k:].zero_()
    return out


def slab_table_plain(T, slab: int):
    """K4's table at k > 32: T (B, dim_t, k) as a flat f32 tensor that
    holds, member after member, its slabs of ``slab`` columns one after
    the other, (nslab, dim_t, ldt) with ldt = ``slab`` rounded up to 4 and
    zeros past k. In plain torch; on the card the wrapper makes the same
    table with one kernel (``ell_gather_slab_table``)."""
    B, dim_t, k = T.shape
    nslab, ldt = -(-k // slab), -(-slab // 4) * 4
    out = T.new_zeros((B, nslab, dim_t, ldt))
    for j in range(nslab):
        cols = T[..., j * slab:min(k, (j + 1) * slab)]
        out[:, j, :, :cols.shape[-1]] = cols
    return out.reshape(-1)


@functools.lru_cache(maxsize=None)
def _lib():
    lib = load("ell_gather")
    p, i = ctypes.c_void_p, ctypes.c_int
    for suffix in _VALS.values():
        fn = getattr(lib, f"ell_gather_{suffix}")
        fn.argtypes = [p, p, p, p, ctypes.c_float, i, i, i, i, i, i, i, i, p,
                       p, p]
        fn.restype = i
    lib.ell_gather_interleave.argtypes = [p, p, i, i, i, i, i, p]
    lib.ell_gather_interleave.restype = i
    lib.ell_gather_slab_table.argtypes = [p, p, i, i, i, i, p]
    lib.ell_gather_slab_table.restype = i
    lib.ell_gather_geometry.argtypes = [i, p, p, p]
    lib.ell_gather_geometry.restype = i
    lib.ell_gather_error_string.argtypes = [i]
    lib.ell_gather_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def geometry(k: int) -> tuple:
    """(KP, largest member group, widest slab) of K4 at width k, as the
    kernel exports them (``ell_gather_geometry``): KP and the group are 0
    at k > 32, the widest slab 0 at k <= 32."""
    lib = _lib()
    kp, gmax, smax = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    check(lib.ell_gather_geometry(k, ctypes.byref(kp), ctypes.byref(gmax),
                                  ctypes.byref(smax)),
          lib, "ell_gather_error_string", "K4 ell_gather_geometry")
    return kp.value, gmax.value, smax.value


def group_for(B: int, dim_t: int, k: int, device, group=None) -> tuple:
    """(KP, G) of a launch: :func:`member_groups` on the card's L2, or the
    ``group`` asked for (checked against the kernel's largest)."""
    kp, gmax, _ = geometry(k)
    if group is None:
        l2 = torch.cuda.get_device_properties(device).L2_cache_size
        return kp, member_groups(B, dim_t, kp, gmax, l2)
    if gmax == 0 or group not in (1, 2, 4, 8) or group > gmax:
        raise ValueError(f"K4 at k={k} takes member groups of 1 to {gmax} "
                         f"(powers of two), not {group}")
    return kp, group


def grouped_table(T, group: int, kp: int):
    """:func:`interleave` of a contiguous f32 T on the card, by one kernel
    (``ell_gather_interleave``); T itself at group 1 and k == kp."""
    B, dim_t, k = T.shape
    if group == 1 and k == kp:
        return T
    table = torch.empty(B * dim_t * kp, dtype=torch.float32, device=T.device)
    lib = _lib()
    with torch.cuda.device(T.device):
        stream = torch.cuda.current_stream(T.device).cuda_stream
        rc = lib.ell_gather_interleave(T.data_ptr(), table.data_ptr(), B,
                                       dim_t, k, kp, group, stream)
    check(rc, lib, "ell_gather_error_string", "K4 ell_gather_interleave")
    return table


def slab_for(dim_t: int, k: int, device, slab=None, ratio=False) -> tuple:
    """(KS, slab count) of a k-wide product (a ``ratio`` one or not) over a
    ``dim_t``-row table: one slab at k <= 32 (the grouped kernel); else
    :func:`slab_plan` on the card's L2 and the kernel's widest slab (for a
    device that runs no K4, the H100's: the memory model plans for it), or
    the ``slab`` asked for (1 to the widest; one slab of k from k on)."""
    if k <= 32:
        return k, 1
    cuda = torch.device(device).type == "cuda"
    smax = geometry(k)[2] if cuda else MAX_SLAB
    if slab is None:
        l2 = (torch.cuda.get_device_properties(device).L2_cache_size if cuda
              else H100_L2_BYTES)
        return slab_plan(dim_t, k, l2, smax, ratio)
    if not 1 <= slab <= smax:
        raise ValueError(f"K4 at k={k} takes slabs of 1 to {smax} columns, "
                         f"not {slab}")
    slab = min(slab, k)
    return slab, -(-k // slab)


def slab_table(T, slab: int):
    """:func:`slab_table_plain` of a contiguous f32 T on the card, by one
    kernel (``ell_gather_slab_table``); T itself at one slab of k where k %
    4 == 0 and T is 16-byte aligned."""
    B, dim_t, k = T.shape
    if slab == k and k % 4 == 0 and T.data_ptr() % 16 == 0:
        return T
    nslab, ldt = -(-k // slab), -(-slab // 4) * 4
    table = torch.empty(B * nslab * dim_t * ldt, dtype=torch.float32,
                        device=T.device)
    lib = _lib()
    with torch.cuda.device(T.device):
        stream = torch.cuda.current_stream(T.device).cuda_stream
        rc = lib.ell_gather_slab_table(T.data_ptr(), table.data_ptr(), B,
                                       dim_t, k, slab, stream)
    check(rc, lib, "ell_gather_error_string", "K4 ell_gather_slab_table")
    return table


def _launch(vals, idx, T, X, eps, group=None, slab=None):
    """One K4 call; ``group`` (k <= 32) overrides the member groups of the
    plan, ``slab`` (k > 32) its slab width."""
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
    if k < 1:
        raise ValueError(f"K4 takes k >= 1, got k={k}")
    if vals.dtype not in _VALS:
        raise TypeError(f"K4 takes f32, bf16 or f16 values, got {vals.dtype}")
    if T.dtype in HALF:
        T = T.float()
        X = X.float() if ratio else None
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
    ws, ks, nslab = None, 0, 1
    if k <= 32:
        if slab is not None:
            raise ValueError(f"K4 takes slabs past k = 32, not at k={k}")
        kp, G = group_for(B, dim_t, k, vals.device, group)
        table = grouped_table(T, G, kp)
    else:
        if group is not None:
            raise ValueError(f"K4 takes member groups at k <= 32, not at "
                             f"k={k}")
        G = 0
        ks, nslab = slab_for(dim_t, k, vals.device, slab, ratio)
        table = slab_table(T, ks)
        if ratio and nslab > 1:     # the dot pass's sums, then coefficients
            ws = torch.empty((B, dim, w), dtype=torch.float32,
                             device=vals.device)
    out = torch.empty((B, dim, k), dtype=torch.float32, device=vals.device)
    lib = _lib()
    fn = getattr(lib, f"ell_gather_{_VALS[vals.dtype]}")
    with torch.cuda.device(vals.device):
        stream = torch.cuda.current_stream(vals.device).cuda_stream
        rc = fn(vals.data_ptr(), idx.data_ptr(), table.data_ptr(),
                X.data_ptr() if ratio else None, float(eps), int(ratio), B,
                dim, w, dim_t, k, G, ks,
                None if ws is None else ws.data_ptr(), out.data_ptr(), stream)
    check(rc, lib, "ell_gather_error_string", "K4 ell_gather")
    key = (("ell_gather_ratio" if ratio else "ell_gather")
           + ("_f16" if vals.dtype == torch.float16 else ""))
    launches[key] += 1
    if k > 32:
        wide_launches[key] += 1
    if nslab > 1:
        slab_launches[key] += 1
    return out[0] if single else out


def ell_gather_product(vals, idx, T, X=None, eps=0.0):
    """The gather product; CPU or f64: plain, CUDA: K4."""
    if (vals.device.type == "cpu"
            or torch.promote_types(T.dtype, vals.dtype) == torch.float64):
        return ell_gather_product_plain(vals, idx, T, X, eps)
    return _launch(vals, idx, T, X, eps)
