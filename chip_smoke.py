#!/usr/bin/env python3
"""Smoke run of pydnmfk_tpu_torch on one NVIDIA GPU (H100).

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

1. builds the CUDA kernels from ``pydnmfk_tpu_torch/csrc`` with nvcc, one
   process per source, all at once;
2. checks each kernel against its plain PyTorch version at the shapes the
   main paths give it, and times kernel, plain version and, where one
   PyTorch call computes the same function, that call, with CUDA events:
   - K1, K2a, K2b and K3 at 57600 x 38400, k = 32 (the reference's
     strong-scaling geometry): K1 on an f32, a bf16 and a uint8 A (the
     ``quantize_uint8`` of the f32 one), K2a/K2b and K3 on all three; and
     each on a 10-member 14400 x 9600, k = 8 ensemble (f32, and K1, K2a,
     K2b and K3 on its bf16 copy, the NMFk ensemble under
     ``--a_precision=bfloat16``);
     K2b on one member of it (the NMFk refit's shape); the two-read floor
     beside each K1 row and each K3 row on a bf16 or uint8 A, and beside
     each K3 row the time of K2a + K2b on the same inputs (the unfused pair
     that does K3's four products); the ptxas registers and spills of K1's,
     K2's, K3's and K4's kernels (no spill allowed);
   - K4 in its four modes (rows/columns, plain/ratio) at the shape and nnz
     of the NYTimes bag-of-words corpus (300000 x 102660, 69.7 M nnz,
     k = 32), and on a 10-member stack of the planted topic matrix of 5 at
     k = 3 and 7 (library call: ``torch.bmm`` of a sparse COO stack);
   profiles one batched FRO-MU and KL-MU step on that stack (wall and
   device ms, idle share, top kernels); and checks NMF.fit on the card
   against the CPU path on a small input;
3. the dense main path, launch counters at zero before each run and read
   after it: NMF.fit for 10 iterations at 57600 x 38400, k = 32, of FRO-MU
   and KL-MU (f32), of both on the uint8-quantized A, of FRO-MU on a bf16
   A, and of KL-MU with ``use_fused=True`` (K3) on an f32, a uint8 and a
   bf16 A; then the NMFk sweep through the CLI on a planted rank-4 14400 x
   9600 matrix (k = 2..7, 10 perturbations, 400 iterations), FRO-MU and
   KL-MU, and FRO-MU with ``--a_precision=bfloat16``, which must choose
   k = 4; the same KL-MU sweep through the library with ``use_fused=True``,
   on f32 and on bf16 members, whose ensemble must launch only K3 (for the
   members' dtype) and whose refit only K2b; and one FRO-MU factorization
   of that matrix through the CLI with and without ``--a_precision=uint8``;
4. the sparse main path, the same way: NMF.fit on the NYTimes-shaped matrix,
   10 FRO-MU and 10 KL-MU iterations, k = 32, on the ELL format the policy
   must choose;
5. the sparse NMFk sweep through the CLI on a planted rank-4 block-sparse
   200000 x 50000 ``.npz`` (about 50 nnz per row, 10 M nnz; the same sweep
   settings), FRO-MU and KL-MU, which must choose k = 4 on the ELL format;
6. prints the card's name and power limit, one JSON line of kernels, and as
   its last line ``{"ok": true, "device": {...}}``.

Any failed check raises, so the script exits non-zero and prints no result.
It also exits non-zero when there is no CUDA device or no package beside it.
"""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
M, N, K = 57600, 38400, 32               # reference strong-scaling geometry
ENS, EM, EN, EK = 10, 14400, 9600, 8     # ensemble kernel check
PLANTED = dict(m=14400, n=9600, k=4)     # NMFk sweep input
SWEEP = ["--start_k=2", "--end_k=7", "--perturbations=10", "--itr=400"]
# NYTimes bag of words (UCI Machine Learning Repository, "Bag of Words"):
# documents x vocabulary and nnz; drawn with replacement, ~79 k repeats drop
NYT_M, NYT_N, NYT_NNZ = 300_000, 102_660, 69_679_427
TOPIC = dict(m=200_000, n=50_000, k=4, nnz_per_row=50)   # sparse sweep input
TOPIC_K = 7                              # K4 stack check: the sweep's top k
PROFILE_STEPS = 20                       # MU steps profiled on that stack
# kernel vs plain, max |difference| / max |plain| over all outputs: f32
# sums taken in another order (and, for K1's W'^T A and K3's W'^T U', with
# atomics in an order that changes from run to run); a bf16 or uint8 A also
# rounds factor operands (and K3's ratios) to bf16 where kernel and plain
# values may differ in the last f32 bit
TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-3, torch.uint8: 1e-3}
ITR = 10                                 # MU iterations of the NMF.fit runs
CLI_ITR = 100    # the CLI factorization: the uint8 error floor stays below
PEAK_FLOPS, PEAK_BYTES = 67e12, 3.35e12  # H100 SXM: f32 non-tensor, HBM3
PEAK_BF16 = 989e12                       # H100 SXM: bf16 tensor cores, dense


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def median_ms(fn, reps=7):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        torch.cuda.synchronize()
        times.append(t0.elapsed_time(t1))
    return float(np.median(times))


def compare(kernel_out, plain_out):
    """(max abs error, max relative error) over matching outputs."""
    if isinstance(kernel_out, torch.Tensor):
        kernel_out, plain_out = (kernel_out,), (plain_out,)
    abs_err = rel_err = 0.0
    for a, b in zip(kernel_out, plain_out):
        check(a.shape == b.shape, f"shape {tuple(a.shape)} != {tuple(b.shape)}")
        check(bool(torch.isfinite(a).all()), "non-finite kernel output")
        d = float((a.double() - b.double()).abs().max())
        abs_err = max(abs_err, d)
        rel_err = max(rel_err, d / max(float(b.double().abs().max()), 1e-30))
    return abs_err, rel_err


def bound(flops, nbytes, peak=PEAK_FLOPS):
    """(least ms the card could take, what bounds it): the larger of the
    operations over the peak of their type (f32 unless given) and the bytes
    over the memory rate."""
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


MANGLED_A = {None: "f32", "f": "f32", "h": "uint8", "13__nv_bfloat16": "bf16"}


def ptxas(log, entry, key):
    """{key(match): (registers, spill store bytes, spill load bytes)} of
    the kernels whose mangled names the regex ``entry`` matches, from the
    ptxas report (``-Xptxas -v``) kept beside the library."""
    out, cur, spill = {}, None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '\S*" + entry, line)
        if m:
            cur, spill = key(m), (0, 0)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and cur:
            spill = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur:
            out[cur] = (int(m.group(1)), *spill)
            cur = None
    return out


def ptxas_k1(log):
    """K1's two kernels (the f32 one; the tensor-core one for a bf16 or
    uint8 A), keyed (A dtype, KP, vec)."""
    return ptxas(log, r"fused_mu_fro_(?:f32|tc)_kernelI(13__nv_bfloat16|h)?"
                      r"Li(\d+)ELb([01])E",
                 lambda m: (MANGLED_A[m.group(1)], int(m.group(2)),
                            m.group(3) == "1"))


def ptxas_k2(log):
    """K2's kernels: the register kernels (KP <= 32), the first port's
    (KP >= 64) and the split reduction, keyed (kernel, A dtype, KP, vec)."""
    return ptxas(log, r"(kl_\w+?_kernel)(?:I(f|13__nv_bfloat16|h)Li(\d+)E"
                      r"(?:Lb([01])E)?)?",
                 lambda m: (m.group(1), MANGLED_A[m.group(2)],
                            int(m.group(3) or 0), m.group(4) == "1"))


def ptxas_k4(log):
    """K4's kernels: the grouped kernel (k <= 32) keyed (kernel, values
    dtype, KP, member group, ratio, False), the first port's (k > 32) keyed
    (kernel, dtype, KP, 0, ratio, vec), and the table's interleave."""
    return ptxas(log, r"(grouped_kernel|ell_gather_kernel|interleave_kernel)"
                      r"(?:I(f|13__nv_bfloat16)Li(\d+)E(?:Li(\d+)E)?Lb([01])E"
                      r"(?:Lb([01])E)?)?",
                 lambda m: (m.group(1), MANGLED_A[m.group(2)],
                            int(m.group(3) or 0), int(m.group(4) or 0),
                            m.group(5) == "1", m.group(6) == "1"))


def ptxas_k3(log):
    """K3's kernels: the f32 kernel and the tensor-core one for a bf16 or
    uint8 A (k <= 32) keyed (kernel, A dtype, KP, vec), the first port's
    (k > 32) keyed (kernel, A dtype, KP, False)."""
    return ptxas(log, r"(fused_mu_kl_f32_kernel|fused_mu_kl_tc_kernel|"
                      r"fused_mu_kl_kernel)"
                      r"I(f|13__nv_bfloat16|h)?Li(\d+)E(?:Lb([01])E)?",
                 lambda m: (m.group(1), MANGLED_A[m.group(2)],
                            int(m.group(3)), m.group(4) == "1"))


def coo_stack(rows, cols, data, shape):
    """A (B, m, n) sparse COO tensor of the B members ``data`` (B, nnz) over
    one pattern, for the library call that chip_smoke times beside K4 on a
    member stack; the port never calls it."""
    B, nnz = data.shape
    member = torch.arange(B, device=data.device).repeat_interleave(nnz)
    ind = torch.stack([member, rows.long().repeat(B), cols.long().repeat(B)])
    return torch.sparse_coo_tensor(ind, data.reshape(-1), (B, *shape),
                                   check_invariants=False).coalesce()


def csr(rows, cols, vals, shape):
    """A CSR tensor of the triplet (rows, cols, vals), for the library
    call that chip_smoke times beside K4; the port never calls it."""
    order = torch.argsort(rows.long() * shape[1] + cols.long())
    crow = torch.zeros(shape[0] + 1, dtype=torch.int64, device=rows.device)
    crow[1:] = torch.cumsum(torch.bincount(rows.long(), minlength=shape[0]), 0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)     # CSR is "beta"
        return torch.sparse_csr_tensor(crow, cols[order].long(), vals[order],
                                       shape, check_invariants=False)


def profile_step(norm, E, W, H, eps):
    """One batched MU step on the member stack E, W, H: its wall time (host
    clock, synchronized, profiler off), its device time (the sum of the
    CUDA kernels' own times under torch.profiler), the device's idle share,
    and the kernels that take the most device time."""
    from pydnmfk_tpu_torch.models import updates
    step = updates.mu_fro_step if norm == "fro" else updates.mu_kl_step
    for _ in range(3):                                   # warm-up
        W, H = step(E, W, H, eps)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(PROFILE_STEPS):
        W, H = step(E, W, H, eps)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / PROFILE_STEPS * 1e3
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(PROFILE_STEPS):
            W, H = step(E, W, H, eps)
        torch.cuda.synchronize()
    # the kernels themselves (an operator's row repeats its kernels' time)
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_ms = (sum(e.self_device_time_total for e in kernels)
              / PROFILE_STEPS / 1e3)
    print(f"[profile] {norm.upper()}-MU step, {W.shape[0]} members x "
          f"{E.shape[0]}x{E.shape[1]} ({E.nse} nnz) k={W.shape[-1]}: wall "
          f"{wall_ms:.3f} ms, device {dev_ms:.3f} ms, idle share "
          f"{1 - dev_ms / wall_ms:.3f}", flush=True)
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"  {e.self_device_time_total / PROFILE_STEPS / 1e3:9.3f} ms "
              f"{e.count / PROFILE_STEPS:6.1f}/step  {e.key[:90]}", flush=True)
    # a device time above the wall time is a count taken twice
    check(dev_ms <= 1.1 * wall_ms, f"profile {norm}: device {dev_ms:.3f} ms "
                                   f"above wall {wall_ms:.3f} ms")


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device")
    sys.path.insert(0, ROOT)
    from pydnmfk_tpu_torch import NMF, NMFConfig, NMFk, NMFkConfig, cli
    from pydnmfk_tpu_torch.models.nmf import init_factors_rand
    from pydnmfk_tpu_torch.ops import (cuda_lib, ell, ell_gather, fused_kl,
                                       fused_mu, kl, linalg, sparse)
    from pydnmfk_tpu_torch.utils import timing
    from pydnmfk_tpu_torch.utils.data_generator import (generate_data,
                                                        generate_topic_sparse)
    from pydnmfk_tpu_torch.utils.io import RESULT_DATASETS, read_cluster_results

    torch.backends.cuda.matmul.allow_tf32 = False     # true-f32 products
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}, {smi}", flush=True)
    counters = (fused_mu.launches, kl.launches, fused_kl.launches,
                ell_gather.launches)

    def counts():
        return {k: v for c in counters for k, v in c.items()}

    def zero_counts():
        for c in counters:
            for key in c:
                c[key] = 0

    main_path = {key: 0 for key in counts()}     # launches on the main path

    def read_counts():
        ran = counts()
        for key, n in ran.items():
            main_path[key] += n
        return ran

    # -- 1. build -------------------------------------------------------
    t0 = time.perf_counter()
    libs = cuda_lib.build_all()
    print(f"[build] {len(libs)} kernel libraries with nvcc for sm_90a in "
          f"{time.perf_counter() - t0:.1f} s: "
          + ", ".join(os.path.relpath(p, ROOT) for p in libs), flush=True)

    # -- 2. kernels against their plain versions ------------------------
    gen = torch.Generator(dev)
    gen.manual_seed(2024)
    eps = float(torch.finfo(torch.float32).eps)
    rows = {}
    case_ms = {}     # kernel ms of every case, by (kernel, label)

    def kernel_case(name, label, kernel, plain, tol, work, library=None):
        """Checks kernel() against plain() and times both (and library(),
        the one PyTorch call that computes the same function); ``work`` is
        the (flops, bytes[, peak]) the function needs. The first case of a
        kernel is its headline in the JSON line."""
        k_out, p_out = kernel(), plain()
        abs_err, rel_err = compare(k_out, p_out)
        del k_out, p_out
        ms, plain_ms = median_ms(kernel), median_ms(plain)
        lib_ms = median_ms(library) if library is not None else None
        bound_ms, bound_by = bound(*work)
        print(f"[kernel] {name} {label}: max rel err {rel_err:.3e} "
              f"(tol {tol:g}), max abs err {abs_err:.3e}, kernel "
              f"{ms:.3f} ms, plain {plain_ms:.3f} ms, library "
              f"{'none' if lib_ms is None else f'{lib_ms:.3f} ms'}, bound "
              f"{bound_ms:.3f} ms ({bound_by})", flush=True)
        check(rel_err <= tol, f"{name} {label} disagrees with its plain "
                              f"version: {rel_err:.3e} > {tol:g}")
        row = rows.setdefault(name, {"max_abs_err": 0.0, "ms": ms,
                                     "plain_ms": plain_ms,
                                     "bound_ms": bound_ms,
                                     "bound_by": bound_by,
                                     "library_ms": lib_ms})
        row["max_abs_err"] = max(row["max_abs_err"], abs_err)
        case_ms[name, label] = ms
        return ms

    # K1's kernels as ptxas built them: registers and spills of each
    # instantiation (f32; tensor cores for bf16 and uint8; KP = k padded to
    # 8, 16, 32, 64; vec: 16-byte loads or copies)
    regs = ptxas_k1(cuda_lib.library_path("fused_mu_fro").with_suffix(
        ".log").read_text())
    for dtype in ("f32", "bf16", "uint8"):
        print(f"[ptxas] K1 {dtype}-A kernel (registers, spill store / load "
              f"bytes): " + ", ".join(
                  f"KP={kp}{' vec' if vec else ''} {r} registers, "
                  f"{ss}/{sl} B spilled"
                  for (dt, kp, vec), (r, ss, sl) in sorted(regs.items())
                  if dt == dtype), flush=True)
    check(len(regs) == 24 and not any(ss or sl for _, ss, sl in regs.values()),
          f"K1 kernels: ptxas report {regs} (expected 24 instantiations, no "
          f"spills)")

    # K2's kernels likewise: the register kernels (KP = 8, 16, 32; vec:
    # 16-byte loads), the first port's (KP = 64, 128, 256) and K2b's split
    # reduction
    regs = ptxas_k2(cuda_lib.library_path("kl_ratio").with_suffix(
        ".log").read_text())
    for name in sorted({key[0] for key in regs}):
        print(f"[ptxas] K2 {name} (registers, spill store / load bytes): "
              + ", ".join(f"{dt} KP={kp}{' vec' if vec else ''} {r} "
                          f"registers, {ss}/{sl} B spilled"
                          for (nm, dt, kp, vec), (r, ss, sl)
                          in sorted(regs.items()) if nm == name), flush=True)
    check(len(regs) == 55 and not any(ss or sl for _, ss, sl in regs.values()),
          f"K2 kernels: ptxas report {regs} (expected 55 instantiations, no "
          f"spills)")

    # K4's kernels likewise: the grouped kernel (KP = 4, 8, 16, 32 at every
    # member group it takes) and the first port's (KP = 64, 128, 256; vec:
    # 16-byte loads), plain and ratio, f32 and bf16 values, and the
    # interleave of the grouped kernel's table
    regs = ptxas_k4(cuda_lib.library_path("ell_gather").with_suffix(
        ".log").read_text())
    for name in sorted({key[0] for key in regs}):
        print(f"[ptxas] K4 {name} (registers, spill store / load bytes): "
              + ", ".join(f"{dt}{f' KP={kp}' if kp else ''}{f' G={g}' if g else ''}"
                          f"{' ratio' if ratio else ''}{' vec' if vec else ''} "
                          f"{r} registers, {ss}/{sl} B spilled"
                          for (nm, dt, kp, g, ratio, vec), (r, ss, sl)
                          in sorted(regs.items()) if nm == name), flush=True)
    check(len(regs) == 85 and not any(ss or sl for _, ss, sl in regs.values()),
          f"K4 kernels: ptxas report {regs} (expected 85 kernels, no spills)")

    # K3's kernels likewise: the f32 kernel and the tensor-core one for a
    # bf16 or uint8 A (KP = 8, 16, 32; vec: 16-byte loads or copies) and the
    # first port's (every A dtype at KP = 64)
    regs = ptxas_k3(cuda_lib.library_path("fused_mu_kl").with_suffix(
        ".log").read_text())
    for name in sorted({key[0] for key in regs}):
        print(f"[ptxas] K3 {name} (registers, spill store / load bytes): "
              + ", ".join(f"{dt} KP={kp}{' vec' if vec else ''} {r} "
                          f"registers, {ss}/{sl} B spilled"
                          for (nm, dt, kp, vec), (r, ss, sl)
                          in sorted(regs.items()) if nm == name), flush=True)
    check(len(regs) == 21 and not any(ss or sl for _, ss, sl in regs.values()),
          f"K3 kernels: ptxas report {regs} (expected 21 kernels, no spills)")

    def beside_pair(label):
        """K3 does the four products of K2a + K2b (its yardstick: no one
        PyTorch call computes K3's function): their times on the same
        inputs beside K3's, where this run timed them."""
        pair = [case_ms.get((kname, label)) for kname in ("K2a kl_uht",
                                                          "K2b kl_wtu")]
        k3 = case_ms["K3 fused_mu_kl", label]
        if None in pair:
            print(f"[kernel] K3 fused_mu_kl {label}: K2a + K2b not timed on "
                  f"this A", flush=True)
            return
        print(f"[kernel] K3 fused_mu_kl {label}: {k3:.3f} ms beside K2a + K2b "
              f"{pair[0]:.3f} + {pair[1]:.3f} = {sum(pair):.3f} ms (K3 / pair "
              f"{k3 / sum(pair):.3f})", flush=True)
        rows["K3 fused_mu_kl"].setdefault("k2a_plus_k2b_ms", sum(pair))

    def two_read_floor(label, a, name="K1 fused_mu_fro"):
        """K1 and K3 read A twice (sweep 2 needs all of A_i H^T, or of
        U_i H^T, first): that traffic alone over the memory rate, beside the
        function's bound."""
        ms = 2 * nbytes(a) / PEAK_BYTES * 1e3
        print(f"[kernel] {name} {label}: two-read floor {ms:.3f} ms (A read "
              f"twice at {PEAK_BYTES / 1e12:g} TB/s)", flush=True)

    A = torch.rand((M, K), generator=gen, device=dev) @ torch.rand(
        (K, N), generator=gen, device=dev)                     # planted rank K
    W = torch.rand((M, K), generator=gen, device=dev)
    H = torch.rand((K, N), generator=gen, device=dev)
    HHT = linalg.gram_t(H)
    shape = f"{M}x{N} k={K}"
    dense_ms = []
    dense_ms.append(kernel_case(
        "K1 fused_mu_fro", f"f32 {shape}",
        lambda: fused_mu.fused_w_pass(A, W, H, HHT, eps),
        lambda: fused_mu.fused_w_pass_plain(A, W, H, HHT, eps),
        TOL[torch.float32], (4 * M * N * K, nbytes(A, W, H, HHT, W, H, HHT)),
        library=lambda: (torch.matmul(A, H.mT), torch.matmul(W.mT, A))))
    two_read_floor(f"f32 {shape}", A)
    # a bf16 A: the same products on bf16 operands (the JAX package's
    # operand rounding), so the bf16 tensor-core peak bounds the operations;
    # the library call takes the factors cast to bf16 beforehand
    A16 = A.to(torch.bfloat16)
    W16, H16 = W.to(torch.bfloat16), H.to(torch.bfloat16)
    kernel_case("K1 fused_mu_fro", f"bf16-A {shape}",
                lambda: fused_mu.fused_w_pass(A16, W, H, HHT, eps),
                lambda: fused_mu.fused_w_pass_plain(A16, W, H, HHT, eps),
                TOL[torch.bfloat16],
                (4 * M * N * K, nbytes(A16, W, H, HHT, W, H, HHT), PEAK_BF16),
                library=lambda: (torch.matmul(A16, H16.mT),
                                 torch.matmul(W16.mT, A16)))
    two_read_floor(f"bf16-A {shape}", A16)
    chunk = linalg.error_chunk_rows(M, N)
    dense_ms.append(kernel_case(
        "K2a kl_uht", f"f32 {shape}", lambda: kl.kl_uht(A, W, H, eps),
        lambda: kl.kl_uht_plain(A, W, H, eps, chunk), TOL[torch.float32],
        (4 * M * N * K, nbytes(A, W, H, W))))
    dense_ms.append(kernel_case(
        "K2b kl_wtu", f"f32 {shape}", lambda: kl.kl_wtu(A, W, H, eps),
        lambda: kl.kl_wtu_plain(A, W, H, eps, chunk), TOL[torch.float32],
        (4 * M * N * K, nbytes(A, W, H, H))))
    # K2 on the bf16 A, K3's yardstick there: the A dtype changes only the
    # load, and K2 computes in f32 like its plain version (1e-4)
    kernel_case("K2a kl_uht", f"bf16-A {shape}",
                lambda: kl.kl_uht(A16, W, H, eps),
                lambda: kl.kl_uht_plain(A16, W, H, eps, chunk),
                TOL[torch.float32], (4 * M * N * K, nbytes(A16, W, H, W)))
    kernel_case("K2b kl_wtu", f"bf16-A {shape}",
                lambda: kl.kl_wtu(A16, W, H, eps),
                lambda: kl.kl_wtu_plain(A16, W, H, eps, chunk),
                TOL[torch.float32], (4 * M * N * K, nbytes(A16, W, H, H)))
    # the uint8 A that NMF.fit solves on: K1 rounds its factor operands to
    # bf16 (bf16 peak); K2 computes in f32 (f32 peak)
    Q, _ = linalg.quantize_uint8(A)
    # torch.matmul takes no uint8 on the card: the library call multiplies a
    # bf16 copy of Q (exact: every uint8 value is a bf16 value)
    Q16 = Q.to(torch.bfloat16)
    kernel_case("K1 fused_mu_fro", f"uint8-A {shape}",
                lambda: fused_mu.fused_w_pass(Q, W, H, HHT, eps),
                lambda: fused_mu.fused_w_pass_plain(Q, W, H, HHT, eps),
                TOL[torch.uint8],
                (4 * M * N * K, nbytes(Q, W, H, HHT, W, H, HHT), PEAK_BF16),
                library=lambda: (torch.matmul(Q16, H16.mT),
                                 torch.matmul(W16.mT, Q16)))
    two_read_floor(f"uint8-A {shape}", Q)
    del Q16
    kernel_case("K2a kl_uht", f"uint8-A {shape}",
                lambda: kl.kl_uht(Q, W, H, eps),
                lambda: kl.kl_uht_plain(Q, W, H, eps, chunk), TOL[torch.uint8],
                (4 * M * N * K, nbytes(Q, W, H, W)))
    kernel_case("K2b kl_wtu", f"uint8-A {shape}",
                lambda: kl.kl_wtu(Q, W, H, eps),
                lambda: kl.kl_wtu_plain(Q, W, H, eps, chunk), TOL[torch.uint8],
                (4 * M * N * K, nbytes(Q, W, H, H)))
    # K3 reads A once for 8 m n k operations: f32 on CUDA cores; bf16
    # operands for a bf16 or uint8 A (bf16 peak)
    hrs = linalg.sum_axis(H, axis=-1)
    for label, a, peak in (("f32", A, PEAK_FLOPS), ("bf16-A", A16, PEAK_BF16),
                           ("uint8-A", Q, PEAK_BF16)):
        kernel_case("K3 fused_mu_kl", f"{label} {shape}",
                    lambda: fused_kl.fused_kl_pass(a, W, H, hrs, eps),
                    lambda: fused_kl.fused_kl_pass_plain(a, W, H, hrs, eps,
                                                         chunk),
                    TOL[a.dtype],
                    (8 * M * N * K, nbytes(a, W, H, hrs, W, H), peak))
        beside_pair(f"{label} {shape}")
        if a.dtype != torch.float32:
            two_read_floor(f"{label} {shape}", a, "K3 fused_mu_kl")
    del A16, W16, H16, Q, W, H, HHT, hrs
    torch.cuda.empty_cache()
    Ae = torch.rand((ENS, EM, EN), generator=gen, device=dev)
    We = torch.rand((ENS, EM, EK), generator=gen, device=dev)
    He = torch.rand((ENS, EK, EN), generator=gen, device=dev)
    HHTe = linalg.gram_t(He)
    eshape = f"{ENS} x {EM}x{EN} k={EK}"
    ework = 4 * ENS * EM * EN * EK
    kernel_case("K1 fused_mu_fro", f"f32 {eshape}",
                lambda: fused_mu.fused_w_pass(Ae, We, He, HHTe, eps),
                lambda: fused_mu.fused_w_pass_plain(Ae, We, He, HHTe, eps),
                TOL[torch.float32],
                (ework, nbytes(Ae, We, He, HHTe, We, He, HHTe)),
                library=lambda: (torch.matmul(Ae, He.mT),
                                 torch.matmul(We.mT, Ae)))
    two_read_floor(f"f32 {eshape}", Ae)
    # the members of the NMFk ensemble under --a_precision=bfloat16
    Ae16 = Ae.to(torch.bfloat16)
    We16, He16 = We.to(torch.bfloat16), He.to(torch.bfloat16)
    kernel_case("K1 fused_mu_fro", f"bf16-A {eshape}",
                lambda: fused_mu.fused_w_pass(Ae16, We, He, HHTe, eps),
                lambda: fused_mu.fused_w_pass_plain(Ae16, We, He, HHTe, eps),
                TOL[torch.bfloat16],
                (ework, nbytes(Ae16, We, He, HHTe, We, He, HHTe), PEAK_BF16),
                library=lambda: (torch.matmul(Ae16, He16.mT),
                                 torch.matmul(We16.mT, Ae16)))
    two_read_floor(f"bf16-A {eshape}", Ae16)
    del We16, He16
    ech = linalg.error_chunk_rows(EM, EN)
    # K2 on the bf16 members: the A dtype changes only the load, and K2
    # computes in f32 like its plain version (1e-4)
    kernel_case("K2a kl_uht", f"bf16-A {eshape}",
                lambda: kl.kl_uht(Ae16, We, He, eps),
                lambda: kl.kl_uht_plain(Ae16, We, He, eps, ech),
                TOL[torch.float32], (ework, nbytes(Ae16, We, He, We)))
    kernel_case("K2b kl_wtu", f"bf16-A {eshape}",
                lambda: kl.kl_wtu(Ae16, We, He, eps),
                lambda: kl.kl_wtu_plain(Ae16, We, He, eps, ech),
                TOL[torch.float32], (ework, nbytes(Ae16, We, He, He)))
    # K3 on the bf16 members (NMFk with use_fused=True under
    # --a_precision=bfloat16): bf16 operands, so the bf16 peak
    hrse = linalg.sum_axis(He, axis=-1)
    kernel_case("K3 fused_mu_kl", f"bf16-A {eshape}",
                lambda: fused_kl.fused_kl_pass(Ae16, We, He, hrse, eps),
                lambda: fused_kl.fused_kl_pass_plain(Ae16, We, He, hrse, eps,
                                                     ech),
                TOL[torch.bfloat16],
                (2 * ework, nbytes(Ae16, We, He, hrse, We, He), PEAK_BF16))
    beside_pair(f"bf16-A {eshape}")
    two_read_floor(f"bf16-A {eshape}", Ae16, "K3 fused_mu_kl")
    del Ae16
    kernel_case("K2a kl_uht", f"f32 {eshape}",
                lambda: kl.kl_uht(Ae, We, He, eps),
                lambda: kl.kl_uht_plain(Ae, We, He, eps, ech),
                TOL[torch.float32], (ework, nbytes(Ae, We, He, We)))
    kernel_case("K2b kl_wtu", f"f32 {eshape}",
                lambda: kl.kl_wtu(Ae, We, He, eps),
                lambda: kl.kl_wtu_plain(Ae, We, He, eps, ech),
                TOL[torch.float32], (ework, nbytes(Ae, We, He, He)))
    # the NMFk refit's W-frozen solve: K2b on one member (its rows split)
    A1, W1, H1 = Ae[0], We[0], He[0]
    kernel_case("K2b kl_wtu", f"f32 refit {EM}x{EN} k={EK}",
                lambda: kl.kl_wtu(A1, W1, H1, eps),
                lambda: kl.kl_wtu_plain(A1, W1, H1, eps, ech),
                TOL[torch.float32],
                (4 * EM * EN * EK, nbytes(A1, W1, H1, H1)))
    del A1, W1, H1
    kernel_case("K3 fused_mu_kl", f"f32 {eshape}",
                lambda: fused_kl.fused_kl_pass(Ae, We, He, hrse, eps),
                lambda: fused_kl.fused_kl_pass_plain(Ae, We, He, hrse, eps,
                                                     ech),
                TOL[torch.float32],
                (2 * ework, nbytes(Ae, We, He, hrse, We, He)))
    beside_pair(f"f32 {eshape}")
    del Ae, We, He, HHTe, hrse
    torch.cuda.empty_cache()

    # K4 at the NYTimes shape: flat positions drawn uniformly with
    # replacement, repeats dropped by unique; positive counts-like values
    # (geometric, from 1 - U in (0, 1]: torch.rand can return 0)
    t0 = time.perf_counter()
    flat = torch.unique(torch.randint(0, NYT_M * NYT_N, (NYT_NNZ,),
                                      generator=gen, device=dev))
    vals = torch.floor(-2.0 * torch.log1p(-torch.rand(
        flat.shape, generator=gen, device=dev))) + 1.0
    nyt = sparse.SparseTriplet(vals, (flat // NYT_N).to(torch.int32),
                               (flat % NYT_N).to(torch.int32), (NYT_M, NYT_N))
    del flat, vals
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    E = ell.ell_pack(nyt)
    torch.cuda.synchronize()
    check(E is not None, "the NYTimes-shaped matrix does not ELL-pack")
    print(f"[sparse] NYTimes-shaped {NYT_M}x{NYT_N}: {nyt.nse} nnz "
          f"({NYT_NNZ - nyt.nse} repeats dropped), drawn in {t1 - t0:.2f} s; "
          f"ell_pack on the card {time.perf_counter() - t1:.2f} s: widths "
          f"{E.rvals.shape[1]} (rows) / {E.cvals.shape[1]} (columns), tails "
          f"{E.rtail_d.numel()} / {E.ctail_d.numel()}", flush=True)

    def k4_cases(tag, E, W, H, library):
        """K4's four modes on the ELL E with factors W (.., m, k), H
        (.., k, n); ``library(Ht, W)`` gives the library calls of the two
        plain modes. Returns the kernel ms of the two plain modes and the
        nonzeros each orientation's ELL holds."""
        Ht = H.mT.contiguous()
        nz_r = E.nse - E.rtail_d.shape[-1]
        nz_c = E.nse - E.ctail_d.shape[-1]
        k = W.shape[-1]
        lib_r, lib_c = library(Ht, W)
        cases = (("rows plain", E.rvals, E.rcols, Ht, None, nz_r, lib_r),
                 ("columns plain", E.cvals, E.crows, W, None, nz_c, lib_c),
                 ("rows ratio", E.rvals, E.rcols, Ht, W, nz_r, None),
                 ("columns ratio", E.cvals, E.crows, W, Ht, nz_c, None))
        out = []
        for label, v, i, T, X, nz, lib in cases:
            # the work of the function, over the nonzeros that the ELL holds
            # (the padding slots are the format's cost, not the product's):
            # each member's values and the shared indices read once, the
            # tables (and X) once, the output written once
            members = v.numel() // i.numel()
            flops = (2 if X is None else 4) * nz * k * members
            tables = nbytes(T) + (0 if X is None else nbytes(X))
            out_bytes = 4 * members * i.shape[0] * k
            work = (nz * (members * v.element_size() + i.element_size())
                    + tables + out_bytes)
            out.append(kernel_case(
                "K4 ell_gather", f"{label} {tag}",
                lambda: ell_gather.ell_gather_product(v, i, T, X, eps),
                lambda: ell_gather.ell_gather_product_plain(v, i, T, X, eps),
                TOL[torch.float32], (flops, work), lib))
        return out[:2], (nz_r, nz_c)

    Wn = torch.rand((NYT_M, K), generator=gen, device=dev)
    Hn = torch.rand((K, NYT_N), generator=gen, device=dev)
    A_r = csr(nyt.rows, nyt.cols, nyt.data, nyt.shape)
    A_c = csr(nyt.cols, nyt.rows, nyt.data, nyt.shape[::-1])
    k4_ms, k4_nz = k4_cases(
        f"{NYT_M}x{NYT_N} k={K} f32", E, Wn, Hn,
        lambda Ht, W: (lambda: torch.sparse.mm(A_r, Ht),
                       lambda: torch.sparse.mm(A_c, W)))
    del Wn, Hn, A_r, A_c
    torch.cuda.empty_cache()
    # the time model's constants (ops/ell.py), from this run's readings
    s_slot = sum(t / nz for t, nz in zip(k4_ms, k4_nz)) / 2e3
    s_elem = sum(dense_ms) / len(dense_ms) / (M * N) / 1e3
    print(f"[model] K4 {s_slot:.3e} s per nonzero at k={K} (ops/ell.py has "
          f"{ell.ELL_S_PER_SLOT:.3e}); K1/K2 {s_elem:.3e} s per element of A "
          f"at k={K} (ops/ell.py has {ell.DENSE_S_PER_ELEM:.3e})", flush=True)

    # K4 on a 10-member stack of the sparse sweep's planted topic matrix
    r, c, v, tshape = generate_topic_sparse(**TOPIC, seed=7)
    topic = sparse.from_coo(*(torch.from_numpy(x).to(dev) for x in (r, c, v)),
                            tshape)
    del r, c, v
    Et, *perms = ell.ell_pack(topic, return_perms=True)
    print(f"[sparse] topic {tshape[0]}x{tshape[1]}: {topic.nse} nnz, widths "
          f"{Et.rvals.shape[1]} (rows) / {Et.cvals.shape[1]} (columns), "
          f"tails {Et.rtail_d.numel()} / {Et.ctail_d.numel()}", flush=True)
    noise = 1.0 + 0.03 * torch.rand((ENS, topic.nse), generator=gen,
                                    device=dev)
    data = topic.data * noise
    stack = ell.ell_with_data(Et, *perms, data)
    # the library yardstick on the stack: torch.bmm of a 3-D sparse COO stack
    # (the members' A with their tails) against the table
    S_r = coo_stack(topic.rows, topic.cols, data, tshape)
    S_c = coo_stack(topic.cols, topic.rows, data, tshape[::-1])
    stack_lib = lambda Ht, W: (lambda: torch.bmm(S_r, Ht),
                               lambda: torch.bmm(S_c, W))
    # k = 3 (KP = 4, groups of 8) beside the sweep's top k = 7 (KP = 8)
    for k in (3, TOPIC_K):
        Ws = torch.rand((ENS, tshape[0], k), generator=gen, device=dev)
        Hs = torch.rand((ENS, k, tshape[1]), generator=gen, device=dev)
        k4_cases(f"{ENS} x {tshape[0]}x{tshape[1]} ({topic.nse} nnz) "
                 f"k={k} f32", stack, Ws, Hs, stack_lib)
    del S_r, S_c, data
    # where the time of one batched MU step of the sparse sweep goes
    for norm in ("fro", "kl"):
        profile_step(norm, stack, Ws, Hs, eps)
    del topic, Et, perms, noise, stack, Ws, Hs
    torch.cuda.empty_cache()

    # NMF.fit through the kernels against the CPU path, small planted input
    _, _, X = generate_data(m=300, n=200, k=5)
    rng = np.random.default_rng(0)
    W0, H0 = rng.random((300, 5)), rng.random((5, 200))
    for norm, kw in (("fro", {}), ("kl", {}), ("kl", {"use_fused": True})):
        cfg = NMFConfig(k=5, norm=norm, itr=50, **kw)
        Wg, Hg, eg = NMF(cfg, dev).fit(X, factors=(W0, H0))
        Wc, Hc, ec = NMF(cfg, "cpu").fit(X, factors=(W0, H0))
        _, rel_err = compare((Wg.cpu(), Hg.cpu()), (Wc, Hc))
        print(f"[check] NMF.fit {norm} {kw} 300x200 k=5, 50 iterations, card "
              f"vs CPU: max rel err {rel_err:.3e}, error {eg:.6f} vs "
              f"{ec:.6f}", flush=True)
        check(rel_err < 1e-3 and abs(eg - ec) < 1e-4 * ec,
              f"NMF.fit {norm} {kw} on the card disagrees with the CPU path")

    # -- 3. the dense main path, counters from zero ----------------------
    timing.enable(True)
    none = {key: 0 for key in counts()}
    g = torch.Generator(dev)
    g.manual_seed(NMFConfig().seed)
    W0, H0 = init_factors_rand(g, M, N, K, torch.float32, dev)
    init_err = float(linalg.relative_error(A, W0, H0, chunk))
    del W0, H0
    errs = {}
    # (label, norm, config options, the launches it must make)
    for label, norm, kw, want in (
            ("FRO-MU f32", "fro", {}, {"fused_mu_fro": ITR}),
            ("KL-MU f32", "kl", {}, {"kl_uht": ITR, "kl_wtu": ITR}),
            ("FRO-MU uint8-A", "fro", {"a_precision": "uint8"},
             {"fused_mu_fro_u8": ITR}),
            ("FRO-MU bf16-A", "fro", {"a_precision": "bfloat16"},
             {"fused_mu_fro_bf16": ITR}),
            ("KL-MU uint8-A", "kl", {"a_precision": "uint8"},
             {"kl_uht": ITR, "kl_wtu": ITR}),
            ("KL-MU f32 use_fused", "kl", {"use_fused": True},
             {"fused_mu_kl": ITR}),
            ("KL-MU uint8-A use_fused", "kl",
             {"a_precision": "uint8", "use_fused": True},
             {"fused_mu_kl_u8": ITR}),
            ("KL-MU bf16-A use_fused", "kl",
             {"a_precision": "bfloat16", "use_fused": True},
             {"fused_mu_kl_bf16": ITR})):
        cfg = NMFConfig(k=K, norm=norm, itr=ITR, **kw)
        timing.reset()
        zero_counts()
        t0 = time.perf_counter()
        W, H, err = NMF(cfg, dev).fit(A)          # same seed: same init
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        ran = read_counts()
        solve_s = timing.TIMINGS["solve"]
        print(f"[nmf] {label} {M}x{N} k={K}, {ITR} iterations: fit "
              f"{secs:.3f} s, solve {solve_s:.3f} s ({ITR / solve_s:.2f} "
              f"it/s incl. final error), relative error {init_err:.6f} "
              f"(rand init) -> {err:.6f}, launches {ran}", flush=True)
        check(np.isfinite(err) and err < init_err,
              f"NMF.fit {label}: error {err} not below the init's {init_err}")
        check(W.shape == (M, K) and H.shape == (K, N), "factor shapes")
        check(ran == {**none, **want},
              f"NMF.fit {label} launches {ran}, expected {want}")
        errs[label] = err
        del W, H
    # the quantized and the bf16 solves track the f32 one; K3 and K2 differ
    # in summation order only at f32; on a uint8 or bf16 A, K3 rounds U and
    # U' to bf16 where K2 does not, and is held to the K2 solve on the same
    # A dtype (the uint8 one; K2 widens a bf16 A, so the f32 one) as the
    # FRO narrow-A solves are
    for label, ref, tol in (("FRO-MU uint8-A", "FRO-MU f32", 0.02),
                            ("FRO-MU bf16-A", "FRO-MU f32", 0.02),
                            ("KL-MU f32 use_fused", "KL-MU f32", 1e-3),
                            ("KL-MU uint8-A use_fused", "KL-MU uint8-A", 0.02),
                            ("KL-MU bf16-A use_fused", "KL-MU f32", 0.02)):
        rel = abs(errs[label] / errs[ref] - 1)
        print(f"[check] {label} error {errs[label]:.6f} vs {ref} "
              f"{errs[ref]:.6f}: relative difference {rel:.2e} (limit "
              f"{tol:g})", flush=True)
        check(rel <= tol, f"{label} error {errs[label]} is not within "
                          f"{tol:g} of {ref}'s {errs[ref]}")
    del A
    torch.cuda.empty_cache()

    def sweep(tmp, ftype, fname, norm, expect, shape, a_precision=None):
        """The NMFk sweep through the CLI entry point, counters from zero;
        checks nopt = 4, every k's results, and that the kernels of
        ``expect`` (and no other) launched."""
        timing.reset()
        res_path = os.path.join(tmp, f"res_{fname}_{norm}_{a_precision}") + "/"
        extra = [f"--a_precision={a_precision}"] if a_precision else []
        zero_counts()
        t0 = time.perf_counter()
        out = cli.main(["--process=pyDNMFk", "--p_r=1", "--p_c=1",
                        f"--ftype={ftype}", f"--fpath={tmp}/",
                        f"--fname={fname}", f"--norm={norm}",
                        f"--results_path={res_path}", "--timing_stats=true",
                        *SWEEP, *extra])
        secs = time.perf_counter() - t0
        ran = read_counts()
        stages = {s: round(timing.TIMINGS.get(s, 0.0), 3) for s in
                  ("read", "sparse_format", "ensemble_solve", "clustering",
                   "regression")}
        print(f"[nmfk] {norm.upper()}-MU {ftype} {shape[0]}x{shape[1]} "
              f"{' '.join(SWEEP + extra)}: nopt {out['nopt']}, {secs:.2f} s, stage "
              f"seconds {stages}, launches {ran}", flush=True)
        check(out["nopt"] == 4, f"NMFk {norm} {ftype} chose k={out['nopt']}, "
                                f"not 4")
        for k in range(2, 8):
            res = read_cluster_results(os.path.join(res_path, fname, str(k)))
            check(set(res) == set(RESULT_DATASETS), f"k={k} datasets")
            check(res["clusterSilhouetteCoefficients"].shape == (k,)
                  and res["L_err"].shape == (shape[1],)
                  and res["ErrTol"].shape == (10,)
                  and all(np.isfinite(v).all() for v in res.values()),
                  f"NMFk {norm} {ftype} k={k} results")
        check(all(ran[key] > 0 for key in expect)
              and not any(ran[key] for key in ran if key not in expect),
              f"NMFk {norm} {ftype} launched {ran}, expected {expect} only")

    def fused_sweep(tmp, a_precision="float32", key="fused_mu_kl"):
        """The dense KL NMFk sweep through the library with use_fused=True
        (the same settings as the CLI sweeps), its members stored at
        ``a_precision``: nopt = 4, every k's results, and exact launches by
        stage: the ensemble only K3 under ``key`` (one launch per iteration
        and k, the members in one stack), the W-frozen refit only K2b."""
        ks = range(2, 8)
        res = os.path.join(tmp, f"res_fused_{a_precision}")
        cfg = NMFkConfig(nmf=NMFConfig(norm="kl", itr=400, use_fused=True,
                                       a_precision=a_precision),
                         start_k=ks[0], end_k=ks[-1], perturbations=10,
                         results_path=res + "/", fname="X", checkpoint=False)
        ens = dict(none)

        class Staged(NMFk):
            def _solve_ensemble(self, *args, **kw):
                before = counts()
                out = super()._solve_ensemble(*args, **kw)
                for key, n in counts().items():
                    ens[key] += n - before[key]
                return out

        A_np = np.load(os.path.join(tmp, "X.npy"))
        timing.reset()
        zero_counts()
        t0 = time.perf_counter()
        nopt = Staged(cfg, dev).fit(A_np)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        ran = read_counts()
        refit = {key: ran[key] - ens[key] for key in ran}
        stages = {st: round(timing.TIMINGS.get(st, 0.0), 3) for st in
                  ("ensemble_solve", "clustering", "regression")}
        print(f"[nmfk] KL-MU use_fused (library) npy {A_np.shape[0]}x"
              f"{A_np.shape[1]} a_precision={a_precision} k=2..7, 10 "
              f"perturbations, 400 iterations: nopt {nopt}, {secs:.2f} s, "
              f"stage seconds {stages}, launches: ensemble {ens}, refit "
              f"{refit}", flush=True)
        check(nopt == 4, f"NMFk KL use_fused {a_precision} chose k={nopt}, "
                         f"not 4")
        for k in ks:
            out = read_cluster_results(os.path.join(res, "X", str(k)))
            check(set(out) == set(RESULT_DATASETS)
                  and out["clusterSilhouetteCoefficients"].shape == (k,)
                  and all(np.isfinite(v).all() for v in out.values()),
                  f"NMFk KL use_fused {a_precision} k={k} results")
        itr = len(ks) * cfg.nmf.itr
        check(ens == {**none, key: itr} and refit == {**none, "kl_wtu": itr},
              f"NMFk KL use_fused {a_precision} launched {ens} (ensemble) and "
              f"{refit} (refit); expected {key} {itr} and kl_wtu {itr} only")

    _, _, X = generate_data(**PLANTED)
    with tempfile.TemporaryDirectory() as tmp:
        np.save(os.path.join(tmp, "X.npy"), X.astype(np.float32))
        del X
        sweep(tmp, "npy", "X", "fro", ("fused_mu_fro",),
              (PLANTED["m"], PLANTED["n"]))
        sweep(tmp, "npy", "X", "kl", ("kl_uht", "kl_wtu"),
              (PLANTED["m"], PLANTED["n"]))
        # the ensemble on bf16 members: K1's tensor-core kernel
        sweep(tmp, "npy", "X", "fro", ("fused_mu_fro_bf16",),
              (PLANTED["m"], PLANTED["n"]), a_precision="bfloat16")
        fused_sweep(tmp)
        # the ensemble on bf16 members: K3's tensor-core kernel
        fused_sweep(tmp, "bfloat16", "fused_mu_kl_bf16")
        # one FRO factorization through the CLI, on the uint8-quantized A
        # (K1's uint8 instantiation) and on the f32 A (K1)
        cli_err = {}
        for a_prec, key in (("uint8", "fused_mu_fro_u8"),
                            (None, "fused_mu_fro")):
            zero_counts()
            t0 = time.perf_counter()
            out = cli.main(["--process=pyDNMF", "--p_r=1", "--p_c=1",
                            "--ftype=npy", f"--fpath={tmp}/", "--fname=X",
                            "--norm=fro", "--k=4", f"--itr={CLI_ITR}",
                            f"--results_path={tmp}/res_pydnmf/",
                            "--timing_stats=true"]
                           + ([f"--a_precision={a_prec}"] if a_prec else []))
            secs = time.perf_counter() - t0
            ran = read_counts()
            cli_err[a_prec] = out["err"]
            print(f"[cli] pyDNMF FRO-MU k=4 {CLI_ITR} iterations, "
                  f"a_precision={a_prec}: relative error {out['err']:.6f}, "
                  f"{secs:.2f} s, launches {ran}", flush=True)
            check(ran == {**none, key: CLI_ITR},
                  f"CLI a_precision={a_prec} launched {ran}")
            check(out["H"].shape == (4, PLANTED["n"])
                  and bool(torch.isfinite(out["H"]).all()), "CLI factors")
        rel = abs(cli_err["uint8"] / cli_err[None] - 1)
        check(rel <= 0.02, f"CLI uint8 error {cli_err['uint8']} is not "
                           f"within 2 % of {cli_err[None]}")

    # -- 4. the sparse main path: NMF.fit at the NYTimes shape ------------
    for norm in ("fro", "kl"):
        cfg = NMFConfig(k=K, norm=norm, itr=10)
        g = torch.Generator(dev)
        g.manual_seed(cfg.seed)
        W0, H0 = init_factors_rand(g, NYT_M, NYT_N, K, torch.float32, dev)
        init_err = float(linalg.relative_error(E, W0, H0))
        del W0, H0
        timing.reset()
        zero_counts()
        t0 = time.perf_counter()
        model = NMF(cfg, dev)
        W, H, err = model.fit(nyt)                # same seed: same init
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        ran = read_counts()
        solve_s = timing.TIMINGS["solve"]
        print(f"[nmf] {norm.upper()}-MU sparse {NYT_M}x{NYT_N} ({nyt.nse} "
              f"nnz) k={K} f32, 10 iterations: fit {secs:.3f} s (format "
              f"{timing.TIMINGS['sparse_format']:.3f} s), solve "
              f"{solve_s:.3f} s ({10 / solve_s:.2f} it/s incl. final "
              f"error), relative error {init_err:.6f} (rand init) -> "
              f"{err:.6f}, launches {ran}", flush=True)
        check(isinstance(model._A, ell.EllSparse),
              f"the format policy chose {type(model._A).__name__}, not ELL")
        check(np.isfinite(err) and err < init_err,
              f"sparse NMF.fit {norm}: error {err} not below the init's "
              f"{init_err}")
        check(W.shape == (NYT_M, K) and H.shape == (K, NYT_N), "factor shapes")
        # each MU iteration makes two ELL products, one K4 launch each (FRO:
        # A H^T and W^T A, plain; KL: UHT and WTU, ratio), and the final
        # Gram-identity error one more, W^T A (plain): FRO 2 x 10 + 1 = 21
        # plain; KL 2 x 10 = 20 ratio + 1 plain
        want = {**none, **({"ell_gather": 21} if norm == "fro"
                           else {"ell_gather": 1, "ell_gather_ratio": 20})}
        check(ran == want, f"sparse NMF.fit {norm} launches {ran}, expected "
                           f"{want}")
        del model, W, H
    del nyt, E
    torch.cuda.empty_cache()

    # -- 5. the sparse NMFk sweep through the CLI on an .npz --------------
    from scipy import sparse as sp
    r, c, v, tshape = generate_topic_sparse(**TOPIC, seed=7)
    # dense f32 would not fit the budget, and the time model takes ELL; the
    # sweeps' launch checks show that the run took it (K4 only)
    budget = sparse.BUDGET_FRAC * torch.cuda.mem_get_info(dev)[1]
    ladder = sparse.format_ladder(*tshape, len(v), 7, 4, budget, "cuda")
    check(tshape[0] * tshape[1] * 4 > budget and ladder[0] == "ell",
          f"the planted topic matrix should take ELL first, ladder {ladder}")
    with tempfile.TemporaryDirectory() as tmp:
        sp.save_npz(os.path.join(tmp, "T.npz"),
                    sp.csr_matrix((v, (r, c)), shape=tshape), compressed=False)
        del r, c, v
        sweep(tmp, "npz", "T", "fro", ("ell_gather",), tshape)
        sweep(tmp, "npz", "T", "kl", ("ell_gather", "ell_gather_ratio"),
              tshape)

    for name, n in main_path.items():
        check(n > 0, f"kernel {name} was not launched on the main path")

    # -- 6. report -------------------------------------------------------
    sources = {"K1 fused_mu_fro": ("fused_mu_fro.cu", "ops/fused_mu.py:50",
                                   ("fused_mu_fro", "fused_mu_fro_bf16",
                                    "fused_mu_fro_u8")),
               "K2a kl_uht": ("kl_ratio.cu", "ops/pallas_kernels.py:78",
                              ("kl_uht",)),
               "K2b kl_wtu": ("kl_ratio.cu", "ops/pallas_kernels.py:96",
                              ("kl_wtu",)),
               "K3 fused_mu_kl": ("fused_mu_kl.cu", "ops/fused_kl.py:44",
                                  ("fused_mu_kl", "fused_mu_kl_bf16",
                                   "fused_mu_kl_u8")),
               "K4 ell_gather": ("ell_gather.cu", "ops/pallas_ell.py:52",
                                 ("ell_gather", "ell_gather_ratio"))}
    kernels = [{"name": name, "route": "cuda",
                "source": f"pydnmfk_tpu_torch/csrc/{src}",
                "replaces": f"pydnmfk_tpu/{tpu}",
                "launches": sum(main_path[c] for c in keys),
                "launches_by_mode": {c: main_path[c] for c in keys},
                **rows[name]}
               for name, (src, tpu, keys) in sources.items()]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
