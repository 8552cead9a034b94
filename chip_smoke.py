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
     ``quantize_uint8`` of the f32 one), K2a/K2b and K3 on all three, and
     the f16 instantiations of K1, K2a, K2b and K3 on its f16 copy; and
     each on a 10-member 14400 x 9600, k = 8 ensemble (f32, and K1, K2a,
     K2b and K3 on its bf16 and its f16 copy, the NMFk ensemble under
     ``--a_precision=bfloat16`` or ``float16``);
     K2b on one member of it (the NMFk refit's shape); the two-read floor
     beside each K1 row and each K3 row on a bf16 or uint8 A, and beside
     each K3 row the time of K2a + K2b on the same inputs (the unfused pair
     that does K3's four products); the ptxas registers and spills of K1's,
     K2's, K3's and K4's kernels (no spill allowed);
   - K4 in its four modes (rows/columns, plain/ratio) at the shape and nnz
     of the NYTimes bag-of-words corpus (300000 x 102660, 69.7 M nnz,
     k = 32), with f32 and with f16 values, and on a 10-member stack of the planted topic matrix of 5 at
     k = 3 and 7 (library call: ``torch.bmm`` of a sparse COO stack);
   - K3 past k = 32 (the 3xTF32 kernel on an f32 A, within 1e-4 and bound
     at 165 TFLOP/s with the CUDA cores' 67 beside it; the tensor-core
     kernel at KP = 64 on a bf16, f16 or uint8 A, within 1e-3 and bound at
     989 TFLOP/s or by the bytes) at 57600 x 38400, k = 64, on the f32 A and
     its bf16, f16 and uint8 copies, and on the 10-member 14400 x 9600 stack
     at k = 34 and 64 in f32 and bf16, each beside K2a + K2b (k > 32) on the
     same inputs and the two-read floor; and
     K4 past k = 32 on its slab kernels: on the NYTimes shape at k = 64,
     128, 256 and 300 (column slabs sized to the L2; the ratio modes in
     several slabs in two passes) and on the 10-member topic stack at
     k = 64, each row with an estimate of its gathers (every nonzero's k
     floats at the L2's gather rate for uniform indices) beside its bound;
   - K2a and K2b past k = 32, on their 3xTF32 tensor-core kernels: at
     57600 x 38400, k = 64, on the f32 A and its bf16, f16 and uint8 copies,
     on one 14400 x 9600 member at k = 34, 64, 128, 256 and 300 (two output
     slabs) and on the 10-member stack at k = 34 and 64 (f32 and bf16), each
     within 1e-4 of the plain version,
     bound at 165 TFLOP/s (3xTF32) with the CUDA cores' 67 beside it;
   profiles one batched FRO-MU and KL-MU step on that stack (wall and
   device ms, idle share, top kernels); checks NMF.fit on the card
   against the CPU path on a small input; and times one ``eigh`` of a
   9600^2 Gram, the nnsvd init of one member of the NMFk ensemble;
3. the dense main path, launch counters at zero before each run and read
   after it: NMF.fit for 10 iterations at 57600 x 38400, k = 32, of FRO-MU
   and KL-MU (f32), of both on the uint8-quantized A, of FRO-MU on a bf16
   A, and of KL-MU with ``use_fused=True`` (K3) on an f32, a uint8 and a
   bf16 A; 10 iterations of HALS (column sweep and ``hals_block=8``, with
   the column chain timed apart from the two A-sized products), of BCD
   (both objectives) and of FRO-MU from the nnsvd init, none of them but
   the last launching a kernel; at bf16 factors FRO-MU (K1), KL-MU (K2),
   KL-MU with ``use_fused`` (K3), HALS and BCD, at f16 factors (on A /
   max(A)) FRO-MU, KL-MU and KL-MU with ``use_fused``, and on an f16 A under
   f32 factors FRO-MU and KL-MU, each within 2 % of the f32 solve's error
   with exact launches under the dtype's keys; KL-MU at k = 64 on the f32 A,
   its uint8 quantization and a bf16 A (K2's 3xTF32 kernels, exactly 10
   launches each), and each with ``use_fused=True`` (K3 past k = 32, exactly
   10 launches under the A dtype's key, counted past k = 32 too; within
   1e-3 of the K2 solve's error on the f32 A, 2 % on the others); then the
   NMFk sweep through
   the CLI on a
   planted rank-4 14400 x
   9600 matrix (k = 2..7, 10 perturbations, 400 iterations), FRO-MU and
   KL-MU, FRO-MU with ``--a_precision=bfloat16``, and FRO-MU with
   ``--precision=bfloat16`` and with ``--precision=float16``, which must
   choose k = 4; the FRO-MU sweep through the library with ``hbm_budget``
   set to hold 5 of the 10 members, which must run each k in two batches;
   the same KL-MU sweep through the library with ``use_fused=True``,
   on f32 and on bf16 members (the latter twice), whose ensemble must
   launch only K3 (for the
   members' dtype) and whose refit only K2b; and one FRO-MU factorization
   of that matrix through the CLI with and without ``--a_precision=uint8``;
4. the sparse main path, the same way: NMF.fit on the NYTimes-shaped matrix,
   10 FRO-MU, 10 KL-MU and 10 HALS iterations, k = 32, 10 FRO-MU and
   KL-MU iterations on its f16 values (``a_precision="float16"``, K4's f16
   instantiation), and 10 KL-MU iterations at k = 300 (K4 in column slabs,
   every call), on the ELL format the policy must choose;
5. the sparse NMFk sweep through the CLI on a planted rank-4 block-sparse
   200000 x 50000 ``.npz`` (about 50 nnz per row, 10 M nnz; the same sweep
   settings), FRO-MU and KL-MU, which must choose k = 4 on the ELL format;
   the NMFk sweep through the CLI with ``--method=hals --init=nnsvd
   --prune=true`` (20 perturbations) on a planted rank-4 4800 x 3200 matrix
   with all-zero rows and columns, and through the library with ``method="bcd"`` on the
   planted 14400 x 9600 one, each of which must choose k = 4 with no kernel
   launched; and the KL-MU sweep through the library at ks 4, 34 and 64 on
   that matrix (K2 past 32), and again with ``use_fused=True`` on bf16
   members (K3: 1200 launches in the ensemble, 800 of them past k = 32;
   K2b in the refit), each of which must choose k = 4 with exact launches
   in its ensemble and its refit;
6. the rest of the job, counters at zero before each run: NMF.fit with
   ``solve_checkpoint_every=10`` over 40 iterations at 57600 x 38400,
   k = 32, FRO-MU on the f32 A (K1) and its uint8 quantization (K1-u8) and
   KL-MU with ``use_fused=True`` on a bf16 copy (K3), each unchunked,
   chunked (exactly 40 launches, error within 1e-5), failed by a raise
   right after the saver's second save and run again (exactly 20
   launches, error within 1e-5, no checkpoint left), with the time of a
   save; the FRO-MU NMFk sweep on the planted 14400 x 9600 matrix (k =
   2..7, 10 perturbations in batches of 5, 400 iterations,
   ``checkpoint=True``) unbroken, then failed right after k = 5's first
   part and run again (K1 exactly 2000: k = 5's second batch and k = 6
   and 7; none in the refits; nopt = 4, each k's statistics beside the
   unbroken sweep's, no ``ensemble_parts/`` left), then extended to k = 9
   (K1 exactly 1600); ``--ftype=folder`` through the CLI at 1x1 and a 2 x 2
   chunk layout of uneven dims through DataReader (both bitwise the
   array); ``kl_divergence`` on the card within 1e-5 of f64 on the CPU;
   one solve under ``timing.trace`` (the trace names K1); ``train_mlp`` on
   the card (its numpy forward within 1e-5 of the module's logits) and
   ``predict_k`` on the sweep's results; ``seed_grid=(2, 2)`` members whose
   four blocks are bitwise equal; and whether the selection and timing
   plots were written (matplotlib may be absent);
7. the p_r x p_c grid (``parallel/mesh.py``), launch counters from zero in
   every rank: on a planted exact rank-48 57600 x 38400 matrix, k = 32, 10
   iterations, the 1x1 solves of FRO-MU, KL-MU, HALS, BCD (rand init) and
   FRO-MU from nnsvd (each also at f64: what f32 itself moves the
   factors), the FRO-MU and KL-MU solves on a one-rank NCCL group (the 1x1
   grid through the distributed code path), then under ``python -m
   torch.distributed.run`` four ranks sharing the card over gloo, each
   building only its block, on a 2 x 2 and a 4 x 1 grid: every method's
   error within 1e-4 of the 1x1 solve's, its gathered factors beside the
   1x1 ones, W's and H's replicas bitwise equal, K2a and K2b exactly 10
   each per rank in KL-MU and no other launch, one MU step's collectives,
   seconds per rank and stage; the FRO-MU NMFk sweep of the planted 14400 x
   9600 matrix at k = 3..5 (GRID_SWEEP; since phase 8 came, three ks, not
   k = 2..7) through ``-m pydnmfk_tpu_torch --p_r=2 --p_c=2`` under
   torchrun (nopt 4 printed once, factors in the 2 x 2 chunk layout,
   per-k statistics beside a 1x1 sweep's) and the KL-MU one with exact K2
   launches on every rank; K2a and K2b against their plain versions on the
   grid's block shapes (one 28800 x 19200 block at k = 32, the 10-member
   stack of 7200 x 4800 blocks at k = 7);
8. a sparse A on the grid (``sparse_grid_phase``), launch counters from
   zero in every rank: FRO-MU and KL-MU on the NYTimes-shaped matrix at
   k = 32, 10 iterations, on a one-rank NCCL group beside phase 4's 1x1
   fits; then under torchrun four ranks sharing the card over gloo, each
   drawing the matrix (``nytimes``) and keeping its block, on a 2 x 2 and
   a 4 x 1 grid: FRO-MU, KL-MU and HALS from the 1x1 init, each rank's
   block in the dual ELL that auto must pick on every rank, every error
   within 1e-4 of the 1x1 fit's, the gathered factors within 1e-3 (HALS:
   twice what f32 moves them from the 1x1 fit at f64), replicas bitwise
   equal, K4 exactly the 1x1 counts on every rank and no other launch, one
   MU step's collectives; FRO-MU on the 2 x 2 triplet blocks (no launch,
   within 1e-4 of the ELL fit); the NMFk sweeps of phase 5's topic .npz
   through the CLI under torchrun at k = 3..5, each rank reading its row
   panel: FRO-MU on 4 x 1 and KL-MU on 2 x 2, every block in the dual ELL
   and K4 exact per rank, nopt 4 on every rank, per-k statistics beside
   phase 5's 1x1 sweeps; K4 against its plain version on a 2 x 2 NYTimes
   block at k = 32 and a 4 x 1 block of the 10-member topic stack at
   k = 7 (its empty column lines padded), where each product in full is
   timed beside the triplet's;
9. the ensemble axis p_e (``ensemble_phase``): DataReader's blocks of a
   2 x 2 grid of an .npy (the native reader) and a .mat (its .npy cache),
   bitwise; then under torchrun four ranks sharing the card over gloo, with
   launch counters from zero in every rank, three NMFk sweeps through the
   library at k = 3..5, 10 members, 400 iterations: the planted 14400 x
   9600 FRO-MU sweep on p_e = 4 groups of 1 x 1 (K1 on each rank's
   members), its KL-MU sweep on 2 groups of 2 x 1 (K2a/K2b on each rank's
   block) and phase 5's topic FRO-MU sweep on 4 groups of 1 x 1 (K4 on the
   ELL), each with exact launches per rank, nopt 4 on every rank, every
   member's error beside the same member's in phase 3's or phase 5's 1x1
   sweep (1e-5 on one rank a group, or twice the spread of two 1x1 sweeps
   where phase 6 ran the second; 1e-3 on 2 x 1 blocks), per-k statistics
   beside the 1x1 sweep's, group 0's refit (factors, column errors) bitwise
   on every rank (and whether each group's own refit was), results
   written by rank 0 alone and each rank's stage seconds;
10. the K-padded NMFk sweep (``k_sweep_phase``, ``[k-sweep]`` lines): K1,
   K2a, K2b and K3 (f32 and bf16 A) on a 10-member stack of the planted
   14400 x 9600 matrix's copies and K4's four modes on the topic stack,
   each with k = 3 factors zero-padded to K = 7: every output's inactive
   columns exactly 0, the active ones within the kernel's limit of the
   same kernel on the unpadded stack and of the plain version on the
   padded one, both timed; then, launch counters from zero before each,
   five library sweeps at k = 2..7, 10 members, 400 iterations, with
   ``k_sweep_batch=True`` and ``checkpoint=True``: the planted FRO-MU
   sweep one k a batch and merged, KL-MU merged, KL-MU ``use_fused`` on
   bf16 members merged (K3) and the topic .npz FRO-MU merged (K4 on the
   ELL), each with nopt 4, exact launches at K's dispatch from the batch
   it reports, every member's error beside the same member's in the per-k
   sweep of phase 3 or 5 (1e-4, or twice the spread of two per-k sweeps
   where a second ran: phase 6's FRO, phase 3's second use_fused sweep on
   bf16 members), per-k statistics within phase 9's limits (or twice the
   two per-k sweeps' own difference where that is more; on bf16 members
   the errors within twice the largest spread of repeated per-k runs
   where that is more, and the clustering's statistics at every k but
   k = 6, where a repeated run changed a member's cluster), no
   ``ensemble_parts/`` left, and its seconds and stage seconds
   beside the per-k sweep's (no torchrun: the K-padded path on grids and
   p_e groups is held by the CPU tests);
11. the examples (``examples_phase``, ``[examples]`` lines): K1 at k = 1
   (one live column in its KP = 8 tile) against its plain version on
   nmfk_wtsi's 20 x 96x21 ensemble and on a 14400 x 9600 A; the data
   generator's command line (a 2 x 2 folder of uneven chunks, read back
   bitwise); then the nine examples of ``pydnmfk_tpu_torch/examples``
   through their ``main`` on stand-ins of wtsi.mat and swim.mat drawn from
   seeds (the files are not in the checkout), launch counters and stage
   timers from zero before each: large_scale (K1 200; HALS and BCD none),
   quantized_swim (K1 and K1-u8 200 each), nmfk_wtsi and runner_example
   from k = 1 (nopt 4, K1 at every batch, the batches utils/memory.py's),
   nmfk_swim at 5000 iterations under seed_grid=(2, 2) (nopt 16, K2a and
   K2b in the ensemble, K2b in the refit), nmfk_large (nopt 8, K1-bf16),
   sparse_ell_beyond_hbm (K4 on the ELL, then K2a and K2b on the dense
   form: the card's policy packs the triplet into the same ELL) and
   sparse_npz (its npz error within 0.01 of
   quantized_swim's dense one; its sparse NMFk, whose choice of k depends
   on the draws, held to its own members solved again on the CPU), each
   with exact launches and its seconds; then multihost_nmfk under
   torchrun as two ranks of a 2 x 1 grid sharing the card over gloo, at
   ks 3..5 of its 1..8, printed as ``reduced`` (nopt 4 on both, no
   launch);
12. prints the card's name and power limit, one JSON line of kernels, and
   as its last line ``{"ok": true, "device": {...}}``.

Any failed check raises, so the script exits non-zero and prints no result.
It also exits non-zero when there is no CUDA device or no package beside it.
``--grid-fits DIR`` and ``--grid-cli DIR ARGS`` are the rank programs of
phase 7 (``--grid-cli`` of phase 8's sweeps too), ``--sparse-grid-fits
DIR`` of phase 8, ``--ensemble-fits DIR DATA`` of phase 9,
``--example-rank DIR ARGS`` of phase 11; it starts them itself under
torchrun.
"""
from __future__ import annotations

import csv
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
PRUNED = dict(m=4800, n=3200, k=4)       # the prune sweep's input, whose
ZERO_EVERY = (97, 89)                    # every 97th row, 89th column is 0
SWEEP = ["--start_k=2", "--end_k=7", "--perturbations=10", "--itr=400"]
# the grid's CLI sweeps (phases 7 and 8), at three ks: four ranks sharing
# the card over gloo take 5-8 times the 1x1 sweep's seconds
GRID_SWEEP_KS = range(3, 6)
GRID_SWEEP = [f"--start_k={GRID_SWEEP_KS[0]}",
              f"--end_k={GRID_SWEEP_KS[-1]}", "--perturbations=10",
              "--itr=400"]
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
TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-3, torch.float16: 1e-3,
       torch.uint8: 1e-3}
ITR = 10                                 # MU iterations of the NMF.fit runs
CLI_ITR = 100    # the CLI factorization: the uint8 error floor stays below
PEAK_FLOPS, PEAK_BYTES = 67e12, 3.35e12  # H100 SXM: f32 non-tensor, HBM3
PEAK_BF16 = 989e12                       # H100 SXM: bf16 tensor cores, dense
PEAK_3XTF32 = 495e12 / 3                 # H100 SXM: TF32 tensor cores, three
                                         # products a product (K2 at k > 32)
WIDE_K = 64                              # K2 at k > 32, the KL solve
PARENT_KL300_S = 1.195   # phase 4's sparse KL-MU solve at k = 300 before
                         # the slab kernels (H100 80GB HBM3, 700 W)
WIDE_SWEEP = dict(start_k=4, end_k=64, step_k=30)   # ks 4, 34, 64


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


MANGLED_A = {None: "f32", "f": "f32", "h": "uint8", "13__nv_bfloat16": "bf16",
             "6__half": "f16"}


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
    """K1's two kernels (the f32 one; the tensor-core one for a bf16, f16 or
    uint8 A), keyed (A dtype, KP, vec)."""
    return ptxas(log, r"fused_mu_fro_(?:f32|tc)_kernelI(13__nv_bfloat16|6__half|h)?"
                      r"Li(\d+)ELb([01])E",
                 lambda m: (MANGLED_A[m.group(1)], int(m.group(2)),
                            m.group(3) == "1"))


def ptxas_k2(log):
    """K2's kernels: the register kernels (KP <= 32), the 3xTF32 tensor-core
    kernels (KP >= 64) and the split reduction, keyed (kernel, A dtype, KP,
    vec)."""
    return ptxas(log, r"(kl_\w+?_kernel)(?:I(f|13__nv_bfloat16|6__half|h)Li(\d+)E"
                      r"(?:Lb([01])E)?)?",
                 lambda m: (m.group(1), MANGLED_A[m.group(2)],
                            int(m.group(3) or 0), m.group(4) == "1"))


def ptxas_k4(log):
    """K4's kernels: the grouped kernel (k <= 32) keyed (kernel, values
    dtype, KP, member group, ratio), the slab kernel (k > 32) keyed
    (kernel, dtype, KP, 0, ratio), the ratio's dot pass keyed (kernel,
    dtype, KP, 0, True), and the two tables' layouts."""
    return ptxas(log, r"(grouped_kernel|slab_kernel|dot_kernel|"
                      r"interleave_kernel|slab_table_kernel)"
                      r"(?:I(f|13__nv_bfloat16|6__half)Li(\d+)E(?:Li(\d+)E)?"
                      r"(?:Lb([01])E)?)?",
                 lambda m: (m.group(1), MANGLED_A[m.group(2)],
                            int(m.group(3) or 0), int(m.group(4) or 0),
                            m.group(5) == "1" or m.group(1) == "dot_kernel"))


def ptxas_k3(log):
    """K3's kernels: the f32 kernel (k <= 32) and the tensor-core one for a
    bf16, f16 or uint8 A (every k <= 64) keyed (kernel, A dtype, KP, vec),
    and the 3xTF32 one for an f32 A past k = 32 keyed (kernel, "f32", 64,
    vec)."""
    return ptxas(log, r"(fused_mu_kl_f32_kernel|fused_mu_kl_tc_kernel|"
                      r"fused_mu_kl_tf32_kernel)"
                      r"I(?:(f|13__nv_bfloat16|6__half|h)?Li(\d+)E)?"
                      r"(?:Lb([01])E)?",
                 lambda m: (m.group(1), MANGLED_A[m.group(2)],
                            int(m.group(3) or 64), m.group(4) == "1"))


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


# -- phase 7: the p_r x p_c grid, four ranks sharing the card over gloo ----
GRID_SHAPES = ((2, 2), (4, 1))
GRID_RANKS = 4
GRID_PLANTED_RANK = 48       # rank of the grid phase's exact planted A
GRID_SEED = 11
GRID_METHODS = {"FRO-MU": dict(norm="fro"), "KL-MU": dict(norm="kl"),
                "HALS": dict(norm="fro", method="hals"),
                "BCD": dict(norm="fro", method="bcd"),
                "FRO-MU nnsvd": dict(norm="fro", init="nnsvd")}
GRID_ERR_TOL = 1e-4          # grid error vs the 1x1 solve's, relative
# gathered factors vs the 1x1 solve's, max |difference| / max |1x1|: f32
# sums in another order (K1's atomics at 1x1) over 10 iterations, or twice
# what f32 itself moves the 1x1 factors (against the 1x1 solve at f64 from
# the same init) where that is more: HALS's Gauss-Seidel chain and the
# randomized SVD of nnsvd magnify a rounding difference in the factors far
# more than in the error (tests/test_torch_grid_nmf.py holds every method
# to 1e-9 at f64)
GRID_FACTOR_TOL = 1e-3


def planted_exact(dev, rows=slice(None), cols=slice(None)):
    """The grid phase's M x N matrix, or its rows x cols block: the product
    of two matrices of integers 0..4 drawn from GRID_SEED, of rank
    GRID_PLANTED_RANK, whose entries (at most 768) are exact in f32 in any
    order of the sums, so that a rank's block is bitwise the whole
    matrix's."""
    g = torch.Generator(dev)
    g.manual_seed(GRID_SEED)
    Wp = torch.randint(0, 5, (M, GRID_PLANTED_RANK), generator=g,
                       device=dev).float()
    Hp = torch.randint(0, 5, (GRID_PLANTED_RANK, N), generator=g,
                       device=dev).float()
    return (Wp[rows] @ Hp[:, cols]).contiguous()


NYT_SEED = 2019           # the NYTimes-shaped matrix's own generator


def nytimes(dev):
    """The NYTimes-shaped matrix on ``dev``, the same on every process:
    flat positions drawn uniformly with replacement from NYT_SEED, repeats
    dropped by unique; positive counts-like values (geometric, from 1 - U
    in (0, 1]: torch.rand can return 0)."""
    from pydnmfk_tpu_torch.ops import sparse
    g = torch.Generator(dev)
    g.manual_seed(NYT_SEED)
    flat = torch.unique(torch.randint(0, NYT_M * NYT_N, (NYT_NNZ,),
                                      generator=g, device=dev))
    vals = torch.floor(-2.0 * torch.log1p(-torch.rand(
        flat.shape, generator=g, device=dev))) + 1.0
    return sparse.SparseTriplet(vals, (flat // NYT_N).to(torch.int32),
                                (flat % NYT_N).to(torch.int32),
                                (NYT_M, NYT_N))


def block_of(A, grid, rank):
    """Rank ``rank``'s block of the triplet A on a ``grid`` = (p_r, p_c),
    as ``ops/sparse.py::shard_sparse_grid`` cuts it on that rank."""
    import types
    from pydnmfk_tpu_torch.ops import sparse
    from pydnmfk_tpu_torch.parallel.partition import block_range
    i, j = divmod(rank, grid[1])
    place = types.SimpleNamespace(rows=lambda m: block_range(m, grid[0], i),
                                  cols=lambda n: block_range(n, grid[1], j))
    return sparse.shard_sparse_grid(A, place).block


def rel_max(X, Y):
    """max |X - Y| / max |Y|, at f64."""
    return float((X.double() - Y.double()).abs().max()
                 / Y.double().abs().max())


def _digest(t):
    import hashlib
    return hashlib.sha1(t.detach().cpu().contiguous().numpy()
                        .tobytes()).hexdigest()


def _rank_counters():
    from pydnmfk_tpu_torch.ops import ell_gather, fused_kl, fused_mu, kl
    return (fused_mu.launches, kl.launches, fused_kl.launches,
            ell_gather.launches)


def grid_fits(outdir):
    """One rank of phase 7's fits (run under torchrun, GRID_RANKS
    processes): on each grid of GRID_SHAPES, every method of GRID_METHODS
    for ITR iterations at M x N, k = K, on this rank's block of
    planted_exact, from the 1x1 solve's init (rand, seeded GRID_SEED, or
    nnsvd); then one FRO-MU and one KL-MU step's collectives. Writes
    ``outdir/rank{r}.json`` (errors, seconds, stages, launches, collectives,
    digests of this rank's W and H blocks) and, on rank 0, the gathered
    factors."""
    sys.path.insert(0, ROOT)
    import functools
    from pydnmfk_tpu_torch import NMF, NMFConfig
    from pydnmfk_tpu_torch.models import updates
    from pydnmfk_tpu_torch.parallel import mesh
    from pydnmfk_tpu_torch.utils import timing
    torch.backends.cuda.matmul.allow_tf32 = False
    counters = _rank_counters()
    report = {}
    timing.enable(True)
    for grid in GRID_SHAPES:
        ctx = mesh.initialize(*grid, "cuda")
        dev = ctx.device
        (r0, r1), (c0, c1) = ctx.rows(M), ctx.cols(N)
        A = planted_exact(dev, slice(r0, r1), slice(c0, c1))
        tag = f"{grid[0]}x{grid[1]}"
        for name, kw in GRID_METHODS.items():
            for c in counters:
                for key in c:
                    c[key] = 0
            timing.reset()
            before = {kind: list(v) for kind, v in ctx.stats.items()}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model = NMF(NMFConfig(k=K, itr=ITR, seed=GRID_SEED, **kw),
                        grid=ctx)
            W, H, err = model.fit(A)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            report[f"{tag} {name}"] = dict(
                err=err, secs=secs,
                stages={s: round(v, 4) for s, v in timing.TIMINGS.items()},
                launches={k: v for c in counters for k, v in c.items() if v},
                collectives={kind: [n - before.get(kind, (0, 0))[0],
                                    b - before.get(kind, (0, 0))[1]]
                             for kind, (n, b) in ctx.stats.items()},
                w_digest=_digest(model._W), h_digest=_digest(model._H))
            if ctx.is_proc0:
                torch.save({"W": W.cpu(), "H": H.cpu()},
                           os.path.join(outdir, f"{tag} {name}.pt"))
            del model, W, H
        g = torch.Generator(dev)
        g.manual_seed(GRID_SEED + ctx.rank)
        Wb = torch.rand((r1 - r0, K), generator=g, device=dev)
        Hb = torch.rand((K, c1 - c0), generator=g, device=dev)
        eps = float(torch.finfo(torch.float32).eps)
        for norm, step in (("fro", updates.mu_fro_step),
                           ("kl", updates.mu_kl_step)):
            timing.reset()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st = timing.collective_stats(functools.partial(step, grid=ctx),
                                         A, Wb, Hb, eps, grid=ctx)
            torch.cuda.synchronize()
            st["ms"] = (time.perf_counter() - t0) * 1e3
            st["dist_comm_ms"] = timing.TIMINGS.get("dist_comm", 0.0) * 1e3
            report[f"{tag} step {norm}"] = st
        del A, Wb, Hb
        torch.cuda.empty_cache()
    report.update(backend=ctx.backend, device=str(ctx.device),
                  coords={f"{g[0]}x{g[1]}": divmod(ctx.rank, g[1])
                          for g in GRID_SHAPES})
    with open(os.path.join(outdir, f"rank{ctx.rank}.json"), "w") as f:
        json.dump(report, f)
    torch.distributed.destroy_process_group()


def grid_cli(outdir, argv):
    """One rank of a CLI run under torchrun (``python3 chip_smoke.py
    --grid-cli OUTDIR ARGS``): ``cli.main(ARGS)`` with the launch counters
    from zero, then this rank's launches, the row panels its reader read
    (an .npz's) and its stage seconds in ``outdir/cli_rank{r}.json``."""
    sys.path.insert(0, ROOT)
    from pydnmfk_tpu_torch import cli
    from pydnmfk_tpu_torch.utils import io, timing
    rank = int(os.environ["RANK"])
    counters = _rank_counters()
    for c in counters:
        for key in c:
            c[key] = 0
    reads = []
    real_read = io.DataReader.read

    def read(self, grid=None):
        out = real_read(self, grid)
        reads.append(getattr(self, "rows_read", None))
        return out

    io.DataReader.read = read
    t0 = time.perf_counter()
    out = cli.main(argv)
    with open(os.path.join(outdir, f"cli_rank{rank}.json"), "w") as f:
        json.dump({"launches": {k: v for c in counters
                                for k, v in c.items() if v},
                   "secs": time.perf_counter() - t0,
                   "nopt": out.get("nopt"), "rows_read": reads,
                   "stages": {s: round(v, 3)
                              for s, v in timing.TIMINGS.items()}}, f)


# -- phase 8: a sparse A on the grid, four ranks sharing the card ---------
SPARSE_GRID_METHODS = {"FRO-MU": dict(norm="fro"), "KL-MU": dict(norm="kl"),
                       "HALS": dict(norm="fro", method="hals")}


def k4_fit_launches(norm, itr=ITR):
    """K4's launches in an ``itr``-iteration sparse fit on the dual ELL
    (phase 4): two products an iteration, one K4 call each (FRO and HALS:
    A H^T and W^T A, plain; KL: U H^T and W^T U, ratio), and one more for
    the final error's W^T A (plain); on a grid every rank's block alike."""
    return ({"ell_gather": 2 * itr + 1} if norm == "fro"
            else {"ell_gather": 1, "ell_gather_ratio": 2 * itr})


def sparse_grid_fits(outdir):
    """One rank of phase 8's fits (run under torchrun, GRID_RANKS
    processes): on each grid of GRID_SHAPES, this rank's block of the
    NYTimes-shaped matrix (drawn whole from NYT_SEED, then cut), every
    method of SPARSE_GRID_METHODS for ITR iterations at k = K from the 1x1
    fit's init (rand, the config's seed), in the format the ranks agree
    on; on 2 x 2 also FRO-MU on the triplet blocks; then one FRO-MU and
    one KL-MU step's collectives on the ELL blocks. Writes
    ``outdir/rank{r}.json`` and, on rank 0, the gathered factors."""
    sys.path.insert(0, ROOT)
    import functools
    from pydnmfk_tpu_torch import NMF, NMFConfig
    from pydnmfk_tpu_torch.models import updates
    from pydnmfk_tpu_torch.ops import sparse
    from pydnmfk_tpu_torch.parallel import mesh
    from pydnmfk_tpu_torch.utils import timing
    torch.backends.cuda.matmul.allow_tf32 = False
    counters = _rank_counters()
    report = {}
    timing.enable(True)
    for grid in GRID_SHAPES:
        ctx = mesh.initialize(*grid, "cuda")
        dev = ctx.device
        tag = f"{grid[0]}x{grid[1]}"
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        G = sparse.shard_sparse_grid(nytimes(dev), ctx)
        torch.cuda.synchronize()
        report[f"{tag} block"] = dict(shape=G.shape, nnz=G.nse,
                                      secs=time.perf_counter() - t0)
        if "warm-up" not in report:
            # a process's first fit sets up the libraries it calls (about
            # 5 s): one of 2 iterations, untimed, before the timed fits
            t0 = time.perf_counter()
            NMF(NMFConfig(k=K, itr=2), grid=ctx).fit(G)
            torch.cuda.synchronize()
            report["warm-up"] = time.perf_counter() - t0
        runs = dict(SPARSE_GRID_METHODS)
        if grid == (2, 2):
            runs["FRO-MU triplet"] = dict(norm="fro",
                                          sparse_grid_format="triplet")
        for name, kw in runs.items():
            for c in counters:
                for key in c:
                    c[key] = 0
            timing.reset()
            before = {kind: list(v) for kind, v in ctx.stats.items()}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model = NMF(NMFConfig(k=K, itr=ITR, **kw), grid=ctx)
            W, H, err = model.fit(G)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            fmt = model._A
            report[f"{tag} {name}"] = dict(
                err=err, secs=secs, fmt=type(fmt).__name__,
                widths=(list(fmt.rvals.shape[-1:] + fmt.cvals.shape[-1:])
                        if hasattr(fmt, "rvals") else None),
                stages={s: round(v, 4) for s, v in timing.TIMINGS.items()},
                launches={k: v for c in counters for k, v in c.items() if v},
                collectives={kind: [n - before.get(kind, (0, 0))[0],
                                    b - before.get(kind, (0, 0))[1]]
                             for kind, (n, b) in ctx.stats.items()},
                w_digest=_digest(model._W), h_digest=_digest(model._H))
            if ctx.is_proc0:
                torch.save({"W": W.cpu(), "H": H.cpu()},
                           os.path.join(outdir, f"{tag} {name}.pt"))
            del model, W, H, fmt
        E = sparse.grid_format(G, ctx).local
        (r0, r1), (c0, c1) = ctx.rows(NYT_M), ctx.cols(NYT_N)
        g = torch.Generator(dev)
        g.manual_seed(GRID_SEED + ctx.rank)
        Wb = torch.rand((r1 - r0, K), generator=g, device=dev)
        Hb = torch.rand((K, c1 - c0), generator=g, device=dev)
        eps = float(torch.finfo(torch.float32).eps)
        for norm, step in (("fro", updates.mu_fro_step),
                           ("kl", updates.mu_kl_step)):
            timing.reset()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st = timing.collective_stats(functools.partial(step, grid=ctx),
                                         E, Wb, Hb, eps, grid=ctx)
            torch.cuda.synchronize()
            st["ms"] = (time.perf_counter() - t0) * 1e3
            st["dist_comm_ms"] = timing.TIMINGS.get("dist_comm", 0.0) * 1e3
            report[f"{tag} step {norm}"] = st
        del G, E, Wb, Hb
        torch.cuda.empty_cache()
    report.update(backend=ctx.backend, device=str(ctx.device),
                  coords={f"{g[0]}x{g[1]}": divmod(ctx.rank, g[1])
                          for g in GRID_SHAPES})
    with open(os.path.join(outdir, f"rank{ctx.rank}.json"), "w") as f:
        json.dump(report, f)
    torch.distributed.destroy_process_group()


def sparse_grid_phase(dev, smi, gen, nyt_ref, topic_ref, k4_cases,
                      zero_counts, read_counts, main_path):
    """Phase 8, a sparse A on the grid, in the parent: the one-rank NCCL
    fits, the fits of ``--sparse-grid-fits`` under torchrun against
    ``nyt_ref`` (phase 4's 1x1 fits by name: error, W, H, seconds,
    launches), the CLI sweeps of the topic .npz against ``topic_ref``
    (phase 5's statistics of GRID_SWEEP_KS by norm), and K4 on the grid's
    block shapes through ``k4_cases``; the ranks' launches go into
    ``main_path``."""
    import socket
    import torch.distributed as dist
    from scipy import sparse as sp
    from pydnmfk_tpu_torch import NMF, NMFConfig
    from pydnmfk_tpu_torch.ops import ell, sparse
    from pydnmfk_tpu_torch.parallel import mesh
    from pydnmfk_tpu_torch.parallel.partition import block_range
    from pydnmfk_tpu_torch.utils.data_generator import generate_topic_sparse
    from pydnmfk_tpu_torch.utils.io import read_cluster_results
    torch.cuda.empty_cache()
    # the one-rank NCCL group (the 1x1 grid through the distributed code
    # path) against phase 4's 1x1 fits from the same init
    nyt = nytimes(dev)
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    one = mesh.initialize(1, 1, "cuda", init_method=f"tcp://localhost:{port}",
                          rank=0, world_size=1, timeout=600)
    for name in ("FRO-MU", "KL-MU"):
        kw = SPARSE_GRID_METHODS[name]
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model = NMF(NMFConfig(k=K, itr=ITR, **kw), grid=one)
        _, _, err = model.fit(nyt)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        ran = {key: n for key, n in read_counts().items() if n}
        rel = abs(err / nyt_ref[name][0] - 1)
        print(f"[grid-sparse] 1x1 grid, one NCCL rank, {name} on the "
              f"NYTimes-shaped matrix k={K}: format "
              f"{type(model._A).__name__}, error {err:.6f} (1x1 without a "
              f"grid {nyt_ref[name][0]:.6f}, relative difference {rel:.2e}, "
              f"limit {GRID_ERR_TOL:g}), {secs:.3f} s (1x1 "
              f"{nyt_ref[name][3]:.3f} s), launches {ran}", flush=True)
        check(isinstance(model._A, ell.EllSparse) and rel <= GRID_ERR_TOL
              and ran == k4_fit_launches(kw["norm"]),
              f"one-rank NCCL sparse {name}: error {err}, launches {ran}")
        del model
    dist.destroy_process_group()
    del nyt
    torch.cuda.empty_cache()

    # four ranks on the card over gloo, 2 x 2 and 4 x 1, each drawing the
    # matrix and keeping its block; HALS's factors held as phase 7 holds
    # them, by what f32 itself moves them (the 1x1 fit at f64, on K4's
    # plain version)
    W64, H64, _ = NMF(NMFConfig(k=K, itr=ITR, precision="float64",
                                **SPARSE_GRID_METHODS["HALS"]),
                      dev).fit(nytimes(dev))
    hals_tol = max(GRID_FACTOR_TOL, 2 * max(
        rel_max(nyt_ref["HALS"][1], W64.cpu()),
        rel_max(nyt_ref["HALS"][2], H64.cpu())))
    del W64, H64
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        _, secs = torchrun([os.path.abspath(__file__), "--sparse-grid-fits",
                            tmp], 600)
        ranks = []
        for r in range(GRID_RANKS):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
        print(f"[grid-sparse] {GRID_RANKS} ranks on one card ({smi}), "
              f"backend {ranks[0]['backend']}, {secs:.1f} s for the torchrun "
              f"of all fits (of it a warm-up fit of 2 iterations, a rank's "
              f"first, {[round(r['warm-up'], 3) for r in ranks]} s); "
              f"blocks (shape, nnz, seconds to draw and cut) per rank "
              f"{[[r[f'{p}x{q} block'] for p, q in GRID_SHAPES] for r in ranks]}",
              flush=True)
        for grid in GRID_SHAPES:
            tag = f"{grid[0]}x{grid[1]}"
            names = list(SPARSE_GRID_METHODS) + (
                ["FRO-MU triplet"] if grid == (2, 2) else [])
            for name in names:
                runs = [r[f"{tag} {name}"] for r in ranks]
                triplet = name.endswith("triplet")
                err1, W1, H1 = nyt_ref[name.split()[0]][:3]
                got = torch.load(os.path.join(tmp, f"{tag} {name}.pt"))
                d_w, d_h = rel_max(got["W"], W1), rel_max(got["H"], H1)
                ftol = hals_tol if name == "HALS" else GRID_FACTOR_TOL
                if triplet:       # against the ELL blocks' fit
                    err1 = ranks[0][f"{tag} FRO-MU"]["err"]
                rel = abs(runs[0]["err"] / err1 - 1)
                rows_ok = all(a["w_digest"] == b["w_digest"]
                              for ra, a in zip(ranks, runs)
                              for rb, b in zip(ranks, runs)
                              if ra["coords"][tag][0] == rb["coords"][tag][0])
                cols_ok = all(a["h_digest"] == b["h_digest"]
                              for ra, a in zip(ranks, runs)
                              for rb, b in zip(ranks, runs)
                              if ra["coords"][tag][1] == rb["coords"][tag][1])
                want = ({} if triplet else k4_fit_launches(
                    SPARSE_GRID_METHODS[name]["norm"]))
                fmts = {run["fmt"] for run in runs}
                print(f"[grid-sparse] {tag} {name}: formats {fmts} (ELL "
                      f"widths rows / columns per rank "
                      f"{[run['widths'] for run in runs]}), error "
                      f"{runs[0]['err']:.6f} ("
                      f"{'ELL 2x2' if triplet else '1x1'} "
                      f"{err1:.6f}, relative difference {rel:.2e}, limit "
                      f"{GRID_ERR_TOL:g}); gathered W, H vs 1x1 {d_w:.2e}, "
                      f"{d_h:.2e} (limit {ftol:.2e}); replicas bitwise equal: "
                      f"W {rows_ok}, H {cols_ok}; seconds per rank "
                      f"{[round(run['secs'], 3) for run in runs]} (1x1 "
                      f"{nyt_ref[name.split()[0]][3]:.3f}); rank 0 stages "
                      f"{runs[0]['stages']}; collectives (calls, bytes) "
                      f"{runs[0]['collectives']}; launches per rank "
                      f"{[run['launches'] for run in runs]}", flush=True)
                check(fmts == {"SparseTriplet" if triplet else "EllSparse"},
                      f"{tag} {name}: the ranks ran {fmts}")
                check(len({run["err"] for run in runs}) == 1,
                      f"{tag} {name}: ranks' errors differ")
                check(rel <= GRID_ERR_TOL and d_w <= ftol and d_h <= ftol,
                      f"{tag} {name} is not the 1x1 fit")
                check(rows_ok and cols_ok, f"{tag} {name}: replicas differ")
                check(all(run["launches"] == want for run in runs),
                      f"{tag} {name} launched "
                      f"{[run['launches'] for run in runs]}, not {want}")
                for run in runs:
                    for key, n in run["launches"].items():
                        main_path[key] += n
            for norm in ("fro", "kl"):
                steps = [r[f"{tag} step {norm}"] for r in ranks]
                print(f"[grid-sparse] {tag} one {norm.upper()}-MU step on the "
                      f"ELL blocks: collectives {steps[0]['counts']}, bytes "
                      f"per rank {[st['bytes'] for st in steps]}, ms per rank "
                      f"{[round(st['ms'], 2) for st in steps]}, of it in "
                      f"collectives "
                      f"{[round(st['dist_comm_ms'], 2) for st in steps]}",
                      flush=True)
                check(all(st["counts"] == {"all-reduce": 4} for st in steps),
                      f"{tag} sparse {norm} step collectives "
                      f"{steps[0]['counts']}")

    # the sparse NMFk sweeps through the CLI under torchrun, each rank
    # reading its row panel of the topic .npz: FRO-MU on 4 x 1 and KL-MU on
    # 2 x 2 at GRID_SWEEP_KS, beside phase 5's 1x1 sweeps at those ks. The
    # auto format is the dual ELL on every rank: a topic's rows use a
    # quarter of the columns, so three quarters of a 4 x 1 block's column
    # lines are empty, and grid_ell_pack counts its blow-up over the lines
    # that hold a nonzero (the JAX package's shared widths refuse this
    # grid); on 2 x 2 two blocks are empty and pack as padding
    r, c, v, tshape = generate_topic_sparse(**TOPIC, seed=7)
    topic = sparse.from_coo(*(torch.from_numpy(x).to(dev) for x in (r, c, v)),
                            tshape)
    ks = list(GRID_SWEEP_KS)
    with tempfile.TemporaryDirectory() as tmp:
        sp.save_npz(os.path.join(tmp, "T.npz"),
                    sp.csr_matrix((v, (r, c)), shape=tshape), compressed=False)
        del r, c, v
        base = ["--process=pyDNMFk", "--ftype=npz", f"--fpath={tmp}/",
                "--fname=T", *GRID_SWEEP, "--timing_stats=true"]
        sweeps = (("fro", (4, 1)), ("kl", (2, 2)))
        for norm, grid in sweeps:
            tag = f"{grid[0]}x{grid[1]}"
            widths = []
            for rank in range(GRID_RANKS):
                packed = ell.grid_ell_pack(block_of(topic, grid, rank))
                widths.append(packed and [packed[0].rvals.shape[1],
                                          packed[0].cvals.shape[1]])
            print(f"[grid-sparse] topic blocks on {tag}: ELL widths rows / "
                  f"columns per rank {widths} (None: the block refuses the "
                  f"ELL)", flush=True)
            check(all(widths), f"{tag} topic blocks refuse the ELL: {widths}")
        # the two sweeps run at once, eight processes sharing the card and
        # the host's cores: their seconds time both together
        started = {}
        try:
            for norm, grid in sweeps:
                os.makedirs(f"{tmp}/{norm}_ranks")
                started[norm] = torchrun_start(
                    [os.path.abspath(__file__), "--grid-cli",
                     f"{tmp}/{norm}_ranks", f"--p_r={grid[0]}",
                     f"--p_c={grid[1]}", f"--norm={norm}",
                     f"--results_path={tmp}/{norm}/", *base])
            secs_of = {norm: torchrun_wait(run, 900)[1]
                       for norm, run in started.items()}
        finally:
            for run in started.values():
                torchrun_stop(run)
        for norm, grid in sweeps:
            tag = f"{grid[0]}x{grid[1]}"
            res, secs = f"{tmp}/{norm}/", secs_of[norm]
            cli_ranks = []
            for rank in range(GRID_RANKS):
                with open(os.path.join(tmp, f"{norm}_ranks",
                                       f"cli_rank{rank}.json")) as f:
                    cli_ranks.append(json.load(f))
            # a k: the ensemble's 400 steps of one batch of 10 and its final
            # error, the refit's 400 H steps, its error and column error
            # (phase 5's counts a k)
            per_k = ({"ell_gather": 1203} if norm == "fro"
                     else {"ell_gather": 3, "ell_gather_ratio": 1200})
            want = {key: n * len(ks) for key, n in per_k.items()}
            # one read a rank, of its rows alone
            panels = [r["rows_read"] for r in cli_ranks]
            want_panels = [[[list(block_range(tshape[0], grid[0],
                                              rank // grid[1]))]]
                           for rank in range(GRID_RANKS)]
            worst = {"ErrTol": 0.0, "avgErr": 0.0, "L_err": 0.0, "sils": 0.0}
            for k in ks:
                a = read_cluster_results(os.path.join(res, "T", str(k)))
                b = topic_ref[norm][k]
                for key in ("ErrTol", "avgErr", "L_err"):
                    worst[key] = max(worst[key], float(np.max(
                        np.abs(a[key] - b[key]) / np.abs(b[key]).max())))
                worst["sils"] = max(worst["sils"], float(np.max(np.abs(
                    a["clusterSilhouetteCoefficients"]
                    - b["clusterSilhouetteCoefficients"]))))
            print(f"[grid-sparse] NMFk {norm.upper()}-MU sweep through the "
                  f"CLI "
                  f"under torchrun, {tag} grid, topic .npz {tshape[0]}x"
                  f"{tshape[1]} k={ks[0]}..{ks[-1]}, 10 perturbations, 400 "
                  f"iterations ({smi}): nopt "
                  f"{[r['nopt'] for r in cli_ranks]}, {secs:.2f} s for the "
                  f"torchrun (beside the other sweep's); rank 0 stage "
                  f"seconds {cli_ranks[0]['stages']}; "
                  f"row panels read per rank {panels}; launches per rank "
                  f"{[r['launches'] for r in cli_ranks]} (expected {want}); "
                  f"per-k statistics against phase 5's 1x1 sweep, max "
                  f"difference over max (silhouettes: absolute) {worst} "
                  f"(limits 1e-3, 1e-3, 1e-2, 1e-3)", flush=True)
            check(all(r["nopt"] == 4 for r in cli_ranks),
                  f"{tag} sparse {norm} sweep nopt")
            check(all(r["launches"] == want for r in cli_ranks),
                  f"{tag} sparse {norm} sweep launches")
            check(panels == want_panels,
                  f"{tag} sparse sweep row panels {panels}, not {want_panels}")
            check(worst["ErrTol"] <= 1e-3 and worst["avgErr"] <= 1e-3
                  and worst["L_err"] <= 1e-2 and worst["sils"] <= 1e-3,
                  f"{tag} sparse {norm} sweep's stats are not the 1x1 "
                  f"sweep's: {worst}")
            for rank in cli_ranks:
                for key, n in rank["launches"].items():
                    main_path[key] += n

    # K4 against its plain version on the grid's block shapes: a 2 x 2
    # block of the NYTimes-shaped matrix at k = K, and a 4 x 1 block of the
    # 10-member topic stack at k = TOPIC_K, the FRO sweep's, packed as the
    # grid packs it (its empty column lines padded); there each product in
    # full (K4 and the tails) beside the triplet's, which auto would run
    # if the block refused
    blk = block_of(nytimes(dev), (2, 2), 0)
    Eb = ell.ell_pack(blk)
    Wb = torch.rand((blk.shape[0], K), generator=gen, device=dev)
    Hb = torch.rand((K, blk.shape[1]), generator=gen, device=dev)
    B_r = csr(blk.rows, blk.cols, blk.data, blk.shape)
    B_c = csr(blk.cols, blk.rows, blk.data, blk.shape[::-1])
    k4_cases(f"2x2 block {blk.shape[0]}x{blk.shape[1]} ({blk.nse} nnz) "
             f"k={K} f32", Eb, Wb, Hb,
             lambda Ht, W: (lambda: torch.sparse.mm(B_r, Ht),
                            lambda: torch.sparse.mm(B_c, W)))
    del blk, Eb, Wb, Hb, B_r, B_c
    blk = block_of(topic, (4, 1), 0)
    del topic
    Eb, *perms = ell.grid_ell_pack(blk)
    data = blk.data * (1.0 + 0.03 * torch.rand((ENS, blk.nse), generator=gen,
                                               device=dev))
    stack = ell.ell_with_data(Eb, *perms, data)
    S_r = coo_stack(blk.rows, blk.cols, data, blk.shape)
    S_c = coo_stack(blk.cols, blk.rows, data, blk.shape[::-1])
    Ws = torch.rand((ENS, blk.shape[0], TOPIC_K), generator=gen, device=dev)
    Hs = torch.rand((ENS, TOPIC_K, blk.shape[1]), generator=gen, device=dev)
    k4_cases(f"4x1 block {ENS} x {blk.shape[0]}x{blk.shape[1]} ({blk.nse} "
             f"nnz, padded lines) k={TOPIC_K} f32", stack, Ws, Hs,
             lambda Ht, W: (lambda: torch.bmm(S_r, Ht),
                            lambda: torch.bmm(S_c, W)))
    trip = blk.with_data(data)
    eps = float(torch.finfo(torch.float32).eps)
    pairs = {"A H^T": (lambda: ell.ell_a_ht(stack, Hs),
                       lambda: sparse.a_ht_triplet(trip, Hs)),
             "W^T A": (lambda: ell.ell_wt_a(stack, Ws),
                       lambda: sparse.wt_a_triplet(trip, Ws)),
             "KL U H^T": (lambda: ell.ell_kl_uht(stack, Ws, Hs, eps),
                          lambda: sparse.kl_uht_sparse(trip, Ws, Hs, eps)),
             "KL W^T U": (lambda: ell.ell_kl_wtu(stack, Ws, Hs, eps),
                          lambda: sparse.kl_wtu_sparse(trip, Ws, Hs, eps))}
    times = {}
    for label, (f_ell, f_trip) in pairs.items():
        _, rel = compare(f_ell(), f_trip())
        check(rel <= TOL[torch.float32],
              f"4x1 topic block {label}: ELL and triplet differ by {rel:.3e}")
        times[label] = (median_ms(f_ell), median_ms(f_trip))
    print(f"[grid-sparse] 4x1 topic block {ENS} x {blk.shape[0]}x"
          f"{blk.shape[1]}, {blk.nse} nnz, k={TOPIC_K} ({smi}): ELL widths "
          f"rows / columns {Eb.rvals.shape[1]} / {Eb.cvals.shape[1]}, slots "
          f"a nonzero {Eb.rvals.numel() / blk.nse:.2f} / "
          f"{Eb.cvals.numel() / blk.nse:.2f}; a product in full, ms, the "
          f"ELL (K4 and the tails) against the triplet "
          + ", ".join(f"{label} {a:.3f} / {b:.3f}"
                      for label, (a, b) in times.items()), flush=True)
    del blk, Eb, perms, data, stack, S_r, S_c, Ws, Hs, trip
    torch.cuda.empty_cache()


# -- phase 9: the ensemble axis p_e, four ranks sharing the card ----------
# each sweep: (p_e, (p_r, p_c), ftype, fname, norm); four groups of one rank
# (K1, or K4 on the ELL, on each rank's members) and two groups of a 2 x 1
# grid (K2a/K2b on each rank's block)
ENSEMBLE_SWEEPS = {"e4 1x1 FRO-MU": (4, (1, 1), "npy", "X", "fro"),
                   "e2 2x1 KL-MU": (2, (2, 1), "npy", "X", "kl"),
                   "e4 1x1 sparse FRO-MU": (4, (1, 1), "npz", "T", "fro")}
ENSEMBLE_MEMBERS, ENSEMBLE_ITR = 10, 400
# a member's error against the same member's in the 1x1 sweep, relative:
# one rank a group runs the 1x1 arithmetic on a smaller batch; a 2 x 1
# block sums its products in another order. Where a second 1x1 sweep of
# the same members ran (phase 6's, in batches of 5), the limit is at least
# twice the spread between the two, which K1's atomics (their order
# changes from run to run) open over 400 iterations
ENSEMBLE_MEMBER_TOL = {(1, 1): 1e-5, (2, 1): 1e-3}


def ensemble_launches(p_e, grid, norm, ftype, batch, group,
                      ks=len(GRID_SWEEP_KS)):
    """A rank's exact launches in a phase-9 sweep: the batches of the
    ENSEMBLE_MEMBERS in which its group has a member (``batch`` a batch,
    split as ``GridContext.members`` splits it), ENSEMBLE_ITR steps each;
    the refit in every group."""
    from pydnmfk_tpu_torch.parallel.partition import block_range
    n = ENSEMBLE_MEMBERS
    solves = sum(1 for s in range(0, n, batch)
                 if len(range(*block_range(min(s + batch, n) - s, p_e,
                                           group))))
    itr = ENSEMBLE_ITR
    if ftype == "npz":       # the ELL: 2 K4 a step and the final error; the
        return {"ell_gather": ks * (solves * (2 * itr + 1)   # refit's steps
                                    + itr + 2)}              # and errors
    if grid == (1, 1):       # one shard: K1 a step; the refit's plain
        return {"fused_mu_fro": ks * solves * itr}
    return {"kl_uht": ks * solves * itr,           # K2 on the block; the
            "kl_wtu": ks * (solves + 1) * itr}     # refit's H steps K2b


def ensemble_fits(outdir, datadir):
    """One rank of phase 9's sweeps (run under torchrun, GRID_RANKS
    processes): each sweep of ENSEMBLE_SWEEPS through the library on its
    p_e groups, A read by DataReader (this rank's block of
    ``datadir/X.npy``, or ``datadir/T.npz`` whole on a 1 x 1 group), at
    GRID_SWEEP_KS with ENSEMBLE_MEMBERS members and ENSEMBLE_ITR
    iterations, the CLI's defaults otherwise. Writes
    ``outdir/rank{r}.json``: nopt, seconds, stages, launches, the batch,
    every member's error by k, digests of the refit's factors, the results
    this rank wrote."""
    sys.path.insert(0, ROOT)
    from pydnmfk_tpu_torch import NMFConfig, NMFk, NMFkConfig
    from pydnmfk_tpu_torch.models import nmf as nmf_mod
    from pydnmfk_tpu_torch.parallel import mesh
    from pydnmfk_tpu_torch.utils import io, timing
    torch.backends.cuda.matmul.allow_tf32 = False
    counters = _rank_counters()
    refits, writes = [], []
    real_fit, real_write = nmf_mod.NMF.fit, io.DataWriter.save_cluster_results

    def fit(self, A, factors=None, **kw):
        W, H, err = real_fit(self, A, factors, **kw)
        if not self.cfg.W_update:       # the W-frozen refit: whole factors
            refits.append([_digest(W), _digest(H)])
        return W, H, err

    def write(self, *a, **kw):
        writes.append(self.fpath)
        return real_write(self, *a, **kw)

    class Members(NMFk):
        def _solve_ensemble(self, A, k, members=None):
            out = super()._solve_ensemble(A, k, members)
            self.errs[k] = out[2].double().cpu().tolist()
            return out

        def _from_group0(self, *refit):
            out = super()._from_group0(*refit)
            self.taken.append([_digest(x) for x in out[:2]]
                              + [_digest(torch.from_numpy(out[2])),
                                 out[3]])
            return out

    nmf_mod.NMF.fit, io.DataWriter.save_cluster_results = fit, write
    timing.enable(True)
    report = {}
    for name, (p_e, grid, ftype, fname, norm) in ENSEMBLE_SWEEPS.items():
        ctx = mesh.initialize(*grid, "cuda", p_e=p_e)
        for c in counters:
            for key in c:
                c[key] = 0
        timing.reset()
        refits.clear()
        writes.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        A = io.DataReader(datadir + "/", fname, ftype).read(ctx)
        cfg = NMFkConfig(nmf=NMFConfig(norm=norm, itr=ENSEMBLE_ITR),
                         start_k=GRID_SWEEP_KS[0], end_k=GRID_SWEEP_KS[-1],
                         perturbations=ENSEMBLE_MEMBERS, checkpoint=False,
                         results_path=os.path.join(outdir, name) + "/",
                         fname=fname)
        model = Members(cfg, grid=ctx)
        model.errs, model.taken = {}, []
        nopt = model.fit(A)
        torch.cuda.synchronize()
        report[name] = dict(
            nopt=nopt, secs=time.perf_counter() - t0,
            batch=model.last_batch_size, group=ctx.group_index,
            coords=list(ctx.coords), errs=model.errs, refits=list(refits),
            taken=model.taken,
            writes=list(writes), ell=model._ell is not None,
            launches={k: v for c in counters for k, v in c.items() if v},
            stages={s: round(v, 3) for s, v in timing.TIMINGS.items()})
        del A, model
        torch.cuda.empty_cache()
    report.update(backend=ctx.backend, device=str(ctx.device))
    with open(os.path.join(outdir, f"rank{ctx.rank}.json"), "w") as f:
        json.dump(report, f)
    torch.distributed.destroy_process_group()


def ensemble_phase(smi, refs, main_path):
    """Phase 9 in the parent: DataReader's block reads (a 2 x 2 grid's
    blocks of an .npy by the native reader and of a .mat through its .npy
    cache, bitwise), then the sweeps of ``--ensemble-fits`` under torchrun
    against ``refs`` (by sweep name: the 1x1 sweep's results at
    GRID_SWEEP_KS, its seconds, its stage seconds and, where one ran, a
    second 1x1 sweep's results of the same members); the ranks' launches
    go into ``main_path``."""
    import types
    from scipy import sparse as sp
    from scipy.io import savemat
    from pydnmfk_tpu_torch import native
    from pydnmfk_tpu_torch.parallel.partition import block_range
    from pydnmfk_tpu_torch.utils import io as io_mod
    from pydnmfk_tpu_torch.utils.data_generator import (generate_data,
                                                        generate_topic_sparse)
    from pydnmfk_tpu_torch.utils.io import read_cluster_results
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        # the reader: every block of a 2 x 2 grid, of an .npy by the C
        # reader and of a .mat through its .npy copy in the cache
        check(native.get_lib() is not None,
              "no C compiler built the native block reader")
        os.environ[io_mod.CACHE_ENV] = os.path.join(tmp, "cache")
        X = np.random.default_rng(9).random((1001, 703)).astype(np.float32)
        np.save(os.path.join(tmp, "R.npy"), X)
        savemat(os.path.join(tmp, "R.mat"), {"X": X})
        reads, served = dict(io_mod.BLOCK_READS), dict(native.READS)
        t0 = time.perf_counter()
        for ftype in ("npy", "mat"):
            reader = io_mod.DataReader(tmp + "/", "R", ftype)
            for rank in range(4):
                i, j = divmod(rank, 2)
                place = types.SimpleNamespace(
                    rows=lambda m, i=i: block_range(m, 2, i),
                    cols=lambda n, j=j: block_range(n, 2, j))
                (r0, r1), (c0, c1) = place.rows(1001), place.cols(703)
                check(np.array_equal(reader.read(place), X[r0:r1, c0:c1]),
                      f"DataReader {ftype} block {rank} is not the array's")
        secs = time.perf_counter() - t0
        got = {key: io_mod.BLOCK_READS[key] - reads[key]
               for key in reads} | {key: native.READS[key] - served[key]
                                    for key in served}
        print(f"[ensemble] DataReader on a 2x2 grid, 1001x703 f32 .npy and "
              f".mat: every block bitwise the array's, reads {got} "
              f"(expected npy 4, cache 4, native 8), {secs:.3f} s", flush=True)
        check(got == {"npy": 4, "cache": 4, "whole": 0, "native": 8,
                      "mmap": 0}, f"block reads {got}")
        del os.environ[io_mod.CACHE_ENV]

        # the sweeps' inputs: phase 3's planted matrix and phase 5's topic
        # .npz
        _, _, X = generate_data(**PLANTED)
        np.save(os.path.join(tmp, "X.npy"), X.astype(np.float32))
        del X
        r, c, v, tshape = generate_topic_sparse(**TOPIC, seed=7)
        sp.save_npz(os.path.join(tmp, "T.npz"),
                    sp.csr_matrix((v, (r, c)), shape=tshape),
                    compressed=False)
        del r, c, v
        out = os.path.join(tmp, "out")
        os.makedirs(out)
        torch.cuda.empty_cache()
        _, secs = torchrun([os.path.abspath(__file__), "--ensemble-fits",
                            out, tmp], 900)
        ranks = []
        for rank in range(GRID_RANKS):
            with open(os.path.join(out, f"rank{rank}.json")) as f:
                ranks.append(json.load(f))
        print(f"[ensemble] {GRID_RANKS} ranks on one card ({smi}), backend "
              f"{ranks[0]['backend']}: {secs:.1f} s for the torchrun of "
              f"the three sweeps (the ranks share the card's SMs: this "
              f"times the code and its gathers, not p_e cards)", flush=True)
        check(all(r["backend"] == "gloo" for r in ranks), "ensemble backend")
        # every sweep prints its lines before a failed check stops the phase
        failed = []
        need = lambda cond, msg: cond or failed.append(msg)
        for name, (p_e, grid, ftype, fname, norm) in ENSEMBLE_SWEEPS.items():
            runs = [r[name] for r in ranks]
            ref, ref_secs, ref_stages, *rerun = refs[name]
            # two 1x1 sweeps of the same members, relative
            spread = max(float(np.max(np.abs(
                rerun[0][k]["ErrTol"] / ref[k]["ErrTol"] - 1)))
                for k in GRID_SWEEP_KS) if rerun else 0.0
            tol = max(ENSEMBLE_MEMBER_TOL[grid], 2 * spread)
            want = [ensemble_launches(p_e, grid, norm, ftype, run["batch"],
                                      run["group"]) for run in runs]
            member = max(float(np.max(np.abs(
                np.asarray(run["errs"][str(k)]) / ref[k]["ErrTol"] - 1)))
                for run in runs for k in GRID_SWEEP_KS)
            worst = {"ErrTol": 0.0, "avgErr": 0.0, "L_err": 0.0, "sils": 0.0}
            for k in GRID_SWEEP_KS:
                a = read_cluster_results(os.path.join(out, name, fname,
                                                      str(k)))
                b = ref[k]
                for key in ("ErrTol", "avgErr", "L_err"):
                    worst[key] = max(worst[key], float(np.max(
                        np.abs(a[key] - b[key]) / np.abs(b[key]).max())))
                worst["sils"] = max(worst["sils"], float(np.max(np.abs(
                    a["clusterSilhouetteCoefficients"]
                    - b["clusterSilhouetteCoefficients"]))))
            # each group's own refit (a sparse one sums with atomics on the
            # card), and group 0's, which every group takes
            refits = {json.dumps(run["refits"]) for run in runs}
            taken = {json.dumps(run["taken"]) for run in runs}
            print(f"[ensemble] {name} ({p_e} groups of {grid[0]}x{grid[1]}"
                  f", {ftype} {fname}, k={GRID_SWEEP_KS[0]}.."
                  f"{GRID_SWEEP_KS[-1]}, {ENSEMBLE_MEMBERS} members, "
                  f"{ENSEMBLE_ITR} iterations; {smi}): nopt per rank "
                  f"{[run['nopt'] for run in runs]}, batch "
                  f"{runs[0]['batch']}; members' errors against the 1x1 "
                  f"sweep's, max relative difference {member:.2e} (limit "
                  f"{tol:.2e}; two 1x1 sweeps of these members "
                  + (f"{spread:.2e}" if rerun else "not run")
                  + f"); per-k statistics, max difference over max "
                  f"(silhouettes: absolute) {worst} (limits 1e-3, 1e-3, "
                  f"1e-2, 1e-3); the groups' own refits bitwise equal: "
                  f"{len(refits) == 1}, group 0's taken by every rank: "
                  f"{len(taken) == 1}; results written per rank "
                  f"{[len(run['writes']) for run in runs]}; seconds per rank "
                  f"{[round(run['secs'], 2) for run in runs]} (1x1 "
                  f"{ref_secs:.2f}); stage seconds per rank "
                  f"{[run['stages'] for run in runs]} (1x1 {ref_stages}); "
                  f"launches per rank {[run['launches'] for run in runs]} "
                  f"(expected {want})", flush=True)
            need(all(run["nopt"] == 4 for run in runs), f"{name} nopt")
            need(member <= tol, f"{name}: a member's error is "
                                 f"{member:.2e} from the 1x1 member's")
            need(worst["ErrTol"] <= 1e-3 and worst["avgErr"] <= 1e-3
                  and worst["L_err"] <= 1e-2 and worst["sils"] <= 1e-3,
                  f"{name}: stats are not the 1x1 sweep's: {worst}")
            need(len(taken) == 1 and len(runs[0]["taken"]) == len(
                GRID_SWEEP_KS), f"{name}: the ranks' refits differ")
            need(len(runs[0]["writes"]) == len(GRID_SWEEP_KS)
                  and not any(run["writes"] for run in runs[1:]),
                  f"{name}: results written by "
                  f"{[len(run['writes']) for run in runs]}")
            need(ftype != "npz" or all(run["ell"] for run in runs),
                  f"{name}: a rank's members are not on the ELL")
            need([run["launches"] for run in runs] == want,
                  f"{name} launched {[run['launches'] for run in runs]}, "
                  f"not {want}")
            for run in runs:
                for key, n in run["launches"].items():
                    main_path[key] += n
        check(not failed, "; ".join(failed))
    print(f"[ensemble] phase 9 in {time.perf_counter() - t_phase:.1f} s",
          flush=True)


# -- the [k-sweep] phase: the K-padded NMFk sweep on one card -------------
KSWEEP_KS = range(2, 8)         # the ks of phases 3 and 5's sweeps
PAD_K, PAD_KK = 3, 7            # the padded stack: k = 3 active of K = 7
# each library sweep: (the per-k sweep it is held against, its input,
# NMFConfig keywords, k_sweep_merge); 10 members, 400 iterations, the
# per-k sweeps' seeds
KSWEEPS = {
    "planted FRO-MU K-padded": ("planted FRO-MU", "X", dict(norm="fro"),
                                False),
    "planted FRO-MU merged": ("planted FRO-MU", "X", dict(norm="fro"), True),
    "planted KL-MU merged": ("planted KL-MU", "X", dict(norm="kl"), True),
    "planted KL-MU use_fused bf16 merged": (
        "planted KL-MU use_fused bf16", "X",
        dict(norm="kl", use_fused=True, a_precision="bfloat16"), True),
    "topic FRO-MU merged": ("topic FRO-MU", "T", dict(norm="fro"), True)}
KSWEEP_MEMBERS, KSWEEP_ITR = 10, 400
# a member's error against the same member's in the per-k sweep, relative:
# at least this, or twice the spread of two per-k sweeps of the same
# members where a second ran (phase 6's FRO, phase 3's second use_fused
# bf16 sweep): K1's and K3's atomics open such a spread (K3 on bf16
# members 8.21e-4 over 400 iterations on an H100 80GB HBM3 at 700 W); the
# per-k statistics likewise: phase 9's limits, or twice the two per-k
# sweeps' own difference where it is larger
KSWEEP_MEMBER_TOL = 1e-4
KSWEEP_STAT_TOL = {"ErrTol": 1e-3, "avgErr": 1e-3, "L_err": 1e-2,
                   "sils": 1e-3}
# the use_fused bf16 sweep, three per-k runs and two merged of the same
# members (bench_torch/bf16_sweep_spread_probe.py, H100 80GB HBM3, 700 W):
# K3's f32 atomics move a member's error by up to 1.18e-3 from one per-k
# run to the next (the per-k pair of phase 3 saw 8.21e-4, and the merged
# sweep 1.89e-3 from the per-k one); at k = 6 one per-k run of four
# clustered a member into the other cluster (L_err 0.276, a silhouette
# 1.31 from the first run), while at every other k L_err stayed within
# 2.02e-3 and the silhouettes within 3.94e-4 (ROADMAP queue 3)
BF16_SWEEP_SPREAD = 1.18e-3
BF16_SWEEP_FLIP_KS = (6,)


def ksweep_solves(batch, merged, ks=KSWEEP_KS, n=KSWEEP_MEMBERS):
    """The batched solves of a [k-sweep] sweep of ``batch`` members a
    batch: ceil(n / batch) a k, or merged, each k's chunks packed in k
    order into batches of at most ``batch`` members, as
    ``models/nmfk.py::NMFk._solve_ensembles_merged`` packs them."""
    chunks = [min(batch, n - off) for _ in ks for off in range(0, n, batch)]
    if not merged:
        return len(chunks)
    solves, room = 0, 0
    for size in chunks:
        if size > room:
            solves, room = solves + 1, batch
        room -= size
    return solves


def ksweep_launches(norm, ftype, fused, solves, ks=KSWEEP_KS,
                    itr=KSWEEP_ITR):
    """Exact launches of a [k-sweep] sweep at K = 7's dispatch: K1, K2a +
    K2b, or K3 (bf16 members) once a step of each batched solve, K4 twice
    a step and once for its error; the W-frozen refit of each k K2b once a
    step (KL), K4 once a step and twice for its errors (sparse), nothing
    for dense FRO."""
    if ftype == "T":
        return {"ell_gather": solves * (2 * itr + 1) + len(ks) * (itr + 2)}
    if norm == "fro":
        return {"fused_mu_fro": solves * itr}
    if fused:
        return {"fused_mu_kl_bf16": solves * itr, "kl_wtu": len(ks) * itr}
    return {"kl_uht": solves * itr, "kl_wtu": (solves + len(ks)) * itr}


def ksweep_diffs(got, ref, ks=KSWEEP_KS):
    """How far one sweep's per-k results lie from another's: (the largest
    relative difference of a member's error, by statistic the largest
    difference over the largest value; the silhouettes absolute)."""
    member = 0.0
    worst = {key: 0.0 for key in KSWEEP_STAT_TOL}
    for kk in ks:
        a, b = got[kk], ref[kk]
        member = max(member, float(np.max(np.abs(
            a["ErrTol"] / b["ErrTol"] - 1))))
        for key in ("ErrTol", "avgErr", "L_err"):
            worst[key] = max(worst[key], float(np.max(
                np.abs(a[key] - b[key]) / np.abs(b[key]).max())))
        worst["sils"] = max(worst["sils"], float(np.max(np.abs(
            a["clusterSilhouetteCoefficients"]
            - b["clusterSilhouetteCoefficients"]))))
    return member, worst


def k_sweep_phase(dev, smi, gen, refs, zero_counts, read_counts):
    """The [k-sweep] phase: the kernels on a K-padded stack, then the
    K-padded NMFk sweeps of KSWEEPS through the library against ``refs``
    (by name: the per-k sweep's results at KSWEEP_KS, its seconds, its
    stage seconds and, where one ran, a second per-k sweep's results of
    the same members); each sweep's launches go to ``read_counts``."""
    from scipy import sparse as sp
    from pydnmfk_tpu_torch import NMFConfig, NMFk, NMFkConfig
    from pydnmfk_tpu_torch.ops import ell, ell_gather, fused_kl, fused_mu, kl
    from pydnmfk_tpu_torch.ops import linalg, sparse
    from pydnmfk_tpu_torch.utils import timing
    from pydnmfk_tpu_torch.utils.data_generator import (generate_data,
                                                        generate_topic_sparse)
    from pydnmfk_tpu_torch.utils.io import DataReader, read_cluster_results
    t_phase = time.perf_counter()
    eps = float(torch.finfo(torch.float32).eps)
    k, K = PAD_K, PAD_KK
    failed = []
    need = lambda cond, msg: cond or failed.append(msg)

    def pad(W, H):
        return (torch.nn.functional.pad(W, (0, K - k)),
                torch.nn.functional.pad(H, (0, 0, 0, K - k)))

    def padded_case(label, kernel, plain, W, H, tol):
        """kernel(W, H) on the padded factors against itself on the
        unpadded ones and against plain() on the padded ones; every
        output's columns (or rows) past k exactly 0. Both timed."""
        Wp, Hp = pad(W, H)
        out, unpadded, ref = kernel(Wp, Hp), kernel(W, H), plain(Wp, Hp)
        active, zero = [], True
        for x, u in zip(out, unpadded):
            sl = [slice(None)] * x.dim()
            for a in (-2, -1):
                if x.shape[a] != u.shape[a]:
                    rest = list(sl)
                    rest[a] = slice(k, None)
                    zero = zero and not bool(x[tuple(rest)].any())
                    sl[a] = slice(None, k)
            active.append(x[tuple(sl)])
        _, rel_u = compare(tuple(active), unpadded)
        _, rel_p = compare(out, ref)
        del out, unpadded, ref, active
        ms_p = median_ms(lambda: kernel(Wp, Hp))
        ms_u = median_ms(lambda: kernel(W, H))
        print(f"[k-sweep] {label} k={k} padded to K={K}: inactive columns "
              f"exactly 0: {zero}; active columns against the unpadded "
              f"call, max rel err {rel_u:.3e}, against the plain version "
              f"{rel_p:.3e} (tol {tol:g}); padded {ms_p:.3f} ms, unpadded "
              f"{ms_u:.3f} ms ({smi})", flush=True)
        need(zero, f"{label}: an inactive column is not 0")
        need(rel_u <= tol and rel_p <= tol,
             f"{label}: {rel_u:.3e} / {rel_p:.3e} > {tol:g}")

    # K1, K2a, K2b and K3 on a 10-member stack of the planted matrix's
    # perturbed copies, f32 and bf16; K4 on the topic stack's ELL
    _, _, X = generate_data(**PLANTED)
    Xt = torch.from_numpy(X.astype(np.float32)).to(dev)
    A = Xt * (1 + 0.03 * torch.rand((ENS,) + tuple(Xt.shape), generator=gen,
                                    device=dev))
    W = torch.rand((ENS, Xt.shape[0], k), generator=gen, device=dev)
    H = torch.rand((ENS, k, Xt.shape[1]), generator=gen, device=dev)
    del Xt
    shape = f"{ENS} x {PLANTED['m']}x{PLANTED['n']}"
    hrs = lambda H: linalg.sum_axis(H, axis=-1).float()
    for a in (A, A.to(torch.bfloat16)):
        tag = {torch.float32: "f32", torch.bfloat16: "bf16"}[a.dtype]
        tol = TOL[a.dtype]
        padded_case(f"K1 fused_mu_fro {tag} A {shape}",
                    lambda W, H: fused_mu.fused_w_pass(
                        a, W, H, linalg.gram_t(H), eps),
                    lambda W, H: fused_mu.fused_w_pass_plain(
                        a, W, H, linalg.gram_t(H), eps), W, H, tol)
        ch = linalg.error_chunk_rows(*a.shape[-2:])
        padded_case(f"K2a kl_uht {tag} A {shape}",
                    lambda W, H: (kl.kl_uht(a, W, H, eps),),
                    lambda W, H: (kl.kl_uht_plain(a, W, H, eps, ch),),
                    W, H, TOL[torch.float32])
        padded_case(f"K2b kl_wtu {tag} A {shape}",
                    lambda W, H: (kl.kl_wtu(a, W, H, eps),),
                    lambda W, H: (kl.kl_wtu_plain(a, W, H, eps, ch),),
                    W, H, TOL[torch.float32])
        padded_case(f"K3 fused_mu_kl {tag} A {shape}",
                    lambda W, H: fused_kl.fused_kl_pass(a, W, H, hrs(H), eps),
                    lambda W, H: fused_kl.fused_kl_pass_plain(
                        a, W, H, hrs(H), eps, ch), W, H, tol)
        del a
    del A, W, H
    torch.cuda.empty_cache()
    r, c, v, tshape = generate_topic_sparse(**TOPIC, seed=7)
    topic = sparse.from_coo(*(torch.from_numpy(x).to(dev) for x in (r, c, v)),
                            tshape)
    Et, *perms = ell.ell_pack(topic, return_perms=True)
    stack = ell.ell_with_data(Et, *perms, topic.data * (
        1.0 + 0.03 * torch.rand((ENS, topic.nse), generator=gen,
                                device=dev)))
    W = torch.rand((ENS, tshape[0], k), generator=gen, device=dev)
    H = torch.rand((ENS, k, tshape[1]), generator=gen, device=dev)
    for label, vals, idx, table, other in (
            ("rows plain", stack.rvals, stack.rcols, "Ht", None),
            ("columns plain", stack.cvals, stack.crows, "W", None),
            ("rows ratio", stack.rvals, stack.rcols, "Ht", "W"),
            ("columns ratio", stack.cvals, stack.crows, "W", "Ht")):
        pick = lambda name, W, H: (None if name is None else W if name == "W"
                                   else H.mT.contiguous())
        padded_case(f"K4 ell_gather {label} {ENS} x {tshape[0]}x{tshape[1]} "
                    f"({topic.nse} nnz)",
                    lambda W, H: (ell_gather.ell_gather_product(
                        vals, idx, pick(table, W, H), pick(other, W, H),
                        eps),),
                    lambda W, H: (ell_gather.ell_gather_product_plain(
                        vals, idx, pick(table, W, H), pick(other, W, H),
                        eps),), W, H, TOL[torch.float32])
    del topic, Et, perms, stack, W, H
    torch.cuda.empty_cache()

    # the K-padded sweeps through the library, beside the per-k sweeps
    timing.enable(True)
    with tempfile.TemporaryDirectory() as tmp:
        np.save(os.path.join(tmp, "X.npy"), X.astype(np.float32))
        sp.save_npz(os.path.join(tmp, "T.npz"),
                    sp.csr_matrix((v, (r, c)), shape=tshape),
                    compressed=False)
        del X, r, c, v
        inputs = {"X": DataReader(tmp + "/", "X", "npy").read(),
                  "T": DataReader(tmp + "/", "T", "npz").read()}
        for name, (ref_name, fname, nmf_kw, merged) in KSWEEPS.items():
            ref, ref_secs, ref_stages, *rerun = refs[ref_name]
            cfg = NMFkConfig(nmf=NMFConfig(itr=KSWEEP_ITR, **nmf_kw),
                             start_k=KSWEEP_KS[0], end_k=KSWEEP_KS[-1],
                             perturbations=KSWEEP_MEMBERS,
                             k_sweep_batch=True, k_sweep_merge=merged,
                             results_path=os.path.join(tmp, name) + "/",
                             fname=fname, checkpoint=True)
            torch.cuda.empty_cache()
            timing.reset()
            zero_counts()
            t0 = time.perf_counter()
            model = NMFk(cfg, dev)
            nopt = model.fit(inputs[fname])
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            ran = {key: n for key, n in read_counts().items() if n}
            stages = {st: round(timing.TIMINGS.get(st, 0.0), 3) for st in
                      ("sparse_format", "ensemble_solve", "ensemble_init",
                       "clustering", "regression")}
            solves = ksweep_solves(model.last_batch_size, merged)
            want = ksweep_launches(nmf_kw["norm"], fname,
                                   nmf_kw.get("use_fused", False), solves)
            got = {kk: read_cluster_results(os.path.join(
                cfg.results_path, fname, str(kk))) for kk in KSWEEP_KS}
            member, worst = ksweep_diffs(got, ref)
            spread, twice = ksweep_diffs(rerun[0], ref) if rerun else (
                0.0, {key: 0.0 for key in KSWEEP_STAT_TOL})
            tol = max(KSWEEP_MEMBER_TOL, 2 * spread)
            limits = {key: max(lim, 2 * twice[key])
                      for key, lim in KSWEEP_STAT_TOL.items()}
            scope = ""
            if nmf_kw.get("a_precision") == "bfloat16":
                # bf16 members under K3's f32 atomics: the errors are held
                # to twice the largest spread of repeated per-k runs at
                # every k, the clustering's statistics at every k but the
                # one where a repeated run changed a member's cluster
                kept = [kk for kk in KSWEEP_KS if kk not in BF16_SWEEP_FLIP_KS]
                flip = ksweep_diffs(got, ref, BF16_SWEEP_FLIP_KS)[1]
                worst = {**ksweep_diffs(got, ref, kept)[1],
                         "ErrTol": worst["ErrTol"], "avgErr": worst["avgErr"]}
                tol = max(tol, 2 * BF16_SWEEP_SPREAD)
                for key in ("ErrTol", "avgErr"):
                    limits[key] = max(limits[key], 2 * BF16_SWEEP_SPREAD)
                scope = (f" (L_err and silhouettes at k = {kept}; at k = "
                         f"{list(BF16_SWEEP_FLIP_KS)}, not checked: L_err "
                         f"{flip['L_err']:.2e}, silhouettes "
                         f"{flip['sils']:.2e})")
            left = [kk for kk in KSWEEP_KS if os.path.exists(os.path.join(
                cfg.results_path, fname, str(kk), "ensemble_parts"))]
            print(f"[k-sweep] {name} ({fname}, k={KSWEEP_KS[0]}.."
                  f"{KSWEEP_KS[-1]} at K={KSWEEP_KS[-1]}, {KSWEEP_MEMBERS} "
                  f"members, {KSWEEP_ITR} iterations; {smi}): nopt {nopt}, "
                  f"batch {model.last_batch_size} ({solves} batched "
                  f"solves), {secs:.2f} s (per-k {ref_secs:.2f} s), stage "
                  f"seconds {stages} (per-k {ref_stages}); members' errors "
                  f"against the per-k sweep's, max relative difference "
                  f"{member:.2e} (limit {tol:.2e}; two per-k sweeps of "
                  f"these members " + (f"{spread:.2e}" if rerun else
                                       "not run")
                  + f"); per-k statistics{scope}, max difference over max "
                  f"(silhouettes: absolute) {worst} (limits {limits}; two "
                  f"per-k sweeps " + (f"{twice}" if rerun else "not run")
                  + f"); parts left {left}; launches {ran} "
                  f"(expected {want})", flush=True)
            need(nopt == 4, f"{name} chose k={nopt}, not 4")
            need(member <= tol, f"{name}: a member's error is {member:.2e} "
                                f"from the per-k member's")
            need(all(worst[key] <= limits[key] for key in limits),
                 f"{name}: stats are not the per-k sweep's: {worst}")
            need(not left, f"{name}: ensemble_parts/ left at ks {left}")
            need(ran == want, f"{name} launched {ran}, not {want}")
            del model
        del inputs
    check(not failed, "; ".join(failed))
    print(f"[k-sweep] phase in {time.perf_counter() - t_phase:.1f} s",
          flush=True)


# -- phase 11: the examples on the card -----------------------------------
# The reference's sample data, wtsi.mat (96 x 21 uint16) and swim.mat
# (1024 x 256 uint8), are not in the checkout: each example that reads one
# runs on a stand-in of its shape and dtype drawn from a seed
# (utils/data_generator.py::generate_disjoint: disjoint-support W, so that
# the planted k is unambiguous): wtsi's at rank 4, swim's at rank 16 with
# about 35 % zeros (nmfk_swim), and a rank-4 swim for quantized_swim and
# sparse_npz, whose error bound comes from the dense run on the same file
EX_WTSI = dict(m=96, n=21, k=4, vmax=2000, dtype=np.uint16, seed=1)
EX_SWIM = dict(m=1024, n=256, k=16, zeros=0.35, vmax=255, dtype=np.uint8,
               seed=2)
EX_SWIM4 = dict(m=1024, n=256, k=4, zeros=0.35, vmax=255, dtype=np.uint8,
                seed=3)
EX_FOLDER = dict(m=1001, n=257, k=4)     # the generator CLI's 2 x 2 folder
# multihost_nmfk's ks, cut from its own 1..8: at 1000 iterations each MU
# step's all-reduces over gloo between two ranks on one card take 78.6 s a
# rank on an H100 80GB HBM3 at 700 W, 47.6 at ks 1..5. Each k's members
# are its own, so ks 3..5 are the full sweep's, and the walk compares
# k = 4 and 5 as it does there (k = 1 runs in nmfk_wtsi); 250 iterations
# chose 3, not 4, so the iterations stay
EX_MULTIHOST_KS = (3, 5)


def example_rank(outdir, argv):
    """One rank of phase 11's ``multihost_nmfk`` under torchrun
    (``python3 chip_smoke.py --example-rank OUTDIR ARGS``): the example's
    ``main(ARGS)`` with the launch counters from zero, then this rank's
    nopt, launches and seconds in ``outdir/example_rank{r}.json``."""
    sys.path.insert(0, ROOT)
    from pydnmfk_tpu_torch.examples import multihost_nmfk
    rank = int(os.environ["RANK"])
    counters = _rank_counters()
    for c in counters:
        for key in c:
            c[key] = 0
    t0 = time.perf_counter()
    nopt = multihost_nmfk.main(argv)
    torch.cuda.synchronize()
    with open(os.path.join(outdir, f"example_rank{rank}.json"), "w") as f:
        json.dump({"nopt": nopt, "secs": time.perf_counter() - t0,
                   "launches": {k: v for c in counters
                                for k, v in c.items() if v}}, f)


def examples_phase(dev, smi, gen, kernel_case, zero_counts, read_counts):
    """Phase 11, ``[examples]``: K1 at k = 1 against its plain version;
    the data generator's CLI, read back bitwise; then the nine examples of
    ``pydnmfk_tpu_torch/examples`` on the card through their ``main``,
    eight in this process with the launch counters and stage timers from
    zero before each, ``multihost_nmfk`` under torchrun on a 2 x 1 grid
    of two ranks sharing the card over gloo, after them; each with its
    answer (nopt, or its error assertion), exact launches (from the
    batches its sweep took and the format the sparse policy picked) and
    its seconds."""
    import shutil
    from scipy.io import savemat
    from pydnmfk_tpu_torch import NMFConfig, NMFk, NMFkConfig
    from pydnmfk_tpu_torch.examples import (large_scale, nmfk_large,
                                            nmfk_swim, nmfk_wtsi,
                                            quantized_swim, runner_example,
                                            sparse_ell_beyond_hbm,
                                            sparse_npz)
    from pydnmfk_tpu_torch.models import nmf as nmf_mod
    from pydnmfk_tpu_torch.ops import fused_mu, linalg, sparse
    from pydnmfk_tpu_torch.parallel.partition import partition_slices
    from pydnmfk_tpu_torch.utils import memory, timing
    from pydnmfk_tpu_torch.utils.data_generator import (generate_data,
                                                        generate_disjoint)
    from pydnmfk_tpu_torch.utils.io import DataReader, to_numpy

    t_phase = time.perf_counter()
    eps = float(torch.finfo(torch.float32).eps)
    # K1 at k = 1, one live column in its KP = 8 tile: on nmfk_wtsi's
    # ensemble at k = 1 (20 members of 96 x 21) and on a 14400 x 9600 A
    for label, shp in (("f32 20 x 96x21 k=1 (nmfk_wtsi's ensemble)",
                        (20, 96, 21)), ("f32 14400x9600 k=1", (14400, 9600))):
        A = torch.rand(shp, generator=gen, device=dev)
        W = torch.rand((*shp[:-1], 1), generator=gen, device=dev)
        H = torch.rand((*shp[:-2], 1, shp[-1]), generator=gen, device=dev)
        HHT = linalg.gram_t(H)
        kernel_case("K1 fused_mu_fro", label,
                    lambda: fused_mu.fused_w_pass(A, W, H, HHT, eps),
                    lambda: fused_mu.fused_w_pass_plain(A, W, H, HHT, eps),
                    TOL[torch.float32],
                    (4 * A.numel(), nbytes(A, W, H, HHT, W, H, HHT)),
                    library=lambda: (torch.matmul(A, H.mT),
                                     torch.matmul(W.mT, A)))
        del A, W, H, HHT
    torch.cuda.empty_cache()

    tmp = tempfile.mkdtemp(prefix="chip_smoke_examples_")
    real_batch = NMFk._ensemble_batch_size
    batches = []          # the batch of every per-k ensemble, in order

    def spy(self, A, k, cap=None):
        batch = real_batch(self, A, k, cap)
        batches.append(batch)
        return batch

    NMFk._ensemble_batch_size = spy
    try:
        # the data generator's CLI (the JAX package's flags) writes a 2 x 2
        # folder of uneven chunks, which the folder reader reads back
        folder = os.path.join(tmp, "folder") + "/"
        gm, gn, gk = EX_FOLDER["m"], EX_FOLDER["n"], EX_FOLDER["k"]
        subprocess.run([sys.executable, "-m",
                        "pydnmfk_tpu_torch.utils.data_generator", "--p_r=2",
                        "--p_c=2", f"--m={gm}", f"--n={gn}", f"--k={gk}",
                        f"--fpath={folder}"], cwd=ROOT, check=True,
                       timeout=300)
        Wg, Hg, Xg = generate_data(gm, gn, gk)
        back = DataReader(folder, "X_", "folder", precision="float64",
                          pgrid=(2, 2)).read()
        same = np.array_equal(back, Xg) and all(
            np.array_equal(np.load(f"{folder}X_{r}.npy"), Xg[rs, cs])
            and np.array_equal(np.load(f"{folder}W_{r}.npy"), Wg[rs])
            and np.array_equal(np.load(f"{folder}H_{r}.npy"), Hg[:, cs])
            for r, (rs, cs) in enumerate(partition_slices((2, 2), Xg.shape)))
        print(f"[examples] python -m pydnmfk_tpu_torch.utils.data_generator "
              f"--p_r=2 --p_c=2 --m={gm} --n={gn} --k={gk}: "
              f"{len(os.listdir(folder))} chunk files, read back bitwise: "
              f"{same}", flush=True)
        check(same, "the data generator's folder is not X, bitwise")

        # the stand-ins of the sample data
        data, data4 = (os.path.join(tmp, d) + "/" for d in ("data", "data4"))
        for d, name, spec in ((data, "wtsi", EX_WTSI),
                              (data, "swim", EX_SWIM),
                              (data4, "swim", EX_SWIM4)):
            os.makedirs(d, exist_ok=True)
            X = generate_disjoint(**spec)
            savemat(f"{d}{name}.mat", {"X": X})
            print(f"[examples] stand-in {d[len(tmp) + 1:]}{name}.mat: "
                  f"{X.shape[0]}x{X.shape[1]} {X.dtype}, planted rank "
                  f"{spec['k']}, {float((X == 0).mean()):.3f} zeros",
                  flush=True)
        def run(name, call, want):
            """Runs one example; ``want(batches)`` gives its launches."""
            zero_counts()
            timing.enable(True)
            timing.reset()
            batches.clear()
            t0 = time.perf_counter()
            out = call()
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            ran = read_counts()
            stages = {st: round(v, 3) for st, v in timing.TIMINGS.items()}
            timing.enable(False)
            expect = {**{key: 0 for key in ran}, **want(list(batches))}
            live = lambda d: {key: v for key, v in d.items() if v}
            shown = ({key: v for key, v in out.items() if key != "per_k_stats"}
                     if isinstance(out, dict) else out)
            print(f"[examples] {name} ({smi}): {secs:.2f} s, stage seconds "
                  f"{stages}, ensemble batches {batches}, launches "
                  f"{live(ran)} (expected {live(expect)}), returned {shown}",
                  flush=True)
            check(ran == expect, f"example {name} launched {live(ran)}, "
                                 f"expected {live(expect)}")
            return out

        def solves(b, members):
            """Batched solves of a per-k sweep of ``members`` members whose
            ks took the batches ``b``."""
            return sum(-(-members // x) for x in b)

        # 1. large_scale: FRO-MU's 200 steps through K1, HALS and BCD none
        run("large_scale", lambda: large_scale.main(device=dev),
            lambda b: {"fused_mu_fro": 200})
        torch.cuda.empty_cache()
        # 2. quantized_swim on the rank-4 swim: K1 on f32, K1-u8 on uint8
        e32, _ = run("quantized_swim",
                     lambda: quantized_swim.main(data4, device=dev),
                     lambda b: {"fused_mu_fro": 200, "fused_mu_fro_u8": 200})
        # 3-4. nmfk_wtsi and runner_example from k = 1: K1 at each k, batch
        # and iteration; nnsvd init and the W-frozen refit none
        wtsi_ks = range(1, 9)
        for name, call in (
                ("nmfk_wtsi", lambda: nmfk_wtsi.main(
                    data, os.path.join(tmp, "res_wtsi") + "/", device=dev)),
                ("runner_example", lambda: runner_example.main(
                    data, os.path.join(tmp, "res_runner") + "/",
                    device=dev))):
            run(name, call,
                lambda b: {"fused_mu_fro": solves(b, 20) * 1000})
            check(len(batches) == len(wtsi_ks), f"{name}: {batches}")
            ncfg = NMFConfig(itr=1000, norm="fro", init="nnsvd")
            model = [memory.auto_ensemble_batch(96, 21, k, 20, ncfg,
                                                device=dev) for k in wtsi_ks]
            print(f"[examples] {name}: utils/memory.py's batches {model}",
                  flush=True)
            check(batches == model, f"{name}: the sweep's batches {batches} "
                                    f"are not utils/memory.py's {model}")
        # 5. nmfk_swim (KL, seed_grid 2 x 2): K2a in the ensemble, K2b in
        # the ensemble and the W-frozen refit
        run("nmfk_swim",
            lambda: nmfk_swim.main(data, os.path.join(tmp, "res_swim") + "/",
                                   device=dev),
            lambda b: {"kl_uht": solves(b, 20) * 5000,
                       "kl_wtu": (solves(b, 20) + len(b)) * 5000})
        # 6. nmfk_large: bf16 members through K1-bf16; the refit none
        run("nmfk_large",
            lambda: nmfk_large.main(
                device=dev, results_path=os.path.join(tmp, "res_large") + "/"),
            lambda b: {"fused_mu_fro_bf16": solves(b, 10) * 400})
        torch.cuda.empty_cache()
        # 7. sparse_ell_beyond_hbm: KL-MU on the ELL (K4: 1 plain, 2 ratio
        # an iteration), then on the dense form (K2a and K2b an iteration):
        # the card's policy would pack the triplet into the same ELL
        T = sparse_ell_beyond_hbm.planted_sparse_coo(3000, 2400, 4,
                                                     keep=0.01).to(dev)
        print(f"[examples] sparse_ell_beyond_hbm: the policy runs the "
              f"3000x2400 triplet ({T.nse} nnz) as "
              f"{sparse_ell_beyond_hbm.format_name(T)} on the card, so the "
              f"example's second solve takes the dense form", flush=True)
        del T
        run("sparse_ell_beyond_hbm",
            lambda: sparse_ell_beyond_hbm.main(device=dev),
            lambda b: {**k4_fit_launches("kl", 400),
                       "kl_uht": 400, "kl_wtu": 400})
        # 8. sparse_npz on the rank-4 swim: its npz factorization within
        # 0.01 of quantized_swim's dense f32 error on the same file, then
        # sparse NMFk on the planted 80 x 60, each in the policy's format
        X4 = generate_disjoint(**EX_SWIM4).astype(np.float32)
        r, c = np.nonzero(X4)
        npz_fmt = sparse.densify_for_backend(sparse.from_coo(
            torch.from_numpy(r.astype(np.int32)),
            torch.from_numpy(c.astype(np.int32)),
            torch.from_numpy(X4[r, c]), X4.shape).to(dev), k_hint=4)
        P = sparse_npz.planted_sparse()
        r, c = np.nonzero(P)
        nmfk_fmt = sparse.densify_for_backend(sparse.from_coo(
            torch.from_numpy(r.astype(np.int32)),
            torch.from_numpy(c.astype(np.int32)),
            torch.from_numpy(P[r, c]), P.shape).to(dev), k_hint=5)
        dense = not (linalg.is_sparse(npz_fmt) or linalg.is_sparse(nmfk_fmt))
        print(f"[examples] sparse_npz: the policy runs the swim npz as "
              f"{'dense' if not linalg.is_sparse(npz_fmt) else 'sparse'} "
              f"and the planted 80x60 as "
              f"{'dense' if not linalg.is_sparse(nmfk_fmt) else 'sparse'} "
              f"on the card", flush=True)
        check(dense, "sparse_npz: the policy kept a sparse format, for "
                     "which this phase derives no launch count")
        del npz_fmt, nmfk_fmt
        # the planted 80 x 60's choice of k depends on the draws, in the
        # JAX package too (k = 3's least silhouette lies near the gate), so
        # the card's sparse NMFk is held to its own members solved again on
        # the CPU (nopt, and the per-k statistics within phase 9's limits),
        # not to the JAX example's answer for the JAX package's draws
        caught = {}
        real_solve = nmf_mod.solve

        def solve_spy(A_ens, W0, H0, *a, **kw):
            if W0.dim() == 3:            # an ensemble's batched solve
                caught[W0.shape[-1]] = tuple(x.cpu()
                                             for x in (A_ens, W0, H0))
            return real_solve(A_ens, W0, H0, *a, **kw)

        nmf_mod.solve = solve_spy
        try:
            out = run("sparse_npz",
                      lambda: sparse_npz.main(
                          data4, device=dev,
                          err_range=(e32 - 0.01, e32 + 0.01),
                          nmfk_expected=None),
                      lambda b: {"fused_mu_fro": 200,
                                 "kl_uht": solves(b, 6) * 300,
                                 "kl_wtu": (solves(b, 6) + len(b)) * 300})
        finally:
            nmf_mod.solve = real_solve
        cpu = NMFk(NMFkConfig(
            nmf=NMFConfig(k=0, norm="kl", method="mu", itr=300, init="rand",
                          seed=42), start_k=2, end_k=5, perturbations=6,
            noise_var=0.03, sill_thr=0.6,
            results_path=os.path.join(tmp, "res_npz_cpu"), fname="sp",
            checkpoint=False), "cpu")
        os.makedirs(cpu.results_path, exist_ok=True)
        At = torch.from_numpy(P)
        for k in sorted(caught):
            cpu.pynmfk_per_k(At, k, ensemble=cpu._solve_ensemble(
                At, k, members=caught[k]))
        nopt_cpu = cpu.pvalue_analysis()

        def as_results(stats):
            return {k: {"ErrTol": to_numpy(st["recon_err"]),
                        "avgErr": np.asarray(st["avgErr"]),
                        "L_err": to_numpy(st["L_err"]),
                        "clusterSilhouetteCoefficients": to_numpy(
                            st["clusterSilhouetteCoefficients"])}
                    for k, st in stats.items()}

        card = as_results(out["per_k_stats"])
        member, worst = ksweep_diffs(card, as_results(cpu.per_k_stats),
                                     sorted(caught))
        least = {k: round(float(np.min(st["clusterSilhouetteCoefficients"])),
                          4) for k, st in card.items()}
        print(f"[examples] sparse_npz's sparse NMFk on the card: nopt "
              f"{out['nopt']} (the JAX example's 3 is its draws' answer), "
              f"least silhouette by k {least}; "
              f"the card's members solved on the CPU: nopt {nopt_cpu}, "
              f"members' errors within {member:.2e}, per-k statistics "
              f"{worst} (limits {KSWEEP_STAT_TOL})", flush=True)
        check(nopt_cpu == out["nopt"] and sorted(caught) == [2, 3, 4, 5]
              and all(worst[key] <= tol
                      for key, tol in KSWEEP_STAT_TOL.items()),
              "sparse_npz's sparse NMFk on the card is not its members' "
              "on the CPU")

        # 9. multihost_nmfk: two ranks of a 2 x 1 grid sharing the card over
        # gloo (their own processes count their own launches); FRO-MU on a
        # grid runs the plain products (no launch)
        k0, k1 = EX_MULTIHOST_KS
        print(f"[examples] reduced: multihost_nmfk ks 1..8 -> {k0}..{k1} "
              f"(depth only; the shapes are the example's)", flush=True)
        out, secs = torchrun([os.path.abspath(__file__), "--example-rank",
                              tmp, f"--fpath={data}",
                              f"--results={tmp}/res_mh/", f"--start_k={k0}",
                              f"--end_k={k1}"], 900, nproc=2)
        ranks = []
        for rank in range(2):
            with open(os.path.join(tmp, f"example_rank{rank}.json")) as f:
                ranks.append(json.load(f))
        lines = [line for line in out.splitlines() if "estimated k" in line]
        print(f"[examples] multihost_nmfk under torchrun, 2 ranks on a 2x1 "
              f"grid sharing the card over gloo ({smi}): {secs:.2f} s for "
              f"the torchrun, rank seconds "
              f"{[round(r['secs'], 2) for r in ranks]} (they time the code "
              f"and gloo on one card, not two cards), nopt "
              f"{[r['nopt'] for r in ranks]}, launches "
              f"{[r['launches'] for r in ranks]} (expected none), {lines}",
              flush=True)
        check(all(r["nopt"] == 4 and not r["launches"] for r in ranks)
              and len(lines) == 2, "multihost_nmfk")
    finally:
        NMFk._ensemble_batch_size = real_batch
        timing.enable(False)
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"[examples] phase 11 in {time.perf_counter() - t_phase:.1f} s",
          flush=True)


def torchrun_start(args, nproc=GRID_RANKS):
    """Starts ``python -m torch.distributed.run --standalone
    --nproc_per_node=4 ARGS`` (``nproc`` processes) from the checkout, in a
    session of its own; returns (process, start time, ARGS)."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc_per_node={nproc}", *args]
    env = dict(os.environ, OMP_NUM_THREADS="2")
    return (subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True,
                             start_new_session=True),
            time.perf_counter(), args)


def torchrun_stop(started):
    """Kills a started torchrun's session, if it still runs."""
    import signal
    proc = started[0]
    if proc.poll() is None:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()


def torchrun_wait(started, timeout):
    """Waits for a started torchrun, whose session is killed whole if it
    outlives ``timeout`` s; fails unless it exits 0. Returns (stdout,
    seconds since it started)."""
    proc, t0, args = started
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        torchrun_stop(started)
        check(False, f"torchrun {' '.join(args[:3])} outlived {timeout} s")
    secs = time.perf_counter() - t0
    check(proc.returncode == 0, f"torchrun {' '.join(args[:3])} exited "
                                f"{proc.returncode}: {err[-4000:]}")
    return out, secs


def torchrun(args, timeout, nproc=GRID_RANKS):
    """:func:`torchrun_start` and :func:`torchrun_wait`: (stdout,
    seconds)."""
    return torchrun_wait(torchrun_start(args, nproc), timeout)


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device")
    sys.path.insert(0, ROOT)
    from pydnmfk_tpu_torch import NMF, NMFConfig, NMFk, NMFkConfig, cli
    from pydnmfk_tpu_torch.models import updates
    from pydnmfk_tpu_torch.models.nmf import init_factors_rand
    from pydnmfk_tpu_torch.models.svd import DistSVD
    from pydnmfk_tpu_torch.ops import (cuda_lib, ell, ell_gather, fused_kl,
                                       fused_mu, kl, linalg, sparse)
    from pydnmfk_tpu_torch.utils import timing
    from pydnmfk_tpu_torch.utils.data_generator import (generate_data,
                                                        generate_topic_sparse)
    from pydnmfk_tpu_torch.utils.io import RESULT_DATASETS, read_cluster_results

    torch.backends.cuda.matmul.allow_tf32 = False     # true-f32 products
    torch.backends.cudnn.allow_tf32 = False
    # half products summed in f32, as the kernels and the port's products
    # sum them: every library row is timed under these settings
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction = False
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
        for c in counters + (kl.tc_launches, ell_gather.wide_launches,
                             ell_gather.slab_launches,
                             fused_kl.wide_launches):
            for key in c:
                c[key] = 0

    # of them, K2's, K3's and K4's at k > 32 (the 3xTF32 kernels, K3's
    # kernels at KP = 64, the slab kernels), which the wrappers count apart
    # by the same keys
    wide_counters = (kl.tc_launches, fused_kl.wide_launches,
                     ell_gather.wide_launches)

    def wide_counts():
        return {k: v for c in wide_counters for k, v in c.items()}

    main_path = {key: 0 for key in counts()}     # launches on the main path
    main_path_wide = {key: 0 for key in wide_counts()}

    def read_counts():
        ran = counts()
        for key, n in ran.items():
            main_path[key] += n
        for key, n in wide_counts().items():
            main_path_wide[key] += n
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
    # instantiation (f32; tensor cores for bf16, f16 and uint8; KP = k
    # padded to 8, 16, 32, 64; vec: 16-byte loads or copies)
    regs = ptxas_k1(cuda_lib.library_path("fused_mu_fro").with_suffix(
        ".log").read_text())
    for dtype in ("f32", "bf16", "f16", "uint8"):
        print(f"[ptxas] K1 {dtype}-A kernel (registers, spill store / load "
              f"bytes): " + ", ".join(
                  f"KP={kp}{' vec' if vec else ''} {r} registers, "
                  f"{ss}/{sl} B spilled"
                  for (dt, kp, vec), (r, ss, sl) in sorted(regs.items())
                  if dt == dtype), flush=True)
    check(len(regs) == 32 and not any(ss or sl for _, ss, sl in regs.values()),
          f"K1 kernels: ptxas report {regs} (expected 32 instantiations, no "
          f"spills)")

    # K2's kernels likewise: the register kernels (KP = 8, 16, 32; vec:
    # 16-byte loads), the 3xTF32 tensor-core kernels (KP = 64, 128, 256) and
    # K2b's split reduction
    regs = ptxas_k2(cuda_lib.library_path("kl_ratio").with_suffix(
        ".log").read_text())
    for name in sorted({key[0] for key in regs}):
        print(f"[ptxas] K2 {name} (registers, spill store / load bytes): "
              + ", ".join(f"{dt} KP={kp}{' vec' if vec else ''} {r} "
                          f"registers, {ss}/{sl} B spilled"
                          for (nm, dt, kp, vec), (r, ss, sl)
                          in sorted(regs.items()) if nm == name), flush=True)
    check(len(regs) == 97 and not any(ss or sl for _, ss, sl in regs.values()),
          f"K2 kernels: ptxas report {regs} (expected 97 instantiations, no "
          f"spills)")

    # K4's kernels likewise: the grouped kernel (KP = 4, 8, 16, 32 at every
    # member group it takes) and the slab kernel (KP = 32, 64, 128, 256),
    # plain and ratio, the ratio's dot pass (the same KP), f32, bf16 and f16
    # values, and the layouts of the two kernels' tables
    regs = ptxas_k4(cuda_lib.library_path("ell_gather").with_suffix(
        ".log").read_text())
    for name in sorted({key[0] for key in regs}):
        print(f"[ptxas] K4 {name} (registers, spill store / load bytes): "
              + ", ".join(f"{dt}{f' KP={kp}' if kp else ''}{f' G={g}' if g else ''}"
                          f"{' ratio' if ratio else ''} "
                          f"{r} registers, {ss}/{sl} B spilled"
                          for (nm, dt, kp, g, ratio), (r, ss, sl)
                          in sorted(regs.items()) if nm == name), flush=True)
    check(len(regs) == 128 and not any(ss or sl for _, ss, sl in regs.values()),
          f"K4 kernels: ptxas report {regs} (expected 128 kernels, no spills)")

    # K3's kernels likewise: the f32 kernel (KP = 8, 16, 32; vec: 16-byte
    # loads), the tensor-core one for a bf16, f16 or uint8 A (KP = 8, 16, 32,
    # 64; vec: 16-byte copies) and the 3xTF32 one for an f32 A (KP = 64)
    regs = ptxas_k3(cuda_lib.library_path("fused_mu_kl").with_suffix(
        ".log").read_text())
    for name in sorted({key[0] for key in regs}):
        print(f"[ptxas] K3 {name} (registers, spill store / load bytes): "
              + ", ".join(f"{dt} KP={kp}{' vec' if vec else ''} {r} "
                          f"registers, {ss}/{sl} B spilled"
                          for (nm, dt, kp, vec), (r, ss, sl)
                          in sorted(regs.items()) if nm == name), flush=True)
    check(len(regs) == 32 and not any(ss or sl for _, ss, sl in regs.values()),
          f"K3 kernels: ptxas report {regs} (expected 32 kernels, no spills)")

    def beside_pair(label, tag=""):
        """K3 does the four products of K2a + K2b (its yardstick: no one
        PyTorch call computes K3's function): their times on the same
        inputs beside K3's, where this run timed them. ``tag`` names the
        instantiation (" f16" for an f16 A) or the width (" k>32")."""
        pair = [case_ms.get((kname + tag, label))
                for kname in ("K2a kl_uht", "K2b kl_wtu")]
        k3 = case_ms["K3 fused_mu_kl" + tag, label]
        if None in pair:
            print(f"[kernel] K3 fused_mu_kl{tag} {label}: K2a + K2b not timed "
                  f"on this A", flush=True)
            return
        print(f"[kernel] K3 fused_mu_kl{tag} {label}: {k3:.3f} ms beside K2a + "
              f"K2b {pair[0]:.3f} + {pair[1]:.3f} = {sum(pair):.3f} ms (K3 / "
              f"pair {k3 / sum(pair):.3f})", flush=True)
        rows["K3 fused_mu_kl" + tag].setdefault("k2a_plus_k2b_ms", sum(pair))

    def two_read_floor(label, a, name="K1 fused_mu_fro"):
        """K1 and K3 read A twice (sweep 2 needs all of A_i H^T, or of
        U_i H^T, first): that traffic alone over the memory rate, beside the
        function's bound."""
        ms = 2 * nbytes(a) / PEAK_BYTES * 1e3
        print(f"[kernel] {name} {label}: two-read floor {ms:.3f} ms (A read "
              f"twice at {PEAK_BYTES / 1e12:g} TB/s)", flush=True)

    def wide_k2_cases(label, a, W, H, chunk):
        """K2a and K2b at k > 32 (the 3xTF32 tensor-core kernels; past 256
        in slabs) against their plain versions, for every A dtype within
        1e-4 (f32 arithmetic); the bound at the 3xTF32 rate, and beside it
        the CUDA cores'. Their rows are kept apart from k <= 32's."""
        B = a.shape[0] if a.dim() == 3 else 1
        m, n = a.shape[-2:]
        flops = 4 * B * m * n * W.shape[-1]
        for name, fn, plain, out in (
                ("K2a kl_uht", kl.kl_uht, kl.kl_uht_plain, W),
                ("K2b kl_wtu", kl.kl_wtu, kl.kl_wtu_plain, H)):
            kernel_case(f"{name} k>32", label, lambda: fn(a, W, H, eps),
                        lambda: plain(a, W, H, eps, chunk),
                        TOL[torch.float32],
                        (flops, nbytes(a, W, H, out), PEAK_3XTF32))
        print(f"[kernel] K2 k>32 {label}: CUDA-core bound "
              f"{flops / PEAK_FLOPS * 1e3:.3f} ms (4 m n k at "
              f"{PEAK_FLOPS / 1e12:g} TFLOP/s)", flush=True)

    def wide_k3_case(label, a, W, H, chunk):
        """K3 at k > 32 (the 3xTF32 kernel for an f32 A, within 1e-4; the
        tensor-core kernel at KP = 64 for a bf16, f16 or uint8 A, within
        1e-3) against its plain version, beside K2a + K2b on the same inputs
        and the two-read floor; an f32 A's bound at the 3xTF32 rate with the
        CUDA cores' beside it. Its rows are kept apart from k <= 32's."""
        B = a.shape[0] if a.dim() == 3 else 1
        m, n = a.shape[-2:]
        flops = 8 * B * m * n * W.shape[-1]
        f32 = a.dtype == torch.float32
        hrs = linalg.sum_axis(H, axis=-1)
        kernel_case("K3 fused_mu_kl k>32", label,
                    lambda: fused_kl.fused_kl_pass(a, W, H, hrs, eps),
                    lambda: fused_kl.fused_kl_pass_plain(a, W, H, hrs, eps,
                                                         chunk),
                    TOL[a.dtype],
                    (flops, nbytes(a, W, H, hrs, W, H),
                     PEAK_3XTF32 if f32 else PEAK_BF16))
        beside_pair(label, " k>32")
        two_read_floor(label, a, "K3 fused_mu_kl k>32")
        if f32:
            print(f"[kernel] K3 fused_mu_kl k>32 {label}: CUDA-core bound "
                  f"{flops / PEAK_FLOPS * 1e3:.3f} ms (8 m n k at "
                  f"{PEAK_FLOPS / 1e12:g} TFLOP/s)", flush=True)

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
    del A16, Q
    # the f16 instantiations, on the f16 copy of that A under f32 factors
    # (a_precision="float16"): K1 on f16 operands (the f16 tensor-core
    # peak; the library call takes the factors cast to f16), K2 in f32, K3
    # on bf16 operands with A widened exactly
    Ah = A.to(torch.float16)
    Wh, Hh = W.to(torch.float16), H.to(torch.float16)
    hshape = f"f16-A {shape}"
    kernel_case("K1 fused_mu_fro f16", hshape,
                lambda: fused_mu.fused_w_pass(Ah, W, H, HHT, eps),
                lambda: fused_mu.fused_w_pass_plain(Ah, W, H, HHT, eps),
                TOL[torch.float16],
                (4 * M * N * K, nbytes(Ah, W, H, HHT, W, H, HHT), PEAK_BF16),
                library=lambda: (torch.matmul(Ah, Hh.mT),
                                 torch.matmul(Wh.mT, Ah)))
    two_read_floor(hshape, Ah, "K1 fused_mu_fro f16")
    kernel_case("K2a kl_uht f16", hshape, lambda: kl.kl_uht(Ah, W, H, eps),
                lambda: kl.kl_uht_plain(Ah, W, H, eps, chunk),
                TOL[torch.float16], (4 * M * N * K, nbytes(Ah, W, H, W)))
    kernel_case("K2b kl_wtu f16", hshape, lambda: kl.kl_wtu(Ah, W, H, eps),
                lambda: kl.kl_wtu_plain(Ah, W, H, eps, chunk),
                TOL[torch.float16], (4 * M * N * K, nbytes(Ah, W, H, H)))
    kernel_case("K3 fused_mu_kl f16", hshape,
                lambda: fused_kl.fused_kl_pass(Ah, W, H, hrs, eps),
                lambda: fused_kl.fused_kl_pass_plain(Ah, W, H, hrs, eps,
                                                     chunk),
                TOL[torch.float16],
                (8 * M * N * K, nbytes(Ah, W, H, hrs, W, H), PEAK_BF16))
    beside_pair(hshape, " f16")
    two_read_floor(hshape, Ah, "K3 fused_mu_kl f16")
    del Ah, Wh, Hh, W16, H16, W, H, HHT, hrs
    # K2 and K3 at k = 64: K2's 3xTF32 kernels and K3's (the 3xTF32 one on
    # the f32 A, the tensor-core one at KP = 64 on its bf16, f16 and uint8
    # copies), K3 beside K2a + K2b on each A
    W64 = torch.rand((M, 64), generator=gen, device=dev)
    H64 = torch.rand((64, N), generator=gen, device=dev)
    for label, make in (("f32", lambda: A),
                        ("bf16-A", lambda: A.to(torch.bfloat16)),
                        ("f16-A", lambda: A.to(torch.float16)),
                        ("uint8-A", lambda: linalg.quantize_uint8(A)[0])):
        a = make()
        wide_k2_cases(f"{label} {M}x{N} k=64", a, W64, H64, chunk)
        wide_k3_case(f"{label} {M}x{N} k=64", a, W64, H64, chunk)
        del a
    del W64, H64
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
    # the f16 instantiations on the f16 members (NMFk under
    # --a_precision=float16)
    Aeh = Ae.to(torch.float16)
    Weh, Heh = We.to(torch.float16), He.to(torch.float16)
    heshape = f"f16-A {eshape}"
    kernel_case("K1 fused_mu_fro f16", heshape,
                lambda: fused_mu.fused_w_pass(Aeh, We, He, HHTe, eps),
                lambda: fused_mu.fused_w_pass_plain(Aeh, We, He, HHTe, eps),
                TOL[torch.float16],
                (ework, nbytes(Aeh, We, He, HHTe, We, He, HHTe), PEAK_BF16),
                library=lambda: (torch.matmul(Aeh, Heh.mT),
                                 torch.matmul(Weh.mT, Aeh)))
    two_read_floor(heshape, Aeh, "K1 fused_mu_fro f16")
    del Weh, Heh
    kernel_case("K2a kl_uht f16", heshape,
                lambda: kl.kl_uht(Aeh, We, He, eps),
                lambda: kl.kl_uht_plain(Aeh, We, He, eps, ech),
                TOL[torch.float16], (ework, nbytes(Aeh, We, He, We)))
    kernel_case("K2b kl_wtu f16", heshape,
                lambda: kl.kl_wtu(Aeh, We, He, eps),
                lambda: kl.kl_wtu_plain(Aeh, We, He, eps, ech),
                TOL[torch.float16], (ework, nbytes(Aeh, We, He, He)))
    kernel_case("K3 fused_mu_kl f16", heshape,
                lambda: fused_kl.fused_kl_pass(Aeh, We, He, hrse, eps),
                lambda: fused_kl.fused_kl_pass_plain(Aeh, We, He, hrse, eps,
                                                     ech),
                TOL[torch.float16],
                (2 * ework, nbytes(Aeh, We, He, hrse, We, He), PEAK_BF16))
    beside_pair(heshape, " f16")
    two_read_floor(heshape, Aeh, "K3 fused_mu_kl f16")
    del Aeh
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
    del W1, H1
    # K2 past 32 on one member (the refit's shape: phase 5's W-frozen refit
    # runs K2b there at k = 34 and 64, KP = 64 with its rows split; k = 34
    # pads; k = 300: two slabs) and on the stack at phase 5's k = 34 and at
    # k = 64
    for k in (34, 64, 128, 256, 300):
        Wk = torch.rand((EM, k), generator=gen, device=dev)
        Hk = torch.rand((k, EN), generator=gen, device=dev)
        wide_k2_cases(f"f32 {EM}x{EN} k={k}", A1, Wk, Hk, ech)
    del A1, Wk, Hk
    # and K3 beside them, on the f32 members and their bf16 copies
    Ae16 = Ae.to(torch.bfloat16)
    for k in (34, WIDE_K):
        Wk = torch.rand((ENS, EM, k), generator=gen, device=dev)
        Hk = torch.rand((ENS, k, EN), generator=gen, device=dev)
        for label, a in (("f32", Ae), ("bf16-A", Ae16)):
            wide_k2_cases(f"{label} {ENS} x {EM}x{EN} k={k}", a, Wk, Hk, ech)
            wide_k3_case(f"{label} {ENS} x {EM}x{EN} k={k}", a, Wk, Hk, ech)
    del Wk, Hk, Ae16
    kernel_case("K3 fused_mu_kl", f"f32 {eshape}",
                lambda: fused_kl.fused_kl_pass(Ae, We, He, hrse, eps),
                lambda: fused_kl.fused_kl_pass_plain(Ae, We, He, hrse, eps,
                                                     ech),
                TOL[torch.float32],
                (2 * ework, nbytes(Ae, We, He, hrse, We, He)))
    beside_pair(f"f32 {eshape}")
    del Ae, We, He, HHTe, hrse
    torch.cuda.empty_cache()

    # K4 at the NYTimes shape (nytimes: drawn from NYT_SEED, as every rank
    # of phase 8 draws it)
    t0 = time.perf_counter()
    nyt = nytimes(dev)
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

    def k4_cases(tag, E, W, H, library, name="K4 ell_gather"):
        """K4's four modes on the ELL E with factors W (.., m, k), H
        (.., k, n); ``library(Ht, W)`` gives the library calls of the two
        plain modes (None where there is none). Returns the kernel ms of the
        two plain modes and the nonzeros each orientation's ELL holds."""
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
                name, f"{label} {tag}",
                lambda: ell_gather.ell_gather_product(v, i, T, X, eps),
                lambda: ell_gather.ell_gather_product_plain(v, i, T, X, eps),
                TOL[torch.float32], (flops, work), lib))
            # the gathers' own traffic, every nonzero's k floats once, at
            # the L2's rate for uniform indices: an estimate, not a floor
            # (sorted lines share cached rows and may gather faster)
            rate = ell_gather.L2_GATHER_BYTES
            slabs = ell_gather.slab_for(T.shape[-2], k, T.device,
                                        ratio=X is not None)[1]
            print(f"[kernel] {name} {label} {tag}: gather estimate "
                  f"{nz * members * k * 4 / rate * 1e3:.3f} ms "
                  f"({nz * members * k * 4 / 1e9:.1f} GB at the L2's "
                  f"{rate / 1e12:g} TB/s for uniform indices, "
                  f"bench_torch/gather_probe.cu), {slabs} "
                  f"slab{'s' if slabs > 1 else ''}", flush=True)
        return out[:2], (nz_r, nz_c)

    Wn = torch.rand((NYT_M, K), generator=gen, device=dev)
    Hn = torch.rand((K, NYT_N), generator=gen, device=dev)
    A_r = csr(nyt.rows, nyt.cols, nyt.data, nyt.shape)
    A_c = csr(nyt.cols, nyt.rows, nyt.data, nyt.shape[::-1])
    nyt_lib = lambda Ht, W: (lambda: torch.sparse.mm(A_r, Ht),
                             lambda: torch.sparse.mm(A_c, W))
    k4_ms, k4_nz = k4_cases(f"{NYT_M}x{NYT_N} k={K} f32", E, Wn, Hn, nyt_lib)
    # the f16 instantiation: f16 values (a_precision="float16") under f32
    # factors; the library call, where CUDA has an f16 CSR product, takes
    # the factors cast to f16 beforehand
    A_r16 = csr(nyt.rows, nyt.cols, nyt.data.half(), nyt.shape)
    A_c16 = csr(nyt.cols, nyt.rows, nyt.data.half(), nyt.shape[::-1])

    def nyt_lib16(Ht, W):
        Ht16, W16 = Ht.half(), W.half()
        try:
            torch.sparse.mm(A_r16, Ht16)
            torch.cuda.synchronize()
        except RuntimeError as exc:
            print(f"[kernel] K4 ell_gather f16: torch.sparse.mm takes no "
                  f"f16 CSR on CUDA ({str(exc)[:100]}): library none",
                  flush=True)
            return None, None
        return (lambda: torch.sparse.mm(A_r16, Ht16),
                lambda: torch.sparse.mm(A_c16, W16))

    k4_cases(f"{NYT_M}x{NYT_N} k={K} f16 values", E.astype(torch.float16),
             Wn, Hn, nyt_lib16, "K4 ell_gather f16")
    del A_r16, A_c16
    # K4 past k = 32, on its slab kernels: the tables (H^T 102660 rows, W
    # 300000) in column slabs sized to the L2, the ratio modes in several
    # slabs in two passes; k = 300 first, the main path's shape (phase 4),
    # is the row's headline in the JSON line
    for k in (300, 64, 128, 256):
        Wn = torch.rand((NYT_M, k), generator=gen, device=dev)
        Hn = torch.rand((k, NYT_N), generator=gen, device=dev)
        k4_cases(f"{NYT_M}x{NYT_N} k={k} f32", E, Wn, Hn, nyt_lib,
                 "K4 ell_gather k>32")
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
    # k = 3 (KP = 4, groups of 8) beside the sweep's top k = 7 (KP = 8), and
    # k = 64 on the slab kernels (each member's W 51 MB)
    for k in (3, 64, TOPIC_K):
        Ws = torch.rand((ENS, tshape[0], k), generator=gen, device=dev)
        Hs = torch.rand((ENS, k, tshape[1]), generator=gen, device=dev)
        k4_cases(f"{ENS} x {tshape[0]}x{tshape[1]} ({topic.nse} nnz) "
                 f"k={k} f32", stack, Ws, Hs, stack_lib,
                 "K4 ell_gather k>32" if k > 32 else "K4 ell_gather")
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

    # the NMFk ensemble's nnsvd init takes one eigh of each member's Gram
    # (models/svd.py::_svd_gram): one at the planted sweep's shape
    _, _, X = generate_data(**PLANTED)
    G = linalg.gram(torch.from_numpy(X.astype(np.float32)).to(dev))
    del X
    eigh_ms = median_ms(lambda: torch.linalg.eigh(G), reps=3)
    print(f"[svd] eigh of the {G.shape[0]}x{G.shape[1]} f32 Gram of a "
          f"{PLANTED['m']}x{PLANTED['n']} member: {eigh_ms:.1f} ms "
          f"(median of 3)", flush=True)
    del G

    def hals_parts(A):
        """One HALS iteration at A's shape in parts: the two A-sized
        products, and the W and H chains by columns and by blocks of 8."""
        g = torch.Generator(dev)
        g.manual_seed(1)
        W, H = init_factors_rand(g, *A.shape, K, torch.float32, dev)
        HHT, AHT = linalg.gram_t(H), linalg.matmul_AHT(A, H)
        WTW, WTA = linalg.gram(W), linalg.matmul_WTA(W, A)
        prod = median_ms(lambda: (linalg.matmul_AHT(A, H),
                                  linalg.matmul_WTA(W, A)))
        chains = [median_ms(fn) for fn in (
            lambda: updates._hals_w_cols(W, HHT, AHT, eps, 0, K),
            lambda: updates._hals_h_rows(H, WTW, WTA, eps, 0, K),
            lambda: updates._hals_w_blocked(W, HHT, AHT, eps, 8),
            lambda: updates._hals_h_blocked(H, WTW, WTA, eps, 8))]
        print(f"[nmf] HALS iteration parts {A.shape[0]}x{A.shape[1]} k={K}: "
              f"A H^T + W^T A {prod:.3f} ms; column chain W {chains[0]:.3f} "
              f"+ H {chains[1]:.3f} ms; blocks of 8 W {chains[2]:.3f} + H "
              f"{chains[3]:.3f} ms (CUDA events, median of 7)", flush=True)

    # -- 3. the dense main path, counters from zero ----------------------
    timing.enable(True)
    none = {key: 0 for key in counts()}
    g = torch.Generator(dev)
    g.manual_seed(NMFConfig().seed)
    W0, H0 = init_factors_rand(g, M, N, K, torch.float32, dev)
    init_err = float(linalg.relative_error(A, W0, H0, chunk))
    del W0, H0
    errs = {}

    def dense_fit(label, cfg, want, ref_err=init_err, ref="rand init",
                  A_in=None):
        """NMF.fit of A (or ``A_in``) under ``cfg``, counters from zero: its
        seconds, its error (finite and below ``ref_err``, the init's), its
        launches (exactly ``want``, nothing else) and factors at the
        precision's dtype."""
        A_fit = A if A_in is None else A_in
        k = cfg.k
        timing.reset()
        zero_counts()
        t0 = time.perf_counter()
        W, H, err = NMF(cfg, dev).fit(A_fit)      # same seed: same init
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        ran = read_counts()
        solve_s = timing.TIMINGS["solve"]
        print(f"[nmf] {label} {M}x{N} k={k}, {cfg.itr} iterations: fit "
              f"{secs:.3f} s, solve {solve_s:.3f} s ({cfg.itr / solve_s:.2f} "
              f"it/s incl. final error), relative error {ref_err:.6f} "
              f"({ref}) -> {err:.6f}, launches {ran}", flush=True)
        check(np.isfinite(err) and err < ref_err,
              f"NMF.fit {label}: error {err} not below the init's {ref_err}")
        check(W.shape == (M, k) and H.shape == (k, N), "factor shapes")
        check(W.dtype == H.dtype == cfg.dtype,
              f"NMF.fit {label}: factors {W.dtype}, {H.dtype}")
        check(ran == {**none, **want},
              f"NMF.fit {label} launches {ran}, expected {want}")
        return err

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
        errs[label] = dense_fit(label, NMFConfig(k=K, norm=norm, itr=ITR,
                                                 **kw), want)
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

    # KL-MU at k = 64: K2a and K2b on their 3xTF32 kernels, 10 each, on the
    # f32 A, its uint8 quantization and its bf16 copy; and with use_fused=True
    # K3 on each (the 3xTF32 kernel, the tensor-core kernel at KP = 64), 10
    # launches under the A dtype's key, held to the K2 solve on the same A
    # as at k = 32
    g = torch.Generator(dev)
    g.manual_seed(NMFConfig().seed)
    W0, H0 = init_factors_rand(g, M, N, WIDE_K, torch.float32, dev)
    init_wide = float(linalg.relative_error(A, W0, H0, chunk))
    del W0, H0
    wide = []
    for label, kw, key in (("f32", {}, "fused_mu_kl"),
                           ("uint8-A", {"a_precision": "uint8"},
                            "fused_mu_kl_u8"),
                           ("bf16-A", {"a_precision": "bfloat16"},
                            "fused_mu_kl_bf16")):
        ref = f"KL-MU {label} k={WIDE_K}"
        errs[ref] = dense_fit(ref, NMFConfig(k=WIDE_K, norm="kl", itr=ITR,
                                             **kw),
                              {"kl_uht": ITR, "kl_wtu": ITR}, init_wide)
        fused = f"KL-MU {label} k={WIDE_K} use_fused"
        errs[fused] = dense_fit(fused, NMFConfig(k=WIDE_K, norm="kl", itr=ITR,
                                                 use_fused=True, **kw),
                                {key: ITR}, init_wide)
        check(fused_kl.wide_launches[key] == ITR,
              f"{fused}: {fused_kl.wide_launches} past k = 32, expected "
              f"{ITR} under {key}")
        wide.append((fused, ref, 1e-3 if label == "f32" else 0.02))
    for label, ref, tol in wide:
        rel = abs(errs[label] / errs[ref] - 1)
        print(f"[check] {label} error {errs[label]:.6f} vs {ref} "
              f"{errs[ref]:.6f}: relative difference {rel:.2e} (limit "
              f"{tol:g})", flush=True)
        check(rel <= tol, f"{label} error {errs[label]} is not within "
                          f"{tol:g} of {ref}'s {errs[ref]}")

    # HALS and BCD from the same rand init: their A-sized products are plain
    # (cuBLAS), their chains small products, and no kernel of K1-K4 runs
    for label, kw in (("HALS", {"method": "hals"}),
                      ("HALS hals_block=8", {"method": "hals",
                                             "hals_block": 8}),
                      ("BCD gram", {"method": "bcd"}),
                      ("BCD residual", {"method": "bcd",
                                        "bcd_obj": "residual"})):
        errs[label] = dense_fit(label, NMFConfig(k=K, norm="fro", itr=ITR,
                                                 **kw), {})
    # the blocks change the summation order only; the two objectives decide
    # alike unless one sits within the Gram identity's f32 resolution
    for label, ref in (("HALS hals_block=8", "HALS"),
                       ("BCD residual", "BCD gram")):
        rel = abs(errs[label] / errs[ref] - 1)
        print(f"[check] {label} error {errs[label]:.6f} vs {ref} "
              f"{errs[ref]:.6f}: relative difference {rel:.2e} (limit 1e-3)",
              flush=True)
        check(rel <= 1e-3, f"{label} error {errs[label]} is not within 1e-3 "
                           f"of {ref}'s {errs[ref]}")
    hals_parts(A)

    # FRO-MU from the nnsvd init (randomized SVD: min(M, N) > 8192)
    t0 = time.perf_counter()
    _, svd_errs = DistSVD(k=K, eps=eps).nnsvd(A, verbose=1)
    torch.cuda.synchronize()
    print(f"[svd] DistSVD.nnsvd(verbose=1) {M}x{N} k={K} (randomized): "
          f"{time.perf_counter() - t0:.3f} s, recon_err_svd "
          f"{svd_errs['recon_err_svd']:.6f}, recon_err_nnsvd "
          f"{svd_errs['recon_err_nnsvd']:.6f}", flush=True)
    dense_fit("FRO-MU f32 nnsvd", NMFConfig(k=K, norm="fro", itr=ITR,
                                            init="nnsvd"),
              {"fused_mu_fro": ITR}, svd_errs["recon_err_nnsvd"],
              "nnsvd init")
    print(f"[svd] the nnsvd init of that fit took "
          f"{timing.TIMINGS['init_factors']:.3f} s", flush=True)

    # the half precisions, from the same rand init (drawn in f32, then
    # cast): bf16 factors (A at bf16: K1 and K3 on their bf16 kernels, K2
    # on a bf16 A, HALS and BCD on bf16 cuBLAS products) and f32 factors on
    # an f16 A (a_precision="float16": K1's and K2's f16 kernels) on A
    # itself; f16 factors on A / max(A), since at f16 the products of A
    # (up to about 20 here) pass f16's 65504 (the JAX package's f16
    # semantics, kept). Relative errors do not change with A's scale, and
    # MU's iterates scale with it up to eps: each error is held to 2 % of
    # the f32 solve's. HALS at bf16 ends further from it in the JAX package
    # too: 3.6-4.1 % above its f32 HALS after 10 iterations on a planted
    # rank-32 1200x800, with the port as far to 0.01
    # (tests/test_torch_precision.py::
    # test_hals_bf16_ends_as_far_from_f32_as_jax); here 3.0 % was measured.
    # HALS at bf16 is held to 5 %
    half = []
    limit = {"HALS bf16": 0.05}
    for label, norm, kw, want, ref in (
            ("FRO-MU bf16", "fro", {"precision": "bfloat16"},
             {"fused_mu_fro_bf16": ITR}, "FRO-MU f32"),
            ("KL-MU bf16", "kl", {"precision": "bfloat16"},
             {"kl_uht": ITR, "kl_wtu": ITR}, "KL-MU f32"),
            ("KL-MU bf16 use_fused", "kl",
             {"precision": "bfloat16", "use_fused": True},
             {"fused_mu_kl_bf16": ITR}, "KL-MU f32 use_fused"),
            ("HALS bf16", "fro", {"precision": "bfloat16", "method": "hals"},
             {}, "HALS"),
            ("BCD bf16", "fro", {"precision": "bfloat16", "method": "bcd"},
             {}, "BCD gram"),
            ("FRO-MU f16-A", "fro", {"a_precision": "float16"},
             {"fused_mu_fro_f16": ITR}, "FRO-MU f32"),
            ("KL-MU f16-A", "kl", {"a_precision": "float16"},
             {"kl_uht_f16": ITR, "kl_wtu_f16": ITR}, "KL-MU f32")):
        errs[label] = dense_fit(label, NMFConfig(k=K, norm=norm, itr=ITR,
                                                 **kw), want)
        half.append((label, ref))
    A.div_(A.max())               # in place: A in [0, 1]
    g = torch.Generator(dev)
    g.manual_seed(NMFConfig().seed)
    W0, H0 = init_factors_rand(g, M, N, K, torch.float16, dev)
    init_err16 = float(linalg.relative_error(A, W0.float(), H0.float(),
                                             chunk))
    del W0, H0
    for label, norm, kw, want, ref in (
            ("FRO-MU f16", "fro", {}, {"fused_mu_fro_f16": ITR},
             "FRO-MU f32"),
            ("KL-MU f16", "kl", {}, {"kl_uht_f16": ITR, "kl_wtu_f16": ITR},
             "KL-MU f32"),
            ("KL-MU f16 use_fused", "kl", {"use_fused": True},
             {"fused_mu_kl_f16": ITR}, "KL-MU f32 use_fused")):
        errs[label] = dense_fit(label, NMFConfig(k=K, norm=norm, itr=ITR,
                                                 precision="float16", **kw),
                                want, init_err16, "rand init, A / max(A)")
        half.append((label, ref))
    for label, ref in half:
        rel = abs(errs[label] / errs[ref] - 1)
        tol = limit.get(label, 0.02)
        print(f"[check] {label} error {errs[label]:.6f} vs {ref} "
              f"{errs[ref]:.6f}: relative difference {rel:.2e} (limit "
              f"{tol:g})", flush=True)
        check(rel <= tol, f"{label} error {errs[label]} is not within "
                          f"{tol:g} of {ref}'s {errs[ref]}")
    del A
    torch.cuda.empty_cache()

    sweep_log = {}      # results path -> (seconds, stage seconds)

    def ensemble_ref(res_path, fname):
        """Phase 9's and the [k-sweep] phase's reference: a 1x1 sweep's
        results at KSWEEP_KS (phase 9 reads GRID_SWEEP_KS of them), its
        seconds and its stage seconds (its members at those ks are theirs:
        a member is keyed by (seed, member) alone)."""
        return ({k: read_cluster_results(os.path.join(res_path, fname,
                                                      str(k)))
                 for k in KSWEEP_KS}, *sweep_log[res_path])

    def sweep(tmp, ftype, fname, norm, expect, shape, a_precision=None,
              flags=(), label=None, perturbations=10, nopt=4):
        """The NMFk sweep through the CLI entry point, counters from zero;
        checks that it chose ``nopt`` (None: only prints its choice and the
        minimum silhouette of each k), every k's results, and that the
        kernels of ``expect`` (and no other) launched. ``flags`` adds CLI
        flags, and ``perturbations`` replaces SWEEP's 10. Returns the
        results path."""
        timing.reset()
        tag = "".join(f.replace("-", "_").replace("=", "_") for f in flags)
        res_path = os.path.join(
            tmp, f"res_{fname}_{norm}_{a_precision}{tag}") + "/"
        extra = [f"--a_precision={a_precision}"] if a_precision else []
        extra += list(flags)
        args = [f"--perturbations={perturbations}"
                if a.startswith("--perturbations=") else a for a in SWEEP]
        label = label or f"{norm.upper()}-MU"
        zero_counts()
        t0 = time.perf_counter()
        out = cli.main(["--process=pyDNMFk", "--p_r=1", "--p_c=1",
                        f"--ftype={ftype}", f"--fpath={tmp}/",
                        f"--fname={fname}", f"--norm={norm}",
                        f"--results_path={res_path}", "--timing_stats=true",
                        *args, *extra])
        secs = time.perf_counter() - t0
        ran = read_counts()
        stages = {s: round(timing.TIMINGS.get(s, 0.0), 3) for s in
                  ("read", "sparse_format", "ensemble_solve", "clustering",
                   "regression")}
        sweep_log[res_path] = (secs, stages)
        if flags:
            stages["ensemble_init"] = round(timing.TIMINGS["ensemble_init"],
                                            3)
        print(f"[nmfk] {label} {ftype} {shape[0]}x{shape[1]} "
              f"{' '.join(args + extra)}: nopt {out['nopt']}, {secs:.2f} s, stage "
              f"seconds {stages}, launches {ran}", flush=True)
        check(nopt is None or out["nopt"] == nopt,
              f"NMFk {norm} {ftype} chose k={out['nopt']}, not {nopt}")
        sils = {}
        for k in range(2, 8):
            res = read_cluster_results(os.path.join(res_path, fname, str(k)))
            sils[k] = round(float(np.min(res["clusterSilhouetteCoefficients"])),
                            3)
            check(set(res) == set(RESULT_DATASETS), f"k={k} datasets")
            check(res["clusterSilhouetteCoefficients"].shape == (k,)
                  and res["L_err"].shape == (shape[1],)
                  and res["ErrTol"].shape == (perturbations,)
                  and all(np.isfinite(v).all() for v in res.values()),
                  f"NMFk {norm} {ftype} k={k} results")
        check(all(ran[key] > 0 for key in expect)
              and not any(ran[key] for key in ran if key not in expect),
              f"NMFk {norm} {ftype} launched {ran}, expected {expect} only")
        if nopt is None:
            print(f"[nmfk] {label}: minimum silhouette by k {sils}", flush=True)
        return res_path

    def staged_sweep(A_np, cfg, label, want_ens, want_refit):
        """The dense KL NMFk sweep through the library under ``cfg``: nopt
        = 4, every k's results, and exact launches by stage, ``want_ens``
        in the ensemble and ``want_refit`` in the W-frozen refit, each per
        iteration and k (the members in one stack)."""
        ks = list(cfg.k_range)
        ens = dict(none)

        class Staged(NMFk):
            def _solve_ensemble(self, *args, **kw):
                before = counts()
                out = super()._solve_ensemble(*args, **kw)
                for key, n in counts().items():
                    ens[key] += n - before[key]
                return out

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
        sweep_log[cfg.results_path] = (secs, stages)
        print(f"[nmfk] {label} (library) npy {A_np.shape[0]}x{A_np.shape[1]} "
              f"a_precision={cfg.nmf.a_precision} k={ks}, "
              f"{cfg.perturbations} perturbations, {cfg.nmf.itr} "
              f"iterations: nopt {nopt}, {secs:.2f} s, stage seconds "
              f"{stages}, launches: ensemble {ens}, refit {refit}",
              flush=True)
        check(nopt == 4, f"NMFk {label} chose k={nopt}, not 4")
        for k in ks:
            out = read_cluster_results(os.path.join(cfg.results_path,
                                                    cfg.fname, str(k)))
            check(set(out) == set(RESULT_DATASETS)
                  and out["clusterSilhouetteCoefficients"].shape == (k,)
                  and all(np.isfinite(v).all() for v in out.values()),
                  f"NMFk {label} k={k} results")
        itr = len(ks) * cfg.nmf.itr
        want_ens = {**none, **{key: itr for key in want_ens}}
        want_refit = {**none, **{key: itr for key in want_refit}}
        check(ens == want_ens and refit == want_refit,
              f"NMFk {label} launched {ens} (ensemble) and {refit} (refit); "
              f"expected {want_ens} and {want_refit}")

    def fused_sweep(tmp, a_precision="float32", key="fused_mu_kl", run=""):
        """The dense KL NMFk sweep through the library with use_fused=True
        (the same settings as the CLI sweeps), its members stored at
        ``a_precision``: the ensemble only K3 under ``key``, the refit only
        K2b. Returns the results path (``run`` tells a second one apart)."""
        cfg = NMFkConfig(nmf=NMFConfig(norm="kl", itr=400, use_fused=True,
                                       a_precision=a_precision),
                         start_k=2, end_k=7, perturbations=10,
                         results_path=os.path.join(
                             tmp, f"res_fused_{a_precision}{run}") + "/",
                         fname="X", checkpoint=False)
        staged_sweep(np.load(os.path.join(tmp, "X.npy")), cfg,
                     "KL-MU use_fused", (key,), ("kl_wtu",))
        return cfg.results_path

    def budget_sweep(tmp, batch=5):
        """The dense FRO NMFk sweep through the library with ``hbm_budget``
        set so that the 10 members run in batches of ``batch``: nopt = 4,
        and K1 launched once per iteration, k and batch, nothing else."""
        ks = range(2, 8)
        m, n = PLANTED["m"], PLANTED["n"]
        # the port's member model (utils/memory.py, which
        # models/nmfk.py::_ensemble_batch_size calls): the member's f32
        # copy, its factors' working set at k = 4, and the shared f32 A
        # outside the 85 % headroom
        per_member = m * n * 4 + (m + n) * 4 * 4 * 8
        budget = int(((batch + 0.5) * per_member + m * n * 4) / 0.85)
        cfg = NMFkConfig(nmf=NMFConfig(norm="fro", itr=400), start_k=ks[0],
                         end_k=ks[-1], perturbations=10, hbm_budget=budget,
                         results_path=os.path.join(tmp, "res_budget") + "/",
                         fname="X", checkpoint=False)
        A_np = np.load(os.path.join(tmp, "X.npy"))
        timing.reset()
        zero_counts()
        t0 = time.perf_counter()
        model = NMFk(cfg, dev)
        nopt = model.fit(A_np)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        ran = read_counts()
        stages = {st: round(timing.TIMINGS.get(st, 0.0), 3) for st in
                  ("ensemble_solve", "clustering", "regression")}
        batches = -(-cfg.perturbations // model.last_batch_size)
        print(f"[nmfk] FRO-MU (library) npy {m}x{n} hbm_budget={budget} "
              f"k=2..7, 10 perturbations, 400 iterations: batches of "
              f"{model.last_batch_size} ({batches} a k), nopt {nopt}, "
              f"{secs:.2f} s, stage seconds {stages}, launches {ran}",
              flush=True)
        check(nopt == 4, f"NMFk hbm_budget chose k={nopt}, not 4")
        check(model.last_batch_size == batch and batches >= 2,
              f"NMFk hbm_budget ran batches of {model.last_batch_size}")
        want = {**none, "fused_mu_fro": batches * len(ks) * cfg.nmf.itr}
        check(ran == want, f"NMFk hbm_budget launched {ran}, expected {want}")

    _, _, X = generate_data(**PLANTED)
    with tempfile.TemporaryDirectory() as tmp:
        np.save(os.path.join(tmp, "X.npy"), X.astype(np.float32))
        del X
        # phase 9 holds its sweeps at ks 3..5 against these
        ensemble_refs = {name: ensemble_ref(sweep(
            tmp, "npy", "X", norm, expect, (PLANTED["m"], PLANTED["n"])), "X")
            for name, norm, expect in (
                ("e4 1x1 FRO-MU", "fro", ("fused_mu_fro",)),
                ("e2 2x1 KL-MU", "kl", ("kl_uht", "kl_wtu")))}
        # the ensemble on bf16 members: K1's tensor-core kernel
        sweep(tmp, "npy", "X", "fro", ("fused_mu_fro_bf16",),
              (PLANTED["m"], PLANTED["n"]), a_precision="bfloat16")
        # the ensemble at bf16 and at f16 factors (A at the same dtype):
        # K1's bf16 and f16 kernels
        sweep(tmp, "npy", "X", "fro", ("fused_mu_fro_bf16",),
              (PLANTED["m"], PLANTED["n"]), flags=("--precision=bfloat16",),
              label="FRO-MU bf16")
        # At f16 the sweep's choice is not checked: the clustering
        # normalizes W's columns by sqrt(sum of squares + eps) with the
        # factor dtype's eps (JAX clustering.py:37-44 with cfg.nmf.eps,
        # nmfk.py:1246; reference dist_clustering.py:30-39), and f16's eps,
        # 9.8e-4, passes the sum of squares of a column whose unit L1 mass
        # spreads over more than about a thousand rows: the columns are no
        # longer unit vectors, the silhouettes collapse, and the walk stops
        # early, in the JAX package as in the port (ROADMAP queue 3)
        sweep(tmp, "npy", "X", "fro", ("fused_mu_fro_f16",),
              (PLANTED["m"], PLANTED["n"]), flags=("--precision=float16",),
              label="FRO-MU f16", nopt=None)
        budget_sweep(tmp)
        fused_sweep(tmp)
        # the ensemble on bf16 members: K3's tensor-core kernel; the
        # [k-sweep] phase holds its merged K-padded sweep against it, and
        # against how far a second run of it lies (K3's atomics)
        fused_bf16_ref = ensemble_ref(
            fused_sweep(tmp, "bfloat16", "fused_mu_kl_bf16"), "X") + (
            ensemble_ref(fused_sweep(tmp, "bfloat16", "fused_mu_kl_bf16",
                                     "_rerun"), "X")[0],)
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
    # (f16 values under f32 factors, a_precision="float16": K4's f16
    # instantiation)
    # (and KL-MU at k = 300: K4 in column slabs, every call, its ratio modes
    # in two passes)
    nyt_ref = {}     # the f32 k = K fits, phase 8's 1x1 references
    for norm, method, a_prec, k in (("fro", "mu", None, K),
                                    ("kl", "mu", None, K),
                                    ("fro", "hals", None, K),
                                    ("fro", "mu", "float16", K),
                                    ("kl", "mu", "float16", K),
                                    ("kl", "mu", None, 300)):
        cfg = NMFConfig(k=k, norm=norm, itr=10, method=method,
                        a_precision=a_prec)
        label = "HALS" if method == "hals" else f"{norm.upper()}-MU"
        label += " f16 values" if a_prec else ""
        g = torch.Generator(dev)
        g.manual_seed(cfg.seed)
        W0, H0 = init_factors_rand(g, NYT_M, NYT_N, k, torch.float32, dev)
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
        print(f"[nmf] {label} sparse {NYT_M}x{NYT_N} ({nyt.nse} "
              f"nnz) k={k} f32, 10 iterations: fit {secs:.3f} s (format "
              f"{timing.TIMINGS['sparse_format']:.3f} s), solve "
              f"{solve_s:.3f} s ({10 / solve_s:.2f} it/s incl. final "
              f"error), relative error {init_err:.6f} (rand init) -> "
              f"{err:.6f}, launches {ran}", flush=True)
        check(isinstance(model._A, ell.EllSparse),
              f"the format policy chose {type(model._A).__name__}, not ELL")
        check(np.isfinite(err) and err < init_err,
              f"sparse NMF.fit {label}: error {err} not below the init's "
              f"{init_err}")
        check(W.shape == (NYT_M, k) and H.shape == (k, NYT_N), "factor shapes")
        # each MU or HALS iteration makes two ELL products, one K4 launch
        # each (FRO and HALS: A H^T and W^T A, plain; KL: UHT and WTU,
        # ratio), and the final Gram-identity error one more, W^T A
        # (plain): FRO and HALS 2 x 10 + 1 = 21 plain; KL 2 x 10 = 20 ratio
        # + 1 plain
        tag = "_f16" if a_prec else ""
        want = {**none, **({f"ell_gather{tag}": 21} if norm == "fro"
                           else {f"ell_gather{tag}": 1,
                                 f"ell_gather_ratio{tag}": 20})}
        check(ran == want, f"sparse NMF.fit {label} launches {ran}, "
                           f"expected {want}")
        if a_prec is None and k == K:
            nyt_ref[label] = (err, W.cpu(), H.cpu(), secs,
                              {key: n for key, n in ran.items() if n})
        if k > 32:
            slabbed = dict(ell_gather.slab_launches)
            check(slabbed == {key: n for key, n in ran.items()
                              if key.startswith("ell_gather")},
                  f"sparse NMF.fit {label}: K4 calls in slabs {slabbed}, "
                  f"expected every one of {want}")
            print(f"[nmf] {label} sparse k={k}: solve {solve_s:.3f} s beside "
                  f"{PARENT_KL300_S} s for the design with slabs of 256 "
                  f"columns and the wide ratio kernel (H100 80GB HBM3, "
                  f"700 W)", flush=True)
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
        # phase 8 holds its grid sweeps at ks 3..5 against these ks of the
        # 1x1 sweeps: a member is keyed by (seed, member) alone, whatever
        # the other ks of its sweep
        topic_ref = {}
        for norm, expect in (("fro", ("ell_gather",)),
                             ("kl", ("ell_gather", "ell_gather_ratio"))):
            res_path = sweep(tmp, "npz", "T", norm, expect, tshape)
            topic_ref[norm] = {k: read_cluster_results(
                os.path.join(res_path, "T", str(k))) for k in GRID_SWEEP_KS}
            if norm == "fro":       # and phase 9 its sparse sweep
                ensemble_refs["e4 1x1 sparse FRO-MU"] = ensemble_ref(
                    res_path, "T")

    # the HALS + nnsvd + prune sweep through the CLI: a planted matrix with
    # all-zero rows and columns, which the sweep prunes once and puts back
    # into the saved factors; HALS launches no kernel of K1-K4. NNSVD
    # starts every member from the same point up to its noise, so the
    # clusters of k > 4 hold together more often than under rand init: at
    # 10 members the walk chose 5 for 4 of 6 seeds on the card, at 20
    # members (the CLI's default) 4 for all 6 (PERF.md §6;
    # bench_torch/nnsvd_sweep_probe.py)
    _, _, X = generate_data(**PRUNED)
    X = X.astype(np.float32)
    zero_rows = np.arange(0, PRUNED["m"], ZERO_EVERY[0])
    zero_cols = np.arange(0, PRUNED["n"], ZERO_EVERY[1])
    X[zero_rows] = 0.0
    X[:, zero_cols] = 0.0
    with tempfile.TemporaryDirectory() as tmp:
        np.save(os.path.join(tmp, "P.npy"), X)
        res_path = sweep(tmp, "npy", "P", "fro", (), X.shape,
                         flags=("--method=hals", "--init=nnsvd",
                                "--prune=true"),
                         label="HALS nnsvd prune", perturbations=20)
        sils = {}
        for k in range(2, 8):
            k_path = os.path.join(res_path, "P", str(k))
            Wr = np.load(os.path.join(k_path, "W_reg_factors", "W.npy"))
            Hr = np.load(os.path.join(k_path, "H_reg_factors", "H.npy"))
            res = read_cluster_results(k_path)
            sils[k] = round(float(np.min(
                res["clusterSilhouetteCoefficients"])), 3)
            check(Wr.shape == (X.shape[0], k) and Hr.shape == (k, X.shape[1])
                  and not Wr[zero_rows].any() and not Hr[:, zero_cols].any()
                  and Wr.any(axis=1).sum() == X.shape[0] - len(zero_rows)
                  and not res["L_err"][zero_cols].any(),
                  f"prune sweep k={k}: factors {Wr.shape} {Hr.shape} not at "
                  f"the full shape with the planted zero rows and columns")
        print(f"[nmfk] HALS nnsvd prune: minimum silhouette by k {sils}; "
              f"{len(zero_rows)} zero rows and {len(zero_cols)} zero columns "
              f"pruned and restored", flush=True)
    del X

    # the BCD sweep through the library on the planted 14400 x 9600 matrix
    # (rand init): its products are plain, no kernel of K1-K4 runs
    _, _, X = generate_data(**PLANTED)
    ks = range(2, 8)
    with tempfile.TemporaryDirectory() as tmp:
        cfg = NMFkConfig(nmf=NMFConfig(norm="fro", method="bcd", itr=400),
                         start_k=ks[0], end_k=ks[-1], perturbations=10,
                         results_path=tmp + "/", fname="X", checkpoint=False)
        timing.reset()
        zero_counts()
        t0 = time.perf_counter()
        nopt = NMFk(cfg, dev).fit(X.astype(np.float32))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        ran = read_counts()
        stages = {st: round(timing.TIMINGS.get(st, 0.0), 3) for st in
                  ("ensemble_solve", "ensemble_init", "clustering",
                   "regression")}
        print(f"[nmfk] BCD (library) npy {X.shape[0]}x{X.shape[1]} k=2..7, "
              f"10 perturbations, 400 iterations: nopt {nopt}, {secs:.2f} s, "
              f"stage seconds {stages}, launches {ran}", flush=True)
        check(nopt == 4, f"NMFk BCD chose k={nopt}, not 4")
        check(ran == none, f"NMFk BCD launched {ran}, expected nothing")
        for k in ks:
            out = read_cluster_results(os.path.join(tmp, "X", str(k)))
            check(set(out) == set(RESULT_DATASETS)
                  and out["clusterSilhouetteCoefficients"].shape == (k,)
                  and all(np.isfinite(v).all() for v in out.values()),
                  f"NMFk BCD k={k} results")
        # the KL-MU sweep through the library at ks 4, 34 and 64: K2 on its
        # register kernel (k = 4) and its 3xTF32 kernel (KP = 64), the
        # refit's rows split; nopt = 4, as the JAX package chooses at these
        # ks on the CPU (tests/test_torch_nmfk.py::
        # test_kl_sweep_at_wide_k_matches_jax)
        cfg = NMFkConfig(nmf=NMFConfig(norm="kl", itr=400), **WIDE_SWEEP,
                         perturbations=10, results_path=tmp + "/wide/",
                         fname="X", checkpoint=False)
        staged_sweep(X.astype(np.float32), cfg, "KL-MU", ("kl_uht", "kl_wtu"),
                     ("kl_wtu",))
        # the same ks with use_fused=True on bf16 members: K3's tensor-core
        # kernel at KP = 8 (k = 4) and 64 (k = 34, 64) in the ensemble, one
        # launch an iteration for the 10-member stack, K2b in the refit
        cfg = NMFkConfig(nmf=NMFConfig(norm="kl", itr=400, use_fused=True,
                                       a_precision="bfloat16"), **WIDE_SWEEP,
                         perturbations=10, results_path=tmp + "/wide_fused/",
                         fname="X", checkpoint=False)
        staged_sweep(X.astype(np.float32), cfg, "KL-MU use_fused",
                     ("fused_mu_kl_bf16",), ("kl_wtu",))
        wide_k = sum(k > 32 for k in cfg.k_range) * cfg.nmf.itr
        check(fused_kl.wide_launches == {**dict.fromkeys(
                  fused_kl.wide_launches, 0), "fused_mu_kl_bf16": wide_k},
              f"NMFk KL-MU use_fused at ks {list(cfg.k_range)}: K3 past k = "
              f"32 {fused_kl.wide_launches}, expected {wide_k} under "
              f"fused_mu_kl_bf16")
    del X

    # -- 6. checkpoints, resume and the rest of the job -----------------
    from pydnmfk_tpu_torch.models import ml_recognition, nmfk as nmfk_mod
    from pydnmfk_tpu_torch.models import sampler
    from pydnmfk_tpu_torch.utils import checkpoint as ckpt_mod
    from pydnmfk_tpu_torch.utils import io as io_mod
    from pydnmfk_tpu_torch.utils.io import DataWriter

    # a checkpointed NMF.fit (solve_checkpoint_every=10, 40 iterations) at
    # 57600 x 38400, k = 32: K1 on the f32 A, K1-u8 on its quantization, K3
    # on a bf16 copy (use_fused), each unchunked, chunked, failed by a raise
    # right after the saver's second save, and resumed
    A = torch.rand((M, K), generator=gen, device=dev) @ torch.rand(
        (K, N), generator=gen, device=dev)
    real_save = ckpt_mod.SolveCheckpoint.save
    saves = []

    def timed_save(self, W, H, i):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        real_save(self, W, H, i)
        saves.append(time.perf_counter() - t0)

    def failing_save(self, W, H, i):
        timed_save(self, W, H, i)
        if len(saves) == 2:
            raise RuntimeError("injected failure after the second save")

    def ckpt_fit(cfg, label):
        """NMF.fit of A under cfg, counters from zero: (error, launches,
        seconds)."""
        zero_counts()
        t0 = time.perf_counter()
        _, _, err = NMF(cfg, dev).fit(A)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        ran = {key: n for key, n in read_counts().items() if n}
        check(np.isfinite(err), f"checkpointed {label}: error {err}")
        return err, ran, secs

    with tempfile.TemporaryDirectory() as tmp:
        for label, norm, kw, key in (
                ("FRO-MU f32", "fro", {}, "fused_mu_fro"),
                ("FRO-MU uint8-A", "fro", {"a_precision": "uint8"},
                 "fused_mu_fro_u8"),
                ("KL-MU bf16-A use_fused", "kl",
                 {"a_precision": "bfloat16", "use_fused": True},
                 "fused_mu_kl_bf16")):
            cfg = NMFConfig(k=K, norm=norm, itr=4 * ITR, results_path=tmp,
                            **kw)
            err0, ran0, secs0 = ckpt_fit(cfg, label)
            cfg = cfg.replace(solve_checkpoint_every=ITR)
            saves.clear()
            ckpt_mod.SolveCheckpoint.save = timed_save
            err1, ran1, secs1 = ckpt_fit(cfg, label)
            n_saves, per_save = len(saves), 1e3 * sum(saves) / len(saves)
            saves.clear()
            ckpt_mod.SolveCheckpoint.save = failing_save
            zero_counts()
            try:
                NMF(cfg, dev).fit(A)
                check(False, f"checkpointed {label}: the injected failure "
                             f"did not happen")
            except RuntimeError as e:
                check("injected failure" in str(e), f"checkpointed {label}: "
                                                    f"{e!r}")
            read_counts()
            ckpt_mod.SolveCheckpoint.save = real_save
            path = os.path.join(tmp, f"solve_ckpt_k{K}")
            check(os.path.exists(path), f"checkpointed {label}: no file")
            err2, ran2, secs2 = ckpt_fit(cfg, label)
            rel1, rel2 = abs(err1 / err0 - 1), abs(err2 / err0 - 1)
            print(f"[resume] {label} {M}x{N} k={K}, {cfg.itr} iterations "
                  f"({smi}): unchunked {secs0:.3f} s, error {err0:.7f}; "
                  f"chunks of {ITR} {secs1:.3f} s, error {err1:.7f} "
                  f"(relative difference {rel1:.2e}), {n_saves} saves at "
                  f"{per_save:.2f} ms each; resumed after the "
                  f"second save {secs2:.3f} s, error {err2:.7f} ({rel2:.2e}), "
                  f"launches {ran0} / {ran1} / {ran2}", flush=True)
            check(ran0 == ran1 == {key: cfg.itr},
                  f"checkpointed {label}: launches {ran0}, {ran1}, expected "
                  f"{cfg.itr} under {key}")
            check(ran2 == {key: cfg.itr // 2},
                  f"resumed {label}: launches {ran2}, expected "
                  f"{cfg.itr // 2} under {key}")
            check(rel1 <= 1e-5 and rel2 <= 1e-5,
                  f"checkpointed {label}: errors {err1}, {err2} not within "
                  f"1e-5 of {err0}")
            check(not os.path.exists(path), f"resumed {label}: checkpoint "
                                            f"left behind")
    del A
    torch.cuda.empty_cache()

    # the FRO-MU NMFk sweep on the planted 14400 x 9600 matrix, k = 2..7, 10
    # members in batches of 5 with checkpoint=True: unbroken, then failed
    # right after k = 5's first part and run again, then extended to k = 9
    # (a resume past a finished sweep solves only the new ks)
    _, _, X = generate_data(**PLANTED)
    X = X.astype(np.float32)
    stage_names = ("ensemble_solve", "clustering", "regression")

    def resume_sweep(path, end_k=7):
        cfg = NMFkConfig(nmf=NMFConfig(norm="fro", itr=400), start_k=2,
                         end_k=end_k, perturbations=10, ensemble_batch=5,
                         results_path=path + "/", fname="X", checkpoint=True)
        timing.reset()
        zero_counts()
        t0 = time.perf_counter()
        model = NMFk(cfg, dev)
        nopt = model.fit(X)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        ran = {key: n for key, n in read_counts().items() if n}
        stages = {st: round(timing.TIMINGS.get(st, 0.0), 3)
                  for st in stage_names}
        return cfg, nopt, secs, stages, ran

    with tempfile.TemporaryDirectory() as tmp:
        gold_cfg, nopt, secs, stages, ran = resume_sweep(tmp + "/gold")
        print(f"[resume] FRO-MU NMFk unbroken {X.shape[0]}x{X.shape[1]} "
              f"k=2..7, 10 perturbations in batches of 5, 400 iterations "
              f"({smi}): nopt {nopt}, {secs:.2f} s, stage seconds {stages}, "
              f"launches {ran}", flush=True)
        check(nopt == 4 and ran == {"fused_mu_fro": 2 * 6 * 400},
              f"unbroken sweep: nopt {nopt}, launches {ran}")
        # phase 3's FRO sweep of the same members, in batches of 5: how far
        # two 1x1 sweeps lie apart, for phase 9's and the [k-sweep]
        # phase's members
        ensemble_refs["e4 1x1 FRO-MU"] += ({k: read_cluster_results(
            os.path.join(tmp, "gold", "X", str(k))) for k in KSWEEP_KS},)
        real_part = nmfk_mod._save_ensemble_part

        def failing_part(parts_dir, off, *a):
            real_part(parts_dir, off, *a)
            if off == 0 and parts_dir.endswith(os.sep + os.path.join(
                    "5", "ensemble_parts")):
                raise RuntimeError("injected failure after k = 5's first "
                                   "part")

        nmfk_mod._save_ensemble_part = failing_part
        zero_counts()
        t0 = time.perf_counter()
        try:
            resume_sweep(tmp + "/run")
            check(False, "the sweep's injected failure did not happen")
        except RuntimeError as e:
            check("injected failure" in str(e), f"broken sweep: {e!r}")
        finally:
            nmfk_mod._save_ensemble_part = real_part
        broken_s = time.perf_counter() - t0
        parts = os.path.join(tmp, "run", "X", "5", "ensemble_parts")
        check(sorted(os.listdir(parts)) == ["part_000000.pt"],
              f"broken sweep: parts {os.listdir(parts)}")
        cfg, nopt, secs, stages, ran = resume_sweep(tmp + "/run")
        want = 400 * (1 + 2 + 2)       # k = 5's second batch, k = 6 and 7
        diffs = {}
        for k in cfg.k_range:
            a, b = (read_cluster_results(os.path.join(c.results_path, "X",
                                                      str(k)))
                    for c in (cfg, gold_cfg))
            diffs[k] = {name: float(np.max(np.abs(a[name] - b[name])
                                           / np.maximum(np.abs(b[name]),
                                                        1e-30)))
                        for name in ("ErrTol", "L_err", "avgErr", "AIC")}
            diffs[k]["sils"] = float(np.max(np.abs(
                a["clusterSilhouetteCoefficients"]
                - b["clusterSilhouetteCoefficients"])))
        worst = {name: max(d[name] for d in diffs.values())
                 for name in diffs[2]}
        print(f"[resume] FRO-MU NMFk failed after k = 5's first part "
              f"({broken_s:.2f} s) and run again ({smi}): nopt {nopt}, "
              f"{secs:.2f} s, stage seconds {stages}, launches {ran} "
              f"(expected fused_mu_fro {want}: k = 5's second batch, k = 6 "
              f"and 7; none in the refits); largest difference from the "
              f"unbroken sweep over k = 2..7 {worst}", flush=True)
        check(nopt == 4, f"resumed sweep chose k={nopt}, not 4")
        check(ran == {"fused_mu_fro": want},
              f"resumed sweep launched {ran}, expected {want}")
        # K1 adds W'^T A in atomic order, so the runs are not bitwise: the
        # largest differences were 2.8e-6 (ErrTol), 7.2e-5 (L_err), 5.2e-7
        # (avgErr) and 1.4e-6 (silhouettes, absolute) on an H100
        check(worst["ErrTol"] <= 1e-4 and worst["avgErr"] <= 1e-4
              and worst["L_err"] <= 1e-3 and worst["sils"] <= 1e-4,
              f"resumed sweep's stats differ from the unbroken one's: "
              f"{worst}")
        check(not any(os.path.exists(os.path.join(tmp, "run", "X", str(k),
                                                  "ensemble_parts"))
                      for k in cfg.k_range), "ensemble_parts left behind")
        cfg, nopt9, secs, stages, ran = resume_sweep(tmp + "/run", end_k=9)
        print(f"[resume] the same sweep extended to k = 9 ({smi}): nopt "
              f"{nopt9}, {secs:.2f} s, stage seconds {stages}, launches "
              f"{ran}", flush=True)
        check(ran == {"fused_mu_fro": 2 * 2 * 400},
              f"extended sweep launched {ran}, expected k = 8 and 9 only")
        res_dir = os.path.join(tmp, "run", "X")
        selection = os.path.exists(os.path.join(res_dir,
                                                "X_selection_plot.pdf"))

        # the folder format at 1x1 through the CLI (the chunk file X0.npy),
        # and a 2 x 2 chunk layout of uneven dims through DataReader
        np.save(os.path.join(tmp, "X0.npy"), X)
        real_read = io_mod.DataReader.read
        read = []

        def keep(self, grid=None):
            out = real_read(self, grid)
            read.append(out)
            return out

        io_mod.DataReader.read = keep
        zero_counts()
        try:
            out = cli.main(["--process=pyDNMF", "--p_r=1", "--p_c=1",
                            "--ftype=folder", f"--fpath={tmp}/", "--fname=X",
                            "--norm=fro", "--k=4", f"--itr={ITR}",
                            f"--results_path={tmp}/res_folder/",
                            "--timing_stats=true"])
        finally:
            io_mod.DataReader.read = real_read
        ran = {key: n for key, n in read_counts().items() if n}
        check(len(read) == 1 and np.array_equal(read[0], X)
              and read[0].dtype == X.dtype, "the CLI's folder read")
        check(ran == {"fused_mu_fro": ITR} and np.isfinite(out["err"]),
              f"the CLI's folder run: launches {ran}, error {out['err']}")
        timing_plot = os.path.exists(os.path.join(tmp, "res_folder",
                                                  "timing.png"))
        U = X[:9601, :6399]
        for i in range(2):
            r0, r1 = io_mod.block_range(U.shape[0], 2, i)
            for j in range(2):
                c0, c1 = io_mod.block_range(U.shape[1], 2, j)
                np.save(os.path.join(tmp, f"U{i * 2 + j}.npy"),
                        U[r0:r1, c0:c1])
        U_read = io_mod.DataReader(f"{tmp}/", "U", "folder",
                                   pgrid=(2, 2)).read()
        check(np.array_equal(U_read, U), "DataReader folder 2x2 read")
        print(f"[io] --ftype=folder at 1x1 through the CLI ({X.shape}) and "
              f"a 2x2 chunk layout of {U.shape} through DataReader: equal "
              f"bitwise; CLI relative error {out['err']:.6f}, launches {ran}",
              flush=True)

        # kl_divergence of one member (the planted matrix and its k = 4
        # regression factors) on the card against f64 on the CPU
        k_path = os.path.join(res_dir, "4")
        Wr = np.load(os.path.join(k_path, "W_reg_factors", "W.npy"))
        Hr = np.load(os.path.join(k_path, "H_reg_factors", "H.npy"))
        on_dev = [torch.from_numpy(x).to(dev) for x in (X, Wr, Hr)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        kl_dev = float(linalg.kl_divergence(*on_dev, eps,
                                            linalg.error_chunk_rows(*X.shape)))
        kl_s = time.perf_counter() - t0
        del on_dev
        kl_ref = float(linalg.kl_divergence(
            *(torch.from_numpy(x).double() for x in (X, Wr, Hr)), eps, 2048))
        rel = abs(kl_dev / kl_ref - 1)
        print(f"[linalg] kl_divergence {X.shape} k=4 on the card "
              f"{kl_dev:.6f} ({kl_s:.3f} s), f64 on the CPU {kl_ref:.6f}: "
              f"relative difference {rel:.2e} (limit 1e-5)", flush=True)
        check(rel <= 1e-5, f"kl_divergence {kl_dev} vs {kl_ref}")

        # one solve under timing.trace: a Chrome trace that names K1
        trace_dir = os.path.join(tmp, "trace")
        zero_counts()
        with timing.trace(trace_dir):
            NMF(NMFConfig(k=4, norm="fro", itr=ITR), dev).fit(X)
        ran = {key: n for key, n in read_counts().items() if n}
        with open(os.path.join(trace_dir, "trace.json")) as f:
            text = f.read()
        check(ran == {"fused_mu_fro": ITR}, f"traced solve launched {ran}")
        check("fused_mu_fro" in text, "the trace does not name K1")
        print(f"[timing] trace of one FRO-MU solve: "
              f"{len(text) / 1e6:.2f} MB, {text.count('fused_mu_fro')} "
              f"mentions of K1", flush=True)

        # the k-predictor: train_mlp on the card on windows of synthetic
        # sweeps (silhouettes collapse past the planted k), its numpy
        # forward against the torch module; predict_k on the sweep's dir
        apps, true_ks = [], []
        for i, kt in enumerate((3, 4, 5, 6, 7, 8)):
            d = os.path.join(tmp, "ml", str(i))
            for k in range(1, 15):
                sils = np.where(np.arange(k) < kt, 1.0, 0.2)
                err = 1.0 / min(k, kt) + 0.001 * k
                DataWriter(os.path.join(d, str(k))).save_cluster_results({
                    "clusterSilhouetteCoefficients": sils,
                    "avgSilhouetteCoefficients": sils.mean(),
                    "L_err": np.full(10, err), "L_errDist": err,
                    "avgErr": err, "recon_err": np.full(4, err),
                    "AIC": -1000.0 / min(k, kt)})
            apps.append(ml_recognition.MLFeatureTools(
                d, None).build_statistics())
            true_ks.append(kt)
        Xw, yw = ml_recognition.build_training_windows(apps, true_ks)
        t0 = time.perf_counter()
        mlp, net = ml_recognition.train_mlp(Xw, yw, hidden=(32,),
                                            epochs=200, batch_size=8,
                                            seed=0, device=dev,
                                            return_module=True)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        with torch.no_grad():
            logits = net(torch.from_numpy(Xw.astype(np.float32)).to(
                dev)).double().cpu().numpy()
        ref = mlp.logits(Xw.astype(np.float32))
        rel = float(np.abs(ref - logits).max() / np.abs(logits).max())
        acc = float(np.mean(mlp.predict(Xw) == yw))
        with tempfile.NamedTemporaryFile(suffix=".json") as f:
            mlp.to_json(f.name)
            k_pred = ml_recognition.predict_k(res_dir, f.name)
        print(f"[ml] train_mlp on the card, {Xw.shape[0]} windows, 200 "
              f"epochs: {train_s:.2f} s ({smi}), training accuracy {acc:.3f}, "
              f"numpy forward vs the module's logits {rel:.2e} (limit 1e-5); "
              f"predict_k on the sweep's results (k = 2..9): {k_pred}",
              flush=True)
        check(rel <= 1e-5, f"train_mlp: numpy forward {rel:.2e} off")

    # a seed_grid=(2, 2) member drawn on the card: the planted matrix's
    # top-left block tiled 2 x 2, so that every block's data is the same;
    # uniform noise tiles, Poisson blocks draw alike, the init tiles
    B = torch.from_numpy(np.tile(X[:PLANTED["m"] // 2, :PLANTED["n"] // 2],
                                 (2, 2))).to(dev)
    bm, bn = B.shape[0] // 2, B.shape[1] // 2
    blocks = lambda Y: [Y[..., i * bm:(i + 1) * bm, j * bn:(j + 1) * bn]
                        for i in range(2) for j in range(2)]
    for method, Y in (("uniform", B), ("poisson", (B * 50).round())):
        member = sampler.sample_ensemble(Y, 100, 0.015, [3], method,
                                         tile_grid=(2, 2))
        parts = blocks(member)
        check(all(torch.equal(parts[0], p) for p in parts[1:])
              and not torch.equal(member[0], Y),
              f"seed_grid {method} member's blocks differ")
    W0, H0 = sampler.init_ensemble_rand(100, [3], *B.shape, 4, torch.float32,
                                        dev, tile_grid=(2, 2))
    check(torch.equal(W0[:, :bm // 2], W0[:, bm // 2:bm])
          and torch.equal(H0[:, :, :bn // 2], H0[:, :, bn // 2:bn]),
          "seed_grid init is not tiled")
    print(f"[seed_grid] (2, 2) members of a {tuple(B.shape)} matrix drawn on "
          f"the card: uniform and Poisson blocks bitwise equal, init tiled "
          f"4-fold", flush=True)
    del B, X
    print(f"[plots] selection plot written: {selection}; timing plot "
          f"written: {timing_plot}", flush=True)

    # -- 7. the p_r x p_c grid: four ranks sharing the card over gloo ---
    import socket
    import torch.distributed as dist
    from pydnmfk_tpu_torch.parallel import mesh
    from pydnmfk_tpu_torch.utils import io as io_mod
    torch.cuda.empty_cache()
    # the 1x1 solves of every grid method from the grid's init, then the
    # same two MU solves on a one-rank NCCL group: the 1x1 grid through the
    # distributed code path
    A = planted_exact(dev)
    ref = {}
    for name, kw in GRID_METHODS.items():
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        W1, H1, err1 = NMF(NMFConfig(k=K, itr=ITR, seed=GRID_SEED, **kw),
                           dev).fit(A)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        ran = {key: n for key, n in read_counts().items() if n}
        W64, H64, err64 = NMF(NMFConfig(k=K, itr=ITR, seed=GRID_SEED,
                                        precision="float64", **kw),
                              dev).fit(A)
        spread = max(rel_max(W1, W64), rel_max(H1, H64))
        ref[name] = (err1, W1.cpu(), H1.cpu(), secs, ran,
                     max(GRID_FACTOR_TOL, 2 * spread))
        del W1, H1, W64, H64
        torch.cuda.empty_cache()
        print(f"[grid] 1x1 {name} at {M}x{N} k={K} ({ITR} iterations, "
              f"planted rank {GRID_PLANTED_RANK}): error {err1:.6f}, "
              f"{secs:.3f} s, launches {ran}; at f64 error {err64:.6f}, "
              f"factors {spread:.2e} from f32's", flush=True)
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    one = mesh.initialize(1, 1, "cuda", init_method=f"tcp://localhost:{port}",
                          rank=0, world_size=1, timeout=600)
    check(one.backend == "nccl", f"one rank took {one.backend}, not NCCL")
    for name, want in (("FRO-MU", {"fused_mu_fro": ITR}),
                       ("KL-MU", {"kl_uht": ITR, "kl_wtu": ITR})):
        zero_counts()
        before = {kind: list(v) for kind, v in one.stats.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, _, err = NMF(NMFConfig(k=K, itr=ITR, seed=GRID_SEED,
                                  **GRID_METHODS[name]), grid=one).fit(A)
        secs = time.perf_counter() - t0
        ran = {key: n for key, n in read_counts().items() if n}
        issued = {kind: n - before.get(kind, (0, 0))[0]
                  for kind, (n, _) in one.stats.items()}
        rel = abs(err / ref[name][0] - 1)
        print(f"[grid] 1x1 grid, one NCCL rank, {name}: error {err:.6f} "
              f"(1x1 without a grid {ref[name][0]:.6f}, relative difference "
              f"{rel:.2e}, limit {GRID_ERR_TOL:g}), {secs:.3f} s, launches "
              f"{ran}, collectives {issued}", flush=True)
        check(rel <= GRID_ERR_TOL and ran == want,
              f"one-rank NCCL {name}: error {err}, launches {ran}")
    dist.destroy_process_group()
    del A
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmp:
        _, secs = torchrun([os.path.abspath(__file__), "--grid-fits", tmp],
                           600)
        ranks = []
        for r in range(GRID_RANKS):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
        print(f"[grid] {GRID_RANKS} ranks on one card ({smi}), backend "
              f"{ranks[0]['backend']} (ranks share the card, so collectives "
              f"stage through the host: gloo times, not NCCL's), "
              f"{secs:.1f} s for the torchrun of all fits", flush=True)
        check(all(r["backend"] == "gloo" for r in ranks), "grid backend")
        for grid in GRID_SHAPES:
            tag = f"{grid[0]}x{grid[1]}"
            for name in GRID_METHODS:
                runs = [r[f"{tag} {name}"] for r in ranks]
                err1, W1, H1 = ref[name][:3]
                ftol = ref[name][5]
                errs = {run["err"] for run in runs}
                got = torch.load(os.path.join(tmp, f"{tag} {name}.pt"))
                d_w, d_h = rel_max(got["W"], W1), rel_max(got["H"], H1)
                rel = abs(runs[0]["err"] / err1 - 1)
                rows_ok = all(a["w_digest"] == b["w_digest"]
                              for ra, a in zip(ranks, runs)
                              for rb, b in zip(ranks, runs)
                              if ra["coords"][tag][0] == rb["coords"][tag][0])
                cols_ok = all(a["h_digest"] == b["h_digest"]
                              for ra, a in zip(ranks, runs)
                              for rb, b in zip(ranks, runs)
                              if ra["coords"][tag][1] == rb["coords"][tag][1])
                want = ({"kl_uht": ITR, "kl_wtu": ITR} if name == "KL-MU"
                        else {})
                print(f"[grid] {tag} {name}: error {runs[0]['err']:.6f} (1x1 "
                      f"{err1:.6f}, relative difference {rel:.2e}, limit "
                      f"{GRID_ERR_TOL:g}); gathered W, H vs 1x1 {d_w:.2e}, "
                      f"{d_h:.2e} (limit {ftol:.2e}); replicas "
                      f"bitwise equal: W {rows_ok}, H {cols_ok}; seconds "
                      f"per rank {[round(run['secs'], 3) for run in runs]} "
                      f"(1x1 {ref[name][3]:.3f}); rank 0 stages "
                      f"{runs[0]['stages']}; collectives (calls, bytes) "
                      f"{runs[0]['collectives']}; launches per rank "
                      f"{[run['launches'] for run in runs]}", flush=True)
                check(len(errs) == 1, f"{tag} {name}: ranks' errors {errs}")
                check(rel <= GRID_ERR_TOL and d_w <= ftol and d_h <= ftol,
                      f"{tag} {name} is not the 1x1 solve")
                check(rows_ok and cols_ok, f"{tag} {name}: replicas differ")
                check(all(run["launches"] == want for run in runs),
                      f"{tag} {name} launched "
                      f"{[run['launches'] for run in runs]}, not {want}")
                for run in runs:
                    for key, n in run["launches"].items():
                        main_path[key] += n
            for norm in ("fro", "kl"):
                steps = [r[f"{tag} step {norm}"] for r in ranks]
                print(f"[grid] {tag} one {norm.upper()}-MU step: collectives "
                      f"{steps[0]['counts']}, bytes per rank "
                      f"{[st['bytes'] for st in steps]}, ms per rank "
                      f"{[round(st['ms'], 2) for st in steps]}, of it in "
                      f"collectives {[round(st['dist_comm_ms'], 2) for st in steps]}",
                      flush=True)
                check(all(st["counts"] == {"all-reduce": 4} for st in steps),
                      f"{tag} {norm} step collectives {steps[0]['counts']}")

    # the NMFk sweep through the CLI under torchrun on a 2 x 2 grid, beside
    # the 1x1 sweep on the same members
    _, _, X = generate_data(**PLANTED)
    with tempfile.TemporaryDirectory() as tmp:
        np.save(os.path.join(tmp, "X.npy"), X.astype(np.float32))
        del X
        base = ["--process=pyDNMFk", "--ftype=npy", f"--fpath={tmp}/",
                "--fname=X", *GRID_SWEEP]
        zero_counts()
        t0 = time.perf_counter()
        one_out = cli.main(["--p_r=1", "--p_c=1", "--norm=fro",
                            f"--results_path={tmp}/one/", *base])
        one_s = time.perf_counter() - t0
        read_counts()
        # the FRO-MU and the KL-MU sweep run at once, eight processes
        # sharing the card and the host's cores: their seconds time both
        runs = {}
        try:
            runs["fro"] = torchrun_start(
                ["-m", "pydnmfk_tpu_torch", "--p_r=2", "--p_c=2",
                 "--norm=fro", "--timing_stats=true",
                 f"--results_path={tmp}/grid/", *base])
            runs["kl"] = torchrun_start(
                [os.path.abspath(__file__), "--grid-cli", tmp, "--p_r=2",
                 "--p_c=2", "--norm=kl", f"--results_path={tmp}/grid_kl/",
                 *base])
            out, secs = torchrun_wait(runs["fro"], 900)
            _, kl_secs = torchrun_wait(runs["kl"], 900)
        finally:
            for run in runs.values():
                torchrun_stop(run)
        lines = [ln for ln in out.splitlines() if "Rank estimated" in ln]
        with open(os.path.join(tmp, "grid", "Timing_stats.csv")) as f:
            names, values = list(csv.reader(f))
        stages = {n: round(float(v), 3) for n, v in zip(names, values)}
        worst = {"ErrTol": 0.0, "avgErr": 0.0, "L_err": 0.0, "sils": 0.0}
        for k in GRID_SWEEP_KS:
            a = read_cluster_results(os.path.join(tmp, "grid", "X", str(k)))
            b = read_cluster_results(os.path.join(tmp, "one", "X", str(k)))
            for key in ("ErrTol", "avgErr", "L_err"):
                worst[key] = max(worst[key], float(np.max(
                    np.abs(a[key] - b[key]) / np.abs(b[key]).max())))
            worst["sils"] = max(worst["sils"], float(np.max(np.abs(
                a["clusterSilhouetteCoefficients"]
                - b["clusterSilhouetteCoefficients"]))))
            Wg, Hg = io_mod.read_factors(os.path.join(tmp, "grid", "X",
                                                      str(k)), (2, 2))
            files = sorted(os.listdir(os.path.join(tmp, "grid", "X", str(k),
                                                   "W_reg_factors")))
            check(Wg.shape == (PLANTED["m"], k) and Hg.shape == (
                k, PLANTED["n"]) and files == [f"W_{b}.npy"
                                               for b in range(4)],
                  f"grid sweep k={k} factor files {files}")
        print(f"[grid] NMFk FRO-MU sweep through the CLI under torchrun, 2x2 "
              f"grid, {PLANTED['m']}x{PLANTED['n']} {' '.join(GRID_SWEEP)} "
              f"({smi}): {lines}, {secs:.2f} s for the torchrun, beside the "
              f"KL sweep's (1x1 "
              f"{one_s:.2f} s, nopt {one_out['nopt']}); rank 0 stage seconds "
              f"{stages}; per-k statistics against the 1x1 sweep's, max "
              f"difference over max (silhouettes: absolute) {worst} "
              f"(limits 1e-3, 1e-3, 1e-2, 1e-3)", flush=True)
        check(lines == ["Rank estimated by NMFk = 4"],
              f"grid sweep printed {lines}")
        check(worst["ErrTol"] <= 1e-3 and worst["avgErr"] <= 1e-3
              and worst["L_err"] <= 1e-2 and worst["sils"] <= 1e-3,
              f"grid sweep's stats are not the 1x1 sweep's: {worst}")
        # KL-MU: exact K2 launches on every rank, ensemble and refit
        cli_ranks = []
        for r in range(GRID_RANKS):
            with open(os.path.join(tmp, f"cli_rank{r}.json")) as f:
                cli_ranks.append(json.load(f))
        per_k = 400 * len(GRID_SWEEP_KS)
        want = {"kl_uht": per_k, "kl_wtu": 2 * per_k}
        print(f"[grid] NMFk KL-MU sweep through the CLI under torchrun, 2x2 "
              f"grid: nopt {[r['nopt'] for r in cli_ranks]}, {kl_secs:.2f} "
              f"s for the torchrun (beside the FRO sweep's), "
              f"launches per rank {[r['launches'] for r in cli_ranks]} "
              f"(expected {want}: 400 K2a + K2b a k in the ensemble, one "
              f"batch of 10, and 400 K2b a k in the refit)", flush=True)
        check(all(r["nopt"] == 4 and r["launches"] == want
                  for r in cli_ranks), "grid KL sweep")
        for r in cli_ranks:
            for key, n in r["launches"].items():
                main_path[key] += n

    # K2a and K2b on the grid's block shapes against their plain versions:
    # a 2 x 2 block of the 57600 x 38400 matrix at k = 32, and the 2 x 2
    # blocks of the 10-member 14400 x 9600 stack at k = 7
    for label, shp in ((f"2x2 block {M // 2}x{N // 2} k={K}",
                        (M // 2, N // 2, K)),
                       (f"2x2 block {ENS} x {EM // 2}x{EN // 2} k=7",
                        (ENS, EM // 2, EN // 2, 7))):
        if len(shp) == 3:
            a = planted_exact(dev, slice(0, M // 2), slice(0, N // 2))
            Wb = torch.rand((shp[0], shp[2]), generator=gen, device=dev)
            Hb = torch.rand((shp[2], shp[1]), generator=gen, device=dev)
            B = 1
        else:
            B = shp[0]
            a = torch.rand(shp[:3], generator=gen, device=dev)
            Wb = torch.rand((B, shp[1], shp[3]), generator=gen, device=dev)
            Hb = torch.rand((B, shp[3], shp[2]), generator=gen, device=dev)
        work = 4 * B * a.shape[-2] * a.shape[-1] * Wb.shape[-1]
        ch = linalg.error_chunk_rows(*a.shape[-2:])
        kernel_case("K2a kl_uht", label, lambda: kl.kl_uht(a, Wb, Hb, eps),
                    lambda: kl.kl_uht_plain(a, Wb, Hb, eps, ch),
                    TOL[torch.float32], (work, nbytes(a, Wb, Hb, Wb)))
        kernel_case("K2b kl_wtu", label, lambda: kl.kl_wtu(a, Wb, Hb, eps),
                    lambda: kl.kl_wtu_plain(a, Wb, Hb, eps, ch),
                    TOL[torch.float32], (work, nbytes(a, Wb, Hb, Hb)))
        del a, Wb, Hb
    torch.cuda.empty_cache()

    # -- 8. a sparse A on the grid: each rank's block in the dual ELL ----
    sparse_grid_phase(dev, smi, gen, nyt_ref, topic_ref, k4_cases,
                      zero_counts, read_counts, main_path)
    del nyt_ref, topic_ref

    # -- 9. the ensemble axis p_e: NMFk's members over groups of ranks ----
    ensemble_phase(smi, ensemble_refs, main_path)
    ksweep_refs = {"planted FRO-MU": ensemble_refs["e4 1x1 FRO-MU"],
                   "planted KL-MU": ensemble_refs["e2 2x1 KL-MU"],
                   "planted KL-MU use_fused bf16": fused_bf16_ref,
                   "topic FRO-MU": ensemble_refs["e4 1x1 sparse FRO-MU"]}
    del ensemble_refs, fused_bf16_ref

    # -- 10. the K-padded sweep: padded kernels, then the library sweeps ---
    k_sweep_phase(dev, smi, gen, ksweep_refs, zero_counts, read_counts)
    del ksweep_refs

    # -- 11. the examples on the card ---------------------------------------
    examples_phase(dev, smi, gen, kernel_case, zero_counts, read_counts)

    for name, n in main_path.items():
        check(n > 0, f"kernel {name} was not launched on the main path")
    for name in ("kl_uht", "kl_wtu", "fused_mu_kl", "fused_mu_kl_bf16",
                 "fused_mu_kl_u8", "ell_gather", "ell_gather_ratio"):
        check(main_path_wide[name] > 0, f"kernel {name} was not launched "
                                        f"past k = 32 on the main path")

    # -- 12. report ------------------------------------------------------
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
                                 ("ell_gather", "ell_gather_ratio")),
               # the f16 instantiations (an f16 A; K4: f16 values)
               "K1 fused_mu_fro f16": ("fused_mu_fro.cu", "ops/fused_mu.py:50",
                                       ("fused_mu_fro_f16",)),
               "K2a kl_uht f16": ("kl_ratio.cu", "ops/pallas_kernels.py:78",
                                  ("kl_uht_f16",)),
               "K2b kl_wtu f16": ("kl_ratio.cu", "ops/pallas_kernels.py:96",
                                  ("kl_wtu_f16",)),
               "K3 fused_mu_kl f16": ("fused_mu_kl.cu", "ops/fused_kl.py:44",
                                      ("fused_mu_kl_f16",)),
               "K4 ell_gather f16": ("ell_gather.cu", "ops/pallas_ell.py:52",
                                     ("ell_gather_f16",
                                      "ell_gather_ratio_f16"))}
    # the kernels past k = 32 (K2's 3xTF32 ones; K3's 3xTF32 one and its
    # tensor-core one at KP = 64; K4's slab kernels, with f32 and f16
    # values), counted apart by the wrappers; the rows above count the rest
    wide = {"K2a kl_uht k>32": ("kl_ratio.cu", "ops/pallas_kernels.py:78",
                                ("kl_uht",)),
            "K2b kl_wtu k>32": ("kl_ratio.cu", "ops/pallas_kernels.py:96",
                                ("kl_wtu",)),
            "K3 fused_mu_kl k>32": ("fused_mu_kl.cu", "ops/fused_kl.py:44",
                                    ("fused_mu_kl", "fused_mu_kl_bf16",
                                     "fused_mu_kl_f16", "fused_mu_kl_u8")),
            "K4 ell_gather k>32": ("ell_gather.cu", "ops/pallas_ell.py:52",
                                   ("ell_gather", "ell_gather_ratio",
                                    "ell_gather_f16",
                                    "ell_gather_ratio_f16"))}
    narrow = {key: main_path[key] - main_path_wide.get(key, 0)
              for key in main_path}
    kernels = [{"name": name, "route": "cuda",
                "source": f"pydnmfk_tpu_torch/csrc/{src}",
                "replaces": f"pydnmfk_tpu/{tpu}",
                "launches": sum(counted[c] for c in keys),
                "launches_by_mode": {c: counted[c] for c in keys},
                **rows[name]}
               for table, counted in ((sources, narrow),
                                      (wide, main_path_wide))
               for name, (src, tpu, keys) in table.items()]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--grid-fits"]:
        grid_fits(sys.argv[2])
    elif sys.argv[1:2] == ["--sparse-grid-fits"]:
        sparse_grid_fits(sys.argv[2])
    elif sys.argv[1:2] == ["--grid-cli"]:
        grid_cli(sys.argv[2], sys.argv[3:])
    elif sys.argv[1:2] == ["--ensemble-fits"]:
        ensemble_fits(sys.argv[2], sys.argv[3])
    elif sys.argv[1:2] == ["--example-rank"]:
        example_rank(sys.argv[2], sys.argv[3:])
    else:
        main()
