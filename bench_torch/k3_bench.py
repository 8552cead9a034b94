#!/usr/bin/env python3
"""Times kernel K3 (the one-pass KL-MU iteration, ``csrc/fused_mu_kl.cu``)
on one GPU, beside K2a + K2b, the unfused pair that does the same four
products.

    python3 bench_torch/k3_bench.py [--root DIR] [--label NAME] [--wide]

Imports ``pydnmfk_tpu_torch`` from DIR (default: the root of this
checkout), so that two trees, say a parent commit unpacked with ``git
archive`` and the change, can be timed in one run on one card, in turns
(parent, change, change, parent). The cases are those of ``chip_smoke.py``'s
phase 2: an f32, a bf16 and a uint8 A at 57600 x 38400, k = 32 (the planted
rank-32 A and its ``quantize_uint8``), and a 10-member 14400 x 9600, k = 8
stack in f32 and its bf16 copy (the NMFk ensemble's members under
``--a_precision=bfloat16``), all drawn from the same seed. For each case it prints one JSON
line: K3's ms and K2a + K2b's ms on the same inputs (CUDA events, median of
7 after a warm-up), the plain version's ms, K3's max relative error against
the plain version, and its bound: the larger of 8 m n k operations over
their peak (67 TFLOP/s f32 on the CUDA cores; 989 TFLOP/s bf16 for the bf16
operands of a bf16 or uint8 A) and the bytes, each input read once and each
output written once, over 3.35 TB/s.

``--wide`` times instead the cases of the smoke past k = 32: an f32, a bf16,
an f16 and a uint8 A (the f32 A's copies and its ``quantize_uint8``) at
57600 x 38400, k = 34 and 64, and the 10-member 14400 x 9600 stack in f32
and its bf16 copy at k = 34 (the NMFk sweep's ensemble width) and 64. There
K3 runs the 3xTF32 kernel for the f32 A (``tf::fused_mu_kl_tf32_kernel``;
bound at 165 TFLOP/s, the 3xTF32 rate, with the CUDA cores' 67 in
``cuda_core_bound_ms``) and the tensor-core kernel at KP = 64 for the
others (``tc::fused_mu_kl_tc_kernel``); the parents before them ran the
first port's ``fused_mu_kl_kernel`` at every A dtype. Without ``--wide`` the
f32 cases run ``f32::fused_mu_kl_f32_kernel`` and the others
``tc::fused_mu_kl_tc_kernel`` (k <= 32).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

from k1_bench import PEAK_BYTES, median_ms, rel_err

PEAK_FLOPS, PEAK_BF16 = 67e12, 989e12   # H100 SXM: f32 CUDA cores, bf16 dense
PEAK_3XTF32 = 495e12 / 3                # TF32 tensor cores, three a product


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    p.add_argument("--label", default="")
    p.add_argument("--wide", action="store_true",
                   help="the cases past k = 32 (k = 34 and 64)")
    args = p.parse_args()
    if not torch.cuda.is_available():
        sys.exit("k3_bench: no CUDA device")
    sys.path.insert(0, os.path.abspath(args.root))
    from pydnmfk_tpu_torch.ops import fused_kl, kl, linalg

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    eps = float(torch.finfo(torch.float32).eps)
    gen = torch.Generator(dev)
    gen.manual_seed(2024)

    def case(name, A, W, H):
        m, n = A.shape[-2:]
        chunk = linalg.error_chunk_rows(m, n)
        hrs = linalg.sum_axis(H, axis=-1)
        out = fused_kl.fused_kl_pass(A, W, H, hrs, eps)
        ref = fused_kl.fused_kl_pass_plain(A, W, H, hrs, eps, chunk)
        err = rel_err(out, ref)
        del out, ref
        ms = median_ms(lambda: fused_kl.fused_kl_pass(A, W, H, hrs, eps))
        pair_ms = median_ms(lambda: (kl.kl_uht(A, W, H, eps),
                                     kl.kl_wtu(A, W, H, eps)))
        plain_ms = median_ms(lambda: fused_kl.fused_kl_pass_plain(
            A, W, H, hrs, eps, chunk))
        wide = W.shape[-1] > 32
        peak = (PEAK_BF16 if A.dtype != torch.float32 else
                PEAK_3XTF32 if wide else PEAK_FLOPS)
        flops = 8 * A.numel() * W.shape[-1]
        t_ops = flops / peak * 1e3
        t_bytes = nbytes(A, W, H, hrs, W, H) / PEAK_BYTES * 1e3
        row = {"label": args.label, "case": name,
               "kernel": "K3 fused_mu_kl" + (" k>32" if wide else ""),
               "ms": ms, "k2a_plus_k2b_ms": pair_ms, "plain_ms": plain_ms,
               "max_rel_err": err, "bound_ms": max(t_ops, t_bytes),
               "bound_by": "operations" if t_ops >= t_bytes else "bytes",
               "two_read_floor_ms": 2 * nbytes(A) / PEAK_BYTES * 1e3}
        if wide and A.dtype == torch.float32:
            row["cuda_core_bound_ms"] = flops / PEAK_FLOPS * 1e3
        print(json.dumps({**row, "card": smi}), flush=True)

    M, N, K = 57600, 38400, 32
    E, EM, EN, EK = 10, 14400, 9600, 8
    A = torch.rand((M, K), generator=gen, device=dev) @ torch.rand(
        (K, N), generator=gen, device=dev)
    if args.wide:
        wide_cases(case, gen, dev, A, E, EM, EN)
        return
    W = torch.rand((M, K), generator=gen, device=dev)
    H = torch.rand((K, N), generator=gen, device=dev)
    case(f"f32 {M}x{N} k={K}", A, W, H)
    case(f"bf16-A {M}x{N} k={K}", A.to(torch.bfloat16), W, H)
    Q, _ = linalg.quantize_uint8(A)
    del A
    case(f"uint8-A {M}x{N} k={K}", Q, W, H)
    del Q, W, H
    torch.cuda.empty_cache()
    Ae = torch.rand((E, EM, EN), generator=gen, device=dev)
    We = torch.rand((E, EM, EK), generator=gen, device=dev)
    He = torch.rand((E, EK, EN), generator=gen, device=dev)
    case(f"f32 {E} x {EM}x{EN} k={EK}", Ae, We, He)
    # the members of the NMFk ensemble under --a_precision=bfloat16
    case(f"bf16-A {E} x {EM}x{EN} k={EK}", Ae.to(torch.bfloat16), We, He)


def wide_cases(case, gen, dev, A, E, EM, EN):
    """The cases past k = 32: every A dtype at A's shape, k = 34 and 64,
    and the f32 and bf16 member stacks at the same ks."""
    from pydnmfk_tpu_torch.ops import linalg
    M, N = A.shape
    for k in (34, 64):
        W = torch.rand((M, k), generator=gen, device=dev)
        H = torch.rand((k, N), generator=gen, device=dev)
        case(f"f32 {M}x{N} k={k}", A, W, H)
        for label, dtype in (("bf16-A", torch.bfloat16),
                             ("f16-A", torch.float16)):
            a = A.to(dtype)
            case(f"{label} {M}x{N} k={k}", a, W, H)
            del a
        Q, _ = linalg.quantize_uint8(A)
        case(f"uint8-A {M}x{N} k={k}", Q, W, H)
        del Q, W, H
    del A
    torch.cuda.empty_cache()
    Ae = torch.rand((E, EM, EN), generator=gen, device=dev)
    for k in (34, 64):
        We = torch.rand((E, EM, k), generator=gen, device=dev)
        He = torch.rand((E, k, EN), generator=gen, device=dev)
        case(f"f32 {E} x {EM}x{EN} k={k}", Ae, We, He)
        case(f"bf16-A {E} x {EM}x{EN} k={k}", Ae.to(torch.bfloat16), We, He)


if __name__ == "__main__":
    main()
