#!/usr/bin/env python3
"""Times kernel K1 (the FRO-MU W pass, ``csrc/fused_mu_fro.cu``) on one GPU.

    python3 bench_torch/k1_bench.py [--root DIR] [--label NAME]

Imports ``pydnmfk_tpu_torch`` from DIR (default: the root of this
checkout), so that two trees, say a parent commit unpacked with ``git archive``
and the change, can be timed in one run on one card, in turns (parent,
change, change, parent). The cases are those of ``chip_smoke.py``'s phase 2:
an f32, a bf16 and a uint8 A at 57600 x 38400, k = 32, and an f32 and a bf16
10-member 14400 x 9600, k = 8 stack, all drawn from the same seed. For each
case it prints one JSON line: the kernel's ms (CUDA events, median of 7
after a warm-up), where the package runs K1 in two passes the ms of its
second pass alone (``ops/strip.py``, W'^T A; else null), its max relative
error against the plain version, the
library call's ms (``torch.matmul`` of A H^T and W^T A, on bf16 factors for
a bf16 or uint8 A) and the two-read floor (A read twice at 3.35 TB/s).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

PEAK_BYTES = 3.35e12      # H100 SXM HBM3


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


def rel_err(out, ref):
    return max(float((a.double() - b.double()).abs().max()
                     / b.double().abs().max()) for a, b in zip(out, ref))


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    p.add_argument("--label", default="")
    args = p.parse_args()
    if not torch.cuda.is_available():
        sys.exit("k1_bench: no CUDA device")
    sys.path.insert(0, os.path.abspath(args.root))
    from pydnmfk_tpu_torch.ops import fused_mu, linalg
    try:        # the two-pass K1 (its second pass timed alone)
        from pydnmfk_tpu_torch.ops import strip
    except ImportError:
        strip = None

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    eps = float(torch.finfo(torch.float32).eps)
    gen = torch.Generator(dev)
    gen.manual_seed(2024)

    def case(name, A, W, H):
        HHT = linalg.gram_t(H)
        out = fused_mu.fused_w_pass(A, W, H, HHT, eps)
        err = rel_err(out, fused_mu.fused_w_pass_plain(A, W, H, HHT, eps))
        pass2_ms = None
        if strip is not None:
            Wn = out[0].float()
            pass2_ms = median_ms(lambda: strip.wt_pass(A, Wn, None, eps, False))
            del Wn
        del out
        ms = median_ms(lambda: fused_mu.fused_w_pass(A, W, H, HHT, eps))
        if A.dtype == torch.float32:
            Al, Wl, Hl = A, W, H
        else:
            Al, Wl, Hl = (x.to(torch.bfloat16) for x in (A, W, H))
        lib_ms = median_ms(lambda: (torch.matmul(Al, Hl.mT),
                                    torch.matmul(Wl.mT, Al)))
        del Al, Wl, Hl
        floor = 2 * A.numel() * A.element_size() / PEAK_BYTES * 1e3
        print(json.dumps({"label": args.label, "case": name, "ms": ms,
                          "pass2_ms": pass2_ms,
                          "max_rel_err": err, "library_ms": lib_ms,
                          "two_read_floor_ms": floor, "card": smi}),
              flush=True)

    M, N, K = 57600, 38400, 32
    A = torch.rand((M, K), generator=gen, device=dev) @ torch.rand(
        (K, N), generator=gen, device=dev)
    W = torch.rand((M, K), generator=gen, device=dev)
    H = torch.rand((K, N), generator=gen, device=dev)
    case(f"f32 {M}x{N} k={K}", A, W, H)
    case(f"bf16-A {M}x{N} k={K}", A.to(torch.bfloat16), W, H)
    Q, _ = linalg.quantize_uint8(A)
    del A
    case(f"uint8-A {M}x{N} k={K}", Q, W, H)
    del Q, W, H
    torch.cuda.empty_cache()
    E, EM, EN, EK = 10, 14400, 9600, 8
    Ae = torch.rand((E, EM, EN), generator=gen, device=dev)
    We = torch.rand((E, EM, EK), generator=gen, device=dev)
    He = torch.rand((E, EK, EN), generator=gen, device=dev)
    case(f"f32 {E} x {EM}x{EN} k={EK}", Ae, We, He)
    case(f"bf16-A {E} x {EM}x{EN} k={EK}", Ae.to(torch.bfloat16), We, He)


if __name__ == "__main__":
    main()
