#!/usr/bin/env python3
"""Times kernel K2b (W^T (A / (W H + eps)), ``csrc/kl_ratio.cu``) on one GPU
on a 10-member stack under two row splits, and checks which one gives a
member the bits it has alone.

    python3 bench_torch/k2b_member_split_probe.py

K2b's own plan (``ops/kl.py::wtu_split_plan``) counts the blocks of the
whole stack, B x strips, so a stack of 10 members splits its rows less
than one member alone does, and a member's sums come out in another order
in the stack than alone. The second pass of K1 and K3 takes its split from
one member's shape (``ops/strip.py::split_plan``), so a member has the same
bits in any batch. For each case (the NMFk ensemble's 10 x 14400 x 9600
stacks at k = 8 on an f32 and a bf16 A, and at k = 34 and 64 on an f32 A)
it prints one JSON line: the splits of each plan, K2b's ms under each (CUDA
events, median of 7 after a warm-up), and whether member 3 of the stack has
the bits it has alone under each; with the card's name and power limit.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


def main():
    if not torch.cuda.is_available():
        sys.exit("k2b_member_split_probe: no CUDA device")
    sys.path.insert(0, ROOT)
    from pydnmfk_tpu_torch.ops import kl, strip

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    eps = float(torch.finfo(torch.float32).eps)
    gen = torch.Generator(dev)
    gen.manual_seed(2024)
    B, m, n = 10, 14400, 9600
    A = torch.rand((B, m, n), generator=gen, device=dev)
    for label, k, a in (("f32", 8, A), ("bf16-A", 8, A.to(torch.bfloat16)),
                        ("f32", 34, A), ("f32", 64, A)):
        W = torch.rand((B, m, k), generator=gen, device=dev)
        H = torch.rand((B, k, n), generator=gen, device=dev)
        geo = kl.wtu_geometry(k)
        own = kl.wtu_split_plan(B, m, n, k, *geo, sms)[0]
        member = strip.split_plan(a.shape, k, *geo, sms)[0]
        alone = kl.kl_wtu(a[3], W[3], H[3], eps)
        row = {"case": f"{label} {B} x {m}x{n} k={k}", "card": smi}
        for name, splits in (("own", own), ("per_member", member)):
            out = kl.kl_wtu(a, W, H, eps, splits=splits)
            row[f"{name}_splits"] = splits
            row[f"{name}_ms"] = median_ms(
                lambda: kl.kl_wtu(a, W, H, eps, splits=splits))
            row[f"{name}_member_bitwise_alone"] = torch.equal(out[3], alone)
        print(json.dumps(row), flush=True)
        del W, H


if __name__ == "__main__":
    main()
