#!/usr/bin/env python3
"""Times kernels K2a and K2b past k = 32 (``csrc/kl_ratio.cu``) on one GPU.

    python3 bench_torch/k2_wide_bench.py [--root DIR] [--label NAME]

Imports ``pydnmfk_tpu_torch`` from DIR (default: the root of this
checkout), so that two trees, say a parent commit unpacked with ``git
archive`` and the change, can be timed in one run on one card, in turns
(parent, change, change, parent). The cases are those of ``chip_smoke.py``'s
phase 2 at k > 32: an f32 and a uint8 A at 57600 x 38400, k = 64, one
14400 x 9600 member at k = 128, 256 and 300, and the 10-member 14400 x 9600
stack at k = 64, all drawn from the same seed. For each case and kernel it
prints one JSON line: the kernel's ms (CUDA events, median of 7 after a
warm-up), the plain version's ms, the max relative error against it, the
bound (the larger of 4 m n k operations over 165 TFLOP/s, the 3xTF32 rate,
and the bytes, each input read once and the output written once, over 3.35
TB/s) and the CUDA-core bound (4 m n k over 67 TFLOP/s). A package whose
kernels refuse a width prints ``"refused"`` for it.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import torch

from k1_bench import PEAK_BYTES, median_ms

PEAK_3XTF32 = 495e12 / 3     # H100 SXM: TF32 tensor cores, three products
PEAK_FLOPS = 67e12           # H100 SXM: f32 outside the tensor cores
M, N = 57600, 38400
EM, EN, ENS = 14400, 9600, 10


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    p.add_argument("--label", default="")
    args = p.parse_args()
    if not torch.cuda.is_available():
        sys.exit("k2_wide_bench: no CUDA device")
    sys.path.insert(0, os.path.abspath(args.root))
    from pydnmfk_tpu_torch.ops import kl, linalg

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gen = torch.Generator(dev)
    gen.manual_seed(2024)
    eps = float(torch.finfo(torch.float32).eps)

    def case(label, A, W, H):
        m, n = A.shape[-2:]
        k = W.shape[-1]
        B = A.shape[0] if A.dim() == 3 else 1
        chunk = linalg.error_chunk_rows(m, n)
        flops = 4 * B * m * n * k
        for name, fn, plain, out in (
                ("K2a kl_uht", kl.kl_uht, kl.kl_uht_plain, W),
                ("K2b kl_wtu", kl.kl_wtu, kl.kl_wtu_plain, H)):
            row = {"label": args.label, "kernel": name, "case": label}
            try:
                got = fn(A, W, H, eps)
            except ValueError as exc:
                print(json.dumps({**row, "refused": str(exc)}), flush=True)
                continue
            ref = plain(A, W, H, eps, chunk)
            err = float((got.double() - ref.double()).abs().max()
                        / ref.double().abs().max())
            del got, ref
            ms = median_ms(lambda: fn(A, W, H, eps))
            plain_ms = median_ms(lambda: plain(A, W, H, eps, chunk))
            t_bytes = nbytes(A, W, H, out) / PEAK_BYTES * 1e3
            print(json.dumps({
                **row, "ms": round(ms, 3), "plain_ms": round(plain_ms, 3),
                "max_rel_err": err,
                "bound_ms": round(max(flops / PEAK_3XTF32 * 1e3, t_bytes), 3),
                "cuda_core_bound_ms": round(flops / PEAK_FLOPS * 1e3, 3)}),
                flush=True)

    A = torch.rand((M, 64), generator=gen, device=dev) @ torch.rand(
        (64, N), generator=gen, device=dev)
    W = torch.rand((M, 64), generator=gen, device=dev)
    H = torch.rand((64, N), generator=gen, device=dev)
    case(f"f32 {M}x{N} k=64", A, W, H)
    Q, _ = linalg.quantize_uint8(A)
    del A
    case(f"uint8 {M}x{N} k=64", Q, W, H)
    del Q, W, H
    torch.cuda.empty_cache()
    Ae = torch.rand((ENS, EM, EN), generator=gen, device=dev)
    for k in (128, 256, 300):
        W = torch.rand((EM, k), generator=gen, device=dev)
        H = torch.rand((k, EN), generator=gen, device=dev)
        case(f"f32 {EM}x{EN} k={k}", Ae[0], W, H)
    We = torch.rand((ENS, EM, 64), generator=gen, device=dev)
    He = torch.rand((ENS, 64, EN), generator=gen, device=dev)
    case(f"f32 {ENS} x {EM}x{EN} k=64", Ae, We, He)


if __name__ == "__main__":
    main()
