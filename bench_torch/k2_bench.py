#!/usr/bin/env python3
"""Times kernels K2a and K2b (the KL ratio products, ``csrc/kl_ratio.cu``)
on one GPU.

    python3 bench_torch/k2_bench.py [--root DIR] [--label NAME] [--split-sweep]

Imports ``pydnmfk_tpu_torch`` from DIR (default: the root of this
checkout), so that two trees, say a parent commit unpacked with ``git archive``
and the change, can be timed in one run on one card, in turns (parent,
change, change, parent). The cases are those of ``chip_smoke.py``'s phase 2:
an f32 and a uint8 A at 57600 x 38400, k = 32, an f32 and a bf16 10-member
14400 x 9600, k = 8 stack, K2b alone on one member of that stack (the
shape of the NMFk refit, k = 8), and both on one 14400 x 9600 member at
k = 256 (the first port's kernels), all drawn from the same seed. For each
case and kernel it prints one JSON line: the kernel's ms (CUDA events,
median of 7 after a warm-up), the plain version's ms, its max relative
error against the plain version, and its bound (the larger of 4 m n k operations over 67 TFLOP/s and the bytes,
each input read once and the output written once, over 3.35 TB/s).

With ``--split-sweep`` it times K2b alone instead, on the refit's member,
the f32 stack and the f32 57600 x 38400 A, with its rows cut into 1, 2, 4,
8, 16 and 32 splits (``kl_wtu``'s ``splits``) and with the wrapper's own
plan (``"splits_asked": null``), twice, in rising and then falling order;
each line gives the splits and their rows.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

from k1_bench import PEAK_BYTES, median_ms

PEAK_FLOPS = 67e12        # H100 SXM: f32 outside the tensor cores
SWEEP = [1, 2, 4, 8, 16, 32, None]   # --split-sweep: K2b's row splits


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    p.add_argument("--label", default="")
    p.add_argument("--split-sweep", action="store_true",
                   help="time K2b at several row splits instead")
    args = p.parse_args()
    if not torch.cuda.is_available():
        sys.exit("k2_bench: no CUDA device")
    sys.path.insert(0, os.path.abspath(args.root))
    from pydnmfk_tpu_torch.ops import kl, linalg

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    eps = float(torch.finfo(torch.float32).eps)
    gen = torch.Generator(dev)
    gen.manual_seed(2024)

    def case(name, A, W, H, which=("uht", "wtu")):
        m, n = A.shape[-2:]
        chunk = linalg.error_chunk_rows(m, n)
        flops = 4 * A.numel() * W.shape[-1]
        for w in which:
            fn, plain = ((kl.kl_uht, kl.kl_uht_plain) if w == "uht"
                         else (kl.kl_wtu, kl.kl_wtu_plain))
            out, ref = fn(A, W, H, eps), plain(A, W, H, eps, chunk)
            err = float((out.double() - ref.double()).abs().max()
                        / ref.double().abs().max())
            del out, ref
            ms = median_ms(lambda: fn(A, W, H, eps))
            plain_ms = median_ms(lambda: plain(A, W, H, eps, chunk))
            t_ops = flops / PEAK_FLOPS * 1e3
            t_bytes = nbytes(A, W, H, W if w == "uht" else H) / PEAK_BYTES * 1e3
            print(json.dumps({
                "label": args.label, "case": name,
                "kernel": "K2a kl_uht" if w == "uht" else "K2b kl_wtu",
                "ms": ms, "plain_ms": plain_ms, "max_rel_err": err,
                "bound_ms": max(t_ops, t_bytes),
                "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                "card": smi}), flush=True)

    def sweep(name, A, W, H):
        B, m, n = (1, *A.shape) if A.dim() == 2 else A.shape
        k = W.shape[-1]
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        ref = kl.kl_wtu_plain(A, W, H, eps, linalg.error_chunk_rows(m, n))
        for asked in SWEEP + SWEEP[::-1]:
            splits, rows = kl.wtu_split_plan(B, m, n, k, *kl.wtu_geometry(k),
                                             sms, asked)
            out = kl.kl_wtu(A, W, H, eps, splits=asked)
            err = float((out.double() - ref.double()).abs().max()
                        / ref.double().abs().max())
            del out
            print(json.dumps({
                "label": args.label, "case": name, "kernel": "K2b kl_wtu",
                "splits_asked": asked, "splits": splits,
                "rows_per_split": rows,
                "ms": median_ms(lambda: kl.kl_wtu(A, W, H, eps, splits=asked)),
                "max_rel_err": err, "card": smi}), flush=True)

    M, N, K = 57600, 38400, 32
    E, EM, EN, EK = 10, 14400, 9600, 8
    if args.split_sweep:
        Ae = torch.rand((E, EM, EN), generator=gen, device=dev)
        We = torch.rand((E, EM, EK), generator=gen, device=dev)
        He = torch.rand((E, EK, EN), generator=gen, device=dev)
        sweep(f"f32 refit {EM}x{EN} k={EK}", Ae[0], We[0], He[0])
        sweep(f"f32 {E} x {EM}x{EN} k={EK}", Ae, We, He)
        del Ae, We, He
        torch.cuda.empty_cache()
        A = torch.rand((M, N), generator=gen, device=dev)
        sweep(f"f32 {M}x{N} k={K}", A, torch.rand((M, K), generator=gen, device=dev),
              torch.rand((K, N), generator=gen, device=dev))
        return

    A = torch.rand((M, K), generator=gen, device=dev) @ torch.rand(
        (K, N), generator=gen, device=dev)
    W = torch.rand((M, K), generator=gen, device=dev)
    H = torch.rand((K, N), generator=gen, device=dev)
    case(f"f32 {M}x{N} k={K}", A, W, H)
    Q, _ = linalg.quantize_uint8(A)
    del A
    case(f"uint8-A {M}x{N} k={K}", Q, W, H)
    del Q, W, H
    torch.cuda.empty_cache()
    Ae = torch.rand((E, EM, EN), generator=gen, device=dev)
    We = torch.rand((E, EM, EK), generator=gen, device=dev)
    He = torch.rand((E, EK, EN), generator=gen, device=dev)
    case(f"f32 {E} x {EM}x{EN} k={EK}", Ae, We, He)
    case(f"bf16-A {E} x {EM}x{EN} k={EK}", Ae.to(torch.bfloat16), We, He)
    case(f"f32 refit {EM}x{EN} k={EK}", Ae[0], We[0], He[0], ("wtu",))
    A1 = Ae[0].clone()
    del Ae, We, He
    torch.cuda.empty_cache()
    case(f"f32 {EM}x{EN} k=256", A1,
         torch.rand((EM, 256), generator=gen, device=dev),
         torch.rand((256, EN), generator=gen, device=dev))


if __name__ == "__main__":
    main()
