#!/usr/bin/env python3
"""Builds variants of kernel K3's source side by side and times their
tensor-core kernel (a bf16 or uint8 A) on one GPU.

    python3 bench_torch/k3_variants.py '{"NAME": [ENTRIES...], ...}'

Each variant is ``csrc/fused_mu_kl.cu`` (or, when its first entry ends in
``.cu``, that file: an edited copy kept under ``build/``, say), edited by
its entries of the form ``s|OLD|NEW|`` (OLD, which must occur once in the
source, replaced by NEW) and compiled with the package's nvcc flags plus
its other entries (``-D`` switches of an edited copy), all at once, into
``build/k3_variants/``. For each it prints the registers and
spill bytes of the 12 tensor-core kernels (dtype, KP, ``v`` for 16-byte
loads or ``s``), then loads it in place of the package's K3 library, checks
it against the plain version on small ragged shapes (max relative error)
and times it (CUDA events, median of 7) on a bf16 and a uint8 A at
57600 x 38400 for k = 64, 32 and 16, and on the 10-member 14400 x 9600
stacks at k = 8 in bf16 and uint8 and at k = 64 in bf16. For example,
128-row panels with 2 row groups at KP = 64: ``["s|KP <= 16 ? 128 : 256|KP
!= 32 ? 128 : 256|", "s|KP >= 32 ? 4 : 2|KP == 32 ? 4 : 2|"]``. The
numbers compare variants within one run.
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    variants = json.loads(sys.argv[1])
    if not torch.cuda.is_available():
        sys.exit("k3_variants: no CUDA device")
    sys.path.insert(0, ROOT)
    import chip_smoke
    from pydnmfk_tpu_torch.ops import cuda_lib, fused_kl, linalg

    out_dir = os.path.join(ROOT, "build", "k3_variants")
    os.makedirs(out_dir, exist_ok=True)

    def build(item):
        name, flags = item
        src = str(cuda_lib.CSRC / "fused_mu_kl.cu")
        if flags and flags[0].endswith(".cu"):
            src, flags = flags[0], flags[1:]
        edits = [f.split("|")[1:3] for f in flags if f.startswith("s|")]
        flags = [f for f in flags if not f.startswith("s|")]
        if edits:
            text = open(src).read()
            for old, new in edits:
                assert text.count(old) == 1, (name, old)
                text = text.replace(old, new)
            src = os.path.join(out_dir, f"k3_{name}.cu")
            with open(src, "w") as f:
                f.write(text)
        out = os.path.join(out_dir, f"k3_{name}.so")
        cmd = [cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-I", str(cuda_lib.CSRC),
               *flags, "-o", out, src]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode:
            print(name, "build failed:", proc.stderr[-3000:], flush=True)
            return name, None
        regs = chip_smoke.ptxas_k3(proc.stdout + proc.stderr)
        print(name, " ".join(
            f"{dt[0]}{kp}{'v' if vec else 's'}:{r}/{ss}/{sl}"
            for (kern, dt, kp, vec), (r, ss, sl) in sorted(regs.items())
            if kern == "fused_mu_kl_tc_kernel"), flush=True)
        return name, out

    with ThreadPoolExecutor(8) as pool:
        built = list(pool.map(build, variants.items()))

    dev = torch.device("cuda")
    gen = torch.Generator(dev)
    gen.manual_seed(2024)
    eps = float(torch.finfo(torch.float32).eps)
    M, N, K = 57600, 38400, 32
    A = torch.rand((M, K), generator=gen, device=dev) @ torch.rand(
        (K, N), generator=gen, device=dev)
    W = torch.rand((M, K), generator=gen, device=dev)
    H = torch.rand((K, N), generator=gen, device=dev)
    A16 = A.to(torch.bfloat16)
    Q, _ = linalg.quantize_uint8(A)
    del A
    Ae = torch.rand((10, 14400, 9600), generator=gen, device=dev)
    Qe = (Ae * 255).round().to(torch.uint8)
    Ae = Ae.to(torch.bfloat16)
    We = torch.rand((10, 14400, 8), generator=gen, device=dev)
    He = torch.rand((10, 8, 9600), generator=gen, device=dev)
    W16, H16 = W[:, :16].contiguous(), H[:16].contiguous()
    W64 = torch.rand((M, 64), generator=gen, device=dev)
    H64 = torch.rand((64, N), generator=gen, device=dev)
    We64 = torch.rand((10, 14400, 64), generator=gen, device=dev)
    He64 = torch.rand((10, 64, 9600), generator=gen, device=dev)
    cases = [("bf16 k64", A16, W64, H64), ("u8 k64", Q, W64, H64),
             ("bf16 k32", A16, W, H), ("u8 k32", Q, W, H),
             ("bf16 k16", A16, W16, H16), ("u8 k16", Q, W16, H16),
             ("bf16 stack k8", Ae, We, He), ("u8 stack k8", Qe, We, He),
             ("bf16 stack k64", Ae, We64, He64)]
    small = [(a[:513, :1040].contiguous(), w[:513].contiguous(),
              h[:, :1040].contiguous()) for _, a, w, h in cases[:6]]
    p, i = ctypes.c_void_p, ctypes.c_int
    for name, path in built:
        if path is None:
            continue
        lib = ctypes.CDLL(path)
        for suffix in cuda_lib.A_SUFFIX.values():
            fn = getattr(lib, f"fused_mu_kl_{suffix}")
            fn.argtypes = [p, p, p, p, ctypes.c_float, i, i, i, i, p, p, p]
            fn.restype = i
        lib.fused_mu_kl_error_string.argtypes = [i]
        lib.fused_mu_kl_error_string.restype = ctypes.c_char_p
        fused_kl._lib = lambda lib=lib: lib       # this variant's kernels
        err = 0.0
        for a, w, h in small:
            hrs = linalg.sum_axis(h, axis=-1)
            err = max(err, chip_smoke.compare(
                fused_kl.fused_kl_pass(a, w, h, hrs, eps),
                fused_kl.fused_kl_pass_plain(a, w, h, hrs, eps, 50))[1])
        times = []
        for label, a, w, h in cases:
            hrs = linalg.sum_axis(h, axis=-1)
            ms = chip_smoke.median_ms(
                lambda: fused_kl.fused_kl_pass(a, w, h, hrs, eps))
            times.append(f"{label} {ms:.3f}")
        print(name, f"max rel err {err:.2e} |", " | ".join(times), flush=True)


if __name__ == "__main__":
    main()
