#!/usr/bin/env python3
"""Builds variants of K1's pass-1 source side by side and times K1 on an
f32 A with each in place of the package's library, on one GPU.

    python3 bench_torch/k1_pass1_variants.py '{"NAME": [[OLD, NEW], ...]}'

Each variant is ``csrc/fused_mu_fro.cu`` with each OLD (which must occur
once) replaced by NEW, compiled with the package's nvcc flags into
``build/k1_pass1_variants/``, all at once. For each it prints the
registers and spill bytes of the f32 kernel's instantiations ((KP, vec),
from ptxas), then for the package's library and each variant K1's ms and
its second pass's ms alone (``ops/strip.py``; CUDA events, median of 7),
and the max relative error against the plain version, at 57600 x 38400,
k = 32 and 64, and on the 10-member 14400 x 9600 stack at k = 8. For
example, 4 x 8 register tiles at every k:
``{"rm8": [["static constexpr int RM = 4;", "static constexpr int RM =
KP <= 16 ? 4 : 8;"]]}`` gives the 8 x 8 tiles at KP = 32 and 64 back. The
numbers compare variants within one run.
"""
from __future__ import annotations

import ctypes
import json
import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def f32_regs(log):
    """{(KP, vec): (registers, spill stores, spill loads)} of the f32
    kernel in a ptxas report."""
    out, cur, spill = {}, None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '\S*fused_mu_fro_f32_kernel"
                      r"ILi(\d+)ELb([01])E", line)
        if m:
            cur, spill = (int(m.group(1)), m.group(2) == "1"), (0, 0)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and cur:
            spill = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur:
            out[cur] = (int(m.group(1)), *spill)
            cur = None
    return out


def main():
    variants = json.loads(sys.argv[1])
    if not torch.cuda.is_available():
        sys.exit("k1_pass1_variants: no CUDA device")
    sys.path.insert(0, ROOT)
    import chip_smoke
    from pydnmfk_tpu_torch.ops import cuda_lib, fused_mu, linalg, strip

    out_dir = os.path.join(ROOT, "build", "k1_pass1_variants")
    os.makedirs(out_dir, exist_ok=True)

    def build(item):
        name, edits = item
        text = (cuda_lib.CSRC / "fused_mu_fro.cu").read_text()
        for old, new in edits:
            assert text.count(old) == 1, (name, old)
            text = text.replace(old, new)
        src = os.path.join(out_dir, f"{name}.cu")
        with open(src, "w") as f:
            f.write(text)
        out = os.path.join(out_dir, f"{name}.so")
        proc = subprocess.run([cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-I",
                               str(cuda_lib.CSRC), "-o", out, src],
                              capture_output=True, text=True)
        if proc.returncode:
            print(name, "build failed:", proc.stderr[-3000:], flush=True)
            return name, None
        print(name, "(KP, vec): (registers, spill bytes)",
              f32_regs(proc.stdout + proc.stderr), flush=True)
        return name, out

    cuda_lib.build_all()
    with ThreadPoolExecutor(8) as pool:
        built = list(pool.map(build, variants.items()))

    dev = torch.device("cuda")
    gen = torch.Generator(dev)
    gen.manual_seed(2024)
    eps = float(torch.finfo(torch.float32).eps)
    M, N = 57600, 38400
    A = torch.rand((M, 32), generator=gen, device=dev) @ torch.rand(
        (32, N), generator=gen, device=dev)
    Ae = torch.rand((10, 14400, 9600), generator=gen, device=dev)
    rand = lambda *s: torch.rand(s, generator=gen, device=dev)
    cases = ((f"{M}x{N} k=32", A, rand(M, 32), rand(32, N)),
             (f"{M}x{N} k=64", A, rand(M, 64), rand(64, N)),
             ("10 x 14400x9600 k=8", Ae, rand(10, 14400, 8),
              rand(10, 8, 9600)))
    package = fused_mu._lib
    p, i = ctypes.c_void_p, ctypes.c_int
    for name, path in [("package", None)] + built:
        if name != "package" and path is None:
            continue
        if path is None:
            fused_mu._lib = package
        else:
            lib = ctypes.CDLL(path)
            for suffix in cuda_lib.A_SUFFIX.values():
                fn = getattr(lib, f"fused_mu_fro_{suffix}")
                fn.argtypes = [p, p, p, p, ctypes.c_float, i, i, i, i, p, p,
                               p, p]
                fn.restype = i
            lib.fused_mu_fro_geometry.argtypes = [i, i, p]
            lib.fused_mu_fro_geometry.restype = i
            lib.fused_mu_fro_error_string.argtypes = [i]
            lib.fused_mu_fro_error_string.restype = ctypes.c_char_p
            fused_mu._lib = lambda lib=lib: lib    # this variant's pass 1
        fused_mu.panel_rows.cache_clear()
        for label, a, w, h in cases:
            hht = linalg.gram_t(h)
            out = fused_mu.fused_w_pass(a, w, h, hht, eps)
            err = chip_smoke.compare(out, fused_mu.fused_w_pass_plain(
                a, w, h, hht, eps))[1]
            ms = chip_smoke.median_ms(
                lambda: fused_mu.fused_w_pass(a, w, h, hht, eps))
            pass2 = chip_smoke.median_ms(
                lambda: strip.wt_pass(a, out[0], None, eps, False))
            print(json.dumps({"variant": name, "case": label, "ms": ms,
                              "pass2_ms": pass2, "max_rel_err": err}),
                  flush=True)


if __name__ == "__main__":
    main()
