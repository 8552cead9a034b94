#!/usr/bin/env python3
"""Builds variants of ``csrc/kl_ratio.cu`` side by side and times K1's
second pass on an f32 A (W'^T A on K2b's register kernel without the
ratio, C entry ``kl_wta_f32``) with each in place of the package's
library, on one GPU.

    python3 bench_torch/k1_pass2_variants.py '{"NAME": [[OLD, NEW], ...]}'

Each variant is the source with each OLD (which must occur once) replaced
by NEW, compiled with the package's nvcc flags into
``build/k1_pass2_variants/``, all at once. For each it prints the
registers and spill bytes of ``kl_wtu_reg_kernel`` without the ratio
((KP, vec), from ptxas) and any other spill, then for the package's
library and each variant the second pass's ms (``ops/strip.py::wt_pass``;
CUDA events, median of 7) and its max relative error against W'^T A at
f64, at 57600 x 38400, k = 16, 32 and 64, and on the 10-member 14400 x
9600 stack at k = 8. For example, 4 rows in flight past KP = 8 (which
spill at two blocks an SM): ``{"d4": [["RATIO ? 4 : KP <= 8 ? 8 : 2",
"RATIO ? 4 : KP <= 8 ? 8 : 4"]]}``. The numbers compare variants within
one run.
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


def wta_regs(log):
    """[((KP, vec) or a kernel's name, registers, (spill stores, loads))]
    of the no-ratio register kernel, and of any kernel that spills, in a
    ptxas report."""
    out, cur, spill = [], None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur, spill = m.group(1), (0, 0)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and cur:
            spill = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur:
            w = re.search(r"kl_wtu_reg_kernelIfLi(\d+)ELb([01])ELb0E", cur)
            if w:
                out.append(((int(w.group(1)), w.group(2) == "1"),
                            int(m.group(1)), spill))
            elif any(spill):
                out.append((cur[-48:], int(m.group(1)), spill))
            cur = None
    return out


def main():
    variants = json.loads(sys.argv[1])
    if not torch.cuda.is_available():
        sys.exit("k1_pass2_variants: no CUDA device")
    sys.path.insert(0, ROOT)
    import chip_smoke
    from pydnmfk_tpu_torch.ops import cuda_lib, kl, strip

    out_dir = os.path.join(ROOT, "build", "k1_pass2_variants")
    os.makedirs(out_dir, exist_ok=True)

    def build(item):
        name, edits = item
        text = (cuda_lib.CSRC / "kl_ratio.cu").read_text()
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
        print(name, "(KP, vec), registers, spill bytes:",
              wta_regs(proc.stdout + proc.stderr), flush=True)
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
    cases = [(f"{M}x{N} k={k}", A, rand(M, k)) for k in (32, 16, 64)]
    cases.append(("10 x 14400x9600 k=8", Ae, rand(10, 14400, 8)))
    refs = {label: torch.matmul(w.double().mT, a.double())
            for label, a, w in cases}
    package = kl.load
    for name, path in [("package", None)] + built:
        if name != "package" and path is None:
            continue
        kl.load = (lambda _, path=path: ctypes.CDLL(path)) if path else package
        for cached in (kl._lib, kl.wtu_geometry, strip._lib, strip.geometry):
            cached.cache_clear()
        for label, a, w in cases:
            out = strip.wt_pass(a, w, None, eps, False)
            err = float((out.double() - refs[label]).abs().max()
                        / refs[label].abs().max())
            ms = chip_smoke.median_ms(
                lambda: strip.wt_pass(a, w, None, eps, False))
            print(json.dumps({"variant": name, "case": label, "pass2_ms": ms,
                              "max_rel_err": err}), flush=True)


if __name__ == "__main__":
    main()
