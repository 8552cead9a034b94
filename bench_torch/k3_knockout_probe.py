#!/usr/bin/env python3
"""Where K3's time goes past k = 32 on an f32 A: times
``fused_mu_kl_tf32_kernel`` (``csrc/fused_mu_kl.cu``) with parts of it
taken out, on one GPU.

    python3 bench_torch/k3_knockout_probe.py

Copies ``csrc/fused_mu_kl.cu`` and ``csrc/tc_tiles.cuh`` into
``build/k3_knockout/``, inserts switches around three parts of the 3xTF32
kernel (sweep 1's products and ratios, W H and U H^T; sweep 2's, (W' H)^T
and W'^T U'; sweep 2's atomics into WTU; a part taken out leaves zeros, so
the rest still runs: the ring's copies of A and H, the W' step, the
shuffles), and around the copies of A and the loads of H (left out, the
stages keep stale values), builds one library per variant with nvcc (all at once) and
times the f32 entry ``fused_mu_kl_f32`` at 57600 x 38400, k = 64 and on a
10-member 14400 x 9600 stack, k = 64 (CUDA events, median of 5 after a
warm-up). The variants' outputs are wrong by design; only their times mean
something: the difference between two variants is what the part taken out
costs where the rest stays.

The switches go in at exact lines of the source (``SWITCHES``), each
asserted to occur once: an edit of those lines needs them updated here too.
"""
from __future__ import annotations

import ctypes
import json
import os
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "pydnmfk_tpu_torch" / "csrc"
OUT = ROOT / "build" / "k3_knockout"

# (anchor in the source, text put before it): each switch spans from one
# anchor to the next
SWITCHES = [
    ("      // P = W H for the tile's four n8 tiles of columns", "#ifndef NO_S1\n"),
    ("      store_h(p + 2);   // its stage's last reader", "#endif\n"),
    ("      // (W' H)^T for the chunk's four steps of 8 rows", "#ifndef NO_S2\n"),
    ("      if (r0 + CR >= rows) {   // the strip is summed", "#endif\n"),
]
ATOMIC = ("              if (c < k && j < n) atomicAdd(reinterpret_cast<float4*>"
          "(dst + j), v);\n")
NO_ATOMIC = ("#ifdef NO_ATOMIC\n              if (c < k && j < n && v.x == -1.f)"
             " atomicAdd(reinterpret_cast<float4*>(dst + j), v);\n#else\n"
             + ATOMIC + "#endif\n")
# A's copies (both sweeps), and H's (sweep 1's loads into registers, sweep
# 2's strip copies): left out, the ring's stages keep what they held
LINES = [
    "      copy(st, LDA1, A, rows, p * TN1, 3, TM * TN1 / 4 / NT);\n",
    "      copy(st, LDA2, A + (size_t)r0 * n, min(CR, rows - r0), j0, SH2, "
    "CR * TN2 / 4 / NT);\n",
]
H_LINES = [
    "      if (r0 == 0) copy(st + O_H2, LDH2, H, k, j0, SH2, KP * TN2 / 4 / NT);\n",
    "        if (p >= np1 || r >= k || j >= n) continue;\n",
]
VARIANTS = {"full": [], "no A copies": ["-DNO_A"], "no H loads": ["-DNO_H"],
            "no atomics": ["-DNO_ATOMIC"],
            "no sweep-1 products": ["-DNO_S1"],
            "no sweep-2 products": ["-DNO_S2"],
            "neither sweep's products": ["-DNO_S1", "-DNO_S2"],
            "loads and W' only": ["-DNO_S1", "-DNO_S2", "-DNO_ATOMIC"]}
CASES = [(1, 57600, 38400, 64), (10, 14400, 9600, 64)]


def patched_source() -> Path:
    src = (CSRC / "fused_mu_kl.cu").read_text()
    for anchor, before in SWITCHES:
        assert src.count(anchor) == 1, anchor
        src = src.replace(anchor, before + anchor)
    assert src.count(ATOMIC) == 1
    src = src.replace(ATOMIC, NO_ATOMIC)
    for line in LINES:
        assert src.count(line) == 1, line
        src = src.replace(line, "#ifndef NO_A\n" + line + "#endif\n")
    h_copy, h_load = H_LINES
    assert src.count(h_copy) == 1 and src.count(h_load) == 1
    src = src.replace(h_copy, "#ifndef NO_H\n" + h_copy + "#endif\n")
    src = src.replace(h_load, h_load + "#ifdef NO_H\n        continue;\n#endif\n")
    OUT.mkdir(parents=True, exist_ok=True)
    shutil.copy(CSRC / "tc_tiles.cuh", OUT / "tc_tiles.cuh")
    (OUT / "fused_mu_kl.cu").write_text(src)
    return OUT / "fused_mu_kl.cu"


def build(item, src):
    name, flags = item
    lib = OUT / (name.replace(" ", "_").replace("'", "") + ".so")
    cmd = [os.environ.get("NVCC", "/usr/local/cuda/bin/nvcc"), "-gencode",
           "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
           "-Xcompiler", "-fPIC", *flags, "-o", str(lib), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {name}:\n{proc.stderr[-2000:]}")
    return name, lib


def main():
    if not torch.cuda.is_available():
        raise SystemExit("k3_knockout_probe: no CUDA device")
    src = patched_source()
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        libs = dict(pool.map(lambda it: build(it, src), VARIANTS.items()))
    dev = torch.device("cuda", 0)
    gen = torch.Generator(dev)
    gen.manual_seed(1)
    p, i = ctypes.c_void_p, ctypes.c_int
    for B, m, n, k in CASES:
        A = torch.rand((B, m, n), generator=gen, device=dev)
        W = torch.rand((B, m, k), generator=gen, device=dev)
        H = torch.rand((B, k, n), generator=gen, device=dev)
        hrs = H.sum(-1)
        W_out = torch.empty_like(W)
        WTU = torch.zeros((B, k, n), device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        for name, lib in libs.items():
            fn = ctypes.CDLL(str(lib)).fused_mu_kl_f32
            fn.argtypes = [p, p, p, p, ctypes.c_float, i, i, i, i, p, p, p]
            args = (A.data_ptr(), W.data_ptr(), H.data_ptr(), hrs.data_ptr(),
                    1.19e-7, B, m, n, k, W_out.data_ptr(), WTU.data_ptr(),
                    stream)
            assert fn(*args) == 0
            torch.cuda.synchronize()
            times = []
            for _ in range(5):
                t0 = torch.cuda.Event(enable_timing=True)
                t1 = torch.cuda.Event(enable_timing=True)
                t0.record()
                fn(*args)
                t1.record()
                torch.cuda.synchronize()
                times.append(t0.elapsed_time(t1))
            print(json.dumps({"kernel": "K3 fused_mu_kl_tf32_kernel",
                              "case": f"{B} x {m}x{n} k={k}", "variant": name,
                              "ms": round(sorted(times)[2], 3)}), flush=True)


if __name__ == "__main__":
    main()
