#!/usr/bin/env python3
"""Where K2a's time goes past k = 32: times ``kl_uht_tc_kernel``
(``csrc/kl_ratio.cu``) with parts of it taken out, on one GPU.

    python3 bench_torch/k2_knockout_probe.py

Copies ``csrc/kl_ratio.cu`` and ``csrc/tc_tiles.cuh`` into
``build/k2_knockout/``, inserts switches around three parts of K2a's tile
loop (A's stream: its copies into the warp's buffer and the reads from
there; the product S = W H; the product U H^T; a part taken
out leaves constants or a cheap stand-in, so the rest still runs), builds
one library per variant with nvcc (all at once) and times the f32 entry
``kl_uht_f32`` at 57600 x 38400, k = 64 and at one 14400 x 9600 member, k =
256 (CUDA events, median of 5 after a warm-up). The variants' outputs are
wrong by design; only their times mean something: the difference between
two variants is what the part taken out costs where the rest stays.

The switches go in at exact lines of the source (``SWITCHES``, ``COPY``,
``LOADS``), each asserted to occur once: an edit of those lines of
``kl_uht_tc_kernel`` needs them updated here too.
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
OUT = ROOT / "build" / "k2_knockout"

# (anchor in the source, text put before it, text put after it)
SWITCHES = [
    ("      uht_s<LDW>(s, Ws, Hc, rl, g, t, (k + 7) / 8);\n",
     "#ifndef NO_FIRST\n", "#endif\n"),
    ("#pragma unroll\n    for (int og = 0; og < NO / OG; ++og) {\n",
     "#ifndef NO_SECOND\n", ""),
    ("  }\n\n#pragma unroll\n  for (int o = 0; o < NO; ++o) {\n    const int c = c0 + 8 * o + 2 * t;\n",
     "#else\n    for (int i = 0; i < 4; ++i)\n      for (int e = 0; e < 4; ++e)\n"
     "        acc[i][e] += __uint_as_float(uh[i][e] ^ ul[i][e]);\n#endif\n", ""),
]
# A's stream (the aligned path): the cp.async of the warp's tile of A into
# its buffer, and the reads from there
COPY = ("      tc::cp_async_n<4 * sizeof(T)>(tc::smem_u32(As + r * ALD + jj * sizeof(T)),\n"
        "                                    ok ? A + (size_t)row * n + j0 + jj : A, ok);\n")
LOADS = ("        a[i][0] = smem2<T>(p);\n"
         "        a[i][1] = smem2<T>(p + 8 * ALD);\n")
NO_LOADS = ("#ifndef NO_A\n" + LOADS + "#else\n"
            "        a[i][0] = make_float2(1.f + j0, 1.f);\n"
            "        a[i][1] = make_float2(1.f, 2.f + tl);\n#endif\n")
VARIANTS = {"full": [], "no A loads": ["-DNO_A"], "no W H": ["-DNO_FIRST"],
            "no U H^T": ["-DNO_SECOND"],
            "neither product": ["-DNO_FIRST", "-DNO_SECOND"],
            "no A loads, neither product": ["-DNO_A", "-DNO_FIRST",
                                            "-DNO_SECOND"]}
CASES = [(57600, 38400, 64), (14400, 9600, 256)]


def patched_source() -> Path:
    src = (CSRC / "kl_ratio.cu").read_text()
    for anchor, before, after in SWITCHES:
        assert src.count(anchor) == 1, anchor
        src = src.replace(anchor, before + anchor + after)
    assert src.count(LOADS) == 1 and src.count(COPY) == 1
    src = src.replace(LOADS, NO_LOADS)
    src = src.replace(COPY, "#ifndef NO_A\n" + COPY + "#endif\n")
    OUT.mkdir(parents=True, exist_ok=True)
    shutil.copy(CSRC / "tc_tiles.cuh", OUT / "tc_tiles.cuh")
    (OUT / "kl_ratio.cu").write_text(src)
    return OUT / "kl_ratio.cu"


def build(item, src):
    name, flags = item
    lib = OUT / (name.replace(" ", "_").replace(",", "") + ".so")
    cmd = [os.environ.get("NVCC", "/usr/local/cuda/bin/nvcc"), "-gencode",
           "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
           "-Xcompiler", "-fPIC", *flags, "-o", str(lib), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {name}:\n{proc.stderr[-2000:]}")
    return name, lib


def main():
    if not torch.cuda.is_available():
        raise SystemExit("k2_knockout_probe: no CUDA device")
    src = patched_source()
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        libs = dict(pool.map(lambda it: build(it, src), VARIANTS.items()))
    dev = torch.device("cuda", 0)
    gen = torch.Generator(dev)
    gen.manual_seed(1)
    p, i = ctypes.c_void_p, ctypes.c_int
    for m, n, k in CASES:
        A = torch.rand((m, n), generator=gen, device=dev)
        W = torch.rand((m, k), generator=gen, device=dev)
        H = torch.rand((k, n), generator=gen, device=dev)
        out = torch.empty((m, k), device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        for name, lib in libs.items():
            fn = ctypes.CDLL(str(lib)).kl_uht_f32
            fn.argtypes = [p, p, p, ctypes.c_float, i, i, i, i, p, p]
            args = (A.data_ptr(), W.data_ptr(), H.data_ptr(), 1.19e-7, 1, m,
                    n, k, out.data_ptr(), stream)
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
            print(json.dumps({"kernel": "K2a kl_uht_tc_kernel f32",
                              "case": f"{m}x{n} k={k}", "variant": name,
                              "ms": round(sorted(times)[2], 3)}), flush=True)


if __name__ == "__main__":
    main()
