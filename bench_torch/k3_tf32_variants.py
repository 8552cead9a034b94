#!/usr/bin/env python3
"""Builds variants of K3's 3xTF32 kernel (an f32 A past k = 32,
``fused_mu_kl_tf32_kernel`` in ``csrc/fused_mu_kl.cu``) side by side and
times them on one GPU.

    python3 bench_torch/k3_tf32_variants.py [NAME ...]

Each variant is the source with some of these edits (``VARIANTS``):
- ``w_smem``: sweep 1 takes W's split fragments from the split W' panel in
  shared memory (written there first), not from 64 registers;
- ``h_split``: sweep 2 keeps H^T's fragments split (64 registers, not 32)
  rather than splitting them at each use;
- ``swap1``: sweep 1 runs U H^T's two groups of output tiles side by side
  (eight accumulators, not four, a U fragment);
- ``swap2``: sweep 2 runs W'^T U''s two groups of m16 tiles side by side.
- ``nw4``: 4 warps a block (64-row panels, 64-column strips, two blocks an
  SM).
The edits go in at exact lines of the source, each asserted to occur once.
The variants are written to ``build/k3_tf32_variants/`` and compiled with
the package's nvcc flags, all at once; for each it prints the registers and
spill bytes of the kernel (scalar and 16-byte paths), its max relative
error against the plain version on two small ragged shapes, and its time
(CUDA events, median of 7) at 57600 x 38400, k = 64, and on the 10-member
14400 x 9600 stack at k = 64 and 34. The numbers compare variants within
one run.
"""
from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "k3_tf32_variants"

W_DECL = """    uint32_t wh[KP / 8][4], wl[KP / 8][4];
#pragma unroll
    for (int ks = 0; ks < KP / 8; ++ks)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = rl + 8 * (e & 1), c = 8 * ks + t + 4 * (e >> 1);
        const float w = r < rows && c < k ? __ldg(W + (size_t)r * k + c) : 0.f;
        tc::split_tf32(w, wh[ks][e], wl[ks][e]);
      }
"""
W_USE = "          tc::mma4_3xtf32(s, wh[ks], wl[ks], bh, bl);\n"
EPI = "    // element e of acc[o]: row rl + 8 (e >> 1), factor 8 o + 2t + (e & 1);\n"
W_SMEM = [
    (W_DECL, W_DECL.split("    uint32_t wh[KP / 8][4], wl[KP / 8][4];\n")[1].replace(
        "tc::split_tf32(w, wh[ks][e], wl[ks][e]);",
        "*reinterpret_cast<float2*>(Wp + w_off(r, c)) = split2(w);")),
    (W_USE, """          uint32_t ah[4], al[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 v = *reinterpret_cast<const float2*>(
                Wp + w_off(rl + 8 * (e & 1), 8 * ks + t + 4 * (e >> 1)));
            ah[e] = __float_as_uint(v.x);
            al[e] = __float_as_uint(v.y);
          }
          tc::mma4_3xtf32(s, ah, al, bh, bl);
"""),
    (EPI, "    __syncwarp();\n" + EPI)]
H_SPLIT = [
    ("    float hraw[KP / 8][4];\n", "    uint32_t hth[KP / 8][4], htl[KP / 8][4];\n"),
    ("""            hraw[ks][e] = hs[(16 * (ks >> 1) + 4 * (ks & 1) + t + 8 * (e >> 1)) * LDH2 +
                             cw + g + 8 * (e & 1)];
""", """            tc::split_tf32(hs[(16 * (ks >> 1) + 4 * (ks & 1) + t + 8 * (e >> 1)) * LDH2 +
                              cw + g + 8 * (e & 1)],
                           hth[ks][e], htl[ks][e]);
"""),
    ("""          uint32_t hth[4], htl[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) tc::split_tf32(hraw[ks][e], hth[e], htl[e]);
          tc::mma4_3xtf32(s, hth, htl, bh, bl);
""", "          tc::mma4_3xtf32(s, hth[ks], htl[ks], bh, bl);\n")]
# swap1 / swap2: the group loop moves inside the loop over U's (U'^T's)
# fragments; the groups' sums live side by side
SWAP1 = [
    ("""          float q4[4][4];
#pragma unroll
          for (int oo = 0; oo < 4; ++oo) q4[oo][0] = q4[oo][1] = q4[oo][2] = q4[oo][3] = 0.f;
""", ""),
    ("#pragma unroll\n      for (int og = 0; og < KP / 32; ++og) {\n        if (og < ngr) {\n"
     "#pragma unroll\n          for (int i = 0; i < 4; ++i) {\n",
     """      float q4s[KP / 32][4][4] = {};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int og = 0; og < KP / 32; ++og) {
          if (og < ngr) {
            float (&q4)[4][4] = q4s[og];
"""),
    ("""            tc::mma4_3xtf32(q4, uh[i], ul[i], bh, bl);
          }
#pragma unroll
          for (int oo = 0; oo < 4; ++oo)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[4 * og + oo][e] += q4[oo][e];
        }
      }
""", """            tc::mma4_3xtf32(q4, uh[i], ul[i], bh, bl);
          }
        }
      }
#pragma unroll
      for (int og = 0; og < KP / 32; ++og)
        if (og < ngr)
#pragma unroll
          for (int oo = 0; oo < 4; ++oo)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[4 * og + oo][e] += q4s[og][oo][e];
""")]
SWAP2 = [
    ("""          float pp[2][2][4];
#pragma unroll
          for (int ii = 0; ii < 2; ++ii)
#pragma unroll
            for (int h = 0; h < 2; ++h) pp[ii][h][0] = pp[ii][h][1] = pp[ii][h][2] = pp[ii][h][3] = 0.f;
""", ""),
    ("#pragma unroll\n      for (int ig = 0; ig < KP / 32; ++ig) {\n        if (ig < ngr) {\n"
     "#pragma unroll\n          for (int j = 0; j < 4; ++j) {\n"
     "            const int r = r0 + 8 * j + 2 * t;\n",
     """      float pps[KP / 32][2][2][4] = {};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = r0 + 8 * j + 2 * t;
#pragma unroll
        for (int ig = 0; ig < KP / 32; ++ig) {
          if (ig < ngr) {
            float (&pp)[2][2][4] = pps[ig];
"""),
    ("""              for (int h = 0; h < 2; ++h) tc::mma_tf32(pp[ii][h], ah[ii], ubh[j][h][0], ubh[j][h][1]);
          }
#pragma unroll
          for (int ii = 0; ii < 2; ++ii)
#pragma unroll
            for (int h = 0; h < 2; ++h)
#pragma unroll
              for (int e = 0; e < 4; ++e) acc[2 * ig + ii][h][e] += pp[ii][h][e];
        }
      }
""", """              for (int h = 0; h < 2; ++h) tc::mma_tf32(pp[ii][h], ah[ii], ubh[j][h][0], ubh[j][h][1]);
          }
        }
      }
#pragma unroll
      for (int ig = 0; ig < KP / 32; ++ig)
        if (ig < ngr)
#pragma unroll
          for (int ii = 0; ii < 2; ++ii)
#pragma unroll
            for (int h = 0; h < 2; ++h)
#pragma unroll
              for (int e = 0; e < 4; ++e) acc[2 * ig + ii][h][e] += pps[ig][ii][h][e];
""")]
NW4 = [("constexpr int NW = 8;", "constexpr int NW = 4;")]
EDITS = {"w_smem": W_SMEM, "h_split": H_SPLIT, "swap1": SWAP1, "swap2": SWAP2,
         "nw4": NW4}
VARIANTS = {"source": [], "w_smem": ["w_smem"], "h_split": ["h_split"],
            "w_smem h_split": ["w_smem", "h_split"],
            "w_smem swap1": ["w_smem", "swap1"],
            "w_smem swap1 swap2": ["w_smem", "swap1", "swap2"],
            "swap1 swap2": ["swap1", "swap2"], "swap2": ["swap2"],
            "nw4": ["nw4"], "nw4 h_split": ["nw4", "h_split"]}


def variant_source(edits) -> str:
    sys.path.insert(0, str(ROOT))
    from pydnmfk_tpu_torch.ops import cuda_lib
    src = (cuda_lib.CSRC / "fused_mu_kl.cu").read_text()
    for name in edits:
        for old, new in EDITS[name]:
            assert src.count(old) == 1, (name, old[:60])
            src = src.replace(old, new)
    return src


def main():
    names = sys.argv[1:] or list(VARIANTS)
    if not torch.cuda.is_available():
        sys.exit("k3_tf32_variants: no CUDA device")
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from pydnmfk_tpu_torch.ops import cuda_lib, fused_kl

    OUT.mkdir(parents=True, exist_ok=True)
    shutil.copy(cuda_lib.CSRC / "tc_tiles.cuh", OUT / "tc_tiles.cuh")

    def build(name):
        stem = name.replace(" ", "_")
        src, lib = OUT / f"{stem}.cu", OUT / f"{stem}.so"
        src.write_text(variant_source(VARIANTS[name]))
        proc = subprocess.run([cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-o",
                               str(lib), str(src)], capture_output=True, text=True)
        if proc.returncode:
            print(name, "build failed:", proc.stderr[-2000:], flush=True)
            return name, None
        regs = chip_smoke.ptxas_k3(proc.stdout + proc.stderr)
        print(name, " ".join(f"{'v' if vec else 's'}:{r}/{ss}/{sl}"
                             for (kern, _, _, vec), (r, ss, sl) in sorted(regs.items())
                             if kern == "fused_mu_kl_tf32_kernel"), flush=True)
        return name, lib

    with ThreadPoolExecutor(8) as pool:
        built = list(pool.map(build, names))
    dev = torch.device("cuda")
    gen = torch.Generator(dev)
    gen.manual_seed(3)
    eps = float(torch.finfo(torch.float32).eps)

    def draw(b, m, n, k):
        return tuple(torch.rand(s, generator=gen, device=dev)
                     for s in ((b, m, n), (b, m, k), (b, k, n)))

    small = [draw(2, 257, 1040, 64), draw(1, 300, 201, 40)]
    big = [("57600x38400 k=64", draw(1, 57600, 38400, 64)),
           ("10 x 14400x9600 k=64", draw(10, 14400, 9600, 64)),
           ("10 x 14400x9600 k=34", draw(10, 14400, 9600, 34))]
    p, i = ctypes.c_void_p, ctypes.c_int
    for name, path in built:
        if path is None:
            continue
        lib = ctypes.CDLL(str(path))
        for suffix in cuda_lib.A_SUFFIX.values():
            fn = getattr(lib, f"fused_mu_kl_{suffix}")
            fn.argtypes = [p, p, p, p, ctypes.c_float, i, i, i, i, p, p, p]
            fn.restype = i
        lib.fused_mu_kl_error_string.argtypes = [i]
        lib.fused_mu_kl_error_string.restype = ctypes.c_char_p
        fused_kl._lib = lambda lib=lib: lib       # this variant's kernels
        err = 0.0
        for A, W, H in small:
            hrs = H.sum(-1)
            err = max(err, chip_smoke.compare(
                fused_kl.fused_kl_pass(A, W, H, hrs, eps),
                fused_kl.fused_kl_pass_plain(A, W, H, hrs, eps, 50))[1])
        times = []
        for label, (A, W, H) in big:
            hrs = H.sum(-1)
            ms = chip_smoke.median_ms(lambda: fused_kl.fused_kl_pass(A, W, H, hrs, eps))
            times.append(f"{label} {ms:.3f}")
        print(name, f"max rel err {err:.2e} |", " | ".join(times), flush=True)


if __name__ == "__main__":
    main()
