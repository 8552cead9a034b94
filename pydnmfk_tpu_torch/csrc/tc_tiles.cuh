// Tile helpers of the tensor-core kernels (K1's and K3's, csrc/fused_mu_fro.cu
// and csrc/fused_mu_kl.cu; K2's at k > 32 and the second pass of K1 and K3,
// csrc/kl_ratio.cu): swizzled shared-memory tiles of 128-byte rows, cp.async
// copies, ldmatrix, bf16 and f16 mma.sync, the exact widening of uint8
// values, the KL ratio on a fragment, and 3xTF32 products (TF32 splits of
// f32 operands, TF32 mma.sync, split fragment loads).
// Included inside a namespace of each file's anonymous namespace, so each
// library keeps its own internal copy; the library hash
// (ops/cuda_lib.py::library_path) covers this header.
#pragma once

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of 16-byte chunk c of row r in a swizzled bf16 tile of 64
// columns
__device__ __forceinline__ int chunk_off(int r, int c) {
  return r * 128 + ((c ^ (r & 7)) << 4);
}

// byte offset of 16-byte chunk c of row r in a landed uint8 tile of TNP
// columns, swizzled the same way (the widening reads several rows at one
// column)
template <int TNP>
__device__ __forceinline__ int u8_off(int r, int c) {
  return r * TNP + ((c ^ (r & (TNP / 16 - 1))) << 4);
}

// 16 bytes from global to shared, or 16 zeros where !ok
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 16 : 0));
}

// BYTES = 4, 8 or 16 bytes from global to shared, or BYTES zeros where !ok
template <int BYTES>
__device__ __forceinline__ void cp_async_n(uint32_t dst, const void* src, bool ok) {
  if constexpr (BYTES == 16) {
    cp_async16(dst, src, ok);
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst), "l"(src),
                 "n"(BYTES), "r"(ok ? BYTES : 0));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x2(uint32_t addr, uint32_t& r0, uint32_t& r1) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x2_t(uint32_t addr, uint32_t& r0, uint32_t& r1) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(addr));
}

// c += a b on the tensor cores: a 16 x 16 bf16 (row), b 16 x 8 bf16 (col),
// c 16 x 8 f32
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the same at a depth of 8: a 16 x 8 (a0, a1), b 8 x 8 (b0)
__device__ __forceinline__ void mma_bf16_k8(float (&c)[4], uint32_t a0, uint32_t a1,
                                            uint32_t b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

// c += a b with f16 operands: the fragments of mma_bf16, f16 values
__device__ __forceinline__ void mma_f16(float (&c)[4], const uint32_t (&a)[4],
                                        uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 as packed f16 (cvt.rn.f16x2.f32), lo in the low half
__device__ __forceinline__ uint32_t f16x2(float lo, float hi) {
  const __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// the bits of a 16-bit float, for copies element by element
__device__ __forceinline__ unsigned short bits16(__nv_bfloat16 x) {
  return __bfloat16_as_ushort(x);
}
__device__ __forceinline__ unsigned short bits16(__half x) { return __half_as_ushort(x); }

// two f32 as packed bf16 (cvt.rn.bf16x2.f32), lo in the low half
__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// c += a b on the tensor cores at the operand type of T: f16 for T = __half,
// bf16 otherwise (a bf16 or uint8 A, whose values are bf16 values)
template <typename T>
__device__ __forceinline__ void mma_op(float (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  if constexpr (std::is_same<T, __half>::value) {
    mma_f16(c, a, b0, b1);
  } else {
    mma_bf16(c, a, b0, b1);
  }
}

// the two 16-bit values of A in w (lo, hi) as f32, exactly: a bf16 is the
// upper half of the f32 with the same value, and every f16 value is an f32
// value
template <typename T>
__device__ __forceinline__ void unpack2(uint32_t w, float& lo, float& hi) {
  if constexpr (std::is_same<T, __half>::value) {
    const float2 f = __half22float2(*reinterpret_cast<const __half2*>(&w));
    lo = f.x;
    hi = f.y;
  } else {
    lo = __uint_as_float(w << 16);
    hi = __uint_as_float(w & 0xffff0000u);
  }
}

// U = A / P on one m16 x k16 block: a[nt][e] is A at the position of
// accumulator element p[nt][e] of the two n8 tiles; the ratios, rounded to
// bf16, are the m16k16 A operand of the next product
__device__ __forceinline__ void ratio_block(uint32_t (&u)[4], const float (&a)[2][4],
                                            const float (&p)[2][4]) {
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
    u[2 * nt] = bf16x2(__fdividef(a[nt][0], p[nt][0]), __fdividef(a[nt][1], p[nt][1]));
    u[2 * nt + 1] = bf16x2(__fdividef(a[nt][2], p[nt][2]), __fdividef(a[nt][3], p[nt][3]));
  }
}

// bytes 2 i and 2 i + 1 of w as packed bf16, exactly: a byte permute makes
// byte x the f32 2^23 + x, one subtraction leaves the f32 x, and since x has
// at most 8 significant bits, the upper half of that f32 is its bf16 (no
// conversion instruction, no rounding)
__device__ __forceinline__ uint32_t widen2(uint32_t w, int i) {
  const float lo = __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7440 + 2 * i)) - 8388608.f;
  const float hi = __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7441 + 2 * i)) - 8388608.f;
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

// The rows r0 .. r0 + ROWS - 1 x 16-byte chunks c0 .. c0 + CPW - 1 of a
// landed uint8 tile (TM rows of TNP bytes) into the TNP / 64 swizzled bf16
// tiles of 64 columns, by one warp: the part of the tile it multiplies
template <int TM, int TNP, int ROWS, int CPW>
__device__ __forceinline__ void widen_part(const unsigned char* src, unsigned char* dst,
                                           int r0, int c0, int lane) {
#pragma unroll
  for (int i = 0; i < ROWS * CPW / 32; ++i) {
    // rows fastest: 8 lanes take one chunk of 8 rows, which the swizzles
    // spread over all banks, both here and in the bf16 tile
    const int e = lane + 32 * i, r = r0 + e % ROWS, c = c0 + e / ROWS;
    const uint4 v = *reinterpret_cast<const uint4*>(src + u8_off<TNP>(r, c));
    unsigned char* d = dst + c / 4 * TM * 128;
    *reinterpret_cast<uint4*>(d + chunk_off(r, 2 * (c % 4))) =
        make_uint4(widen2(v.x, 0), widen2(v.x, 1), widen2(v.y, 0), widen2(v.y, 1));
    *reinterpret_cast<uint4*>(d + chunk_off(r, 2 * (c % 4) + 1)) =
        make_uint4(widen2(v.z, 0), widen2(v.z, 1), widen2(v.w, 0), widen2(v.w, 1));
  }
}


// ---- 3xTF32: f32 products on the TF32 tensor cores --------------------------
//
// An f32 x is split into two TF32 values, hi = x rounded to TF32 (10
// explicit mantissa bits) and lo = the remainder x - hi, so that x = hi + lo
// to about 2^-21 relative. A product a b then takes three TF32 products,
// a_lo b_hi + a_hi b_lo + a_hi b_hi (the dropped a_lo b_lo is about 2^-22 of
// a b), summed in f32: f32 accuracy at a third of the TF32 tensor-core rate
// (495 / 3 = 165 TFLOP/s on an H100 SXM, against 67 on its CUDA cores).
// The tensor cores add into their f32 accumulator without rounding to
// nearest: over a chain of n mma into one accumulator the error grows like n
// ulps (4e-4 at n = 14400), so a kernel sums a few mma from zero and adds
// that into its own f32 sums.

// x = hi + lo: hi is x rounded to TF32 (half an ulp of TF32 added to the
// magnitude, then the 13 low bits cleared), lo the exact remainder, whose
// low 13 bits the tensor core ignores (about 2^-21 of x)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// two f32 from shared memory at p (8-byte aligned), split: elements e0 and
// e1 of a fragment's hi and lo parts
__device__ __forceinline__ void ld_split2(const float* p, uint32_t& h0, uint32_t& l0,
                                          uint32_t& h1, uint32_t& l1) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  split_tf32(v.x, h0, l0);
  split_tf32(v.y, h1, l1);
}

// c += a b on the TF32 tensor cores: a 16 x 8 (row), b 8 x 8 (col), c 16 x 8
// f32. Thread (g, t) = (lane / 4, lane % 4) holds a0 = a[g][t], a1 =
// a[g + 8][t], a2 = a[g][t + 4], a3 = a[g + 8][t + 4]; b0 = b[t][g], b1 =
// b[t + 4][g]; c0, c1 = c[g][2t, 2t + 1], c2, c3 = c[g + 8][2t, 2t + 1]
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c[i] += a b[i] for four independent 3xTF32 products (a = ah + al, b[i] =
// bh[i] + bl[i]), the small products first and term by term, so that no
// mma waits on the one before it
__device__ __forceinline__ void mma4_3xtf32(float (&c)[4][4], const uint32_t (&ah)[4],
                                            const uint32_t (&al)[4],
                                            const uint32_t (&bh)[4][2],
                                            const uint32_t (&bl)[4][2]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) mma_tf32(c[i], al, bh[i][0], bh[i][1]);
#pragma unroll
  for (int i = 0; i < 4; ++i) mma_tf32(c[i], ah, bl[i][0], bl[i][1]);
#pragma unroll
  for (int i = 0; i < 4; ++i) mma_tf32(c[i], ah, bh[i][0], bh[i][1]);
}
