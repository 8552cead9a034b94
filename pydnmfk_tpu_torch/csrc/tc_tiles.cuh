// Tile helpers of the tensor-core kernels (K1's and K3's, csrc/fused_mu_fro.cu
// and csrc/fused_mu_kl.cu): swizzled shared-memory tiles of 128-byte rows,
// cp.async copies, ldmatrix, bf16 mma.sync and the exact widening of uint8
// values. Included inside each file's anonymous namespace tc, so each
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

// two f32 as packed bf16 (cvt.rn.bf16x2.f32), lo in the low half
__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
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

