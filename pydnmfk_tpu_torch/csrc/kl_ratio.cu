// K2a / K2b: the two products of the KL multiplicative update,
//
//     UHT = (A / (W H + eps)) H^T     (m x k)   K2a
//     WTU = W^T (A / (W H + eps))     (k x n)   K2b
//
// with the ratio U never written to device memory.
//
// Replaces pydnmfk_tpu/ops/pallas_kernels.py::_uht_kernel (kl_uht_pallas)
// and ::_wtu_kernel (kl_wtu_pallas). The TPU kernels revisit one output
// block across the innermost grid axis; here that axis becomes a loop inside
// the block, and partial sums meet in a fixed order: no atomics, and two
// launches give the same bits.
//
// What bounds them on an H100: each element of A costs 2 k FMAs (k for WH,
// k for the product) and one division against 4, 2 or 1 bytes read once.
// At k <= 8 (KP = 8, the NMFk sweep's widths) the FMAs take about 40 % of
// the time the bytes take, so the bytes bound the kernels; at k = 32 the
// FMAs do (4 m n k operations over the 67 TFLOP/s of the CUDA cores). On
// an H100 SXM at 700 W the kernels below reach 73-78 % of the bytes bound
// on a 10-member 14400 x 9600 stack at k = 8, and 36-39 % of the FMA bound
// at 57600 x 38400, k = 32. What the design does about both, for KP = 8, 16
// and 32:
//
//   * U lives only in registers. Each thread loads four consecutive columns
//     of a row of A at once (16 bytes at f32, 8 at bf16 or f16, 4 at uint8)
//     straight into registers, issued D rows (K2b: 4, or 8 for uint8) or two column
//     steps (K2a) before they are used, widens them exactly to f32, forms WH for them,
//     divides and adds the product into registers it owns for the whole
//     loop. No tile of A or U goes through shared memory, and the only block
//     barrier per tile is the one that hands over a staged tile of W (K2b)
//     or H (K2a), copied with cp.async one tile ahead.
//   * K2b (kl_wtu_reg_kernel): a warp walks rows; each thread keeps
//     H[c0 : c0 + KH, j : j + 4] and its out[c0 : c0 + KH, j : j + 4] in
//     registers and reads W[r, c0 : c0 + KH] as a broadcast 16-byte read of
//     shared memory: 2 KH FMAs per element for KH / 4 shared loads per row.
//     At KP = 32, KH = 16 and two threads share a column group (their halves
//     of WH meet through one shuffle). The 8 warps of a block take
//     interleaved rows of one strip of SW columns (W staged in chunks of
//     256 rows) and meet once, at the end, in shared memory, summed in warp
//     order.
//   * A row split for K2b: where B x strips blocks are fewer than the SMs
//     (the single-member refit has 75 strips at n = 9600), the wrapper
//     (ops/kl.py::wtu_split_plan, from the strip and chunk that
//     kl_wtu_geometry exports) cuts each member's rows into S ranges so
//     that B x strips x S blocks reach 8 per SM; split s writes its partial
//     sums to slab s of an f32 scratch the wrapper allocates, and
//     kl_wtu_reduce_kernel adds the slabs in order s = 0, 1, ... . The
//     10-member stack (750 strips) takes one split: two or three measured
//     no faster.
//   * K2a (kl_uht_reg_kernel): a thread owns RW = 2 rows and keeps their
//     out[r, :] in registers; W's rows of the block are staged once in shared
//     memory and read as 16-byte broadcasts, and H[:, j : j + 4] of a staged
//     H tile as 16-byte shared loads, read by the LR lanes that share a
//     column group as one broadcast (LR = 1, 2, 4 at KP = 8, 16, 32: the
//     more FMAs an element costs, the fewer distinct addresses a load has).
//     At KP = 8, H's values stay in registers for both passes. A is loaded
//     two column steps ahead. The LC lanes that share a row reduce their
//     column slices once, at the end, by a butterfly of shuffles. No column
//     split: m / (8 LR RW) blocks per member fill the card.
//   * Division: __fdividef (a multiply by an approximate reciprocal, within
//     2 ulp; WH + eps lies in (0, 2^126) for nonnegative factors). IEEE `/`
//     measured 11-37 % slower at the shapes above, with the same errors.
//   * ptxas spills nothing: at KP = 8 the kernels fit two blocks of 256
//     threads per SM (128 registers), at KP = 16, 32 one.
//
// Ragged edges and rows that are not aligned for the vector width (n % 4 !=
// 0, or A or H not 16-byte aligned) take the masked scalar path (VEC =
// false): elements past m or n load as zeros and give U = 0; A is never
// padded or copied. k is padded inside the kernels to KP = 8, 16, 32 with
// zeros.
//
// k > 32 (KP = 64, 128, 256; kl_uht_tc_kernel, kl_wtu_tc_kernel): the FMAs
// bound the kernels (4 m n k against 4, 2 or 1 bytes of A an element: 8.45
// ms at 57600 x 38400, k = 64, on the CUDA cores), and the 1e-4 limit against
// the plain version rules out plain TF32 or bf16 operands. Both products run
// in 3xTF32 on the tensor cores instead (tc_tiles.cuh: each f32 operand split
// into a TF32 high and low part, hi hi + hi lo + lo hi summed in f32 by
// mma.sync m16n8k8), f32 work at 495 / 3 = 165 TFLOP/s: 3.43 ms at that
// shape. Flash-attention style, U kept in registers:
//
//   * K2a: a block takes TM = 128 rows, 16 a warp; W's rows stay in shared
//     memory for the whole block (at most KP columns), and tiles of H of TN =
//     32 columns arrive by cp.async one tile ahead. Each warp's 16 x 32
//     values of A arrive by cp.async too (chunks of four elements, 16 bytes
//     at f32), one tile ahead into a buffer of the warp's, and are read
//     from there in the accumulator's layout (padded rows: no bank
//     conflict). Per tile a warp
//     forms S = W_rows H_tile by 3xTF32 mma over k in steps of 8 (four
//     independent accumulators, issued term by term), divides (__fdividef;
//     an element of A that is 0, as the padding past m and n, gives U = 0)
//     and adds U H_tile^T into its 16 x KP f32 sums. The accumulator of S is
//     the A operand of that second product with no shuffle: thread (g, t)
//     holds columns 2t and 2t + 1 where the operand wants t and t + 4, so the
//     reduction index is permuted (position t is column 2t, t + 4 is 2t + 1)
//     and H's rows are read in that order, as one 8-byte shared load. The
//     same permutation of k in the first product makes W's fragment two
//     8-byte loads.
//   * K2b, the transposed sweep of K3's tc::fused_mu_kl_tc_kernel: a block
//     takes a strip of SW = 128 columns, 16 a warp, and keeps the strip's
//     H in shared memory; W arrives in chunks of CR = 32 rows by cp.async
//     one chunk ahead, and each warp's 32 x 16 values of A by cp.async into
//     its own buffer, as in K2a. Per chunk a warp forms S^T = H_strip^T W_rows^T (16
//     columns x 8 rows a step, the H^T fragment reused over the chunk's four
//     steps); U^T's accumulator is then, under the same permutation, the B
//     operand of W^T U for the warp's two 8-column tiles, and W^T's fragments
//     come from the staged chunk. The split of rows over blocks (the wrapper's
//     plan, on the strip and chunk that kl_wtu_geometry exports) and its
//     fixed-order reduction are those of k <= 32.
//   * Sums: the tensor cores add into their accumulator without rounding to
//     nearest, and the error grows with the chain (4e-4 of the result after
//     the 14400 mma of K2a at n = 38400). So each tile (K2a) or chunk (K2b)
//     forms its 12 mma of an output tile from zero, in groups of OG output
//     tiles (independent chains), and adds them into the f32 sums: the long
//     sums round to nearest, as the plain version's.
//   * Splits: hi = x rounded to TF32 by an integer add and mask, lo = x - hi
//     (exact; the tensor core reads its top 19 bits), 3 instructions an
//     element, taken as each fragment is loaded.
//   * Registers are the crux: a warp's 16 x KP (K2a) or KP x 16 (K2b) sums
//     take KP / 2 floats a thread, 128 at KP = 256. W's and H's tiles stay in
//     shared memory and are split at fragment-load time (3 instructions an
//     element), one block of 256 threads an SM at KP = 128 and 256 (up to 255
//     registers), two at KP = 64 (128). No spills (chip_smoke.py's [ptxas]).
//     At KP = 256 the A buffers (20 KB a block at f32) fill shared memory
//     to 224 KB (K2a) and 217 KB (K2b) of the 227 KB a block may take. A
//     loaded straight into registers instead (the first design; H100 SXM,
//     700 W) was 4-21 %
//     slower at k = 64 (most on a uint8 A, whose K2b loads were single
//     bytes) and 3 % faster for K2a at KP = 128 and 256.
//   * Past 256 columns the grid gains an output-slab axis: each block covers
//     at most 256 factor columns of the output, and recomputes W H over all
//     k in chunks of 256, the slab's own chunk last, so its H rows stay
//     staged for the product. With one chunk W's rows (K2a) or H's strip
//     (K2b) are staged once; with several, each tile (K2a) or row chunk (K2b)
//     restages W's and H's chunk in turn, synchronously. So past 256 A is
//     read ceil(k / 256) times, the W H products take ceil(k / 256) times
//     their work, and the restaging reads W's panel (K2a) or H's strip (K2b)
//     from L2 once a tile or chunk: a simple design, for widths no measured
//     path needs to be fast at yet.
//
// A bf16, f16 or uint8 A is widened exactly to f32 as it is loaded; all
// arithmetic is f32, as in the plain path and in pydnmfk_tpu/ops/kl.py:33-34,
// which divides the integer A by an f32 WH.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int NT = 256;           // threads per block (8 warps), every kernel
constexpr int NWARP = NT / 32;
constexpr unsigned FULL = 0xffffffffu;

// Four consecutive elements of a row of A: their raw bits, loaded once
// (streaming: A is read once) and widened exactly to f32.
template <typename T> struct Vec4;

template <> struct Vec4<float> {
  using raw = float4;
  static __device__ __forceinline__ raw zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
  static __device__ __forceinline__ raw load(const float* p) {
    return __ldcs(reinterpret_cast<const float4*>(p));
  }
  static __device__ __forceinline__ raw load_scalar(const float* p, int valid) {
    raw v = zero();
    v.x = __ldcs(p);
    if (valid > 1) v.y = __ldcs(p + 1);
    if (valid > 2) v.z = __ldcs(p + 2);
    if (valid > 3) v.w = __ldcs(p + 3);
    return v;
  }
  static __device__ __forceinline__ void widen(raw v, float a[4]) {
    a[0] = v.x; a[1] = v.y; a[2] = v.z; a[3] = v.w;
  }
};

template <> struct Vec4<__nv_bfloat16> {
  using raw = uint2;
  static __device__ __forceinline__ raw zero() { return make_uint2(0u, 0u); }
  static __device__ __forceinline__ raw load(const __nv_bfloat16* p) {
    return __ldcs(reinterpret_cast<const uint2*>(p));
  }
  static __device__ __forceinline__ raw load_scalar(const __nv_bfloat16* p, int valid) {
    const unsigned short* q = reinterpret_cast<const unsigned short*>(p);
    unsigned e[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) e[i] = i < valid ? (unsigned)__ldcs(q + i) : 0u;
    return make_uint2(e[0] | (e[1] << 16), e[2] | (e[3] << 16));
  }
  // a bf16 is the upper half of the f32 with the same value
  static __device__ __forceinline__ void widen(raw v, float a[4]) {
    a[0] = __uint_as_float(v.x << 16); a[1] = __uint_as_float(v.x & 0xffff0000u);
    a[2] = __uint_as_float(v.y << 16); a[3] = __uint_as_float(v.y & 0xffff0000u);
  }
};

template <> struct Vec4<__half> {
  using raw = uint2;
  static __device__ __forceinline__ raw zero() { return make_uint2(0u, 0u); }
  static __device__ __forceinline__ raw load(const __half* p) {
    return __ldcs(reinterpret_cast<const uint2*>(p));
  }
  static __device__ __forceinline__ raw load_scalar(const __half* p, int valid) {
    const unsigned short* q = reinterpret_cast<const unsigned short*>(p);
    unsigned e[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) e[i] = i < valid ? (unsigned)__ldcs(q + i) : 0u;
    return make_uint2(e[0] | (e[1] << 16), e[2] | (e[3] << 16));
  }
  // every f16 value is an f32 value: the conversion is exact
  static __device__ __forceinline__ void widen(raw v, float a[4]) {
    const float2 lo = __half22float2(*reinterpret_cast<const __half2*>(&v.x));
    const float2 hi = __half22float2(*reinterpret_cast<const __half2*>(&v.y));
    a[0] = lo.x; a[1] = lo.y; a[2] = hi.x; a[3] = hi.y;
  }
};

template <> struct Vec4<uint8_t> {
  using raw = unsigned;
  static __device__ __forceinline__ raw zero() { return 0u; }
  static __device__ __forceinline__ raw load(const uint8_t* p) {
    return __ldcs(reinterpret_cast<const unsigned*>(p));
  }
  static __device__ __forceinline__ raw load_scalar(const uint8_t* p, int valid) {
    unsigned v = 0u;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (i < valid) v |= (unsigned)__ldcs(p + i) << (8 * i);
    return v;
  }
  // byte i becomes the f32 2^23 + x (a byte permute), less 2^23: exactly x
  static __device__ __forceinline__ void widen(raw v, float a[4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = __uint_as_float(__byte_perm(v, 0x4b000000u, 0x7440 + i)) - 8388608.f;
  }
};

// row[j .. j + 4) of A; elements past n, or on a row that is not there, are 0.
// VEC: n % 4 == 0 and A aligned, so a group of four lies whole inside n.
template <typename T, bool VEC>
__device__ __forceinline__ typename Vec4<T>::raw load4(const T* row, int j, int n,
                                                       bool row_ok) {
  if (!row_ok || j >= n) return Vec4<T>::zero();
  if (VEC) return Vec4<T>::load(row + j);
  return Vec4<T>::load_scalar(row + j, min(4, n - j));
}

__device__ __forceinline__ float ratio(float a, float d) { return __fdividef(a, d); }

// cp.async of 4 or 16 bytes; pred false writes zeros (source size 0)
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(pred ? 4 : 0));
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// ---- K2b: WTU = W^T U ------------------------------------------------------

template <int KP>
struct WtuGeom {
  static constexpr int KH = KP < 16 ? KP : 16;   // factor rows per thread
  static constexpr int G = KP / KH;              // threads per column group
  static constexpr int SW = 4 * 32 / G;          // strip width: columns per block
  static constexpr int CR = 256;                 // rows per staged W chunk
  static constexpr int RPW = CR / NWARP;         // rows of a chunk per warp
  static constexpr size_t smem() {               // W chunks, then the reduction
    const size_t w = 2 * CR * KP, red = NWARP * KP * SW;
    return sizeof(float) * (w > red ? w : red);
  }
};

// Block (strip x, member y, split z): rows [z R, min(m, (z + 1) R)) of
// columns [x SW, x SW + SW); out is the (S, B, k, n) scratch when S > 1,
// else the (B, k, n) result.
template <typename T, int KP, bool VEC>
__global__ void __launch_bounds__(NT, KP <= 8 ? 2 : 1)
kl_wtu_reg_kernel(const T* __restrict__ A, const float* __restrict__ W,
                  const float* __restrict__ H, float eps, int m, int n, int k,
                  int rows_per_split, float* __restrict__ out) {
  using Gm = WtuGeom<KP>;
  using V = Vec4<T>;
  using Raw = typename V::raw;
  constexpr int KH = Gm::KH, G = Gm::G, SW = Gm::SW, CR = Gm::CR, RPW = Gm::RPW;
  constexpr int D = sizeof(T) == 1 ? 8 : 4;      // rows of A in flight per thread
  static_assert(RPW % D == 0, "a chunk holds whole prefetch groups");
  extern __shared__ __align__(16) float smem[];
  float* Ws = smem;                              // [2][CR][KP]

  const int b = blockIdx.y, s = blockIdx.z;
  const int col0 = blockIdx.x * SW;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane % G, cg = lane / G;
  const int j = col0 + 4 * cg;                   // the thread's 4 columns
  const int c0 = g * KH;                         // and its factor rows
  const int rb = s * rows_per_split;
  const int re = min(m, rb + rows_per_split);
  A += (size_t)b * m * n;
  W += (size_t)b * m * k;
  H += (size_t)b * k * n;

  float h[KH][4], acc[KH][4];
#pragma unroll
  for (int cc = 0; cc < KH; ++cc)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int c = c0 + cc;
      h[cc][q] = (c < k && j + q < n) ? H[(size_t)c * n + j + q] : 0.f;
      acc[cc][q] = 0.f;
    }

  // W rows [row0, row0 + CR) into chunk buffer buf, zeros past re and k
  auto stage = [&](int buf, int row0) {
    float* dst = Ws + buf * CR * KP;
    for (int e = threadIdx.x; e < CR * KP; e += NT) {
      const int r = e / KP, c = e % KP, row = row0 + r;
      const bool ok = row < re && c < k;
      cp_async4(dst + e, ok ? W + (size_t)row * k + c : W, ok);
    }
    cp_async_commit();
  };
  // the warp's t-th row: chunk t / RPW, rows interleaved over the warps
  auto row_of = [&](int t) {
    return rb + (t / RPW) * CR + warp + NWARP * (t % RPW);
  };

  const int nchunks = (re - rb + CR - 1) / CR;
  Raw buf[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const int r = row_of(d);
    buf[d] = load4<T, VEC>(A + (size_t)r * n, j, n, r < re);
  }
  stage(0, rb);
  for (int ch = 0; ch < nchunks; ++ch) {
    cp_async_wait_all();
    __syncthreads();          // chunk ch landed; chunk ch - 1 is read by all
    if (ch + 1 < nchunks) stage((ch + 1) & 1, rb + (ch + 1) * CR);
    const float* Wc = Ws + (ch & 1) * CR * KP;
    for (int i0 = 0; i0 < RPW; i0 += D) {
#pragma unroll
      for (int d = 0; d < D; ++d) {
        const int i = i0 + d;
        float a[4];
        V::widen(buf[d], a);
        const int rn = row_of(ch * RPW + i + D);      // D rows ahead
        buf[d] = load4<T, VEC>(A + (size_t)rn * n, j, n, rn < re);
        const float* wr = Wc + (warp + NWARP * i) * KP + c0;
        float wv[KH];
#pragma unroll
        for (int cc = 0; cc < KH; cc += 4) {
          const float4 t4 = *reinterpret_cast<const float4*>(wr + cc);
          wv[cc] = t4.x; wv[cc + 1] = t4.y; wv[cc + 2] = t4.z; wv[cc + 3] = t4.w;
        }
        float wh[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int cc = 0; cc < KH; ++cc)
#pragma unroll
          for (int q = 0; q < 4; ++q) wh[q] = fmaf(wv[cc], h[cc][q], wh[q]);
#pragma unroll
        for (int off = 1; off < G; off <<= 1)
#pragma unroll
          for (int q = 0; q < 4; ++q) wh[q] += __shfl_xor_sync(FULL, wh[q], off);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float u = ratio(a[q], wh[q] + eps);
#pragma unroll
          for (int cc = 0; cc < KH; ++cc) acc[cc][q] = fmaf(wv[cc], u, acc[cc][q]);
        }
      }
    }
  }

  // the 8 warps' sums meet in shared memory, added in warp order
  __syncthreads();
  float* red = smem;                             // [NWARP][KP][SW]
#pragma unroll
  for (int cc = 0; cc < KH; ++cc)
    *reinterpret_cast<float4*>(red + ((size_t)(warp * KP + c0 + cc) * SW + 4 * cg)) =
        make_float4(acc[cc][0], acc[cc][1], acc[cc][2], acc[cc][3]);
  __syncthreads();
  float* dst = out + ((size_t)s * gridDim.y + b) * k * n;
  for (int e = threadIdx.x; e < KP * SW; e += NT) {
    const int c = e / SW, jj = e % SW;
    if (c < k && col0 + jj < n) {
      float v = 0.f;
#pragma unroll
      for (int w = 0; w < NWARP; ++w) v += red[(w * KP + c) * SW + jj];
      dst[(size_t)c * n + col0 + jj] = v;
    }
  }
}

// out[i] = sum over s = 0, 1, ..., S - 1 of part[s len + i], in that order
__global__ void __launch_bounds__(NT)
kl_wtu_reduce_kernel(const float* __restrict__ part, int S, size_t len,
                     float* __restrict__ out) {
  for (size_t i = blockIdx.x * (size_t)NT + threadIdx.x; i < len;
       i += (size_t)gridDim.x * NT) {
    float v = 0.f;
    for (int s = 0; s < S; ++s) v += part[s * len + i];
    out[i] = v;
  }
}

// ---- K2a: UHT = U H^T ------------------------------------------------------

template <int KP>
struct UhtGeom {
  static constexpr int LR = KP <= 8 ? 1 : KP <= 16 ? 2 : 4;  // lanes along rows
  static constexpr int LC = 32 / LR;             // lanes along columns
  static constexpr int RW = 2;                   // rows per thread
  static constexpr int TMR = NWARP * LR * RW;    // rows per block
  static constexpr int STEP = 4 * LC;            // columns per warp step
  static constexpr int TN = KP <= 16 ? 512 : 256;  // columns per staged H tile
  static constexpr int SPT = TN / STEP;          // steps per tile
  static constexpr int DA = 2;                   // steps of A in flight per thread
  static constexpr int LDW = KP + 4;             // padded row stride of W's tile
  static constexpr size_t smem() { return sizeof(float) * (2 * KP * TN + TMR * LDW); }
};

// At KP > 8 ptxas would hoist all KP of H's shared loads of a pass to the
// top (KP x 4 values beside the sums, and spills): a warp barrier, which
// orders shared memory, every eighth factor column keeps at most eight in
// flight. At KP = 8 H's values stay in registers for both passes.
template <int KP>
__device__ __forceinline__ void fence8(int c) {
  if (KP > 8 && c % 8 == 0) __syncwarp();
}

// Block (row tile x, member y): rows [x TMR, x TMR + TMR), every column.
template <typename T, int KP, bool VEC>
__global__ void __launch_bounds__(NT, KP <= 8 && sizeof(T) > 1 ? 2 : 1)
kl_uht_reg_kernel(const T* __restrict__ A, const float* __restrict__ W,
                  const float* __restrict__ H, float eps, int m, int n, int k,
                  float* __restrict__ out) {
  using Gm = UhtGeom<KP>;
  using V = Vec4<T>;
  using Raw = typename V::raw;
  constexpr int LR = Gm::LR, LC = Gm::LC, RW = Gm::RW, TN = Gm::TN, SPT = Gm::SPT,
                STEP = Gm::STEP, DA = Gm::DA, LDW = Gm::LDW;
  static_assert(SPT % DA == 0, "a tile holds whole prefetch groups");
  extern __shared__ __align__(16) float smem[];
  float* Hs = smem;                              // [2][KP][TN]
  float* Ws = Hs + 2 * KP * TN;                  // [TMR][LDW]

  const int b = blockIdx.y;
  const int row0 = blockIdx.x * Gm::TMR;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int lc = lane % LC, lr = lane / LC;
  const int rloc = warp * LR * RW + lr;          // rows rloc + LR i of the tile
  const int rbase = row0 + rloc;
  A += (size_t)b * m * n;
  W += (size_t)b * m * k;
  H += (size_t)b * k * n;
  out += (size_t)b * m * k;

  // W's rows of the block, zeros past m and k (the first barrier below
  // publishes them)
  for (int e = threadIdx.x; e < Gm::TMR * KP; e += NT) {
    const int r = e / KP, c = e % KP;
    Ws[r * LDW + c] = (row0 + r < m && c < k) ? W[(size_t)(row0 + r) * k + c] : 0.f;
  }
  float acc[RW][KP];
#pragma unroll
  for (int i = 0; i < RW; ++i)
#pragma unroll
    for (int c = 0; c < KP; ++c) acc[i][c] = 0.f;

  // H[:, j0 : j0 + TN) into tile buffer buf, zeros past k and n
  auto stage = [&](int buf, int j0) {
    float* dst = Hs + buf * KP * TN;
    if (VEC) {
      for (int e = threadIdx.x; e < KP * TN / 4; e += NT) {
        const int c = e / (TN / 4), jj = 4 * (e % (TN / 4));
        const bool ok = c < k && j0 + jj < n;
        cp_async16(dst + c * TN + jj, ok ? H + (size_t)c * n + j0 + jj : H, ok);
      }
    } else {
      for (int e = threadIdx.x; e < KP * TN; e += NT) {
        const int c = e / TN, jj = e % TN;
        const bool ok = c < k && j0 + jj < n;
        cp_async4(dst + e, ok ? H + (size_t)c * n + j0 + jj : H, ok);
      }
    }
    cp_async_commit();
  };

  const int ntiles = (n + TN - 1) / TN;
  Raw nxt[DA][RW];                               // steps s + 1 .. s + DA ahead
#pragma unroll
  for (int d = 0; d < DA; ++d)
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      const int r = rbase + LR * i;
      nxt[d][i] = load4<T, VEC>(A + (size_t)r * n, d * STEP + 4 * lc, n, r < m);
    }
  stage(0, 0);
  for (int tl = 0; tl < ntiles; ++tl) {
    cp_async_wait_all();
    __syncthreads();          // tile tl landed; tile tl - 1 is read by all
    if (tl + 1 < ntiles) stage((tl + 1) & 1, (tl + 1) * TN);
    const float* Ht = Hs + (tl & 1) * KP * TN;
#pragma unroll 1
    for (int st0 = 0; st0 < SPT; st0 += DA) {
#pragma unroll
      for (int d = 0; d < DA; ++d) {
        const int st = st0 + d;
        float a[RW][4];
        const int jn = (tl * SPT + st + DA) * STEP + 4 * lc;   // DA steps ahead
#pragma unroll
        for (int i = 0; i < RW; ++i) {
          V::widen(nxt[d][i], a[i]);
          const int r = rbase + LR * i;
          nxt[d][i] = load4<T, VEC>(A + (size_t)r * n, jn, n, r < m);
        }
        const float* hc = Ht + st * STEP + 4 * lc;
        float wh[RW][4];
#pragma unroll
        for (int i = 0; i < RW; ++i)
#pragma unroll
          for (int q = 0; q < 4; ++q) wh[i][q] = 0.f;
#pragma unroll
        for (int c4 = 0; c4 < KP; c4 += 4) {
          fence8<KP>(c4);
          float w4[RW][4];
#pragma unroll
          for (int i = 0; i < RW; ++i) {
            const float4 t = *reinterpret_cast<const float4*>(Ws + (rloc + LR * i) * LDW + c4);
            w4[i][0] = t.x; w4[i][1] = t.y; w4[i][2] = t.z; w4[i][3] = t.w;
          }
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) {
            const float4 hv = *reinterpret_cast<const float4*>(hc + (c4 + cc) * TN);
#pragma unroll
            for (int i = 0; i < RW; ++i) {
              wh[i][0] = fmaf(w4[i][cc], hv.x, wh[i][0]);
              wh[i][1] = fmaf(w4[i][cc], hv.y, wh[i][1]);
              wh[i][2] = fmaf(w4[i][cc], hv.z, wh[i][2]);
              wh[i][3] = fmaf(w4[i][cc], hv.w, wh[i][3]);
            }
          }
        }
        float u[RW][4];
#pragma unroll
        for (int i = 0; i < RW; ++i)
#pragma unroll
          for (int q = 0; q < 4; ++q) u[i][q] = ratio(a[i][q], wh[i][q] + eps);
#pragma unroll
        for (int c = 0; c < KP; ++c) {
          fence8<KP>(c);
          const float4 hv = *reinterpret_cast<const float4*>(hc + c * TN);
#pragma unroll
          for (int i = 0; i < RW; ++i) {
            float v = acc[i][c];
            v = fmaf(u[i][0], hv.x, v);
            v = fmaf(u[i][1], hv.y, v);
            v = fmaf(u[i][2], hv.z, v);
            acc[i][c] = fmaf(u[i][3], hv.w, v);
          }
        }
      }
    }
  }

  // the LC column slices of a row meet in a butterfly of shuffles (every lane
  // ends with the same sum), then lane lc writes the factor columns c = lc mod LC
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    const int r = rbase + LR * i;
#pragma unroll
    for (int c = 0; c < KP; ++c) {
      float v = acc[i][c];
#pragma unroll
      for (int off = 1; off < LC; off <<= 1) v += __shfl_xor_sync(FULL, v, off);
      if (c % LC == lc && r < m && c < k) out[(size_t)r * k + c] = v;
    }
  }
}

// ---- K2a / K2b at k > 32: 3xTF32 on the tensor cores ------------------------

namespace tc {
#include "tc_tiles.cuh"
}  // namespace tc

namespace tf {

constexpr int TM = 128;          // K2a: rows per block, 16 a warp
constexpr int TN = 32;           // K2a: columns of A per tile, four n8 tiles
constexpr int LDH = TN + 4;      // K2a: row stride of a staged H tile
constexpr int SW = 128;          // K2b: columns per strip, 16 a warp
constexpr int CR = 32;           // K2b: rows per staged W chunk, four steps of 8
constexpr int OG = 4;            // n8 (K2a) or m16 / 2 (K2b) output tiles a group

// VEC: each warp's own rows (K2a) or columns (K2b) of A arrive by cp.async
// in chunks of four elements into a buffer of the warp's, one tile (K2a) or
// chunk (K2b) ahead, and are read from there in the accumulator's layout.
// ALD is the buffer's row stride in bytes, padded so that those reads meet
// no bank conflict.
template <int KP, typename T, bool VEC>
struct UhtTc {
  static constexpr int LDW = KP + 8;             // W's rows, [TM][LDW]
  static constexpr int ALD = TN * sizeof(T) + (sizeof(T) == 4 ? 32 : 16);
  static constexpr int FLOATS = TM * LDW + 2 * KP * LDH;
  static constexpr size_t smem() { return sizeof(float) * FLOATS + (VEC ? TM * ALD : 0); }
};

constexpr int LDS = SW + 4;      // K2b: row stride of the staged H strip

template <int KP, typename T, bool VEC>
struct WtuTc {
  static constexpr int LDW = KP + 4;             // a W chunk, [CR][LDW]
  static constexpr int ALD = 16 * sizeof(T) + (sizeof(T) == 1 ? 8 : 16);
  static constexpr int FLOATS = KP * LDS + 2 * CR * LDW;
  static constexpr size_t smem() { return sizeof(float) * FLOATS + (VEC ? NT / 32 * CR * ALD : 0); }
};

// U = a / d; an element of A that is 0 (the padding past m and n among
// them) gives 0 whatever d is
__device__ __forceinline__ float ratio0(float a, float d) {
  return a == 0.f ? 0.f : __fdividef(a, d);
}

// one element of A (streaming: A is read once), widened exactly to f32
template <typename T>
__device__ __forceinline__ float load1(const T* __restrict__ p) {
  if constexpr (std::is_same<T, float>::value || std::is_same<T, uint8_t>::value) {
    return (float)__ldcs(p);
  } else {
    const unsigned short b = __ldcs(reinterpret_cast<const unsigned short*>(p));
    if constexpr (std::is_same<T, __half>::value) return __half2float(__ushort_as_half(b));
    else return __uint_as_float((unsigned)b << 16);
  }
}

// one element of A staged in shared memory at p, widened exactly to f32
template <typename T>
__device__ __forceinline__ float smem1(const unsigned char* p) {
  if constexpr (std::is_same<T, float>::value) return *reinterpret_cast<const float*>(p);
  else if constexpr (std::is_same<T, uint8_t>::value) return (float)*p;
  else if constexpr (std::is_same<T, __half>::value)
    return __half2float(*reinterpret_cast<const __half*>(p));
  else return __uint_as_float((unsigned)*reinterpret_cast<const unsigned short*>(p) << 16);
}

// two consecutive elements of A staged in shared memory at p (aligned for
// the pair), widened exactly to f32
template <typename T>
__device__ __forceinline__ float2 smem2(const unsigned char* p) {
  if constexpr (std::is_same<T, float>::value) {
    return *reinterpret_cast<const float2*>(p);
  } else if constexpr (sizeof(T) == 2) {
    const unsigned w = *reinterpret_cast<const unsigned*>(p);
    if constexpr (std::is_same<T, __half>::value)
      return __half22float2(*reinterpret_cast<const __half2*>(&w));
    else return make_float2(__uint_as_float(w << 16), __uint_as_float(w & 0xffff0000u));
  } else {
    const unsigned short w = *reinterpret_cast<const unsigned short*>(p);
    return make_float2((float)(w & 0xffu), (float)(w >> 8));
  }
}

// row[j], row[j + 1] of A as f32; zeros past n or on a row that is not
// there. VEC: n % 4 == 0 and A aligned, so the pair (j even) lies whole
// inside n and loads at once.
template <typename T, bool VEC>
__device__ __forceinline__ float2 load_pair(const T* __restrict__ row, int j, int n, bool ok) {
  float2 v = make_float2(0.f, 0.f);
  if (!ok || j >= n) return v;
  if constexpr (VEC) {
    if constexpr (std::is_same<T, float>::value) {
      v = __ldcs(reinterpret_cast<const float2*>(row + j));
    } else if constexpr (sizeof(T) == 2) {
      const unsigned w = __ldcs(reinterpret_cast<const unsigned*>(row + j));
      if constexpr (std::is_same<T, __half>::value) {
        v = __half22float2(*reinterpret_cast<const __half2*>(&w));
      } else {
        v.x = __uint_as_float(w << 16);
        v.y = __uint_as_float(w & 0xffff0000u);
      }
    } else {
      const unsigned short w = __ldcs(reinterpret_cast<const unsigned short*>(row + j));
      v.x = (float)(w & 0xffu);
      v.y = (float)(w >> 8);
    }
  } else {
    v.x = load1(row + j);
    if (j + 1 < n) v.y = load1(row + j + 1);
  }
  return v;
}

// rows [0, R) x columns [cb, cb + min(KP, k - cb)) of the (rows x k) f32
// matrix W into dst [R][ld], zeros past `rows` and k; 16-byte copies when k
// % 4 == 0 and W is 16-byte aligned
template <int KP, int R>
__device__ __forceinline__ void stage_rows(float* dst, int ld, const float* __restrict__ W,
                                           int rows, int k, int cb, bool wvec) {
  const int kc = min(KP, k - cb);
  if (wvec) {
    for (int e = threadIdx.x; e < R * KP / 4; e += NT) {
      const int r = e / (KP / 4), c = 4 * (e % (KP / 4));
      const bool ok = r < rows && c < kc;
      tc::cp_async16(tc::smem_u32(dst + r * ld + c), ok ? W + (size_t)r * k + cb + c : W, ok);
    }
  } else {
    for (int e = threadIdx.x; e < R * KP; e += NT) {
      const int r = e / KP, c = e % KP;
      const bool ok = r < rows && c < kc;
      cp_async4(dst + r * ld + c, ok ? W + (size_t)r * k + cb + c : W, ok);
    }
  }
}

// s[i] += W_rows H_tile for the warp's 16 rows (W's rows rl, rl + 8 of Ws)
// and the tile's n8 tiles i = 0 .. 3, over nks steps of 8 factors; k
// permuted within a step (position t is factor 2t, t + 4 is 2t + 1) in both
// operands
template <int LDW>
__device__ __forceinline__ void uht_s(float (&s)[4][4], const float* Ws, const float* Hc,
                                      int rl, int g, int t, int nks) {
#pragma unroll 2
  for (int ks = 0; ks < nks; ++ks) {
    const int kk = 8 * ks + 2 * t;
    uint32_t ah[4], al[4], bh[4][2], bl[4][2];
    tc::ld_split2(Ws + rl * LDW + kk, ah[0], al[0], ah[2], al[2]);
    tc::ld_split2(Ws + (rl + 8) * LDW + kk, ah[1], al[1], ah[3], al[3]);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int o = kk * LDH + 8 * i + g;
      tc::split_tf32(Hc[o], bh[i][0], bl[i][0]);
      tc::split_tf32(Hc[o + LDH], bh[i][1], bl[i][1]);
    }
    tc::mma4_3xtf32(s, ah, al, bh, bl);
  }
}

// Block (row tile x, member y, output slab z): rows [x TM, x TM + TM) and
// factor columns [z KP, z KP + KP) of UHT, over every column of A.
template <typename T, int KP, bool VEC>
__global__ void __launch_bounds__(NT, KP <= 64 ? 2 : 1)
kl_uht_tc_kernel(const T* __restrict__ A, const float* __restrict__ W,
                 const float* __restrict__ H, float eps, int m, int n, int k,
                 float* __restrict__ out) {
  using G = UhtTc<KP, T, VEC>;
  constexpr int LDW = G::LDW, ALD = G::ALD, NO = KP / 8;
  static_assert(NO % OG == 0, "whole groups of output tiles");
  extern __shared__ __align__(16) float smem[];
  float* Ws = smem;                              // [TM][LDW]
  float* Hs = smem + TM * LDW;                   // [2][KP][LDH]

  const int b = blockIdx.y, slab = blockIdx.z;
  const int row0 = blockIdx.x * TM;
  const int nch = (k + KP - 1) / KP;             // chunks of KP factors
  const int c0 = slab * KP;                      // the slab's first factor
  const int ngr = (min(KP, k - c0) + 8 * OG - 1) / (8 * OG);   // its groups
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rl = 16 * warp + g;                  // rows rl, rl + 8 of the tile
  const int r0 = row0 + rl, r1 = r0 + 8;
  const bool wvec = k % 4 == 0 && reinterpret_cast<uintptr_t>(W) % 16 == 0;
  A += (size_t)b * m * n;
  W += ((size_t)b * m + row0) * k;
  H += (size_t)b * k * n;
  out += (size_t)b * m * k;
  const T* arow0 = A + (size_t)(r0 < m ? r0 : 0) * n;
  const T* arow1 = A + (size_t)(r1 < m ? r1 : 0) * n;
  // VEC: the warp's 16 rows of A's tile, [16][ALD bytes]
  unsigned char* As = reinterpret_cast<unsigned char*>(smem + G::FLOATS) + warp * 16 * ALD;

  // the warp's rows x [j0, j0 + TN) of A into As, zeros past m and n (n % 4
  // == 0: a chunk of four lies whole inside n or past it)
  auto stage_a = [&](int j0) {
#pragma unroll
    for (int q = 0; q < 16 * TN / 4 / 32; ++q) {
      const int e = lane + 32 * q, r = e / (TN / 4), jj = 4 * (e % (TN / 4));
      const int row = row0 + 16 * warp + r;
      const bool ok = row < m && j0 + jj < n;
      tc::cp_async_n<4 * sizeof(T)>(tc::smem_u32(As + r * ALD + jj * sizeof(T)),
                                    ok ? A + (size_t)row * n + j0 + jj : A, ok);
    }
  };

  // H[cb .. cb + KP) x [j0, j0 + TN) into tile buffer buf, zeros past k, n
  auto stage_h = [&](int buf, int c, int j0) {
    const int cb = c * KP, kc = min(KP, k - cb);
    float* dst = Hs + buf * KP * LDH;
    if (VEC) {
      for (int e = threadIdx.x; e < KP * TN / 4; e += NT) {
        const int cc = e / (TN / 4), jj = 4 * (e % (TN / 4));
        const bool ok = cc < kc && j0 + jj < n;
        tc::cp_async16(tc::smem_u32(dst + cc * LDH + jj),
                       ok ? H + (size_t)(cb + cc) * n + j0 + jj : H, ok);
      }
    } else {
      for (int e = threadIdx.x; e < KP * TN; e += NT) {
        const int cc = e / TN, jj = e % TN;
        const bool ok = cc < kc && j0 + jj < n;
        cp_async4(dst + cc * LDH + jj, ok ? H + (size_t)(cb + cc) * n + j0 + jj : H, ok);
      }
    }
  };

  float acc[NO][4];
#pragma unroll
  for (int o = 0; o < NO; ++o) acc[o][0] = acc[o][1] = acc[o][2] = acc[o][3] = 0.f;
  const int ntiles = (n + TN - 1) / TN;
  if (nch == 1) {
    stage_rows<KP, TM>(Ws, LDW, W, m - row0, k, 0, wvec);
    stage_h(0, 0, 0);
  }
  if (VEC) stage_a(0);
  cp_async_commit();
  for (int tl = 0; tl < ntiles; ++tl) {
    const int j0 = tl * TN;
    if (VEC || nch == 1) {
      cp_async_wait_all();
      __syncthreads();        // tile tl landed; tile tl - 1 is read by all
    }
    // the thread's A of the tile in S's accumulator layout, [n8 tile][row
    // half]: VEC from the warp's buffer, which then takes the next tile;
    // else straight from device memory, before the tile's W H so that it
    // lands meanwhile
    float2 a[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (VEC) {
        const unsigned char* p = As + g * ALD + (8 * i + 2 * t) * sizeof(T);
        a[i][0] = smem2<T>(p);
        a[i][1] = smem2<T>(p + 8 * ALD);
      } else {
        a[i][0] = load_pair<T, VEC>(arow0, j0 + 8 * i + 2 * t, n, r0 < m);
        a[i][1] = load_pair<T, VEC>(arow1, j0 + 8 * i + 2 * t, n, r1 < m);
      }
    }
    if (VEC) {
      __syncwarp();           // every lane has read the warp's buffer
      if (tl + 1 < ntiles) stage_a(j0 + TN);
    }
    if (nch == 1 && tl + 1 < ntiles) stage_h((tl + 1) & 1, 0, j0 + TN);
    cp_async_commit();
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
    const float* Hc;
    if (nch == 1) {
      Hc = Hs + (tl & 1) * KP * LDH;
      uht_s<LDW>(s, Ws, Hc, rl, g, t, (k + 7) / 8);
    } else {
      // every chunk of k in turn, the slab's own last: its H rows stay
      for (int q = 0; q < nch; ++q) {
        const int c = (slab + 1 + q) % nch;
        __syncthreads();      // the last chunk (or tile) is read by all
        stage_rows<KP, TM>(Ws, LDW, W, m - row0, k, c * KP, wvec);
        stage_h(0, c, j0);
        cp_async_commit();
        cp_async_wait_all();
        __syncthreads();
        uht_s<LDW>(s, Ws, Hs, rl, g, t, (min(KP, k - c * KP) + 7) / 8);
      }
      Hc = Hs;
    }
    // U = A / (S + eps), split: for n8 tile i, the A operand of U H^T under
    // the permuted reduction index (a0 = (rl, 2t), a1 = (rl + 8, 2t), a2 =
    // (rl, 2t + 1), a3 = (rl + 8, 2t + 1))
    uint32_t uh[4][4], ul[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      tc::split_tf32(ratio0(a[i][0].x, s[i][0] + eps), uh[i][0], ul[i][0]);
      tc::split_tf32(ratio0(a[i][1].x, s[i][2] + eps), uh[i][1], ul[i][1]);
      tc::split_tf32(ratio0(a[i][0].y, s[i][1] + eps), uh[i][2], ul[i][2]);
      tc::split_tf32(ratio0(a[i][1].y, s[i][3] + eps), uh[i][3], ul[i][3]);
    }
    // acc[o] += U H_slab^T, by groups of OG output tiles: the tile's 12 mma
    // of each from zero, then one f32 add. b0 = H[c0 + 8o + g][j0 + 8i +
    // 2t], b1 = the next column, one 8-byte shared load
#pragma unroll
    for (int og = 0; og < NO / OG; ++og) {
      if (og < ngr) {
        float p[OG][4];
#pragma unroll
        for (int oo = 0; oo < OG; ++oo) p[oo][0] = p[oo][1] = p[oo][2] = p[oo][3] = 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          uint32_t bh[OG][2], bl[OG][2];
#pragma unroll
          for (int oo = 0; oo < OG; ++oo)
            tc::ld_split2(Hc + (8 * (OG * og + oo) + g) * LDH + 8 * i + 2 * t, bh[oo][0],
                          bl[oo][0], bh[oo][1], bl[oo][1]);
#pragma unroll
          for (int oo = 0; oo < OG; ++oo) tc::mma_tf32(p[oo], ul[i], bh[oo][0], bh[oo][1]);
#pragma unroll
          for (int oo = 0; oo < OG; ++oo) tc::mma_tf32(p[oo], uh[i], bl[oo][0], bl[oo][1]);
#pragma unroll
          for (int oo = 0; oo < OG; ++oo) tc::mma_tf32(p[oo], uh[i], bh[oo][0], bh[oo][1]);
        }
#pragma unroll
        for (int oo = 0; oo < OG; ++oo)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[OG * og + oo][e] += p[oo][e];
      }
    }
  }

#pragma unroll
  for (int o = 0; o < NO; ++o) {
    const int c = c0 + 8 * o + 2 * t;
    if (o < OG * ngr) {
      if (r0 < m) {
        if (c < k) out[(size_t)r0 * k + c] = acc[o][0];
        if (c + 1 < k) out[(size_t)r0 * k + c + 1] = acc[o][1];
      }
      if (r1 < m) {
        if (c < k) out[(size_t)r1 * k + c] = acc[o][2];
        if (c + 1 < k) out[(size_t)r1 * k + c + 1] = acc[o][3];
      }
    }
  }
}

// s[st] += H_strip^T W_rows^T for the warp's 16 columns (nl, nl + 8 of the
// strip Hs) and the chunk's four steps of 8 rows, over nks steps of 8
// factors, k permuted as in uht_s
template <int LDW>
__device__ __forceinline__ void wtu_s(float (&s)[4][4], const float* Hs, const float* Wc,
                                      int nl, int g, int t, int nks) {
#pragma unroll 2
  for (int ks = 0; ks < nks; ++ks) {
    const int kk = 8 * ks + 2 * t;
    uint32_t ah[4], al[4], bh[4][2], bl[4][2];
    const float* hp = Hs + kk * LDS + nl;
    tc::split_tf32(hp[0], ah[0], al[0]);
    tc::split_tf32(hp[8], ah[1], al[1]);
    tc::split_tf32(hp[LDS], ah[2], al[2]);
    tc::split_tf32(hp[LDS + 8], ah[3], al[3]);
#pragma unroll
    for (int st = 0; st < 4; ++st)
      tc::ld_split2(Wc + (8 * st + g) * LDW + kk, bh[st][0], bl[st][0], bh[st][1], bl[st][1]);
    tc::mma4_3xtf32(s, ah, al, bh, bl);
  }
}

// Block (strip x, member y, z = slab S + split): rows [split R, min(m,
// (split + 1) R)) of columns [x SW, x SW + SW), factor rows [slab KP, slab KP
// + KP) of WTU; out is the (S, B, k, n) scratch when S > 1, else the (B, k,
// n) result.
template <typename T, int KP, bool VEC>
__global__ void __launch_bounds__(NT, KP <= 64 ? 2 : 1)
kl_wtu_tc_kernel(const T* __restrict__ A, const float* __restrict__ W,
                 const float* __restrict__ H, float eps, int m, int n, int k,
                 int rows_per_split, float* __restrict__ out) {
  using G = WtuTc<KP, T, VEC>;
  constexpr int LDW = G::LDW, ALD = G::ALD, NI = KP / 16, IG = OG / 2;
  static_assert(NI % IG == 0, "whole groups of output tiles");
  extern __shared__ __align__(16) float smem[];
  float* Hs = smem;                              // [KP][LDS]
  float* Ws = smem + KP * LDS;                   // [2][CR][LDW]

  const int b = blockIdx.y;
  const int S = (m + rows_per_split - 1) / rows_per_split;
  const int split = blockIdx.z % S, slab = blockIdx.z / S;
  const int col0 = blockIdx.x * SW;
  const int rb = split * rows_per_split, re = min(m, rb + rows_per_split);
  const int nch = (k + KP - 1) / KP;
  const int c0 = slab * KP;
  const int ngr = (min(KP, k - c0) + 16 * IG - 1) / (16 * IG);   // the slab's groups
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int nl = 16 * warp + g;                  // columns nl, nl + 8 of the strip
  const int j0 = col0 + nl, j1 = j0 + 8;
  const bool wvec = k % 4 == 0 && reinterpret_cast<uintptr_t>(W) % 16 == 0;
  A += (size_t)b * m * n;
  W += (size_t)b * m * k;
  H += (size_t)b * k * n;
  // VEC: the warp's 16 columns of A's chunk, [CR][ALD bytes]
  unsigned char* As = reinterpret_cast<unsigned char*>(smem + G::FLOATS) + warp * CR * ALD;

  // rows [rr, rr + CR) x the warp's 16 columns of A into As, zeros past re
  // and n (n % 4 == 0: a chunk of four lies whole inside n or past it)
  auto stage_a = [&](int rr) {
#pragma unroll
    for (int q = 0; q < CR * 4 / 32; ++q) {
      const int e = lane + 32 * q, r = e / 4, jj = 4 * (e % 4);
      const int row = rr + r, col = col0 + 16 * warp + jj;
      const bool ok = row < re && col < n;
      tc::cp_async_n<4 * sizeof(T)>(tc::smem_u32(As + r * ALD + jj * sizeof(T)),
                                    ok ? A + (size_t)row * n + col : A, ok);
    }
  };

  // H's strip for factors [cb, cb + KP), zeros past k and n, by cp.async
  auto stage_h = [&](int c) {
    const int cb = c * KP, kc = min(KP, k - cb);
    if (VEC) {
      for (int e = threadIdx.x; e < KP * SW / 4; e += NT) {
        const int cc = e / (SW / 4), jj = 4 * (e % (SW / 4));
        const bool ok = cc < kc && col0 + jj < n;
        tc::cp_async16(tc::smem_u32(Hs + cc * LDS + jj),
                       ok ? H + (size_t)(cb + cc) * n + col0 + jj : H, ok);
      }
    } else {
      for (int e = threadIdx.x; e < KP * SW; e += NT) {
        const int cc = e / SW, jj = e % SW;
        const bool ok = cc < kc && col0 + jj < n;
        cp_async4(Hs + cc * LDS + jj, ok ? H + (size_t)(cb + cc) * n + col0 + jj : H, ok);
      }
    }
  };

  float acc[NI][2][4];
#pragma unroll
  for (int i = 0; i < NI; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) acc[i][h][0] = acc[i][h][1] = acc[i][h][2] = acc[i][h][3] = 0.f;
  const int nrc = (re - rb + CR - 1) / CR;
  if (nch == 1) {
    stage_h(0);
    stage_rows<KP, CR>(Ws, LDW, W + (size_t)rb * k, re - rb, k, 0, wvec);
  }
  if (VEC) stage_a(rb);
  cp_async_commit();
  for (int rc = 0; rc < nrc; ++rc) {
    const int rr = rb + rc * CR;
    if (VEC || nch == 1) {
      cp_async_wait_all();
      __syncthreads();        // chunk rc landed; chunk rc - 1 is read by all
    }
    // the thread's A of the chunk in S^T's accumulator layout: step st holds
    // (row 2t, j0), (row 2t + 1, j0), (row 2t, j1), (row 2t + 1, j1) of its 8
    // rows; VEC from the warp's buffer, which then takes the next chunk,
    // else straight from device memory
    float a[4][4];
#pragma unroll
    for (int st = 0; st < 4; ++st) {
      if (VEC) {
        const unsigned char* p = As + (8 * st + 2 * t) * ALD + g * sizeof(T);
        a[st][0] = smem1<T>(p);
        a[st][1] = smem1<T>(p + ALD);
        a[st][2] = smem1<T>(p + 8 * sizeof(T));
        a[st][3] = smem1<T>(p + ALD + 8 * sizeof(T));
      } else {
        const int r = rr + 8 * st + 2 * t;
        const T* p = A + (size_t)r * n;
        const bool ok0 = r < re, ok1 = r + 1 < re;
        a[st][0] = ok0 && j0 < n ? load1(p + j0) : 0.f;
        a[st][1] = ok1 && j0 < n ? load1(p + n + j0) : 0.f;
        a[st][2] = ok0 && j1 < n ? load1(p + j1) : 0.f;
        a[st][3] = ok1 && j1 < n ? load1(p + n + j1) : 0.f;
      }
    }
    if (VEC) {
      __syncwarp();           // every lane has read the warp's buffer
      if (rc + 1 < nrc) stage_a(rr + CR);
    }
    if (nch == 1 && rc + 1 < nrc)
      stage_rows<KP, CR>(Ws + ((rc + 1) & 1) * CR * LDW, LDW, W + (size_t)(rr + CR) * k,
                         re - rr - CR, k, 0, wvec);
    cp_async_commit();
    float s[4][4];
#pragma unroll
    for (int st = 0; st < 4; ++st) s[st][0] = s[st][1] = s[st][2] = s[st][3] = 0.f;
    const float* Wc;
    if (nch == 1) {
      Wc = Ws + (rc & 1) * CR * LDW;
      wtu_s<LDW>(s, Hs, Wc, nl, g, t, (k + 7) / 8);
    } else {
      for (int q = 0; q < nch; ++q) {
        const int c = (slab + 1 + q) % nch;
        __syncthreads();      // the last chunk is read by all
        stage_h(c);
        stage_rows<KP, CR>(Ws, LDW, W + (size_t)rr * k, re - rr, k, c * KP, wvec);
        cp_async_commit();
        cp_async_wait_all();
        __syncthreads();
        wtu_s<LDW>(s, Hs, Ws, nl, g, t, (min(KP, k - c * KP) + 7) / 8);
      }
      Wc = Ws;                // the slab's chunk: W's factors c0 .. c0 + KP
    }
    // U^T = A / (S^T + eps), split: under the permuted reduction index
    // (position t is row 2t, t + 4 row 2t + 1), step st's B operand of W^T U
    // for the columns j0 (ub[st][0]) and j1 (ub[st][1])
    uint32_t ubh[4][2][2], ubl[4][2][2];
#pragma unroll
    for (int st = 0; st < 4; ++st) {
      tc::split_tf32(ratio0(a[st][0], s[st][0] + eps), ubh[st][0][0], ubl[st][0][0]);
      tc::split_tf32(ratio0(a[st][1], s[st][1] + eps), ubh[st][0][1], ubl[st][0][1]);
      tc::split_tf32(ratio0(a[st][2], s[st][2] + eps), ubh[st][1][0], ubl[st][1][0]);
      tc::split_tf32(ratio0(a[st][3], s[st][3] + eps), ubh[st][1][1], ubl[st][1][1]);
    }
    // acc[i][h] += W^T U, by groups of IG m16 tiles: the chunk's 12 mma of
    // each from zero, then one f32 add. a0 = W[2t][c0 + 16i + g], a1 =
    // W[2t][.. + g + 8], a2 = W[2t + 1][.. + g], a3 = W[2t + 1][.. + g + 8]
    // of the step's rows
#pragma unroll
    for (int ig = 0; ig < NI / IG; ++ig) {
      if (ig < ngr) {
        float p[IG][2][4];
#pragma unroll
        for (int ii = 0; ii < IG; ++ii)
#pragma unroll
          for (int h = 0; h < 2; ++h) p[ii][h][0] = p[ii][h][1] = p[ii][h][2] = p[ii][h][3] = 0.f;
#pragma unroll
        for (int st = 0; st < 4; ++st) {
          const float* w0 = Wc + (8 * st + 2 * t) * LDW + g;
          uint32_t ah[IG][4], al[IG][4];
#pragma unroll
          for (int ii = 0; ii < IG; ++ii) {
            const int c = 16 * (IG * ig + ii);
            tc::split_tf32(w0[c], ah[ii][0], al[ii][0]);
            tc::split_tf32(w0[c + 8], ah[ii][1], al[ii][1]);
            tc::split_tf32(w0[LDW + c], ah[ii][2], al[ii][2]);
            tc::split_tf32(w0[LDW + c + 8], ah[ii][3], al[ii][3]);
          }
#pragma unroll
          for (int ii = 0; ii < IG; ++ii)
#pragma unroll
            for (int h = 0; h < 2; ++h)
              tc::mma_tf32(p[ii][h], al[ii], ubh[st][h][0], ubh[st][h][1]);
#pragma unroll
          for (int ii = 0; ii < IG; ++ii)
#pragma unroll
            for (int h = 0; h < 2; ++h)
              tc::mma_tf32(p[ii][h], ah[ii], ubl[st][h][0], ubl[st][h][1]);
#pragma unroll
          for (int ii = 0; ii < IG; ++ii)
#pragma unroll
            for (int h = 0; h < 2; ++h)
              tc::mma_tf32(p[ii][h], ah[ii], ubh[st][h][0], ubh[st][h][1]);
        }
#pragma unroll
        for (int ii = 0; ii < IG; ++ii)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[IG * ig + ii][h][e] += p[ii][h][e];
      }
    }
  }

  // acc[i][h]: c0, c1 = WTU[c0 + 16i + g][j + 2t, + 1], c2, c3 the same at
  // factor + 8, for the columns j = col0 + 16 warp + 8h
  float* dst = out + ((size_t)split * gridDim.y + b) * k * n;
#pragma unroll
  for (int i = 0; i < NI; ++i) {
    if (i < IG * ngr) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = col0 + 16 * warp + 8 * h + 2 * t;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int c = c0 + 16 * i + g + 8 * half;
          if (c >= k || j >= n) continue;
          float* q = dst + (size_t)c * n + j;
          if (VEC) {
            *reinterpret_cast<float2*>(q) = make_float2(acc[i][h][2 * half], acc[i][h][2 * half + 1]);
          } else {
            q[0] = acc[i][h][2 * half];
            if (j + 1 < n) q[1] = acc[i][h][2 * half + 1];
          }
        }
      }
    }
  }
}

}  // namespace tf

template <typename T, int KP, bool VEC>
cudaError_t launch_uht_tc(const T* A, const float* W, const float* H, float eps,
                          int B, int m, int n, int k, float* out, cudaStream_t stream) {
  constexpr size_t smem = tf::UhtTc<KP, T, VEC>::smem();
  const auto kernel = &tf::kl_uht_tc_kernel<T, KP, VEC>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((m + tf::TM - 1) / tf::TM, B, (k + KP - 1) / KP);
  kernel<<<grid, NT, smem, stream>>>(A, W, H, eps, m, n, k, out);
  return cudaGetLastError();
}

template <typename T, int KP, bool VEC>
cudaError_t launch_wtu_tc(const T* A, const float* W, const float* H, float eps,
                          int B, int m, int n, int k, int rows_per_split,
                          float* scratch, float* out, cudaStream_t stream) {
  constexpr size_t smem = tf::WtuTc<KP, T, VEC>::smem();
  const int S = (m + rows_per_split - 1) / rows_per_split;
  const int slabs = (k + KP - 1) / KP;
  if (S > 1 && scratch == nullptr) return cudaErrorInvalidValue;
  if ((size_t)S * slabs > 65535) return cudaErrorInvalidValue;
  const auto kernel = &tf::kl_wtu_tc_kernel<T, KP, VEC>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + tf::SW - 1) / tf::SW, B, S * slabs);
  kernel<<<grid, NT, smem, stream>>>(A, W, H, eps, m, n, k, rows_per_split,
                                     S > 1 ? scratch : out);
  err = cudaGetLastError();
  if (err != cudaSuccess || S == 1) return err;
  const size_t len = (size_t)B * k * n;
  const int blocks = (int)((len + NT - 1) / NT < 4096 ? (len + NT - 1) / NT : 4096);
  kl_wtu_reduce_kernel<<<blocks, NT, 0, stream>>>(scratch, S, len, out);
  return cudaGetLastError();
}

// ---- dispatch ---------------------------------------------------------------

template <typename T, int KP, bool VEC>
cudaError_t launch_uht(const T* A, const float* W, const float* H, float eps,
                       int B, int m, int n, int k, float* out, cudaStream_t stream) {
  using Gm = UhtGeom<KP>;
  constexpr size_t smem = Gm::smem();
  const auto kernel = &kl_uht_reg_kernel<T, KP, VEC>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((m + Gm::TMR - 1) / Gm::TMR, B);
  kernel<<<grid, NT, smem, stream>>>(A, W, H, eps, m, n, k, out);
  return cudaGetLastError();
}

template <typename T, int KP, bool VEC>
cudaError_t launch_wtu(const T* A, const float* W, const float* H, float eps,
                       int B, int m, int n, int k, int rows_per_split,
                       float* scratch, float* out, cudaStream_t stream) {
  using Gm = WtuGeom<KP>;
  constexpr size_t smem = Gm::smem();
  const int S = (m + rows_per_split - 1) / rows_per_split;
  if (S > 1 && scratch == nullptr) return cudaErrorInvalidValue;
  const auto kernel = &kl_wtu_reg_kernel<T, KP, VEC>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + Gm::SW - 1) / Gm::SW, B, S);
  kernel<<<grid, NT, smem, stream>>>(A, W, H, eps, m, n, k, rows_per_split,
                                     S > 1 ? scratch : out);
  err = cudaGetLastError();
  if (err != cudaSuccess || S == 1) return err;
  const size_t len = (size_t)B * k * n;
  const int blocks = (int)((len + NT - 1) / NT < 4096 ? (len + NT - 1) / NT : 4096);
  kl_wtu_reduce_kernel<<<blocks, NT, 0, stream>>>(scratch, S, len, out);
  return cudaGetLastError();
}

template <typename T, int KP>
cudaError_t launch(bool uht, const void* A, const void* W, const void* H,
                   float eps, int B, int m, int n, int k, int rows_per_split,
                   void* scratch, void* out, cudaStream_t s) {
  const T* a = static_cast<const T*>(A);
  const float* w = static_cast<const float*>(W);
  const float* h = static_cast<const float*>(H);
  float* o = static_cast<float*>(out);
  float* sc = static_cast<float*>(scratch);
  const bool vec = n % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(A) % (4 * sizeof(T)) == 0 &&
                   reinterpret_cast<uintptr_t>(H) % 16 == 0;
  if (!uht && rows_per_split < 1) return cudaErrorInvalidValue;
  if constexpr (KP > 32) {
    if (uht)
      return vec ? launch_uht_tc<T, KP, true>(a, w, h, eps, B, m, n, k, o, s)
                 : launch_uht_tc<T, KP, false>(a, w, h, eps, B, m, n, k, o, s);
    return vec ? launch_wtu_tc<T, KP, true>(a, w, h, eps, B, m, n, k,
                                            rows_per_split, sc, o, s)
               : launch_wtu_tc<T, KP, false>(a, w, h, eps, B, m, n, k,
                                             rows_per_split, sc, o, s);
  } else {
    if (uht)
      return vec ? launch_uht<T, KP, true>(a, w, h, eps, B, m, n, k, o, s)
                 : launch_uht<T, KP, false>(a, w, h, eps, B, m, n, k, o, s);
    return vec ? launch_wtu<T, KP, true>(a, w, h, eps, B, m, n, k,
                                         rows_per_split, sc, o, s)
               : launch_wtu<T, KP, false>(a, w, h, eps, B, m, n, k,
                                          rows_per_split, sc, o, s);
  }
}

// f(std::integral_constant<int, KP>{}) for k's padded width KP = 8, 16, 32,
// 64, 128, 256 (k > 256: slabs of 256): the one place that maps k to an
// instantiation
template <typename F>
cudaError_t with_kp(int k, F&& f) {
  if (k < 1) return cudaErrorInvalidValue;
  if (k <= 8) return f(std::integral_constant<int, 8>{});
  if (k <= 16) return f(std::integral_constant<int, 16>{});
  if (k <= 32) return f(std::integral_constant<int, 32>{});
  if (k <= 64) return f(std::integral_constant<int, 64>{});
  if (k <= 128) return f(std::integral_constant<int, 128>{});
  return f(std::integral_constant<int, 256>{});
}

template <typename T>
cudaError_t dispatch(bool uht, const void* A, const void* W, const void* H,
                     float eps, int B, int m, int n, int k, int rows_per_split,
                     void* scratch, void* out, cudaStream_t s) {
  if (B < 1 || m < 1 || n < 1) return cudaErrorInvalidValue;
  return with_kp(k, [&](auto kp) {
    return launch<T, decltype(kp)::value>(uht, A, W, H, eps, B, m, n, k,
                                          rows_per_split, scratch, out, s);
  });
}

}  // namespace

// Plain C interface, bound with ctypes. A is (B, m, n) in f32, bf16, f16 or
// uint8;
// W is (B, m, k) and H is (B, k, n) in f32, all contiguous. out is (B, m, k)
// for UHT and (B, k, n) for WTU, f32; every element is written; any k >= 1.
// WTU takes its row split: rows_per_split rows of each member per block (S =
// ceil(m / rows_per_split) splits), and, when S > 1, an f32 scratch of S * B
// * k * n elements. Returns the CUDA error code of the launch (0 on
// success).
#define KL_UHT(SUFFIX, T)                                                          \
  extern "C" int kl_uht_##SUFFIX(const void* A, const void* W, const void* H,     \
                                 float eps, int B, int m, int n, int k, void* out, \
                                 void* stream) {                                   \
    return (int)dispatch<T>(true, A, W, H, eps, B, m, n, k, 1, nullptr, out,       \
                            static_cast<cudaStream_t>(stream));                    \
  }
#define KL_WTU(SUFFIX, T)                                                          \
  extern "C" int kl_wtu_##SUFFIX(const void* A, const void* W, const void* H,     \
                                 float eps, int B, int m, int n, int k,            \
                                 int rows_per_split, void* scratch, void* out,     \
                                 void* stream) {                                   \
    return (int)dispatch<T>(false, A, W, H, eps, B, m, n, k, rows_per_split,       \
                            scratch, out, static_cast<cudaStream_t>(stream));      \
  }
KL_UHT(f32, float)
KL_UHT(bf16, __nv_bfloat16)
KL_UHT(f16, __half)
KL_UHT(u8, uint8_t)
KL_WTU(f32, float)
KL_WTU(bf16, __nv_bfloat16)
KL_WTU(f16, __half)
KL_WTU(u8, uint8_t)

// K2b's geometry at factor width k, for the wrapper's row split
// (ops/kl.py::wtu_split_plan): *strip columns per block and *chunk rows of W
// staged at a time (kl_wtu_reg_kernel at k <= 32, kl_wtu_tc_kernel above).
// Returns 0, or the error code of an invalid value for k < 1.
extern "C" int kl_wtu_geometry(int k, int* strip, int* chunk) {
  return (int)with_kp(k, [&](auto kp) {
    constexpr int KP = decltype(kp)::value;
    if constexpr (KP > 32) {
      *strip = tf::SW;
      *chunk = tf::CR;
    } else {
      *strip = WtuGeom<KP>::SW;
      *chunk = WtuGeom<KP>::CR;
    }
    return cudaSuccess;
  });
}

extern "C" const char* kl_ratio_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
