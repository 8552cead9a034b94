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
// KP = 64, 128 and 256 keep the kernels of the first port (kl_uht_kernel,
// kl_wtu_kernel in namespace legacy below): one block of 256 threads per
// 64 x 64 tile, A and U staged in shared memory, factors from shared
// memory. They are unchanged but for kl_uht_kernel's product loop,
// unrolled twice instead of four times, which removed a spill at KP = 128.
// No main path runs them.
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

namespace legacy {


constexpr int TM = 64;        // rows per tile
constexpr int TN = 64;        // columns per tile
constexpr int NT = 256;       // threads per block (8 warps)
constexpr int LDA = TN + 1;   // padded row stride of the A / U tile

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f32(uint8_t x) { return static_cast<float>(x); }

template <typename T>
__device__ __forceinline__ void load_a_tile(float* As, const T* __restrict__ A,
                                            int n, int rows, int cols) {
  for (int e = threadIdx.x; e < TM * TN; e += NT) {
    const int r = e / TN, j = e % TN;
    As[r * LDA + j] = (r < rows && j < cols) ? to_f32(A[(size_t)r * n + j]) : 0.f;
  }
}

// Ws [TM][KP+1] <- W rows [0, rows), columns [0, k); zeros elsewhere.
template <int KP>
__device__ __forceinline__ void load_w_tile(float* Ws, const float* __restrict__ W,
                                            int k, int rows) {
  for (int e = threadIdx.x; e < TM * KP; e += NT) {
    const int r = e / KP, c = e % KP;
    Ws[r * (KP + 1) + c] = (r < rows && c < k) ? W[(size_t)r * k + c] : 0.f;
  }
}

// Hs [KP][TN] <- H rows [0, k), columns [0, cols); zeros elsewhere.
template <int KP>
__device__ __forceinline__ void load_h_tile(float* Hs, const float* __restrict__ H,
                                            int n, int k, int cols) {
  for (int e = threadIdx.x; e < KP * TN; e += NT) {
    const int c = e / TN, j = e % TN;
    Hs[e] = (c < k && j < cols) ? H[(size_t)c * n + j] : 0.f;
  }
}

// As <- As / (Ws Hs + eps) for the whole tile. Thread: rows warp + 8 i,
// columns {lane, lane + 32}.
template <int KP>
__device__ __forceinline__ void ratio_tile(float* As, const float* Hs,
                                           const float* Ws, float eps) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float wh[8][2];
#pragma unroll
  for (int i = 0; i < 8; ++i) wh[i][0] = wh[i][1] = 0.f;
#pragma unroll 4
  for (int c = 0; c < KP; ++c) {
    const float h0 = Hs[c * TN + lane], h1 = Hs[c * TN + lane + 32];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float w = Ws[(warp + 8 * i) * (KP + 1) + c];
      wh[i][0] += w * h0;
      wh[i][1] += w * h1;
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = warp + 8 * i;
    As[r * LDA + lane] = As[r * LDA + lane] / (wh[i][0] + eps);
    As[r * LDA + lane + 32] = As[r * LDA + lane + 32] / (wh[i][1] + eps);
  }
}

template <int KP>
constexpr size_t smem_bytes() {
  return sizeof(float) * (TM * LDA + KP * TN + TM * (KP + 1));
}

template <typename T, int KP>
__global__ void __launch_bounds__(NT)
kl_uht_kernel(const T* __restrict__ A, const float* __restrict__ W,
              const float* __restrict__ H, float eps, int m, int n, int k,
              float* __restrict__ out) {
  constexpr int CT = KP / 8;    // factor columns per thread: c = warp + 8 q
  extern __shared__ float smem[];
  float* As = smem;
  float* Hs = As + TM * LDA;
  float* Ws = Hs + KP * TN;

  const int b = blockIdx.y;
  const int row0 = blockIdx.x * TM;
  const int rows = min(TM, m - row0);
  A += (size_t)b * m * n + (size_t)row0 * n;
  W += ((size_t)b * m + row0) * k;
  H += (size_t)b * k * n;
  out += ((size_t)b * m + row0) * k;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  load_w_tile<KP>(Ws, W, k, rows);
  float acc[2][CT];
#pragma unroll
  for (int q = 0; q < CT; ++q) acc[0][q] = acc[1][q] = 0.f;
  for (int j0 = 0; j0 < n; j0 += TN) {
    const int cols = min(TN, n - j0);
    load_a_tile(As, A + j0, n, rows, cols);
    load_h_tile<KP>(Hs, H + j0, n, k, cols);
    __syncthreads();
    ratio_tile<KP>(As, Hs, Ws, eps);
    __syncthreads();
    // acc[r][c] += sum_j U[r][j] H[c][j], rows {lane, lane + 32}
#pragma unroll 2
    for (int j = 0; j < TN; ++j) {
      const float u0 = As[lane * LDA + j], u1 = As[(lane + 32) * LDA + j];
#pragma unroll
      for (int q = 0; q < CT; ++q) {
        const float h = Hs[(warp + 8 * q) * TN + j];
        acc[0][q] += u0 * h;
        acc[1][q] += u1 * h;
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = lane + 32 * i;
#pragma unroll
    for (int q = 0; q < CT; ++q) {
      const int c = warp + 8 * q;
      if (r < rows && c < k) out[(size_t)r * k + c] = acc[i][q];
    }
  }
}

template <typename T, int KP>
__global__ void __launch_bounds__(NT)
kl_wtu_kernel(const T* __restrict__ A, const float* __restrict__ W,
              const float* __restrict__ H, float eps, int m, int n, int k,
              float* __restrict__ out) {
  constexpr int CT = KP / 8;
  extern __shared__ float smem[];
  float* As = smem;
  float* Hs = As + TM * LDA;
  float* Ws = Hs + KP * TN;

  const int b = blockIdx.y;
  const int col0 = blockIdx.x * TN;
  const int cols = min(TN, n - col0);
  A += (size_t)b * m * n + col0;
  W += (size_t)b * m * k;
  H += (size_t)b * k * n + col0;
  out += (size_t)b * k * n + col0;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  load_h_tile<KP>(Hs, H, n, k, cols);
  float acc[CT][2];
#pragma unroll
  for (int q = 0; q < CT; ++q) acc[q][0] = acc[q][1] = 0.f;
  for (int r0 = 0; r0 < m; r0 += TM) {
    const int rows = min(TM, m - r0);
    load_a_tile(As, A + (size_t)r0 * n, n, rows, cols);
    load_w_tile<KP>(Ws, W + (size_t)r0 * k, k, rows);
    __syncthreads();
    ratio_tile<KP>(As, Hs, Ws, eps);
    __syncthreads();
    // acc[c][j] += sum_r W[r][c] U[r][j], columns {lane, lane + 32}
#pragma unroll 4
    for (int r = 0; r < TM; ++r) {
      const float u0 = As[r * LDA + lane], u1 = As[r * LDA + lane + 32];
#pragma unroll
      for (int q = 0; q < CT; ++q) {
        const float w = Ws[r * (KP + 1) + warp + 8 * q];
        acc[q][0] += w * u0;
        acc[q][1] += w * u1;
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int q = 0; q < CT; ++q) {
    const int c = warp + 8 * q;
    if (c < k) {
      if (lane < cols) out[(size_t)c * n + lane] = acc[q][0];
      if (lane + 32 < cols) out[(size_t)c * n + lane + 32] = acc[q][1];
    }
  }
}


}  // namespace legacy

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

// ---- dispatch ---------------------------------------------------------------

template <typename T, int KP>
cudaError_t launch_legacy(bool uht, const void* A, const void* W, const void* H,
                          float eps, int B, int m, int n, int k, void* out,
                          cudaStream_t stream) {
  constexpr size_t smem = legacy::smem_bytes<KP>();
  using Kernel = void (*)(const T*, const float*, const float*, float, int,
                          int, int, float*);
  const Kernel kernel = uht ? &legacy::kl_uht_kernel<T, KP>
                            : &legacy::kl_wtu_kernel<T, KP>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(uht ? (m + legacy::TM - 1) / legacy::TM
                      : (n + legacy::TN - 1) / legacy::TN, B);
  kernel<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(A), static_cast<const float*>(W),
      static_cast<const float*>(H), eps, m, n, k, static_cast<float*>(out));
  return cudaGetLastError();
}

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
  if constexpr (KP > 32) {
    return launch_legacy<T, KP>(uht, A, W, H, eps, B, m, n, k, out, s);
  } else {
    const T* a = static_cast<const T*>(A);
    const float* w = static_cast<const float*>(W);
    const float* h = static_cast<const float*>(H);
    float* o = static_cast<float*>(out);
    float* sc = static_cast<float*>(scratch);
    const bool vec = n % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(A) % (4 * sizeof(T)) == 0 &&
                     reinterpret_cast<uintptr_t>(H) % 16 == 0;
    if (uht)
      return vec ? launch_uht<T, KP, true>(a, w, h, eps, B, m, n, k, o, s)
                 : launch_uht<T, KP, false>(a, w, h, eps, B, m, n, k, o, s);
    if (rows_per_split < 1) return cudaErrorInvalidValue;
    return vec ? launch_wtu<T, KP, true>(a, w, h, eps, B, m, n, k,
                                         rows_per_split, sc, o, s)
               : launch_wtu<T, KP, false>(a, w, h, eps, B, m, n, k,
                                          rows_per_split, sc, o, s);
  }
}

// f(std::integral_constant<int, KP>{}) for k's padded width KP = 8, 16, 32,
// 64, 128, 256: the one place that maps k to an instantiation
template <typename F>
cudaError_t with_kp(int k, F&& f) {
  if (k < 1) return cudaErrorInvalidValue;
  if (k <= 8) return f(std::integral_constant<int, 8>{});
  if (k <= 16) return f(std::integral_constant<int, 16>{});
  if (k <= 32) return f(std::integral_constant<int, 32>{});
  if (k <= 64) return f(std::integral_constant<int, 64>{});
  if (k <= 128) return f(std::integral_constant<int, 128>{});
  if (k <= 256) return f(std::integral_constant<int, 256>{});
  return cudaErrorInvalidValue;
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
// for UHT and (B, k, n) for WTU, f32; every element is written. WTU takes
// its row split: rows_per_split rows of each member per block (S = ceil(m /
// rows_per_split) splits; k > 32 ignores it), and, when S > 1, an f32
// scratch of S * B * k * n elements. Returns the CUDA error code of the
// launch (0 on success).
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
// staged at a time by kl_wtu_reg_kernel; *strip = *chunk = 0 where k > 32
// (the first port's kernel, which takes no split). Returns 0, or the error
// code of an invalid value for k outside [1, 256].
extern "C" int kl_wtu_geometry(int k, int* strip, int* chunk) {
  return (int)with_kp(k, [&](auto kp) {
    constexpr int KP = decltype(kp)::value;
    if constexpr (KP > 32) {
      *strip = *chunk = 0;
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
