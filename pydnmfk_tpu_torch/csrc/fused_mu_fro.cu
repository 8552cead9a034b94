// K1: one Frobenius-MU W pass with one read of each row panel of A.
//
// Replaces pydnmfk_tpu/ops/fused_mu.py::_fused_kernel (launched by
// _fused_w_pass). For each row panel A_i of each member b:
//
//     AHT_i  = A_i H^T                          (panel rows x k)
//     W'_i   = W_i * AHT_i / (W_i HHT + eps)     written to W_out
//     WTA   += W'_i^T A_i                        (k x n, f32 atomics)
//     WTW   += W'_i^T W'_i                       (k x k, f32 atomics)
//
// The H update (H * WTA / (WTW H + eps)) and HHT = H H^T are small and stay
// in PyTorch, as the TPU version leaves them to XLA.
//
// Design on Hopper, as the bf16 and uint8 instantiations keep it (the f32
// one, fused_mu_fro_f32_kernel below, is redesigned for the CUDA cores). One
// block of 256 threads owns a panel of TM = 64 rows of one member (grid =
// row panels x members). W'_i needs A_i H^T over all of
// n before any of W'_i^T A_i can be formed, so the block sweeps its panel
// twice: sweep 1 accumulates AHT_i in registers over column tiles of TN = 64,
// sweep 2 re-reads the panel and adds W'_i^T A_i into WTA. The TPU kernel
// carries WTA from one grid step to the next; Hopper runs blocks in parallel,
// so that carry becomes f32 atomicAdd (order varies from run to run; the
// sums agree with the plain version to f32 rounding). A is never padded: the
// ragged edges of m and n are masked with zeros as tiles are loaded.
//
// What bounds it: at k = 32 each A element costs 4k = 128 flops against 4
// bytes (f32) read twice, which is above the card's f32 CUDA-core balance,
// so this simple version is bound by shared-memory operand traffic into
// CUDA-core FMAs (about 6 shared loads per 8 FMAs per thread). A bf16 A
// halves the bytes. Tensor cores (wgmma), TMA pipelines and tuning are later
// work.
//
// bf16 or uint8 A: the products take bf16 operands with f32 accumulation,
// exactly as the plain path does (ops/linalg.py::matmul rounds the f32
// factor to bf16; a uint8 value is exact in bf16): H is rounded as it is
// loaded for sweep 1, W' is rounded for sweep 2, and WTW uses the unrounded
// f32 W'. This is the JAX package's rule for an integer A too
// (pydnmfk_tpu/ops/fused_mu.py:53-60, :166-172), whose uint8 variant is
// tools/fused_u8_probe.py::make_kernel.
//
// uint8 A: each element is one byte load, widened exactly to f32 (no
// alignment needed, so any n works). A quarter of the f32 bytes, but the
// same shared-memory operand traffic, so at k = 32 it is bound where the
// f32 and bf16 instantiations are; vector loads are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int TM = 64;        // rows of A per block
constexpr int TN = 64;        // columns of A per tile
constexpr int NT = 256;       // threads per block (8 warps)
constexpr int LDA = TN + 1;   // padded row stride of the A tile in shared memory

__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(uint8_t x) { return static_cast<float>(x); }

// A factor value as an operand of a product with A: unchanged for an f32 A,
// rounded to bf16 for a bf16 or uint8 A.
template <typename T>
__device__ __forceinline__ float operand(float x) {
  if constexpr (!std::is_same<T, float>::value) {
    return __bfloat162float(__float2bfloat16(x));
  } else {
    return x;
  }
}

template <typename T>
__device__ __forceinline__ void load_a_tile(float* As, const T* __restrict__ A,
                                            int n, int rows, int j0, int cols) {
  for (int e = threadIdx.x; e < TM * TN; e += NT) {
    const int r = e / TN, j = e % TN;
    As[r * LDA + j] = (r < rows && j < cols) ? to_f32(A[(size_t)r * n + j0 + j]) : 0.f;
  }
}

template <typename T, int KP>
__global__ void __launch_bounds__(NT)
fused_mu_fro_kernel(const T* __restrict__ A, const float* __restrict__ W,
                    const float* __restrict__ H, const float* __restrict__ HHT,
                    float eps, int m, int n, int k, float* __restrict__ W_out,
                    float* __restrict__ WTA, float* __restrict__ WTW) {
  constexpr int LDW = KP + 1;   // padded row stride of the W panel
  constexpr int CT = KP / 8;    // factor columns per thread: c = warp + 8 q
  extern __shared__ float smem[];
  float* As = smem;             // [TM][LDA]  A tile
  float* Hs = As + TM * LDA;    // [KP][TN]   H tile; later HHT [KP][KP]
  float* Ws = Hs + KP * TN;     // [TM][LDW]  W panel; later W'

  const int b = blockIdx.y;
  const int row0 = blockIdx.x * TM;
  const int rows = min(TM, m - row0);
  A += (size_t)b * m * n + (size_t)row0 * n;
  W += ((size_t)b * m + row0) * k;
  W_out += ((size_t)b * m + row0) * k;
  H += (size_t)b * k * n;
  HHT += (size_t)b * k * k;
  WTA += (size_t)b * k * n;
  WTW += (size_t)b * k * k;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // Sweep 1: AHT for rows {lane, lane + 32} and columns warp + 8 q.
  float acc[2][CT];
#pragma unroll
  for (int q = 0; q < CT; ++q) acc[0][q] = acc[1][q] = 0.f;
  for (int j0 = 0; j0 < n; j0 += TN) {
    const int cols = min(TN, n - j0);
    load_a_tile(As, A, n, rows, j0, cols);
    for (int e = tid; e < KP * TN; e += NT) {
      const int c = e / TN, j = e % TN;
      Hs[e] = (c < k && j < cols) ? operand<T>(H[(size_t)c * n + j0 + j]) : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < TN; ++j) {
      const float a0 = As[lane * LDA + j], a1 = As[(lane + 32) * LDA + j];
#pragma unroll
      for (int q = 0; q < CT; ++q) {
        const float h = Hs[(warp + 8 * q) * TN + j];
        acc[0][q] += a0 * h;
        acc[1][q] += a1 * h;
      }
    }
    __syncthreads();
  }

  // W'_i = W_i * AHT_i / (W_i HHT + eps). Rows past m and columns past k
  // load as zeros, so their W' is exactly zero.
  for (int e = tid; e < TM * KP; e += NT) {
    const int r = e / KP, c = e % KP;
    Ws[r * LDW + c] = (r < rows && c < k) ? W[(size_t)r * k + c] : 0.f;
  }
  for (int e = tid; e < KP * KP; e += NT) {
    const int c = e / KP, d = e % KP;
    Hs[e] = (c < k && d < k) ? HHT[c * k + d] : 0.f;
  }
  __syncthreads();
  float wn[2][CT];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = lane + 32 * i;
#pragma unroll
    for (int q = 0; q < CT; ++q) {
      const int c = warp + 8 * q;
      float den = 0.f;
#pragma unroll 8
      for (int d = 0; d < KP; ++d) den += Ws[r * LDW + d] * Hs[d * KP + c];
      wn[i][q] = Ws[r * LDW + c] * acc[i][q] / (den + eps);
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = lane + 32 * i;
#pragma unroll
    for (int q = 0; q < CT; ++q) {
      const int c = warp + 8 * q;
      Ws[r * LDW + c] = wn[i][q];
      if (r < rows && c < k) W_out[(size_t)r * k + c] = wn[i][q];
    }
  }
  __syncthreads();

  // WTW += W'^T W' over this panel, from the unrounded W'.
  for (int e = tid; e < KP * KP; e += NT) {
    const int c = e / KP, d = e % KP;
    if (c < k && d < k) {
      float s = 0.f;
      for (int r = 0; r < rows; ++r) s += Ws[r * LDW + c] * Ws[r * LDW + d];
      atomicAdd(&WTW[c * k + d], s);
    }
  }
  if constexpr (!std::is_same<T, float>::value) {
    __syncthreads();
    for (int e = tid; e < TM * KP; e += NT) {
      const int r = e / KP, c = e % KP;
      Ws[r * LDW + c] = operand<T>(Ws[r * LDW + c]);
    }
  }
  __syncthreads();

  // Sweep 2: WTA[c][j0 + j] += sum_r W'[r][c] A[r][j] for columns
  // j in {lane, lane + 32} and factor columns c = warp + 8 q.
  for (int j0 = 0; j0 < n; j0 += TN) {
    const int cols = min(TN, n - j0);
    load_a_tile(As, A, n, rows, j0, cols);
    __syncthreads();
    float p[CT][2];
#pragma unroll
    for (int q = 0; q < CT; ++q) p[q][0] = p[q][1] = 0.f;
#pragma unroll 4
    for (int r = 0; r < TM; ++r) {
      const float a0 = As[r * LDA + lane], a1 = As[r * LDA + lane + 32];
#pragma unroll
      for (int q = 0; q < CT; ++q) {
        const float w = Ws[r * LDW + warp + 8 * q];
        p[q][0] += w * a0;
        p[q][1] += w * a1;
      }
    }
#pragma unroll
    for (int q = 0; q < CT; ++q) {
      const int c = warp + 8 * q;
      if (c < k) {
        if (lane < cols) atomicAdd(&WTA[(size_t)c * n + j0 + lane], p[q][0]);
        if (lane + 32 < cols) atomicAdd(&WTA[(size_t)c * n + j0 + lane + 32], p[q][1]);
      }
    }
    __syncthreads();
  }
}

template <typename T, int KP>
cudaError_t launch(const void* A, const void* W, const void* H, const void* HHT,
                   float eps, int B, int m, int n, int k, void* W_out,
                   void* WTA, void* WTW, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (TM * LDA + KP * TN + TM * (KP + 1));
  const auto kernel = &fused_mu_fro_kernel<T, KP>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((m + TM - 1) / TM, B);
  kernel<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(A), static_cast<const float*>(W),
      static_cast<const float*>(H), static_cast<const float*>(HHT), eps, m, n, k,
      static_cast<float*>(W_out), static_cast<float*>(WTA),
      static_cast<float*>(WTW));
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* A, const void* W, const void* H,
                     const void* HHT, float eps, int B, int m, int n, int k,
                     void* W_out, void* WTA, void* WTW, cudaStream_t s) {
  if (B < 1 || m < 1 || n < 1 || k < 1) return cudaErrorInvalidValue;
  if (k <= 8) return launch<T, 8>(A, W, H, HHT, eps, B, m, n, k, W_out, WTA, WTW, s);
  if (k <= 16) return launch<T, 16>(A, W, H, HHT, eps, B, m, n, k, W_out, WTA, WTW, s);
  if (k <= 32) return launch<T, 32>(A, W, H, HHT, eps, B, m, n, k, W_out, WTA, WTW, s);
  if (k <= 64) return launch<T, 64>(A, W, H, HHT, eps, B, m, n, k, W_out, WTA, WTW, s);
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// The f32 instantiation: register micro-tiles, float4 operands, vector atomics.
//
// Same contract and the same two sweeps as fused_mu_fro_kernel, redesigned for
// the CUDA cores: a thread's 8 x 8 tile of outputs takes two float4 of each
// operand from shared memory per 64 FMAs (1 byte per FMA, what shared memory
// delivers to the 128 FP32 lanes of an SM per clock; a 4 x 8 tile needs 1.5,
// and k <= 16, bound by bytes, takes 4 x 8 and 8 x 4 tiles to save registers).
// - Sweep 1 (A_i H^T, TM x KP, a sum over n): a thread keeps RM rows x 8
//   factor columns in registers. The threads split each tile's TN1 columns
//   into G1 groups, whose partial sums are reduced once per panel through
//   shared memory. The A tile is stored transposed ([TN1][TM]): each thread
//   loads 4 rows x 4 columns (one float4 per row) and stores them as 4 float4
//   of 4 rows each, XOR-swizzled (row r of column j at r ^ sw(j)) so that
//   neither the stores nor the float4 reads conflict on banks.
// - Sweep 2 (W'^T A_i, KP x n): a thread keeps 8 factor columns x JT columns
//   of A and sums them over all TM rows of the panel, streamed in tiles of RC
//   rows x TN2 columns (row-major), so no partial sums are exchanged. When a
//   strip of TN2 columns is done, its sums go into WTA with 16-byte vector
//   atomics (red.global.add.v4.f32 on sm_90).
// - A is read with 16-byte loads when n % 4 == 0 and A, H and WTA are
//   16-byte aligned (VEC). The next tile's loads are spread over the current
//   tile's products (issued together they hold up the shared-memory loads
//   queued behind them) and land in the other of two shared-memory buffers:
//   one barrier per tile, no cp.async. At k <= 16 the tile after next is also
//   prefetched into L2. Otherwise (n % 4 != 0) each tile is copied element by
//   element after the products, and WTA takes scalar atomics.
// - Panels of TM = 128 rows (64 at KP = 64) halve the panel count of the
//   generic kernel, and so the atomics into WTA; 256 threads, at most 128
//   registers (two blocks per SM) and at most ~100 KB of shared memory.
// What bounds it: A is read twice (sweep 2 needs all of A_i H^T first, and a
// panel does not fit on chip), and 4 k FMAs per element of A run on the CUDA
// cores (true f32 has no tensor-core path): at k = 32 the two are about
// even, at k = 8 the bytes bound it.

namespace f32 {

constexpr int NT = 256;       // threads per block

constexpr int cmax(int a, int b) { return a > b ? a : b; }

template <int KP>
struct Cfg {
  static constexpr int TM = KP <= 32 ? 128 : 64;   // rows per panel
  // tiles ahead that A is prefetched into L2 (0: none). Where the bytes
  // bound the kernel (k <= 16) this hides more of the load latency than the
  // one tile staged in registers can; at k = 32 and 64 it costs registers
  // (spills) and time.
  static constexpr int PF = KP <= 16 ? 2 : 0;
  // sweep 1: RM rows x 8 factor columns a thread; tiles of TN1 columns
  static constexpr int RM = KP <= 16 ? 4 : 8;
  static constexpr int TN1 = 32;
  static constexpr int HW = cmax(KP, 32);           // row width of the H^T tile
  static constexpr int T1 = TM / RM * (KP / 8);     // threads per column group
  static constexpr int G1 = NT / T1;                // column groups
  static constexpr int JPG = TN1 / G1;              // columns per group and tile
  // sweep 2: 8 factor columns x JT columns a thread; tiles of RC x TN2
  static constexpr int JT = KP <= 16 ? 4 : 8;
  static constexpr int TN2 = NT * JT * 8 / KP;
  static constexpr int RC = 4096 / TN2;
  static constexpr int LD2 = TN2 + 4;               // row stride of its tile
  static constexpr int LDW = KP + 4;                // row stride of the W' panel
  static constexpr int NW = TM * KP / 4 / NT;       // float4s of W' per thread
  // shared memory, in floats: the tiles of either sweep (two buffers each)
  // or sweep 1's partial sums, then the W' panel and HHT
  static constexpr int A1 = TN1 * TM, H1 = TN1 * HW, A2 = RC * LD2;
  static constexpr int RED = G1 * TM * KP;
  static constexpr int X = cmax(cmax(2 * (A1 + H1), 2 * A2), RED);
  static constexpr size_t SMEM = sizeof(float) * (X + TM * LDW + KP * KP);
  static_assert(T1 % 32 == 0 && T1 * G1 == NT && TN1 % G1 == 0, "sweep 1");
  static_assert(TN2 / JT * (KP / 8) == NT && RC * TN2 == 4096 && TM % RC == 0,
                "sweep 2");
  static_assert(NW >= 1 && SMEM <= 100 * 1024, "sizes");
};

// A tile of R rows x TN columns is cut two ways:
// - slots of one float4, consecutive along the rows (a warp reads 512
//   contiguous bytes, or 256 bytes of 2 rows, or 128 bytes of 4 rows);
//   SLOTS per thread;
// - quads of 4 rows x 4 columns, a thread loading one float4 of each of the 4
//   rows (a warp again reads whole 128-byte lines); QUADS per thread, 4
//   float4s each.
template <int R, int TN>
constexpr int SLOTS = (R * TN / 4 + NT - 1) / NT;
template <int R, int TN>
constexpr int QUADS = (R * TN / 16 + NT - 1) / NT;

template <int TN>
__device__ __forceinline__ void slot_pos(int p, int& r, int& jl) {
  const int e = threadIdx.x + NT * p;
  r = e / (TN / 4);
  jl = 4 * (e % (TN / 4));
}

template <int TN>
__device__ __forceinline__ void quad_pos(int p, int& r, int& jl) {
  const int q = threadIdx.x + NT * p;
  r = 4 * (q / (TN / 4));
  jl = 4 * (q % (TN / 4));
}

// swizzle of the transposed tiles: flips bits 2-4 of the row index, so a
// float4 of 4 rows stays whole
__device__ __forceinline__ int sw(int j) { return ((j >> 2) & 7) << 2; }

__device__ __forceinline__ float4 fma4(float s, float4 a, float4 c) {
  return make_float4(fmaf(s, a.x, c.x), fmaf(s, a.y, c.y), fmaf(s, a.z, c.z),
                     fmaf(s, a.w, c.w));
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

__device__ __forceinline__ float comp(float4 v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// Columns jl .. jl + 3 of row r of the window rows [0, rows) x columns
// [j0, j0 + cols) of src (row stride ld, a multiple of 4); zero outside (no
// load at all when rows == 0).
__device__ __forceinline__ float4 load4(const float* __restrict__ src, int ld,
                                        int r, int jl, int rows, int j0, int cols) {
  if (r < rows && jl < cols)
    return __ldg(reinterpret_cast<const float4*>(src + (size_t)r * ld + j0 + jl));
  return make_float4(0.f, 0.f, 0.f, 0.f);
}

// Asks L2 for the 16 bytes of load4's window element (no register, no copy
// into shared memory: the later load4 then finds the line in L2).
__device__ __forceinline__ void prefetch4(const float* __restrict__ src, int ld,
                                          int r, int jl, int rows, int j0, int cols) {
  if (r < rows && jl < cols)
    asm volatile("prefetch.global.L2 [%0];" ::"l"(src + (size_t)r * ld + j0 + jl));
}

template <int TN>
__device__ __forceinline__ float4 load_slot(int p, const float* __restrict__ src,
                                            int ld, int rows, int j0, int cols) {
  int r, jl;
  slot_pos<TN>(p, r, jl);
  return load4(src, ld, r, jl, rows, j0, cols);
}

// float4 q of this thread's quads: row q % 4 of quad q / 4
template <int TN>
__device__ __forceinline__ float4 load_quad(int q, const float* __restrict__ src,
                                            int ld, int rows, int j0, int cols) {
  int r, jl;
  quad_pos<TN>(q >> 2, r, jl);
  return load4(src, ld, r + (q & 3), jl, rows, j0, cols);
}

// stores the slots row-major: element (r, j) at dst[r * LD + j]
template <int R, int TN, int LD>
__device__ __forceinline__ void store_r(float* dst, const float4 (&v)[SLOTS<R, TN>]) {
#pragma unroll
  for (int p = 0; p < SLOTS<R, TN>; ++p) {
    int r, jl;
    slot_pos<TN>(p, r, jl);
    if (r < R) *reinterpret_cast<float4*>(dst + r * LD + jl) = v[p];
  }
}

// stores the slots transposed and swizzled: element (r, j) at
// dst[j * RS + (r ^ sw(j))]
template <int R, int TN, int RS>
__device__ __forceinline__ void store_t(float* dst, const float4 (&v)[SLOTS<R, TN>]) {
#pragma unroll
  for (int p = 0; p < SLOTS<R, TN>; ++p) {
    int r, jl;
    slot_pos<TN>(p, r, jl);
    if (r < R) {
      float* d = dst + jl * RS + (r ^ sw(jl));
      d[0] = v[p].x;
      d[RS] = v[p].y;
      d[2 * RS] = v[p].z;
      d[3 * RS] = v[p].w;
    }
  }
}

// stores the quads transposed and swizzled, as store_t
template <int R, int TN, int RS>
__device__ __forceinline__ void store_q(float* dst, const float4 (&v)[4 * QUADS<R, TN>]) {
#pragma unroll
  for (int p = 0; p < QUADS<R, TN>; ++p) {
    int r, jl;
    quad_pos<TN>(p, r, jl);
    if (r < R) {
      const float4* x = v + 4 * p;
      float* d = dst + jl * RS + (r ^ sw(jl));
      *reinterpret_cast<float4*>(d) = make_float4(x[0].x, x[1].x, x[2].x, x[3].x);
      *reinterpret_cast<float4*>(d + RS) = make_float4(x[0].y, x[1].y, x[2].y, x[3].y);
      *reinterpret_cast<float4*>(d + 2 * RS) = make_float4(x[0].z, x[1].z, x[2].z, x[3].z);
      *reinterpret_cast<float4*>(d + 3 * RS) = make_float4(x[0].w, x[1].w, x[2].w, x[3].w);
    }
  }
}

// The scalar path (n % 4 != 0): copies the window rows [0, rows) x columns
// [j0, j0 + cols) of src into a tile element by element, transposed and
// swizzled (T) or row-major, zero outside.
template <int R, int TN, int LD, bool T>
__device__ __forceinline__ void copy_tile(float* dst, const float* __restrict__ src,
                                          int ld, int rows, int j0, int cols) {
#pragma unroll 1
  for (int e = threadIdx.x; e < R * TN; e += NT) {
    const int r = e / TN, j = e % TN;
    const float x = (r < rows && j < cols) ? __ldg(src + (size_t)r * ld + j0 + j) : 0.f;
    if constexpr (T) {
      dst[j * LD + (r ^ sw(j))] = x;
    } else {
      dst[r * LD + j] = x;
    }
  }
}

template <int KP, bool VEC>
__global__ void __launch_bounds__(NT, 2)
fused_mu_fro_f32_kernel(const float* __restrict__ A, const float* __restrict__ W,
                        const float* __restrict__ H, const float* __restrict__ HHT,
                        float eps, int m, int n, int k, float* __restrict__ W_out,
                        float* __restrict__ WTA, float* __restrict__ WTW) {
  using C = Cfg<KP>;
  constexpr int TM = C::TM, TN1 = C::TN1, TN2 = C::TN2, RC = C::RC;
  extern __shared__ float4 smem4[];
  float* X = reinterpret_cast<float*>(smem4);   // tiles, or sweep 1's partial sums
  float* Ws = X + C::X;                          // W panel, later W' [TM][LDW]
  float* HHs = Ws + TM * C::LDW;                 // HHT [KP][KP]

  const int b = blockIdx.y;
  const int row0 = blockIdx.x * TM;
  const int rows = min(TM, m - row0);
  A += (size_t)b * m * n + (size_t)row0 * n;
  W += ((size_t)b * m + row0) * k;
  W_out += ((size_t)b * m + row0) * k;
  H += (size_t)b * k * n;
  HHT += (size_t)b * k * k;
  WTA += (size_t)b * k * n;
  WTW += (size_t)b * k * k;
  const int tid = threadIdx.x;

  // Sweep 1: A_i H^T. Thread (g, ri, ci) sums rows 4 ri + u TM / RF + (0..3)
  // and factor columns 4 ci + (0..3), KP / 2 + 4 ci + (0..3) over the
  // columns g JPG .. (g + 1) JPG - 1 of each tile.
  {
    constexpr int RF = C::RM / 4;
    constexpr int NA = 4 * QUADS<TM, TN1>, NL = NA + SLOTS<KP, TN1>;
    float4 qa[NA], vh[SLOTS<KP, TN1>];          // the next tiles of A and H
    const int g = tid / C::T1, t = tid % C::T1;
    const int ci = t % (KP / 8), ri = t / (KP / 8);
    float4 acc[C::RM][2];
#pragma unroll
    for (int i = 0; i < C::RM; ++i) acc[i][0] = acc[i][1] = make_float4(0.f, 0.f, 0.f, 0.f);
    // fills tile buffer `buf` with the columns j0 .. j0 + TN1 of A_i and H
    // (from the registers where VEC staged them)
    const auto fill = [&](float* buf, int j0) {
      if constexpr (VEC) {
        store_q<TM, TN1, TM>(buf, qa);
        store_t<KP, TN1, C::HW>(buf + C::A1, vh);
      } else {
        copy_tile<TM, TN1, TM, true>(buf, A, n, rows, j0, min(TN1, n - j0));
        copy_tile<KP, TN1, C::HW, true>(buf + C::A1, H, n, k, j0, min(TN1, n - j0));
      }
    };
    if constexpr (VEC) {
#pragma unroll
      for (int q = 0; q < NA; ++q) qa[q] = load_quad<TN1>(q, A, n, rows, 0, min(TN1, n));
#pragma unroll
      for (int p = 0; p < SLOTS<KP, TN1>; ++p)
        vh[p] = load_slot<TN1>(p, H, n, k, 0, min(TN1, n));
    }
    fill(X, 0);
    __syncthreads();
    const int ntiles = (n + TN1 - 1) / TN1;
    for (int t0 = 0; t0 < ntiles; ++t0) {
      const float* As = X + (t0 & 1) * (C::A1 + C::H1);
      const float* Hs = As + C::A1;
      const bool next = t0 + 1 < ntiles;
      const int j1 = (t0 + 1) * TN1, cols1 = min(TN1, n - j1);
      if constexpr (VEC && C::PF > 1) {   // tile t0 + PF into L2
        const int jp = (t0 + C::PF) * TN1, colsp = min(TN1, n - jp);
        const int rowsp = t0 + C::PF < ntiles ? rows : 0;
#pragma unroll
        for (int p = 0; p < QUADS<TM, TN1>; ++p) {
          int r, jl;
          quad_pos<TN1>(p, r, jl);
#pragma unroll
          for (int i = 0; i < 4; ++i) prefetch4(A, n, r + i, jl, rowsp, jp, colsp);
        }
      }
#pragma unroll
      for (int jj = 0; jj < C::JPG; ++jj) {
        if constexpr (VEC) {
#pragma unroll
          for (int q = 0; q < NL; ++q) {
            if (q * C::JPG / NL != jj) continue;
            if (q < NA) qa[q] = load_quad<TN1>(q, A, n, next ? rows : 0, j1, cols1);
            else vh[q - NA] = load_slot<TN1>(q - NA, H, n, next ? k : 0, j1, cols1);
          }
        }
        const int j = g * C::JPG + jj, s = sw(j);
        const float* ap = As + j * TM;
        const float* hp = Hs + j * C::HW;
        const float4 h0 = *reinterpret_cast<const float4*>(hp + ((4 * ci) ^ s));
        const float4 h1 = *reinterpret_cast<const float4*>(hp + ((4 * ci + KP / 2) ^ s));
#pragma unroll
        for (int u = 0; u < RF; ++u) {
          const float4 a = *reinterpret_cast<const float4*>(ap + ((4 * ri + u * TM / RF) ^ s));
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc[4 * u + e][0] = fma4(comp(a, e), h0, acc[4 * u + e][0]);
            acc[4 * u + e][1] = fma4(comp(a, e), h1, acc[4 * u + e][1]);
          }
        }
      }
      if (next) fill(X + ((t0 + 1) & 1) * (C::A1 + C::H1), j1);
      __syncthreads();
    }
    // the groups' partial A_i H^T, Red[g][r][c], over the freed tiles
#pragma unroll
    for (int u = 0; u < RF; ++u) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float* d = X + (g * TM + 4 * ri + u * TM / RF + e) * KP + 4 * ci;
        *reinterpret_cast<float4*>(d) = acc[4 * u + e][0];
        *reinterpret_cast<float4*>(d + KP / 2) = acc[4 * u + e][1];
      }
    }
  }
  // sweep 2's first tile is in flight while W' is formed
  constexpr int NA2 = SLOTS<RC, TN2>;
  float4 va[NA2];
  if constexpr (VEC) {
#pragma unroll
    for (int p = 0; p < NA2; ++p) va[p] = load_slot<TN2>(p, A, n, min(RC, rows), 0, min(TN2, n));
  }

  // W'_i = W_i * AHT_i / (W_i HHT + eps). Rows past m and columns past k
  // load as zeros, so their W' is exactly zero.
  for (int e = tid; e < TM * KP; e += NT) {
    const int r = e / KP, c = e % KP;
    Ws[r * C::LDW + c] = (r < rows && c < k) ? W[(size_t)r * k + c] : 0.f;
  }
  for (int e = tid; e < KP * KP; e += NT) {
    const int c = e / KP, d = e % KP;
    HHs[e] = (c < k && d < k) ? HHT[c * k + d] : 0.f;
  }
  __syncthreads();
  float4 wn[C::NW];
#pragma unroll
  for (int q = 0; q < C::NW; ++q) {
    const int e = tid + NT * q, r = e / (KP / 4), c = 4 * (e % (KP / 4));
    float4 aht = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int g = 0; g < C::G1; ++g)
      aht = add4(aht, *reinterpret_cast<const float4*>(X + (g * TM + r) * KP + c));
    float4 den = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
    for (int d = 0; d < KP; ++d)
      den = fma4(Ws[r * C::LDW + d], *reinterpret_cast<const float4*>(HHs + d * KP + c), den);
    const float4 w = *reinterpret_cast<const float4*>(Ws + r * C::LDW + c);
    wn[q] = make_float4(w.x * aht.x / (den.x + eps), w.y * aht.y / (den.y + eps),
                        w.z * aht.z / (den.z + eps), w.w * aht.w / (den.w + eps));
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < C::NW; ++q) {
    const int e = tid + NT * q, r = e / (KP / 4), c = 4 * (e % (KP / 4));
    *reinterpret_cast<float4*>(Ws + r * C::LDW + c) = wn[q];
    if (r < rows) {
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (c + u < k) W_out[(size_t)r * k + c + u] = comp(wn[q], u);
    }
  }
  if constexpr (VEC) {
    store_r<RC, TN2, C::LD2>(X, va);
  } else {
    copy_tile<RC, TN2, C::LD2, false>(X, A, n, min(RC, rows), 0, min(TN2, n));
  }
  __syncthreads();

  // WTW += W'^T W' over this panel.
  for (int e = tid; e < KP * KP; e += NT) {
    const int c = e / KP, d = e % KP;
    if (c < k && d < k) {
      float s = 0.f;
      for (int r = 0; r < rows; ++r) s += Ws[r * C::LDW + c] * Ws[r * C::LDW + d];
      atomicAdd(&WTW[c * k + d], s);
    }
  }

  // Sweep 2: WTA += W'^T A_i. Thread (cg, jg) sums factor columns
  // 4 cg + (0..3), KP / 2 + 4 cg + (0..3) and columns 4 jg + u TN2 / JF +
  // (0..3) of each strip over all rows of the panel.
  {
    constexpr int JF = C::JT / 4;
    const int jg = tid % (TN2 / C::JT), cg = tid / (TN2 / C::JT);
    const int nchunks = (rows + RC - 1) / RC;
    const int ntiles = (n + TN2 - 1) / TN2 * nchunks;
    float4 acc[8][JF];
#pragma unroll
    for (int c = 0; c < 8; ++c)
#pragma unroll
      for (int u = 0; u < JF; ++u) acc[c][u] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int t0 = 0; t0 < ntiles; ++t0) {
      const int s0 = t0 / nchunks, c0 = t0 % nchunks;
      const float* As = X + (t0 & 1) * C::A2;
      const bool next = t0 + 1 < ntiles;
      const int s1 = (t0 + 1) / nchunks, r1 = (t0 + 1) % nchunks * RC;
      const int rows1 = next ? min(RC, rows - r1) : 0;
      const int j1 = s1 * TN2, cols1 = min(TN2, n - j1);
      const float* A1 = A + (size_t)r1 * n;
      if constexpr (VEC && C::PF > 1) {   // tile t0 + PF into L2
        const int tp = t0 + C::PF, rp = tp % nchunks * RC, jp = tp / nchunks * TN2;
        const int rowsp = tp < ntiles ? min(RC, rows - rp) : 0;
#pragma unroll
        for (int p = 0; p < NA2; ++p) {
          int r, jl;
          slot_pos<TN2>(p, r, jl);
          prefetch4(A + (size_t)rp * n, n, r, jl, rowsp, jp, min(TN2, n - jp));
        }
      }
#pragma unroll
      for (int rr = 0; rr < RC; ++rr) {
        if constexpr (VEC) {
#pragma unroll
          for (int q = 0; q < NA2; ++q)
            if (q * RC / NA2 == rr) va[q] = load_slot<TN2>(q, A1, n, rows1, j1, cols1);
        }
        const float* wp = Ws + (c0 * RC + rr) * C::LDW;
        const float4 w0 = *reinterpret_cast<const float4*>(wp + 4 * cg);
        const float4 w1 = *reinterpret_cast<const float4*>(wp + 4 * cg + KP / 2);
#pragma unroll
        for (int u = 0; u < JF; ++u) {
          const float4 a = *reinterpret_cast<const float4*>(
              As + rr * C::LD2 + 4 * jg + u * TN2 / JF);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc[e][u] = fma4(comp(w0, e), a, acc[e][u]);
            acc[4 + e][u] = fma4(comp(w1, e), a, acc[4 + e][u]);
          }
        }
      }
      if (next) {
        float* An = X + ((t0 + 1) & 1) * C::A2;
        if constexpr (VEC) {
          store_r<RC, TN2, C::LD2>(An, va);
        } else {
          copy_tile<RC, TN2, C::LD2, false>(An, A1, n, rows1, j1, cols1);
        }
      }
      if (c0 == nchunks - 1) {   // the strip is summed over the panel
#pragma unroll
        for (int cc = 0; cc < 8; ++cc) {
          const int c = (cc < 4 ? 0 : KP / 2 - 4) + 4 * cg + cc;
#pragma unroll
          for (int u = 0; u < JF; ++u) {
            const int j = s0 * TN2 + 4 * jg + u * TN2 / JF;
            const float4 v = acc[cc][u];
            acc[cc][u] = make_float4(0.f, 0.f, 0.f, 0.f);
            if (c >= k || j >= n) continue;
            float* dst = WTA + (size_t)c * n + j;
            if constexpr (VEC) {
              atomicAdd(reinterpret_cast<float4*>(dst), v);   // j + 3 < n as n % 4 == 0
            } else {
              atomicAdd(dst, v.x);
              if (j + 1 < n) atomicAdd(dst + 1, v.y);
              if (j + 2 < n) atomicAdd(dst + 2, v.z);
              if (j + 3 < n) atomicAdd(dst + 3, v.w);
            }
          }
        }
      }
      __syncthreads();
    }
  }
}

template <int KP, bool VEC>
cudaError_t launch(const float* A, const float* W, const float* H,
                   const float* HHT, float eps, int B, int m, int n, int k,
                   float* W_out, float* WTA, float* WTW, cudaStream_t stream) {
  using C = Cfg<KP>;
  const auto kernel = &fused_mu_fro_f32_kernel<KP, VEC>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::SMEM);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const dim3 grid((m + C::TM - 1) / C::TM, B);
  kernel<<<grid, NT, C::SMEM, stream>>>(A, W, H, HHT, eps, m, n, k, W_out, WTA, WTW);
  return cudaGetLastError();
}

template <int KP>
cudaError_t launch_kp(const float* A, const float* W, const float* H,
                      const float* HHT, float eps, int B, int m, int n, int k,
                      float* W_out, float* WTA, float* WTW, cudaStream_t s) {
  // 16-byte loads and vector atomics need every row of A, H and WTA aligned
  const bool vec = n % 4 == 0 &&
      (reinterpret_cast<uintptr_t>(A) | reinterpret_cast<uintptr_t>(H) |
       reinterpret_cast<uintptr_t>(WTA)) % 16 == 0;
  return vec ? launch<KP, true>(A, W, H, HHT, eps, B, m, n, k, W_out, WTA, WTW, s)
             : launch<KP, false>(A, W, H, HHT, eps, B, m, n, k, W_out, WTA, WTW, s);
}

cudaError_t dispatch(const void* A_, const void* W_, const void* H_,
                     const void* HHT_, float eps, int B, int m, int n, int k,
                     void* W_out_, void* WTA_, void* WTW_, cudaStream_t s) {
  if (B < 1 || m < 1 || n < 1 || k < 1) return cudaErrorInvalidValue;
  const auto A = static_cast<const float*>(A_), W = static_cast<const float*>(W_),
             H = static_cast<const float*>(H_), HHT = static_cast<const float*>(HHT_);
  const auto W_out = static_cast<float*>(W_out_), WTA = static_cast<float*>(WTA_),
             WTW = static_cast<float*>(WTW_);
  if (k <= 8) return launch_kp<8>(A, W, H, HHT, eps, B, m, n, k, W_out, WTA, WTW, s);
  if (k <= 16) return launch_kp<16>(A, W, H, HHT, eps, B, m, n, k, W_out, WTA, WTW, s);
  if (k <= 32) return launch_kp<32>(A, W, H, HHT, eps, B, m, n, k, W_out, WTA, WTW, s);
  if (k <= 64) return launch_kp<64>(A, W, H, HHT, eps, B, m, n, k, W_out, WTA, WTW, s);
  return cudaErrorInvalidValue;
}

}  // namespace f32

}  // namespace

// Plain C interface, bound with ctypes. A is (B, m, n) in f32, bf16 or uint8; W and
// W_out are (B, m, k), H is (B, k, n), HHT is (B, k, k), WTA is (B, k, n) and
// WTW is (B, k, k), all f32, contiguous, and WTA/WTW zeroed by the caller.
// Returns the CUDA error code of the launch (0 on success).
extern "C" int fused_mu_fro_f32(const void* A, const void* W, const void* H,
                                const void* HHT, float eps, int B, int m, int n,
                                int k, void* W_out, void* WTA, void* WTW,
                                void* stream) {
  return (int)f32::dispatch(A, W, H, HHT, eps, B, m, n, k, W_out, WTA, WTW,
                            static_cast<cudaStream_t>(stream));
}

extern "C" int fused_mu_fro_bf16(const void* A, const void* W, const void* H,
                                 const void* HHT, float eps, int B, int m,
                                 int n, int k, void* W_out, void* WTA,
                                 void* WTW, void* stream) {
  return (int)dispatch<__nv_bfloat16>(A, W, H, HHT, eps, B, m, n, k, W_out, WTA,
                                      WTW, static_cast<cudaStream_t>(stream));
}

extern "C" int fused_mu_fro_u8(const void* A, const void* W, const void* H,
                               const void* HHT, float eps, int B, int m, int n,
                               int k, void* W_out, void* WTA, void* WTW,
                               void* stream) {
  return (int)dispatch<uint8_t>(A, W, H, HHT, eps, B, m, n, k, W_out, WTA, WTW,
                                static_cast<cudaStream_t>(stream));
}

extern "C" const char* fused_mu_fro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
