// K3: one KL-MU iteration with one pass over the row panels of A.
//
// Replaces pydnmfk_tpu/ops/fused_kl.py::_fused_kl_kernel (launched by
// _fused_kl_pass). For each row panel A_i of each member b:
//
//     U_i   = A_i / (W_i H + eps)
//     W'_i  = W_i * (U_i H^T) / (hrs + eps)     written to W_out
//     U'_i  = A_i / (W'_i H + eps)
//     WTU  += W'_i^T U'_i                        (k x n, f32 atomics)
//
// with hrs = rowsum(H). The H update (H * WTU / (colsum(W') + eps)) and hrs
// are k-sized and stay in PyTorch, as the TPU version leaves them to XLA.
//
// Both kernels below share K1's two-sweep structure (csrc/fused_mu_fro.cu).
// One block of 256 threads owns a row panel of one member (grid = row
// panels x members, so the member stack of an NMFk ensemble is one launch).
// W'_i needs U_i H^T over all of n before any U'_i exists, so sweep 1 sums
// U_i H^T over the column tiles, W'_i is formed, written out and kept in
// shared memory, and sweep 2 reads A_i again to form U'_i and add
// W'_i^T U'_i into WTU. The TPU kernel carries WTU from one grid step to the
// next; Hopper runs the panels in parallel, so that carry becomes f32
// atomics into the zeroed WTU, as in K1. A deterministic second pass would
// need a (panels x k x n) f32 scratch, 4.4 GB at 57600 x 38400, k = 32: half
// of A's bytes again. The atomics' order varies from run to run; the sums
// agree with the plain version to f32 rounding. A is never padded or copied
// (the JAX caller pads it to its row tile, an 8.8 GB copy at full size): the
// ragged edges of m and n load as zeros, which give U = 0 and W' = 0 and add
// nothing. k is padded to 8, 16, 32 or 64 with zeros inside the block
// (MAX_K = 64 in ops/fused_kl.py).
//
// Which A takes which kernel:
// - f32 A, k <= 32: f32::fused_mu_kl_f32_kernel (C entry fused_mu_kl_f32),
//   register micro-tiles on the CUDA cores; its design note stands above it.
// - bf16 or uint8 A, and f32 A at 32 < k <= 64: fused_mu_kl_kernel, the
//   first port's simple kernel, below.
//
// Types (pydnmfk_tpu/ops/fused_kl.py:52-81, matmul_compute_dtype off the
// TPU): with an f32 A every product is true f32. With a bf16 or uint8 A the
// products take bf16 operands with f32 sums: W is rounded for W H, U for
// U H^T, W' for W' H, and W' and U' for W'^T U'; H is rounded as it is
// loaded. A is widened exactly to f32 (a uint8 A one byte load per element,
// so any n works); the ratios and the W' update are f32.
//
// What bounds it: 8 m n k operations (four products of 2 m n k) against one
// read of A's bytes. At f32 that is the operations on CUDA cores (8.45 ms at
// 57600 x 38400, k = 32, at 67 TFLOP/s); at bf16 or uint8 the operations
// would fit the tensor cores, and the bytes of A bound it (1.32 ms bf16,
// 0.66 ms uint8).
//
// The first port's kernel (fused_mu_kl_kernel): panels of TM = 64 rows and
// column tiles of TN = 64; sweep 1 forms W_i H_j in registers from the W
// panel and an H tile in shared memory, overwrites the A tile with U and
// accumulates U_i H^T (TM x k) in registers; sweep 2 forms W'_i H_j and U'
// the same way and adds W'_i^T U'_i into WTU with scalar atomics. Its loops
// read factors from shared memory at about 2 bytes per FMA, and its loads
// are scalar and synchronous; tensor cores for a bf16 or uint8 A are later
// work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int TM = 64;        // rows of A per block
constexpr int TN = 64;        // columns of A per tile
constexpr int NT = 256;       // threads per block (8 warps)
constexpr int LDA = TN + 1;   // padded row stride of the A / U tile

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(uint8_t x) { return static_cast<float>(x); }

// A value as an operand of a product: unchanged for an f32 A, rounded to
// bf16 for a bf16 or uint8 A.
template <typename T>
__device__ __forceinline__ float operand(float x) {
  if constexpr (!std::is_same<T, float>::value) {
    return __bfloat162float(__float2bfloat16(x));
  } else {
    return x;
  }
}

// As [TM][LDA] <- A rows [0, rows), columns [j0, j0 + cols); zeros elsewhere.
template <typename T>
__device__ __forceinline__ void load_a_tile(float* As, const T* __restrict__ A,
                                            int n, int rows, int j0, int cols) {
  for (int e = threadIdx.x; e < TM * TN; e += NT) {
    const int r = e / TN, j = e % TN;
    As[r * LDA + j] = (r < rows && j < cols) ? to_f32(A[(size_t)r * n + j0 + j]) : 0.f;
  }
}

// Hs [KP][TN] <- H rows [0, k), columns [j0, j0 + cols) as operands.
template <typename T, int KP>
__device__ __forceinline__ void load_h_tile(float* Hs, const float* __restrict__ H,
                                            int n, int k, int j0, int cols) {
  for (int e = threadIdx.x; e < KP * TN; e += NT) {
    const int c = e / TN, j = e % TN;
    Hs[e] = (c < k && j < cols) ? operand<T>(H[(size_t)c * n + j0 + j]) : 0.f;
  }
}

// As <- operand(As / (Ws Hs + eps)) for the whole tile, Ws [TM][KP+1]
// holding the operand panel. Thread: rows warp + 8 i, columns {lane,
// lane + 32}.
template <typename T, int KP>
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
    As[r * LDA + lane] = operand<T>(As[r * LDA + lane] / (wh[i][0] + eps));
    As[r * LDA + lane + 32] = operand<T>(As[r * LDA + lane + 32] / (wh[i][1] + eps));
  }
}

template <int KP>
constexpr size_t smem_bytes() {
  return sizeof(float) * (TM * LDA + KP * TN + TM * (KP + 1));
}

template <typename T, int KP>
__global__ void __launch_bounds__(NT)
fused_mu_kl_kernel(const T* __restrict__ A, const float* __restrict__ W,
                   const float* __restrict__ H, const float* __restrict__ hrs,
                   float eps, int m, int n, int k, float* __restrict__ W_out,
                   float* __restrict__ WTU) {
  constexpr int LDW = KP + 1;   // padded row stride of the W panel
  constexpr int CT = KP / 8;    // factor columns per thread: c = warp + 8 q
  extern __shared__ float smem[];
  float* As = smem;             // [TM][LDA]  A tile, then U or U'
  float* Hs = As + TM * LDA;    // [KP][TN]   H tile (operands)
  float* Ws = Hs + KP * TN;     // [TM][LDW]  W panel, later W' (operands)

  const int b = blockIdx.y;
  const int row0 = blockIdx.x * TM;
  const int rows = min(TM, m - row0);
  A += (size_t)b * m * n + (size_t)row0 * n;
  W += ((size_t)b * m + row0) * k;
  W_out += ((size_t)b * m + row0) * k;
  H += (size_t)b * k * n;
  hrs += (size_t)b * k;
  WTU += (size_t)b * k * n;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  for (int e = tid; e < TM * KP; e += NT) {
    const int r = e / KP, c = e % KP;
    Ws[r * LDW + c] = (r < rows && c < k) ? operand<T>(W[(size_t)r * k + c]) : 0.f;
  }

  // Sweep 1: U H^T for rows {lane, lane + 32} and columns warp + 8 q.
  float acc[2][CT];
#pragma unroll
  for (int q = 0; q < CT; ++q) acc[0][q] = acc[1][q] = 0.f;
  for (int j0 = 0; j0 < n; j0 += TN) {
    const int cols = min(TN, n - j0);
    load_a_tile(As, A, n, rows, j0, cols);
    load_h_tile<T, KP>(Hs, H, n, k, j0, cols);
    __syncthreads();
    ratio_tile<T, KP>(As, Hs, Ws, eps);
    __syncthreads();
#pragma unroll 4
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

  // W'_i = W_i * (U_i H^T) / (hrs + eps) from the unrounded f32 W; rows past
  // m and columns past k are exactly zero. Ws then holds W' as operands.
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = lane + 32 * i;
#pragma unroll
    for (int q = 0; q < CT; ++q) {
      const int c = warp + 8 * q;
      const bool in = r < rows && c < k;
      const float w = in ? W[(size_t)r * k + c] : 0.f;
      const float wn = in ? w * acc[i][q] / (hrs[c] + eps) : 0.f;
      if (in) W_out[(size_t)r * k + c] = wn;
      Ws[r * LDW + c] = operand<T>(wn);
    }
  }
  __syncthreads();

  // Sweep 2: WTU[c][j0 + j] += sum_r W'[r][c] U'[r][j] for columns
  // j in {lane, lane + 32} and factor columns c = warp + 8 q.
  for (int j0 = 0; j0 < n; j0 += TN) {
    const int cols = min(TN, n - j0);
    load_a_tile(As, A, n, rows, j0, cols);
    load_h_tile<T, KP>(Hs, H, n, k, j0, cols);
    __syncthreads();
    ratio_tile<T, KP>(As, Hs, Ws, eps);
    __syncthreads();
    float p[CT][2];
#pragma unroll
    for (int q = 0; q < CT; ++q) p[q][0] = p[q][1] = 0.f;
#pragma unroll 4
    for (int r = 0; r < TM; ++r) {
      const float u0 = As[r * LDA + lane], u1 = As[r * LDA + lane + 32];
#pragma unroll
      for (int q = 0; q < CT; ++q) {
        const float w = Ws[r * LDW + warp + 8 * q];
        p[q][0] += w * u0;
        p[q][1] += w * u1;
      }
    }
#pragma unroll
    for (int q = 0; q < CT; ++q) {
      const int c = warp + 8 * q;
      if (c < k) {
        if (lane < cols) atomicAdd(&WTU[(size_t)c * n + j0 + lane], p[q][0]);
        if (lane + 32 < cols) atomicAdd(&WTU[(size_t)c * n + j0 + lane + 32], p[q][1]);
      }
    }
    __syncthreads();
  }
}

template <typename T, int KP>
cudaError_t launch(const void* A, const void* W, const void* H, const void* hrs,
                   float eps, int B, int m, int n, int k, void* W_out, void* WTU,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<KP>();
  const auto kernel = &fused_mu_kl_kernel<T, KP>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((m + TM - 1) / TM, B);
  kernel<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(A), static_cast<const float*>(W),
      static_cast<const float*>(H), static_cast<const float*>(hrs), eps, m, n,
      k, static_cast<float*>(W_out), static_cast<float*>(WTU));
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The f32 kernel: register micro-tiles on both sweeps, 16-byte loads in
// flight, 128-row panels with vector atomics.
//
// What bounds it: 8 k FMAs per element of A on the CUDA cores (true f32 has
// no tensor-core path at the 1e-4 gate), against A read twice (the two-read
// floor: 5.28 ms at 57600 x 38400 against 8.45 ms of FMAs at k = 32; at
// k = 8 the bytes bound it). So the FMA pipe has to be kept busy: each inner
// loop is an outer product on registers fed by float4 shared-memory loads
// that most lanes of a warp share (broadcasts), every operand is loaded once
// per tile, and no loop reads a scalar from shared memory per FMA. What each
// part does:
// - The ratio step (both sweeps): a thread owns a quad of 4 rows x 4
//   columns of the tile. Its A values come straight from device memory into
//   registers (one 16-byte load per row), issued a tile ahead, so A never
//   passes through shared memory. P = W_i H_j (or W'_i H_j) is a 4 x 4
//   outer product per factor c: one float4 of the transposed W panel (4
//   rows at c) and one of the H tile (4 columns at c) per 16 FMAs; a warp
//   spans up to 4 row quads x 8 column quads, so each load is 1 wavefront.
//   P starts at eps, and U = A / P comes by __fdividef in the registers that
//   hold P (IEEE `/` is 11-37 % slower in K1 and K2, with the same errors).
// - Sweep 1 (U_i H^T, TM x KP, a sum over n), on tiles of TN1 columns (TM x
//   TN1 = 16 NT: one quad a thread): U goes once into shared memory,
//   transposed and XOR-swizzled as K1-f32's sweep 1 holds A (row r of column
//   j at r ^ sw(j)), and U H^T is a register-tiled product: a thread keeps
//   4 rows x 8 factors over all of n (one float4 of U^T and two of H^T per 32
//   FMAs; 8 x 8 tiles take 128 registers and spill beside the ratio step),
//   the threads split each tile's columns into G1 groups, and the groups'
//   partial sums meet once per panel in shared memory. H's tile is kept
//   twice, row-major for W H and transposed for U H^T.
// - W'_i = W_i * (U_i H^T) / (hrs + eps) from the unrounded f32 W, with an
//   IEEE division on the k-sized denominator; written to W_out and kept in
//   shared memory, row-major for sweep 2's product and transposed for its
//   ratio step.
// - Sweep 2 (W'^T U', KP x n), K1-f32's sweep-2 layout: a thread owns 8
//   factors x 4 columns of a strip of TN2 columns and sums them over all
//   rows of the panel, streamed in chunks of RC rows (RC x TN2 = 16 NT: one
//   quad a thread), so no partial sums are exchanged. The strip's H (KP x
//   TN2) is staged once per strip. When a strip is done, its sums go into
//   WTU with 16-byte vector atomics (red.global.add.v4.f32).
// - Loads in flight: the next tile's A quad is issued right after the
//   ratio step has read the current one (at KP = 16 spread over the
//   product instead), sweep 1's H tiles two tiles ahead; U tiles are
//   double-buffered and H tiles triple-buffered in shared memory, so each
//   tile costs one block barrier (sweep 2 one more per strip, to stage its
//   H). Holding a second tile of A in registers, a cp.async ring for A,
//   L2 prefetches and keeping U in registers at KP = 8 (K2's scheme) were
//   no faster.
// - VEC: 16-byte loads and vector atomics when n % 4 == 0 and A, H and WTU
//   are 16-byte aligned; otherwise the same loops load element by element
//   (masked) and WTU takes scalar atomics.
// - Panels of TM = 128 rows: half the panels of the first port's 64, and so
//   half the H tiles read from L2 and the atomics into WTU. 256 threads, at
//   most 128 registers (no spill in any instantiation) and 69-99 KB of
//   shared memory, so two blocks fit an SM: 264 at once on the 132 SMs,
//   against 450 panels at m = 57600 (1.7 waves). On the 16-byte path at
//   KP = 8 the panels are 64 rows: the 14400-row member stack makes 10 x 225
//   blocks (8.5 waves) instead of 10 x 113 (4.3, the last a quarter full).
// - Both sweeps at KP = 8 run about as fast as K2a and K2b, which stream
//   the same bytes with the same products; each sweep reaches about 75 % of
//   the memory rate, so the fused kernel gains its time at k = 32, where the
//   FMAs bound it.
// KP = 64 keeps the first port's kernel.

namespace f32 {

constexpr int NT = 256;       // threads per block

constexpr int cmax(int a, int b) { return a > b ? a : b; }

template <int KP, bool VEC>
struct Cfg {
  // rows per panel: 64 on the 16-byte path at KP = 8, where 128 leave the
  // last wave of a member stack a quarter full; 128 otherwise (the scalar
  // path at KP = 8 spills at 64)
  static constexpr int TM = KP == 8 && VEC ? 64 : 128;
  // the next tile's A quad: loaded right after the ratio step, or (KP = 16,
  // which spills otherwise) spread over the U H^T or W'^T U' product
  static constexpr bool EARLY = KP != 16;
  // sweep 1: tiles of TN1 columns; U H^T takes 4 rows x 8 factors a thread
  static constexpr int TN1 = 16 * NT / TM;
  static constexpr int HW = cmax(KP, 32);           // row width of the H^T tile
  static constexpr int T1 = TM / 4 * (KP / 8);      // threads per column group
  static constexpr int G1 = NT / T1;                // column groups
  static constexpr int JPG = TN1 / G1;              // columns per group and tile
  // sweep 2: strips of TN2 columns in chunks of RC rows; 8 factors x JT
  // columns a thread
  static constexpr int JT = 4;
  static constexpr int TN2 = NT * JT * 8 / KP;
  static constexpr int RC = 4096 / TN2;
  static constexpr int LD2 = TN2 + 4;               // row stride of a U' chunk
  static constexpr int LDW = KP + 4;                // row stride of the W' panel
  static constexpr int NW = (TM * KP / 4 + NT - 1) / NT;   // float4s of W' a thread
  // shared memory, in floats: region X holds sweep 1's U^T tiles (two) and
  // H tiles (three, each row-major and transposed), or its groups' partial
  // sums, or sweep 2's U' chunks (two) and H strip; then the transposed W
  // (later W') panel and the row-major W' panel
  static constexpr int U1 = TN1 * TM, H1 = KP * TN1 + TN1 * HW;
  static constexpr int RED = G1 * TM * KP;
  static constexpr int U2 = RC * LD2;
  static constexpr int X = cmax(cmax(2 * U1 + 3 * H1, RED), 2 * U2 + KP * TN2);
  static constexpr size_t SMEM = sizeof(float) * (X + KP * TM + TM * LDW);
  static_assert(T1 * G1 == NT && JPG % 4 == 0 && KP * TN1 <= 4 * NT, "sweep 1");
  static_assert(TM * TN1 == 16 * NT && RC * TN2 == 16 * NT && RC % 4 == 0,
                "one quad a thread");
  static_assert(TN2 / JT * (KP / 8) == NT && TM % RC == 0, "sweep 2");
  static_assert(NW >= 1 && SMEM <= 110 * 1024 && (X + KP * TM + TM * LDW) % 4 == 0,
                "two blocks an SM");
};

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

__device__ __forceinline__ float4 div4(float4 a, float4 p) {
  return make_float4(__fdividef(a.x, p.x), __fdividef(a.y, p.y),
                     __fdividef(a.z, p.z), __fdividef(a.w, p.w));
}

__device__ __forceinline__ float comp(float4 v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

__device__ __forceinline__ float4 zero4() { return make_float4(0.f, 0.f, 0.f, 0.f); }

// Columns jl .. jl + 3 of row r of the window rows [0, rows) x columns
// [j0, j0 + cols) of src (row stride ld); zero outside (no load at all when
// rows == 0). VEC: one 16-byte load (ld % 4 == 0 and src aligned, so cols
// is a multiple of 4); otherwise element by element.
template <bool VEC>
__device__ __forceinline__ float4 load4(const float* __restrict__ src, int ld,
                                        int r, int jl, int rows, int j0, int cols) {
  if (r >= rows || jl >= cols) return zero4();
  const float* p = src + (size_t)r * ld + j0 + jl;
  if constexpr (VEC) {
    return __ldg(reinterpret_cast<const float4*>(p));
  } else {
    return make_float4(__ldg(p), jl + 1 < cols ? __ldg(p + 1) : 0.f,
                       jl + 2 < cols ? __ldg(p + 2) : 0.f,
                       jl + 3 < cols ? __ldg(p + 3) : 0.f);
  }
}

// This thread's quad of a tile of 4 RG rows: rows r .. r + 3, columns
// jl .. jl + 3. A warp spans min(RG, 4) row quads and 32 / min(RG, 4) column
// quads, so its loads of a row are whole 128-byte lines and its shared
// loads of the ratio step are broadcasts.
template <int RG>
__device__ __forceinline__ void quad_pos(int& r, int& jl) {
  const int tid = threadIdx.x;
  r = 4 * ((tid >> 3) % RG);
  jl = 4 * ((tid & 7) + 8 * (tid / (8 * RG)));
}

// The ratio step on this thread's quad: p = eps + sum_c Wt[c][wr ..] Ht[c][jl
// ..] over KP factors (Wt's rows of stride TM, Ht's of stride LDH), then
// u[i] = a[i] / p[i]. A row or column outside the window has a = 0 and so
// u = 0.
template <int KP, int TM, int LDH, bool VEC>
__device__ __forceinline__ void ratio_quad(float4 (&u)[4], const float4 (&a)[4],
                                           const float* Wt, const float* Ht,
                                           int wr, int jl, float eps) {
  float4 p[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) p[i] = make_float4(eps, eps, eps, eps);
  const auto step = [&](int c) {
    const float4 w = *reinterpret_cast<const float4*>(Wt + c * TM + wr);
    const float4 h = *reinterpret_cast<const float4*>(Ht + c * LDH + jl);
    p[0] = fma4(w.x, h, p[0]);
    p[1] = fma4(w.y, h, p[1]);
    p[2] = fma4(w.z, h, p[2]);
    p[3] = fma4(w.w, h, p[3]);
  };
  // unrolled whole on the 16-byte path; on the scalar path, whose masked
  // loads hold more registers, 4 or 2 deep (fully unrolled, it spills)
  if constexpr (VEC) {
#pragma unroll
    for (int c = 0; c < KP; ++c) step(c);
  } else if constexpr (KP == 8) {
#pragma unroll 4
    for (int c = 0; c < KP; ++c) step(c);
  } else {
#pragma unroll 2
    for (int c = 0; c < KP; ++c) step(c);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) u[i] = div4(a[i], p[i]);
}

template <int KP, bool VEC>
__global__ void __launch_bounds__(NT, 2)
fused_mu_kl_f32_kernel(const float* __restrict__ A, const float* __restrict__ W,
                       const float* __restrict__ H, const float* __restrict__ hrs,
                       float eps, int m, int n, int k, float* __restrict__ W_out,
                       float* __restrict__ WTU) {
  using C = Cfg<KP, VEC>;
  constexpr int TM = C::TM, TN1 = C::TN1, TN2 = C::TN2, RC = C::RC;
  extern __shared__ float4 smem4[];
  float* X = reinterpret_cast<float*>(smem4);   // tiles, or sweep 1's partial sums
  float* Wt = X + C::X;                          // [KP][TM]: W^T, later W'^T
  float* Wr = Wt + KP * TM;                      // [TM][LDW]: W'

  const int b = blockIdx.y;
  const int row0 = blockIdx.x * TM;
  const int rows = min(TM, m - row0);
  A += (size_t)b * m * n + (size_t)row0 * n;
  W += ((size_t)b * m + row0) * k;
  W_out += ((size_t)b * m + row0) * k;
  H += (size_t)b * k * n;
  hrs += (size_t)b * k;
  WTU += (size_t)b * k * n;
  const int tid = threadIdx.x;

  // the W panel, transposed; zero past the panel's rows and past k
  for (int e = tid; e < TM * KP; e += NT) {
    const int c = e / TM, r = e % TM;
    Wt[e] = (r < rows && c < k) ? __ldg(W + (size_t)r * k + c) : 0.f;
  }

  // -- sweep 1: U_i H^T ------------------------------------------------------
  // U H^T: thread (g, ri, ci) sums rows 4 ri + (0..3) and factor columns
  // 4 ci + (0..3), KP / 2 + 4 ci + (0..3) over the columns g JPG .. (g + 1)
  // JPG - 1 of each tile.
  {
    const int g = tid / C::T1, t1 = tid % C::T1;
    const int ci = t1 % (KP / 8), ri = t1 / (KP / 8);
    int qr, qj;                      // the ratio step's quad
    quad_pos<TM / 4>(qr, qj);
    const int hr = tid / (TN1 / 4), hj = 4 * (tid % (TN1 / 4));   // H slot
    const int ntiles = (n + TN1 - 1) / TN1;
    float4 acc[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[i][0] = acc[i][1] = zero4();
    float4 qa[4], vh;                // the next A quad, the H slot two tiles on
    const auto hbuf = [&](int t) { return X + 2 * C::U1 + (t % 3) * C::H1; };
    const auto load_h = [&](int t) {   // H rows [0, k) of tile t, slot (hr, hj)
      const int j0 = t * TN1;
      vh = load4<VEC>(H, n, hr, hj, t < ntiles ? k : 0, j0, min(TN1, n - j0));
    };
    const auto store_h = [&](int t) {  // the slot into tile t's buffers
      if (hr < KP) {
        float* hb = hbuf(t);
        *reinterpret_cast<float4*>(hb + hr * TN1 + hj) = vh;
        float* d = hb + KP * TN1 + hj * C::HW + (hr ^ sw(hj));
        d[0] = vh.x;
        d[C::HW] = vh.y;
        d[2 * C::HW] = vh.z;
        d[3 * C::HW] = vh.w;
      }
    };
    const auto load_a = [&](int t, int i) {   // row i of tile t's quad
      const int j0 = t * TN1;
      qa[i] = load4<VEC>(A, n, qr + i, qj, t < ntiles ? rows : 0, j0,
                         min(TN1, n - j0));
    };
    load_h(0);
    store_h(0);
    load_h(1);
    store_h(1);
    if constexpr (VEC) {
#pragma unroll
      for (int i = 0; i < 4; ++i) load_a(0, i);
    }
    __syncthreads();
#pragma unroll 1
    for (int t = 0; t < ntiles; ++t) {
      const float* hb = hbuf(t);
      float* ut = X + (t & 1) * C::U1;
      if constexpr (!VEC) {   // element by element, right before use
#pragma unroll
        for (int i = 0; i < 4; ++i) load_a(t, i);
      }
      {   // U of this thread's quad, into ut transposed: row r of column j
          // at ut[j TM + (r ^ sw(j))]
        float4 u[4];
        ratio_quad<KP, TM, TN1, VEC>(u, qa, Wt, hb, qr, qj, eps);
        float* d = ut + qj * TM + (qr ^ sw(qj));
        *reinterpret_cast<float4*>(d) = make_float4(u[0].x, u[1].x, u[2].x, u[3].x);
        *reinterpret_cast<float4*>(d + TM) = make_float4(u[0].y, u[1].y, u[2].y, u[3].y);
        *reinterpret_cast<float4*>(d + 2 * TM) = make_float4(u[0].z, u[1].z, u[2].z, u[3].z);
        *reinterpret_cast<float4*>(d + 3 * TM) = make_float4(u[0].w, u[1].w, u[2].w, u[3].w);
      }
      if constexpr (VEC && C::EARLY) {
#pragma unroll
        for (int i = 0; i < 4; ++i) load_a(t + 1, i);
      }
      __syncthreads();
      // this group's columns jb .. jb + JPG - 1: the swizzle is the same for
      // each 4 of them, so the addresses are offsets from two bases
      const int jb = g * C::JPG;
      const float* ap0 = ut + jb * TM;
      const float* hp0 = hb + KP * TN1 + jb * C::HW;
#pragma unroll
      for (int jj = 0; jj < C::JPG; ++jj) {
        // the next tile's A quad and the H slot of the tile after it,
        // spread over the product
        if constexpr (VEC) {
#pragma unroll
          for (int q = 0; q < 5; ++q) {
            if (q * C::JPG / 5 != jj) continue;
            if (q < 4) { if (!C::EARLY) load_a(t + 1, q); }
            else load_h(t + 2);
          }
        }
        __syncwarp();   // keeps ptxas from hoisting the shared loads into spills
        const int s = sw(jb + (jj & ~3));
        const float* ap = ap0 + jj * TM;
        const float* hp = hp0 + jj * C::HW;
        const float4 h0 = *reinterpret_cast<const float4*>(hp + ((4 * ci) ^ s));
        const float4 h1 = *reinterpret_cast<const float4*>(hp + ((4 * ci + KP / 2) ^ s));
        const float4 a = *reinterpret_cast<const float4*>(ap + ((4 * ri) ^ s));
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[e][0] = fma4(comp(a, e), h0, acc[e][0]);
          acc[e][1] = fma4(comp(a, e), h1, acc[e][1]);
        }
      }
      if constexpr (!VEC) load_h(t + 2);
      store_h(t + 2);
    }
    __syncthreads();   // every warp is done with the tiles
    // the groups' partial U_i H^T, Red[g][r][c], over the freed tiles
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float* d = X + (g * TM + 4 * ri + e) * KP + 4 * ci;
      *reinterpret_cast<float4*>(d) = acc[e][0];
      *reinterpret_cast<float4*>(d + KP / 2) = acc[e][1];
    }
  }

  // sweep 2's first chunk is in flight while W' is formed
  constexpr int RG2 = RC / 4;
  int qr, qj;
  quad_pos<RG2>(qr, qj);
  const int nchunks = (rows + RC - 1) / RC;
  const int nstrips = (n + TN2 - 1) / TN2;
  const int ntiles = nstrips * nchunks;
  float4 qa[4];
  // row i of the quad of chunk t (strip t / nchunks, rows t % nchunks RC ..)
  const auto load_a = [&](int t, int i) {
    const int r0 = t % nchunks * RC, j0 = t / nchunks * TN2;
    qa[i] = load4<VEC>(A + (size_t)r0 * n, n, qr + i, qj,
                       t < ntiles ? min(RC, rows - r0) : 0, j0, min(TN2, n - j0));
  };
  if constexpr (VEC) {
#pragma unroll
    for (int i = 0; i < 4; ++i) load_a(0, i);
  }
  float* Hs = X + 2 * C::U2;    // [KP][TN2]: H of the strip
  const auto stage_h = [&](int s) {   // H rows [0, k) of strip s into Hs
    const int j0 = s * TN2, cols = min(TN2, n - j0);
    float4 v[KP * TN2 / 4 / NT];
#pragma unroll
    for (int i = 0; i < KP * TN2 / 4 / NT; ++i) {
      const int e = tid + NT * i, c = e / (TN2 / 4), jl = 4 * (e % (TN2 / 4));
      v[i] = load4<VEC>(H, n, c, jl, k, j0, cols);
    }
#pragma unroll
    for (int i = 0; i < KP * TN2 / 4 / NT; ++i)
      *reinterpret_cast<float4*>(Hs + 4 * (tid + NT * i)) = v[i];
  };

  // -- W'_i = W_i * (U_i H^T) / (hrs + eps) -----------------------------------
  // from the unrounded f32 W; rows past m and columns past k are exactly 0
  __syncthreads();
  float4 wn[C::NW];
#pragma unroll
  for (int q = 0; q < C::NW; ++q) {
    const int e = tid + NT * q, r = e / (KP / 4), c = 4 * (e % (KP / 4));
    if (r >= TM) break;
    float4 uht = zero4();
#pragma unroll 4
    for (int g = 0; g < C::G1; ++g)
      uht = add4(uht, *reinterpret_cast<const float4*>(X + (g * TM + r) * KP + c));
    float w[4], den[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      w[u] = Wt[(c + u) * TM + r];
      den[u] = (c + u < k ? __ldg(hrs + c + u) : 0.f) + eps;
    }
    wn[q] = make_float4(w[0] * uht.x / den[0], w[1] * uht.y / den[1],
                        w[2] * uht.z / den[2], w[3] * uht.w / den[3]);
  }
  __syncthreads();   // the partial sums and W^T are read
#pragma unroll
  for (int q = 0; q < C::NW; ++q) {
    const int e = tid + NT * q, r = e / (KP / 4), c = 4 * (e % (KP / 4));
    if (r >= TM) break;
    *reinterpret_cast<float4*>(Wr + r * C::LDW + c) = wn[q];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      Wt[(c + u) * TM + r] = comp(wn[q], u);
      if (r < rows && c + u < k) W_out[(size_t)r * k + c + u] = comp(wn[q], u);
    }
  }
  stage_h(0);
  __syncthreads();

  // WTU[c][j .. j + 3] += v: a 16-byte atomic (red.global.add.v4.f32), or
  // scalar ones on the scalar path; nothing past k or n
  const auto add_wtu = [&](int c, int j, float4 v) {
    if (c >= k || j >= n) return;
    float* dst = WTU + (size_t)c * n + j;
    if constexpr (VEC) {
      atomicAdd(reinterpret_cast<float4*>(dst), v);   // j + 3 < n as n % 4 == 0
    } else {
      atomicAdd(dst, v.x);
      if (j + 1 < n) atomicAdd(dst + 1, v.y);
      if (j + 2 < n) atomicAdd(dst + 2, v.z);
      if (j + 3 < n) atomicAdd(dst + 3, v.w);
    }
  };

  // -- sweep 2: WTU += W'_i^T U'_i ---------------------------------------------
  // Thread (cg, jg) sums factor columns 4 cg + (0..3), KP / 2 + 4 cg + (0..3)
  // and columns 4 jg + (0..3) of each strip over all rows of the panel.
  {
    const int jg = tid % (TN2 / C::JT), cg = tid / (TN2 / C::JT);
    float4 acc[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[c] = zero4();
#pragma unroll 1
    for (int t = 0; t < ntiles; ++t) {
      const int s0 = t / nchunks, r0 = t % nchunks * RC;
      float* ut = X + (t & 1) * C::U2;
      if constexpr (!VEC) {
#pragma unroll
        for (int i = 0; i < 4; ++i) load_a(t, i);
      }
      {   // U' of this thread's quad, into ut row-major
        float4 u[4];
        ratio_quad<KP, TM, TN2, VEC>(u, qa, Wt, Hs, r0 + qr, qj, eps);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          *reinterpret_cast<float4*>(ut + (qr + i) * C::LD2 + qj) = u[i];
      }
      if constexpr (VEC && C::EARLY) {
#pragma unroll
        for (int i = 0; i < 4; ++i) load_a(t + 1, i);
      }
      __syncthreads();
#pragma unroll
      for (int rr = 0; rr < RC; ++rr) {
        if constexpr (VEC && !C::EARLY) {
#pragma unroll
          for (int q = 0; q < 4; ++q)
            if (q * RC / 4 == rr) load_a(t + 1, q);   // the next chunk's quad
        }
        __syncwarp();   // keeps ptxas from hoisting the shared loads into spills
        const float* wp = Wr + (r0 + rr) * C::LDW;
        const float4 w0 = *reinterpret_cast<const float4*>(wp + 4 * cg);
        const float4 w1 = *reinterpret_cast<const float4*>(wp + 4 * cg + KP / 2);
        const float4 a = *reinterpret_cast<const float4*>(ut + rr * C::LD2 + 4 * jg);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[e] = fma4(comp(w0, e), a, acc[e]);
          acc[4 + e] = fma4(comp(w1, e), a, acc[4 + e]);
        }
      }
      if (r0 + RC >= rows) {   // the strip is summed over the panel
        const int j = s0 * TN2 + 4 * jg;
#pragma unroll
        for (int cc = 0; cc < 8; ++cc) {
          add_wtu((cc < 4 ? 0 : KP / 2 - 4) + 4 * cg + cc, j, acc[cc]);
          acc[cc] = zero4();
        }
        if (s0 + 1 < nstrips) {   // every warp is past the strip's ratio steps
          stage_h(s0 + 1);
          __syncthreads();
        }
      }
    }
  }
}

template <int KP, bool VEC>
cudaError_t launch(const float* A, const float* W, const float* H,
                   const float* hrs, float eps, int B, int m, int n, int k,
                   float* W_out, float* WTU, cudaStream_t stream) {
  using C = Cfg<KP, VEC>;
  const auto kernel = &fused_mu_kl_f32_kernel<KP, VEC>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::SMEM);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const dim3 grid((m + C::TM - 1) / C::TM, B);
  kernel<<<grid, NT, C::SMEM, stream>>>(A, W, H, hrs, eps, m, n, k, W_out, WTU);
  return cudaGetLastError();
}

template <int KP>
cudaError_t launch_kp(const float* A, const float* W, const float* H,
                      const float* hrs, float eps, int B, int m, int n, int k,
                      float* W_out, float* WTU, cudaStream_t s) {
  // 16-byte loads and vector atomics need every row of A, H and WTU aligned
  const bool vec = n % 4 == 0 &&
      (reinterpret_cast<uintptr_t>(A) | reinterpret_cast<uintptr_t>(H) |
       reinterpret_cast<uintptr_t>(WTU)) % 16 == 0;
  return vec ? launch<KP, true>(A, W, H, hrs, eps, B, m, n, k, W_out, WTU, s)
             : launch<KP, false>(A, W, H, hrs, eps, B, m, n, k, W_out, WTU, s);
}

}  // namespace f32

// bf16 or uint8 A: the first port's kernel
template <typename T>
cudaError_t dispatch(const void* A, const void* W, const void* H,
                     const void* hrs, float eps, int B, int m, int n, int k,
                     void* W_out, void* WTU, cudaStream_t s) {
  if (B < 1 || m < 1 || n < 1 || k < 1) return cudaErrorInvalidValue;
  if (k <= 8) return launch<T, 8>(A, W, H, hrs, eps, B, m, n, k, W_out, WTU, s);
  if (k <= 16) return launch<T, 16>(A, W, H, hrs, eps, B, m, n, k, W_out, WTU, s);
  if (k <= 32) return launch<T, 32>(A, W, H, hrs, eps, B, m, n, k, W_out, WTU, s);
  if (k <= 64) return launch<T, 64>(A, W, H, hrs, eps, B, m, n, k, W_out, WTU, s);
  return cudaErrorInvalidValue;
}

cudaError_t dispatch_f32(const void* A_, const void* W_, const void* H_,
                         const void* hrs_, float eps, int B, int m, int n, int k,
                         void* W_out_, void* WTU_, cudaStream_t s) {
  if (B < 1 || m < 1 || n < 1 || k < 1) return cudaErrorInvalidValue;
  const auto A = static_cast<const float*>(A_), W = static_cast<const float*>(W_),
             H = static_cast<const float*>(H_), hrs = static_cast<const float*>(hrs_);
  const auto W_out = static_cast<float*>(W_out_), WTU = static_cast<float*>(WTU_);
  if (k <= 8) return f32::launch_kp<8>(A, W, H, hrs, eps, B, m, n, k, W_out, WTU, s);
  if (k <= 16) return f32::launch_kp<16>(A, W, H, hrs, eps, B, m, n, k, W_out, WTU, s);
  if (k <= 32) return f32::launch_kp<32>(A, W, H, hrs, eps, B, m, n, k, W_out, WTU, s);
  // 32 < k <= 64: the first port's kernel
  if (k <= 64) return launch<float, 64>(A_, W_, H_, hrs_, eps, B, m, n, k, W_out_, WTU_, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// Plain C interface, bound with ctypes. A is (B, m, n) in f32, bf16 or
// uint8; W and W_out are (B, m, k), H is (B, k, n), hrs is (B, k) and WTU is
// (B, k, n), all f32, contiguous, and WTU zeroed by the caller. Returns the
// CUDA error code of the launch (0 on success).
extern "C" int fused_mu_kl_f32(const void* A, const void* W, const void* H,
                               const void* hrs, float eps, int B, int m, int n,
                               int k, void* W_out, void* WTU, void* stream) {
  return (int)dispatch_f32(A, W, H, hrs, eps, B, m, n, k, W_out, WTU,
                           static_cast<cudaStream_t>(stream));
}

extern "C" int fused_mu_kl_bf16(const void* A, const void* W, const void* H,
                                const void* hrs, float eps, int B, int m, int n,
                                int k, void* W_out, void* WTU, void* stream) {
  return (int)dispatch<__nv_bfloat16>(A, W, H, hrs, eps, B, m, n, k, W_out, WTU,
                                      static_cast<cudaStream_t>(stream));
}

extern "C" int fused_mu_kl_u8(const void* A, const void* W, const void* H,
                              const void* hrs, float eps, int B, int m, int n,
                              int k, void* W_out, void* WTU, void* stream) {
  return (int)dispatch<uint8_t>(A, W, H, hrs, eps, B, m, n, k, W_out, WTU,
                                static_cast<cudaStream_t>(stream));
}

extern "C" const char* fused_mu_kl_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
