// K3: one KL-MU iteration, every sum in a fixed order.
//
// Replaces pydnmfk_tpu/ops/fused_kl.py::_fused_kl_kernel (launched by
// _fused_kl_pass). For each row panel A_i of each member b (pass 1, this
// file):
//
//     U_i   = A_i / (W_i H + eps)
//     W'_i  = W_i * (U_i H^T) / (hrs + eps)     written to W_out
//
// with hrs = rowsum(H). Pass 2, WTU = W'^T U' with U' = A / (W' H + eps)
// (k x n), is K2b's product on (A, W', H) and walks column strips of A over
// all rows in order, in csrc/kl_ratio.cu (K2b's kernels for an f32 A;
// strip::wtu_strip_kernel in its ratio mode for a bf16, f16 or uint8 A),
// launched by the same wrapper (ops/fused_kl.py). The H update (H * WTU /
// (colsum(W') + eps)) and hrs are k-sized and stay in PyTorch, as the TPU
// version leaves them to XLA.
//
// One block owns a row panel of one member (grid = row panels x members, so
// the member stack of an NMFk ensemble is one launch). W'_i needs U_i H^T
// over all of n before any U'_i exists, so A is read twice, once a pass.
// The TPU kernel carries WTU from one grid step to the next in panel
// order; Hopper runs the panels in parallel, and an atomic carry would sum
// in an order that changes from run to run (a member's error moved by up
// to 1.18e-3 over an NMFk sweep, and a cluster flipped), so pass 2 owns
// each output column instead: the same call on the same inputs gives the
// same bits, and a member's bits do not depend on how many members share
// its launch. A is never padded or copied (the JAX caller pads it to its
// row tile, an 8.8 GB copy at full size): the ragged edges of m and n load
// as zeros, which give U = 0 and W' = 0. k is padded to 8, 16, 32 or 64
// with zeros inside the block (MAX_K = 64 in ops/fused_kl.py).
//
// Which A takes which pass-1 kernel:
// - f32 A, k <= 32: f32::fused_mu_kl_f32_kernel (C entry fused_mu_kl_f32),
//   register micro-tiles on the CUDA cores.
// - f32 A, 32 < k <= 64: tf::fused_mu_kl_tf32_kernel (the same C entry),
//   3xTF32 products on the tensor cores.
// - bf16, f16 or uint8 A, every k <= 64: tc::fused_mu_kl_tc_kernel (C
//   entries fused_mu_kl_bf16, fused_mu_kl_f16 and fused_mu_kl_u8), on the
//   bf16 tensor cores.
// Each kernel's design note stands above it.
//
// Types (pydnmfk_tpu/ops/fused_kl.py:52-81, matmul_compute_dtype off the
// TPU): with an f32 A every product is true f32. With a bf16, f16 or uint8
// A the products take bf16 operands with f32 sums: W is rounded for W H and
// U for U H^T (and in pass 2 W' for W' H, W' and U' for W'^T U'); H arrives
// rounded to bf16 (the wrapper casts it). A is widened exactly to f32 (every uint8 and
// f16 value is an f32 value); the ratios and the W' update are f32. The JAX
// package rounds the operands of an f16 A to f16; bf16 keeps U's range:
// with f32 factors eps is 1.2e-7, and U = A / (W H + eps) can pass f16's
// 65504.
//
// What bounds the two passes together: 8 m n k operations (four products
// of 2 m n k, two a pass) against A's bytes. At f32 that is the operations:
// on the CUDA cores at k <= 32 (8.45 ms at 57600 x 38400, k = 32, at 67
// TFLOP/s), on the tensor cores at three TF32 products a product past 32
// (6.86 ms at k = 64, at 165 TFLOP/s); at bf16 or uint8 the operations fit
// the tensor cores, and the bytes of A bound it (1.32 ms bf16, 0.66 ms
// uint8; A read twice, once a pass: 2.64 and 1.32 ms).
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

namespace {

// ---------------------------------------------------------------------------
// The f32 kernel: register micro-tiles, 16-byte loads in flight, 128-row
// panels.
//
// What bounds it: 4 k FMAs per element of A on the CUDA cores (at k <= 32;
// past 32 the 3xTF32 kernel below carries f32 accuracy onto the tensor
// cores), against A read once (2.64 ms at 57600 x 38400 against 4.23 ms of
// FMAs at k = 32; at k = 8 the bytes bound it). So the FMA pipe has to be
// kept busy: each inner loop is an outer product on registers fed by float4
// shared-memory loads that most lanes of a warp share (broadcasts), every
// operand is loaded once per tile, and no loop reads a scalar from shared
// memory per FMA. What each part does:
// - The ratio step: a thread owns a quad of 4 rows x 4 columns of the tile.
//   Its A values come straight from device memory into registers (one
//   16-byte load per row), issued a tile ahead, so A never passes through
//   shared memory. P = W_i H_j is a 4 x 4 outer product per factor c: one
//   float4 of the transposed W panel (4 rows at c) and one of the H tile (4
//   columns at c) per 16 FMAs; a warp spans up to 4 row quads x 8 column
//   quads, so each load is 1 wavefront. P starts at eps, and U = A / P
//   comes by __fdividef in the registers that hold P (IEEE `/` is 11-37 %
//   slower in K1 and K2, with the same errors).
// - U_i H^T (TM x KP, a sum over n), on tiles of TN1 columns (TM x TN1 = 16
//   NT: one quad a thread): U goes once into shared memory, transposed and
//   XOR-swizzled as K1-f32 holds A (row r of column j at r ^ sw(j)), and
//   U H^T is a register-tiled product: a thread keeps 4 rows x 8 factors
//   over all of n (one float4 of U^T and two of H^T per 32 FMAs; 8 x 8 tiles
//   take 128 registers and spill beside the ratio step), the threads split
//   each tile's columns into G1 groups, and the groups' partial sums meet
//   once per panel in shared memory. H's tile is kept twice, row-major for
//   W H and transposed for U H^T.
// - W'_i = W_i * (U_i H^T) / (hrs + eps) from the unrounded f32 W, with an
//   IEEE division on the k-sized denominator, written to W_out.
// - Loads in flight: the next tile's A quad is issued right after the
//   ratio step has read the current one (at KP = 16 spread over the
//   product instead), the H tiles two tiles ahead; U tiles are
//   double-buffered and H tiles triple-buffered in shared memory, so each
//   tile costs one block barrier. Holding a second tile of A in registers,
//   a cp.async ring for A, L2 prefetches and keeping U in registers at
//   KP = 8 (K2's scheme) were no faster.
// - VEC: 16-byte loads when n % 4 == 0 and A and H are 16-byte aligned;
//   otherwise the same loops load element by element (masked).
// - Panels of TM = 128 rows: half the H tiles read from L2 of 64-row ones.
//   256 threads, at most 128 registers and under 100 KB of shared memory,
//   so two blocks fit an SM. On the 16-byte path at KP = 8 the panels are
//   64 rows: the 14400-row member stack makes 10 x 225 blocks (8.5 waves)
//   instead of 10 x 113 (4.3, the last a quarter full).
// Past k = 32 an f32 A takes the 3xTF32 kernel (namespace tf, below).

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
  // which spills otherwise) spread over the U H^T product
  static constexpr bool EARLY = KP != 16;
  // sweep 1: tiles of TN1 columns; U H^T takes 4 rows x 8 factors a thread
  static constexpr int TN1 = 16 * NT / TM;
  static constexpr int HW = cmax(KP, 32);           // row width of the H^T tile
  static constexpr int T1 = TM / 4 * (KP / 8);      // threads per column group
  static constexpr int G1 = NT / T1;                // column groups
  static constexpr int JPG = TN1 / G1;              // columns per group and tile
  static constexpr int NW = (TM * KP / 4 + NT - 1) / NT;   // float4s of W' a thread
  // shared memory, in floats: region X holds the U^T tiles (two) and H
  // tiles (three, each row-major and transposed), or the groups' partial
  // sums; then the transposed W panel
  static constexpr int U1 = TN1 * TM, H1 = KP * TN1 + TN1 * HW;
  static constexpr int RED = G1 * TM * KP;
  static constexpr int X = cmax(2 * U1 + 3 * H1, RED);
  static constexpr size_t SMEM = sizeof(float) * (X + KP * TM);
  static_assert(T1 * G1 == NT && JPG % 4 == 0 && KP * TN1 <= 4 * NT, "tiles");
  static_assert(TM * TN1 == 16 * NT, "one quad a thread");
  static_assert(NW >= 1 && SMEM <= 110 * 1024 && (X + KP * TM) % 4 == 0,
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
                       float eps, int m, int n, int k, float* __restrict__ W_out) {
  using C = Cfg<KP, VEC>;
  constexpr int TM = C::TM, TN1 = C::TN1;
  extern __shared__ float4 smem4[];
  float* X = reinterpret_cast<float*>(smem4);   // tiles, or the partial sums
  float* Wt = X + C::X;                          // [KP][TM]: W^T

  const int b = blockIdx.y;
  const int row0 = blockIdx.x * TM;
  const int rows = min(TM, m - row0);
  A += (size_t)b * m * n + (size_t)row0 * n;
  W += ((size_t)b * m + row0) * k;
  W_out += ((size_t)b * m + row0) * k;
  H += (size_t)b * k * n;
  hrs += (size_t)b * k;
  const int tid = threadIdx.x;

  // the W panel, transposed; zero past the panel's rows and past k
  for (int e = tid; e < TM * KP; e += NT) {
    const int c = e / TM, r = e % TM;
    Wt[e] = (r < rows && c < k) ? __ldg(W + (size_t)r * k + c) : 0.f;
  }

  // -- U_i H^T ----------------------------------------------------------------
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

  // -- W'_i = W_i * (U_i H^T) / (hrs + eps) into W_out ------------------------
  // from the unrounded f32 W (rolled: unrolled, it spills at KP = 32)
  __syncthreads();
#pragma unroll 1
  for (int q = 0; q < C::NW; ++q) {
    const int e = tid + NT * q, r = e / (KP / 4), c = 4 * (e % (KP / 4));
    if (r >= rows) break;
    float4 uht = zero4();
#pragma unroll 4
    for (int g = 0; g < C::G1; ++g)
      uht = add4(uht, *reinterpret_cast<const float4*>(X + (g * TM + r) * KP + c));
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (c + u >= k) break;
      const float den = __ldg(hrs + c + u) + eps;
      W_out[(size_t)r * k + c + u] = Wt[(c + u) * TM + r] * comp(uht, u) / den;
    }
  }
}

template <int KP, bool VEC>
cudaError_t launch(const float* A, const float* W, const float* H,
                   const float* hrs, float eps, int B, int m, int n, int k,
                   float* W_out, cudaStream_t stream) {
  using C = Cfg<KP, VEC>;
  const auto kernel = &fused_mu_kl_f32_kernel<KP, VEC>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::SMEM);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const dim3 grid((m + C::TM - 1) / C::TM, B);
  kernel<<<grid, NT, C::SMEM, stream>>>(A, W, H, hrs, eps, m, n, k, W_out);
  return cudaGetLastError();
}

template <int KP>
cudaError_t launch_kp(const float* A, const float* W, const float* H,
                      const float* hrs, float eps, int B, int m, int n, int k,
                      float* W_out, cudaStream_t s) {
  // 16-byte loads need every row of A and H aligned
  const bool vec = n % 4 == 0 &&
      (reinterpret_cast<uintptr_t>(A) | reinterpret_cast<uintptr_t>(H)) % 16 == 0;
  return vec ? launch<KP, true>(A, W, H, hrs, eps, B, m, n, k, W_out, s)
             : launch<KP, false>(A, W, H, hrs, eps, B, m, n, k, W_out, s);
}

}  // namespace f32

// ---------------------------------------------------------------------------
// The tensor-core kernel: a bf16, f16 or uint8 A at every k <= 64.
//
// Numbers: mma.sync with bf16 operands and f32 sums computes the JAX rule
// (see "Types" above) up to the order of the sums: W and U are rounded to
// bf16 as they become operands, H arrives as bf16, A is widened exactly.
// P = W H starts at eps in its f32 accumulators, U = A / P comes by
// __fdividef (as in the f32 kernel), and W' from the unrounded f32 W with an
// IEEE division on the k-sized denominator.
//
// What bounds it: 4 k flops per element of A, 64 per byte of a bf16 A at
// k = 32 (128 for uint8), below the card's ~295 bf16 tensor flops per byte:
// the bytes bound it, A read once. Beside the bytes, each element costs
// about a dozen instructions on the CUDA cores and the tensor pipe (its
// share of an ldmatrix, of two or more mma, an unpack, a division, half a
// pack), so the products must not go through shared memory and U must never
// leave registers.
// - Loads are K1-tc's (csrc/fused_mu_fro.cu; the tile helpers of both are
//   in csrc/tc_tiles.cuh): a block of 256 threads owns a panel of TM rows
//   of one member; tiles of 128-byte rows (64 bf16 columns, or 128 uint8
//   columns as two 64-column sub-tiles) land by cp.async.cg 16-byte
//   copies, zero-filled past the edges, in a ring of 3 stages, each with
//   its bf16 H tile (the same columns, rows [0, k)); 16-byte chunks are
//   XOR-swizzled by row so that the 8 rows an ldmatrix (or 8 lanes) reads
//   fall on distinct banks.
// - A uint8 A is not widened in shared memory (K1's way): each thread reads
//   its bytes at the accumulator positions straight from the landed tile
//   (a 16-bit load per pair) and widens them exactly to f32 in registers, a
//   byte permute and a subtraction each; a bf16 tile widened first measured
//   14-19 % slower. A bf16 or f16 A comes by ldmatrix, whose fragment layout
//   is that of two n8 accumulator tiles, and is widened exactly in
//   registers (a shift for bf16, a conversion for f16); an f16 A lands as a
//   bf16 one does.
// - Panels: TM = 128 rows at KP <= 16 (two blocks an SM), 256 at KP >= 32
//   (one; 128 at KP = 64 on the element-by-element path, which spills at
//   256); a uint8 A lands 64 columns at KP = 64 (64-byte rows, swizzled by
//   r & 3). These were measured when one kernel also held the second sweep
//   over W'^T U' (PERF.md) and stand as they were; the
//   member's H is offset where a tile's copies are issued, so that its
//   pointer is not held across the loop.
// - U_i H^T (TM x KP, a sum over n): warp w owns rows TM / 8 w .. (one or
//   two m16 tiles) and every column. Per 16 columns: P = W H on mma (W's
//   bf16 fragments held in registers for the loop, H's by ldmatrix.trans
//   from the H tile; m16n8k8 at KP = 8, so k is not padded to 16); A's
//   values at the accumulator positions (above); U = A / P in the
//   accumulators; the two n8 tiles packed to bf16 are the m16k16 A operand
//   of U H^T (flash attention's register reuse), with H's fragments by
//   ldmatrix from the same H tile. U H^T stays in f32 registers over all of
//   n; nothing is reduced across warps.
// - W' in f32 on the CUDA cores, written to W_out.
// - VEC: 16-byte copies when n % 8 == 0 (bf16, f16) or n % 16 == 0 (uint8)
//   and A and H are 16-byte aligned; otherwise the same tiles are filled
//   element by element.

namespace tc {

constexpr int NT = 256;   // threads per block (8 warps)
constexpr int TN = 64;    // columns of a bf16 (sub-)tile: 128-byte rows

template <typename T, int KP, bool VEC>
struct Cfg {
  static constexpr bool U8 = std::is_same<T, uint8_t>::value;
  // columns of a landed tile: a uint8 A lands 128 (two 64-column sub-tiles)
  // at KP <= 32, and 64 at KP = 64
  static constexpr int TNP = U8 && KP <= 32 ? 2 * TN : TN;
  static constexpr int SUB = TNP / TN;              // 64-column sub-tiles in it
  // rows per panel, and blocks an SM: two blocks of 128 rows at KP <= 16,
  // one of 256 at KP >= 32 (128 at KP = 64 on the element-by-element path,
  // whose copy loops spill beside 256 rows' sums)
  static constexpr int TM = KP <= 16 || (KP == 64 && !VEC) ? 128 : 256;
  static constexpr int MINB = KP <= 16 ? 2 : 1;
  static constexpr int S = 3;                       // stages of the ring
  static constexpr int MT = TM / 8 / 16;            // m16 tiles a warp
  static constexpr int KS = KP >= 16 ? KP / 16 : 1; // k-steps over the factors
  static constexpr int NF = KP / 8;                 // n8 tiles of factors
  static constexpr int LDWP = KP == 8 ? 24 : KP + 8;   // bf16 W panel row stride
  static constexpr int A_BYTES = TM * TNP * (int)sizeof(T);   // a landed A tile
  static constexpr int STAGE = A_BYTES + SUB * KP * 128;      // and its bf16 H
  // byte offsets in dynamic shared memory: the ring, then the W panel
  static constexpr int O_WP = S * STAGE;
  static constexpr size_t SMEM = O_WP + TM * LDWP * 2;
  static_assert(O_WP % 16 == 0, "alignment");
  static_assert(SMEM <= (MINB == 1 ? 227 : 113) * 1024, "shared memory");
};

#include "tc_tiles.cuh"

// byte i of w as f32, exactly: a byte permute makes byte x the f32 2^23 + x,
// one subtraction leaves x
__device__ __forceinline__ float byte_f32(uint32_t w, int i) {
  return __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7440 + i)) - 8388608.f;
}

// Starts the copy of the landed tile of columns j0 .. j0 + TNP - 1 of the
// panel (rows [0, rows)) and of H's rows [0, k) of those columns (H of the
// block's member, blockIdx.y) into
// `stage`. A bf16 A lands as a swizzled tile of 64 columns, a uint8 A as
// rows of 128 bytes, swizzled; H as TNP / 64 swizzled tiles of KP rows. VEC:
// cp.async, to be waited for; otherwise plain copies.
template <typename T, int KP, bool VEC>
__device__ __forceinline__ void load_tile(unsigned char* stage, const T* __restrict__ A,
                                          const __nv_bfloat16* __restrict__ H,
                                          int n, int k, int rows, int j0) {
  using C = Cfg<T, KP, VEC>;
  const int tid = threadIdx.x;
  unsigned char* hs = stage + C::A_BYTES;
  H += (size_t)blockIdx.y * k * n;   // the member's H, not held across the sweeps
  if constexpr (VEC) {
    const uint32_t s = smem_u32(stage);
    constexpr int CW = 16 / (int)sizeof(T);      // columns per 16-byte chunk
    constexpr int CPR = C::TNP / CW;             // chunks per row
    // thread tid copies chunk tid % CPR of rows tid / CPR + i NT / CPR: one
    // running source pointer (row pointers computed ahead spill), and the
    // same swizzle in every row it copies
    constexpr int RS = NT / CPR;
    const int r0 = tid / CPR, ca = tid % CPR, ja = j0 + CW * ca;
    const T* src = A + (size_t)r0 * n + ja;
    const uint32_t d0 = s + (C::U8 ? u8_off<C::TNP>(r0, ca) : chunk_off(r0, ca));
#pragma unroll
    for (int i = 0; i < C::TM / RS; ++i) {
      const bool ok = r0 + RS * i < rows && ja < n;
      cp_async16(d0 + RS * i * C::TNP * (int)sizeof(T), ok ? src : A, ok);
      src += (size_t)RS * n;
    }
    const uint32_t sh = smem_u32(hs);
    for (int e = tid; e < C::SUB * KP * 8; e += NT) {
      const int u = e / (KP * 8), c = (e >> 3) % KP, ch = e & 7;
      const int j = j0 + TN * u + 8 * ch;
      const bool ok = c < k && j < n;
      cp_async16(sh + u * KP * 128 + chunk_off(c, ch), ok ? H + (size_t)c * n + j : H, ok);
    }
  } else {
#pragma unroll 1
    for (int e = tid; e < C::TM * C::TNP; e += NT) {
      const int r = e / C::TNP, j = e % C::TNP;
      const bool ok = r < rows && j0 + j < n;
      if constexpr (C::U8) {
        stage[u8_off<C::TNP>(r, j >> 4) + (j & 15)] = ok ? A[(size_t)r * n + j0 + j] : 0;
      } else {
        *reinterpret_cast<unsigned short*>(stage + chunk_off(r, j >> 3) + 2 * (j & 7)) =
            ok ? bits16(A[(size_t)r * n + j0 + j]) : 0;
      }
    }
#pragma unroll 1
    for (int e = tid; e < C::SUB * KP * TN; e += NT) {
      const int u = e / (KP * TN), c = e / TN % KP, j = e % TN, jg = j0 + TN * u + j;
      const bool ok = c < k && jg < n;
      *reinterpret_cast<unsigned short*>(hs + u * KP * 128 + chunk_off(c, j >> 3) +
                                         2 * (j & 7)) =
          ok ? __bfloat16_as_ushort(H[(size_t)c * n + jg]) : 0;
    }
  }
}

template <typename T, int KP, bool VEC>
__global__ void __launch_bounds__(NT, (Cfg<T, KP, VEC>::MINB))
fused_mu_kl_tc_kernel(const T* __restrict__ A, const float* __restrict__ W,
                      const __nv_bfloat16* __restrict__ H,
                      const float* __restrict__ hrs, float eps, int m, int n,
                      int k, float* __restrict__ W_out) {
  using C = Cfg<T, KP, VEC>;
  constexpr int TM = C::TM, S = C::S, MT = C::MT, KS = C::KS, NF = C::NF;
  constexpr int LDWP = C::LDWP;
  extern __shared__ uint4 smem_tc[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(smem_tc);
  __nv_bfloat16* Wp = reinterpret_cast<__nv_bfloat16*>(sm + C::O_WP);
  const uint32_t wp_s = smem_u32(Wp);

  const int b = blockIdx.y;
  const int row0 = blockIdx.x * TM;
  const int rows = min(TM, m - row0);
  A += (size_t)b * m * n + (size_t)row0 * n;
  W += ((size_t)b * m + row0) * k;
  W_out += ((size_t)b * m + row0) * k;
  hrs += (size_t)b * k;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;   // a fragment's row and column pair
  // an ldmatrix lane's row in its 8 x 8 matrix, and two bits of the matrix
  const int l7 = lane & 7, q1 = (lane >> 3) & 1, q2 = lane >> 4;

  // landed tiles of TNP columns, np of them
  const int np = (n + C::TNP - 1) / C::TNP;
  const auto load = [&](int p) {   // tile p, into stage p % S
    load_tile<T, KP, VEC>(sm + (p % S) * C::STAGE, A, H, n, k, rows, p * C::TNP);
  };
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < np) load(s);
    cp_async_commit();
  }

  // the W panel rounded to bf16, zero past the panel's rows and past k
  for (int e = tid; e < TM * KP / 2; e += NT) {
    const int r = e / (KP / 2), c = 2 * (e % (KP / 2));
    const bool in = r < rows;
    const float w0 = in && c < k ? __ldg(W + (size_t)r * k + c) : 0.f;
    const float w1 = in && c + 1 < k ? __ldg(W + (size_t)r * k + c + 1) : 0.f;
    *reinterpret_cast<uint32_t*>(Wp + r * LDWP + c) = bf16x2(w0, w1);
  }
  __syncthreads();

  // waits for tile t, starts the copy of tile t + S - 1 into the stage that
  // tile t - 1 freed, and returns tile t's stage
  const auto next_tile = [&](int t) {
    cp_async_wait<S - 2>();      // tile t has landed
    __syncthreads();             // and every warp is done with tile t - 1
    if (t + S - 1 < np) load(t + S - 1);
    cp_async_commit();
    return sm + t % S * C::STAGE;
  };

  // -- U H^T over all columns ----------------------------------------------------
  // Warp w owns rows wrow .. wrow + 31: its W fragments (A operand, M =
  // rows, K = factors) and its U H^T sums stay in registers.
  const int wrow = warp * (TM / 8);
  {
    uint32_t wf[MT][KS][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        const int r = wrow + 16 * i + q1 * 8 + l7;
        if constexpr (KP == 8) {
          ldsm_x2(wp_s + 2 * r * LDWP, wf[i][0][0], wf[i][0][1]);
        } else {
          ldsm_x4(wp_s + 2 * (r * LDWP + 16 * ks + q2 * 8), wf[i][ks]);
        }
      }
    float acc[MT][NF][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int f = 0; f < NF; ++f)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][f][e] = 0.f;

#pragma unroll 1
    for (int t = 0; t < np; ++t) {
      unsigned char* st = next_tile(t);
#pragma unroll
      for (int u = 0; u < C::SUB; ++u) {
        const uint32_t a_s = smem_u32(st);
        const uint32_t h_s = smem_u32(st + C::A_BYTES + u * KP * 128);
#pragma unroll
        for (int kk = 0; kk < TN / 16; ++kk) {
          __syncwarp();   // keeps ptxas from hoisting the next steps' loads into spills
          // H's fragments for these 16 columns: hp the B operand of W H (K =
          // factors, N = columns), hu that of U H^T (K = columns, N = factors)
          uint32_t hp[KS][4], hu[KS][4];
          if constexpr (KP == 8) {
            const uint32_t ad = h_s + chunk_off(l7, 2 * kk + q1);
            ldsm_x2_t(ad, hp[0][0], hp[0][1]);
            ldsm_x2(ad, hu[0][0], hu[0][1]);
          } else {
#pragma unroll
            for (int ks = 0; ks < KS; ++ks) {
              ldsm_x4_t(h_s + chunk_off(16 * ks + q1 * 8 + l7, 2 * kk + q2), hp[ks]);
              ldsm_x4(h_s + chunk_off(16 * ks + q2 * 8 + l7, 2 * kk + q1), hu[ks]);
            }
          }
#pragma unroll
          for (int i = 0; i < MT; ++i) {
            // A at the accumulator positions: rows g, g + 8 of the m16 tile,
            // columns 2 t4, 2 t4 + 1 of each n8 tile
            float a[2][4];
            if constexpr (C::U8) {   // 16-bit loads of two bytes, widened exactly
              const unsigned char* q =
                  st + u8_off<C::TNP>(wrow + 16 * i + g, 4 * u + kk) + 2 * t4;
#pragma unroll
              for (int nt = 0; nt < 2; ++nt) {
                const uint32_t w0 = *reinterpret_cast<const unsigned short*>(q + 8 * nt);
                const uint32_t w1 =
                    *reinterpret_cast<const unsigned short*>(q + 8 * nt + 8 * C::TNP);
                a[nt][0] = byte_f32(w0, 0);
                a[nt][1] = byte_f32(w0, 1);
                a[nt][2] = byte_f32(w1, 0);
                a[nt][3] = byte_f32(w1, 1);
              }
            } else {   // one ldmatrix: its fragment is that of the two n8 tiles
              uint32_t x[4];
              ldsm_x4(a_s + chunk_off(wrow + 16 * i + q1 * 8 + l7, 2 * kk + q2), x);
              unpack2<T>(x[0], a[0][0], a[0][1]);
              unpack2<T>(x[1], a[0][2], a[0][3]);
              unpack2<T>(x[2], a[1][0], a[1][1]);
              unpack2<T>(x[3], a[1][2], a[1][3]);
            }
            uint32_t ua[4];
            float p[2][4];
#pragma unroll
            for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
              for (int e = 0; e < 4; ++e) p[nt][e] = eps;
              if constexpr (KP == 8) {
                mma_bf16_k8(p[nt], wf[i][0][0], wf[i][0][1], hp[0][nt]);
              } else {
#pragma unroll
                for (int ks = 0; ks < KS; ++ks)
                  mma_bf16(p[nt], wf[i][ks], hp[ks][2 * nt], hp[ks][2 * nt + 1]);
              }
            }
            ratio_block(ua, a, p);
#pragma unroll
            for (int f = 0; f < NF; ++f) {
              if constexpr (KP == 8) {
                mma_bf16(acc[i][f], ua, hu[0][0], hu[0][1]);
              } else {
                mma_bf16(acc[i][f], ua, hu[f >> 1][2 * (f & 1)], hu[f >> 1][2 * (f & 1) + 1]);
              }
            }
          }
        }
      }
    }

    // -- W' = W * (U H^T) / (hrs + eps) on this warp's rows ------------------
    // element e of fragment (i, f): row wrow + 16 i + g + 8 (e >> 1), factor
    // column 8 f + 2 t4 + (e & 1). The f32 W comes from global memory (L2);
    // rows past m and columns past k are not written.
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      const int c = 8 * f + 2 * t4;
      const float d0 = (c < k ? __ldg(hrs + c) : 0.f) + eps;
      const float d1 = (c + 1 < k ? __ldg(hrs + c + 1) : 0.f) + eps;
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = wrow + 16 * i + g + 8 * h;
          const bool in = r < rows;
          const float w0 = in && c < k ? __ldg(W + (size_t)r * k + c) : 0.f;
          const float w1 = in && c + 1 < k ? __ldg(W + (size_t)r * k + c + 1) : 0.f;
          if (in) {
            if (c < k) W_out[(size_t)r * k + c] = w0 * acc[i][f][2 * h] / d0;
            if (c + 1 < k) W_out[(size_t)r * k + c + 1] = w1 * acc[i][f][2 * h + 1] / d1;
          }
        }
    }
  }
}


template <typename T, int KP, bool VEC>
cudaError_t launch(const T* A, const float* W, const __nv_bfloat16* H,
                   const float* hrs, float eps, int B, int m, int n, int k,
                   float* W_out, cudaStream_t stream) {
  using C = Cfg<T, KP, VEC>;
  const auto kernel = &fused_mu_kl_tc_kernel<T, KP, VEC>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((m + C::TM - 1) / C::TM, B);
  kernel<<<grid, NT, C::SMEM, stream>>>(A, W, H, hrs, eps, m, n, k, W_out);
  return cudaGetLastError();
}

template <typename T, int KP>
cudaError_t launch_kp(const T* A, const float* W, const __nv_bfloat16* H,
                      const float* hrs, float eps, int B, int m, int n, int k,
                      float* W_out, cudaStream_t s) {
  // 16-byte copies need every row of A and H aligned
  const bool vec = n % (16 / (int)sizeof(T)) == 0 &&
      (reinterpret_cast<uintptr_t>(A) | reinterpret_cast<uintptr_t>(H)) % 16 == 0;
  return vec ? launch<T, KP, true>(A, W, H, hrs, eps, B, m, n, k, W_out, s)
             : launch<T, KP, false>(A, W, H, hrs, eps, B, m, n, k, W_out, s);
}

}  // namespace tc

// ---------------------------------------------------------------------------
// The f32 kernel past k = 32: 3xTF32 products on the tensor cores (KP = 64).
//
// Numbers: each f32 operand is split into a TF32 hi part and the remainder
// (tc::split_tf32), and a product takes three TF32 mma.sync (hi lo, lo hi,
// hi hi) with f32 sums: f32 accuracy at 165 TFLOP/s, against 67 on the
// CUDA cores. The tensor cores do not round their f32 sums to nearest, so
// no accumulator takes a long chain: every sum over columns (U H^T) is 12
// mma from zero, added into f32 register sums; W H is 24 mma from zero over
// the 64 factors (as K2's 3xTF32 kernels, csrc/kl_ratio.cu). U = A / (P +
// eps) by __fdividef, W' in f32 on the CUDA cores from the unrounded W with
// an IEEE division on the k-sized denominator, as in the kernels above.
//
// What bounds it: 4 m n k operations at the 3xTF32 rate (3.43 ms at 57600 x
// 38400, k = 64) against A read once (2.64 ms). Beside the mma, the
// operands' splits and shared-memory loads take issue slots, so H's tiles,
// which every warp reads, are split once, as (hi, lo) pairs; W's fragments,
// which a warp keeps in registers, are split (64 registers).
// - A block of 256 threads (8 warps) owns a panel of TM = 128 rows of one
//   member, one block an SM (up to 255 registers a thread). A arrives by
//   cp.async, zero-filled past the edges, in a ring of 3 stages of 128 rows
//   x 32 columns.
// - U H^T (a sum over n): warp w owns rows 16 w .. 16 w + 15 and every
//   factor. Per tile, W H for the four n8 tiles of columns (four
//   accumulators a k-step, so that no mma waits on the one before), U =
//   A / (W H + eps) in the accumulators, split, as the A operand of U H^T
//   (the accumulator's columns 2t, 2t + 1 at positions t, t + 4 of the
//   reduction), and U H^T by groups of four output tiles. H's tile is
//   loaded into registers three tiles ahead and stored, split into (hi,
//   lo) pairs, two tiles ahead in the spare room of its ring stage,
//   swizzled so that both of its reads (by factor rows for W H, by column
//   pairs for U H^T) meet no bank conflict.
// - W' = W * (U H^T) / (hrs + eps) from the warp's sums, written to W_out.
// - k < 64 pads with zeros; W H skips the k-steps past k, U H^T the groups
//   of output tiles past k.
// - VEC: 16-byte copies and loads when n % 4 == 0 and A and H are 16-byte
//   aligned; otherwise element by element.
// The block's shape was measured when one kernel also held the second sweep
// over W'^T U' and stands as it was.

namespace tf {

constexpr int NW = 8;                // warps a block
constexpr int NT = 32 * NW;          // threads per block
constexpr int MINB = NW == 8 ? 1 : 2;   // blocks an SM
constexpr int KP = 64;               // factor columns, k padded with zeros
constexpr int TM = 16 * NW;          // rows per panel, 16 a warp in sweep 1
constexpr int TN1 = 32;              // sweep 1: columns per tile, 4 n8 tiles
constexpr int LDA1 = TN1 + 8;        // row stride of an A tile
constexpr int S = 3;                 // stages of the ring
// a stage, in floats: the A tile and its split H tile (KP x TN1 pairs)
constexpr int O_H1 = TM * LDA1;
constexpr int STAGE = O_H1 + 2 * KP * TN1;
constexpr size_t SMEM = sizeof(float) * S * STAGE;
static_assert(SMEM <= (MINB == 1 ? 227 : 113) * 1024 && O_H1 % 4 == 0 && STAGE % 4 == 0,
              "shared memory");
// sweep 1's H tile: float4s a thread stages
constexpr int HQ = KP * TN1 / 4 / NT;

// pair slot of element (r, c) of a split H tile (rows of TN1 pairs): bits
// 2-3 of c (its 32-byte granule in a 128-byte line) flipped by r, so that 4
// rows r .. r + 3 at 4 pairs each, and 2 rows r, r + 1 (r even) at 8 pairs
// each, fall on distinct banks
__device__ __forceinline__ int h1_slot(int r, int c) {
  return r * TN1 + (c ^ ((((r & 1) << 1) | ((r >> 1) & 1)) << 2));
}

__device__ __forceinline__ float2 split2(float x) {
  uint32_t h, l;
  tc::split_tf32(x, h, l);
  return make_float2(__uint_as_float(h), __uint_as_float(l));
}

template <bool VEC>
__global__ void __launch_bounds__(NT, MINB)
fused_mu_kl_tf32_kernel(const float* __restrict__ A, const float* __restrict__ W,
                        const float* __restrict__ H, const float* __restrict__ hrs,
                        float eps, int m, int n, int k, float* __restrict__ W_out) {
  extern __shared__ float4 smem_tf[];
  float* ring = reinterpret_cast<float*>(smem_tf);

  const int b = blockIdx.y;
  const int row0 = blockIdx.x * TM;
  const int rows = min(TM, m - row0);
  A += (size_t)b * m * n + (size_t)row0 * n;
  W += ((size_t)b * m + row0) * k;
  W_out += ((size_t)b * m + row0) * k;
  H += (size_t)b * k * n;
  hrs += (size_t)b * k;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int nks = (k + 7) / 8;         // k-steps of 8 factors with any of k
  const int ngr = (k + 31) / 32;       // groups of 32 factors with any of k

  // ring tiles of TN1 columns, np1 of them: rows [0, rows) x columns [j0,
  // j0 + TN1) of A into a stage (row stride LDA1), zeros past the panel's
  // rows and past n; 8 chunks of 4 columns a row
  const int np1 = (n + TN1 - 1) / TN1;
  const auto load = [&](int p) {   // tile p, into stage p % S
    const uint32_t d = tc::smem_u32(ring + p % S * STAGE);
    const int j0 = p * TN1;
    if constexpr (VEC) {
      for (int i = 0; i < TM * TN1 / 4 / NT; ++i) {
        const int e = tid + NT * i, r = e >> 3, c = 4 * (e & 7);
        const bool ok = r < rows && j0 + c < n;
        tc::cp_async16(d + 4 * (r * LDA1 + c), ok ? A + (size_t)r * n + j0 + c : A, ok);
      }
    } else {
      for (int i = 0; i < TM * TN1 / NT; ++i) {
        const int e = tid + NT * i, r = e >> 5, c = e & 31;
        const bool ok = r < rows && j0 + c < n;
        tc::cp_async_n<4>(d + 4 * (r * LDA1 + c), ok ? A + (size_t)r * n + j0 + c : A, ok);
      }
    }
  };
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < np1) load(s);
    tc::cp_async_commit();
  }
  // waits for tile p, starts the copy of tile p + S - 1 into the stage that
  // tile p - 1 freed, and returns tile p's stage
  const auto next_tile = [&](int p) {
    tc::cp_async_wait<S - 2>();
    __syncthreads();
    if (p + S - 1 < np1) load(p + S - 1);
    tc::cp_async_commit();
    return ring + p % S * STAGE;
  };

  // -- U H^T over all columns -------------------------------------------------------
  {
    const int rl = 16 * warp + g;      // this lane's rows rl, rl + 8
    // W's fragments, split (A operand of W H: M = rows, K = factors 8 ks +
    // t at position t, 8 ks + t + 4 at t + 4)
    uint32_t wh[KP / 8][4], wl[KP / 8][4];
#pragma unroll
    for (int ks = 0; ks < KP / 8; ++ks)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = rl + 8 * (e & 1), c = 8 * ks + t + 4 * (e >> 1);
        const float w = r < rows && c < k ? __ldg(W + (size_t)r * k + c) : 0.f;
        tc::split_tf32(w, wh[ks][e], wl[ks][e]);
      }
    // H's tiles: this thread's rows hr + NT / 8 q at columns hc .. hc + 3
    const int hr = tid >> 3, hc = 4 * (tid & 7);
    float4 hv[HQ];
    const auto load_h = [&](int p) {
      const int j = p * TN1 + hc;
#pragma unroll
      for (int q = 0; q < HQ; ++q) {
        const int r = hr + NT / 8 * q;
        const float* src = H + (size_t)r * n + j;
        hv[q] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (p >= np1 || r >= k || j >= n) continue;
        if constexpr (VEC) {
          hv[q] = __ldg(reinterpret_cast<const float4*>(src));
        } else {
          hv[q].x = __ldg(src);
          if (j + 1 < n) hv[q].y = __ldg(src + 1);
          if (j + 2 < n) hv[q].z = __ldg(src + 2);
          if (j + 3 < n) hv[q].w = __ldg(src + 3);
        }
      }
    };
    const auto store_h = [&](int p) {   // into the spare room of p's stage
      if (p >= np1) return;
      float2* hs = reinterpret_cast<float2*>(ring + p % S * STAGE + O_H1);
#pragma unroll
      for (int q = 0; q < HQ; ++q) {
        const int r = hr + NT / 8 * q;
        const float2 x = split2(hv[q].x), y = split2(hv[q].y), z = split2(hv[q].z),
                     w = split2(hv[q].w);
        *reinterpret_cast<float4*>(hs + h1_slot(r, hc)) = make_float4(x.x, x.y, y.x, y.y);
        *reinterpret_cast<float4*>(hs + h1_slot(r, hc + 2)) = make_float4(z.x, z.y, w.x, w.y);
      }
    };
    load_h(0);
    store_h(0);
    load_h(1);
    store_h(1);
    load_h(2);

    float acc[KP / 8][4];
#pragma unroll
    for (int o = 0; o < KP / 8; ++o) acc[o][0] = acc[o][1] = acc[o][2] = acc[o][3] = 0.f;
#pragma unroll 1
    for (int p = 0; p < np1; ++p) {
      const float* st = next_tile(p);
      const float2* hs = reinterpret_cast<const float2*>(st + O_H1);
      // P = W H for the tile's four n8 tiles of columns: b0 = H[8 ks + t][8 i
      // + g], b1 = H[8 ks + t + 4][8 i + g]
      float s[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KP / 8; ++ks) {
        if (ks < nks) {
          uint32_t bh[4][2], bl[4][2];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int q = 0; q < 2; ++q) {
              const float2 v = hs[h1_slot(8 * ks + t + 4 * q, 8 * i + g)];
              bh[i][q] = __float_as_uint(v.x);
              bl[i][q] = __float_as_uint(v.y);
            }
          tc::mma4_3xtf32(s, wh[ks], wl[ks], bh, bl);
        }
      }
      // U = A / (P + eps), split: n8 tile i's A operand of U H^T (a0 = (rl,
      // 8 i + 2t), a1 = (rl + 8, 8 i + 2t), a2 = (rl, 8 i + 2t + 1), a3 = (rl +
      // 8, 8 i + 2t + 1))
      uint32_t uh[4][4], ul[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 a0 = *reinterpret_cast<const float2*>(st + rl * LDA1 + 8 * i + 2 * t);
        const float2 a1 =
            *reinterpret_cast<const float2*>(st + (rl + 8) * LDA1 + 8 * i + 2 * t);
        tc::split_tf32(__fdividef(a0.x, s[i][0] + eps), uh[i][0], ul[i][0]);
        tc::split_tf32(__fdividef(a1.x, s[i][2] + eps), uh[i][1], ul[i][1]);
        tc::split_tf32(__fdividef(a0.y, s[i][1] + eps), uh[i][2], ul[i][2]);
        tc::split_tf32(__fdividef(a1.y, s[i][3] + eps), uh[i][3], ul[i][3]);
      }
      // acc += U H^T by groups of four output tiles: the tile's 12 mma of
      // each from zero, then one f32 add. b0 = H[8 o + g][8 i + 2t], b1 =
      // the next column: one 16-byte load of both pairs
#pragma unroll
      for (int og = 0; og < KP / 32; ++og) {
        if (og < ngr) {
          float q4[4][4];
#pragma unroll
          for (int oo = 0; oo < 4; ++oo) q4[oo][0] = q4[oo][1] = q4[oo][2] = q4[oo][3] = 0.f;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            uint32_t bh[4][2], bl[4][2];
#pragma unroll
            for (int oo = 0; oo < 4; ++oo) {
              const float4 v = *reinterpret_cast<const float4*>(
                  hs + h1_slot(8 * (4 * og + oo) + g, 8 * i + 2 * t));
              bh[oo][0] = __float_as_uint(v.x);
              bl[oo][0] = __float_as_uint(v.y);
              bh[oo][1] = __float_as_uint(v.z);
              bl[oo][1] = __float_as_uint(v.w);
            }
            tc::mma4_3xtf32(q4, uh[i], ul[i], bh, bl);
          }
#pragma unroll
          for (int oo = 0; oo < 4; ++oo)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[4 * og + oo][e] += q4[oo][e];
        }
      }
      store_h(p + 2);   // its stage's last reader, tile p - 1, is done
      load_h(p + 3);
    }

    // -- W' = W * (U H^T) / (hrs + eps) on this warp's rows ------------------
    // element e of acc[o]: row rl + 8 (e >> 1), factor 8 o + 2t + (e & 1);
    // rows past m and factors past k read W as 0, so their W' is 0
#pragma unroll
    for (int o = 0; o < KP / 8; ++o)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = rl + 8 * (e >> 1), c = 8 * o + 2 * t + (e & 1);
        const bool in = r < rows && c < k;
        const float w = in ? __ldg(W + (size_t)r * k + c) : 0.f;
        const float den = (c < k ? __ldg(hrs + c) : 0.f) + eps;
        if (in) W_out[(size_t)r * k + c] = w * acc[o][e] / den;
      }
  }
}


template <bool VEC>
cudaError_t launch(const float* A, const float* W, const float* H, const float* hrs,
                   float eps, int B, int m, int n, int k, float* W_out,
                   cudaStream_t stream) {
  const auto kernel = &fused_mu_kl_tf32_kernel<VEC>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((m + TM - 1) / TM, B);
  kernel<<<grid, NT, SMEM, stream>>>(A, W, H, hrs, eps, m, n, k, W_out);
  return cudaGetLastError();
}

cudaError_t launch_any(const float* A, const float* W, const float* H, const float* hrs,
                       float eps, int B, int m, int n, int k, float* W_out,
                       cudaStream_t s) {
  // 16-byte copies and loads need every row of A and H aligned
  const bool vec = n % 4 == 0 &&
      (reinterpret_cast<uintptr_t>(A) | reinterpret_cast<uintptr_t>(H)) % 16 == 0;
  return vec ? launch<true>(A, W, H, hrs, eps, B, m, n, k, W_out, s)
             : launch<false>(A, W, H, hrs, eps, B, m, n, k, W_out, s);
}

}  // namespace tf

// bf16, f16 or uint8 A: the tensor-core kernel at every k <= 64
template <typename T>
cudaError_t dispatch(const void* A_, const void* W_, const void* H_,
                     const void* hrs_, float eps, int B, int m, int n, int k,
                     void* W_out_, cudaStream_t s) {
  if (B < 1 || m < 1 || n < 1 || k < 1) return cudaErrorInvalidValue;
  const auto A = static_cast<const T*>(A_);
  const auto H = static_cast<const __nv_bfloat16*>(H_);
  const auto W = static_cast<const float*>(W_), hrs = static_cast<const float*>(hrs_);
  const auto W_out = static_cast<float*>(W_out_);
  if (k <= 8) return tc::launch_kp<T, 8>(A, W, H, hrs, eps, B, m, n, k, W_out, s);
  if (k <= 16) return tc::launch_kp<T, 16>(A, W, H, hrs, eps, B, m, n, k, W_out, s);
  if (k <= 32) return tc::launch_kp<T, 32>(A, W, H, hrs, eps, B, m, n, k, W_out, s);
  if (k <= 64) return tc::launch_kp<T, 64>(A, W, H, hrs, eps, B, m, n, k, W_out, s);
  return cudaErrorInvalidValue;
}

cudaError_t dispatch_f32(const void* A_, const void* W_, const void* H_,
                         const void* hrs_, float eps, int B, int m, int n, int k,
                         void* W_out_, cudaStream_t s) {
  if (B < 1 || m < 1 || n < 1 || k < 1) return cudaErrorInvalidValue;
  const auto A = static_cast<const float*>(A_), W = static_cast<const float*>(W_),
             H = static_cast<const float*>(H_), hrs = static_cast<const float*>(hrs_);
  const auto W_out = static_cast<float*>(W_out_);
  if (k <= 8) return f32::launch_kp<8>(A, W, H, hrs, eps, B, m, n, k, W_out, s);
  if (k <= 16) return f32::launch_kp<16>(A, W, H, hrs, eps, B, m, n, k, W_out, s);
  if (k <= 32) return f32::launch_kp<32>(A, W, H, hrs, eps, B, m, n, k, W_out, s);
  if (k <= 64) return tf::launch_any(A, W, H, hrs, eps, B, m, n, k, W_out, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// Plain C interface, bound with ctypes: pass 1 of K3. A is (B, m, n) in f32
// (fused_mu_kl_f32), bf16 (fused_mu_kl_bf16), f16 (fused_mu_kl_f16) or uint8
// (fused_mu_kl_u8); H is (B, k, n), f32 with an f32 A and bf16 (the
// operand, rounded by the caller) with a bf16, f16 or uint8 A; W and W_out
// are (B, m, k) and hrs is (B, k), all f32; all contiguous. Returns the
// CUDA error code of the launch (0 on success).
#define FUSED_MU_KL(SUFFIX, CALL)                                                  \
  extern "C" int fused_mu_kl_##SUFFIX(const void* A, const void* W, const void* H, \
                                      const void* hrs, float eps, int B, int m,    \
                                      int n, int k, void* W_out, void* stream) {   \
    return (int)CALL(A, W, H, hrs, eps, B, m, n, k, W_out,                         \
                     static_cast<cudaStream_t>(stream));                           \
  }
FUSED_MU_KL(f32, dispatch_f32)
FUSED_MU_KL(bf16, dispatch<__nv_bfloat16>)
FUSED_MU_KL(f16, dispatch<__half>)
FUSED_MU_KL(u8, dispatch<uint8_t>)

extern "C" const char* fused_mu_kl_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
