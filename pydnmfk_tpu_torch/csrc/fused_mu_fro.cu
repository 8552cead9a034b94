// K1: one Frobenius-MU W pass with one read of each row panel of A.
//
// For each row panel A_i of each member b:
//
//     AHT_i  = A_i H^T                          (panel rows x k)
//     W'_i   = W_i * AHT_i / (W_i HHT + eps)     written to W_out
//     WTA   += W'_i^T A_i                        (k x n, f32 atomics)
//     WTW   += W'_i^T W'_i                       (k x k, f32 atomics)
//
// The H update (H * WTA / (WTW H + eps)) and HHT = H H^T are small and stay
// in PyTorch, as the TPU version leaves them to XLA. W'_i needs A_i H^T over
// all of n before any of W'_i^T A_i can be formed, and a panel does not fit
// on chip, so both kernels below sweep their panel twice: A is read twice,
// and those bytes over the memory rate are the floor of this design (the
// two-read floor). The TPU kernels carry WTA from one grid step to the next;
// Hopper runs blocks in parallel, so that carry becomes f32 atomics (order
// varies from run to run; the sums agree with the plain version to f32
// rounding). A is never padded: the ragged edges of m and n are zero-filled
// as tiles land.
//
// Which dtype of A takes which kernel:
// - f32 A: f32::fused_mu_fro_f32_kernel (C entry fused_mu_fro_f32), on the
//   CUDA cores, since true f32 has no tensor-core path. Replaces
//   pydnmfk_tpu/ops/fused_mu.py::_fused_kernel for an f32 A.
// - bf16, f16 or uint8 A: tc::fused_mu_fro_tc_kernel (C entries
//   fused_mu_fro_bf16, fused_mu_fro_f16 and fused_mu_fro_u8), on the tensor
//   cores (f16 operands for an f16 A, bf16 otherwise). Replaces
//   _fused_kernel for a bf16 or f16 A and tools/fused_u8_probe.py::
//   make_kernel for a uint8 A.
// Each kernel's design note stands above it.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

namespace {

// ---------------------------------------------------------------------------
// The tensor-core kernel: a bf16, f16 or uint8 A.
//
// Numbers: the products take operands at the compute dtype with f32 sums,
// the JAX package's rule (pydnmfk_tpu/ops/fused_mu.py:55-76, :166-173,
// pallas_kernels.py::matmul_compute_dtype) and the plain version's
// (ops/fused_mu.py::fused_w_pass_plain): f16 for an f16 A, bf16 for a bf16
// or uint8 A. H arrives rounded to that dtype (the wrapper casts it, a k x n
// pass outside the kernel), W' is rounded to it for W'^T A_i, and W'^T W'
// takes the unrounded f32 W'. Every uint8 value is exact in bf16. That is
// what mma.sync.m16n8k16 with f16 or bf16 operands and f32 sums computes; an
// f16 A runs every line of the bf16 one, with f16 mma and f16 packing.
//
// What bounds it: each sweep does 2 k flops per element of A, 32 per byte of
// a bf16 A at k = 32 (64 for uint8), far below the card's ~295 bf16 tensor
// flops per byte, so the bytes bound it and its floor is A read twice. The
// design keeps bytes in flight, in long runs of each row, and takes the
// products off the CUDA cores:
// - A block of 256 threads (8 warps) owns a panel of TM = 256 rows (128 at
//   KP = 64) of one member; grid = row panels x members. Panels of 256 rows
//   take a quarter of the atomics into WTA (and of the H tiles read from
//   L2) that 64-row panels would; 128-row panels measured slower.
// - Tiles land by cp.async.cg 16-byte copies in a ring of S shared-memory
//   stages (3; 5 for uint8 at KP = 64), so 2 tiles (4) are in flight while
//   one is multiplied; out-of-range rows and columns are zero-filled through
//   the src-size operand. One ring runs through both sweeps, so sweep 2's
//   first tiles are in flight while W' is formed. A tile spans 128 bytes of
//   each row: 64 bf16 columns, or 128 uint8 columns (64 at KP = 64); rows
//   read 64 bytes at a time stream far slower (PERF.md, section 6). The
//   16-byte path (VEC) needs n % 8 == 0 (bf16, f16) or
//   n % 16 == 0 (uint8) and A, H and WTA 16-byte aligned; otherwise tiles
//   are copied element by element into the same layout.
// - bf16 tiles are 64 columns wide, 128-byte rows whose 16-byte chunks are
//   XOR-swizzled (chunk c of row r at c ^ (r & 7)), so the 8 row addresses
//   of an ldmatrix fall on 8 distinct groups of banks; a 128-column tile is
//   two of them.
// - A uint8 tile lands as bytes and is widened in shared memory into one
//   bf16 tile (16 bytes read, 32 written per chunk, exact through f32 by
//   byte permutes and one subtraction, see widen2). Each warp widens the
//   part of the tile that it multiplies, so no block barrier stands between
//   widening and products, and one warp's widening overlaps another's
//   products. From the bf16 tile on, both dtypes share every line.
// - Sweep 1 (A_i H^T, TM x KP, a sum over n): warp w owns TM / 8 rows and
//   all KP factor columns. A's fragments come by ldmatrix from the row-major
//   tile, H's by ldmatrix from its KP x 64 row-major tile, which is the
//   "col" operand as it stands. The f32 sums stay in registers over all of
//   n: no split over n, nothing to reduce.
// - W' in f32 on the CUDA cores from the sums, W (read from L2) and HHT;
//   W_out and WTW (a sum over the panel's rows of the f32 W') as in the f32
//   kernel; then W' rounded to the operand type (bf16, or f16 for an f16
//   A) into shared memory and from there, once
//   per panel, into each warp's registers as sweep 2's operand.
// - Sweep 2 (C = A_i^T W', a sum over the panel's rows): the factor
//   dimension is mma's N = 8, so k <= 8 pads nothing. Warp w owns 16 (32
//   for a 128-column tile) columns and half of the panel's rows; A^T's
//   fragments come by ldmatrix.trans from the same row-major tile. The two
//   halves are summed through shared memory, and WTA takes 16-byte
//   red.global.add.v4.f32 (scalar atomics where n % 4 != 0).
// - The f32 W' of WTW and sweep 2's partial sums use the widened uint8 tile
//   as scratch where they fit (the tile is free at both points), which is
//   what leaves room for three 128-column uint8 stages.

namespace tc {

constexpr int NT = 256;   // threads per block (8 warps)
constexpr int TN = 64;    // columns of a bf16 tile (a landed uint8 tile may hold two)

constexpr int cmax(int a, int b) { return a > b ? a : b; }

template <typename T, int KP>
struct Cfg {
  static constexpr bool U8 = std::is_same<T, uint8_t>::value;
  // columns of a landed tile: uint8 lands rows of 128 bytes at KP <= 32
  static constexpr int TNP = U8 && KP <= 32 ? 2 * TN : TN;
  static constexpr int SUB = TNP / TN;                 // 64-column tiles in it
  static constexpr int TM = KP <= 32 ? 256 : 128;      // rows per panel
  static constexpr int S = U8 && KP > 32 ? 5 : 3;      // stages of the ring
  static constexpr int NF = KP / 8;                    // n-tiles of 8 factors
  static constexpr int MT1 = TM / 8 / 16;              // sweep 1: m-tiles a warp
  static constexpr int RG = 2;                         // sweep 2: row groups
  static constexpr int CBW = TNP / 64;                 // sweep 2: 16-column blocks a warp
  static constexpr int KS2 = TM / RG / 16;             // sweep 2: k-steps a warp
  static constexpr int LDWP = KP == 8 ? 24 : KP + 8;   // bf16 W' row stride
  static constexpr int LDX = TNP + 4;                  // sweep 2 staging stride
  static constexpr int A_BYTES = TM * TNP * (int)sizeof(T);  // a landed A tile
  static constexpr int STAGE = A_BYTES + SUB * KP * TN * 2;  // and its bf16 H
  static constexpr int WIDE = U8 ? TM * TNP * 2 : 0;   // the widened uint8 tile
  // X, floats: the f32 W' for W'^T W', then sweep 2's partial sums; in the
  // widened tile where it fits (that tile is free at both points)
  static constexpr int XF = cmax(TM * (KP + 1), RG * KP * LDX);
  static constexpr bool XIN = 4 * XF <= WIDE;
  // byte offsets in dynamic shared memory
  static constexpr int O_WIDE = S * STAGE;
  static constexpr int O_WP = O_WIDE + WIDE;
  static constexpr int O_X = XIN ? O_WIDE : O_WP + TM * LDWP * 2;
  static constexpr int O_HHT = O_WP + TM * LDWP * 2 + (XIN ? 0 : 4 * XF);
  static constexpr size_t SMEM = O_HHT + 4 * KP * KP;
  static_assert(O_WP % 16 == 0 && O_X % 16 == 0 && O_HHT % 16 == 0, "alignment");
  static_assert(SMEM <= 227 * 1024, "shared memory");
};

#include "tc_tiles.cuh"

// the products' operand type: f16 for an f16 A, bf16 for a bf16 or uint8 A
template <typename T>
using OpT = typename std::conditional<std::is_same<T, __half>::value, __half,
                                      __nv_bfloat16>::type;

// c += a b on the tensor cores at OpT<T>
template <typename T>
__device__ __forceinline__ void mma_op(float (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  if constexpr (std::is_same<T, __half>::value) {
    mma_f16(c, a, b0, b1);
  } else {
    mma_bf16(c, a, b0, b1);
  }
}

// two f32 packed at OpT<T>, lo in the low half
template <typename T>
__device__ __forceinline__ uint32_t pack_op(float lo, float hi) {
  if constexpr (std::is_same<T, __half>::value) {
    return f16x2(lo, hi);
  } else {
    return bf16x2(lo, hi);
  }
}

// Starts the copy of the landed tile of columns j0 .. j0 + TNP - 1 of the
// panel (rows [0, rows)) into `stage`, and of H's rows [0, k) of those
// columns if with_h. A bf16 or f16 A and H land as TNP / 64 swizzled tiles of 64
// columns, one after another; a uint8 A as rows of TNP bytes, swizzled. VEC:
// cp.async, to be waited for; otherwise plain copies.
template <typename T, int KP, bool VEC>
__device__ __forceinline__ void load_tile(unsigned char* stage, const T* __restrict__ A,
                                          const OpT<T>* __restrict__ H,
                                          int n, int k, int rows, int j0, bool with_h) {
  using C = Cfg<T, KP>;
  const int tid = threadIdx.x;
  unsigned char* hs = stage + C::A_BYTES;
  if constexpr (VEC) {
    const uint32_t s = smem_u32(stage);
    if constexpr (C::U8) {   // chunks of 16 columns, swizzled
      constexpr int CPR = C::TNP / 16;
#pragma unroll
      for (int i = 0; i < C::TM * CPR / NT; ++i) {
        const int e = tid + NT * i, r = e / CPR, c = e % CPR, j = j0 + 16 * c;
        const bool ok = r < rows && j < n;
        cp_async16(s + u8_off<C::TNP>(r, c), ok ? A + (size_t)r * n + j : A, ok);
      }
    } else {                 // chunks of 8 columns, swizzled
      constexpr int CPR = C::TNP / 8;
#pragma unroll
      for (int i = 0; i < C::TM * CPR / NT; ++i) {
        const int e = tid + NT * i, r = e / CPR, c = e % CPR, j = j0 + 8 * c;
        const bool ok = r < rows && j < n;
        cp_async16(s + c / 8 * C::TM * 128 + chunk_off(r, c % 8),
                   ok ? A + (size_t)r * n + j : A, ok);
      }
    }
    if (with_h) {
      const uint32_t sh = smem_u32(hs);
      for (int e = tid; e < C::SUB * KP * 8; e += NT) {
        const int u = e / (KP * 8), c = (e >> 3) % KP, ch = e & 7;
        const int j = j0 + TN * u + 8 * ch;
        const bool ok = c < k && j < n;
        cp_async16(sh + u * KP * 128 + chunk_off(c, ch), ok ? H + (size_t)c * n + j : H, ok);
      }
    }
  } else {
#pragma unroll 1
    for (int e = tid; e < C::TM * C::TNP; e += NT) {
      const int r = e / C::TNP, j = e % C::TNP;
      const bool ok = r < rows && j0 + j < n;
      if constexpr (C::U8) {
        stage[u8_off<C::TNP>(r, j >> 4) + (j & 15)] = ok ? A[(size_t)r * n + j0 + j] : 0;
      } else {
        *reinterpret_cast<unsigned short*>(stage + j / TN * C::TM * 128 +
                                           chunk_off(r, j % TN >> 3) + 2 * (j & 7)) =
            ok ? bits16(A[(size_t)r * n + j0 + j]) : 0;
      }
    }
    if (with_h) {
#pragma unroll 1
      for (int e = tid; e < C::SUB * KP * TN; e += NT) {
        const int u = e / (KP * TN), c = e / TN % KP, j = e % TN, jg = j0 + TN * u + j;
        const bool ok = c < k && jg < n;
        *reinterpret_cast<unsigned short*>(hs + u * KP * 128 + chunk_off(c, j >> 3) +
                                           2 * (j & 7)) =
            ok ? bits16(H[(size_t)c * n + jg]) : 0;
      }
    }
  }
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

template <typename T, int KP, bool VEC>
__global__ void __launch_bounds__(NT, 1)
fused_mu_fro_tc_kernel(const T* __restrict__ A, const float* __restrict__ W,
                       const OpT<T>* __restrict__ H,
                       const float* __restrict__ HHT, float eps, int m, int n,
                       int k, float* __restrict__ W_out, float* __restrict__ WTA,
                       float* __restrict__ WTW) {
  using C = Cfg<T, KP>;
  constexpr int TM = C::TM, S = C::S, NF = C::NF, MT1 = C::MT1, KS2 = C::KS2;
  constexpr int LW = KP + 1;     // row stride of the f32 W' panel in X
  extern __shared__ uint4 smem_tc[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(smem_tc);
  unsigned char* wide = sm + C::O_WIDE;
  OpT<T>* Wp = reinterpret_cast<OpT<T>*>(sm + C::O_WP);
  float* X = reinterpret_cast<float*>(sm + C::O_X);
  float* HHs = reinterpret_cast<float*>(sm + C::O_HHT);

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
  const int g = lane >> 2, t4 = lane & 3;   // a fragment's row and column pair

  for (int e = tid; e < KP * KP; e += NT) {   // HHT, zero outside [k) x [k)
    const int c = e / KP, d = e % KP;
    HHs[e] = (c < k && d < k) ? HHT[c * k + d] : 0.f;
  }

  // Landed tiles of TNP columns, np of them per sweep: tiles 0 .. np - 1 are
  // sweep 1's, np .. 2 np - 1 sweep 2's (the same columns again)
  const int np = (n + C::TNP - 1) / C::TNP, ntot = 2 * np;
  const auto load = [&](int p) {   // tile p, into stage p % S
    load_tile<T, KP, VEC>(sm + (p % S) * C::STAGE, A, H, n, k, rows,
                          (p % np) * C::TNP, p < np);
  };
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < ntot) load(s);
    cp_async_commit();
  }

  float acc[MT1][NF][4];         // sweep 1: A_i H^T, then W'
#pragma unroll
  for (int i = 0; i < MT1; ++i)
#pragma unroll
    for (int f = 0; f < NF; ++f)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][f][e] = 0.f;
  uint32_t wf[KS2][NF][2];       // sweep 2: this warp's bf16 W' fragments
  const int wrow = warp * (TM / 8);            // sweep 1: this warp's rows
  // sweep 2: this warp's column group (CBW blocks of 16 columns) and rows
  const int cw = warp % (8 / C::RG), rg = warp / (8 / C::RG);

#pragma unroll 1
  for (int t = 0; t < ntot; ++t) {
    cp_async_wait<S - 2>();      // tile t has landed
    __syncthreads();             // and every warp is done with tile t - 1
    if (t + S - 1 < ntot) load(t + S - 1);
    cp_async_commit();
    const unsigned char* st = sm + t % S * C::STAGE;
    if constexpr (C::U8) {     // each warp widens what it multiplies
      if (t < np) {
        widen_part<TM, C::TNP, TM / 8, C::TNP / 16>(st, wide, wrow, 0, lane);
      } else {
        widen_part<TM, C::TNP, TM / C::RG, C::CBW>(st, wide, rg * (TM / C::RG),
                                                   cw * C::CBW, lane);
      }
      __syncwarp();
    }
    // the bf16 tile: SUB tiles of 64 columns, TM x 128 bytes each
    const uint32_t a_s = smem_u32(C::U8 ? wide : st);
    if (t < np) {
      // -- sweep 1: acc += A tile x H tile^T --------------------------------
#pragma unroll
      for (int u = 0; u < C::SUB; ++u) {
        const uint32_t h_s = smem_u32(st + C::A_BYTES + u * KP * 128);
        const uint32_t au_s = a_s + u * TM * 128;
        uint32_t bh[NF][2][4];   // H fragments of k-steps (2p, 2p + 1)
#pragma unroll
        for (int f = 0; f < NF; ++f)
#pragma unroll
          for (int p = 0; p < 2; ++p)
            ldsm_x4(h_s + chunk_off(8 * f + (lane & 7), 4 * p + (lane >> 3)), bh[f][p]);
#pragma unroll
        for (int kk = 0; kk < TN / 16; ++kk) {
#pragma unroll
          for (int i = 0; i < MT1; ++i) {
            uint32_t a[4];
            const int r = wrow + 16 * i + (lane & 7) + ((lane >> 3) & 1) * 8;
            ldsm_x4(au_s + chunk_off(r, 2 * kk + (lane >> 4)), a);
#pragma unroll
            for (int f = 0; f < NF; ++f)
              mma_op<T>(acc[i][f], a, bh[f][kk >> 1][2 * (kk & 1)],
                       bh[f][kk >> 1][2 * (kk & 1) + 1]);
          }
        }
      }
      if (t == np - 1) {
        // -- W' = W * AHT / (W HHT + eps) on this warp's rows ---------------
        // element e of fragment (i, f): row wrow + 16 i + g + 8 (e >> 1),
        // factor column 8 f + 2 t4 + (e & 1). W comes from global memory
        // (L2); rows past m and columns past k read as 0, so their W' is 0.
        const auto w_at = [&](int r, int c) {
          return r < rows && c < k ? __ldg(W + (size_t)r * k + c) : 0.f;
        };
        float den[MT1][NF][4];
#pragma unroll
        for (int i = 0; i < MT1; ++i)
#pragma unroll
          for (int f = 0; f < NF; ++f)
#pragma unroll
            for (int e = 0; e < 4; ++e) den[i][f][e] = 0.f;
#pragma unroll 4
        for (int d = 0; d < KP; ++d) {
          float wr[MT1][2];
#pragma unroll
          for (int i = 0; i < MT1; ++i)
#pragma unroll
            for (int h = 0; h < 2; ++h) wr[i][h] = w_at(wrow + 16 * i + g + 8 * h, d);
#pragma unroll
          for (int f = 0; f < NF; ++f) {
            const float2 hh = *reinterpret_cast<const float2*>(HHs + d * KP + 8 * f + 2 * t4);
#pragma unroll
            for (int i = 0; i < MT1; ++i) {
              den[i][f][0] = fmaf(wr[i][0], hh.x, den[i][f][0]);
              den[i][f][1] = fmaf(wr[i][0], hh.y, den[i][f][1]);
              den[i][f][2] = fmaf(wr[i][1], hh.x, den[i][f][2]);
              den[i][f][3] = fmaf(wr[i][1], hh.y, den[i][f][3]);
            }
          }
        }
#pragma unroll
        for (int i = 0; i < MT1; ++i)
#pragma unroll
          for (int f = 0; f < NF; ++f)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int r = wrow + 16 * i + g + 8 * (e >> 1), c = 8 * f + 2 * t4 + (e & 1);
              acc[i][f][e] = w_at(r, c) * acc[i][f][e] / (den[i][f][e] + eps);
            }
        if constexpr (C::XIN) __syncthreads();   // X is the tile just read
        // W' to W_out, to X in f32 and to Wp at the operand type
#pragma unroll
        for (int i = 0; i < MT1; ++i)
#pragma unroll
          for (int f = 0; f < NF; ++f)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int r = wrow + 16 * i + g + 8 * h, c = 8 * f + 2 * t4;
              const float w0 = acc[i][f][2 * h], w1 = acc[i][f][2 * h + 1];
              X[r * LW + c] = w0;
              X[r * LW + c + 1] = w1;
              *reinterpret_cast<uint32_t*>(Wp + r * C::LDWP + c) = pack_op<T>(w0, w1);
              if (r < rows) {
                if (c < k) W_out[(size_t)r * k + c] = w0;
                if (c + 1 < k) W_out[(size_t)r * k + c + 1] = w1;
              }
            }
        __syncthreads();
        // WTW += W'^T W' over the panel's rows, from the f32 W'
        for (int p = tid; p < KP * KP; p += NT) {
          const int c = p / KP, d = p % KP;
          if (c < k && d < k) {
            float s = 0.f;
#pragma unroll 4
            for (int r = 0; r < rows; ++r) s = fmaf(X[r * LW + c], X[r * LW + d], s);
            atomicAdd(&WTW[c * k + d], s);
          }
        }
        // sweep 2's B fragments: rows rg TM / RG + 16 s .., factors 8 f ..
        const uint32_t wp_s = smem_u32(Wp);
#pragma unroll
        for (int s = 0; s < KS2; ++s)
#pragma unroll
          for (int f = 0; f < NF; ++f) {
            const int r = rg * (TM / C::RG) + 16 * s + (lane & 7) + ((lane >> 3) & 1) * 8;
            ldsm_x2_t(wp_s + 2 * (r * C::LDWP + 8 * f), wf[s][f][0], wf[s][f][1]);
          }
      }
    } else {
      // -- sweep 2: WTA[:, j0 ..] += (A tile^T W')^T --------------------------
      const int j0 = (t - np) * C::TNP;
      float c2[C::CBW][NF][4];
#pragma unroll
      for (int v = 0; v < C::CBW; ++v)
#pragma unroll
        for (int f = 0; f < NF; ++f)
#pragma unroll
          for (int e = 0; e < 4; ++e) c2[v][f][e] = 0.f;
#pragma unroll
      for (int s = 0; s < KS2; ++s) {
        const int r = rg * (TM / C::RG) + 16 * s + (lane & 7) + (lane >> 4) * 8;
#pragma unroll
        for (int v = 0; v < C::CBW; ++v) {
          const int cb = cw * C::CBW + v;   // 16-column block in the tile
          uint32_t a[4];
          ldsm_x4_t(a_s + cb / 4 * TM * 128 + chunk_off(r, 2 * (cb % 4) + ((lane >> 3) & 1)), a);
#pragma unroll
          for (int f = 0; f < NF; ++f) mma_op<T>(c2[v][f], a, wf[s][f][0], wf[s][f][1]);
        }
      }
      if constexpr (C::XIN) __syncthreads();   // X is the tile just read
      // element e of fragment (v, f): column 16 cb + g + 8 (e >> 1), factor
      // 8 f + 2 t4 + (e & 1); X[rg][factor][column]
#pragma unroll
      for (int v = 0; v < C::CBW; ++v)
#pragma unroll
        for (int f = 0; f < NF; ++f)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            X[(rg * KP + 8 * f + 2 * t4 + (e & 1)) * C::LDX + 16 * (cw * C::CBW + v) + g +
              8 * (e >> 1)] = c2[v][f][e];
      __syncthreads();
      for (int q = tid; q < KP * C::TNP / 4; q += NT) {
        const int c = q / (C::TNP / 4), jq = 4 * (q % (C::TNP / 4)), j = j0 + jq;
        if (c >= k || j >= n) continue;
        float4 s = *reinterpret_cast<const float4*>(X + c * C::LDX + jq);
#pragma unroll
        for (int h = 1; h < C::RG; ++h) {
          const float4 v = *reinterpret_cast<const float4*>(X + (h * KP + c) * C::LDX + jq);
          s = make_float4(s.x + v.x, s.y + v.y, s.z + v.z, s.w + v.w);
        }
        float* dst = WTA + (size_t)c * n + j;
        if constexpr (VEC) {
          atomicAdd(reinterpret_cast<float4*>(dst), s);   // j + 3 < n: n % 8 == 0
        } else {
          atomicAdd(dst, s.x);
          if (j + 1 < n) atomicAdd(dst + 1, s.y);
          if (j + 2 < n) atomicAdd(dst + 2, s.z);
          if (j + 3 < n) atomicAdd(dst + 3, s.w);
        }
      }
    }
  }
}

template <typename T, int KP, bool VEC>
cudaError_t launch(const T* A, const float* W, const OpT<T>* H,
                   const float* HHT, float eps, int B, int m, int n, int k,
                   float* W_out, float* WTA, float* WTW, cudaStream_t stream) {
  using C = Cfg<T, KP>;
  const auto kernel = &fused_mu_fro_tc_kernel<T, KP, VEC>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((m + C::TM - 1) / C::TM, B);
  kernel<<<grid, NT, C::SMEM, stream>>>(A, W, H, HHT, eps, m, n, k, W_out, WTA, WTW);
  return cudaGetLastError();
}

template <typename T, int KP>
cudaError_t launch_kp(const T* A, const float* W, const OpT<T>* H,
                      const float* HHT, float eps, int B, int m, int n, int k,
                      float* W_out, float* WTA, float* WTW, cudaStream_t s) {
  // 16-byte copies and vector atomics need every row of A, H and WTA aligned
  const bool vec = n % (16 / (int)sizeof(T)) == 0 &&
      (reinterpret_cast<uintptr_t>(A) | reinterpret_cast<uintptr_t>(H) |
       reinterpret_cast<uintptr_t>(WTA)) % 16 == 0;
  return vec ? launch<T, KP, true>(A, W, H, HHT, eps, B, m, n, k, W_out, WTA, WTW, s)
             : launch<T, KP, false>(A, W, H, HHT, eps, B, m, n, k, W_out, WTA, WTW, s);
}

template <typename T>
cudaError_t dispatch(const void* A_, const void* W_, const void* H_,
                     const void* HHT_, float eps, int B, int m, int n, int k,
                     void* W_out_, void* WTA_, void* WTW_, cudaStream_t s) {
  if (B < 1 || m < 1 || n < 1 || k < 1) return cudaErrorInvalidValue;
  const auto A = static_cast<const T*>(A_);
  const auto H = static_cast<const OpT<T>*>(H_);
  const auto W = static_cast<const float*>(W_), HHT = static_cast<const float*>(HHT_);
  const auto W_out = static_cast<float*>(W_out_), WTA = static_cast<float*>(WTA_),
             WTW = static_cast<float*>(WTW_);
  if (k <= 8) return launch_kp<T, 8>(A, W, H, HHT, eps, B, m, n, k, W_out, WTA, WTW, s);
  if (k <= 16) return launch_kp<T, 16>(A, W, H, HHT, eps, B, m, n, k, W_out, WTA, WTW, s);
  if (k <= 32) return launch_kp<T, 32>(A, W, H, HHT, eps, B, m, n, k, W_out, WTA, WTW, s);
  if (k <= 64) return launch_kp<T, 64>(A, W, H, HHT, eps, B, m, n, k, W_out, WTA, WTW, s);
  return cudaErrorInvalidValue;
}

}  // namespace tc

// ---------------------------------------------------------------------------
// The f32 instantiation: register micro-tiles, float4 operands, vector atomics.
//
// Same contract and the same two sweeps as the tensor-core kernel, designed for
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

// Plain C interface, bound with ctypes. A is (B, m, n) in f32 (fused_mu_fro_f32),
// bf16 (fused_mu_fro_bf16), f16 (fused_mu_fro_f16) or uint8 (fused_mu_fro_u8);
// H is (B, k, n), f32 for an f32 A, f16 for an f16 A and bf16 for a bf16 or
// uint8 A (rounded by the caller); W and W_out
// are (B, m, k), HHT is (B, k, k), WTA is (B, k, n) and WTW is (B, k, k), all
// f32; everything contiguous, and WTA/WTW zeroed by the caller. Returns the
// CUDA error code of the launch (0 on success).
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
  return (int)tc::dispatch<__nv_bfloat16>(A, W, H, HHT, eps, B, m, n, k, W_out,
                                          WTA, WTW, static_cast<cudaStream_t>(stream));
}

extern "C" int fused_mu_fro_f16(const void* A, const void* W, const void* H,
                                const void* HHT, float eps, int B, int m, int n,
                                int k, void* W_out, void* WTA, void* WTW,
                                void* stream) {
  return (int)tc::dispatch<__half>(A, W, H, HHT, eps, B, m, n, k, W_out, WTA, WTW,
                                   static_cast<cudaStream_t>(stream));
}

extern "C" int fused_mu_fro_u8(const void* A, const void* W, const void* H,
                               const void* HHT, float eps, int B, int m, int n,
                               int k, void* W_out, void* WTA, void* WTW,
                               void* stream) {
  return (int)tc::dispatch<uint8_t>(A, W, H, HHT, eps, B, m, n, k, W_out, WTA, WTW,
                                    static_cast<cudaStream_t>(stream));
}

extern "C" const char* fused_mu_fro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
