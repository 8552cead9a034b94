// K1: one Frobenius-MU W pass, every sum in a fixed order.
//
// For each row panel A_i of each member b (pass 1, this file):
//
//     AHT_i  = A_i H^T                          (panel rows x k)
//     W'_i   = W_i * AHT_i / (W_i HHT + eps)     written to W_out
//     WTWp_i = W'_i^T W'_i                       (k x k, the panel's slot)
//
// and then WTW = WTWp_0 + WTWp_1 + ... in panel order (wtw_panel_sum_kernel).
// Pass 2, WTA = W'^T A (k x n), walks column strips of A over all rows in
// order, in csrc/kl_ratio.cu (K2b's register kernel without the ratio for
// an f32 A; strip::wtu_strip_kernel for a bf16, f16 or uint8 A), launched by
// the same wrapper (ops/fused_mu.py). The H update (H * WTA / (WTW H +
// eps)) and HHT = H H^T are small and stay in PyTorch, as the TPU version
// leaves them to XLA. W'_i needs A_i H^T over all of n before any of
// W'_i^T A_i can be formed, and a panel does not fit on chip, so A is read
// twice, once a pass: those bytes over the memory rate are the floor of
// this design (the two-read floor). The TPU kernel carries WTA from one
// grid step to the next in panel order; Hopper runs panels in parallel, and
// an atomic carry would sum in an order that changes from run to run, so
// pass 2 owns each output column instead: the same call on the same inputs
// gives the same bits, and a member's bits do not depend on how many
// members share its launch. A is never padded: the ragged edges of m and n
// are zero-filled as tiles land.
//
// Which dtype of A takes which pass-1 kernel:
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
// pass outside the kernel); W'^T W' takes the unrounded f32 W' (pass 2
// takes W' rounded to the operand dtype). Every uint8 value is exact in
// bf16. That is what mma.sync.m16n8k16 with f16 or bf16 operands and f32
// sums computes; an f16 A runs every line of the bf16 one, with f16 mma.
//
// What bounds it: 2 k flops per element of A, 32 per byte of a bf16 A at
// k = 32 (64 for uint8), far below the card's ~295 bf16 tensor flops per
// byte, so the bytes bound it: A read once. The design keeps bytes in
// flight, in long runs of each row, and takes the products off the CUDA
// cores:
// - A block of 256 threads (8 warps) owns a panel of TM = 256 rows (128 at
//   KP = 64) of one member; grid = row panels x members. 256-row panels
//   read a quarter of the H tiles from L2 that 64-row ones would.
// - Tiles land by cp.async.cg 16-byte copies in a ring of S shared-memory
//   stages (3; 5 for uint8 at KP = 64), so 2 tiles (4) are in flight while
//   one is multiplied; out-of-range rows and columns are zero-filled through
//   the src-size operand. A tile spans 128 bytes of each row: 64 bf16
//   columns, or 128 uint8 columns (64 at KP = 64); rows read 64 bytes at a
//   time stream far slower (PERF.md, section 6). The 16-byte path (VEC)
//   needs n % 8 == 0 (bf16, f16) or n % 16 == 0 (uint8) and A and H 16-byte
//   aligned; otherwise tiles are copied element by element into the same
//   layout.
// - bf16 tiles are 64 columns wide, 128-byte rows whose 16-byte chunks are
//   XOR-swizzled (chunk c of row r at c ^ (r & 7)), so the 8 row addresses
//   of an ldmatrix fall on 8 distinct groups of banks; a 128-column tile is
//   two of them.
// - A uint8 tile lands as bytes and is widened in shared memory into one
//   bf16 tile (16 bytes read, 32 written per chunk, exact through f32 by
//   byte permutes and one subtraction, see widen2). Each warp widens the
//   rows that it multiplies, so no block barrier stands between widening
//   and products. From the bf16 tile on, both dtypes share every line.
// - A_i H^T (TM x KP, a sum over n): warp w owns TM / 8 rows and all KP
//   factor columns. A's fragments come by ldmatrix from the row-major tile,
//   H's by ldmatrix from its KP x 64 row-major tile, which is the "col"
//   operand as it stands. The f32 sums stay in registers over all of n: no
//   split over n, nothing to reduce.
// - W' in f32 on the CUDA cores from the sums, W (read from L2) and HHT,
//   written to W_out and into shared memory (the widened uint8 tile where it
//   fits, which is free by then); W'^T W' as a sum over the panel's rows in
//   row order, one thread an output, into the panel's slot of WTWp.

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
  static constexpr int MT1 = TM / 8 / 16;              // m-tiles a warp
  static constexpr int A_BYTES = TM * TNP * (int)sizeof(T);  // a landed A tile
  static constexpr int STAGE = A_BYTES + SUB * KP * TN * 2;  // and its bf16 H
  static constexpr int WIDE = U8 ? TM * TNP * 2 : 0;   // the widened uint8 tile
  // X, floats: the f32 W' for W'^T W'; in the widened tile where it fits
  // (that tile is free by then)
  static constexpr int XF = TM * (KP + 1);
  static constexpr bool XIN = 4 * XF <= WIDE;
  // byte offsets in dynamic shared memory
  static constexpr int O_WIDE = S * STAGE;
  static constexpr int O_X = XIN ? O_WIDE : O_WIDE + WIDE;
  static constexpr int O_HHT = O_WIDE + WIDE + (XIN ? 0 : 4 * XF);
  static constexpr size_t SMEM = O_HHT + 4 * KP * KP;
  static_assert(O_X % 16 == 0 && O_HHT % 16 == 0, "alignment");
  static_assert(SMEM <= 227 * 1024, "shared memory");
};

#include "tc_tiles.cuh"

// the products' operand type: f16 for an f16 A, bf16 for a bf16 or uint8 A
template <typename T>
using OpT = typename std::conditional<std::is_same<T, __half>::value, __half,
                                      __nv_bfloat16>::type;

// Starts the copy of the landed tile of columns j0 .. j0 + TNP - 1 of the
// panel (rows [0, rows)) into `stage`, and of H's rows [0, k) of those
// columns. A bf16 or f16 A and H land as TNP / 64 swizzled tiles of 64
// columns, one after another; a uint8 A as rows of TNP bytes, swizzled. VEC:
// cp.async, to be waited for; otherwise plain copies.
template <typename T, int KP, bool VEC>
__device__ __forceinline__ void load_tile(unsigned char* stage, const T* __restrict__ A,
                                          const OpT<T>* __restrict__ H,
                                          int n, int k, int rows, int j0) {
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
        *reinterpret_cast<unsigned short*>(stage + j / TN * C::TM * 128 +
                                           chunk_off(r, j % TN >> 3) + 2 * (j & 7)) =
            ok ? bits16(A[(size_t)r * n + j0 + j]) : 0;
      }
    }
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

template <typename T, int KP, bool VEC>
__global__ void __launch_bounds__(NT, 1)
fused_mu_fro_tc_kernel(const T* __restrict__ A, const float* __restrict__ W,
                       const OpT<T>* __restrict__ H,
                       const float* __restrict__ HHT, float eps, int m, int n,
                       int k, float* __restrict__ W_out, float* __restrict__ WTWp) {
  using C = Cfg<T, KP>;
  constexpr int TM = C::TM, S = C::S, NF = C::NF, MT1 = C::MT1;
  constexpr int LW = KP + 1;     // row stride of the f32 W' panel in X
  extern __shared__ uint4 smem_tc[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(smem_tc);
  unsigned char* wide = sm + C::O_WIDE;
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
  WTWp += ((size_t)b * gridDim.x + blockIdx.x) * k * k;   // this panel's slot
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;   // a fragment's row and column pair

  for (int e = tid; e < KP * KP; e += NT) {   // HHT, zero outside [k) x [k)
    const int c = e / KP, d = e % KP;
    HHs[e] = (c < k && d < k) ? HHT[c * k + d] : 0.f;
  }

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

  float acc[MT1][NF][4];         // A_i H^T, then W'
#pragma unroll
  for (int i = 0; i < MT1; ++i)
#pragma unroll
    for (int f = 0; f < NF; ++f)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][f][e] = 0.f;
  const int wrow = warp * (TM / 8);            // this warp's rows

#pragma unroll 1
  for (int t = 0; t < np; ++t) {
    cp_async_wait<S - 2>();      // tile t has landed
    __syncthreads();             // and every warp is done with tile t - 1
    if (t + S - 1 < np) load(t + S - 1);
    cp_async_commit();
    const unsigned char* st = sm + t % S * C::STAGE;
    if constexpr (C::U8) {     // each warp widens what it multiplies
      widen_part<TM, C::TNP, TM / 8, C::TNP / 16>(st, wide, wrow, 0, lane);
      __syncwarp();
    }
    // the bf16 tile: SUB tiles of 64 columns, TM x 128 bytes each
    const uint32_t a_s = smem_u32(C::U8 ? wide : st);
    // -- acc += A tile x H tile^T ---------------------------------------------
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
  }

  // -- W' = W * AHT / (W HHT + eps) on this warp's rows -------------------------
  // element e of fragment (i, f): row wrow + 16 i + g + 8 (e >> 1), factor
  // column 8 f + 2 t4 + (e & 1). W comes from global memory (L2); rows past
  // m and columns past k read as 0, so their W' is 0.
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
  if constexpr (C::XIN) __syncthreads();   // X is the widened tile, read by all
  // W' to W_out and to X in f32
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
        if (r < rows) {
          if (c < k) W_out[(size_t)r * k + c] = w0;
          if (c + 1 < k) W_out[(size_t)r * k + c + 1] = w1;
        }
      }
  __syncthreads();
  // the panel's W'^T W', summed over its rows in row order, from the f32 W'
  for (int p = tid; p < KP * KP; p += NT) {
    const int c = p / KP, d = p % KP;
    if (c < k && d < k) {
      float s = 0.f;
#pragma unroll 4
      for (int r = 0; r < rows; ++r) s = fmaf(X[r * LW + c], X[r * LW + d], s);
      WTWp[c * k + d] = s;
    }
  }
}

template <typename T, int KP, bool VEC>
cudaError_t launch(const T* A, const float* W, const OpT<T>* H,
                   const float* HHT, float eps, int B, int m, int n, int k,
                   float* W_out, float* WTWp, cudaStream_t stream) {
  using C = Cfg<T, KP>;
  const auto kernel = &fused_mu_fro_tc_kernel<T, KP, VEC>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((m + C::TM - 1) / C::TM, B);
  kernel<<<grid, NT, C::SMEM, stream>>>(A, W, H, HHT, eps, m, n, k, W_out, WTWp);
  return cudaGetLastError();
}

template <typename T, int KP>
cudaError_t launch_kp(const T* A, const float* W, const OpT<T>* H,
                      const float* HHT, float eps, int B, int m, int n, int k,
                      float* W_out, float* WTWp, cudaStream_t s) {
  // 16-byte copies need every row of A and H aligned
  const bool vec = n % (16 / (int)sizeof(T)) == 0 &&
      (reinterpret_cast<uintptr_t>(A) | reinterpret_cast<uintptr_t>(H)) % 16 == 0;
  return vec ? launch<T, KP, true>(A, W, H, HHT, eps, B, m, n, k, W_out, WTWp, s)
             : launch<T, KP, false>(A, W, H, HHT, eps, B, m, n, k, W_out, WTWp, s);
}

template <typename T>
cudaError_t dispatch(const void* A_, const void* W_, const void* H_,
                     const void* HHT_, float eps, int B, int m, int n, int k,
                     void* W_out_, void* WTWp_, cudaStream_t s) {
  const auto A = static_cast<const T*>(A_);
  const auto H = static_cast<const OpT<T>*>(H_);
  const auto W = static_cast<const float*>(W_), HHT = static_cast<const float*>(HHT_);
  const auto W_out = static_cast<float*>(W_out_), WTWp = static_cast<float*>(WTWp_);
  if (k <= 8) return launch_kp<T, 8>(A, W, H, HHT, eps, B, m, n, k, W_out, WTWp, s);
  if (k <= 16) return launch_kp<T, 16>(A, W, H, HHT, eps, B, m, n, k, W_out, WTWp, s);
  if (k <= 32) return launch_kp<T, 32>(A, W, H, HHT, eps, B, m, n, k, W_out, WTWp, s);
  return launch_kp<T, 64>(A, W, H, HHT, eps, B, m, n, k, W_out, WTWp, s);
}

}  // namespace tc

// ---------------------------------------------------------------------------
// The f32 instantiation: register micro-tiles, float4 operands.
//
// Same contract as the tensor-core kernel, designed for the CUDA cores: a
// thread's 4 x 8 tile of outputs takes one float4 of A and two of H from
// shared memory per 32 FMAs. (An 8 x 8 tile, two float4 of each per 64
// FMAs, is what shared memory delivers to the 128 FP32 lanes of an SM per
// clock; it fit 128 registers beside the second sweep of the one-pass
// kernel, but spills 32-88 bytes in this pass alone at KP = 32 and 64, and
// measured slower so: 12.96 against 12.07 ms for the whole K1 at 57600 x
// 38400, k = 32, on an H100 80GB HBM3 at 700 W,
// bench_torch/k1_pass1_variants.py.)
// - A_i H^T (TM x KP, a sum over n): a thread keeps RM = 4 rows x 8 factor
//   columns in registers. The threads split each tile's TN1 columns into G1
//   groups, whose partial sums are reduced once per panel through shared
//   memory. The A tile is stored transposed ([TN1][TM]): each thread loads
//   4 rows x 4 columns (one float4 per row) and stores them as 4 float4 of
//   4 rows each, XOR-swizzled (row r of column j at r ^ sw(j)) so that
//   neither the stores nor the float4 reads conflict on banks.
// - A is read with 16-byte loads when n % 4 == 0 and A and H are 16-byte
//   aligned (VEC). The next tile's loads are spread over the current tile's
//   products (issued together they hold up the shared-memory loads queued
//   behind them) and land in the other of two shared-memory buffers: one
//   barrier per tile, no cp.async. At k <= 16 the tile after next is also
//   prefetched into L2. Otherwise (n % 4 != 0) each tile is copied element
//   by element after the products.
// - W' in f32 from the groups' sums, W and HHT, written to W_out and kept in
//   shared memory for the panel's W'^T W' (one thread an output, a sum over
//   the panel's rows in row order, into the panel's slot of WTWp).
// - Panels of TM = 128 rows (64 at KP = 64); 256 threads, at most 128
//   registers (two blocks per SM) and at most ~100 KB of shared memory.
// What bounds it: 2 k FMAs per element of A on the CUDA cores (true f32 has
// no tensor-core path) against one read of A: at k = 32 the FMAs (2.11 ms
// at 57600 x 38400 on 67 TFLOP/s) and the bytes (2.64 ms) are about even,
// at k = 8 the bytes bound it.

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
  // RM rows x 8 factor columns a thread; tiles of TN1 columns
  static constexpr int RM = 4;
  static constexpr int TN1 = 32;
  static constexpr int HW = cmax(KP, 32);           // row width of the H^T tile
  static constexpr int T1 = TM / RM * (KP / 8);     // threads per column group
  static constexpr int G1 = NT / T1;                // column groups
  static constexpr int JPG = TN1 / G1;              // columns per group and tile
  static constexpr int LDW = KP + 4;                // row stride of the W' panel
  static constexpr int NW = TM * KP / 4 / NT;       // float4s of W' per thread
  // shared memory, in floats: the tiles (two buffers) or the groups' partial
  // sums, then the W' panel and HHT
  static constexpr int A1 = TN1 * TM, H1 = TN1 * HW;
  static constexpr int RED = G1 * TM * KP;
  static constexpr int X = cmax(2 * (A1 + H1), RED);
  static constexpr size_t SMEM = sizeof(float) * (X + TM * LDW + KP * KP);
  static_assert(T1 % 32 == 0 && T1 * G1 == NT && TN1 % G1 == 0, "tiles");
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
// swizzled, zero outside.
template <int R, int TN, int LD>
__device__ __forceinline__ void copy_tile(float* dst, const float* __restrict__ src,
                                          int ld, int rows, int j0, int cols) {
#pragma unroll 1
  for (int e = threadIdx.x; e < R * TN; e += NT) {
    const int r = e / TN, j = e % TN;
    const float x = (r < rows && j < cols) ? __ldg(src + (size_t)r * ld + j0 + j) : 0.f;
    dst[j * LD + (r ^ sw(j))] = x;
  }
}

template <int KP, bool VEC>
__global__ void __launch_bounds__(NT, 2)
fused_mu_fro_f32_kernel(const float* __restrict__ A, const float* __restrict__ W,
                        const float* __restrict__ H, const float* __restrict__ HHT,
                        float eps, int m, int n, int k, float* __restrict__ W_out,
                        float* __restrict__ WTWp) {
  using C = Cfg<KP>;
  constexpr int TM = C::TM, TN1 = C::TN1;
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
  WTWp += ((size_t)b * gridDim.x + blockIdx.x) * k * k;   // this panel's slot
  const int tid = threadIdx.x;

  // A_i H^T. Thread (g, ri, ci) sums rows 4 ri + u TM / RF + (0..3)
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
        copy_tile<TM, TN1, TM>(buf, A, n, rows, j0, min(TN1, n - j0));
        copy_tile<KP, TN1, C::HW>(buf + C::A1, H, n, k, j0, min(TN1, n - j0));
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
  __syncthreads();

  // the panel's W'^T W', summed over its rows in row order
  for (int e = tid; e < KP * KP; e += NT) {
    const int c = e / KP, d = e % KP;
    if (c < k && d < k) {
      float s = 0.f;
      for (int r = 0; r < rows; ++r) s += Ws[r * C::LDW + c] * Ws[r * C::LDW + d];
      WTWp[c * k + d] = s;
    }
  }
}

template <int KP, bool VEC>
cudaError_t launch(const float* A, const float* W, const float* H,
                   const float* HHT, float eps, int B, int m, int n, int k,
                   float* W_out, float* WTWp, cudaStream_t stream) {
  using C = Cfg<KP>;
  const auto kernel = &fused_mu_fro_f32_kernel<KP, VEC>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::SMEM);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const dim3 grid((m + C::TM - 1) / C::TM, B);
  kernel<<<grid, NT, C::SMEM, stream>>>(A, W, H, HHT, eps, m, n, k, W_out, WTWp);
  return cudaGetLastError();
}

template <int KP>
cudaError_t launch_kp(const float* A, const float* W, const float* H,
                      const float* HHT, float eps, int B, int m, int n, int k,
                      float* W_out, float* WTWp, cudaStream_t s) {
  // 16-byte loads need every row of A and H aligned
  const bool vec = n % 4 == 0 &&
      (reinterpret_cast<uintptr_t>(A) | reinterpret_cast<uintptr_t>(H)) % 16 == 0;
  return vec ? launch<KP, true>(A, W, H, HHT, eps, B, m, n, k, W_out, WTWp, s)
             : launch<KP, false>(A, W, H, HHT, eps, B, m, n, k, W_out, WTWp, s);
}

cudaError_t dispatch(const void* A_, const void* W_, const void* H_,
                     const void* HHT_, float eps, int B, int m, int n, int k,
                     void* W_out_, void* WTWp_, cudaStream_t s) {
  const auto A = static_cast<const float*>(A_), W = static_cast<const float*>(W_),
             H = static_cast<const float*>(H_), HHT = static_cast<const float*>(HHT_);
  const auto W_out = static_cast<float*>(W_out_), WTWp = static_cast<float*>(WTWp_);
  if (k <= 8) return launch_kp<8>(A, W, H, HHT, eps, B, m, n, k, W_out, WTWp, s);
  if (k <= 16) return launch_kp<16>(A, W, H, HHT, eps, B, m, n, k, W_out, WTWp, s);
  if (k <= 32) return launch_kp<32>(A, W, H, HHT, eps, B, m, n, k, W_out, WTWp, s);
  return launch_kp<64>(A, W, H, HHT, eps, B, m, n, k, W_out, WTWp, s);
}

}  // namespace f32

// WTW[i] = sum over panels p = 0, 1, ..., P - 1 of WTWp[b][p][i] for the
// member b of i, in that order: the TPU kernel's carry order, whatever order
// the panels ran in
__global__ void __launch_bounds__(256)
wtw_panel_sum_kernel(const float* __restrict__ WTWp, int P, int kk, int total,
                     float* __restrict__ WTW) {
  for (int i = blockIdx.x * 256 + threadIdx.x; i < total; i += gridDim.x * 256) {
    const float* p = WTWp + (size_t)(i / kk) * P * kk + i % kk;
    float v = 0.f;
    for (int q = 0; q < P; ++q) v += p[(size_t)q * kk];
    WTW[i] = v;
  }
}

// rows per panel of the pass-1 kernel for an A of a_bytes bytes an element
// at factor width k (the panels of WTWp)
int panel_rows(int a_bytes, int k) {
  if (a_bytes == 4) return k <= 32 ? f32::Cfg<32>::TM : f32::Cfg<64>::TM;
  return k <= 32 ? tc::Cfg<__nv_bfloat16, 32>::TM : tc::Cfg<__nv_bfloat16, 64>::TM;
}

// pass 1, then the panels' sum
template <typename F>
cudaError_t pass1(F&& launch, int a_bytes, int B, int m, int k, float* WTWp,
                  float* WTW, cudaStream_t s) {
  if (B < 1 || m < 1 || k < 1 || k > 64) return cudaErrorInvalidValue;
  cudaError_t err = launch();
  if (err != cudaSuccess) return err;
  const int P = (m + panel_rows(a_bytes, k) - 1) / panel_rows(a_bytes, k);
  const int total = B * k * k;
  const int blocks = (total + 255) / 256 < 1024 ? (total + 255) / 256 : 1024;
  wtw_panel_sum_kernel<<<blocks, 256, 0, s>>>(WTWp, P, k * k, total, WTW);
  return cudaGetLastError();
}


}  // namespace

// Plain C interface, bound with ctypes: pass 1 of K1 and the panels' sum.
// A is (B, m, n) in f32 (fused_mu_fro_f32), bf16 (fused_mu_fro_bf16), f16
// (fused_mu_fro_f16) or uint8 (fused_mu_fro_u8); H is (B, k, n), f32 for an
// f32 A, f16 for an f16 A and bf16 for a bf16 or uint8 A (rounded by the
// caller); W and W_out are (B, m, k), HHT is (B, k, k), WTWp is the (B, P,
// k, k) scratch of the panels' W'^T W' (P = ceil(m / fused_mu_fro_geometry's
// panel rows)) and WTW is (B, k, k), all f32; everything contiguous, 1 <= k
// <= 64. Returns the CUDA error code of the launches (0 on success).
#define FUSED_MU_FRO(SUFFIX, BYTES, CALL)                                           \
  extern "C" int fused_mu_fro_##SUFFIX(const void* A, const void* W, const void* H, \
                                       const void* HHT, float eps, int B, int m,    \
                                       int n, int k, void* W_out, void* WTWp,       \
                                       void* WTW, void* stream) {                   \
    const auto s = static_cast<cudaStream_t>(stream);                               \
    if (n < 1) return (int)cudaErrorInvalidValue;                                   \
    return (int)pass1(                                                              \
        [&] { return CALL(A, W, H, HHT, eps, B, m, n, k, W_out, WTWp, s); }, BYTES, \
        B, m, k, static_cast<float*>(WTWp), static_cast<float*>(WTW), s);           \
  }
FUSED_MU_FRO(f32, 4, f32::dispatch)
FUSED_MU_FRO(bf16, 2, tc::dispatch<__nv_bfloat16>)
FUSED_MU_FRO(f16, 2, tc::dispatch<__half>)
FUSED_MU_FRO(u8, 1, tc::dispatch<uint8_t>)

// *panel_rows: the rows per panel of pass 1 for an A of a_bytes bytes an
// element (4, 2 or 1) at factor width k (1 <= k <= 64). Returns 0, or the
// error code of an invalid value.
extern "C" int fused_mu_fro_geometry(int a_bytes, int k, int* rows) {
  if (k < 1 || k > 64 || (a_bytes != 4 && a_bytes != 2 && a_bytes != 1))
    return (int)cudaErrorInvalidValue;
  *rows = panel_rows(a_bytes, k);
  return 0;
}

extern "C" const char* fused_mu_fro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
