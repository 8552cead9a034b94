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
// Design on Hopper. One block of 256 threads owns a panel of TM = 64 rows of
// one member (grid = row panels x members). W'_i needs A_i H^T over all of
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

__device__ __forceinline__ float to_f32(float x) { return x; }
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

}  // namespace

// Plain C interface, bound with ctypes. A is (B, m, n) in f32, bf16 or uint8; W and
// W_out are (B, m, k), H is (B, k, n), HHT is (B, k, k), WTA is (B, k, n) and
// WTW is (B, k, k), all f32, contiguous, and WTA/WTW zeroed by the caller.
// Returns the CUDA error code of the launch (0 on success).
extern "C" int fused_mu_fro_f32(const void* A, const void* W, const void* H,
                                const void* HHT, float eps, int B, int m, int n,
                                int k, void* W_out, void* WTA, void* WTW,
                                void* stream) {
  return (int)dispatch<float>(A, W, H, HHT, eps, B, m, n, k, W_out, WTA, WTW,
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
