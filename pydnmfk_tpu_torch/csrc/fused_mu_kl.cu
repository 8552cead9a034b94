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
// Design on Hopper: K1's two-sweep structure (csrc/fused_mu_fro.cu). One
// block of 256 threads owns a panel of TM = 64 rows of one member (grid =
// row panels x members, so the member stack of an NMFk ensemble is one
// launch). W'_i needs U_i H^T over all of n before any U'_i exists, so:
//   sweep 1 loops over column tiles of TN = 64: it forms W_i H_j in
//     registers from the W panel and an H tile in shared memory, overwrites
//     the A tile with U, and accumulates U_i H^T (TM x k) in registers;
//   then it forms W'_i, writes it out and keeps it in shared memory;
//   sweep 2 re-reads each A tile, forms W'_i H_j and U', and adds
//     W'_i^T U'_i into WTU.
// The TPU kernel carries WTU from one grid step to the next; Hopper runs the
// panels in parallel, so that carry becomes f32 atomicAdd into the zeroed
// WTU, as in K1. A deterministic second pass would need a (panels x k x n)
// f32 scratch, 4.4 GB at 57600 x 38400, k = 32: half of A's bytes again.
// The atomics' order varies from run to run; the sums agree with the plain
// version to f32 rounding. A is never padded or copied (the JAX caller pads
// it to its row tile, an 8.8 GB copy at full size): the ragged edges of m
// and n load as zeros, which give U = 0 and W' = 0 and add nothing.
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
// 0.66 ms uint8). This simple version reads A twice and runs CUDA-core FMAs
// fed from shared memory, like K2a + K2b together; tensor cores (wgmma), TMA
// pipelines and tuning are later work. k is padded to 8, 16, 32 or 64 with
// zeros inside the block (MAX_K = 64 in ops/fused_kl.py).
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

}  // namespace

// Plain C interface, bound with ctypes. A is (B, m, n) in f32, bf16 or
// uint8; W and W_out are (B, m, k), H is (B, k, n), hrs is (B, k) and WTU is
// (B, k, n), all f32, contiguous, and WTU zeroed by the caller. Returns the
// CUDA error code of the launch (0 on success).
extern "C" int fused_mu_kl_f32(const void* A, const void* W, const void* H,
                               const void* hrs, float eps, int B, int m, int n,
                               int k, void* W_out, void* WTU, void* stream) {
  return (int)dispatch<float>(A, W, H, hrs, eps, B, m, n, k, W_out, WTU,
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
