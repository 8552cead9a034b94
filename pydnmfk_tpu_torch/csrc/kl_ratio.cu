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
// the block, so each output element is owned by one block and summed in a
// fixed order: no atomics, deterministic results.
//
//   K2a: one block of 256 threads per (row tile of TM = 64 rows, member);
//        it loops over column tiles of TN = 64, forms W_i H_j, U = A / (WH +
//        eps) in shared memory, and accumulates U H_j^T in registers.
//   K2b: one block per (column tile of TN = 64 columns, member); it loops
//        over row tiles and accumulates W_i^T U in registers.
//
// k is padded to the next of 8, 16, ..., 256 with zeros inside the block
// (not to the TPU's 128 lanes). The ragged edges of m and n load as zeros,
// which give U = 0 and add nothing; A is never padded or copied.
//
// What bounds it: each A element costs 4k flops (2k for WH, 2k for the
// product) plus one division against 4 bytes read once, far above the card's
// f32 CUDA-core balance, so the kernels are bound by shared-memory operand
// traffic into CUDA-core FMAs and by the division. Tensor cores (wgmma) for
// both products, TMA pipelines and tuning are later work. A bf16 or uint8 A
// is widened exactly to f32 as it is loaded (a uint8 A one byte load per
// element, so any n works); all arithmetic is f32, as in the plain path and
// in pydnmfk_tpu/ops/kl.py:33-34, which divides the integer A by an f32 WH.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int TM = 64;        // rows per tile
constexpr int TN = 64;        // columns per tile
constexpr int NT = 256;       // threads per block (8 warps)
constexpr int LDA = TN + 1;   // padded row stride of the A / U tile

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
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

template <typename T, int KP>
cudaError_t launch(bool uht, const void* A, const void* W, const void* H,
                   float eps, int B, int m, int n, int k, void* out,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<KP>();
  using Kernel = void (*)(const T*, const float*, const float*, float, int,
                          int, int, float*);
  const Kernel kernel = uht ? &kl_uht_kernel<T, KP> : &kl_wtu_kernel<T, KP>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(uht ? (m + TM - 1) / TM : (n + TN - 1) / TN, B);
  kernel<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(A), static_cast<const float*>(W),
      static_cast<const float*>(H), eps, m, n, k, static_cast<float*>(out));
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(bool uht, const void* A, const void* W, const void* H,
                     float eps, int B, int m, int n, int k, void* out,
                     cudaStream_t s) {
  if (B < 1 || m < 1 || n < 1 || k < 1) return cudaErrorInvalidValue;
  if (k <= 8) return launch<T, 8>(uht, A, W, H, eps, B, m, n, k, out, s);
  if (k <= 16) return launch<T, 16>(uht, A, W, H, eps, B, m, n, k, out, s);
  if (k <= 32) return launch<T, 32>(uht, A, W, H, eps, B, m, n, k, out, s);
  if (k <= 64) return launch<T, 64>(uht, A, W, H, eps, B, m, n, k, out, s);
  if (k <= 128) return launch<T, 128>(uht, A, W, H, eps, B, m, n, k, out, s);
  if (k <= 256) return launch<T, 256>(uht, A, W, H, eps, B, m, n, k, out, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// Plain C interface, bound with ctypes. A is (B, m, n) in f32, bf16 or uint8; W is
// (B, m, k) and H is (B, k, n) in f32, all contiguous. out is (B, m, k) for
// UHT and (B, k, n) for WTU, f32; every element is written. Returns the CUDA
// error code of the launch (0 on success).
extern "C" int kl_uht_f32(const void* A, const void* W, const void* H,
                          float eps, int B, int m, int n, int k, void* out,
                          void* stream) {
  return (int)dispatch<float>(true, A, W, H, eps, B, m, n, k, out,
                              static_cast<cudaStream_t>(stream));
}

extern "C" int kl_uht_bf16(const void* A, const void* W, const void* H,
                           float eps, int B, int m, int n, int k, void* out,
                           void* stream) {
  return (int)dispatch<__nv_bfloat16>(true, A, W, H, eps, B, m, n, k, out,
                                      static_cast<cudaStream_t>(stream));
}

extern "C" int kl_wtu_f32(const void* A, const void* W, const void* H,
                          float eps, int B, int m, int n, int k, void* out,
                          void* stream) {
  return (int)dispatch<float>(false, A, W, H, eps, B, m, n, k, out,
                              static_cast<cudaStream_t>(stream));
}

extern "C" int kl_wtu_bf16(const void* A, const void* W, const void* H,
                           float eps, int B, int m, int n, int k, void* out,
                           void* stream) {
  return (int)dispatch<__nv_bfloat16>(false, A, W, H, eps, B, m, n, k, out,
                                      static_cast<cudaStream_t>(stream));
}

extern "C" int kl_uht_u8(const void* A, const void* W, const void* H,
                         float eps, int B, int m, int n, int k, void* out,
                         void* stream) {
  return (int)dispatch<uint8_t>(true, A, W, H, eps, B, m, n, k, out,
                                static_cast<cudaStream_t>(stream));
}

extern "C" int kl_wtu_u8(const void* A, const void* W, const void* H,
                         float eps, int B, int m, int n, int k, void* out,
                         void* stream) {
  return (int)dispatch<uint8_t>(false, A, W, H, eps, B, m, n, k, out,
                                static_cast<cudaStream_t>(stream));
}

extern "C" const char* kl_ratio_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
