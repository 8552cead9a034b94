// K4: the ELL gather product of the sparse MU products,
//
//     out[e, b, :] = sum_s coef[e, b, s] * T[e, idx[b, s], :]
//     coef = vals[e, b, s]                                     (plain)
//     coef = vals[e, b, s] / (<X[e, b, :], T[e, idx[b, s], :]> + eps)  (ratio)
//
// for members e, lines b (the rows of A, or its columns) and ELL slots s.
// The row orientation takes T = H^T (A H^T; with X = W, the KL product UHT),
// the column orientation T = W (W^T A; with X = H^T, WTU).
//
// Replaces pydnmfk_tpu/ops/pallas_ell.py::_kernel (called from
// _gather_product_pallas). The TPU kernel holds the whole table in VMEM and
// streams (512, w) tiles of vals/idx past it. A Hopper block has 227 KB of
// shared memory, and the tables are megabytes, so the port does not carry
// that over. The table stays in device memory and is read through the
// 50 MB L2: at NYTimes size (300000 x 102660, k = 32) H^T is 13 MB and W is
// 38 MB, so a member's table stays resident while its lines stream past.
//
// Layout: L lanes own one output line and hold it in registers, 4 columns
// per lane (L = 8 at k <= 32: 8 lanes x float4 cover one 128-byte row of T).
// The group walks its line's w slots L at a time: each lane loads one
// (val, idx) pair (coalesced along the line), and the group then takes the L
// slots in turn, the pair broadcast by a shuffle, gathering T's row as one
// contiguous segment. The L gathers of a turn are independent, so several
// are in flight at once. In ratio mode the dot product with X is a shuffle
// reduction inside the group over the same gathered row: one gather per KL
// product, as in ops/ell.py. Members are the slowest grid axis (blockIdx.y),
// so one member's table stays hot in L2. Each output line is written once,
// by one group: no atomics, and the result is deterministic.
//
// What bounds it: from device memory it streams vals and idx once (8 bytes
// per slot at f32), reads the table once and writes the output once; the
// flop count is 2 nnz k (plain) or 4 nnz k (ratio). The product itself needs
// those 8 bytes for the nonzeros only: the padding slots are the format's
// cost, and the bound counts nnz on both sides. The gathers move
// slots x k x 4 bytes more, served from L2, not from device memory; that L2
// traffic (4k bytes against 8 bytes streamed per slot) is what bounds this
// simple kernel. A tiled or sorted gather order, and tuning, are later work.
//
// k is padded to a power of two in [4, 256] inside the kernel; columns past
// k load as zeros and are never stored. Rows of T are loaded as float4 when
// k is a multiple of 4 and the pointers are 16-byte aligned, else as
// scalars. Padding slots (val = 0, idx = 0) are inert. vals may be bf16; it
// is widened to f32 as it is loaded, and all arithmetic is f32.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int NT = 256;                  // threads per block (8 warps)
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// L lanes per line, NQ chunks of 4 columns per lane: lane g of a group holds
// columns (q * L + g) * 4 + j for q < NQ, j < 4.
template <int KP>
struct Layout {
  static constexpr int L = KP / 4 < 32 ? KP / 4 : 32;
  static constexpr int NQ = KP / (4 * L);
  static constexpr int LINES = NT / L;   // lines per block
};

// r <- p[c, c + 4), zeros at and past column k.
template <bool VEC>
__device__ __forceinline__ void load4(float (&r)[4], const float* __restrict__ p,
                                      int c, int k) {
  if (VEC) {
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (c < k) v = __ldg(reinterpret_cast<const float4*>(p + c));
    r[0] = v.x; r[1] = v.y; r[2] = v.z; r[3] = v.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) r[j] = (c + j < k) ? __ldg(p + c + j) : 0.f;
  }
}

template <typename V, int KP, bool RATIO, bool VEC>
__global__ void __launch_bounds__(NT)
ell_gather_kernel(const V* __restrict__ vals, const int* __restrict__ idx,
                  const float* __restrict__ T, const float* __restrict__ X,
                  float eps, int dim, int w, int dim_t, int k,
                  float* __restrict__ out) {
  constexpr int L = Layout<KP>::L, NQ = Layout<KP>::NQ;
  const int e = blockIdx.y;
  const int g = threadIdx.x % L;
  const int line = blockIdx.x * Layout<KP>::LINES + threadIdx.x / L;
  const bool live = line < dim;
  const int b = live ? line : 0;
  vals += ((size_t)e * dim + b) * w;
  idx += (size_t)b * w;
  T += (size_t)e * dim_t * k;

  float x[NQ][4];
  if (RATIO) {
    const float* xr = X + ((size_t)e * dim + b) * k;
#pragma unroll
    for (int q = 0; q < NQ; ++q) load4<VEC>(x[q], xr, (q * L + g) * 4, k);
  }
  float acc[NQ][4];
#pragma unroll
  for (int q = 0; q < NQ; ++q)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[q][j] = 0.f;

  for (int s0 = 0; s0 < w; s0 += L) {
    const int s = s0 + g;
    float v = 0.f;
    int id = 0;
    if (live && s < w) {
      v = to_f32(vals[s]);
      id = idx[s];
    }
    const int ns = min(L, w - s0);       // the same for every lane of the warp
#pragma unroll
    for (int t = 0; t < L; ++t) {
      if (t < ns) {
        const float vt = __shfl_sync(FULL, v, t, L);
        const int it = __shfl_sync(FULL, id, t, L);
        const float* row = T + (size_t)it * k;
        float r[NQ][4];
#pragma unroll
        for (int q = 0; q < NQ; ++q) load4<VEC>(r[q], row, (q * L + g) * 4, k);
        float coef = vt;
        if (RATIO) {
          float d = 0.f;
#pragma unroll
          for (int q = 0; q < NQ; ++q)
#pragma unroll
            for (int j = 0; j < 4; ++j) d += x[q][j] * r[q][j];
#pragma unroll
          for (int o = L / 2; o > 0; o >>= 1) d += __shfl_xor_sync(FULL, d, o, L);
          coef = vt / (d + eps);
        }
#pragma unroll
        for (int q = 0; q < NQ; ++q)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[q][j] += coef * r[q][j];
      }
    }
  }
  if (!live) return;
  float* o = out + ((size_t)e * dim + line) * k;
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    const int c = (q * L + g) * 4;
    if (VEC) {
      if (c < k) *reinterpret_cast<float4*>(o + c) =
          make_float4(acc[q][0], acc[q][1], acc[q][2], acc[q][3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (c + j < k) o[c + j] = acc[q][j];
    }
  }
}

template <typename V, int KP, bool RATIO>
cudaError_t launch(const void* vals, const void* idx, const void* T,
                   const void* X, float eps, int B, int dim, int w, int dim_t,
                   int k, void* out, bool vec, cudaStream_t stream) {
  const dim3 grid((dim + Layout<KP>::LINES - 1) / Layout<KP>::LINES, B);
  auto kernel = vec ? &ell_gather_kernel<V, KP, RATIO, true>
                    : &ell_gather_kernel<V, KP, RATIO, false>;
  kernel<<<grid, NT, 0, stream>>>(
      static_cast<const V*>(vals), static_cast<const int*>(idx),
      static_cast<const float*>(T), static_cast<const float*>(X), eps, dim, w,
      dim_t, k, static_cast<float*>(out));
  return cudaGetLastError();
}

template <typename V, bool RATIO>
cudaError_t dispatch_k(const void* vals, const void* idx, const void* T,
                       const void* X, float eps, int B, int dim, int w,
                       int dim_t, int k, void* out, bool vec, cudaStream_t s) {
  if (k <= 4) return launch<V, 4, RATIO>(vals, idx, T, X, eps, B, dim, w, dim_t, k, out, vec, s);
  if (k <= 8) return launch<V, 8, RATIO>(vals, idx, T, X, eps, B, dim, w, dim_t, k, out, vec, s);
  if (k <= 16) return launch<V, 16, RATIO>(vals, idx, T, X, eps, B, dim, w, dim_t, k, out, vec, s);
  if (k <= 32) return launch<V, 32, RATIO>(vals, idx, T, X, eps, B, dim, w, dim_t, k, out, vec, s);
  if (k <= 64) return launch<V, 64, RATIO>(vals, idx, T, X, eps, B, dim, w, dim_t, k, out, vec, s);
  if (k <= 128) return launch<V, 128, RATIO>(vals, idx, T, X, eps, B, dim, w, dim_t, k, out, vec, s);
  return launch<V, 256, RATIO>(vals, idx, T, X, eps, B, dim, w, dim_t, k, out, vec, s);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

template <typename V>
int dispatch(const void* vals, const void* idx, const void* T, const void* X,
             float eps, int ratio, int B, int dim, int w, int dim_t, int k,
             void* out, void* stream) {
  if (B < 1 || B > 65535 || dim < 1 || w < 1 || dim_t < 1 || k < 1 || k > 256 ||
      (ratio && X == nullptr))
    return (int)cudaErrorInvalidValue;
  const bool vec = k % 4 == 0 && aligned16(T) && aligned16(out) &&
                   (!ratio || aligned16(X));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      ratio ? dispatch_k<V, true>(vals, idx, T, X, eps, B, dim, w, dim_t, k, out, vec, s)
            : dispatch_k<V, false>(vals, idx, T, X, eps, B, dim, w, dim_t, k, out, vec, s);
  return (int)err;
}

}  // namespace

// Plain C interface, bound with ctypes. vals is (B, dim, w) in f32 or bf16,
// idx (dim, w) int32 with entries in [0, dim_t), T (B, dim_t, k) f32, X
// (B, dim, k) f32 or null (plain mode), out (B, dim, k) f32; all contiguous.
// Every element of out is written. Returns the CUDA error code of the launch
// (0 on success).
extern "C" int ell_gather_f32(const void* vals, const void* idx, const void* T,
                              const void* X, float eps, int ratio, int B,
                              int dim, int w, int dim_t, int k, void* out,
                              void* stream) {
  return dispatch<float>(vals, idx, T, X, eps, ratio, B, dim, w, dim_t, k, out,
                         stream);
}

extern "C" int ell_gather_bf16(const void* vals, const void* idx, const void* T,
                               const void* X, float eps, int ratio, int B,
                               int dim, int w, int dim_t, int k, void* out,
                               void* stream) {
  return dispatch<__nv_bfloat16>(vals, idx, T, X, eps, ratio, B, dim, w,
                                 dim_t, k, out, stream);
}

extern "C" const char* ell_gather_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
