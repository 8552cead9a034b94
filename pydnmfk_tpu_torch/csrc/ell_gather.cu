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
// shared memory and the tables are megabytes (1.6-6.4 MB a member on the
// NMFk sweep's topic matrix, 13-38 MB at the NYTimes shape), so the table
// stays in device memory and is read through the 50 MB L2.
//
// What bounds it: from device memory it streams vals and idx once (8 bytes
// per nonzero at f32), reads the table once and writes the output once; the
// flops are 2 nnz k (plain) or 4 nnz k (ratio). On top of that every slot
// gathers one k-float row of the table from L2, and that traffic, with the
// L1 wavefronts and instructions it costs, is what bounds the kernel.
//
// k <= 32 (grouped_kernel below): the NMFk ensemble runs the product on
// member stacks over one index (the B members share idx). The wrapper
// interleaves the table so that the members of a group of G sit side by
// side: (dim_t, G, KP) per group, each member's row padded to KP = 4, 8, 16,
// 32 floats (zeros past k). One slot's index then names one contiguous,
// 16-byte-aligned run of G x KP x 4 bytes (256 at G = 8, KP = 8), where the
// first port gathered G rows of k x 4 bytes from G tables, each as masked
// scalar loads at k % 4 != 0 (28-byte rows straddling sectors at k = 7).
//   * Lanes: a line takes L = G x KP / 4 lanes, lane (m, q) member m's
//     columns [4q, 4q + 4); it loads the slot's run with one float4 and
//     keeps its four sums in registers. A block of 256 threads takes 256 / L
//     lines of one group; groups are the grid's slow axis, so a group's
//     table stays in L2 while its lines stream past. The wrapper bounds G so
//     that a group's table fits a share of the L2 (ops/ell_gather.py's
//     member_groups, on the geometry exported below); the last group holds
//     the B % G members left, and its spare lanes load nothing.
//   * Values and indices: the members' values lie dim x w apart, so the
//     block stages a chunk of S = 2 KP slots of its lines, (G, lines, S)
//     values and (lines, S) indices, in shared memory, read from device
//     memory along s (coalesced) by cp.async one chunk ahead (two buffers;
//     bf16 and f16 values go through registers and are widened, exactly: a
//     bf16 by a shift, an f16 by its conversion). A slot's index is then read from shared memory as a
//     broadcast, once for all G members, and the strides of the staged
//     tiles put the G x lines-per-warp values that a warp reads in distinct
//     banks.
//   * Occupancy: a gather waits on L2, and the latency is hidden by warps:
//     the kernel is bounded to four blocks per SM (64 registers) in plain
//     mode and three (85) in ratio mode, where the dot product spills at
//     64. The table's interleave is one more small kernel (interleave_kernel,
//     a pass over the table), launched by the wrapper before the product.
//   * Division: __fdividef (within 2 ulp; <X, row> + eps lies in (0,
//     2^126) for nonnegative factors), as K2 divides; IEEE `/` adds a slow
//     path and its registers.
//   * Order: each output element is summed by one lane in ascending slot
//     order; the ratio's <X, row> is summed over a lane's four columns and
//     then a butterfly over its member's KP / 4 lanes, neither of which
//     depends on G. So a member's result is the same bitwise in every group
//     size, B = 1 (G = 1) included. No atomics.
//
// k > 32 (legacy::ell_gather_kernel, the first port's kernel): L lanes own
// one output line, 4 columns a lane (L = KP / 4 up to 32); the group walks
// the line's slots L at a time, each lane loading one (val, idx) pair and
// passing it round by shuffles, and gathers the member's row from its own
// table (member on the grid's y axis). Rows load as float4 when k % 4 == 0
// and the pointers are 16-byte aligned, else as scalars. Its launch bounds
// now ask for four blocks per SM: without them ptxas kept the ratio
// instantiations with 16-byte loads at KP = 64, 128 to 32 registers and
// spilled 16-24 bytes.
//
// k > 256: the output is covered in slabs of 256 columns, the grid's z axis
// (row stride ld = k for T, X and out). The plain modes' columns are
// independent, so the KP = 256 kernel runs each slab as it runs k <= 256.
// The ratio modes need <X[b, :], T[idx, :]> over all of k before any slab's
// product: legacy::ell_gather_wide_kernel sums each slot's dot over the
// whole row (a loop of 128 columns a step over the warp's 32 lanes), then
// adds the slab's columns. So past 256 a ratio product reads its gathered
// rows ceil(k / 256) + 1 times and does the dot ceil(k / 256) times: a
// simple design, for widths no measured path needs to be fast at yet.
//
// Padding slots (val = 0, idx = 0) are inert. vals may be bf16 or f16; all
// arithmetic is f32.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

namespace {

// The first port's kernel, kept for k > 32 (KP = 64, 128, 256).
namespace legacy {

constexpr int NT = 256;                  // threads per block (8 warps)
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

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

// o[c .. c + 4) <- acc[q] for the lane's columns c = (q L + g) 4, past k
// not written
template <int NQ, int L, bool VEC>
__device__ __forceinline__ void store_line(float* __restrict__ o, const float (&acc)[NQ][4],
                                           int g, int k) {
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

template <typename V, int KP, bool RATIO, bool VEC>
__global__ void __launch_bounds__(NT, 4)
ell_gather_kernel(const V* __restrict__ vals, const int* __restrict__ idx,
                  const float* __restrict__ T, const float* __restrict__ X,
                  float eps, int dim, int w, int dim_t, int ld,
                  float* __restrict__ out) {
  constexpr int L = Layout<KP>::L, NQ = Layout<KP>::NQ;
  const int e = blockIdx.y;
  const int c0 = blockIdx.z * KP;        // the slab's first column (ratio: 0)
  const int k = min(KP, ld - c0);        // and its width
  const int g = threadIdx.x % L;
  const int line = blockIdx.x * Layout<KP>::LINES + threadIdx.x / L;
  const bool live = line < dim;
  const int b = live ? line : 0;
  vals += ((size_t)e * dim + b) * w;
  idx += (size_t)b * w;
  T += (size_t)e * dim_t * ld + c0;

  float x[NQ][4];
  if (RATIO) {
    const float* xr = X + ((size_t)e * dim + b) * ld;
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
        const float* row = T + (size_t)it * ld;
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
  store_line<NQ, L, VEC>(out + ((size_t)e * dim + line) * ld + c0, acc, g, k);
}

// The ratio modes past 256 columns: block (lines x, member y, slab z) adds
// coef T[idx, slab] over the slots of 8 lines, one warp a line, where coef =
// val / (<X[b, :], T[idx, :]> + eps) is summed over all ld columns first.
template <typename V, int KP, bool RATIO, bool VEC>
__global__ void __launch_bounds__(NT, 4)
ell_gather_wide_kernel(const V* __restrict__ vals, const int* __restrict__ idx,
                       const float* __restrict__ T, const float* __restrict__ X,
                       float eps, int dim, int w, int dim_t, int ld,
                       float* __restrict__ out) {
  static_assert(RATIO && KP == 256, "the wide kernel is the ratio slab of 256");
  constexpr int L = 32, NQ = KP / (4 * L);
  const int e = blockIdx.y;
  const int c0 = blockIdx.z * KP;
  const int k = min(KP, ld - c0);
  const int g = threadIdx.x % L;
  const int line = blockIdx.x * (NT / L) + threadIdx.x / L;
  const bool live = line < dim;
  const int b = live ? line : 0;
  vals += ((size_t)e * dim + b) * w;
  idx += (size_t)b * w;
  T += (size_t)e * dim_t * ld;
  const float* xr = X + ((size_t)e * dim + b) * ld;

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
#pragma unroll 1
    for (int t = 0; t < ns; ++t) {
      const float vt = __shfl_sync(FULL, v, t);
      const int it = __shfl_sync(FULL, id, t);
      const float* row = T + (size_t)it * ld;
      float d = 0.f;
      for (int c = 4 * g; c < ld; c += 4 * L) {
        float x4[4], r4[4];
        load4<VEC>(x4, xr, c, ld);
        load4<VEC>(r4, row, c, ld);
#pragma unroll
        for (int j = 0; j < 4; ++j) d += x4[j] * r4[j];
      }
#pragma unroll
      for (int o = L / 2; o > 0; o >>= 1) d += __shfl_xor_sync(FULL, d, o);
      const float coef = vt / (d + eps);
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        float r[4];
        load4<VEC>(r, row + c0, (q * L + g) * 4, k);
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[q][j] += coef * r[j];
      }
    }
  }
  if (!live) return;
  store_line<NQ, L, VEC>(out + ((size_t)e * dim + line) * ld + c0, acc, g, k);
}

// ld: the rows' width k; past KP, one slab of KP columns per grid z (the
// ratio modes on the wide kernel)
template <typename V, int KP, bool RATIO>
cudaError_t launch(const void* vals, const void* idx, const void* T,
                   const void* X, float eps, int B, int dim, int w, int dim_t,
                   int ld, void* out, bool vec, cudaStream_t stream) {
  const int slabs = (ld + KP - 1) / KP;
  if (slabs > 65535) return cudaErrorInvalidValue;
  const dim3 grid((dim + Layout<KP>::LINES - 1) / Layout<KP>::LINES, B, slabs);
  using Kernel = void (*)(const V*, const int*, const float*, const float*, float,
                          int, int, int, int, float*);
  Kernel kernel = vec ? &ell_gather_kernel<V, KP, RATIO, true>
                      : &ell_gather_kernel<V, KP, RATIO, false>;
  if constexpr (RATIO && KP == 256) {
    if (slabs > 1)
      kernel = vec ? &ell_gather_wide_kernel<V, KP, RATIO, true>
                   : &ell_gather_wide_kernel<V, KP, RATIO, false>;
  }
  kernel<<<grid, NT, 0, stream>>>(
      static_cast<const V*>(vals), static_cast<const int*>(idx),
      static_cast<const float*>(T), static_cast<const float*>(X), eps, dim, w,
      dim_t, ld, static_cast<float*>(out));
  return cudaGetLastError();
}

}  // namespace legacy

namespace grouped {

constexpr int NT = 256;                  // threads per block (8 warps)
// resident blocks per SM: four (64 registers) for the plain product, three
// (85) for the ratio, whose dot product and shuffles spill at 64
template <bool RATIO> constexpr int MIN_BLOCKS = RATIO ? 3 : 4;
constexpr int MAX_G = 8;                 // most members a group gathers
constexpr unsigned FULL = 0xffffffffu;

// The staging layout of a (KP, G) instantiation, in 4-byte words.
template <int KP, int G>
struct Geom {
  static constexpr int Q = KP / 4;       // lanes per member, 4 columns each
  static constexpr int L = G * Q;        // lanes per line
  static_assert(L <= 32 && 32 % L == 0, "a line's lanes lie in one warp");
  static constexpr int LPW = 32 / L;     // lines per warp
  static constexpr int LINES = NT / L;   // lines per block
  static constexpr int S = 8 * Q;        // slots per staged chunk
  static constexpr int LS = S + 1;       // line stride (odd)
  // member stride: at least LINES x LS and congruent to LPW x LS mod 32, so
  // that word m MS + j LS of member m, warp line j falls in bank
  // (m LPW + j) LS mod 32: distinct for the G x LPW pairs of a warp
  static constexpr int MS =
      LINES * LS + (((LPW * LS - LINES * LS) % 32) + 32) % 32;
  static constexpr int VN = G * LINES * S / NT;   // values a thread stages (8)
  static constexpr int IN = LINES * S / NT;       // indices a thread stages
  static constexpr int BUF = G * MS + LINES * LS; // one buffer: values, indices
  static constexpr size_t smem() { return 2 * sizeof(float) * (size_t)BUF; }
};

// dst <- *src (4 bytes) asynchronously, or zeros where !valid
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// a 16-bit value's bits as the f32 of the same value, exactly
template <typename V>
__device__ __forceinline__ float widen16(unsigned short x) {
  if constexpr (std::is_same<V, __half>::value) {
    return __half2float(__ushort_as_half(x));
  } else {
    return __uint_as_float((unsigned)x << 16);   // bf16: the upper half
  }
}

// Ti: the interleaved table, group after group: members [gG, gG + gg) as
// (dim_t, gg, KP), gg = min(G, B - gG)
template <typename V, int KP, int G, bool RATIO>
__global__ void __launch_bounds__(NT, MIN_BLOCKS<RATIO>)
grouped_kernel(const V* __restrict__ vals_, const int* __restrict__ idx,
               const float* __restrict__ Ti, const float* __restrict__ X,
               float eps, int B, int dim, int w, int dim_t, int k,
               float* __restrict__ out) {
  using Gm = Geom<KP, G>;
  constexpr bool F32 = std::is_same<V, float>::value;
  using R = typename std::conditional<F32, float, unsigned short>::type;
  constexpr int Q = Gm::Q, L = Gm::L, LINES = Gm::LINES, S = Gm::S;
  constexpr int LS = Gm::LS, MS = Gm::MS;
  extern __shared__ float smem[];        // two buffers: (G, LINES, LS) values, (LINES, LS) indices
  const R* vals = reinterpret_cast<const R*>(vals_);
  const int tid = threadIdx.x;
  const int e0 = blockIdx.y * G;
  const int gg = min(G, B - e0);         // members in this group
  const int b0 = blockIdx.x * LINES;
  const int ll = tid / L, m = tid % L / Q, q = tid % Q;
  const int line = b0 + ll;
  const bool live = line < dim && m < gg;
  const int rs = gg * KP;                // the group's table row, in floats
  const float* trow = Ti + (size_t)e0 * dim_t * KP + (m < gg ? m : 0) * KP + q * 4;

  float x[4];
  if (RATIO) {
    const float* xr = X + ((size_t)(e0 + (m < gg ? m : 0)) * dim +
                           (line < dim ? line : 0)) * k;
#pragma unroll
    for (int j = 0; j < 4; ++j) x[j] = live && q * 4 + j < k ? __ldg(xr + q * 4 + j) : 0.f;
  }
  float acc[4] = {0.f, 0.f, 0.f, 0.f};

  // stages the chunk of slots [s0, s0 + S) into buffer buf, read along s
  // (coalesced): f32 values and the indices by cp.async, bf16 values
  // through registers, widened
  const auto stage = [&](int s0, int buf) {
    float* sv = smem + buf * Gm::BUF;
    int* si = reinterpret_cast<int*>(sv + G * MS);
#pragma unroll 4
    for (int j = 0; j < Gm::VN; ++j) {
      const int f = j * NT + tid;
      const int mm = f / (LINES * S), l = f / S % LINES, s = f % S;
      const bool ok = mm < gg && b0 + l < dim && s0 + s < w;
      const R* src = vals + (ok ? ((size_t)(e0 + mm) * dim + b0 + l) * w + s0 + s : 0);
      float* dst = sv + mm * MS + l * LS + s;
      if constexpr (F32) cp_async4(dst, src, ok);
      else *dst = ok ? widen16<V>(__ldcs(src)) : 0.f;
    }
#pragma unroll 4
    for (int j = 0; j < Gm::IN; ++j) {
      const int f = j * NT + tid;
      const int l = f / S, s = f % S;
      const bool ok = b0 + l < dim && s0 + s < w;
      cp_async4(si + l * LS + s, idx + (ok ? (size_t)(b0 + l) * w + s0 + s : 0), ok);
    }
    cp_async_commit();
  };

  stage(0, 0);
  for (int s0 = 0, buf = 0; s0 < w; s0 += S, buf ^= 1) {
    if (s0 + S < w) stage(s0 + S, buf ^ 1);
    else cp_async_commit();              // an empty group keeps the count
    cp_async_wait_one();                 // this thread's copies of s0 landed
    __syncthreads();                     // and everyone's
    const float* vr = smem + buf * Gm::BUF + m * MS + ll * LS;
    const int* ir = reinterpret_cast<const int*>(smem + buf * Gm::BUF + G * MS) + ll * LS;
    const int ns = min(S, w - s0);       // the same for the whole block
#pragma unroll 4
    for (int t = 0; t < ns; ++t) {
      const float v = vr[t];
      float4 r4 = make_float4(0.f, 0.f, 0.f, 0.f);
      if (live) r4 = __ldg(reinterpret_cast<const float4*>(trow + (size_t)ir[t] * rs));
      const float r[4] = {r4.x, r4.y, r4.z, r4.w};
      float coef = v;
      if (RATIO) {
        float d = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) d += x[j] * r[j];
#pragma unroll
        for (int o = Q / 2; o > 0; o >>= 1) d += __shfl_xor_sync(FULL, d, o, Q);
        coef = __fdividef(v, d + eps);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[j] += coef * r[j];
    }
    __syncthreads();                     // buf is refilled two chunks on
  }
  if (!live) return;
  float* o = out + ((size_t)(e0 + m) * dim + line) * k + q * 4;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (q * 4 + j < k) o[j] = acc[j];
}

// Ti <- T (B, dim_t, k) interleaved in groups of G members, rows padded
// with zeros to KP = 2^kp_shift: group g = blockIdx.y writes its block
// (dim_t, gg, KP), gg = min(G, B - gG), from g G dim_t KP on, in order.
__global__ void __launch_bounds__(NT)
interleave_kernel(const float* __restrict__ T, float* __restrict__ Ti, int B,
                  int dim_t, int k, int kp_shift, int G) {
  const int g = blockIdx.y;
  const int gg = min(G, B - g * G);
  const int n = dim_t * gg << kp_shift;  // < 2^31 (checked by the caller)
  const float* t = T + (size_t)g * G * dim_t * k;
  float* o = Ti + ((size_t)g * G * dim_t << kp_shift);
  for (int i = blockIdx.x * NT + threadIdx.x; i < n; i += gridDim.x * NT) {
    const int c = i & ((1 << kp_shift) - 1), rm = i >> kp_shift;
    const int m = rm % gg, row = rm / gg;
    o[i] = c < k ? __ldg(t + ((size_t)m * dim_t + row) * k + c) : 0.f;
  }
}

template <typename V, int KP, int G, bool RATIO>
cudaError_t launch(const void* vals, const void* idx, const void* Ti,
                   const void* X, float eps, int B, int dim, int w, int dim_t,
                   int k, void* out, cudaStream_t stream) {
  using Gm = Geom<KP, G>;
  constexpr size_t smem = Gm::smem();
  const auto kernel = &grouped_kernel<V, KP, G, RATIO>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((dim + Gm::LINES - 1) / Gm::LINES, (B + G - 1) / G);
  kernel<<<grid, NT, smem, stream>>>(
      static_cast<const V*>(vals), static_cast<const int*>(idx),
      static_cast<const float*>(Ti), static_cast<const float*>(X), eps, B, dim,
      w, dim_t, k, static_cast<float*>(out));
  return cudaGetLastError();
}

// the largest group a KP takes: a line's lanes fit one warp
constexpr int max_group(int kp) { return 128 / kp < MAX_G ? 128 / kp : MAX_G; }

template <typename V, int KP, bool RATIO>
cudaError_t dispatch_g(int G, const void* vals, const void* idx, const void* Ti,
                       const void* X, float eps, int B, int dim, int w,
                       int dim_t, int k, void* out, cudaStream_t s) {
  switch (G) {
    case 1: return launch<V, KP, 1, RATIO>(vals, idx, Ti, X, eps, B, dim, w, dim_t, k, out, s);
    case 2: return launch<V, KP, 2, RATIO>(vals, idx, Ti, X, eps, B, dim, w, dim_t, k, out, s);
    case 4: return launch<V, KP, 4, RATIO>(vals, idx, Ti, X, eps, B, dim, w, dim_t, k, out, s);
    case 8:
      if constexpr (max_group(KP) >= 8)
        return launch<V, KP, 8, RATIO>(vals, idx, Ti, X, eps, B, dim, w, dim_t, k, out, s);
      [[fallthrough]];
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace grouped

// k's padded width: 4, 8, 16, 32 for the grouped kernel, 64, 128, 256 for
// the legacy one (k > 256: slabs of 256); 0 for k < 1
int padded_width(int k) {
  if (k < 1) return 0;
  int kp = 4;
  while (kp < k && kp < 256) kp *= 2;
  return kp;
}

template <typename V, bool RATIO>
cudaError_t dispatch_k(const void* vals, const void* idx, const void* T,
                       const void* X, float eps, int B, int dim, int w,
                       int dim_t, int k, int group, void* out, bool vec,
                       cudaStream_t s) {
  if (k > 32) {
    if (group != 0) return cudaErrorInvalidValue;
    if (k <= 64) return legacy::launch<V, 64, RATIO>(vals, idx, T, X, eps, B, dim, w, dim_t, k, out, vec, s);
    if (k <= 128) return legacy::launch<V, 128, RATIO>(vals, idx, T, X, eps, B, dim, w, dim_t, k, out, vec, s);
    return legacy::launch<V, 256, RATIO>(vals, idx, T, X, eps, B, dim, w, dim_t, k, out, vec, s);
  }
  if (k <= 4) return grouped::dispatch_g<V, 4, RATIO>(group, vals, idx, T, X, eps, B, dim, w, dim_t, k, out, s);
  if (k <= 8) return grouped::dispatch_g<V, 8, RATIO>(group, vals, idx, T, X, eps, B, dim, w, dim_t, k, out, s);
  if (k <= 16) return grouped::dispatch_g<V, 16, RATIO>(group, vals, idx, T, X, eps, B, dim, w, dim_t, k, out, s);
  return grouped::dispatch_g<V, 32, RATIO>(group, vals, idx, T, X, eps, B, dim, w, dim_t, k, out, s);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

template <typename V>
int dispatch(const void* vals, const void* idx, const void* T, const void* X,
             float eps, int ratio, int B, int dim, int w, int dim_t, int k,
             int group, void* out, void* stream) {
  if (B < 1 || B > 65535 || dim < 1 || w < 1 || dim_t < 1 || padded_width(k) == 0 ||
      (ratio && X == nullptr) || (k <= 32 && !aligned16(T)))
    return (int)cudaErrorInvalidValue;
  const bool vec = k % 4 == 0 && aligned16(T) && aligned16(out) &&
                   (!ratio || aligned16(X));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      ratio ? dispatch_k<V, true>(vals, idx, T, X, eps, B, dim, w, dim_t, k, group, out, vec, s)
            : dispatch_k<V, false>(vals, idx, T, X, eps, B, dim, w, dim_t, k, group, out, vec, s);
  return (int)err;
}

}  // namespace

// Plain C interface, bound with ctypes. vals is (B, dim, w) in f32, bf16 or
// f16,
// idx (dim, w) int32 with entries in [0, dim_t), X (B, dim, k) f32 or null
// (plain mode), out (B, dim, k) f32; all contiguous; any k >= 1. At k <= 32 T is the
// interleaved table of groups of `group` members (1, 2, 4 or 8, at most
// ell_gather_geometry's max_group): for each group, its members' rows padded
// to KP floats side by side, (dim_t, gg, KP), gg = min(group, B - first
// member), 16-byte aligned. At k > 32 group is 0 and T is (B, dim_t, k).
// Every element of out is written. Returns the CUDA error code of the
// launch (0 on success).
extern "C" int ell_gather_f32(const void* vals, const void* idx, const void* T,
                              const void* X, float eps, int ratio, int B,
                              int dim, int w, int dim_t, int k, int group,
                              void* out, void* stream) {
  return dispatch<float>(vals, idx, T, X, eps, ratio, B, dim, w, dim_t, k,
                         group, out, stream);
}

extern "C" int ell_gather_bf16(const void* vals, const void* idx, const void* T,
                               const void* X, float eps, int ratio, int B,
                               int dim, int w, int dim_t, int k, int group,
                               void* out, void* stream) {
  return dispatch<__nv_bfloat16>(vals, idx, T, X, eps, ratio, B, dim, w, dim_t,
                                 k, group, out, stream);
}

extern "C" int ell_gather_f16(const void* vals, const void* idx, const void* T,
                              const void* X, float eps, int ratio, int B,
                              int dim, int w, int dim_t, int k, int group,
                              void* out, void* stream) {
  return dispatch<__half>(vals, idx, T, X, eps, ratio, B, dim, w, dim_t, k,
                          group, out, stream);
}

// The geometry the wrapper plans its member groups on: k's padded width KP
// and the largest group the kernel takes at that width (0: k > 32, the
// legacy kernel, no groups, T as given; KP = 256 past 256, by slabs).
extern "C" int ell_gather_geometry(int k, int* kp, int* max_group) {
  *kp = padded_width(k);
  if (*kp == 0) return (int)cudaErrorInvalidValue;
  *max_group = *kp > 32 ? 0 : grouped::max_group(*kp);
  return (int)cudaSuccess;
}

// The grouped kernel's table: T (B, dim_t, k) f32 as Ti (B dim_t KP
// floats), the members of each group of G side by side, rows padded with
// zeros to KP (ell_gather_f32's T at k <= 32). Returns the CUDA error code.
extern "C" int ell_gather_interleave(const void* T, void* Ti, int B, int dim_t,
                                     int k, int KP, int G, void* stream) {
  int shift = 0;
  while ((1 << shift) < KP) ++shift;
  if (B < 1 || B > 65535 * G || dim_t < 1 || k < 1 || k > KP || KP > 32 ||
      KP != 1 << shift || G < 1 || (size_t)dim_t * G * KP >= (1u << 31))
    return (int)cudaErrorInvalidValue;
  const size_t per_group = ((size_t)dim_t * G * KP + grouped::NT - 1) / grouped::NT;
  const dim3 grid((unsigned)(per_group < 1024 ? per_group : 1024), (B + G - 1) / G);
  grouped::interleave_kernel<<<grid, grouped::NT, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(T), static_cast<float*>(Ti), B, dim_t, k, shift, G);
  return (int)cudaGetLastError();
}

extern "C" const char* ell_gather_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
