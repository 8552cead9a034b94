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
// k > 32 (slab_kernel, dot_kernel below): the tables outgrow the L2 (at
// the NYTimes shape W is 77 MB at k = 64, H^T 123 MB and W 360 MB at k =
// 300), and rows gathered from device memory come at about half the rate
// of rows gathered from L2 (bench_torch/gather_probe.cu). So the output is
// covered in column slabs, each narrow enough that one member's part of
// the table fits a share of the L2 (ops/ell_gather.py's slab_plan, bounded
// by the widest slab exported below):
//   * The table: the wrapper lays T out slab after slab, (B, nslab, dim_t,
//     ldt) with ldt the slab's width rounded up to 4 floats and zeros past
//     k (slab_table_kernel, one pass over T), so that a slab's rows are
//     contiguous and 16-byte aligned and a member's slab fills dim_t ldt 4
//     bytes of the L2 and no more. A table that fits runs as one slab,
//     from T itself where k % 4 == 0.
//   * Lanes: L = KP / 4 lanes a line (at most 32), each holding one 16-byte
//     piece of the slab's row segment, two at KP = 256 (KP = 32, 64, 128,
//     256: the power of two that holds the slab, 32 for any narrower slab,
//     whose idle lanes load nothing). A block of 256 threads takes 256 / L
//     lines of one member and one slab; lines are the grid's fast axis,
//     members and then slabs the slow ones, so that one member's slab
//     stays in L2 while all its lines stream past.
//   * Values and indices: every slab reads them again, so they are staged
//     as the grouped kernel stages them, a chunk of 8 L slots of the
//     block's lines by cp.async one chunk ahead (bf16 and f16 values widened
//     through registers). A line's lanes read four slots' values and
//     indices (two at KP = 256) as two broadcasts from shared memory, then
//     gather the four rows, two steps unrolled (one at KP = 256).
//   * Widths: the plan takes slabs of 32, 64, 128 or 256 floats, so that
//     every lane loads; the time of a slab follows KP, not the columns it
//     holds (idle lanes cost as much as busy ones), and rows of 64 bytes
//     gather at half the rate of rows of 128 (bench_torch/gather_probe.cu,
//     k4_bench.py --slab-sweep).
//   * Plain: each output column is summed by one lane in ascending slot
//     order, so a result is the same bitwise at every slab width.
//   * Ratio in one slab: <X[b, :], row> is summed over the lane's pieces
//     and a butterfly over the line's L lanes, in registers, and divided
//     (__fdividef) in the same pass. The wrapper gives the ratio one slab
//     up to the widest (256), tables past the L2 share included: that one
//     pass beat the two below over slabs that fit. Ratio in several slabs
//     (past 256, or a slab width asked for), two passes:
//     dot_kernel, launched once a slab, sums each slot's dot slab by slab
//     into an f32 (B, dim, w) workspace (read back by cp.async, written a
//     chunk at a time along s), and its last slab writes coef = val / (dot
//     + eps) there; then slab_kernel runs the plain product on coef. Each
//     gathered row is read twice, once a pass, and each dot done once.
//   * Occupancy: five blocks per SM for every slab kernel, the dot pass
//     included.
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

namespace slab {

constexpr int NT = 256;                  // threads per block (8 warps)
constexpr int MAX_SLAB = 256;            // the widest slab, in floats
constexpr unsigned FULL = 0xffffffffu;
// resident blocks per SM: five (48 registers); a gather waits on L2 or
// device memory, and at three blocks (85 registers) the dot pass took
// 1.3-1.6 times as long, at four the one-pass ratio at KP = 256 1.4 times
constexpr int MIN_BLOCKS = 5;

using grouped::cp_async4;
using grouped::cp_async_commit;
using grouped::cp_async_wait_one;
using grouped::widen16;

// The lanes and staging of the kernels whose slab is at most KP floats, in
// 4-byte words.
template <int KP>
struct Geom {
  static constexpr int L = KP / 4 < 32 ? KP / 4 : 32;   // lanes per line
  static constexpr int NQ = KP / (4 * L);    // 16-byte pieces a lane holds
  static constexpr int LINES = NT / L;       // lines per block
  static constexpr int S = 8 * L;            // slots per staged chunk
  static constexpr int U = NQ > 1 ? 2 : 4;   // slots a step of the loop
  static constexpr int STEPS = NQ > 1 ? 1 : 2;   // steps unrolled
  static constexpr int LS = S + 4;           // line stride: 16-byte reads of
                                             // U slots, the LPW <= 8 lines
                                             // of a warp in distinct banks
  static constexpr int VN = LINES * S / NT;  // words a thread stages (8)
  static constexpr int BUF = 2 * LINES * LS; // one buffer: values, indices
  static constexpr size_t smem() { return 2 * sizeof(float) * (size_t)BUF; }
  static_assert(smem() <= 48 * 1024, "within the default dynamic limit");
};

// r <- lane g's pieces of a slab row, zeros at and past the slab's width ks
template <int NQ, int L>
__device__ __forceinline__ void gather_row(float (&r)[NQ][4],
                                           const float* __restrict__ row,
                                           int g, int ks, bool live) {
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    const int c = (q * L + g) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (live && c < ks) v = __ldg(reinterpret_cast<const float4*>(row + c));
    r[q][0] = v.x; r[q][1] = v.y; r[q][2] = v.z; r[q][3] = v.w;
  }
}

// x <- lane g's pieces of p[0, ks) (16-byte loads where vec), zeros past ks
template <int NQ, int L>
__device__ __forceinline__ void load_line(float (&x)[NQ][4],
                                          const float* __restrict__ p, int g,
                                          int ks, bool vec) {
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    const int c = (q * L + g) * 4;
    if (vec) {
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (c < ks) v = __ldg(reinterpret_cast<const float4*>(p + c));
      x[q][0] = v.x; x[q][1] = v.y; x[q][2] = v.z; x[q][3] = v.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) x[q][j] = c + j < ks ? __ldg(p + c + j) : 0.f;
    }
  }
}

// o[0, ks) <- lane g's sums (16-byte stores where vec)
template <int NQ, int L>
__device__ __forceinline__ void store_line(float* __restrict__ o,
                                           const float (&acc)[NQ][4], int g,
                                           int ks, bool vec) {
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    const int c = (q * L + g) * 4;
    if (vec) {
      if (c < ks) *reinterpret_cast<float4*>(o + c) =
          make_float4(acc[q][0], acc[q][1], acc[q][2], acc[q][3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (c + j < ks) o[c + j] = acc[q][j];
    }
  }
}

// v <- U consecutive words of shared memory (U = 2, 4), as one load
template <int U, typename T>
__device__ __forceinline__ void lds(T (&v)[U], const T* p) {
  using W = typename std::conditional<std::is_same<T, int>::value,
      typename std::conditional<U == 4, int4, int2>::type,
      typename std::conditional<U == 4, float4, float2>::type>::type;
  const W a = *reinterpret_cast<const W*>(p);
  v[0] = a.x; v[1] = a.y;
  if constexpr (U == 4) { v[2] = a.z; v[3] = a.w; }
}

// p[0, U) <- v, as one store
template <int U>
__device__ __forceinline__ void sts(float* p, const float (&v)[U]) {
  if constexpr (U == 4) *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  else *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
}

// <x, r> over the line: the lane's pieces, then a butterfly over its L lanes
template <int NQ, int L>
__device__ __forceinline__ float line_dot(const float (&x)[NQ][4],
                                          const float (&r)[NQ][4]) {
  float d = 0.f;
#pragma unroll
  for (int q = 0; q < NQ; ++q)
#pragma unroll
    for (int j = 0; j < 4; ++j) d += x[q][j] * r[q][j];
#pragma unroll
  for (int o = L / 2; o > 0; o >>= 1) d += __shfl_xor_sync(FULL, d, o, L);
  return d;
}

// stages the chunk of slots [s0, s0 + S) of the block's lines into sv
// (values, unless null) and si (indices), read along s (coalesced): f32
// values and the indices by cp.async, bf16 and f16 values through
// registers, widened (vals points at the member's (dim, w) values)
template <typename V, int KP>
__device__ __forceinline__ void stage_chunk(const V* __restrict__ vals_,
                                            const int* __restrict__ idx,
                                            float* sv, int* si, int b0, int s0,
                                            int dim, int w) {
  using Gm = Geom<KP>;
  constexpr bool F32 = std::is_same<V, float>::value;
  using R = typename std::conditional<F32, float, unsigned short>::type;
  constexpr int STEP = NT / Gm::S;       // lines between a thread's words
  const R* vals = reinterpret_cast<const R*>(vals_);
  // word j of the thread: slot s of line l0 + j STEP (one pointer and a
  // stride, not one held per word: the f32 kernels spilled with those)
  const int s = threadIdx.x % Gm::S, l0 = threadIdx.x / Gm::S;
  const bool s_ok = s0 + s < w;
  const size_t at0 = (size_t)(b0 + l0) * w + s0 + s, step = (size_t)STEP * w;
#pragma unroll 2
  for (int j = 0; j < Gm::VN; ++j) {
    const int l = l0 + j * STEP;
    const bool ok = s_ok && b0 + l < dim;
    const size_t at = ok ? at0 + j * step : 0;
    if (sv != nullptr) {
      if constexpr (F32) cp_async4(sv + l * Gm::LS + s, vals + at, ok);
      else sv[l * Gm::LS + s] = ok ? widen16<V>(__ldcs(vals + at)) : 0.f;
    }
    cp_async4(si + l * Gm::LS + s, idx + at, ok);
  }
  cp_async_commit();
}

// Tb: the slab table, (B, nslab, dim_t, ldt) with ldt = slab rounded up to
// 4; slab j of member e holds columns [j slab, j slab + slab) of its rows,
// zeros past k. Block (lines x, member y, slab z) writes out[e, b, slab j]
// = sum_s coef[e, b, s] T[e, idx[b, s], slab j] for its lines b.
template <typename V, int KP, bool RATIO>
__global__ void __launch_bounds__(NT, MIN_BLOCKS)
slab_kernel(const V* __restrict__ vals, const int* __restrict__ idx,
            const float* __restrict__ Tb, const float* __restrict__ X,
            float eps, int dim, int w, int dim_t, int k, int slab, int vec,
            float* __restrict__ out) {
  using Gm = Geom<KP>;
  constexpr int L = Gm::L, NQ = Gm::NQ, LINES = Gm::LINES, S = Gm::S;
  constexpr int LS = Gm::LS, U = Gm::U;
  extern __shared__ float smem[];        // two buffers: (LINES, LS) values, (LINES, LS) indices
  const int e = blockIdx.y, j = blockIdx.z;
  const int c0 = j * slab, ks = min(slab, k - c0), ldt = (slab + 3) & ~3;
  const int b0 = blockIdx.x * LINES, ll = threadIdx.x / L, g = threadIdx.x % L;
  const int line = b0 + ll;
  const bool live = line < dim;
  const float* tslab = Tb + ((size_t)e * gridDim.z + j) * dim_t * ldt;
  vals += (size_t)e * dim * w;

  float x[NQ][4];
  if constexpr (RATIO)
    load_line<NQ, L>(x, X + ((size_t)e * dim + (live ? line : 0)) * k + c0, g,
                     live ? ks : 0, vec);
  float acc[NQ][4];
#pragma unroll
  for (int q = 0; q < NQ; ++q)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[q][i] = 0.f;

  const auto stage = [&](int s0, int buf) {
    float* sv = smem + buf * Gm::BUF;
    stage_chunk<V, KP>(vals, idx, sv, reinterpret_cast<int*>(sv + LINES * LS),
                       b0, s0, dim, w);
  };
  stage(0, 0);
  for (int s0 = 0, buf = 0; s0 < w; s0 += S, buf ^= 1) {
    if (s0 + S < w) stage(s0 + S, buf ^ 1);
    else cp_async_commit();              // an empty group keeps the count
    cp_async_wait_one();                 // this thread's copies of s0 landed
    __syncthreads();                     // and everyone's
    const float* vr = smem + buf * Gm::BUF + ll * LS;
    const int* ir = reinterpret_cast<const int*>(vr + LINES * LS);
    // U slots a step, their values and indices read as one word each; the
    // chunk's slots past w are staged as inert zeros
    const int ns = min(S, w - s0);       // the same for the whole block
#pragma unroll (Gm::STEPS)
    for (int t = 0; t < ns; t += U) {
      float vv[U];
      int ii[U];
      lds<U>(vv, vr + t);
      lds<U>(ii, ir + t);
      float r[U][NQ][4];
#pragma unroll
      for (int u = 0; u < U; ++u)
        gather_row<NQ, L>(r[u], tslab + (size_t)ii[u] * ldt, g, ks, live);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float coef = vv[u];
        if constexpr (RATIO)
          coef = __fdividef(coef, line_dot<NQ, L>(x, r[u]) + eps);
#pragma unroll
        for (int q = 0; q < NQ; ++q)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[q][i] += coef * r[u][q][i];
      }
    }
    __syncthreads();                     // buf is refilled two chunks on
  }
  if (live) store_line<NQ, L>(out + ((size_t)e * dim + line) * k + c0, acc, g,
                              ks, vec);
}

// Slab j of the ratio's dot pass: ws[e, b, s] = (j > 0 ? ws[e, b, s] : 0) +
// <X[e, b, slab j], T[e, idx[b, s], slab j]>, and at the last slab ws[e, b,
// s] = vals[e, b, s] / (ws[e, b, s] + eps), the coefficients of the plain
// product. Block (lines x, member y).
template <typename V, int KP>
__global__ void __launch_bounds__(NT, MIN_BLOCKS)
dot_kernel(const V* __restrict__ vals_, const int* __restrict__ idx,
           const float* __restrict__ Tb, const float* __restrict__ X,
           float eps, int dim, int w, int dim_t, int k, int slab, int j,
           int nslab, int vec, float* ws) {
  using Gm = Geom<KP>;
  constexpr bool F32 = std::is_same<V, float>::value;
  using R = typename std::conditional<F32, float, unsigned short>::type;
  constexpr int L = Gm::L, NQ = Gm::NQ, LINES = Gm::LINES, S = Gm::S;
  constexpr int LS = Gm::LS, U = Gm::U;
  extern __shared__ float smem[];        // two buffers: (LINES, LS) sums, (LINES, LS) indices
  const int e = blockIdx.y;
  const bool first = j == 0, last = j == nslab - 1;
  const int c0 = j * slab, ks = min(slab, k - c0), ldt = (slab + 3) & ~3;
  const int b0 = blockIdx.x * LINES, ll = threadIdx.x / L, g = threadIdx.x % L;
  const int line = b0 + ll;
  const bool live = line < dim;
  const float* tslab = Tb + ((size_t)e * nslab + j) * dim_t * ldt;
  const R* vals = reinterpret_cast<const R*>(vals_) + (size_t)e * dim * w;
  ws += (size_t)e * dim * w;

  float x[NQ][4];
  load_line<NQ, L>(x, X + ((size_t)e * dim + (live ? line : 0)) * k + c0, g,
                   live ? ks : 0, vec);
  // the earlier slabs' sums (none at the first) and the indices
  const auto stage = [&](int s0, int buf) {
    float* sd = smem + buf * Gm::BUF;
    stage_chunk<float, KP>(ws, idx, first ? nullptr : sd,
                           reinterpret_cast<int*>(sd + LINES * LS), b0, s0,
                           dim, w);
  };
  stage(0, 0);
  for (int s0 = 0, buf = 0; s0 < w; s0 += S, buf ^= 1) {
    if (s0 + S < w) stage(s0 + S, buf ^ 1);
    else cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
    float* sd = smem + buf * Gm::BUF;
    float* dr = sd + ll * LS;
    const int* ir = reinterpret_cast<const int*>(dr + LINES * LS);
    const int ns = min(S, w - s0);
#pragma unroll 1
    for (int t = 0; t < ns; t += U) {    // U slots a step, as slab_kernel
      int ii[U];
      lds<U>(ii, ir + t);
      float r[U][NQ][4];
#pragma unroll
      for (int u = 0; u < U; ++u)
        gather_row<NQ, L>(r[u], tslab + (size_t)ii[u] * ldt, g, ks, live);
      float d[U];
#pragma unroll
      for (int u = 0; u < U; ++u) d[u] = 0.f;
      if (!first) lds<U>(d, dr + t);
#pragma unroll
      for (int u = 0; u < U; ++u) d[u] += line_dot<NQ, L>(x, r[u]);
      if (g == 0) sts<U>(dr + t, d);
    }
    __syncthreads();                     // the chunk's sums are in
    // written back along s (coalesced): the sums, or the coefficients
#pragma unroll
    for (int i = 0; i < Gm::VN; ++i) {
      const int f = i * NT + threadIdx.x;
      const int l = f / S, s = f % S;
      if (b0 + l < dim && s0 + s < w) {
        const size_t at = (size_t)(b0 + l) * w + s0 + s;
        const float d = sd[l * LS + s];
        if (last) {
          float v;
          if constexpr (F32) v = __ldcs(vals + at);
          else v = widen16<V>(__ldcs(vals + at));
          ws[at] = __fdividef(v, d + eps);
        } else {
          ws[at] = d;
        }
      }
    }
    __syncthreads();                     // buf is refilled two chunks on
  }
}

// Tb <- T (B, dim_t, k) as the slab table (B, nslab, dim_t, ldt): block row
// y = e nslab + j writes member e's slab j, columns [j slab, j slab + slab)
// of each row, zeros past k and past the slab.
__global__ void __launch_bounds__(NT)
slab_table_kernel(const float* __restrict__ T, float* __restrict__ Tb,
                  int dim_t, int k, int slab, int nslab, int ldt) {
  const int e = blockIdx.y / nslab, j = blockIdx.y % nslab;
  const int n = dim_t * ldt;             // < 2^31 (checked by the caller)
  const float* t = T + (size_t)e * dim_t * k;
  float* o = Tb + (size_t)blockIdx.y * n;
  for (int i = blockIdx.x * NT + threadIdx.x; i < n; i += gridDim.x * NT) {
    const int c = i % ldt, row = i / ldt, col = j * slab + c;
    o[i] = c < slab && col < k ? __ldg(t + (size_t)row * k + col) : 0.f;
  }
}

template <typename V, int KP, bool RATIO>
cudaError_t run(dim3 grid, const void* vals, const void* idx, const void* Tb,
                const void* X, float eps, int dim, int w, int dim_t, int k,
                int slab, int vec, void* out, cudaStream_t s) {
  slab_kernel<V, KP, RATIO><<<grid, NT, Geom<KP>::smem(), s>>>(
      static_cast<const V*>(vals), static_cast<const int*>(idx),
      static_cast<const float*>(Tb), static_cast<const float*>(X), eps, dim,
      w, dim_t, k, slab, vec, static_cast<float*>(out));
  return cudaGetLastError();
}

// The product in slabs of `slab` columns. The ratio in several slabs takes
// nslab launches of the dot pass into ws, then the plain product on ws.
template <typename V, int KP>
cudaError_t launch(const void* vals, const void* idx, const void* Tb,
                   const void* X, float eps, bool ratio, int B, int dim, int w,
                   int dim_t, int k, int slab, void* ws, void* out, int vec,
                   cudaStream_t s) {
  const int nslab = (k + slab - 1) / slab;
  if (nslab > 65535) return cudaErrorInvalidValue;
  const dim3 grid((dim + Geom<KP>::LINES - 1) / Geom<KP>::LINES, B, nslab);
  if (!ratio)
    return run<V, KP, false>(grid, vals, idx, Tb, X, eps, dim, w, dim_t, k,
                             slab, vec, out, s);
  if (nslab == 1)
    return run<V, KP, true>(grid, vals, idx, Tb, X, eps, dim, w, dim_t, k,
                            slab, vec, out, s);
  if (ws == nullptr) return cudaErrorInvalidValue;
  for (int j = 0; j < nslab; ++j) {
    dot_kernel<V, KP><<<dim3(grid.x, B), NT, Geom<KP>::smem(), s>>>(
        static_cast<const V*>(vals), static_cast<const int*>(idx),
        static_cast<const float*>(Tb), static_cast<const float*>(X), eps, dim,
        w, dim_t, k, slab, j, nslab, vec, static_cast<float*>(ws));
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return run<float, KP, false>(grid, ws, idx, Tb, nullptr, eps, dim, w, dim_t,
                               k, slab, vec, out, s);
}

template <typename V>
cudaError_t dispatch(const void* vals, const void* idx, const void* Tb,
                     const void* X, float eps, bool ratio, int B, int dim,
                     int w, int dim_t, int k, int slab, void* ws, void* out,
                     int vec, cudaStream_t s) {
  const int width = (slab + 3) & ~3;
  if (width <= 32) return launch<V, 32>(vals, idx, Tb, X, eps, ratio, B, dim, w, dim_t, k, slab, ws, out, vec, s);
  if (width <= 64) return launch<V, 64>(vals, idx, Tb, X, eps, ratio, B, dim, w, dim_t, k, slab, ws, out, vec, s);
  if (width <= 128) return launch<V, 128>(vals, idx, Tb, X, eps, ratio, B, dim, w, dim_t, k, slab, ws, out, vec, s);
  return launch<V, 256>(vals, idx, Tb, X, eps, ratio, B, dim, w, dim_t, k, slab, ws, out, vec, s);
}

}  // namespace slab

// k's padded width for the grouped kernel: 4, 8, 16, 32; 0 for k < 1 and
// past 32 (the slab kernels)
int padded_width(int k) {
  if (k < 1 || k > 32) return 0;
  int kp = 4;
  while (kp < k) kp *= 2;
  return kp;
}

template <typename V, bool RATIO>
cudaError_t dispatch_k(const void* vals, const void* idx, const void* T,
                       const void* X, float eps, int B, int dim, int w,
                       int dim_t, int k, int group, void* out, cudaStream_t s) {
  if (k <= 4) return grouped::dispatch_g<V, 4, RATIO>(group, vals, idx, T, X, eps, B, dim, w, dim_t, k, out, s);
  if (k <= 8) return grouped::dispatch_g<V, 8, RATIO>(group, vals, idx, T, X, eps, B, dim, w, dim_t, k, out, s);
  if (k <= 16) return grouped::dispatch_g<V, 16, RATIO>(group, vals, idx, T, X, eps, B, dim, w, dim_t, k, out, s);
  return grouped::dispatch_g<V, 32, RATIO>(group, vals, idx, T, X, eps, B, dim, w, dim_t, k, out, s);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

template <typename V>
int dispatch(const void* vals, const void* idx, const void* T, const void* X,
             float eps, int ratio, int B, int dim, int w, int dim_t, int k,
             int group, int slab, void* ws, void* out, void* stream) {
  if (B < 1 || B > 65535 || dim < 1 || w < 1 || dim_t < 1 || k < 1 ||
      (ratio && X == nullptr) || !aligned16(T))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k <= 32) {
    if (slab != 0) return (int)cudaErrorInvalidValue;
    return (int)(ratio ? dispatch_k<V, true>(vals, idx, T, X, eps, B, dim, w, dim_t, k, group, out, s)
                       : dispatch_k<V, false>(vals, idx, T, X, eps, B, dim, w, dim_t, k, group, out, s));
  }
  if (group != 0 || slab < 1 || slab > slab::MAX_SLAB)
    return (int)cudaErrorInvalidValue;
  const int vec = k % 4 == 0 && slab % 4 == 0 && aligned16(out) &&
                  (!ratio || aligned16(X));
  return (int)slab::dispatch<V>(vals, idx, T, X, eps, ratio != 0, B, dim, w,
                                dim_t, k, slab, ws, out, vec, s);
}

}  // namespace

// Plain C interface, bound with ctypes. vals is (B, dim, w) in f32, bf16 or
// f16, idx (dim, w) int32 with entries in [0, dim_t), X (B, dim, k) f32 or
// null (plain mode), out (B, dim, k) f32; all contiguous; any k >= 1; T
// 16-byte aligned. At k <= 32 T is the interleaved table of groups of
// `group` members (1, 2, 4 or 8, at most ell_gather_geometry's max_group):
// for each group, its members' rows padded to KP floats side by side,
// (dim_t, gg, KP), gg = min(group, B - first member); slab is 0. At k > 32
// group is 0, slab a width from 1 to the geometry's max_slab, and T the
// slab table (B, nslab, dim_t, ldt) of ell_gather_slab_table, nslab =
// ceil(k / slab), ldt = slab rounded up to 4 (at one slab with k % 4 == 0,
// T (B, dim_t, k) itself); ws an f32 (B, dim, w) workspace where the ratio
// takes several slabs, else unused. Every element of out is written.
// Returns the CUDA error code of the launches (0 on success).
extern "C" int ell_gather_f32(const void* vals, const void* idx, const void* T,
                              const void* X, float eps, int ratio, int B,
                              int dim, int w, int dim_t, int k, int group,
                              int slab, void* ws, void* out, void* stream) {
  return dispatch<float>(vals, idx, T, X, eps, ratio, B, dim, w, dim_t, k,
                         group, slab, ws, out, stream);
}

extern "C" int ell_gather_bf16(const void* vals, const void* idx, const void* T,
                               const void* X, float eps, int ratio, int B,
                               int dim, int w, int dim_t, int k, int group,
                               int slab, void* ws, void* out, void* stream) {
  return dispatch<__nv_bfloat16>(vals, idx, T, X, eps, ratio, B, dim, w, dim_t,
                                 k, group, slab, ws, out, stream);
}

extern "C" int ell_gather_f16(const void* vals, const void* idx, const void* T,
                              const void* X, float eps, int ratio, int B,
                              int dim, int w, int dim_t, int k, int group,
                              int slab, void* ws, void* out, void* stream) {
  return dispatch<__half>(vals, idx, T, X, eps, ratio, B, dim, w, dim_t, k,
                          group, slab, ws, out, stream);
}

// The geometry the wrapper plans on. At k <= 32: k's padded width KP and
// the largest member group the grouped kernel takes at it (max_slab 0). Past
// 32: the widest slab the slab kernels take (KP and max_group 0: no groups).
extern "C" int ell_gather_geometry(int k, int* kp, int* max_group,
                                   int* max_slab) {
  if (k < 1) return (int)cudaErrorInvalidValue;
  *kp = padded_width(k);
  *max_group = k <= 32 ? grouped::max_group(*kp) : 0;
  *max_slab = k <= 32 ? 0 : slab::MAX_SLAB;
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

// The slab kernels' table: T (B, dim_t, k) f32 as Tb (B, nslab, dim_t, ldt),
// nslab = ceil(k / slab), ldt = slab rounded up to 4, zeros past k
// (ell_gather_f32's T at k > 32). Returns the CUDA error code.
extern "C" int ell_gather_slab_table(const void* T, void* Tb, int B, int dim_t,
                                     int k, int slab, void* stream) {
  if (B < 1 || dim_t < 1 || k < 1 || slab < 1 || slab > slab::MAX_SLAB)
    return (int)cudaErrorInvalidValue;
  const int nslab = (k + slab - 1) / slab, ldt = (slab + 3) & ~3;
  if ((long long)B * nslab > 65535 || (size_t)dim_t * ldt >= (1u << 31))
    return (int)cudaErrorInvalidValue;
  const size_t per_slab = ((size_t)dim_t * ldt + slab::NT - 1) / slab::NT;
  const dim3 grid((unsigned)(per_slab < 1024 ? per_slab : 1024), B * nslab);
  slab::slab_table_kernel<<<grid, slab::NT, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(T), static_cast<float*>(Tb), dim_t, k, slab,
      nslab, ldt);
  return (int)cudaGetLastError();
}

extern "C" const char* ell_gather_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
