// How fast the card gathers factor rows for the ELL product K4
// (pydnmfk_tpu_torch/csrc/ell_gather.cu), without its values, ratios or
// staging: each line of an ELL index (dim x w, shared by B members) sums the
// table rows its slots name, for every member, and writes the sums once.
// Three table layouts at the sparse NMFk sweep's member stack (B = 10):
//
//   rows of k floats, one table per member, member on the grid's y axis, the
//     k columns read as scalars by KP / 4 lanes a line (K4 before its
//     redesign, at k = 3 and 7: 12- and 28-byte rows);
//   rows padded to KP floats (16-byte aligned), one table per member, read
//     as one float4 per lane (G = 1);
//   G members' padded rows side by side (dim_t, G, KP) for each group of G
//     members, one contiguous run of G x KP x 4 bytes per slot, read as one
//     float4 per lane by G x KP / 4 lanes a line (G = 2, 4, 8; the last
//     group holds the B % G members left).
//
// Two shapes: the rows orientation of the planted topic matrix (200000
// lines of w = 50 slots into a 50000-row table) and its columns orientation
// (50000 lines of w = 200 into a 200000-row table); the indices are uniform
// within a quarter of the table (a topic's block), drawn from a fixed hash.
//
// Then the rate of K4's column slabs (k > 32): one member, 300000 lines of
// w = 232 slots (the NYTimes rows' mean) each gathering a row segment of 64,
// 128 or 256 bytes (16, 32, 64 floats, one float4 a lane) from a table of
// 8 to 64 MB (inside and around the 50 MB L2) or 256 MB (device memory),
// the indices uniform over the whole table.
// Build and run on the card:
//
//     nvcc -O3 -std=c++17 -gencode arch=compute_90a,code=sm_90a \
//         -o build/gather_probe bench_torch/gather_probe.cu
//     ./build/gather_probe
//
// Prints, per layout, the best of 5 timed runs (CUDA events), the useful
// bytes (member-slots x k x 4) and the bytes the gather requests
// (member-slots x the row's bytes, 28 or 12 bytes unpadded, 32 or 16 padded)
// over that time.
#include <cuda_runtime.h>

#include <cstdint>
#include <cstdio>

constexpr int NT = 256;

// G = 0: unpadded per-member rows of K floats, read as masked scalars
template <int KP, int K, int G>
__global__ void __launch_bounds__(NT)
gather(const int* __restrict__ idx, const float* __restrict__ T, int B, int dim,
       int w, int dim_t, float* __restrict__ out) {
  constexpr int Q = KP / 4, GM = G > 0 ? G : 1, L = GM * Q, LINES = NT / L;
  const int e0 = blockIdx.y * GM;
  const int gg = B - e0 < GM ? B - e0 : GM;
  const int r = threadIdx.x % L, m = r / Q, q = r % Q;
  const int line = blockIdx.x * LINES + threadIdx.x / L;
  if (line >= dim || m >= gg) return;
  const int* ir = idx + (size_t)line * w;
  float acc = 0.f;
  if (G == 0) {
    const float* t = T + (size_t)e0 * dim_t * K;
    for (int s = 0; s < w; ++s) {
      const float* row = t + (size_t)__ldg(ir + s) * K;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (q * 4 + j < K) acc += __ldg(row + q * 4 + j);
    }
  } else {
    const float* t = T + (size_t)e0 * dim_t * KP + m * KP + q * 4;
    const int rs = gg * KP;
#pragma unroll 8
    for (int s = 0; s < w; ++s) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(
          t + (size_t)__ldg(ir + s) * rs));
      acc += (v.x + v.y) + (v.z + v.w);
    }
  }
  out[((size_t)(e0 + m) * dim + line) * Q + q] = acc;
}

template <int KP, int K, int G>
void run(const int* idx, const float* T, int B, int dim, int w, int dim_t, float* out,
         const char* shape) {
  constexpr int Q = KP / 4, GM = G > 0 ? G : 1, LINES = NT / (GM * Q);
  const dim3 grid((dim + LINES - 1) / LINES, (B + GM - 1) / GM);
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  float best = 1e30f;
  for (int i = 0; i < 6; ++i) {   // the first run warms up
    cudaEventRecord(a);
    gather<KP, K, G><<<grid, NT>>>(idx, T, B, dim, w, dim_t, out);
    cudaEventRecord(b);
    cudaEventSynchronize(b);
    float ms;
    cudaEventElapsedTime(&ms, a, b);
    if (i > 0 && ms < best) best = ms;
  }
  const double slots = (double)B * dim * w;
  const int row = G == 0 ? 4 * K : 4 * KP;
  printf("%-8s k=%d %-22s G=%d: %.3f ms, useful %.0f GB/s, requested %.0f GB/s (%s)\n",
         shape, K, G == 0 ? "unpadded rows, scalar" : "padded rows, float4", G, best,
         slots * 4 * K / best / 1e6, slots * row / best / 1e6,
         cudaGetErrorString(cudaGetLastError()));
}

// blocks = 4: each line's indices within its quarter of the table (a topic
// block); blocks = 1: uniform over the whole table
__global__ void fill(int* idx, float* T, int dim, int w, int dim_t, size_t nt,
                     int blocks = 4) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < (size_t)dim * w) {
    const size_t line = i / w;
    uint32_t h = (uint32_t)i * 2654435761u;
    h ^= h >> 15;
    h *= 2246822519u;
    h ^= h >> 13;
    const int block = dim_t / blocks;            // the line's topic block
    idx[i] = (int)((line * blocks / dim) * block + h % block);
  }
  if (i < nt) T[i] = 1.f + (float)(i % 7);
}

template <int KP, int K>
void shape(int B, int dim, int w, int dim_t, const char* name, int* idx, float* T,
           float* out) {
  const size_t nt = (size_t)B * dim_t * KP;
  const size_t n = (size_t)dim * w > nt ? (size_t)dim * w : nt;
  fill<<<(unsigned)((n + 255) / 256), 256>>>(idx, T, dim, w, dim_t, nt);
  run<KP, K, 0>(idx, T, B, dim, w, dim_t, out, name);
  run<KP, K, 1>(idx, T, B, dim, w, dim_t, out, name);
  run<KP, K, 2>(idx, T, B, dim, w, dim_t, out, name);
  run<KP, K, 4>(idx, T, B, dim, w, dim_t, out, name);
  run<KP, K, 8>(idx, T, B, dim, w, dim_t, out, name);
}

// one member's row segments of KP floats from a table of table_mb MB
template <int KP>
void segments(int dim, int w, int table_mb, int* idx, float* T, float* out) {
  const int dim_t = (int)(((size_t)table_mb << 20) / (KP * 4));
  const size_t nt = (size_t)dim_t * KP;
  const size_t n = (size_t)dim * w > nt ? (size_t)dim * w : nt;
  fill<<<(unsigned)((n + 255) / 256), 256>>>(idx, T, dim, w, dim_t, nt, 1);
  char name[16];
  snprintf(name, sizeof name, "%dMB", table_mb);
  run<KP, KP, 1>(idx, T, 1, dim, w, dim_t, out, name);
}

int main() {
  const int B = 10;
  int* idx;
  float *T, *out;
  if (cudaMalloc(&idx, (size_t)200000 * 50 * 4) != cudaSuccess ||
      cudaMalloc(&T, (size_t)B * 200000 * 8 * 4) != cudaSuccess ||
      cudaMalloc(&out, (size_t)B * 200000 * 2 * 4) != cudaSuccess)
    return 1;
  shape<8, 7>(B, 200000, 50, 50000, "rows", idx, T, out);
  shape<8, 7>(B, 50000, 200, 200000, "columns", idx, T, out);
  shape<4, 3>(B, 200000, 50, 50000, "rows", idx, T, out);
  shape<4, 3>(B, 50000, 200, 200000, "columns", idx, T, out);
  cudaFree(idx);
  cudaFree(T);
  cudaFree(out);

  const int dim = 300000, w = 232;
  if (cudaMalloc(&idx, (size_t)dim * w * 4) != cudaSuccess ||
      cudaMalloc(&T, (size_t)256 << 20) != cudaSuccess ||
      cudaMalloc(&out, (size_t)dim * 16 * 4) != cudaSuccess)
    return 1;
  for (int mb : {8, 16, 24, 32, 40, 48, 64, 256}) {
    segments<16>(dim, w, mb, idx, T, out);
    segments<32>(dim, w, mb, idx, T, out);
    segments<64>(dim, w, mb, idx, T, out);
  }
  return cudaGetLastError() == cudaSuccess ? 0 : 1;
}
