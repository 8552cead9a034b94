// The rate of mma.sync on one GPU, for the ceiling of kernels built on it
// (K2a/K2b past k = 32 run 3xTF32 on m16n8k8 TF32 mma.sync).
//
//     nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o build/mma_probe bench_torch/mma_probe.cu
//     build/mma_probe
//
// Each warp of 8 warps a block, 2 blocks per SM, 16 per SM in all, issues
// chains of mma.sync on CHAINS independent accumulators from registers (no
// memory traffic), for TF32 m16n8k8 and bf16 m16n8k16, f32 sums. Prints the
// dense TFLOP/s of each shape and chain count: the ceiling for a kernel
// whose warps issue mma.sync and nothing else. "operands": "shared" gives
// every mma the same A and B registers; "distinct" gives each chain its own
// B and alternates two A, as a kernel whose fragments differ per mma.
#include <cuda_runtime.h>

#include <cstdint>
#include <cstdio>

constexpr int ITERS = 4096;

template <int CHAINS, bool TF32, bool DISTINCT = false>
__global__ void __launch_bounds__(256, 2) mma_loop(float* out, uint32_t seed) {
  float c[CHAINS][4];
#pragma unroll
  for (int i = 0; i < CHAINS; ++i) c[i][0] = c[i][1] = c[i][2] = c[i][3] = 0.f;
  const uint32_t x = seed ^ threadIdx.x;
  uint32_t av[2][4], bv[CHAINS][2];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) av[j][e] = x * (3u + 2u * e + 8u * j);
#pragma unroll
  for (int i = 0; i < CHAINS; ++i) {
    bv[i][0] = x * (11u + 4u * i);
    bv[i][1] = x * (13u + 4u * i);
  }
  for (int it = 0; it < ITERS; ++it) {
#pragma unroll
    for (int i = 0; i < CHAINS; ++i) {
      const uint32_t* a = av[DISTINCT ? i & 1 : 0];
      const uint32_t a0 = a[0], a1 = a[1], a2 = a[2], a3 = a[3];
      const uint32_t b0 = bv[DISTINCT ? i : 0][0], b1 = bv[DISTINCT ? i : 0][1];
      if (TF32) {
        asm volatile(
            "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
            "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
            : "+f"(c[i][0]), "+f"(c[i][1]), "+f"(c[i][2]), "+f"(c[i][3])
            : "r"(a0 & 0xffffe000u), "r"(a1 & 0xffffe000u), "r"(a2 & 0xffffe000u),
              "r"(a3 & 0xffffe000u), "r"(b0 & 0xffffe000u), "r"(b1 & 0xffffe000u));
      } else {
        asm volatile(
            "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
            "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
            : "+f"(c[i][0]), "+f"(c[i][1]), "+f"(c[i][2]), "+f"(c[i][3])
            : "r"(a0 & 0x3f803f80u), "r"(a1 & 0x3f803f80u), "r"(a2 & 0x3f803f80u),
              "r"(a3 & 0x3f803f80u), "r"(b0 & 0x3f803f80u), "r"(b1 & 0x3f803f80u));
      }
    }
  }
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < CHAINS; ++i) s += c[i][0] + c[i][1] + c[i][2] + c[i][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

template <int CHAINS, bool TF32, bool DISTINCT = false>
void run(int sms, float* out) {
  const int blocks = 2 * sms;
  mma_loop<CHAINS, TF32, DISTINCT><<<blocks, 256>>>(out, 1u);   // warm-up
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  cudaEventRecord(e0);
  for (int r = 0; r < 5; ++r) mma_loop<CHAINS, TF32, DISTINCT><<<blocks, 256>>>(out, 2u + r);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms = 0.f;
  cudaEventElapsedTime(&ms, e0, e1);
  const double flop_per_mma = TF32 ? 16.0 * 8 * 8 * 2 : 16.0 * 8 * 16 * 2;
  const double flops = 5.0 * blocks * 8 * (double)ITERS * CHAINS * flop_per_mma;
  printf("{\"mma\": \"%s\", \"operands\": \"%s\", \"chains_per_warp\": %d, "
         "\"warps_per_sm\": 16, \"ms\": %.3f, \"tflops\": %.1f}\n",
         TF32 ? "m16n8k8 tf32" : "m16n8k16 bf16", DISTINCT ? "distinct" : "shared", CHAINS,
         ms / 5, flops / (ms * 1e-3) / 1e12);
}

int main() {
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  float* out;
  cudaMalloc(&out, 2 * sms * 256 * sizeof(float));
  run<1, true>(sms, out);
  run<4, true>(sms, out);
  run<8, true>(sms, out);
  run<4, false>(sms, out);
  run<8, false>(sms, out);
  run<4, true, true>(sms, out);
  run<8, true, true>(sms, out);
  const cudaError_t err = cudaDeviceSynchronize();
  cudaFree(out);
  if (err != cudaSuccess) {
    printf("error: %s\n", cudaGetErrorString(err));
    return 1;
  }
  return 0;
}
