// The card's mma.sync rate: TF32 m16n8k8 and bf16 m16n8k16, each warp
// issuing 8 independent accumulators in a loop, 4 CTAs an SM of 4, 8 and 16
// warps. A standalone program (not part of the kernel library, which builds
// csrc/*.cu only): chip_smoke.py --mma-rate compiles and runs it. It bounds
// what the generic backward (3xTF32 on mma.sync) can reach: a third of the
// TF32 rate in fp32-accurate products.

#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

template <bool kTf32>
__global__ void mma_loop(float* out, int iters) {
  float d[8][4] = {};
  const uint32_t a[4] = {threadIdx.x, threadIdx.x * 3u, 7u, 9u};
  const uint32_t b[2] = {threadIdx.x ^ 5u, 11u};
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (kTf32)
        asm volatile(
            "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
            "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
            : "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]), "+f"(d[j][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
      else
        asm volatile(
            "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
            "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
            : "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]), "+f"(d[j][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
    }
  }
  float s = 0.f;
  for (int j = 0; j < 8; ++j)
    for (int e = 0; e < 4; ++e) s += d[j][e];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;  // keeps the products live
}

int main() {
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  float* out = nullptr;
  if (cudaMalloc(&out, sizeof(float) * sms * 4 * 16 * 32) != cudaSuccess) return 1;
  const int iters = 4096;
  for (int kind = 0; kind < 2; ++kind) {
    for (int warps : {4, 8, 16}) {
      const dim3 grid(sms * 4), block(32 * warps);
      auto launch = [&]() {
        if (kind == 0)
          mma_loop<true><<<grid, block>>>(out, iters);
        else
          mma_loop<false><<<grid, block>>>(out, iters);
      };
      cudaEvent_t e0, e1;
      cudaEventCreate(&e0);
      cudaEventCreate(&e1);
      launch();  // warm-up
      cudaEventRecord(e0);
      launch();
      cudaEventRecord(e1);
      cudaEventSynchronize(e1);
      if (cudaGetLastError() != cudaSuccess) return 1;
      float ms = 0.f;
      cudaEventElapsedTime(&ms, e0, e1);
      const double flop = 2.0 * grid.x * warps * iters * 8 * 16 * 8 * (kind == 0 ? 8 : 16);
      printf("%s, %d warps a CTA, 4 CTAs an SM: %.3f ms, %.1f TFLOP/s\n",
             kind == 0 ? "mma.sync m16n8k8 tf32" : "mma.sync m16n8k16 bf16", warps, ms,
             flop / ms / 1e9);
    }
  }
  return 0;
}
