// Modulated LayerNorm, y = LN(x) * (1 + scale[b]) + shift[b], for Hopper (sm_90a).
//
// Replaces: adv_grpo_tpu/ops/fused_norms.py `_lnmod_kernel` (called through
// `_ln_mod_p`, public `modulated_layer_norm`), the AdaLN-modulated LayerNorm
// that runs 109 times per SD3.5-M MMDiT forward.
//
// Bound on this card: device-memory bandwidth. A (B, S, 1536) bf16 row does
// ~8 flops per element against 4 bytes moved (2 read, 2 written), far below
// the ~295 flop/byte ridge of the H100's bf16 tensor cores.
//
// Design: one block per (batch, token) row. Each thread loads its part of the
// row once as 16-byte vectors and keeps it in registers, so x is read from
// device memory exactly once and y written exactly once; the statistics are
// two block reductions (mean, then the centred variance) in fp32, the same
// two-pass order as the TPU kernel. The row's (1 + scale) and shift vectors
// are read once per row and stay in L2 across the S rows of a batch item.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxVecPerThread = 4;

__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Sum over the block; every thread gets the total. blockDim.x is a multiple of
// 32 (the launcher rounds it up), so full-mask shuffles are safe.
__device__ __forceinline__ float block_sum(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  __syncthreads();  // `red` is reused by the next call
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = lane < nwarps ? red[lane] : 0.f;
  for (int o = 16; o > 0; o >>= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
  return t;
}

template <typename T>
__global__ void lnmod_kernel(const T* __restrict__ x, const T* __restrict__ scale,
                             const T* __restrict__ shift, T* __restrict__ y,
                             int rows_per_batch, int d, long long scale_stride,
                             long long shift_stride, float eps) {
  constexpr int VEC = 16 / sizeof(T);
  __shared__ float red[32];
  const long long row = blockIdx.x;
  const long long b = row / rows_per_batch;
  const uint4* xr = reinterpret_cast<const uint4*>(x + row * d);
  const uint4* sc = reinterpret_cast<const uint4*>(scale + b * scale_stride);
  const uint4* sh = reinterpret_cast<const uint4*>(shift + b * shift_stride);
  uint4* yr = reinterpret_cast<uint4*>(y + row * d);
  const int nvec = d / VEC;

  float v[kMaxVecPerThread][VEC];
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < kMaxVecPerThread; ++k) {
    const int vi = threadIdx.x + k * blockDim.x;
    if (vi < nvec) {
      alignas(16) T e[VEC];
      *reinterpret_cast<uint4*>(e) = xr[vi];
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        v[k][j] = to_f(e[j]);
        s += v[k][j];
      }
    }
  }
  const float mean = block_sum(s, red) / d;
  float q = 0.f;
#pragma unroll
  for (int k = 0; k < kMaxVecPerThread; ++k) {
    if (threadIdx.x + k * blockDim.x < nvec) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        v[k][j] -= mean;
        q += v[k][j] * v[k][j];
      }
    }
  }
  const float rstd = rsqrtf(block_sum(q, red) / d + eps);
#pragma unroll
  for (int k = 0; k < kMaxVecPerThread; ++k) {
    const int vi = threadIdx.x + k * blockDim.x;
    if (vi < nvec) {
      alignas(16) T es[VEC];
      alignas(16) T eh[VEC];
      alignas(16) T eo[VEC];
      *reinterpret_cast<uint4*>(es) = sc[vi];
      *reinterpret_cast<uint4*>(eh) = sh[vi];
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        eo[j] = from_f<T>(v[k][j] * rstd * (1.f + to_f(es[j])) + to_f(eh[j]));
      yr[vi] = *reinterpret_cast<uint4*>(eo);
    }
  }
}

template <typename T>
int launch_lnmod(const void* x, const void* scale, const void* shift, void* y,
                 long long rows, int rows_per_batch, int d, long long scale_stride,
                 long long shift_stride, float eps, void* stream) {
  constexpr int VEC = 16 / sizeof(T);
  const int nvec = d / VEC;
  const int per_thread = (nvec + 1023) / 1024;
  int threads = (nvec + per_thread - 1) / per_thread;
  threads = ((threads + 31) / 32) * 32;
  lnmod_kernel<T><<<static_cast<unsigned int>(rows), threads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(scale),
      static_cast<const T*>(shift), static_cast<T*>(y), rows_per_batch, d, scale_stride,
      shift_stride, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, y: (rows, d) contiguous, rows = batch * rows_per_batch; scale, shift:
// (batch, d) rows `scale_stride` / `shift_stride` elements apart (the chunks
// of one modulation matmul). d must be a multiple of 16 bytes' worth of
// elements and at most 4096 such vectors; every row 16-byte aligned (the
// wrapper checks). Returns cudaGetLastError().
extern "C" int lnmod_bf16(const void* x, const void* scale, const void* shift, void* y,
                          long long rows, int rows_per_batch, int d,
                          long long scale_stride, long long shift_stride, float eps,
                          void* stream) {
  return launch_lnmod<__nv_bfloat16>(x, scale, shift, y, rows, rows_per_batch, d,
                                     scale_stride, shift_stride, eps, stream);
}
