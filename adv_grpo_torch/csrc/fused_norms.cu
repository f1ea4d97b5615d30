// Row norms for Hopper (sm_90a): the modulated LayerNorm
// y = LN(x) * (1 + scale[b]) + shift[b], the plain LayerNorm y = LN(x) (no
// affine), and the per-head RMS norm y = x * rsqrt(mean_head(x^2) + eps) * w.
//
// Replaces: adv_grpo_tpu/ops/fused_norms.py `_lnmod_kernel` (called through
// `_ln_mod_p`, public `modulated_layer_norm`), which runs 109 times per
// SD3.5-M MMDiT forward, 115 times per Flux.1-dev forward and 61 times per
// Wan2.1-T2V-1.3B forward; `_ln_kernel` (called through `_layer_norm_p`,
// public `layer_norm`), WAN's cross-attention norm, 30 times per
// Wan2.1-T2V-1.3B forward; and both bodies
// of `_rms_heads_p` (public `rms_norm_heads`): `_rms_kernel` (heads of d <=
// 128, Flux's qk-norm, 152 times per forward) and `_rms_row_kernel` (one
// head spanning the whole row, WAN's across-heads qk-norm).
//
// Bound on this card: device-memory bandwidth. Either norm does ~4-8 flops
// per element against 4 bytes moved (2 read, 2 written), far below the ~295
// flop/byte ridge of the H100's bf16 tensor cores.
//
// Design: one block per (batch, token) row. Each thread loads its part of the
// row once as 16-byte vectors and keeps it in registers, so x is read from
// device memory exactly once and y written exactly once; statistics in fp32.
//  * LayerNorm: two block reductions (mean, then the centred variance), the
//    TPU kernel's two-pass order. One template serves both LayerNorms: with
//    the modulation, the row's (1 + scale) and shift vectors are read once
//    per row and stay in L2 across the S rows of a batch item; without it the
//    row is only centred and scaled (WAN applies its norm2 affine after the
//    bf16 cast, outside the kernel, as the TPU path does).
//  * RMS: the group width d is a runtime argument. When a head's d/8 vectors
//    tile a warp (d in 8..256), the lanes of one head sit side by side and
//    the sum of squares is a shuffle reduction among them (16 lanes at Flux's
//    d = 128, so a warp normalises two heads); when the head is the whole row
//    (num_heads = 1, any width) it is a block reduction. Rows are read in
//    place through (batch, row) strides, so q / k may be column slices of one
//    fused projection.

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

// threads for a row of nvec 16-byte vectors: at most kMaxVecPerThread each,
// a multiple of 32
int row_threads(int nvec) {
  const int per_thread = (nvec + 1023) / 1024;
  const int threads = (nvec + per_thread - 1) / per_thread;
  return ((threads + 31) / 32) * 32;
}

// kMod: y = LN(x) * (1 + scale[b]) + shift[b]; otherwise y = LN(x) and
// scale / shift are not read.
template <typename T, bool kMod>
__global__ void layer_norm_kernel(const T* __restrict__ x, const T* __restrict__ scale,
                                  const T* __restrict__ shift, T* __restrict__ y,
                                  int rows_per_batch, int d, long long scale_stride,
                                  long long shift_stride, float eps) {
  constexpr int VEC = 16 / sizeof(T);
  __shared__ float red[32];
  const long long row = blockIdx.x;
  const uint4* xr = reinterpret_cast<const uint4*>(x + row * d);
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
      alignas(16) T eo[VEC];
      if constexpr (kMod) {
        const long long b = row / rows_per_batch;
        alignas(16) T es[VEC];
        alignas(16) T eh[VEC];
        *reinterpret_cast<uint4*>(es) =
            reinterpret_cast<const uint4*>(scale + b * scale_stride)[vi];
        *reinterpret_cast<uint4*>(eh) =
            reinterpret_cast<const uint4*>(shift + b * shift_stride)[vi];
#pragma unroll
        for (int j = 0; j < VEC; ++j)
          eo[j] = from_f<T>(v[k][j] * rstd * (1.f + to_f(es[j])) + to_f(eh[j]));
      } else {
#pragma unroll
        for (int j = 0; j < VEC; ++j) eo[j] = from_f<T>(v[k][j] * rstd);
      }
      yr[vi] = *reinterpret_cast<uint4*>(eo);
    }
  }
}

template <typename T, bool kMod>
int launch_layer_norm(const void* x, const void* scale, const void* shift, void* y,
                      long long rows, int rows_per_batch, int d, long long scale_stride,
                      long long shift_stride, float eps, void* stream) {
  constexpr int VEC = 16 / sizeof(T);
  const int threads = row_threads(d / VEC);
  layer_norm_kernel<T, kMod><<<static_cast<unsigned int>(rows), threads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(scale),
      static_cast<const T*>(shift), static_cast<T*>(y), rows_per_batch, d, scale_stride,
      shift_stride, eps);
  return static_cast<int>(cudaGetLastError());
}

// Per-head RMS over a row of `hd` = num_heads * d values: see the header.
__global__ void rms_heads_kernel(const __nv_bfloat16* __restrict__ x,
                                 const float* __restrict__ w, __nv_bfloat16* __restrict__ y,
                                 int rows_per_batch, int hd, int d, long long x_sb,
                                 long long x_ss, float eps) {
  constexpr int VEC = 8;
  __shared__ float red[32];
  const long long row = blockIdx.x;
  const long long b = row / rows_per_batch, s = row % rows_per_batch;
  const uint4* xr = reinterpret_cast<const uint4*>(x + b * x_sb + s * x_ss);
  uint4* yr = reinterpret_cast<uint4*>(y + row * hd);
  const int nvec = hd / VEC, vph = d / VEC;  // vectors per row / per head

  float v[kMaxVecPerThread][VEC];
  float ss[kMaxVecPerThread];
#pragma unroll
  for (int k = 0; k < kMaxVecPerThread; ++k) {
    const int vi = threadIdx.x + k * blockDim.x;
    ss[k] = 0.f;
    if (vi < nvec) {
      alignas(16) __nv_bfloat16 e[VEC];
      *reinterpret_cast<uint4*>(e) = xr[vi];
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        v[k][j] = to_f(e[j]);
        ss[k] += v[k][j] * v[k][j];
      }
    }
  }
  if (vph <= 32 && 32 % vph == 0) {
    // blockDim is a multiple of 32 and vph divides 32, so each aligned group
    // of vph lanes holds one head (or lies wholly past the row's end)
#pragma unroll
    for (int k = 0; k < kMaxVecPerThread; ++k)
      for (int o = 1; o < vph; o <<= 1) ss[k] += __shfl_xor_sync(0xffffffffu, ss[k], o);
  } else {  // one head spans the row
    float t = 0.f;
#pragma unroll
    for (int k = 0; k < kMaxVecPerThread; ++k) t += ss[k];
    t = block_sum(t, red);
#pragma unroll
    for (int k = 0; k < kMaxVecPerThread; ++k) ss[k] = t;
  }
#pragma unroll
  for (int k = 0; k < kMaxVecPerThread; ++k) {
    const int vi = threadIdx.x + k * blockDim.x;
    if (vi < nvec) {
      const float r = rsqrtf(ss[k] / d + eps);
      const float4* wv = reinterpret_cast<const float4*>(w + (vi % vph) * VEC);
      const float4 w0 = wv[0], w1 = wv[1];
      const float ww[VEC] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
      alignas(16) __nv_bfloat16 eo[VEC];
#pragma unroll
      for (int j = 0; j < VEC; ++j) eo[j] = from_f<__nv_bfloat16>(v[k][j] * r * ww[j]);
      yr[vi] = *reinterpret_cast<uint4*>(eo);
    }
  }
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
  return launch_layer_norm<__nv_bfloat16, true>(x, scale, shift, y, rows, rows_per_batch,
                                                d, scale_stride, shift_stride, eps, stream);
}

// x, y: (rows, d) contiguous bf16; y = LN(x) over each row, no affine. d as
// for lnmod_bf16 (the wrapper checks). Returns cudaGetLastError().
extern "C" int ln_bf16(const void* x, void* y, long long rows, int d, float eps,
                       void* stream) {
  return launch_layer_norm<__nv_bfloat16, false>(x, nullptr, nullptr, y, rows, 1, d, 0, 0,
                                                 eps, stream);
}

// x: bf16 rows of width hd, row b*rows_per_batch + s at x + b*x_sb + s*x_ss
// (unit stride along hd, 16-byte aligned rows); w: fp32 (d,); y: contiguous
// bf16 (rows, hd). hd = num_heads * d with d a multiple of 8 that divides 256,
// or d == hd; hd at most 32768 (the wrapper checks). Returns cudaGetLastError().
extern "C" int rms_heads_bf16(const void* x, const void* w, void* y, long long rows,
                              int rows_per_batch, int hd, int d, long long x_sb,
                              long long x_ss, float eps, void* stream) {
  rms_heads_kernel<<<static_cast<unsigned int>(rows), row_threads(hd / 8), 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(w),
      static_cast<__nv_bfloat16*>(y), rows_per_batch, hd, d, x_sb, x_ss, eps);
  return static_cast<int>(cudaGetLastError());
}
