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
// Each norm has a bf16 instance (the main path) and an fp32 one (`lnmod_f32`,
// `ln_f32`, `rms_heads_f32`: the fp32 tiny presets and mixed_precision=fp32),
// the same templates with 4-element instead of 8-element 16-byte vectors.
//
// Bound on this card: device-memory bandwidth. Either norm does ~4-8 flops
// per element against 4 bytes moved in bf16 (2 read, 2 written; 8 in fp32),
// far below the ~295 flop/byte ridge of the H100's bf16 tensor cores.
//
// Design. Each thread loads its part of a row once as 16-byte vectors and
// keeps it in registers, so x is read from device memory exactly once and y
// written exactly once; statistics in fp32.
//  * LayerNorm (`layer_norm_kernel<T, kMod, kVec, kWarpRow>`, both
//    LayerNorms: with the modulation, and without it, where the row is only
//    centred and scaled: WAN applies its norm2 affine after the bf16 cast,
//    outside the kernel, as the TPU path does). A persistent grid: at most
//    as many CTAs as the card holds at once (the occupancy API's CTAs per SM
//    times the SMs), split evenly over the batch items (one item without the
//    modulation), each walking its item's rows with a stride, so neither
//    WAN's 8,100 rows nor SD3's 308 text rows leave a tail wave. Up to 384
//    vectors a row (d <= 3072, every main-path width) a warp owns a row: its
//    lanes hold kVec vectors each, and the mean and the centred variance
//    (the TPU kernel's two-pass order) are warp shuffles, with no block
//    barrier and no shared-memory round trip per row. The warp issues its
//    next row's loads before it reduces the current one (two register
//    buffers). With the modulation, a CTA copies its item's scale and shift
//    rows into shared memory once, by cp.async while its first row loads,
//    not once per row (a CTA never changes item). Wider rows (the tests'
//    8192 and 32768) take the same walk with a CTA owning each row (block
//    reductions; scale and shift read per row from device memory: their
//    rows, up to 64 KB each, would pass the 48 KB of shared memory a launch
//    gets without opting in).
//  * RMS: one block per (batch, token) row. The group width d is a runtime
//    argument. When a head's d/8 vectors tile a warp (d in 8..256), the
//    lanes of one head sit side by side and the sum of squares is a shuffle
//    reduction among them (16 lanes at Flux's d = 128, so a warp normalises
//    two heads); when the head is the whole row (num_heads = 1, any width)
//    it is a block reduction. Rows are read in place through (batch, row)
//    strides, so q / k may be column slices of one fused projection.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxVecPerThread = 4;

__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(float v) { return v; }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
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

// ── the LayerNorms (#1 with the modulation, #6 without) ──

constexpr int kRowWarps = 4;       // warps per CTA when a warp owns a row
constexpr int kWideThreads = 512;  // most threads of a CTA that owns a row

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// the sum over a row: its warp's (kWarpRow) or its CTA's
template <bool kWarpRow>
__device__ __forceinline__ float row_sum(float v, float* red) {
  return kWarpRow ? warp_sum(v) : block_sum(v, red);
}

// the index of this thread's k-th 16-byte vector of a row
template <bool kWarpRow>
__device__ __forceinline__ int row_vec(int k) {
  return kWarpRow ? (threadIdx.x & 31) + 32 * k : threadIdx.x + blockDim.x * k;
}

// issue this thread's loads of a row (kept in flight until first used)
template <int kVec, bool kWarpRow>
__device__ __forceinline__ void load_row(uint4 (&buf)[kVec], const void* row, int nvec) {
  const uint4* xr = reinterpret_cast<const uint4*>(row);
#pragma unroll
  for (int k = 0; k < kVec; ++k)
    if (row_vec<kWarpRow>(k) < nvec) buf[k] = __ldg(xr + row_vec<kWarpRow>(k));
}

// LN of one row held in `buf`, written to yr: the mean, then the centred
// variance (fp32, the TPU kernel's two-pass order); with kMod times (1 +
// scale) and plus shift, read from `mod` (the item's scale row, then its
// shift row, as in device memory, copied to shared memory) when a warp owns
// the row, else from the rows sc / sh in device memory. 1 + scale is formed
// in fp32 per element either way, as the plain version forms it.
template <typename T, bool kMod, int kVec, bool kWarpRow>
__device__ __forceinline__ void ln_row(const uint4 (&buf)[kVec], T* yr, int nvec, int d,
                                       float eps, const uint4* mod, const T* sc, const T* sh,
                                       float* red) {
  constexpr int VEC = 16 / sizeof(T);
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    if (row_vec<kWarpRow>(k) < nvec) {
      const T* e = reinterpret_cast<const T*>(&buf[k]);
#pragma unroll
      for (int j = 0; j < VEC; ++j) s += to_f(e[j]);
    }
  }
  const float mean = row_sum<kWarpRow>(s, red) / d;
  float q = 0.f;
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    if (row_vec<kWarpRow>(k) < nvec) {
      const T* e = reinterpret_cast<const T*>(&buf[k]);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float c = to_f(e[j]) - mean;
        q += c * c;
      }
    }
  }
  const float rstd = rsqrtf(row_sum<kWarpRow>(q, red) / d + eps);
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    const int vi = row_vec<kWarpRow>(k);
    if (vi < nvec) {
      const T* e = reinterpret_cast<const T*>(&buf[k]);
      alignas(16) T eo[VEC];
      if constexpr (kMod) {
        alignas(16) T es[VEC];
        alignas(16) T eh[VEC];
        if constexpr (kWarpRow) {
          *reinterpret_cast<uint4*>(es) = mod[vi];
          *reinterpret_cast<uint4*>(eh) = mod[nvec + vi];
        } else {
          *reinterpret_cast<uint4*>(es) = __ldg(reinterpret_cast<const uint4*>(sc) + vi);
          *reinterpret_cast<uint4*>(eh) = __ldg(reinterpret_cast<const uint4*>(sh) + vi);
        }
#pragma unroll
        for (int j = 0; j < VEC; ++j)
          eo[j] = from_f<T>((to_f(e[j]) - mean) * rstd * (1.f + to_f(es[j])) + to_f(eh[j]));
      } else {
#pragma unroll
        for (int j = 0; j < VEC; ++j) eo[j] = from_f<T>((to_f(e[j]) - mean) * rstd);
      }
      reinterpret_cast<uint4*>(yr)[vi] = *reinterpret_cast<uint4*>(eo);
    }
  }
}

// kMod: y = LN(x) * (1 + scale[b]) + shift[b] over `items` batch items of
// `rows_per_item` rows; otherwise y = LN(x) over one item of all the rows,
// and scale / shift are not read. The grid is ctas_per_item CTAs per item;
// each unit (a warp when kWarpRow, else the CTA) walks its item's rows with
// the stride of the item's units, two rows in flight.
template <typename T, bool kMod, int kVec, bool kWarpRow>
__global__ void __launch_bounds__(kWarpRow ? 32 * kRowWarps : kWideThreads)
    layer_norm_kernel(const T* __restrict__ x, const T* __restrict__ scale,
                      const T* __restrict__ shift, T* __restrict__ y, long long rows_per_item,
                      int ctas_per_item, int d, long long scale_stride,
                      long long shift_stride, float eps) {
  constexpr int VEC = 16 / sizeof(T);
  extern __shared__ uint4 mod[];  // kMod with kWarpRow: the item's scale, then shift row
  __shared__ float red[32];
  const int nvec = d / VEC;
  const long long item = blockIdx.x / ctas_per_item;
  const int units = kWarpRow ? blockDim.x >> 5 : 1;
  const long long stride = static_cast<long long>(ctas_per_item) * units;
  long long r = static_cast<long long>(blockIdx.x % ctas_per_item) * units +
                (kWarpRow ? threadIdx.x >> 5 : 0);
  const T* xi = x + item * rows_per_item * d;
  T* yi = y + item * rows_per_item * d;

  uint4 a[kVec], b[kVec];
  if (r < rows_per_item) load_row<kVec, kWarpRow>(a, xi + r * d, nvec);
  // the item's modulation rows, copied once per CTA while the first row loads
  const T* sc = kMod ? scale + item * scale_stride : nullptr;
  const T* sh = kMod ? shift + item * shift_stride : nullptr;
  if constexpr (kMod && kWarpRow) {
    // by cp.async: no registers, every copy of the CTA in flight at once
    const uint32_t m = static_cast<uint32_t>(__cvta_generic_to_shared(mod));
    for (int v = threadIdx.x; v < nvec; v += blockDim.x) {
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(m + 16 * v),
                   "l"(reinterpret_cast<const uint4*>(sc) + v));
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(m + 16 * (nvec + v)),
                   "l"(reinterpret_cast<const uint4*>(sh) + v));
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
  }
  // two register buffers: the next row's loads are issued before this row's
  // reductions
  while (r < rows_per_item) {
    long long n = r + stride;
    if (n < rows_per_item) load_row<kVec, kWarpRow>(b, xi + n * d, nvec);
    ln_row<T, kMod, kVec, kWarpRow>(a, yi + r * d, nvec, d, eps, mod, sc, sh, red);
    r = n;
    if (r >= rows_per_item) break;
    n = r + stride;
    if (n < rows_per_item) load_row<kVec, kWarpRow>(a, xi + n * d, nvec);
    ln_row<T, kMod, kVec, kWarpRow>(b, yi + r * d, nvec, d, eps, mod, sc, sh, red);
    r = n;
  }
}

// SMs of the current device, memoised per thread and device
int device_sms(int device) {
  thread_local int sms[64] = {};
  if (device < 0 || device >= 64) return 1;
  if (sms[device] == 0)
    cudaDeviceGetAttribute(&sms[device], cudaDevAttrMultiProcessorCount, device);
  return sms[device] > 0 ? sms[device] : 1;
}

// CTAs of `kernel` at this block size and dynamic shared memory that the
// device holds at once (resident per SM times SMs); memoised per thread, the
// last 16 queries
int resident_ctas(const void* kernel, int device, int threads, size_t smem) {
  struct Entry {
    const void* kernel;
    int device, threads;
    size_t smem;
    int ctas;
  };
  thread_local Entry memo[16] = {};
  thread_local int next = 0;
  for (const Entry& e : memo)
    if (e.kernel == kernel && e.device == device && e.threads == threads && e.smem == smem)
      return e.ctas;
  int per_sm = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  const int ctas = (per_sm > 0 ? per_sm : 1) * device_sms(device);
  memo[next] = Entry{kernel, device, threads, smem, ctas};
  next = (next + 1) % 16;
  return ctas;
}

// The launch plan: a warp per row (kRowWarps per CTA) or a CTA per row of up
// to kWideThreads threads; CTAs per item so that the grid fits on the card at
// once and no unit is left without a row.
template <typename T, bool kMod, int kVec, bool kWarpRow>
int launch_ln(const void* x, const void* scale, const void* shift, void* y, long long items,
              long long rows_per_item, int d, long long scale_stride, long long shift_stride,
              float eps, cudaStream_t stream) {
  const auto kernel = layer_norm_kernel<T, kMod, kVec, kWarpRow>;
  int device = 0;
  cudaGetDevice(&device);
  int threads, units;
  size_t smem = 0;
  if constexpr (kWarpRow) {
    units = kRowWarps;
    threads = 32 * units;
    if constexpr (kMod) smem = 2 * static_cast<size_t>(d) * sizeof(T);
  } else {
    const int nvec = d / static_cast<int>(16 / sizeof(T));
    units = 1;
    threads = ((nvec + kVec - 1) / kVec + 31) / 32 * 32;
  }
  const long long fit = resident_ctas(reinterpret_cast<const void*>(kernel), device, threads,
                                      smem) / items;
  const long long need = (rows_per_item + units - 1) / units;
  const long long ctas_per_item = need < fit ? need : (fit > 1 ? fit : 1);
  const long long grid = ctas_per_item * items;
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  kernel<<<static_cast<unsigned int>(grid), threads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(scale), static_cast<const T*>(shift),
      static_cast<T*>(y), rows_per_item, static_cast<int>(ctas_per_item), d, scale_stride,
      shift_stride, eps);
  return static_cast<int>(cudaGetLastError());
}

// the instance for d / VEC vectors a row: a warp holds rows of up to 192
// vectors in 6 a lane (d <= 1536 in bf16: SD3.5-M and WAN) or up to 384 in 12
// (d <= 3072: Flux.1-dev), a CTA wider ones
template <typename T, bool kMod>
int launch_layer_norm(const void* x, const void* scale, const void* shift, void* y,
                      long long items, long long rows_per_item, int d,
                      long long scale_stride, long long shift_stride, float eps, void* stream) {
  constexpr int VEC = 16 / sizeof(T);
  const int nvec = d / VEC;
  const auto s = static_cast<cudaStream_t>(stream);
  if (nvec <= 192)
    return launch_ln<T, kMod, 6, true>(x, scale, shift, y, items, rows_per_item, d,
                                       scale_stride, shift_stride, eps, s);
  if (nvec <= 384)
    return launch_ln<T, kMod, 12, true>(x, scale, shift, y, items, rows_per_item, d,
                                        scale_stride, shift_stride, eps, s);
  return launch_ln<T, kMod, 8, false>(x, scale, shift, y, items, rows_per_item, d,
                                      scale_stride, shift_stride, eps, s);
}

// Per-head RMS over a row of `hd` = num_heads * d values: see the header.
template <typename T>
__global__ void rms_heads_kernel(const T* __restrict__ x, const float* __restrict__ w,
                                 T* __restrict__ y, int rows_per_batch, int hd, int d,
                                 long long x_sb, long long x_ss, float eps) {
  constexpr int VEC = 16 / sizeof(T);
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
      alignas(16) T e[VEC];
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
      // this vector's VEC weights, as float4s
      const float4* wv = reinterpret_cast<const float4*>(w + (vi % vph) * VEC);
      float ww[VEC];
#pragma unroll
      for (int q = 0; q < VEC / 4; ++q) {
        const float4 f = wv[q];
        ww[4 * q] = f.x;
        ww[4 * q + 1] = f.y;
        ww[4 * q + 2] = f.z;
        ww[4 * q + 3] = f.w;
      }
      alignas(16) T eo[VEC];
#pragma unroll
      for (int j = 0; j < VEC; ++j) eo[j] = from_f<T>(v[k][j] * r * ww[j]);
      yr[vi] = *reinterpret_cast<uint4*>(eo);
    }
  }
}

template <typename T>
int launch_rms_heads(const void* x, const void* w, void* y, long long rows, int rows_per_batch,
                     int hd, int d, long long x_sb, long long x_ss, float eps, void* stream) {
  constexpr int VEC = 16 / sizeof(T);
  rms_heads_kernel<T><<<static_cast<unsigned int>(rows), row_threads(hd / VEC), 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const float*>(w), static_cast<T*>(y),
      rows_per_batch, hd, d, x_sb, x_ss, eps);
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
  if (rows <= 0 || rows_per_batch <= 0) return 0;  // nothing to launch
  return launch_layer_norm<__nv_bfloat16, true>(x, scale, shift, y, rows / rows_per_batch,
                                                rows_per_batch, d, scale_stride, shift_stride,
                                                eps, stream);
}

// x, y: (rows, d) contiguous bf16; y = LN(x) over each row, no affine. d as
// for lnmod_bf16 (the wrapper checks). Returns cudaGetLastError().
extern "C" int ln_bf16(const void* x, void* y, long long rows, int d, float eps,
                       void* stream) {
  if (rows <= 0) return 0;  // nothing to launch
  return launch_layer_norm<__nv_bfloat16, false>(x, nullptr, nullptr, y, 1, rows, d, 0, 0,
                                                 eps, stream);
}

// x: bf16 rows of width hd, row b*rows_per_batch + s at x + b*x_sb + s*x_ss
// (unit stride along hd, 16-byte aligned rows); w: fp32 (d,); y: contiguous
// bf16 (rows, hd). hd = num_heads * d with d a multiple of 8 that divides 256,
// or d == hd; hd at most 32768 (the wrapper checks). Returns cudaGetLastError().
extern "C" int rms_heads_bf16(const void* x, const void* w, void* y, long long rows,
                              int rows_per_batch, int hd, int d, long long x_sb,
                              long long x_ss, float eps, void* stream) {
  return launch_rms_heads<__nv_bfloat16>(x, w, y, rows, rows_per_batch, hd, d, x_sb, x_ss,
                                         eps, stream);
}

// The fp32 instances of the three norms: as their bf16 entries, with fp32
// x, scale, shift and y, and 4-element (16-byte) vectors, so d (lnmod, ln)
// is a multiple of 4 and at most 4 * 4096, and the RMS's head width d a
// multiple of 4 that divides 128 (or d == hd, at most 16384).
extern "C" int lnmod_f32(const void* x, const void* scale, const void* shift, void* y,
                         long long rows, int rows_per_batch, int d, long long scale_stride,
                         long long shift_stride, float eps, void* stream) {
  if (rows <= 0 || rows_per_batch <= 0) return 0;  // nothing to launch
  return launch_layer_norm<float, true>(x, scale, shift, y, rows / rows_per_batch,
                                        rows_per_batch, d, scale_stride, shift_stride, eps,
                                        stream);
}

extern "C" int ln_f32(const void* x, void* y, long long rows, int d, float eps, void* stream) {
  if (rows <= 0) return 0;  // nothing to launch
  return launch_layer_norm<float, false>(x, nullptr, nullptr, y, 1, rows, d, 0, 0, eps,
                                         stream);
}

extern "C" int rms_heads_f32(const void* x, const void* w, void* y, long long rows,
                             int rows_per_batch, int hd, int d, long long x_sb, long long x_ss,
                             float eps, void* stream) {
  return launch_rms_heads<float>(x, w, y, rows, rows_per_batch, hd, d, x_sb, x_ss, eps,
                                 stream);
}
