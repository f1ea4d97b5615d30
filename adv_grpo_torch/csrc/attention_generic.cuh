// The generic attention kernels' shared part: their parameters, the tile
// loader and the operand pre-pass (attention_generic_fwd.cu,
// attention_generic_bwd.cu).
//
// The generic kernels take what the wgmma + TMA kernels
// (attention_fwd_sm90.cu, attention_bwd_sm90.cu; bf16, head width 64 or
// 128) do not: fp32 operands at any head width d <= 128, and bf16 at the
// other widths d <= 128, with the same four layouts (modes):
//  * kJoint: the two-stream joint attention (#2 / #4), or one stream
//    (#3 / #5), q and k read as the operands the pre-pass below writes:
//    q^ = dt(yq * sm_scale * log2 e), q_s = dt(yq * sm_scale) (backward)
//    and, with the fused qk-RMS, k^ = dt(yk), where yq = rms(q) * wq and
//    yk = rms(k) * wk in fp32 (q and k as stored without weights; k^ is
//    then k itself), the sums of squares in the order of the port's twin
//    (ops/joint_attention.py `_sum_sq`, `joint_operands`);
//  * kBshd: (B, S, H*D) tensors read through (batch, row) strides, with a
//    kv_len key mask (#8 / #9); the fp32 scores are scaled, p and t
//    rounded to dt before their products in the backward;
//  * kBhsd: (B, H, S, D) tensors (#10 / #11); as kBshd, but the backward
//    keeps p and t in fp32.
// dt is the operands' type T (float or bf16): in fp32 every rounding to dt
// is the identity. The two dtypes take two designs, chosen by dtype before
// the launch: fp32 the tensor cores in a 3xTF32 split (fp32 accuracy; the
// *_tf32 kernels: the forward on wgmma, the backward on mma.sync m16n8k8),
// bf16 FFMA on tiles staged as fp32 (the kernels without the suffix, which
// round p and t where the twins do).
//
// Each tensor is a View: a base pointer and the element strides of its
// batch, row and head; a head's d columns are contiguous and start on a
// 16-byte boundary (the wrapper checks), so the loader reads 16-byte
// vectors. A padded width DMAX in {32, 64, 128} is a template argument; the
// run-time d <= DMAX, and the columns d..DMAX of every tile are zero.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

namespace generic_attn {

enum Mode { kJoint = 0, kBshd = 1, kBhsd = 2 };

constexpr int kThreads = 256;   // 16 row groups x 16 column lanes
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// the layout of the int64 stream descriptor the wrappers pass (per stream,
// kDescLen entries; ops/attention.py `_GENERIC_DESC` names the same slots)
enum Desc {
  kQRows = 0, kKvRows = 1, kKvValid = 2,
  kQ = 3, kK = 7, kV = 11, kO = 15, kDo = 19, kDq = 23, kDk = 27, kDv = 31,  // Views
  kLse = 35, kDi = 36, kWq = 37, kWk = 38, kQhat = 39, kQs = 40, kKhat = 41,
  kDescLen = 42
};

struct View {
  const void* p;
  long long sb, ss, sh;  // element strides of batch, row and head
};

struct Stream {
  View q, qs, k, v;      // operands: scores (q, k), dk's q (qs), v
  View out, dout;        // o (forward) / dq (backward); do (backward)
  View dk, dv;           // backward outputs
  float* lse;            // (B, H, q_rows) fp32, natural log; may be null
  const float* di;       // (B, H, q_rows) fp32, backward
  int q_rows, kv_rows, kv_valid;
};

struct Params {
  Stream st[2];
  int nst;             // streams: 1 or 2
  int heads, d;
  float score_scale;   // scales q.k into base-2 scores (1 where q^ holds it)
  float dq_scale, dk_scale;
  int round_pt;        // the backward rounds p and t to dt
};

__host__ __device__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ __forceinline__ int imin(int a, int b) { return a < b ? a : b; }

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// v rounded to T and back (the identity in fp32)
template <typename T>
__device__ __forceinline__ float round_to(float v) { return to_f(from_f<T>(v)); }

template <typename T>
__device__ __forceinline__ const T* at(const View& v, int b, int row, int h) {
  return static_cast<const T*>(v.p) + b * v.sb + static_cast<long long>(row) * v.ss +
         h * v.sh;
}

template <typename T>
__device__ __forceinline__ T* at_mut(const View& v, int b, int row, int h) {
  return const_cast<T*>(at<T>(v, b, row, h));
}

// rows [r0, r0 + n) of head h of batch item b into a [rows][ld] fp32 tile in
// shared memory, as fp32; rows n..rows and columns d..DMAX are zero
template <typename T, int DMAX>
__device__ __forceinline__ void load_tile(float* dst, int ld, int rows, const View& v, int b,
                                          int h, int r0, int n, int d) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int VPR = DMAX / VEC;  // vectors per padded row
  for (int idx = threadIdx.x; idx < rows * VPR; idx += blockDim.x) {
    const int r = idx / VPR, c = (idx % VPR) * VEC;
    float f[VEC];
    if (r < n && c < d) {
      const uint4 raw = *reinterpret_cast<const uint4*>(at<T>(v, b, r0 + r, h) + c);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < VEC; ++j) f[j] = to_f(e[j]);
    } else {
#pragma unroll
      for (int j = 0; j < VEC; ++j) f[j] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < VEC; ++j) dst[r * ld + c + j] = f[j];
  }
}

// the same rows of an fp32 View by 16-byte cp.async copies (the caller
// commits and waits), into a [rows][ld] tile with ld a multiple of 4
template <int DMAX>
__device__ __forceinline__ void load_tile_async(float* dst, int ld, int rows, const View& v,
                                                int b, int h, int r0, int n, int d) {
  constexpr int VPR = DMAX / 4;
  for (int idx = threadIdx.x; idx < rows * VPR; idx += blockDim.x) {
    const int r = idx / VPR, c = (idx % VPR) * 4;
    const bool ok = r < n && c < d;
    sm90::cp_async16(dst + r * ld + c,
                     ok ? at<float>(v, b, r0 + r, h) + c : static_cast<const float*>(v.p), ok);
  }
}

// ── the fp32 backward's products: 3xTF32 on mma.sync m16n8k8 ──
// A warp owns 16 rows of its tile; lane (g, c) = (lane / 4, lane % 4). Two
// kinds of product, both from row-major fp32 tiles in shared memory with
// rows padded to a multiple of 4 words that is 4 mod 32 (DMAX + 4), so
// every fragment read below hits 32 distinct banks:
//  * scores_3xtf32: s = A B^T over the DMAX columns (q k^T, do v^T in the
//    dq kernel; k q^T, v do^T in the dkv kernel);
//  * update_3xtf32: acc += P B, P a score tile in the accumulator layout
//    (p^T do, t^T q, t k). Lane (g, c) holds P's columns (2c, 2c + 1)
//    of each 8-column step, which is the A fragment of the step if its 8
//    rows of B are taken in the order 0, 2, 4, 6, 1, 3, 5, 7 (B's rows 2c
//    and 2c + 1 where the fragment names rows c and c + 4): a permutation
//    of the sum, so P needs no shuffle.
// The tensor cores add products into an accumulator with truncation, so a
// long run of mma into one register drifts towards zero; both kinds keep
// the small products (big * small, small * big) in accumulators apart from
// big * big, and update_3xtf32 adds each tile's sums into acc in fp32 with
// rounding to nearest. The separate accumulators (three for the scores,
// two per group of n-tiles for the updates) also give mma.sync, whose
// result comes many cycles after its issue, independent products to issue
// back to back.

// the A fragment of rows r, r + 8 and columns k, k + 4 (p at [r][k])
__device__ __forceinline__ void frag_a(float (&a)[4], const float* p, int ld) {
  a[0] = p[0];
  a[1] = p[8 * ld];
  a[2] = p[4];
  a[3] = p[8 * ld + 4];
}

// s[n] = sum over the KS 8-column steps of A's warp rows times rows 8n..8n+7
// of B, n < SN; a points at A[row 16 warp + g][c], b at B[g][c]. With
// kTwoSmall false both small products share one accumulator (where
// registers are short).
template <int KS, int SN, bool kTwoSmall = true>
__device__ __forceinline__ void scores_3xtf32(float (&s)[SN][4], const float* a, const float* b,
                                              int ld) {
  float x[SN][4], y[SN][4];
#pragma unroll
  for (int n = 0; n < SN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = x[n][e] = y[n][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    float af[4];
    frag_a(af, a + 8 * ks, ld);
    uint32_t ab[4], as[4], bb[SN][2], bs[SN][2];
    sm90::split_tf32(af, ab, as);
#pragma unroll
    for (int n = 0; n < SN; ++n) {
      const float bf[2] = {b[8 * n * ld + 8 * ks], b[8 * n * ld + 8 * ks + 4]};
      sm90::split_tf32(bf, bb[n], bs[n]);
    }
#pragma unroll
    for (int n = 0; n < SN; ++n) sm90::mma_tf32(x[n], as, bb[n]);
#pragma unroll
    for (int n = 0; n < SN; ++n) sm90::mma_tf32(kTwoSmall ? y[n] : x[n], ab, bs[n]);
#pragma unroll
    for (int n = 0; n < SN; ++n) sm90::mma_tf32(s[n], ab, bb[n]);
  }
#pragma unroll
  for (int n = 0; n < SN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] += x[n][e] + y[n][e];
}

// the A fragments of the SN 8-column steps of a score tile p in the
// accumulator layout, split
template <int SN>
__device__ __forceinline__ void split_p(const float (&p)[SN][4], uint32_t (&big)[SN][4],
                                        uint32_t (&small)[SN][4]) {
#pragma unroll
  for (int kk = 0; kk < SN; ++kk) {
    const float a[4] = {p[kk][0], p[kk][2], p[kk][1], p[kk][3]};
    sm90::split_tf32(a, big[kk], small[kk]);
  }
}

// acc[n] += sum over the SN steps of P's step times B's rows 8kk + (0, 2,
// .., 7) at columns 8n..8n+7, n < NT; b points at B[2c][g]. G n-tiles at a
// time (fewer where registers are short), each group's sums added into acc
// once.
template <int SN, int NT, int G = 4>
__device__ __forceinline__ void update_3xtf32(float (&acc)[NT][4], const uint32_t (&pb)[SN][4],
                                              const uint32_t (&ps)[SN][4], const float* b,
                                              int ld) {
  static_assert(NT % G == 0, "whole groups of n-tiles");
#pragma unroll
  for (int n0 = 0; n0 < NT; n0 += G) {
    float x[G][4], y[G][4];
#pragma unroll
    for (int j = 0; j < G; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) x[j][e] = y[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < SN; ++kk) {
      uint32_t bb[G][2], bs[G][2];
#pragma unroll
      for (int j = 0; j < G; ++j) {
        const float* bp = b + 8 * kk * ld + 8 * (n0 + j);
        const float bf[2] = {bp[0], bp[ld]};
        sm90::split_tf32(bf, bb[j], bs[j]);
      }
#pragma unroll
      for (int j = 0; j < G; ++j) sm90::mma_tf32(x[j], ps[kk], bb[j]);
#pragma unroll
      for (int j = 0; j < G; ++j) sm90::mma_tf32(x[j], pb[kk], bs[j]);
#pragma unroll
      for (int j = 0; j < G; ++j) sm90::mma_tf32(y[j], pb[kk], bb[j]);
    }
#pragma unroll
    for (int j = 0; j < G; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n0 + j][e] += y[j][e] + x[j][e];
  }
}

// The operand pre-pass: for each (b, row, h) of `in` (one thread a head
// row), y = x * rs * w with rs = 1 / sqrt(sum(x^2) * (1 / d) + eps) when w
// is given (else y = x), then out1 = dt(y * scale1) and, if out2, out2 =
// dt(y * scale2), written as contiguous (B, rows, H*D). The sum of squares
// in the twin's order: each 8-column chunk's squares in column order (a
// partial last chunk padded with zeros, which add nothing), then the chunk
// sums in chunk order, for a q row (`halves`) the chunks c % 8 < 4 and the
// others apart, then the two added. Every step rounds once (no FMA), as the
// twin's separate tensor operations do.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    operand_prepass_kernel(View in, const float* __restrict__ w, T* __restrict__ out1,
                           float scale1, T* __restrict__ out2, float scale2, int rows,
                           int heads, int d, float inv_d, float eps, int halves) {
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<long long>(rows) * heads) return;
  const int b = blockIdx.y;
  const int h = static_cast<int>(idx % heads), r = static_cast<int>(idx / heads);
  const T* x = at<T>(in, b, r, h);
  float rs = 1.f;
  if (w != nullptr) {
    float sa = 0.f, sb = 0.f;
    bool two = false;
    for (int c = 0; c * 8 < d; ++c) {
      float chunk = 0.f;
      for (int e = 0; e < 8; ++e) {
        const float v = 8 * c + e < d ? to_f(x[8 * c + e]) : 0.f;
        chunk = __fadd_rn(chunk, __fmul_rn(v, v));
      }
      if (!halves || c % 8 < 4) {
        sa = __fadd_rn(sa, chunk);
      } else {
        sb = __fadd_rn(sb, chunk);
        two = true;
      }
    }
    const float ss = two ? __fadd_rn(sa, sb) : sa;
    rs = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(__fmul_rn(ss, inv_d), eps)));
  }
  const long long o = ((static_cast<long long>(b) * rows + r) * heads + h) * d;
  for (int c = 0; c < d; ++c) {
    float y = to_f(x[c]);
    if (w != nullptr) y = __fmul_rn(__fmul_rn(y, rs), w[c]);
    out1[o + c] = from_f<T>(__fmul_rn(y, scale1));
    if (out2 != nullptr) out2[o + c] = from_f<T>(__fmul_rn(y, scale2));
  }
}

inline View view_at(const long long* a) {
  return View{reinterpret_cast<const void*>(a[0]), a[1], a[2], a[3]};
}

// a contiguous (B, rows, H*D) scratch as a View
inline View scratch_view(long long ptr, int rows, int heads, int d) {
  const long long hd = static_cast<long long>(heads) * d;
  return View{reinterpret_cast<const void*>(ptr), rows * hd, hd, d};
}

// Fill p.st from the descriptor: each stream's views as given, then, in
// kJoint, the pre-pass launched for its q (q^ into kQhat, and q_s into kQs
// when `backward` and `want_qs`, else the qs view is q^'s) and, with a k
// weight, its k (k^ into kKhat), and the stream's q / qs / k views pointed
// at those scratches. Returns the first launch error.
template <typename T>
int setup_streams(Params& p, const long long* desc, int nst, int mode, int batch, int heads,
                  int d, float qscale, float sm_scale, float eps, bool backward,
                  cudaStream_t stream, bool want_qs = true) {
  p.nst = nst;
  p.heads = heads;
  p.d = d;
  for (int i = 0; i < 2; ++i) {
    Stream& s = p.st[i];
    s = Stream{};
    if (i >= nst) continue;
    const long long* a = desc + i * kDescLen;
    s.q_rows = static_cast<int>(a[kQRows]);
    s.kv_rows = static_cast<int>(a[kKvRows]);
    s.kv_valid = static_cast<int>(a[kKvValid]);
    s.q = s.qs = view_at(a + kQ);
    s.k = view_at(a + kK);
    s.v = view_at(a + kV);
    s.out = view_at(a + (backward ? kDq : kO));
    s.dout = view_at(a + kDo);
    s.dk = view_at(a + kDk);
    s.dv = view_at(a + kDv);
    s.lse = reinterpret_cast<float*>(a[kLse]);
    s.di = reinterpret_cast<const float*>(a[kDi]);
    if (mode != kJoint) continue;
    const float inv_d = static_cast<float>(1.0 / d);
    const float* wq = reinterpret_cast<const float*>(a[kWq]);
    const float* wk = reinterpret_cast<const float*>(a[kWk]);
    if (s.q_rows > 0) {
      T* qhat = reinterpret_cast<T*>(a[kQhat]);
      const bool own_qs = backward && want_qs;
      T* qs = own_qs ? reinterpret_cast<T*>(a[kQs]) : nullptr;
      const dim3 grid(cdiv(s.q_rows * heads, kThreads), batch);
      operand_prepass_kernel<T><<<grid, kThreads, 0, stream>>>(
          s.q, wq, qhat, qscale, qs, sm_scale, s.q_rows, heads, d, inv_d, eps, 1);
      s.q = scratch_view(a[kQhat], s.q_rows, heads, d);
      s.qs = own_qs ? scratch_view(a[kQs], s.q_rows, heads, d) : s.q;
    }
    if (wk != nullptr && s.kv_rows > 0) {
      const dim3 grid(cdiv(s.kv_rows * heads, kThreads), batch);
      operand_prepass_kernel<T><<<grid, kThreads, 0, stream>>>(
          s.k, wk, reinterpret_cast<T*>(a[kKhat]), 1.f, static_cast<T*>(nullptr), 1.f,
          s.kv_rows, heads, d, inv_d, eps, 0);
      s.k = scratch_view(a[kKhat], s.kv_rows, heads, d);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

// the q tiles of `rows`-row tiles over the streams, and which stream and
// tile of it the flat tile index t names
__device__ __forceinline__ int stream_of(const Params& p, int rows_per_tile, bool kv_side,
                                         int& t) {
  const int n0 = cdiv(kv_side ? p.st[0].kv_rows : p.st[0].q_rows, rows_per_tile);
  if (t < n0) return 0;
  t -= n0;
  return 1;
}

inline int tiles_of(const Params& p, int rows_per_tile, bool kv_side) {
  int n = 0;
  for (int i = 0; i < p.nst; ++i)
    n += cdiv(kv_side ? p.st[i].kv_rows : p.st[i].q_rows, rows_per_tile);
  return n;
}

}  // namespace generic_attn
