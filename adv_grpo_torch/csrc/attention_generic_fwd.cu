// The generic attention forward for Hopper (sm_90a): fp32 at any head width
// d <= 128, bf16 at the widths d <= 128 other than 64 and 128, in the four
// layouts of the wgmma + TMA forward (attention_generic.cuh: kJoint two
// streams or one, with or without the fused qk-RMS; kBshd with kv_len and
// row strides; kBhsd).
//
// Replaces, where the wgmma + TMA kernel (attention_fwd_sm90.cu) does not
// reach: adv_grpo_tpu/ops/joint_attention.py `_joint_fwd_kernel` (#2) and
// `_single_fwd_kernel` (#3), adv_grpo_tpu/ops/attention.py
// `_bshd_fwd_kernel` (#8) and `_fwd_kernel` (#10). The TPU kernels take any
// dtype (their dots run in the input's dtype) and any d with 128 % d == 0,
// packing 128 / d heads per column group, and fall back to the unfused
// composition of the same kernels elsewhere; the (B, H, S, D) kernel at the
// end of that chain takes a whole head of any width.
//
// Bound on this card: in fp32 the FFMA rate (67 TFLOP/s), since fp32 takes
// no tensor core here; in bf16 the tensor cores (989 TFLOP/s), which this
// kernel does not use either. It is the simple, right kernel; its times are
// in PERF.md beside the bound.
//
// Design. One CTA of 256 threads per (64-row q tile, head, batch item),
// which walks the 128-row kv tiles of stream 0 and then of stream 1 (the
// twin's tile, so the running max, and with it where bf16 rounds p, is the
// twin's) with an online base-2 softmax. The q tile, each K / V tile and
// the tile of p are staged in shared memory as fp32, rows padded by one
// word against bank conflicts. Thread (ty, tx) owns the q rows 4ty..4ty+3
// and, of the scores, the kv columns tx + 16j, of the output the columns tx
// + 16c: the row statistics stay in its registers, reduced over the 16 lanes
// of a row group by shuffles. p = exp2(s - m) is rounded to dt for p.v and
// summed unrounded into l, as the twin does; o = acc / l and lse = ln2 (m +
// log2 l), fp32 (B, H, S).

#include "attention_generic.cuh"

namespace generic_attn {
namespace {

constexpr int kBQ = 64;    // q rows of a CTA
constexpr int kBKV = 128;  // kv rows of a tile (the twin's KV_TILE)

template <int DMAX>
struct FwdSmem {
  static constexpr int kLd = DMAX + 1;  // padded row of the Q and K tiles
  static constexpr int kLdP = kBKV + 1;
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kBQ * kLd;
  static constexpr int kV = kK + kBKV * kLd;
  static constexpr int kP = kV + kBKV * DMAX;
  static constexpr int kFloats = kP + kBQ * kLdP;
  static constexpr size_t kBytes = kFloats * sizeof(float);
};

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads) attn_generic_fwd_kernel(const __grid_constant__ Params p) {
  using L = FwdSmem<DMAX>;
  constexpr int C = DMAX / 16;  // output columns a thread owns
  extern __shared__ float smem[];
  float* sQ = smem + L::kQ;
  float* sK = smem + L::kK;
  float* sV = smem + L::kV;
  float* sP = smem + L::kP;
  const int h = blockIdx.y, b = blockIdx.z;
  int t = blockIdx.x;
  const Stream& S = p.st[stream_of(p, kBQ, false, t)];
  const int r0 = t * kBQ;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;

  load_tile<T, DMAX>(sQ, L::kLd, kBQ, S.q, b, h, r0, imin(kBQ, S.q_rows - r0), p.d);

  float m[4], l[4], acc[4][C];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) acc[i][c] = 0.f;
  }
  for (int ks = 0; ks < p.nst; ++ks) {
    const Stream& K = p.st[ks];
    for (int c0 = 0; c0 < K.kv_valid; c0 += kBKV) {
      const int nk = imin(kBKV, K.kv_valid - c0);
      __syncthreads();  // the last tile's K, V and p are read
      load_tile<T, DMAX>(sK, L::kLd, kBKV, K.k, b, h, c0, nk, p.d);
      load_tile<T, DMAX>(sV, DMAX, kBKV, K.v, b, h, c0, nk, p.d);
      __syncthreads();
      float s[4][8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 4
      for (int e = 0; e < DMAX; ++e) {
        float qa[4], kb[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) qa[i] = sQ[(4 * ty + i) * L::kLd + e];
#pragma unroll
        for (int j = 0; j < 8; ++j) kb[j] = sK[(tx + 16 * j) * L::kLd + e];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          s[i][j] = tx + 16 * j < nk ? s[i][j] * p.score_scale : -INFINITY;
          mx = fmaxf(mx, s[i][j]);
        }
#pragma unroll
        for (int o = 8; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        const float m_new = fmaxf(m[i], mx);
        const float a = exp2f(m[i] - m_new);
        float ps = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float pj = exp2f(s[i][j] - m_new);
          ps += pj;
          sP[(4 * ty + i) * L::kLdP + tx + 16 * j] = round_to<T>(pj);
        }
#pragma unroll
        for (int o = 8; o > 0; o >>= 1) ps += __shfl_xor_sync(0xffffffffu, ps, o);
        l[i] = l[i] * a + ps;
        m[i] = m_new;
#pragma unroll
        for (int c = 0; c < C; ++c) acc[i][c] *= a;
      }
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < nk; ++kk) {
        float pa[4], vb[C];
#pragma unroll
        for (int i = 0; i < 4; ++i) pa[i] = sP[(4 * ty + i) * L::kLdP + kk];
#pragma unroll
        for (int c = 0; c < C; ++c) vb[c] = sV[kk * DMAX + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < C; ++c) acc[i][c] = fmaf(pa[i], vb[c], acc[i][c]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + 4 * ty + i;
    if (row >= S.q_rows) continue;
    const float den = l[i] == 0.f ? 1.f : l[i];
    T* o = at_mut<T>(S.out, b, row, h);
#pragma unroll
    for (int c = 0; c < C; ++c)
      if (tx + 16 * c < p.d) o[tx + 16 * c] = from_f<T>(acc[i][c] / den);
    if (tx == 0 && S.lse != nullptr)
      S.lse[(static_cast<long long>(b) * p.heads + h) * S.q_rows + row] =
          (m[i] + log2f(fmaxf(l[i], 1e-37f))) * kLn2;
  }
}

template <typename T, int DMAX>
int launch_fwd(const Params& p, int batch, cudaStream_t stream) {
  using L = FwdSmem<DMAX>;
  const auto kernel = attn_generic_fwd_kernel<T, DMAX>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(L::kBytes));
  const dim3 grid(tiles_of(p, kBQ, false), p.heads, batch);
  kernel<<<grid, kThreads, L::kBytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int run(const long long* desc, int nst, int mode, int batch, int heads, int d, float qscale,
        float eps, cudaStream_t stream) {
  Params p{};
  int rc = setup_streams<T>(p, desc, nst, mode, batch, heads, d, qscale, 0.f, eps, false,
                            stream);
  if (rc != 0) return rc;
  p.score_scale = mode == kJoint ? 1.f : qscale;  // q^ holds the scale in kJoint
  if (d <= 32) return launch_fwd<T, 32>(p, batch, stream);
  if (d <= 64) return launch_fwd<T, 64>(p, batch, stream);
  return launch_fwd<T, 128>(p, batch, stream);
}

}  // namespace
}  // namespace generic_attn

// desc: `nst` streams of generic_attn::kDescLen int64 each (the lengths, the
// Views of q, k, v and o, the lse and RMS weight pointers, the kJoint
// scratches; attention_generic.cuh `Desc`); dtype: 0 fp32, 1 bf16; mode:
// generic_attn::Mode; qscale = sm_scale * log2 e. Head width d <= 128 and a
// multiple of 16 bytes' worth of elements, every row 16-byte aligned (the
// wrapper checks). Returns the first cudaGetLastError() that is not 0.
extern "C" int attention_generic_fwd(const long long* desc, int nst, int dtype, int mode,
                                     int batch, int num_heads, int head_dim, float qscale,
                                     float eps, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (head_dim < 1 || head_dim > 128 || nst < 1 || nst > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return generic_attn::run<float>(desc, nst, mode, batch, num_heads, head_dim, qscale, eps,
                                    s);
  return generic_attn::run<__nv_bfloat16>(desc, nst, mode, batch, num_heads, head_dim, qscale,
                                          eps, s);
}
