// The online-softmax attention forward of the joint entry points, all in
// joint_attention.cu so that each instance compiles once: the joint
// image+text kernel and its single-stream form (`mha_rms`). The plain
// multi-head forwards (`mha_bshd`, `mha`) have their own wgmma + TMA kernel
// (attention_fwd_sm90.cu).
//
// One kernel template per head width D (64 or 128) walks one or two token
// streams. Each stream is read in place through its (batch, row, head)
// strides, so q/k/v can stay in the (B, S, H*D) projection layout or be
// column slices of one fused projection; a stream's kv rows stop at its
// `kv_len`, and q rows at its `len`.
//
// Design (FlashAttention-2 shape, mma.sync):
//  * one block of 4 warps per (q tile of 64 rows, head, batch item); the q
//    tiles of the first stream come first in the grid, then the second's;
//  * the block walks the kv tiles of the first stream and then of the second
//    (64 rows each) into ONE fp32 accumulator with an online softmax, so the
//    streams are never concatenated and nothing is padded in device memory;
//  * RMS in fp32, then x weight (when the stream has qk-norm weights), then
//    q x sm_scale*log2(e) and the cast to bf16, so QK^T comes out pre-scaled:
//    the order of the TPU's `_joint_fwd_kernel` and `_single_fwd_kernel`;
//    scores, running max and sum in fp32 with exp2; p cast to bf16 before
//    p.v; p.v accumulated in fp32; divide by l at the end (a row with l == 0
//    divides by 1, as the TPU kernels do); the natural-log lse = ln2 * (m +
//    log2 max(l, 1e-37)), as the TPU kernels write it, into an fp32 (B, H, S)
//    array when one is given;
//  * ragged q rows and kv columns past a stream's kv_len are masked in the
//    kernel;
//  * each warp owns 16 q rows end to end: Q.K^T and P.V are bf16 mma.sync
//    (m16n8k16) products whose score, probability and output tiles never
//    leave registers; only k/v go through (double-buffered, dynamic) shared
//    memory. q is staged in the second k buffer before the walk starts.
//  * D = 64 fetches the next k/v tile into registers before the current
//    tile's math, so the loads overlap it. At D = 128 the output accumulator
//    (64 fp32 per thread) and the q fragments (32 registers) double, and 64
//    more registers of prefetched k/v would spill past 255: there the next
//    tile is fetched after the math, and other blocks on the SM hide its
//    latency.

#pragma once

#include "attention_tiles.cuh"

namespace attn {
namespace {

struct Stream {  // one token stream; strides in elements
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* o;
  float* lse;  // (B, H, len) fp32, or null when not wanted
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh;
  int len;     // q (and o) rows
  int kv_len;  // k/v rows attended to
  const float* wq;  // (D,) RMS weights, or null when there is no qk-norm
  const float* wk;
};

// kv tile number `i` of the walk over the first stream, then the second
struct KvTile {
  const bf16* k;
  const bf16* v;
  long long k_ss, v_ss;
  int row0, len;
  const float* wk;
};

__device__ __forceinline__ KvTile kv_tile(const Stream& s0, const Stream& s1, int s0_tiles,
                                          int i, long long b, int h) {
  const bool second = i >= s0_tiles;
  const Stream& s = second ? s1 : s0;
  KvTile t;
  t.k = s.k + b * s.k_sb + h * s.k_sh;
  t.v = s.v + b * s.v_sb + h * s.v_sh;
  t.k_ss = s.k_ss;
  t.v_ss = s.v_ss;
  t.row0 = (second ? i - s0_tiles : i) * kBKV;
  t.len = s.kv_len;
  t.wk = s.wk;
  return t;
}

template <int D>
constexpr int fwd_smem_bytes() {
  return 4 * kBKV * ld_of<D>() * static_cast<int>(sizeof(bf16));  // k, v double-buffered
}

// Three blocks per SM at D = 64: at most 168 registers a thread (unbounded,
// ptxas takes 173, which leaves room for two). Two at D = 128 (207).
template <int D>
__global__ void __launch_bounds__(kThreads, D == 64 ? 3 : 1)
    attn_fwd_kernel(const __grid_constant__ Stream s0, const __grid_constant__ Stream s1,
                    int s0_qtiles, float qscale, float eps) {
  constexpr int kTile = kBKV * ld_of<D>();
  constexpr bool kPrefetch = D == 64;
  extern __shared__ uint4 smem_u4[];
  bf16* const smem = reinterpret_cast<bf16*>(smem_u4);
  // k buffers 0 and 1, then v buffers 0 and 1
  auto ks = [smem](int i) { return smem + (i & 1) * kTile; };
  auto vs = [smem](int i) { return smem + (2 + (i & 1)) * kTile; };

  const int h = blockIdx.y;
  const long long b = blockIdx.z;
  const bool q_second = static_cast<int>(blockIdx.x) >= s0_qtiles;
  const Stream& sq = q_second ? s1 : s0;
  const int q0 = (static_cast<int>(blockIdx.x) - (q_second ? s0_qtiles : 0)) * kBQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;  // mma fragment row group / column pair
  const int s0_tiles = (s0.kv_len + kBKV - 1) / kBKV;
  const int n_tiles = s0_tiles + (s1.kv_len + kBKV - 1) / kBKV;

  TileRegsT<D> kr, vr;
  fetch_tile<D>(kr, sq.q + b * sq.q_sb + h * sq.q_sh, sq.q_ss, q0, sq.len);
  store_tile<D>(ks(1), kr, sq.wq, eps, qscale);
  {
    const KvTile t0 = kv_tile(s0, s1, s0_tiles, 0, b, h);
    fetch_tile<D>(kr, t0.k, t0.k_ss, t0.row0, t0.len);
    fetch_tile<D>(vr, t0.v, t0.v_ss, t0.row0, t0.len);
    store_tile<D>(ks(0), kr, t0.wk, eps, 1.f);
    store_tile<D>(vs(0), vr, nullptr, eps, 1.f);
  }
  __syncthreads();

  uint32_t qa[D / 16][4];  // this warp's 16 q rows as A fragments
  load_a_frags<D>(qa, ks(1), 16 * warp, g, t);
  __syncthreads();  // every warp holds its q: the second k buffer is free

  float o[D / 8][4];  // output rows g and g+8, columns 8n + 2t, +1
  zero(o);
  float m0 = -INFINITY, m1 = -INFINITY;  // running max of rows g, g+8
  float l0 = 0.f, l1 = 0.f;              // this thread's share of the row sums

  for (int i = 0; i < n_tiles; ++i) {
    const bool more = i + 1 < n_tiles;
    KvTile next{};
    if (kPrefetch && more) {  // the next tile's loads stay in flight during the math
      next = kv_tile(s0, s1, s0_tiles, i + 1, b, h);
      fetch_tile<D>(kr, next.k, next.k_ss, next.row0, next.len);
      fetch_tile<D>(vr, next.v, next.v_ss, next.row0, next.len);
    }

    float sc[kBKV / 8][4];  // scores: rows g, g+8 x columns 8j + 2t, +1
    zero(sc);
    mma_abt<D>(sc, qa, ks(i), lane);

    const KvTile cur = kv_tile(s0, s1, s0_tiles, i, b, h);
    const int nvalid = cur.len - cur.row0;
    if (nvalid < kBKV) {
#pragma unroll
      for (int j = 0; j < kBKV / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (8 * j + 2 * t + (e & 1) >= nvalid) sc[j][e] = -INFINITY;
    }

    // online softmax in base 2 (the scores carry sm_scale*log2(e)); a row's four
    // column-pair threads are lanes 4g..4g+3
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < kBKV / 8; ++j) {
      mx0 = fmaxf(mx0, fmaxf(sc[j][0], sc[j][1]));
      mx1 = fmaxf(mx1, fmaxf(sc[j][2], sc[j][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    // a row that has seen only masked columns keeps m = -inf: guard
    // exp2(-inf - -inf)
    const float a0 = m0 == -INFINITY ? 0.f : exp2f(m0 - mn0);
    const float a1 = m1 == -INFINITY ? 0.f : exp2f(m1 - mn1);
    const float base0 = mn0 == -INFINITY ? 0.f : mn0;
    const float base1 = mn1 == -INFINITY ? 0.f : mn1;
    m0 = mn0;
    m1 = mn1;

    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int j = 0; j < kBKV / 8; ++j) {
      sc[j][0] = exp2f(sc[j][0] - base0);
      sc[j][1] = exp2f(sc[j][1] - base0);
      sc[j][2] = exp2f(sc[j][2] - base1);
      sc[j][3] = exp2f(sc[j][3] - base1);
      ps0 += sc[j][0] + sc[j][1];
      ps1 += sc[j][2] + sc[j][3];
    }
    uint32_t pa[kBKV / 16][4];  // p as the A fragments of p.v
    acc_to_a(pa, sc);
    l0 = l0 * a0 + ps0;
    l1 = l1 * a1 + ps1;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      o[n][0] *= a0;
      o[n][1] *= a0;
      o[n][2] *= a1;
      o[n][3] *= a1;
    }
    mma_ab<D>(o, pa, vs(i), lane);

    if (more) {
      if (!kPrefetch) {
        next = kv_tile(s0, s1, s0_tiles, i + 1, b, h);
        fetch_tile<D>(kr, next.k, next.k_ss, next.row0, next.len);
        fetch_tile<D>(vr, next.v, next.v_ss, next.row0, next.len);
      }
      store_tile<D>(ks(i + 1), kr, next.wk, eps, 1.f);
      store_tile<D>(vs(i + 1), vr, nullptr, eps, 1.f);
    }
    __syncthreads();  // tile i+1 is in shared memory; tile i is free again
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const int r0 = q0 + 16 * warp + g;
  store_rows<D>(sq.o + b * sq.o_sb + h * sq.o_sh, sq.o_ss, r0, sq.len, o,
                l0 == 0.f ? 1.f : l0, l1 == 0.f ? 1.f : l1, t);
  if (sq.lse != nullptr && t == 0) {
    // natural-log lse for the backward: ln(sum e^s) = ln2 * lse2
    float* lse = sq.lse + (b * gridDim.y + h) * sq.len;
    if (r0 < sq.len) lse[r0] = (m0 + log2f(fmaxf(l0, 1e-37f))) * kLn2;
    if (r0 + 8 < sq.len) lse[r0 + 8] = (m1 + log2f(fmaxf(l1, 1e-37f))) * kLn2;
  }
}

template <int D>
int launch_fwd(const Stream& s0, const Stream& s1, int batch, int num_heads, float qscale,
               float eps, void* stream) {
  const int s0_qtiles = (s0.len + kBQ - 1) / kBQ;
  const int s1_qtiles = (s1.len + kBQ - 1) / kBQ;
  const dim3 grid(s0_qtiles + s1_qtiles, num_heads, batch);
  constexpr int smem = fwd_smem_bytes<D>();
  if (smem > 48 * 1024) {  // above the static limit only after opting in
    const cudaError_t e = cudaFuncSetAttribute(
        attn_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  attn_fwd_kernel<D><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      s0, s1, s0_qtiles, qscale, eps);
  return static_cast<int>(cudaGetLastError());
}

// The head width as a template argument; any other width is refused.
// qscale = sm_scale * log2(e), applied to q.
int launch_fwd_dim(int head_dim, const Stream& s0, const Stream& s1, int batch, int num_heads,
                   float qscale, float eps, void* stream) {
  switch (head_dim) {
    case 64:
      return launch_fwd<64>(s0, s1, batch, num_heads, qscale, eps, stream);
    case 128:
      return launch_fwd<128>(s0, s1, batch, num_heads, qscale, eps, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// A stream with no tokens: the second stream of a single-stream call.
inline Stream empty_stream() {
  Stream s{};
  return s;
}

}  // namespace
}  // namespace attn
