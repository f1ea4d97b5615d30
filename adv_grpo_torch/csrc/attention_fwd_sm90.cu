// Forward of softmax attention for Hopper (sm_90a): one warp-specialised
// wgmma + TMA kernel (FlashAttention-3's forward shape),
// `attn_fwd_sm90_kernel<D, kMode>` at head widths D = 64 and 128, behind four
// entry points:
//   * `mha_bshd_fwd_bf16` (#8): q and k/v of their own lengths in any (batch,
//     row, head) strides (the BSHD layout; Flux's single blocks and WAN's
//     self- and cross-attention read the column slices of their fused
//     projections in place), keys at or past `kv_len` masked;
//   * `mha_fwd_bf16` (#10): the same on contiguous (B, H, S, D) tensors;
//   * `joint_attention_fwd_bf16` (#2): two token streams, image then text,
//     each in the (B, S, H*D) layout, attending jointly to the keys of both,
//     with the per-head qk-RMS fused or not;
//   * `mha_rms_fwd_bf16` (#3): the same with one stream.
// Each can write the per-row natural-log lse the backward needs.
//
// Replaces: adv_grpo_tpu/ops/attention.py `_bshd_fwd_kernel` (through
// `_bshd_fwd`, public `mha_bshd`) and `_fwd_kernel` (through `_flash_fwd`,
// behind the custom VJP `_flash_mha` and the public `mha`, which
// `context_parallel_attention` runs on the gathered keys); and
// adv_grpo_tpu/ops/joint_attention.py `_joint_fwd_kernel` (through
// `_joint_fwd`, public `joint_mha`) and `_single_fwd_kernel` (through
// `_single_fwd`, public `mha_rms`), with their `save_residuals=True` lse.
// SD3.5-M runs the joint and single-stream forms 24 and 13 times per MMDiT
// forward at head width 64 with the qk-RMS fused; Flux.1-dev the joint one 19
// times at 128 without it (its qk-norm and RoPE come before).
//
// Contract, per mode (the TPU kernels' op orders):
//  * kScaleS (#8, #10): s is the fp32 product of the bf16 q and k as stored,
//    scaled in fp32 by qscale = sm_scale * log2(e) (one FFMA with the running
//    max in the exponent; q is never pre-scaled);
//  * kScaleQ (#2, #3 without qk-norm): q^ = bf16(q * qscale), k as stored,
//    s = q^ k^T in fp32, already in base 2: no fp32 multiply of the scores;
//  * kRmsQ (#2, #3 with it): in fp32, q^ = bf16(q * rsqrt(mean(q^2) + eps) *
//    wq * qscale) and k^ = bf16(k * rsqrt(mean(k^2) + eps) * wk), then as
//    kScaleQ (the sums of squares in a fixed order, per 8-column chunk and
//    then over the chunks; the rsqrt correctly rounded);
// and in every mode: keys at or past a stream's kv_len are masked; the
// softmax runs online in base 2 over the kv tiles of the first stream and
// then of the second, with fp32 max and sum; p is cast to bf16 for p.v, which
// accumulates in fp32; o = acc / l, where a row with l == 0 divides by 1; lse
// = ln2 * (m + log2 max(l, 1e-37)), fp32 (B, H, S) per stream, when a pointer
// is given.
//
// Bound on this card: tensor-core math. Per (batch item, head) the forward is
// 2 products of S_q x S_kv x D; at WAN's 8,100 tokens x 12 heads of 128 that
// is 403 GFLOP against ~100 MB of q, k, v and o, and at SD3.5-M's 1,024 + 154
// tokens x 24 heads of 64 8.5 GFLOP per batch item against ~1.4 MB: far
// above the ~295 flop/byte ridge.
//
// Design:
//  * one CTA of 3 warpgroups per (q tile of 128 rows, head, batch item); in
//    the joint modes the grid's x runs over the first stream's q tiles and
//    then the second's. WG0, after setmaxnreg.dec, is the producer: one
//    thread TMA-loads the CTA's Q tile once, then streams the 128-row K and V
//    tiles of the first stream and then of the second through a ring of 2
//    stages, K and V each with their own full / empty mbarriers (so S_j can
//    start before V_j lands). WG1 and WG2, after setmaxnreg.inc, each own 64
//    q rows and keep their O accumulator (64 x D fp32), running max and sum
//    in registers for the whole walk;
//  * the q transform of the joint modes runs once per CTA: each consumer
//    rewrites its own 64 rows of the Q tile in shared memory (two threads a
//    row, reading the 128-byte-swizzled tile conflict-free), then
//    fence.proxy.async and a barrier over its 128 threads before its first
//    wgmma reads them;
//  * the k transform of kRmsQ runs once per call, before the attention:
//    `rms_k_kernel` writes k^ of both streams into a scratch the wrapper
//    allocates (one thread per 16 bytes, a row's sum over its lanes), and
//    the K maps read that. Normalising each K tile inside this kernel, on
//    the producer warpgroup as it landed, repeated it for every q tile and
//    read 2.7x this form's kernel time at SD3.5-M's CFG batch 2 on an H100
//    (0.216 against 0.079 ms, chip_smoke.py --sd3-attention-ms): the
//    warpgroup could not normalise a tile in the time the consumers took to
//    walk one;
//  * per kv tile j, each consumer: S_j = Q K_j^T (SS wgmma m64n128k16, both
//    operands K-major from the swizzled tiles); the mask, the online softmax
//    and the rescale of O in registers; P_j to bf16 A fragments in
//    registers; O += P_j V_j (RS wgmma, V read MN-major through the
//    transpose bit);
//  * the two consumers ping-pong: a consumer's turn issues S_j and O +=
//    P_{j-1} V_{j-1} back to back, and two named barriers (1 + consumer)
//    make the turns alternate, so one consumer's softmax (exp2 at 16 a clock
//    per SM) runs while the other's products hold the tensor cores. Inside a
//    consumer the softmax of S_j also runs while its own P_{j-1} V_{j-1}
//    does (two commit groups; O is rescaled and P_j packed after the wait):
//    on an H100 (chip_smoke.py --attention-fwd-ms) that read 6-14% faster
//    by kernel time at every timed shape than waiting for both products;
//  * every operand tile arrives by TMA with the 128-byte swizzle (boxes of 64
//    columns x 128 rows, two per tile at D = 128), which the wgmma
//    descriptors read directly. Each stream's K / V maps end at its kv_len:
//    rows past it read as zeros, and the kv tiles wholly past it are not
//    walked; the keys of a tile at or past its stream's kv_len get -inf. q
//    rows past a stream's length read as zeros and are never stored (nor
//    their lse);
//  * shared memory: Q 128 x D plus 2 (K, V) pairs of 128 x D bf16; at D =
//    128, 32 + 2 x 64 KB: one CTA per SM. At D = 64 (16 + 2 x 32 KB) two
//    CTAs would fit the shared memory, but a CTA holds 168 registers x 384
//    threads, 64,512 of the SM's 65,536, so one runs per SM there too. A
//    third stage (fits at 224 KB) read no faster at either head width.

#include <cuda_bf16.h>
#include <math.h>
#include <string.h>

#include "sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace sm90;

constexpr int kBQ = 128;    // q rows per CTA, 64 per consumer warpgroup
constexpr int kBKV = 128;   // kv rows per ring stage
constexpr int kStages = 2;  // K / V ring depth (a third stage read no faster)
constexpr int kThreads = 384;
constexpr int kProducerRegs = 24, kConsumerRegs = 240;
constexpr int kBarTurn = 1;  // named barriers 1, 2: consumer 0's, 1's turn to issue
constexpr int kTurnThreads = 256;
constexpr int kBarQ = 3;  // named barriers 3, 4: consumer 0's, 1's q rows rewritten
constexpr float kLn2 = 0.6931471805599453f;

// how q meets the scores (see the contract above)
constexpr int kScaleS = 0;  // #8, #10
constexpr int kScaleQ = 1;  // #2, #3 without qk-norm
constexpr int kRmsQ = 2;    // #2, #3 with it (k^ from rms_k_kernel)

// shared-memory layout, byte offsets (every tile 1024-byte aligned). A bf16
// tile of R rows and D columns is D/64 column blocks of R rows x 128 bytes.
template <int D>
struct Smem {
  static constexpr int kQBytes = kBQ * D * 2;
  static constexpr int kKvBytes = kBKV * D * 2;
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kQBytes;
  static constexpr int kV = kK + kStages * kKvBytes;
  static constexpr int kBars = kV + kStages * kKvBytes;
  // q_full, then k_full, v_full, k_empty, v_empty per stage
  static constexpr int kBytes = kBars + 8 * (1 + 4 * kStages);
};

struct Stream {  // one token stream's output side, lengths and q's RMS weights
  bf16* o;
  float* lse;  // (B, H, sq) fp32, natural log; null when not wanted
  const float* wq;  // (D,) fp32 (kRmsQ only)
  long long o_sb, o_ss, o_sh;  // element strides
  int sq, kv_len;  // q (and o) rows; keys attended to
};

struct Params {
  Stream st[2];  // the second only in the joint modes (no rows for mha_rms)
  int heads;
  int bhsd;      // the maps are (D, S, H, B) rather than (D, H, S, B)
  int q_tiles0;  // the first stream's q tiles: the grid's x runs over them first
  float qscale, eps;
};

// the TMA maps of q, k, v of each of N streams
template <int N>
struct Maps {
  CUtensorMap q[N], k[N], v[N];
};

template <int kMode>
using MapsOf = Maps<kMode == kScaleS ? 1 : 2>;

struct Bars {
  uint64_t *q_full, *k_full, *v_full, *k_empty, *v_empty;
};

template <int D>
__device__ __forceinline__ Bars bars_of(uint8_t* smem) {
  uint64_t* const b = reinterpret_cast<uint64_t*>(smem + Smem<D>::kBars);
  return {b, b + 1, b + 1 + kStages, b + 1 + 2 * kStages, b + 1 + 3 * kStages};
}

// The CTA's walk: its q tile, and the kv tiles of the first stream and then
// of the second (each stream's tiles wholly past its kv_len are not walked)
struct Walk {
  int qs;  // the stream of the q tile
  int q0;  // its first row in that stream
  int n0;  // the first stream's kv tiles
  int n;   // all kv tiles
};

template <int kMode>
__device__ __forceinline__ Walk walk_of(const Params& p) {
  const int x = static_cast<int>(blockIdx.x);
  const int qs = kMode != kScaleS && x >= p.q_tiles0;
  const int n0 = cdiv(p.st[0].kv_len, kBKV);
  const int n1 = kMode != kScaleS ? cdiv(p.st[1].kv_len, kBKV) : 0;
  return {qs, (x - (qs ? p.q_tiles0 : 0)) * kBQ, n0, n0 + n1};
}

// kv tile j of the walk: its stream, and its first row in that stream
__device__ __forceinline__ int2 kv_tile(const Walk& w, int j) {
  return j < w.n0 ? make_int2(0, j * kBKV) : make_int2(1, (j - w.n0) * kBKV);
}

// ── producer ──

template <int D, int N>
__device__ __forceinline__ void load_q(const Maps<N>& m, const Params& p, uint8_t* smem,
                                       const Walk& w) {
  using L = Smem<D>;
  const Bars bar = bars_of<D>(smem);
  const int h = blockIdx.y, b = blockIdx.z;
  // dims 1 and 2 of the maps: (heads, rows) for BSHD, (rows, heads) for BHSD
  const int q1 = p.bhsd ? w.q0 : h, q2 = p.bhsd ? h : w.q0;
  mbar_arrive_expect_tx(bar.q_full, L::kQBytes);
  for (int c = 0; c < D / 64; ++c)
    tma_load_4d(smem + L::kQ + c * kBQ * 128, &m.q[w.qs], bar.q_full, 64 * c, q1, q2, b);
}

// K_j and V_j into stage j % kStages, each once both consumers have released
// the tile that stage held
template <int D, int N>
__device__ __forceinline__ void load_kv(const Maps<N>& m, const Params& p, uint8_t* smem,
                                        const Walk& w, int j) {
  using L = Smem<D>;
  const Bars bar = bars_of<D>(smem);
  const int h = blockIdx.y, b = blockIdx.z;
  const int s = j % kStages, free_parity = ((j / kStages) & 1) ^ 1;
  const int2 t = kv_tile(w, j);
  const int c1 = p.bhsd ? t.y : h, c2 = p.bhsd ? h : t.y;
  const int off = s * L::kKvBytes;
  mbar_wait(bar.k_empty + s, free_parity);
  mbar_arrive_expect_tx(bar.k_full + s, L::kKvBytes);
  for (int c = 0; c < D / 64; ++c)
    tma_load_4d(smem + L::kK + off + c * kBKV * 128, &m.k[t.x], bar.k_full + s, 64 * c, c1, c2,
                b);
  mbar_wait(bar.v_empty + s, free_parity);
  mbar_arrive_expect_tx(bar.v_full + s, L::kKvBytes);
  for (int c = 0; c < D / 64; ++c)
    tma_load_4d(smem + L::kV + off + c * kBKV * 128, &m.v[t.x], bar.v_full + s, 64 * c, c1, c2,
                b);
}

// byte offset of the 16-byte chunk c (columns 8c .. 8c + 7) of row r in a
// 128-byte-swizzled tile of `rows` rows: column block c / 8, chunk (c % 8) ^
// (r % 8) of the row's 128 bytes
__device__ __forceinline__ int chunk_off(int c, int r, int rows) {
  return (c / 8) * rows * 128 + r * 128 + (((c % 8) ^ (r % 8)) << 4);
}

// one thread: Q once, then K_j and V_j of the walk
template <int D, int N>
__device__ __forceinline__ void produce(const Maps<N>& m, const Params& p, uint8_t* smem,
                                        const Walk& w) {
  load_q<D>(m, p, smem, w);
  for (int j = 0; j < w.n; ++j) load_kv<D>(m, p, smem, w, j);
}

// ── consumers ──

// The q transform of a consumer thread: its row of the Q tile and its half
// of that row, thread `half` taking chunks 4 half .. 4 half + 3 of each
// column block, so a quarter-warp (four rows) reads eight distinct chunks
__device__ __forceinline__ int q_chunk(int i, int half) { return 8 * (i / 4) + 4 * half + i % 4; }

// kRmsQ: this thread's D / 2 RMS weights of q, loaded while the Q tile lands
template <int D>
__device__ __forceinline__ void load_q_weights(float (&wv)[D / 2], const float* w, int half) {
#pragma unroll
  for (int i = 0; i < D / 16; ++i)
#pragma unroll
    for (int e = 0; e < 8; ++e) wv[8 * i + e] = __ldg(w + 8 * q_chunk(i, half) + e);
}

// q^ = bf16(q * qscale), with the RMS and the weights wv first in kRmsQ, for
// this consumer's 64 rows of the Q tile, in place: two threads a row
template <int D, int kMode>
__device__ __forceinline__ void transform_q(uint8_t* q, int cw, int tid, const float (&wv)[D / 2],
                                            float qscale, float eps) {
  const int r = 64 * cw + tid / 2, half = tid % 2;
  float rs = 1.f;
  if constexpr (kMode == kRmsQ) {
    float ss = 0.f;
#pragma unroll
    for (int i = 0; i < D / 16; ++i)
      ss += sum_sq(*reinterpret_cast<const uint4*>(q + chunk_off(q_chunk(i, half), r, kBQ)));
    ss += __shfl_xor_sync(0xffffffffu, ss, 1);
    rs = rms_scale<D>(ss, eps);
  }
#pragma unroll
  for (int i = 0; i < D / 16; ++i) {
    uint4* const x = reinterpret_cast<uint4*>(q + chunk_off(q_chunk(i, half), r, kBQ));
    *x = scale_chunk(*x, rs, kMode == kRmsQ ? wv + 8 * i : nullptr, qscale);
  }
}

// the running max and this thread's share of the sum of its rows g and g + 8
// (the max in units of s: kScaleS scales it by qscale where it is used)
struct Rows {
  float m0, m1, l0, l1;
};

// S = Q K^T: 64 q x 128 kv, both operands K-major; q: this consumer's rows
// of the Q tile, k: the K tile
template <int D>
__device__ __forceinline__ void issue_s(float (&s)[kBKV / 2], uint32_t q, uint32_t k) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_m64n128_ss<0, 0>(s, desc_sw128(q + (kk / 4) * kBQ * 128 + (kk % 4) * 32, 16, 1024),
                           desc_sw128(k + (kk / 4) * kBKV * 128 + (kk % 4) * 32, 16, 1024),
                           kk > 0);
}

// O += P V: A = P from registers, B = the V tile (kv x D), MN-major, column
// blocks kBKV rows apart
template <int D>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2], const uint32_t (&pa)[kBKV / 16][4],
                                         uint32_t v) {
#pragma unroll
  for (int kk = 0; kk < kBKV / 16; ++kk)
    wgmma_rs<D, 1>(o, pa[kk], desc_sw128(v + kk * 2048, kBKV * 128, 1024), 1);
}

// The online softmax of one S tile whose first `nvalid` columns are keys
// before their stream's kv_len: mask, new max, P = exp2(S qscale - max) in
// place of S and the rescaled sums; returns the factors (a0, a1) that rescale
// O. qscale is 1 where q carries it (the joint modes).
__device__ __forceinline__ float2 softmax(float (&s)[kBKV / 2], Rows& r, int nvalid, int t,
                                          float qscale) {
  if (nvalid < kBKV) {
#pragma unroll
    for (int n = 0; n < kBKV / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (8 * n + 2 * t + (e & 1) >= nvalid) s[4 * n + e] = -INFINITY;
  }
  float mx0 = r.m0, mx1 = r.m1;
#pragma unroll
  for (int n = 0; n < kBKV / 8; ++n) {
    mx0 = fmaxf(mx0, fmaxf(s[4 * n], s[4 * n + 1]));
    mx1 = fmaxf(mx1, fmaxf(s[4 * n + 2], s[4 * n + 3]));
  }
  // a row's four column-pair threads are lanes 4g .. 4g + 3
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
  }
  // a row that has seen only masked columns keeps m = -inf: guard
  // exp2(-inf - -inf)
  const float a0 = r.m0 == -INFINITY ? 0.f : exp2f((r.m0 - mx0) * qscale);
  const float a1 = r.m1 == -INFINITY ? 0.f : exp2f((r.m1 - mx1) * qscale);
  const float base0 = mx0 == -INFINITY ? 0.f : mx0 * qscale;
  const float base1 = mx1 == -INFINITY ? 0.f : mx1 * qscale;
  r.m0 = mx0;
  r.m1 = mx1;
  float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
  for (int n = 0; n < kBKV / 8; ++n) {
    s[4 * n] = exp2f(fmaf(s[4 * n], qscale, -base0));
    s[4 * n + 1] = exp2f(fmaf(s[4 * n + 1], qscale, -base0));
    s[4 * n + 2] = exp2f(fmaf(s[4 * n + 2], qscale, -base1));
    s[4 * n + 3] = exp2f(fmaf(s[4 * n + 3], qscale, -base1));
    ps0 += s[4 * n] + s[4 * n + 1];
    ps1 += s[4 * n + 2] + s[4 * n + 3];
  }
  r.l0 = r.l0 * a0 + ps0;
  r.l1 = r.l1 * a1 + ps1;
  return make_float2(a0, a1);
}

// O *= a (rows g, g + 8), and P as the bf16 A fragments of O += P V
template <int D>
__device__ __forceinline__ void rescale_pack(float (&o)[D / 2], uint32_t (&pa)[kBKV / 16][4],
                                             const float (&s)[kBKV / 2], float2 a) {
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    o[4 * n] *= a.x;
    o[4 * n + 1] *= a.x;
    o[4 * n + 2] *= a.y;
    o[4 * n + 3] *= a.y;
  }
#pragma unroll
  for (int kk = 0; kk < kBKV / 16; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) pa[kk][e] = pack_bf16(s[8 * kk + 2 * e], s[8 * kk + 2 * e + 1]);
}

template <int D, int kMode>
__device__ __forceinline__ void consume(const Params& p, uint8_t* smem, const Walk& w) {
  using L = Smem<D>;
  const Bars bar = bars_of<D>(smem);
  const int cw = threadIdx.x / 128 - 1;  // q rows 64 cw .. 64 cw + 63 of the tile
  const int tid = threadIdx.x % 128, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int h = blockIdx.y, b = blockIdx.z;
  const uint32_t sq_ = smem_u32(smem + L::kQ) + cw * 64 * 128;
  const uint32_t sk = smem_u32(smem + L::kK), sv = smem_u32(smem + L::kV);
  const int my_turn = kBarTurn + cw, next_turn = kBarTurn + 1 - cw;
  // the joint modes carry qscale in q^, so the scores are already in base 2
  const float qscale = kMode == kScaleS ? p.qscale : 1.f;
  auto nvalid = [&](int j) {
    const int2 tile = kv_tile(w, j);
    return p.st[tile.x].kv_len - tile.y;
  };

  if (cw == 1) named_bar_arrive(kBarTurn, kTurnThreads);  // consumer 0 takes the first turn
  float wv[D / 2];
  if constexpr (kMode == kRmsQ) load_q_weights<D>(wv, p.st[w.qs].wq, tid % 2);
  mbar_wait(bar.q_full, 0);
  if constexpr (kMode != kScaleS) {
    transform_q<D, kMode>(smem + L::kQ, cw, tid, wv, p.qscale, p.eps);
    fence_proxy_async();  // the rewritten rows before this warpgroup's wgmma reads
    named_bar_sync(kBarQ + cw, 128);
  }

  // accumulators (rows 16 w + g and + 8 of this consumer's 64; columns 8 n +
  // 2 t, + 1 in [4n .. 4n + 3]): O, the scores S, and P as the bf16 A
  // fragments of O += P V (k16 step kk: [kk][0..3])
  float o[D / 2], s[kBKV / 2];
  uint32_t pa[kBKV / 16][4];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  Rows rows{-INFINITY, -INFINITY, 0.f, 0.f};
  auto kt = [&](int j) { return sk + (j % kStages) * L::kKvBytes; };
  auto vt = [&](int j) { return sv + (j % kStages) * L::kKvBytes; };

  // turn 0: S_0
  mbar_wait(bar.k_full, 0);
  named_bar_sync(my_turn, kTurnThreads);
  wgmma_fence();
  issue_s<D>(s, sq_, kt(0));
  wgmma_commit();
  named_bar_arrive(next_turn, kTurnThreads);
  wgmma_wait<0>();
  fence_regs(s);
  if (tid == 0) mbar_arrive(bar.k_empty);
  rescale_pack<D>(o, pa, s, softmax(s, rows, nvalid(0), t, qscale));

  // turn j: S_j, then O += P_{j-1} V_{j-1}
  for (int j = 1; j < w.n; ++j) {
    const int sj = j % kStages, sp = (j - 1) % kStages;
    mbar_wait(bar.v_full + sp, ((j - 1) / kStages) & 1);
    mbar_wait(bar.k_full + sj, (j / kStages) & 1);
    named_bar_sync(my_turn, kTurnThreads);
    wgmma_fence();
    // S_j first: the softmax of S_j runs while O += P_{j-1} V_{j-1} does
    issue_s<D>(s, sq_, kt(j));
    wgmma_commit();
    issue_pv<D>(o, pa, vt(j - 1));
    wgmma_commit();
    named_bar_arrive(next_turn, kTurnThreads);
    wgmma_wait<1>();
    fence_regs(s);
    if (tid == 0) mbar_arrive(bar.k_empty + sj);
    const float2 a = softmax(s, rows, nvalid(j), t, qscale);
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(pa);
    if (tid == 0) mbar_arrive(bar.v_empty + sp);
    rescale_pack<D>(o, pa, s, a);
  }

  // the last turn: O += P_{n-1} V_{n-1}; consumer 1 ends the alternation
  {
    const int sp = (w.n - 1) % kStages;
    mbar_wait(bar.v_full + sp, ((w.n - 1) / kStages) & 1);
    named_bar_sync(my_turn, kTurnThreads);
    wgmma_fence();
    issue_pv<D>(o, pa, vt(w.n - 1));
    wgmma_commit();
    if (cw == 0) named_bar_arrive(next_turn, kTurnThreads);
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(pa);
  }

  // o = acc / l (a row with l == 0 divides by 1), rows < the stream's length
  const Stream& so = p.st[w.qs];
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    rows.l0 += __shfl_xor_sync(0xffffffffu, rows.l0, off);
    rows.l1 += __shfl_xor_sync(0xffffffffu, rows.l1, off);
  }
  const float div0 = rows.l0 == 0.f ? 1.f : rows.l0, div1 = rows.l1 == 0.f ? 1.f : rows.l1;
  const int r0 = w.q0 + 64 * cw + 16 * (tid / 32) + g, r1 = r0 + 8;
  bf16* const ob = so.o + b * so.o_sb + h * so.o_sh + 2 * t;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    if (r0 < so.sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + r0 * so.o_ss + 8 * n) =
          __floats2bfloat162_rn(o[4 * n] / div0, o[4 * n + 1] / div0);
    if (r1 < so.sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + r1 * so.o_ss + 8 * n) =
          __floats2bfloat162_rn(o[4 * n + 2] / div1, o[4 * n + 3] / div1);
  }
  if (so.lse != nullptr && t == 0) {
    // natural-log lse for the backward: ln(sum e^s) = ln2 * lse2
    float* const lse = so.lse + (static_cast<long long>(b) * p.heads + h) * so.sq;
    if (r0 < so.sq) lse[r0] = (rows.m0 * qscale + log2f(fmaxf(rows.l0, 1e-37f))) * kLn2;
    if (r1 < so.sq) lse[r1] = (rows.m1 * qscale + log2f(fmaxf(rows.l1, 1e-37f))) * kLn2;
  }
}

template <int D, int kMode>
__global__ void __launch_bounds__(kThreads, 1)
    attn_fwd_sm90_kernel(const __grid_constant__ MapsOf<kMode> maps,
                         const __grid_constant__ Params p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* const smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const Walk w = walk_of<kMode>(p);
  if (threadIdx.x == 0) {
    const Bars bar = bars_of<D>(smem);
    mbar_init(bar.q_full, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar.k_full + s, 1);   // the producer's arrival + TMA bytes
      mbar_init(bar.v_full + s, 1);
      mbar_init(bar.k_empty + s, 2);  // one arrival per consumer
      mbar_init(bar.v_empty + s, 2);
    }
    fence_mbar_init();
  }
  __syncthreads();
  if (threadIdx.x < 128) {  // one big branch per role, never reconverging
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) produce<D>(maps, p, smem, w);
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    consume<D, kMode>(p, smem, w);
  }
}

// ── the k side of kRmsQ ──

// both streams' k for rms_k_kernel: (batch, row) element strides, heads D
// columns apart; k^ into scratch, contiguous (B, rows, H*D)
struct RmsK {
  const bf16* k[2];
  bf16* khat[2];
  const float* w[2];  // (D,) fp32
  long long sb[2], ss[2];
  int rows[2];  // the second stream may have none
  int heads, batch;
  float eps;
};

// k^ = bf16(k * 1 / sqrt(mean(k^2) + eps) * w) of every (row, head) of both
// streams: D/8 neighbouring lanes a (row, head), one 16-byte chunk each; the
// row's sum of squares adds the chunks' sums in chunk order, in every lane of
// the row alike (the twin's order). Bound by bytes: k read once, k^ written
// once.
template <int D>
__global__ void __launch_bounds__(256) rms_k_kernel(const __grid_constant__ RmsK p) {
  constexpr int kLanes = D / 8;  // divides 32: a (row, head) never spans two warps
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long rh = t / kLanes;  // (row, head) of the first stream, then of the second
  const int c = static_cast<int>(t % kLanes), first = threadIdx.x % 32 - c;
  const long long n0 = static_cast<long long>(p.batch) * p.rows[0] * p.heads;
  const long long n1 = static_cast<long long>(p.batch) * p.rows[1] * p.heads;
  const int st = rh >= n0;
  const long long i = rh - (st ? n0 : 0);  // (b * rows + r) * heads + h
  const bool live = rh < n0 + n1;
  uint4 x = make_uint4(0u, 0u, 0u, 0u);
  if (live) {
    const long long br = i / p.heads, h = i % p.heads;
    const long long b = br / p.rows[st], r = br % p.rows[st];
    x = *reinterpret_cast<const uint4*>(p.k[st] + b * p.sb[st] + r * p.ss[st] + h * D + 8 * c);
  }
  const float part = sum_sq(x);
  float ss = __shfl_sync(0xffffffffu, part, first);
#pragma unroll
  for (int j = 1; j < kLanes; ++j) ss += __shfl_sync(0xffffffffu, part, first + j);
  if (live) {
    float w8[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) w8[e] = __ldg(p.w[st] + 8 * c + e);
    *reinterpret_cast<uint4*>(p.khat[st] + i * D + 8 * c) =
        scale_chunk(x, rms_scale<D>(ss, p.eps), w8, 1.f);
  }
}

// ── host side ──

// q, k, v as head views per stream (k and v of kv_len rows: the maps end
// there); a stream without rows takes the first stream's maps, never read
template <int D, int kMode>
int launch(const HeadView* q, const HeadView* k, const HeadView* v, const Params& p, int batch,
           cudaStream_t stream) {
  if (encode_tiled() == nullptr) return static_cast<int>(cudaErrorNotSupported);
  constexpr int kStreams = kMode == kScaleS ? 1 : 2;
  const bool bhsd = p.bhsd != 0;
  MapsOf<kMode> m;
  for (int i = 0; i < kStreams; ++i) {
    if (i > 0 && p.st[i].sq == 0) {
      memcpy(&m.q[i], &m.q[0], sizeof(CUtensorMap));
      memcpy(&m.k[i], &m.k[0], sizeof(CUtensorMap));
      memcpy(&m.v[i], &m.v[0], sizeof(CUtensorMap));
      continue;
    }
    if (!bf16_map(&m.q[i], q[i], D, p.heads, batch, bhsd, kBQ) ||
        !bf16_map(&m.k[i], k[i], D, p.heads, batch, bhsd, kBKV) ||
        !bf16_map(&m.v[i], v[i], D, p.heads, batch, bhsd, kBKV))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  constexpr int smem = Smem<D>::kBytes + 1024;  // + the 1024-byte alignment
  static bool opted_in[kMaxDevices] = {};
  const cudaError_t err = opt_in_smem(attn_fwd_sm90_kernel<D, kMode>, smem, opted_in);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int q_tiles = p.q_tiles0 + (kStreams == 2 ? cdiv(p.st[1].sq, kBQ) : 0);
  const dim3 grid(q_tiles, p.heads, batch);
  attn_fwd_sm90_kernel<D, kMode><<<grid, kThreads, smem, stream>>>(m, p);
  return static_cast<int>(cudaGetLastError());
}

// the head width as a template argument; any other width is refused
template <int kMode>
int launch_dim(int head_dim, const HeadView* q, const HeadView* k, const HeadView* v,
               const Params& p, int batch, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64:
      return launch<64, kMode>(q, k, v, p, batch, st);
    case 128:
      return launch<128, kMode>(q, k, v, p, batch, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

Stream make_stream(void* o, void* lse, const long long* o_strides, int sq, int kv_len) {
  Stream s{};
  s.o = static_cast<bf16*>(o);
  s.lse = static_cast<float*>(lse);
  s.o_sb = o_strides[0], s.o_ss = o_strides[1], s.o_sh = o_strides[2];
  s.sq = sq;
  s.kv_len = kv_len;
  return s;
}

Params make_params(int num_heads, bool bhsd, float qscale, float eps) {
  Params p{};
  p.heads = num_heads;
  p.bhsd = bhsd;
  p.qscale = qscale;
  p.eps = eps;
  return p;
}

// One stream of a joint call in the (B, S, H*D) layout: heads head_dim
// columns apart. st: the (batch, row) strides of q, k, v, o.
void joint_stream(Params& p, int i, HeadView* hq, HeadView* hk, HeadView* hv, const void* q,
                  const void* k, const void* v, void* o, void* lse, int len,
                  const long long* st, int head_dim, const void* wq) {
  hq[i] = {q, st[0], st[1], head_dim, len};
  hk[i] = {k, st[2], st[3], head_dim, len};
  hv[i] = {v, st[4], st[5], head_dim, len};
  const long long o_strides[3] = {st[6], st[7], head_dim};
  p.st[i] = make_stream(o, lse, o_strides, len, len);
  p.st[i].wq = static_cast<const float*>(wq);
}

template <int D>
int launch_rms_k(const RmsK& r, cudaStream_t stream) {
  const long long threads = static_cast<long long>(r.batch) * (r.rows[0] + r.rows[1]) *
                            r.heads * (D / 8);
  rms_k_kernel<D><<<static_cast<unsigned>((threads + 255) / 256), 256, 0, stream>>>(r);
  return static_cast<int>(cudaGetLastError());
}

// With RMS weights (wk non-null): k^ of both streams into `khat` first
// (rms_k_kernel), which the K maps then read; then the attention.
int launch_joint(int head_dim, const HeadView* q, HeadView* k, const HeadView* v, Params& p,
                 const void* const* wk, void* const* khat, float eps, int batch,
                 void* stream) {
  p.q_tiles0 = cdiv(p.st[0].sq, kBQ);
  if (wk[0] == nullptr) return launch_dim<kScaleQ>(head_dim, q, k, v, p, batch, stream);
  RmsK r{};
  for (int i = 0; i < 2; ++i) {
    r.k[i] = static_cast<const bf16*>(k[i].ptr);
    r.khat[i] = static_cast<bf16*>(khat[i]);
    r.w[i] = static_cast<const float*>(wk[i]);
    r.sb[i] = k[i].sb, r.ss[i] = k[i].ss;
    r.rows[i] = p.st[i].sq;
    const long long row = static_cast<long long>(p.heads) * head_dim;
    k[i] = {khat[i], row * p.st[i].sq, row, head_dim, p.st[i].sq};
  }
  r.heads = p.heads, r.batch = batch, r.eps = eps;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int err = head_dim == 64    ? launch_rms_k<64>(r, st)
                  : head_dim == 128 ? launch_rms_k<128>(r, st)
                                    : static_cast<int>(cudaErrorInvalidValue);
  if (err != 0) return err;
  return launch_dim<kRmsQ>(head_dim, q, k, v, p, batch, stream);
}

}  // namespace

// Bidirectional multi-head attention read in place through strides (the
// BSHD layout of Flux's single blocks and WAN; any other layout with a
// head's D = head_dim (64 or 128) columns contiguous). q, o: bf16 with `sq`
// rows; k, v: bf16 with at least `kv_len` rows (1 <= kv_len), the keys
// attended to: rows at or past kv_len are never read. strides: 12 host
// int64s, the (batch, row, head) element strides of q, k, v, o, each a
// multiple of 8 (the head stride of q, k, v at most their row stride), every
// base 16-byte aligned. lse: contiguous fp32 (B, H, sq), or null. qscale =
// sm_scale * log2(e). Returns cudaGetLastError() (cudaErrorInvalidValue for
// another head_dim or a tensor TMA cannot map).
extern "C" int mha_bshd_fwd_bf16(const void* q, const void* k, const void* v, void* o,
                                 void* lse, int sq, int kv_len, const long long* strides,
                                 int batch, int num_heads, int head_dim, float qscale,
                                 void* stream) {
  const HeadView hq{q, strides[0], strides[1], strides[2], sq};
  const HeadView hk{k, strides[3], strides[4], strides[5], kv_len};
  const HeadView hv{v, strides[6], strides[7], strides[8], kv_len};
  Params p = make_params(num_heads, false, qscale, 0.f);
  p.st[0] = make_stream(o, lse, strides + 9, sq, kv_len);
  p.q_tiles0 = cdiv(sq, kBQ);
  return launch_dim<kScaleS>(head_dim, &hq, &hk, &hv, p, batch, stream);
}

// Bidirectional multi-head attention on contiguous (B, H, S, D) tensors: the
// TPU's `_fwd_kernel`. q, o: bf16 (B, H, sq, D); k, v: bf16 (B, H, skv, D);
// D = head_dim (64 or 128). Keys at rows >= kv_len (1 <= kv_len <= skv) are
// masked. lse: contiguous fp32 (B, H, sq), or null. qscale = sm_scale *
// log2(e). Returns cudaGetLastError().
extern "C" int mha_fwd_bf16(const void* q, const void* k, const void* v, void* o, void* lse,
                            int sq, int skv, int kv_len, int batch, int num_heads, int head_dim,
                            float qscale, void* stream) {
  const long long d = head_dim, hq = static_cast<long long>(sq) * d;
  const long long hkv = static_cast<long long>(skv) * d;
  const long long q_side[3] = {num_heads * hq, d, hq};
  const HeadView vq{q, q_side[0], q_side[1], q_side[2], sq};
  const HeadView vk{k, num_heads * hkv, d, hkv, kv_len};
  const HeadView vv{v, num_heads * hkv, d, hkv, kv_len};
  Params p = make_params(num_heads, true, qscale, 0.f);
  p.st[0] = make_stream(o, lse, q_side, sq, kv_len);
  p.q_tiles0 = cdiv(sq, kBQ);
  return launch_dim<kScaleS>(head_dim, &vq, &vk, &vv, p, batch, stream);
}

// Joint image+text attention with the optional fused per-head qk-RMS (the
// TPU's `_joint_fwd_kernel`): each stream's queries attend to the keys of
// both. q/k/v/o of each stream: bf16 (B, S, H*D), D = head_dim (64 or 128),
// unit stride along the last dim, every base 16-byte aligned. s_img >= 1;
// s_txt may be 0. strides: 16 host int64s, the (batch, row) strides of q, k,
// v, o of the image stream and then of the text stream, each a multiple of 8.
// lse_img / lse_txt: contiguous fp32 (B, H, S) outputs of the natural-log
// log-sum-exp per row, or null. The four RMS weights are fp32 (D,) device
// pointers, all null for no qk-norm; with them khat_img / khat_txt are bf16
// scratch of k's shape, contiguous, for k^ (else null). qscale = sm_scale *
// log2(e), applied to q. Launches rms_k_kernel (with the weights), then the
// attention. Returns cudaGetLastError() (cudaErrorInvalidValue for another
// head_dim or a tensor TMA cannot map).
extern "C" int joint_attention_fwd_bf16(const void* q_img, const void* k_img,
                                        const void* v_img, void* o_img, void* lse_img,
                                        int s_img, const void* q_txt, const void* k_txt,
                                        const void* v_txt, void* o_txt, void* lse_txt,
                                        int s_txt, const long long* strides,
                                        const void* wq_img, const void* wk_img,
                                        const void* wq_txt, const void* wk_txt, void* khat_img,
                                        void* khat_txt, int batch, int num_heads, int head_dim,
                                        float qscale, float eps, void* stream) {
  HeadView hq[2], hk[2], hv[2];
  Params p = make_params(num_heads, false, qscale, eps);
  joint_stream(p, 0, hq, hk, hv, q_img, k_img, v_img, o_img, lse_img, s_img, strides, head_dim,
               wq_img);
  joint_stream(p, 1, hq, hk, hv, q_txt, k_txt, v_txt, o_txt, lse_txt, s_txt, strides + 8,
               head_dim, wq_txt);
  const void* const wk[2] = {wk_img, wk_txt};
  void* const khat[2] = {khat_img, khat_txt};
  return launch_joint(head_dim, hq, hk, hv, p, wk, khat, eps, batch, stream);
}

// Single-stream attention with the optional fused qk-RMS (the TPU's
// `_single_fwd_kernel`; SD3.5's dual self-attention): the joint kernel with
// no second stream. strides: 8 host int64s for q, k, v, o; khat: bf16
// scratch of k's shape, contiguous, with the weights (else null).
extern "C" int mha_rms_fwd_bf16(const void* q, const void* k, const void* v, void* o,
                                void* lse, int s, const long long* strides, const void* wq,
                                const void* wk, void* khat, int batch, int num_heads,
                                int head_dim, float qscale, float eps, void* stream) {
  HeadView hq[2], hk[2], hv[2];
  Params p = make_params(num_heads, false, qscale, eps);
  joint_stream(p, 0, hq, hk, hv, q, k, v, o, lse, s, strides, head_dim, wq);
  p.st[1] = Stream{};
  hk[1] = hk[0];
  const void* const wk2[2] = {wk, wk};
  void* const khat2[2] = {khat, khat};
  return launch_joint(head_dim, hq, hk, hv, p, wk2, khat2, eps, batch, stream);
}
