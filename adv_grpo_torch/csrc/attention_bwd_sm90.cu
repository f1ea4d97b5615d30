// Backward of softmax attention for Hopper (sm_90a): one warp-specialised
// wgmma + TMA kernel (FlashAttention-3's backward shape),
// `attn_bwd_sm90_kernel<D, kMode>` at head widths D = 64 and 128, behind four
// entry points:
//   * `mha_bshd_bwd_bf16` (#9, kBf16P): q and k/v of their own lengths in any
//     (batch, row, head) strides (Flux's single blocks and WAN read the fused
//     projections in place), a `kv_len` key mask; p and t = p (dp - di)
//     rounded to bf16 for their products;
//   * `mha_bwd_bf16` (#11, kF32P): the same on contiguous (B, H, S, D)
//     tensors with p and t kept to ~16 significant bits by a hi/lo bf16
//     split, the backward of the TPU's `mha`;
//   * `joint_attention_bwd_bf16` (#4, kJoint): two token streams (image,
//     text) in the (B, S, H*D) layout, each stream's queries against the keys
//     of both, the qk-RMS optional (SD3.5-M at D = 64 with it, Flux.1-dev at
//     D = 128 without);
//   * `mha_rms_bwd_bf16` (#5, kJoint): the same with one stream (SD3.5's dual
//     self-attention, D = 64).
//
// Replaces: adv_grpo_tpu/ops/attention.py `_bshd_bwd_dkv_kernel` +
// `_bshd_bwd_dq_kernel` (through `_bshd_bwd`) and `_bshd_bwd_fused_kernel`
// (through `_bshd_bwd_fused`), and `_bwd_dkv_kernel` + `_bwd_dq_kernel`
// (through `_flash_bwd`, the VJP of `mha`); adv_grpo_tpu/ops/joint_attention.py
// `_joint_bwd_kernel` (through `_joint_bwd_fused`) and `_single_bwd_kernel`
// (through `_single_bwd_fused`). A backward of SD3.5-M with respect to its
// LoRA runs the last two 24 and 12 times; one of Flux.1-dev the joint one 19
// times.
//
// Contract: from q, k, v, the output cotangent do, the forward's per-row lse
// (natural log) and di = sum_d o * do, fp32 (B, H, S_q) each: p = exp(s -
// lse) with s = q k^T * sm_scale (keys at or past kv_len get p = 0); dv =
// p^T do; dp = do v^T; t = p (dp - di); dk = sm_scale * (t^T q); dq =
// sm_scale * (t k). Numerics, per mode:
//  * kBf16P, kF32P: s is the fp32 product of the bf16 q and k as stored,
//    scaled in fp32 (one FFMA with the base-2 lse in the exponent); dk and dq
//    are scaled by sm_scale once, in fp32, at the end — the order of the
//    TPU's split bodies. kBf16P rounds p and t to bf16 (one wgmma each; the
//    TPU keeps them fp32); kF32P runs each product with p or t twice, on
//    bf16(x) and on bf16(x - bf16(x));
//  * kJoint (the TPU's fused joint bodies): a pre-pass forms, once per call,
//    q^ = bf16(yq * sm_scale * log2 e), q_s = bf16(yq * sm_scale) and, with
//    RMS weights, k^ = bf16(yk), where yq = rms(q) * wq and yk = rms(k) * wk
//    in fp32 (q and k as stored without weights); q^ and k^ are the
//    forward's (attention_fwd_sm90.cu) bit for bit, from the same code
//    (sm90.cuh: the sum of squares in the forward's order per tensor, a
//    correctly rounded 1 / sqrt), so p = exp2(q^ k^T - lse * log2 e) is the
//    p whose row sums the forward's lse took. Then dv = bf16(p)^T do, t =
//    bf16(p (dp - di)), dyk = t^T q_s (not scaled again), dyq = sm_scale *
//    (t k^); the cotangents of the NORMALISED q and k (the caller applies the
//    closed-form RMS backward; without RMS they are dq and dk).
//
// Bound on this card: tensor-core math. Per (batch item, head) the backward
// is 5 products of S_q x S_kv x D (s, dp, dv, dk, dq), 8 with the hi/lo
// split; at WAN's 8,100 tokens x 12 heads of 128 that is 1 TFLOP against
// ~10 MB of operands, and at SD3.5-M's 1,024 + 154 tokens x 24 heads of 64
// 21 GFLOP per batch item against ~3 MB: far above the ~295 flop/byte ridge.
// The pre-pass moves bytes only (q, k read once; q^, q_s, k^ written once).
//
// Design:
//  * one CTA of 3 warpgroups per (kv tile of 128 rows, head, batch item); in
//    kJoint the grid's x runs over the image stream's kv tiles and then the
//    text's, and each CTA walks the 64-row q tiles of the image stream and
//    then of the text stream. WG0, after setmaxnreg.dec, is the producer:
//    one warp TMA-loads the CTA's K and V tiles once, then streams the q-side
//    tiles (q and do; q^, q_s and do in kJoint) through a 2-stage ring
//    guarded by full / empty mbarriers, with the tiles' lse (base 2) and di,
//    which it loads itself (a q row past its stream's length gets lse = +inf,
//    so p = 0, and di = 0). WG1 and WG2, after setmaxnreg.inc, each own 64 kv
//    rows and keep their dk and dv accumulators (fp32, 2 x D/2 registers a
//    thread) for the whole walk;
//  * per q tile, each consumer: S^T = K Q^T (SS wgmma), P^T = exp2(S^T qscale
//    - lse2) in registers (exp2(S^T - lse2) in kJoint: q^ carries it), dV += P^T
//    dO (RS wgmma: A = bf16 P^T from registers, B = dO MN-major), dP^T = V
//    dO^T (SS), dS^T = P^T (dP^T - di), dK += dS^T Q (RS; Q_s in kJoint), and
//    bf16 dS^T into a shared [kv row][q] tile. dV runs beside the dS^T math,
//    except in kJoint at D = 128: there it is waited for first, since P^T's
//    fragments in flight beside the separate q_s operand spilled 76 bytes;
//  * dQ^T = K^T dS^T from shared memory (SS, both operands MN-major): at D =
//    128 each consumer computes 64 of the 128 head columns over all 128 kv
//    rows of the tile; at D = 64 each sums over its own 64 kv rows. The 64 x
//    64 fp32 result is staged in shared memory and reduce-added into an fp32
//    (B, H, S_q, D) scratch by a TMA reduce (cp.reduce.async.bulk.tensor);
//    in kJoint the scratch holds both streams' rows, the text stream's after
//    the image stream's (a tile's rows past the image stream add exact zeros:
//    their p is 0). The reduce-adds of the CTAs walking one head hit the
//    same rows at about the same time, so they stay in L2. A second small
//    kernel writes dq = bf16(sm_scale * scratch) through the caller's strides
//    (per stream in kJoint). The scratch is zero on entry (the kJoint
//    pre-pass zeroes it); the order of the fp32 adds changes from run to
//    run, so dq is not bitwise reproducible (the tests hold tolerances). A
//    kJoint call is 3 launches: pre-pass, backward, dq convert;
//  * the qk-RMS runs in the pre-pass, not per tile: the forward normalising
//    each K tile inside its kernel read 2.7x slower on an H100 (see
//    attention_fwd_sm90.cu), and the backward would redo each q tile for
//    every kv tile;
//  * all operand tiles arrive by TMA with the 128-byte swizzle (boxes of 64
//    columns x 64 rows, two per row at D = 128), which the wgmma descriptors
//    read directly: nothing is rescaled or copied on the way. Each stream's
//    maps end at its length, so rows past it read as zeros; keys in [kv_len,
//    S_kv) are real memory and get p = 0 and dS = 0 in-kernel, so their dk
//    and dv rows are stored as zeros, and a kv tile wholly past kv_len walks
//    nothing and stores zeros; dk and dv rows past a stream's length are
//    never stored;
//  * shared memory at D = 128: K and V 64 KB, the ring 64 KB (96 KB in
//    kJoint: three tiles a stage), dS^T 16 KB (32 with the hi/lo split), dq
//    staging 32 KB: one CTA per SM.

#include <cuda_bf16.h>
#include <math.h>
#include <string.h>

#include "sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace sm90;

constexpr int kBQ = 64;     // q rows per ring stage
constexpr int kBKV = 128;   // kv rows per CTA, 64 per consumer warpgroup
constexpr int kStages = 2;  // q-side ring depth
constexpr int kThreads = 384;
constexpr int kProducerRegs = 24, kConsumerRegs = 240;
constexpr float kLog2e = 1.4426950408889634f;

// the modes (see the contract above)
constexpr int kBf16P = 0;  // #9
constexpr int kF32P = 1;   // #11
constexpr int kJoint = 2;  // #4, #5

// shared-memory layout, byte offsets (every tile 1024-byte aligned). A bf16
// tile of R rows and D columns is D/64 column blocks of R rows x 128 bytes.
template <int D, int kMode>
struct Smem {
  static constexpr int kKvBytes = kBKV * D * 2;
  static constexpr int kQBytes = kBQ * D * 2;
  static constexpr int kDsBytes = kBKV * kBQ * 2;
  static constexpr int kStageBytes = kBQ * 64 * 4;  // one consumer's fp32 dq tile
  static constexpr int kRing = kMode == kJoint ? 3 : 2;  // q (q^), [q_s,] do a stage
  static constexpr int kK = 0;
  static constexpr int kV = kK + kKvBytes;
  static constexpr int kQ = kV + kKvBytes;
  static constexpr int kQs = kQ + kStages * kQBytes;  // kJoint only
  static constexpr int kDo = kQs + (kRing - 2) * kStages * kQBytes;
  static constexpr int kDs = kDo + kStages * kQBytes;
  static constexpr int kStage = kDs + (kMode == kF32P ? 2 : 1) * kDsBytes;
  static constexpr int kStats = kStage + 2 * kStageBytes;
  static constexpr int kBars = kStats + kStages * 2 * kBQ * 4;
  static constexpr int kBytes = kBars + 8 * (1 + 2 * kStages);
};

struct Side {  // one token stream: its q rows' statistics, its kv rows' outputs
  const float* lse;  // (B, H, sq) fp32, natural log
  const float* di;   // (B, H, sq) fp32
  bf16* dk;
  bf16* dv;
  long long dk_sb, dk_ss, dk_sh, dv_sb, dv_ss, dv_sh;  // element strides
  int sq, skv, kv_len;
  int q_row0;  // the stream's first row in the dq scratch
};

struct Params {
  Side st[2];  // the second only in kJoint (no rows for mha_rms_bwd)
  // q_splits > 1 (not kJoint): the CTAs of one kv tile each walk a share of
  // the q tiles and reduce-add dk (before its sm_scale) and dv into this
  // fp32 (2, B, H, S_kv, D) scratch, zero on entry
  float* dkv_acc;
  int q_splits;
  int heads;
  int bhsd;       // the bf16 maps are (D, S, H, B) rather than (D, H, S, B)
  int kv_tiles0;  // the first stream's kv tiles: the grid's x runs over them first
  float qscale;  // multiplies the fp32 scores: sm_scale * log2 e (not kJoint)
  float sm_scale;
};

// the TMA maps of q (q^ in kJoint), q_s (kJoint only), k, v, do of each of N
// streams, and of the fp32 dq scratch
template <int N>
struct Maps {
  CUtensorMap q[N], qs[N], k[N], v[N], dout[N];
  CUtensorMap dq;
};

template <int kMode>
using MapsOf = Maps<kMode == kJoint ? 2 : 1>;

// The CTA's kv tile (its stream ks and first row kv0 there) and its share
// j0 .. j1 of the walk over the q tiles of the first stream (nq0 of them)
// and then of the second
struct Walk {
  int ks, kv0, j0, j1, nq0;
};

template <int kMode>
__device__ __forceinline__ Walk walk_of(const Params& p) {
  const int x = static_cast<int>(blockIdx.x) / p.q_splits;
  const int ks = kMode == kJoint && x >= p.kv_tiles0;
  const int kv0 = (x - (ks ? p.kv_tiles0 : 0)) * kBKV;
  const int nq0 = cdiv(p.st[0].sq, kBQ);
  const int n_q = nq0 + (kMode == kJoint ? cdiv(p.st[1].sq, kBQ) : 0);
  const int per = cdiv(n_q, p.q_splits);
  const bool live = kv0 < p.st[ks].kv_len;  // a kv tile wholly past kv_len walks nothing
  const int j0 = live ? min(n_q, static_cast<int>(blockIdx.x) % p.q_splits * per) : 0;
  const int j1 = live ? min(n_q, j0 + per) : 0;
  return {ks, kv0, j0, j1, nq0};
}

// q tile j of the walk: its stream, and its first row in that stream
__device__ __forceinline__ int2 q_tile(const Walk& w, int j) {
  return j < w.nq0 ? make_int2(0, j * kBQ) : make_int2(1, (j - w.nq0) * kBQ);
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// A 64 x 64 fp32 wgmma accumulator (rows 16 w + g, +8; columns 8 n + 2 t, +1
// in d[4n .. 4n+3]) as the bf16 A fragments of a product that contracts over
// its columns: the high half bf16(x), or with kLo the low half bf16(x -
// bf16(x)).
template <bool kLo>
__device__ __forceinline__ void acc_to_frags(uint32_t (&a)[4][4], const float (&d)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float x0 = d[8 * kk + 2 * r], x1 = d[8 * kk + 2 * r + 1];
      a[kk][r] = kLo ? pack_bf16(x0 - bf16_round(x0), x1 - bf16_round(x1)) : pack_bf16(x0, x1);
    }
}

// A fragments of dS^T (this consumer's kv rows m0, m0 + 8 within its 64, q
// columns 16 kk + 2t (+8)) into the [kv row][64 q] bf16 tile, 128-byte
// swizzled: the dq product's B operand, MN-major.
__device__ __forceinline__ void store_ds(uint8_t* tile, const uint32_t (&a)[4][4], int row0,
                                         int g, int t) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = row0 + (r & 1) * 8, chunk = 2 * kk + (r >> 1);
      *reinterpret_cast<uint32_t*>(tile + row * 128 + ((chunk ^ g) << 4) + 4 * t) = a[kk][r];
    }
}

template <int D, int kMode, int N>
__device__ __forceinline__ void produce(const Maps<N>& m, const Params& p, uint8_t* smem,
                                        const Walk& w) {
  using L = Smem<D, kMode>;
  const int lane = threadIdx.x, h = blockIdx.y, b = blockIdx.z;
  uint64_t* const kv_full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* const full = kv_full + 1;
  uint64_t* const empty = full + kStages;
  if (w.j0 == w.j1) return;  // a kv tile wholly past kv_len loads nothing
  if (lane == 0) {
    mbar_arrive_expect_tx(kv_full, 2 * L::kKvBytes);
    for (int r = 0; r < kBKV / 64; ++r) {
      const int row = w.kv0 + 64 * r;
      const int c1 = p.bhsd ? row : h, c2 = p.bhsd ? h : row;
      for (int c = 0; c < D / 64; ++c) {
        const int off = c * kBKV * 128 + r * 64 * 128;
        tma_load_4d(smem + L::kK + off, &m.k[w.ks], kv_full, 64 * c, c1, c2, b);
        tma_load_4d(smem + L::kV + off, &m.v[w.ks], kv_full, 64 * c, c1, c2, b);
      }
    }
  }
  for (int j = w.j0; j < w.j1; ++j) {
    const int s = (j - w.j0) % kStages;
    const int2 t = q_tile(w, j);
    const Side& sd = p.st[t.x];
    mbar_wait(empty + s, (((j - w.j0) / kStages) & 1) ^ 1);
    float* const st = reinterpret_cast<float*>(smem + L::kStats) + s * 2 * kBQ;
    const long long stat0 = (static_cast<long long>(b) * p.heads + h) * sd.sq;
    for (int i = lane; i < kBQ; i += 32) {
      const int r = t.y + i;
      st[i] = r < sd.sq ? sd.lse[stat0 + r] * kLog2e : INFINITY;
      st[kBQ + i] = r < sd.sq ? sd.di[stat0 + r] : 0.f;
    }
    if (lane == 0) {
      mbar_arrive_expect_tx(full + s, L::kRing * L::kQBytes);
      const int c1 = p.bhsd ? t.y : h, c2 = p.bhsd ? h : t.y;
      for (int c = 0; c < D / 64; ++c) {
        const int off = s * L::kQBytes + c * kBQ * 128;
        tma_load_4d(smem + L::kQ + off, &m.q[t.x], full + s, 64 * c, c1, c2, b);
        if constexpr (kMode == kJoint)
          tma_load_4d(smem + L::kQs + off, &m.qs[t.x], full + s, 64 * c, c1, c2, b);
        tma_load_4d(smem + L::kDo + off, &m.dout[t.x], full + s, 64 * c, c1, c2, b);
      }
    } else {
      mbar_arrive(full + s);  // this lane's stats are written
    }
  }
}

template <int D, int kMode, int N>
__device__ __forceinline__ void consume(const Maps<N>& m, const Params& p, uint8_t* smem,
                                        const Walk& w) {
  using L = Smem<D, kMode>;
  constexpr bool kHiLo = kMode == kF32P;
  uint64_t* const kv_full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* const full = kv_full + 1;
  uint64_t* const empty = full + kStages;
  const int cw = threadIdx.x / 128 - 1;  // kv rows 64 cw .. 64 cw + 63 of the tile
  const int tid = threadIdx.x % 128, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int m0 = 16 * (tid / 32) + g;  // accumulator rows m0 and m0 + 8
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvr = w.kv0 + 64 * cw + m0;  // this thread's kv rows kvr, kvr + 8
  const int kv_len = p.st[w.ks].kv_len;
  const bool live0 = kvr < kv_len, live1 = kvr + 8 < kv_len;
  const uint32_t sk = smem_u32(smem + L::kK), sv = smem_u32(smem + L::kV);
  const uint32_t sds = smem_u32(smem + L::kDs);
  uint8_t* const stage_buf = smem + L::kStage + cw * L::kStageBytes;
  // D = 128: the consumers share the dS^T tile (each reads the other's rows
  // for its half of dq's columns); D = 64: each works alone
  constexpr int kBarThreads = D == 128 ? 256 : 128;
  const int bar_ds = D == 128 ? 1 : 1 + cw, bar_stage = D == 128 ? 3 : 3 + cw;
  // dQ^T's operands: K^T (columns 64 cw.. of the head at D = 128) and dS^T
  // rows (all 128 at D = 128, this consumer's 64 at D = 64)
  constexpr int kDqSteps = D == 128 ? kBKV / 16 : 64 / 16;
  const uint32_t dq_a = sk + (D == 128 ? cw * kBKV * 128 : cw * 64 * 128);
  const uint32_t dq_b = sds + (D == 128 ? 0 : cw * 64 * 128);
  const int dq_col = D == 128 ? 64 * cw : 0;

  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
  if (w.j1 > w.j0) mbar_wait(kv_full, 0);

  for (int j = w.j0; j < w.j1; ++j) {
    const int s = (j - w.j0) % kStages;
    mbar_wait(full + s, ((j - w.j0) / kStages) & 1);
    const uint32_t sq_ = smem_u32(smem + L::kQ + s * L::kQBytes);
    // the dK operand: q itself, or q_s in kJoint
    const uint32_t sqk = sq_ + (L::kQs - L::kQ) * (kMode == kJoint);
    const uint32_t sdo = smem_u32(smem + L::kDo + s * L::kQBytes);
    const float* const st = reinterpret_cast<const float*>(smem + L::kStats) + s * 2 * kBQ;

    // S^T = K Q^T and dP^T = V dO^T: 64 kv x 64 q each, K-major operands
    float sacc[32], dpacc[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t a = (kk / 4) * kBKV * 128 + cw * 64 * 128 + (kk % 4) * 32;
      const uint32_t bq = (kk / 4) * kBQ * 128 + (kk % 4) * 32;
      wgmma_m64n64_ss<0, 0>(sacc, desc_sw128(sk + a, 16, 1024), desc_sw128(sq_ + bq, 16, 1024),
                            kk > 0);
    }
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t a = (kk / 4) * kBKV * 128 + cw * 64 * 128 + (kk % 4) * 32;
      const uint32_t bq = (kk / 4) * kBQ * 128 + (kk % 4) * 32;
      wgmma_m64n64_ss<0, 0>(dpacc, desc_sw128(sv + a, 16, 1024),
                            desc_sw128(sdo + bq, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<1>();  // S^T is in
    fence_regs(sacc);

    // P^T = exp2(S^T qscale - lse2), S^T - lse2 in kJoint (q^ carries
    // qscale); masked keys and q rows past their stream give 0
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float lse2 = st[8 * n + 2 * t + (e & 1)];
        const float x = sacc[4 * n + e];
        sacc[4 * n + e] = (e < 2 ? live0 : live1)
                              ? exp2f(kMode == kJoint ? x - lse2 : fmaf(x, p.qscale, -lse2))
                              : 0.f;
      }
    // dV += P^T dO: B = dO (q x D), MN-major, column blocks 64 rows apart.
    // The hi/lo split runs its two halves one after the other through the
    // same 16 fragment registers, so that they fit beside dS^T's
    uint32_t pa[4][4];
    acc_to_frags<false>(pa, sacc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<D, 1>(dv, pa[kk], desc_sw128(sdo + kk * 2048, kBQ * 128, 1024), 1);
    wgmma_commit();
    if constexpr (kHiLo) {
      wgmma_wait<0>();  // dP^T and the high half of dV are done
      fence_regs(pa);
      fence_regs(dpacc);
      acc_to_frags<true>(pa, sacc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs<D, 1>(dv, pa[kk], desc_sw128(sdo + kk * 2048, kBQ * 128, 1024), 1);
      wgmma_commit();
    } else if constexpr (kMode == kJoint && D == 128) {
      // dV done too: P^T's fragments are free during dS^T (with dV still in
      // flight, the fragments beside the separate q_s tile's operands spill)
      wgmma_wait<0>();
      fence_regs(pa);
      fence_regs(dpacc);
    } else {
      wgmma_wait<1>();  // dP^T is in (dV may still run)
      fence_regs(dpacc);
    }

    // dS^T = P^T (dP^T - di), exactly 0 at masked keys
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float di = st[kBQ + 8 * n + 2 * t + (e & 1)];
        dpacc[4 * n + e] =
            (e < 2 ? live0 : live1) ? sacc[4 * n + e] * (dpacc[4 * n + e] - di) : 0.f;
      }

    // dK += dS^T Q (Q_s in kJoint): B (q x D), MN-major; bf16 dS^T (and its
    // low half) to shared memory for dQ
    uint32_t da[4][4], dl[4][4];
    acc_to_frags<false>(da, dpacc);
    store_ds(smem + L::kDs, da, 64 * cw + m0, g, t);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<D, 1>(dk, da[kk], desc_sw128(sqk + kk * 2048, kBQ * 128, 1024), 1);
    wgmma_commit();
    if constexpr (kHiLo) {
      acc_to_frags<true>(dl, dpacc);
      store_ds(smem + L::kDs + L::kDsBytes, dl, 64 * cw + m0, g, t);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs<D, 1>(dk, dl[kk], desc_sw128(sqk + kk * 2048, kBQ * 128, 1024), 1);
      wgmma_commit();
    }
    wgmma_wait<kHiLo ? 2 : 1>();  // dV is done: P^T's fragments are free
    fence_regs(pa);

    // dS^T is in shared memory, and the staging tile's last reduce has read it
    if (tid == 0) bulk_wait_read<0>();
    fence_proxy_async();
    named_bar_sync(bar_ds, kBarThreads);

    // dQ^T = K^T dS^T: 64 head columns x 64 q, both operands MN-major
    float dqacc[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kDqSteps; ++kk)
      wgmma_m64n64_ss<1, 1>(dqacc, desc_sw128(dq_a + kk * 2048, kBKV * 128, 1024),
                            desc_sw128(dq_b + kk * 2048, kBQ * 128, 1024), kk > 0);
    if constexpr (kHiLo) {
#pragma unroll
      for (int kk = 0; kk < kDqSteps; ++kk)
        wgmma_m64n64_ss<1, 1>(dqacc, desc_sw128(dq_a + kk * 2048, kBKV * 128, 1024),
                              desc_sw128(dq_b + L::kDsBytes + kk * 2048, kBQ * 128, 1024), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dqacc);
    fence_regs(dk);
    fence_regs(dv);
    fence_regs(da);
    if constexpr (kHiLo) fence_regs(dl);
    if (tid == 0) mbar_arrive(empty + s);  // the q-side tiles and stats of this stage are used up

    // stage dQ^T as fp32 [q][64 head columns] and reduce-add it into the scratch
    float* const stg = reinterpret_cast<float*>(stage_buf);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        stg[(8 * n + 2 * t + (e & 1)) * 64 + m0 + (e >> 1) * 8] = dqacc[4 * n + e];
    fence_proxy_async();
    named_bar_sync(bar_stage, kBarThreads);  // D = 128: both consumers are past dS^T too
    if (tid == 0) {
      const int2 qt = q_tile(w, j);
      tma_reduce_add_3d(&m.dq, stage_buf, dq_col, p.st[qt.x].q_row0 + qt.y, b * p.heads + h);
      bulk_commit();
    }
  }
  if (tid == 0) bulk_wait<0>();

  const Side& kvs = p.st[w.ks];
  if (p.q_splits > 1) {  // a share of the q walk: add it to the scratch
    if (w.j1 == w.j0) return;
    const long long plane = static_cast<long long>(gridDim.z) * p.heads * kvs.skv * D;
    float* const dka =
        p.dkv_acc + (static_cast<long long>(b) * p.heads + h) * kvs.skv * D + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const long long row = kvr + 8 * r;
        if (row < kvs.skv) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            atomicAdd(dka + row * D + 8 * n + e, dk[4 * n + 2 * r + e]);
            atomicAdd(dka + plane + row * D + 8 * n + e, dv[4 * n + 2 * r + e]);
          }
        }
      }
    return;
  }
  // dk = sm_scale * (dS^T Q) (dS^T Q_s in kJoint, which carries sm_scale)
  // and dv, rows < the stream's S_kv (zeros at masked keys)
  bf16* const dkb = kvs.dk + b * kvs.dk_sb + h * kvs.dk_sh + 2 * t;
  bf16* const dvb = kvs.dv + b * kvs.dv_sb + h * kvs.dv_sh + 2 * t;
  const float dk_scale = kMode == kJoint ? 1.f : p.sm_scale;
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const long long row = kvr + 8 * r;
      if (row < kvs.skv) {
        *reinterpret_cast<__nv_bfloat162*>(dkb + row * kvs.dk_ss + 8 * n) = __floats2bfloat162_rn(
            dk[4 * n + 2 * r] * dk_scale, dk[4 * n + 2 * r + 1] * dk_scale);
        *reinterpret_cast<__nv_bfloat162*>(dvb + row * kvs.dv_ss + 8 * n) =
            __floats2bfloat162_rn(dv[4 * n + 2 * r], dv[4 * n + 2 * r + 1]);
      }
    }
}

template <int D, int kMode>
__global__ void __launch_bounds__(kThreads, 1)
    attn_bwd_sm90_kernel(const __grid_constant__ MapsOf<kMode> maps,
                         const __grid_constant__ Params p) {
  using L = Smem<D, kMode>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* const smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const Walk w = walk_of<kMode>(p);
  if (threadIdx.x == 0) {
    uint64_t* const bars = reinterpret_cast<uint64_t*>(smem + L::kBars);
    mbar_init(bars, 1);  // K and V in
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bars + 1 + s, 32);           // full: the producer warp's arrivals + TMA bytes
      mbar_init(bars + 1 + kStages + s, 2);  // empty: one arrival per consumer
    }
    fence_mbar_init();
  }
  __syncthreads();
  if (threadIdx.x < 128) {  // one big branch per role, never reconverging
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x < 32) produce<D, kMode>(maps, p, smem, w);
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    consume<D, kMode>(maps, p, smem, w);
  }
}

// ── the kJoint pre-pass ──

// both streams' q and k (each (batch, row) element strides, heads D columns
// apart) and where their operands go: contiguous (B, rows, H*D) bf16 each
struct Prepass {
  const bf16* q[2];
  const bf16* k[2];
  bf16* qhat[2];
  bf16* qs[2];
  bf16* khat[2];       // null without RMS weights
  const float* wq[2];  // (D,) fp32, null without RMS
  const float* wk[2];
  long long q_sb[2], q_ss[2], k_sb[2], k_ss[2];
  int rows[2];  // the second stream may have none
  int heads, batch;
  float qscale, sm_scale, eps;
  float4* zero;  // the dq scratch, zeroed here
  long long n_zero;
};

// Per (row, head) of both streams: q^ = bf16(yq * qscale), q_s = bf16(yq *
// sm_scale) and, with RMS weights, k^ = bf16(yk), from the forward's code
// (sm90.cuh) in the forward's sum orders: q's chunks c % 8 < 4 and the others
// summed apart (the forward's two threads a row) and then added, k's in chunk
// order (rms_k_kernel); so q^ and k^ are the forward's bit for bit. D/8
// neighbouring lanes a (row, head), one 16-byte chunk each. Also zeroes the
// dq scratch. Bound by bytes: q (and k) read once, the operands written once.
template <int D>
__global__ void __launch_bounds__(256) attn_bwd_prepass_kernel(const __grid_constant__ Prepass p) {
  constexpr int kLanes = D / 8;  // divides 32: a (row, head) never spans two warps
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  for (long long i = t; i < p.n_zero; i += static_cast<long long>(gridDim.x) * blockDim.x)
    p.zero[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  const long long rh = t / kLanes;  // (row, head) of the first stream, then of the second
  const int c = static_cast<int>(t % kLanes), first = threadIdx.x % 32 - c;
  const long long n0 = static_cast<long long>(p.batch) * p.rows[0] * p.heads;
  const long long n1 = static_cast<long long>(p.batch) * p.rows[1] * p.heads;
  const int st = rh >= n0;
  const long long i = rh - (st ? n0 : 0);  // (b * rows + r) * heads + h
  const bool live = rh < n0 + n1;
  const bool rms = p.wq[0] != nullptr;
  uint4 xq = make_uint4(0u, 0u, 0u, 0u), xk = xq;
  if (live) {
    const long long br = i / p.heads, h = i % p.heads;
    const long long b = br / p.rows[st], r = br % p.rows[st];
    xq = *reinterpret_cast<const uint4*>(p.q[st] + b * p.q_sb[st] + r * p.q_ss[st] + h * D +
                                         8 * c);
    if (rms)
      xk = *reinterpret_cast<const uint4*>(p.k[st] + b * p.k_sb[st] + r * p.k_ss[st] + h * D +
                                           8 * c);
  }
  float rq = 1.f, rk = 1.f;
  if (rms) {  // the same for every thread of the grid
    const float part_q = sum_sq(xq), part_k = sum_sq(xk);
    float lo = 0.f, hi = 0.f, ss = 0.f;
#pragma unroll
    for (int j = 0; j < kLanes; ++j) {
      const float v = __shfl_sync(0xffffffffu, part_q, first + j);
      if (j % 8 < 4)
        lo += v;
      else
        hi += v;
      ss += __shfl_sync(0xffffffffu, part_k, first + j);
    }
    rq = rms_scale<D>(lo + hi, p.eps);
    rk = rms_scale<D>(ss, p.eps);
  }
  if (!live) return;
  const long long o = i * D + 8 * c;
  uint4* const qhat = reinterpret_cast<uint4*>(p.qhat[st] + o);
  uint4* const qs = reinterpret_cast<uint4*>(p.qs[st] + o);
  if (rms) {
    float wq8[8], wk8[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      wq8[e] = __ldg(p.wq[st] + 8 * c + e);
      wk8[e] = __ldg(p.wk[st] + 8 * c + e);
    }
    *reinterpret_cast<uint4*>(p.khat[st] + o) = scale_chunk(xk, rk, wk8, 1.f);
    *qhat = scale_chunk(xq, rq, wq8, p.qscale);
    *qs = scale_chunk(xq, rq, wq8, p.sm_scale);
  } else {
    *qhat = scale_chunk(xq, 1.f, nullptr, p.qscale);
    *qs = scale_chunk(xq, 1.f, nullptr, p.sm_scale);
  }
}

// ── the dq convert ──

struct Out {  // a bf16 output through its (batch, row, head) element strides
  bf16* ptr;
  long long sb, ss, sh;
};

// out = bf16(scale * acc): acc fp32 (B, H, rows, D) contiguous; its rows
// below `split` to o0, the others (from row 0) to o1; 8 columns a thread
__global__ void attn_bwd_convert_kernel(const float* __restrict__ acc, Out o0, Out o1,
                                        int split, int rows, int heads, int d, long long n_vec,
                                        float scale) {
  const int per_row = d / 8;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < n_vec;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int c = static_cast<int>(i % per_row);
    const long long r = i / per_row;  // (b, h, s) row of acc
    const int s = static_cast<int>(r % rows);
    const long long bh = r / rows;
    const float4 x0 = reinterpret_cast<const float4*>(acc)[2 * i];
    const float4 x1 = reinterpret_cast<const float4*>(acc)[2 * i + 1];
    uint4 y;
    y.x = pack_bf16(x0.x * scale, x0.y * scale);
    y.y = pack_bf16(x0.z * scale, x0.w * scale);
    y.z = pack_bf16(x1.x * scale, x1.y * scale);
    y.w = pack_bf16(x1.z * scale, x1.w * scale);
    const bool second = s >= split;
    const Out& o = second ? o1 : o0;
    *reinterpret_cast<uint4*>(o.ptr + (bh / heads) * o.sb + (second ? s - split : s) * o.ss +
                              (bh % heads) * o.sh + 8 * c) = y;
  }
}

int convert(const float* acc, const Out& o0, const Out& o1, int split, int batch, int rows,
            int heads, int d, float scale, cudaStream_t stream) {
  const long long n_vec = static_cast<long long>(batch) * heads * rows * (d / 8);
  const int blocks = static_cast<int>(n_vec < 132LL * 8 * 256 ? (n_vec + 255) / 256 : 132 * 8);
  attn_bwd_convert_kernel<<<blocks, 256, 0, stream>>>(acc, o0, o1, split, rows, heads, d, n_vec,
                                                      scale);
  return static_cast<int>(cudaGetLastError());
}

int convert(const float* acc, const Out& o, int batch, int rows, int heads, int d, float scale,
            cudaStream_t stream) {
  return convert(acc, o, o, rows, batch, rows, heads, d, scale, stream);
}

// ── host side ──

// the fp32 dq scratch (B*H, rows, D) as a 3-D map, boxes of 64 columns x 64
// rows; memoised (the wrappers keep their scratch from call to call)
bool acc_map(CUtensorMap* map, float* acc, int d, int rows, int planes) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(planes)};
  const cuuint64_t key[9] = {reinterpret_cast<cuuint64_t>(acc), dims[0], dims[1], dims[2]};
  return memo_map(map, key, [&](CUtensorMap* m) {
    const cuuint64_t strides[2] = {4ull * d, 4ull * d * rows};
    const cuuint32_t box[3] = {64, 64, 1};
    const cuuint32_t unit[3] = {1, 1, 1};
    return encode_tiled()(m, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, acc, dims, strides, box, unit,
                          CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                          CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
  });
}

// the backward kernel itself, its shared memory opted in once per device
template <int D, int kMode>
int launch_kernel(const MapsOf<kMode>& m, const Params& p, int batch, cudaStream_t stream) {
  constexpr int smem = Smem<D, kMode>::kBytes + 1024;  // + the 1024-byte alignment
  static bool opted_in[kMaxDevices] = {};
  const cudaError_t err = opt_in_smem(attn_bwd_sm90_kernel<D, kMode>, smem, opted_in);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int kv_tiles =
      p.kv_tiles0 + (kMode == kJoint ? cdiv(p.st[1].skv, kBKV) : 0);
  const dim3 grid(kv_tiles * p.q_splits, p.heads, batch);
  attn_bwd_sm90_kernel<D, kMode><<<grid, kThreads, smem, stream>>>(m, p);
  return static_cast<int>(cudaGetLastError());
}

struct Call {  // a kBf16P / kF32P call
  HeadView q, k, v, dout;
  Out dq;
  Params p;
  float* dq_acc;  // zeroed fp32 (B, H, S_q, D)
  int batch;
};

template <int D, int kMode>
int launch(const Call& c, cudaStream_t stream) {
  if (encode_tiled() == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const bool bhsd = c.p.bhsd != 0;
  const Side& sd = c.p.st[0];
  Maps<1> m;
  if (!bf16_map(&m.q[0], c.q, D, c.p.heads, c.batch, bhsd, kBQ) ||
      !bf16_map(&m.k[0], c.k, D, c.p.heads, c.batch, bhsd, 64) ||
      !bf16_map(&m.v[0], c.v, D, c.p.heads, c.batch, bhsd, 64) ||
      !bf16_map(&m.dout[0], c.dout, D, c.p.heads, c.batch, bhsd, kBQ) ||
      !acc_map(&m.dq, c.dq_acc, D, sd.sq, c.batch * c.p.heads))
    return static_cast<int>(cudaErrorInvalidValue);
  if (c.p.q_splits < 1 || (c.p.q_splits > 1 && c.p.dkv_acc == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  int rc = launch_kernel<D, kMode>(m, c.p, c.batch, stream);
  if (rc != 0) return rc;
  rc = convert(c.dq_acc, c.dq, c.batch, sd.sq, c.p.heads, D, c.p.sm_scale, stream);
  if (rc != 0 || c.p.q_splits == 1) return rc;
  const long long plane = static_cast<long long>(c.batch) * c.p.heads * sd.skv * D;
  rc = convert(c.p.dkv_acc, {sd.dk, sd.dk_sb, sd.dk_ss, sd.dk_sh}, c.batch, sd.skv, c.p.heads, D,
               c.p.sm_scale, stream);
  if (rc != 0) return rc;
  return convert(c.p.dkv_acc + plane, {sd.dv, sd.dv_sb, sd.dv_ss, sd.dv_sh}, c.batch, sd.skv,
                 c.p.heads, D, 1.f, stream);
}

template <int kMode>
int launch_dim(int head_dim, const Call& c, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64:
      return launch<64, kMode>(c, st);
    case 128:
      return launch<128, kMode>(c, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

Call make_call(const void* q, const void* k, const void* v, const void* dout, const void* lse,
               const void* di, void* dq, void* dk, void* dv, void* dq_acc, void* dkv_acc,
               int q_splits, int sq, int skv, int kv_len, const long long* st, int batch,
               int num_heads, float sm_scale, bool bhsd) {
  Call c{};
  c.q = {q, st[0], st[1], st[2], sq};
  c.k = {k, st[3], st[4], st[5], skv};
  c.v = {v, st[6], st[7], st[8], skv};
  c.dout = {dout, st[9], st[10], st[11], sq};
  c.dq = {static_cast<bf16*>(dq), st[12], st[13], st[14]};
  Side& s = c.p.st[0];
  s.lse = static_cast<const float*>(lse);
  s.di = static_cast<const float*>(di);
  s.dk = static_cast<bf16*>(dk);
  s.dv = static_cast<bf16*>(dv);
  s.dk_sb = st[15], s.dk_ss = st[16], s.dk_sh = st[17];
  s.dv_sb = st[18], s.dv_ss = st[19], s.dv_sh = st[20];
  s.sq = sq;
  s.skv = skv;
  s.kv_len = kv_len;
  c.p.dkv_acc = static_cast<float*>(dkv_acc);
  c.p.q_splits = q_splits;
  c.p.heads = num_heads;
  c.p.bhsd = bhsd;
  c.p.kv_tiles0 = cdiv(skv, kBKV);
  c.p.qscale = sm_scale * kLog2e;
  c.p.sm_scale = sm_scale;
  c.dq_acc = static_cast<float*>(dq_acc);
  c.batch = batch;
  return c;
}

// One stream of a kJoint call: q, k, v, do of `len` rows in the (B, S, H*D)
// layout, `st` their (batch, row) element strides; lse, di fp32 (B, H, len);
// dq, dk, dv contiguous (B, len, H*D) outputs; wq, wk the RMS weights or null.
struct JointSide {
  const void *q, *k, *v, *dout, *lse, *di;
  void *dq, *dk, *dv;
  int len;
  const long long* st;
  const void *wq, *wk;
};

// The pre-pass (operands and the zeroed dq scratch), the backward, the dq
// convert. `operands`: bf16 scratch of (2, or 3 with RMS) x B x (len0 +
// len1) x H*D elements, per stream q^, q_s (and k^) of B x len x H*D each,
// the image stream's first; dq_acc: fp32 (B, H, len0 + len1, D).
template <int D>
int launch_joint(const JointSide (&s)[2], void* operands, void* dq_acc, int batch, int heads,
                 float sm_scale, float qscale, float eps, cudaStream_t stream) {
  if (encode_tiled() == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const bool rms = s[0].wq != nullptr;
  const long long hd = static_cast<long long>(heads) * D;
  const int rows = s[0].len + s[1].len;
  Prepass pp{};
  bf16* next = static_cast<bf16*>(operands);
  for (int i = 0; i < 2; ++i) {
    const long long n = static_cast<long long>(batch) * s[i].len * hd;
    pp.q[i] = static_cast<const bf16*>(s[i].q);
    pp.k[i] = static_cast<const bf16*>(s[i].k);
    pp.qhat[i] = next;
    pp.qs[i] = next + n;
    pp.khat[i] = rms ? next + 2 * n : nullptr;
    next += (rms ? 3 : 2) * n;
    pp.wq[i] = static_cast<const float*>(s[i].wq);
    pp.wk[i] = static_cast<const float*>(s[i].wk);
    pp.q_sb[i] = s[i].st[0], pp.q_ss[i] = s[i].st[1];
    pp.k_sb[i] = s[i].st[2], pp.k_ss[i] = s[i].st[3];
    pp.rows[i] = s[i].len;
  }
  pp.heads = heads, pp.batch = batch;
  pp.qscale = qscale, pp.sm_scale = sm_scale, pp.eps = eps;
  pp.zero = static_cast<float4*>(dq_acc);
  pp.n_zero = static_cast<long long>(batch) * heads * rows * (D / 4);
  const long long threads = static_cast<long long>(batch) * rows * heads * (D / 8);
  attn_bwd_prepass_kernel<D><<<static_cast<unsigned>((threads + 255) / 256), 256, 0, stream>>>(pp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  Maps<2> m;
  Params p{};
  for (int i = 0; i < 2; ++i) {
    if (i > 0 && s[i].len == 0) {  // no second stream: its maps are never read
      m.q[i] = m.q[0], m.qs[i] = m.qs[0], m.k[i] = m.k[0], m.v[i] = m.v[0];
      m.dout[i] = m.dout[0];
      continue;
    }
    const int len = s[i].len;
    const long long* st = s[i].st;
    const HeadView qh{pp.qhat[i], len * hd, hd, D, len}, qs{pp.qs[i], len * hd, hd, D, len};
    const HeadView k = rms ? HeadView{pp.khat[i], len * hd, hd, D, len}
                           : HeadView{s[i].k, st[2], st[3], D, len};
    const HeadView v{s[i].v, st[4], st[5], D, len}, dout{s[i].dout, st[6], st[7], D, len};
    if (!bf16_map(&m.q[i], qh, D, heads, batch, false, kBQ) ||
        !bf16_map(&m.qs[i], qs, D, heads, batch, false, kBQ) ||
        !bf16_map(&m.k[i], k, D, heads, batch, false, 64) ||
        !bf16_map(&m.v[i], v, D, heads, batch, false, 64) ||
        !bf16_map(&m.dout[i], dout, D, heads, batch, false, kBQ))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (!acc_map(&m.dq, static_cast<float*>(dq_acc), D, rows, batch * heads))
    return static_cast<int>(cudaErrorInvalidValue);
  for (int i = 0; i < 2; ++i) {
    Side& sd = p.st[i];
    const long long len = s[i].len;
    sd.lse = static_cast<const float*>(s[i].lse);
    sd.di = static_cast<const float*>(s[i].di);
    sd.dk = static_cast<bf16*>(s[i].dk);
    sd.dv = static_cast<bf16*>(s[i].dv);
    sd.dk_sb = sd.dv_sb = len * hd;
    sd.dk_ss = sd.dv_ss = hd;
    sd.dk_sh = sd.dv_sh = D;
    sd.sq = sd.skv = sd.kv_len = s[i].len;
    sd.q_row0 = i == 0 ? 0 : s[0].len;
  }
  p.q_splits = 1;
  p.heads = heads;
  p.kv_tiles0 = cdiv(s[0].len, kBKV);
  p.sm_scale = sm_scale;
  int rc = launch_kernel<D, kJoint>(m, p, batch, stream);
  if (rc != 0) return rc;
  const Out o0{static_cast<bf16*>(s[0].dq), s[0].len * hd, hd, D};
  const Out o1{static_cast<bf16*>(s[1].dq), s[1].len * hd, hd, D};
  return convert(static_cast<const float*>(dq_acc), o0, o1, s[0].len, batch, rows, heads, D,
                 sm_scale, stream);
}

JointSide joint_side(const void* q, const void* k, const void* v, const void* dout,
                     const void* lse, const void* di, void* dq, void* dk, void* dv, int len,
                     const long long* st, const void* wq, const void* wk) {
  return {q, k, v, dout, lse, di, dq, dk, dv, len, st, wq, wk};
}

}  // namespace

// Multi-head attention backward read and written in place through strides
// (the BSHD layout of Flux's single blocks and WAN; any other layout with a
// head's D = head_dim (64 or 128) columns contiguous). q, do, dq: bf16 with
// `sq` rows; k, v, dk, dv: bf16 with `skv` rows. strides: 21 host int64s, the
// (batch, row, head) element strides of q, k, v, do, dq, dk, dv, each a
// multiple of 8 (the head stride of q, k, v, do at most their row stride),
// every base 16-byte aligned. Keys at rows >= kv_len (1 <= kv_len <= skv)
// are masked: their dk, dv rows are stored as zeros. lse, di: contiguous
// fp32 (B, H, sq). dq_acc: fp32 (B, H, sq, D), zero on entry. q_splits >= 1
// CTAs share each kv tile's walk over the q tiles; above 1, dkv_acc is a
// zeroed fp32 (2, B, H, skv, D) scratch for dk and dv (else unused). p and t
// are rounded to bf16 for their products. Returns cudaGetLastError()
// (cudaErrorInvalidValue for another head_dim or a tensor TMA cannot map).
extern "C" int mha_bshd_bwd_bf16(const void* q, const void* k, const void* v, const void* dout,
                                 const void* lse, const void* di, void* dq, void* dk, void* dv,
                                 void* dq_acc, void* dkv_acc, int q_splits, int sq, int skv,
                                 int kv_len, const long long* strides, int batch, int num_heads,
                                 int head_dim, float sm_scale, void* stream) {
  const Call c = make_call(q, k, v, dout, lse, di, dq, dk, dv, dq_acc, dkv_acc, q_splits, sq, skv,
                           kv_len, strides, batch, num_heads, sm_scale, false);
  return launch_dim<kBf16P>(head_dim, c, stream);
}

// The backward of multi-head attention on contiguous (B, H, S, D) tensors
// with p and t kept to ~16 significant bits (hi/lo bf16 split): the TPU's
// `_bwd_dkv_kernel` / `_bwd_dq_kernel`, whose bodies are all fp32. q, do, dq:
// bf16 (B, H, sq, D); k, v, dk, dv: bf16 (B, H, skv, D); D = head_dim (64 or
// 128). Keys at rows >= kv_len are masked (dk, dv rows zero). lse (natural
// log) and di = sum_d o * do: contiguous fp32 (B, H, sq). dq_acc, dkv_acc,
// q_splits: as for `mha_bshd_bwd_bf16`. Returns cudaGetLastError().
extern "C" int mha_bwd_bf16(const void* q, const void* k, const void* v, const void* dout,
                            const void* lse, const void* di, void* dq, void* dk, void* dv,
                            void* dq_acc, void* dkv_acc, int q_splits, int sq, int skv,
                            int kv_len, int batch, int num_heads, int head_dim, float sm_scale,
                            void* stream) {
  const long long d = head_dim, hq = static_cast<long long>(sq) * d;
  const long long hkv = static_cast<long long>(skv) * d;
  const long long q_side[3] = {num_heads * hq, d, hq}, kv_side[3] = {num_heads * hkv, d, hkv};
  long long st[21];
  const long long* sides[7] = {q_side, kv_side, kv_side, q_side, q_side, kv_side, kv_side};
  for (int i = 0; i < 7; ++i)
    for (int j = 0; j < 3; ++j) st[3 * i + j] = sides[i][j];
  const Call c = make_call(q, k, v, dout, lse, di, dq, dk, dv, dq_acc, dkv_acc, q_splits, sq, skv,
                           kv_len, st, batch, num_heads, sm_scale, true);
  return launch_dim<kF32P>(head_dim, c, stream);
}

// The backward of joint image+text attention with the optional fused
// per-head qk-RMS (the TPU's `_joint_bwd_kernel`): per stream, the
// cotangents dyq, dyk of the normalised q and k (dq and dk without RMS) and
// dv. Per stream: q, k, v, do bf16 (B, S, H*D), D = head_dim (64 or 128),
// unit stride along the last dim, every base 16-byte aligned; lse (natural
// log, the forward's) and di = sum_d o * do contiguous fp32 (B, H, S);
// outputs dq, dk, dv contiguous bf16 (B, S, H*D). s_img >= 1, s_txt may be 0.
// strides: 16 host int64s, the (batch, row) strides of q, k, v, do of the
// image stream and then of the text stream, each a multiple of 8. The four
// RMS weights are fp32 (D,) device pointers, all null for no qk-norm.
// operands: bf16 scratch of 2 (3 with the weights) x B x (s_img + s_txt) x
// H*D elements for the pre-pass's q^, q_s (and k^); dq_acc: fp32 scratch of
// B x H x (s_img + s_txt) x D elements (the pre-pass zeroes it). qscale =
// sm_scale * log2(e), as the forward was given it. Launches the pre-pass, the
// backward and the dq convert. Returns cudaGetLastError()
// (cudaErrorInvalidValue for another head_dim or a tensor TMA cannot map).
extern "C" int joint_attention_bwd_bf16(
    const void* q_img, const void* k_img, const void* v_img, const void* do_img,
    const void* lse_img, const void* di_img, void* dq_img, void* dk_img, void* dv_img, int s_img,
    const void* q_txt, const void* k_txt, const void* v_txt, const void* do_txt,
    const void* lse_txt, const void* di_txt, void* dq_txt, void* dk_txt, void* dv_txt, int s_txt,
    const long long* strides, const void* wq_img, const void* wk_img, const void* wq_txt,
    const void* wk_txt, void* operands, void* dq_acc, int batch, int num_heads, int head_dim,
    float sm_scale, float qscale, float eps, void* stream) {
  const JointSide s[2] = {
      joint_side(q_img, k_img, v_img, do_img, lse_img, di_img, dq_img, dk_img, dv_img, s_img,
                 strides, wq_img, wk_img),
      joint_side(q_txt, k_txt, v_txt, do_txt, lse_txt, di_txt, dq_txt, dk_txt, dv_txt, s_txt,
                 strides + 8, wq_txt, wk_txt)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64:
      return launch_joint<64>(s, operands, dq_acc, batch, num_heads, sm_scale, qscale, eps, st);
    case 128:
      return launch_joint<128>(s, operands, dq_acc, batch, num_heads, sm_scale, qscale, eps, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Single-stream backward with the optional qk-RMS (the TPU's
// `_single_bwd_kernel`; SD3.5's dual self-attention), head width 64: the
// joint backward with an empty second stream. strides: 8 host int64s for q,
// k, v, do; operands and dq_acc as for `joint_attention_bwd_bf16` with
// s_txt = 0.
extern "C" int mha_rms_bwd_bf16(const void* q, const void* k, const void* v, const void* dout,
                                const void* lse, const void* di, void* dq, void* dk, void* dv,
                                int s, const long long* strides, const void* wq, const void* wk,
                                void* operands, void* dq_acc, int batch, int num_heads,
                                float sm_scale, float qscale, float eps, void* stream) {
  const JointSide sides[2] = {
      joint_side(q, k, v, dout, lse, di, dq, dk, dv, s, strides, wq, wk),
      joint_side(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                 0, strides, nullptr, nullptr)};
  return launch_joint<64>(sides, operands, dq_acc, batch, num_heads, sm_scale, qscale, eps,
                          static_cast<cudaStream_t>(stream));
}
