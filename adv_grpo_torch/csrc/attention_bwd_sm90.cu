// Backward of multi-head softmax attention for Hopper (sm_90a): one
// warp-specialised wgmma + TMA kernel (FlashAttention-3's backward shape)
// behind two entry points:
//   * `mha_bshd_bwd_bf16`: q and k/v of their own lengths in any (batch, row,
//     head) strides (Flux's single blocks and WAN read the fused projections
//     in place), a `kv_len` key mask; p and t = p (dp - di) rounded to bf16
//     for their products (kF32P = false);
//   * `mha_bwd_bf16`: the same on contiguous (B, H, S, D) tensors with p and t
//     kept to ~16 significant bits by a hi/lo bf16 split (kF32P = true), the
//     backward of the TPU's `mha`.
// Head widths 64 and 128.
//
// Replaces: adv_grpo_tpu/ops/attention.py `_bshd_bwd_dkv_kernel` +
// `_bshd_bwd_dq_kernel` (through `_bshd_bwd`) and `_bshd_bwd_fused_kernel`
// (through `_bshd_bwd_fused`), and `_bwd_dkv_kernel` + `_bwd_dq_kernel`
// (through `_flash_bwd`, the VJP of `mha`).
//
// Contract: from q, k, v, the output cotangent do, the forward's per-row lse
// (natural log) and di = sum_d o * do, fp32 (B, H, S_q) each: p = exp(s -
// lse) with s = q k^T * sm_scale (keys at or past kv_len get p = 0); dv =
// p^T do; dp = do v^T; t = p (dp - di); dk = sm_scale * (t^T q); dq =
// sm_scale * (t k). Numerics (both modes): s is the fp32 product of the bf16
// q and k as stored, scaled in fp32 (one FFMA with the base-2 lse in the
// exponent); dk and dq are scaled by sm_scale once, in fp32, at the end —
// the order of the TPU's split bodies, which run at every shape of the main
// paths. kF32P = false rounds p and t to bf16 (one wgmma each; the TPU keeps
// them fp32); kF32P = true runs each product with p or t twice, on bf16(x)
// and on bf16(x - bf16(x)).
//
// Bound on this card: tensor-core math. Per (batch item, head) the backward
// is 5 products of S_q x S_kv x D (s, dp, dv, dk, dq), 8 with the hi/lo
// split; at WAN's 8,100 tokens x 12 heads of 128 that is 1 TFLOP against
// ~10 MB of operands, far above the ~295 flop/byte ridge.
//
// Design:
//  * one CTA of 3 warpgroups per (kv tile of 128 rows, head, batch item). WG0,
//    after setmaxnreg.dec, is the producer: one warp TMA-loads the CTA's K
//    and V tiles once, then streams 64-row q and do tiles through a 2-stage
//    ring guarded by full / empty mbarriers, with the tiles' lse (base 2) and
//    di, which it loads itself (a q row past S_q gets lse = +inf, so p = 0,
//    and di = 0). WG1 and WG2, after setmaxnreg.inc, each own 64 kv rows and
//    keep their dk and dv accumulators (fp32, 2 x D/2 registers a thread) for
//    the whole walk;
//  * per q tile, each consumer: S^T = K Q^T (SS wgmma), P^T = exp2(S^T qscale
//    - lse2) in registers, dV += P^T dO (RS wgmma: A = bf16 P^T from
//    registers, B = dO MN-major), dP^T = V dO^T (SS), dS^T = P^T (dP^T - di),
//    dK += dS^T Q (RS), and bf16 dS^T into a shared [kv row][q] tile;
//  * dQ^T = K^T dS^T from shared memory (SS, both operands MN-major): at D =
//    128 each consumer computes 64 of the 128 head columns over all 128 kv
//    rows of the tile; at D = 64 each sums over its own 64 kv rows. The 64 x
//    64 fp32 result is staged in shared memory and reduce-added into an fp32
//    (B, H, S_q, D) scratch by a TMA reduce (cp.reduce.async.bulk.tensor);
//    the reduce-adds of the CTAs walking one head hit the same rows at about
//    the same time, so they stay in L2. A second small kernel writes dq =
//    bf16(sm_scale * scratch) through the caller's strides. The scratch is
//    zeroed by the caller; the order of the fp32 adds changes from run to run,
//    so dq is not bitwise reproducible (the tests hold tolerances);
//  * all operand tiles arrive by TMA with the 128-byte swizzle (boxes of 64
//    columns x 64 rows, two per row at D = 128), which the wgmma descriptors
//    read directly: nothing is rescaled or copied on the way. Rows past a
//    tensor's end read as zeros; keys in [kv_len, S_kv) are real memory and
//    get p = 0 and dS = 0 in-kernel, so their dk and dv rows are stored as
//    zeros, and a kv tile wholly past kv_len walks nothing and stores zeros;
//  * shared memory at D = 128: K and V 64 KB, the q/do ring 64 KB, dS^T 16 KB
//    (32 with the hi/lo split), dq staging 32 KB: one CTA per SM.

#include <cuda_bf16.h>
#include <math.h>

#include "sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace sm90;

constexpr int kBQ = 64;     // q rows per ring stage
constexpr int kBKV = 128;   // kv rows per CTA, 64 per consumer warpgroup
constexpr int kStages = 2;  // q/do ring depth
constexpr int kThreads = 384;
constexpr int kProducerRegs = 24, kConsumerRegs = 240;
constexpr float kLog2e = 1.4426950408889634f;

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// shared-memory layout, byte offsets (every tile 1024-byte aligned). A bf16
// tile of R rows and D columns is D/64 column blocks of R rows x 128 bytes.
template <int D, bool kF32P>
struct Smem {
  static constexpr int kKvBytes = kBKV * D * 2;
  static constexpr int kQBytes = kBQ * D * 2;
  static constexpr int kDsBytes = kBKV * kBQ * 2;
  static constexpr int kStageBytes = kBQ * 64 * 4;  // one consumer's fp32 dq tile
  static constexpr int kK = 0;
  static constexpr int kV = kK + kKvBytes;
  static constexpr int kQ = kV + kKvBytes;
  static constexpr int kDo = kQ + kStages * kQBytes;
  static constexpr int kDs = kDo + kStages * kQBytes;
  static constexpr int kStage = kDs + (kF32P ? 2 : 1) * kDsBytes;
  static constexpr int kStats = kStage + 2 * kStageBytes;
  static constexpr int kBars = kStats + kStages * 2 * kBQ * 4;
  static constexpr int kBytes = kBars + 8 * (1 + 2 * kStages);
};

struct Params {
  const float* lse;  // (B, H, S_q) fp32, natural log
  const float* di;   // (B, H, S_q) fp32
  bf16* dk;
  bf16* dv;
  long long dk_sb, dk_ss, dk_sh, dv_sb, dv_ss, dv_sh;  // element strides
  // q_splits > 1: the CTAs of one kv tile each walk a share of the q tiles
  // and reduce-add dk (before its sm_scale) and dv into this fp32 (2, B, H,
  // S_kv, D) scratch, zero on entry
  float* dkv_acc;
  int q_splits;
  int sq, skv, kv_len, heads;
  int bhsd;  // the bf16 maps are (D, S, H, B) rather than (D, H, S, B)
  float qscale, sm_scale;
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
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

template <int D, bool kF32P>
__device__ __forceinline__ void produce(const CUtensorMap* tm_q, const CUtensorMap* tm_k,
                                        const CUtensorMap* tm_v, const CUtensorMap* tm_do,
                                        const Params& p, uint8_t* smem, int kv0, int j0,
                                        int j1) {
  using L = Smem<D, kF32P>;
  const int lane = threadIdx.x, h = blockIdx.y, b = blockIdx.z;
  uint64_t* const kv_full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* const full = kv_full + 1;
  uint64_t* const empty = full + kStages;
  if (j0 == j1) return;  // a kv tile wholly past kv_len loads nothing
  if (lane == 0) {
    mbar_arrive_expect_tx(kv_full, 2 * L::kKvBytes);
    for (int r = 0; r < kBKV / 64; ++r) {
      const int row = kv0 + 64 * r;
      const int c1 = p.bhsd ? row : h, c2 = p.bhsd ? h : row;
      for (int c = 0; c < D / 64; ++c) {
        const int off = c * kBKV * 128 + r * 64 * 128;
        tma_load_4d(smem + L::kK + off, tm_k, kv_full, 64 * c, c1, c2, b);
        tma_load_4d(smem + L::kV + off, tm_v, kv_full, 64 * c, c1, c2, b);
      }
    }
  }
  const long long stat0 = (static_cast<long long>(b) * p.heads + h) * p.sq;
  for (int j = j0; j < j1; ++j) {
    const int s = (j - j0) % kStages, q0 = j * kBQ;
    mbar_wait(empty + s, (((j - j0) / kStages) & 1) ^ 1);
    float* const st = reinterpret_cast<float*>(smem + L::kStats) + s * 2 * kBQ;
    for (int i = lane; i < kBQ; i += 32) {
      const int r = q0 + i;
      st[i] = r < p.sq ? p.lse[stat0 + r] * kLog2e : INFINITY;
      st[kBQ + i] = r < p.sq ? p.di[stat0 + r] : 0.f;
    }
    if (lane == 0) {
      mbar_arrive_expect_tx(full + s, 2 * L::kQBytes);
      const int c1 = p.bhsd ? q0 : h, c2 = p.bhsd ? h : q0;
      for (int c = 0; c < D / 64; ++c) {
        const int off = s * L::kQBytes + c * kBQ * 128;
        tma_load_4d(smem + L::kQ + off, tm_q, full + s, 64 * c, c1, c2, b);
        tma_load_4d(smem + L::kDo + off, tm_do, full + s, 64 * c, c1, c2, b);
      }
    } else {
      mbar_arrive(full + s);  // this lane's stats are written
    }
  }
}

template <int D, bool kF32P>
__device__ __forceinline__ void consume(const CUtensorMap* tm_dq, const Params& p, uint8_t* smem,
                                        int kv0, int j0, int j1) {
  using L = Smem<D, kF32P>;
  uint64_t* const kv_full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* const full = kv_full + 1;
  uint64_t* const empty = full + kStages;
  const int cw = threadIdx.x / 128 - 1;  // kv rows 64 cw .. 64 cw + 63 of the tile
  const int tid = threadIdx.x % 128, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int m0 = 16 * (tid / 32) + g;  // accumulator rows m0 and m0 + 8
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvr = kv0 + 64 * cw + m0;  // this thread's kv rows kvr, kvr + 8
  const bool live0 = kvr < p.kv_len, live1 = kvr + 8 < p.kv_len;
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
  if (j1 > j0) mbar_wait(kv_full, 0);

  for (int j = j0; j < j1; ++j) {
    const int s = (j - j0) % kStages;
    mbar_wait(full + s, ((j - j0) / kStages) & 1);
    const uint32_t sq_ = smem_u32(smem + L::kQ + s * L::kQBytes);
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

    // P^T = exp2(S^T qscale - lse2); masked keys and q rows past S_q give 0
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float lse2 = st[8 * n + 2 * t + (e & 1)];
        sacc[4 * n + e] =
            (e < 2 ? live0 : live1) ? exp2f(fmaf(sacc[4 * n + e], p.qscale, -lse2)) : 0.f;
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
    if constexpr (kF32P) {
      wgmma_wait<0>();  // dP^T and the high half of dV are done
      fence_regs(pa);
      fence_regs(dpacc);
      acc_to_frags<true>(pa, sacc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs<D, 1>(dv, pa[kk], desc_sw128(sdo + kk * 2048, kBQ * 128, 1024), 1);
      wgmma_commit();
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

    // dK += dS^T Q: B = Q (q x D), MN-major; bf16 dS^T (and its low half)
    // to shared memory for dQ
    uint32_t da[4][4], dl[4][4];
    acc_to_frags<false>(da, dpacc);
    store_ds(smem + L::kDs, da, 64 * cw + m0, g, t);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<D, 1>(dk, da[kk], desc_sw128(sq_ + kk * 2048, kBQ * 128, 1024), 1);
    wgmma_commit();
    if constexpr (kF32P) {
      acc_to_frags<true>(dl, dpacc);
      store_ds(smem + L::kDs + L::kDsBytes, dl, 64 * cw + m0, g, t);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs<D, 1>(dk, dl[kk], desc_sw128(sq_ + kk * 2048, kBQ * 128, 1024), 1);
      wgmma_commit();
    }
    wgmma_wait<kF32P ? 2 : 1>();  // dV is done: P^T's fragments are free
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
    if constexpr (kF32P) {
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
    if constexpr (kF32P) fence_regs(dl);
    if (tid == 0) mbar_arrive(empty + s);  // q, do and the stats of this stage are used up

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
      tma_reduce_add_3d(tm_dq, stage_buf, dq_col, j * kBQ, b * p.heads + h);
      bulk_commit();
    }
  }
  if (tid == 0) bulk_wait<0>();

  if (p.q_splits > 1) {  // a share of the q walk: add it to the scratch
    if (j1 == j0) return;
    const long long plane = static_cast<long long>(gridDim.z) * p.heads * p.skv * D;
    float* const dka = p.dkv_acc + (static_cast<long long>(b) * p.heads + h) * p.skv * D + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const long long row = kvr + 8 * r;
        if (row < p.skv) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            atomicAdd(dka + row * D + 8 * n + e, dk[4 * n + 2 * r + e]);
            atomicAdd(dka + plane + row * D + 8 * n + e, dv[4 * n + 2 * r + e]);
          }
        }
      }
    return;
  }
  // dk = sm_scale * (dS^T Q) and dv, rows < S_kv (zeros at masked keys)
  bf16* const dkb = p.dk + b * p.dk_sb + h * p.dk_sh + 2 * t;
  bf16* const dvb = p.dv + b * p.dv_sb + h * p.dv_sh + 2 * t;
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const long long row = kvr + 8 * r;
      if (row < p.skv) {
        *reinterpret_cast<__nv_bfloat162*>(dkb + row * p.dk_ss + 8 * n) = __floats2bfloat162_rn(
            dk[4 * n + 2 * r] * p.sm_scale, dk[4 * n + 2 * r + 1] * p.sm_scale);
        *reinterpret_cast<__nv_bfloat162*>(dvb + row * p.dv_ss + 8 * n) =
            __floats2bfloat162_rn(dv[4 * n + 2 * r], dv[4 * n + 2 * r + 1]);
      }
    }
}

template <int D, bool kF32P>
__global__ void __launch_bounds__(kThreads, 1)
    attn_bwd_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                         const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v,
                         const __grid_constant__ CUtensorMap tm_do,
                         const __grid_constant__ CUtensorMap tm_dq,
                         const __grid_constant__ Params p) {
  using L = Smem<D, kF32P>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* const smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  // kv tile blockIdx.x / q_splits, and its share blockIdx.x % q_splits of the q tiles
  const int kv0 = static_cast<int>(blockIdx.x) / p.q_splits * kBKV;
  const int n_q = cdiv(p.sq, kBQ), per = cdiv(n_q, p.q_splits);
  const int j0 = kv0 < p.kv_len ? min(n_q, static_cast<int>(blockIdx.x) % p.q_splits * per) : 0;
  const int j1 = kv0 < p.kv_len ? min(n_q, j0 + per) : 0;
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
    if (threadIdx.x < 32) produce<D, kF32P>(&tm_q, &tm_k, &tm_v, &tm_do, p, smem, kv0, j0, j1);
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    consume<D, kF32P>(&tm_dq, p, smem, kv0, j0, j1);
  }
}

// out = bf16(scale * acc): acc fp32 (B, H, S, D) contiguous, out through its
// (batch, row, head) strides; 8 columns a thread
__global__ void attn_bwd_convert_kernel(const float* __restrict__ acc, bf16* __restrict__ out,
                                        long long sb, long long ss, long long sh, int rows,
                                        int heads, int d, long long n_vec, float scale) {
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
    *reinterpret_cast<uint4*>(out + (bh / heads) * sb + s * ss + (bh % heads) * sh + 8 * c) = y;
  }
}

int convert(const float* acc, bf16* out, long long sb, long long ss, long long sh, int batch,
            int rows, int heads, int d, float scale, cudaStream_t stream) {
  const long long n_vec = static_cast<long long>(batch) * heads * rows * (d / 8);
  const int blocks = static_cast<int>(n_vec < 132LL * 8 * 256 ? (n_vec + 255) / 256 : 132 * 8);
  attn_bwd_convert_kernel<<<blocks, 256, 0, stream>>>(acc, out, sb, ss, sh, rows, heads, d,
                                                      n_vec, scale);
  return static_cast<int>(cudaGetLastError());
}

// ── host side ──

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled (a libcuda entry point) looked up through the
// runtime, so the library links without -lcuda
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

struct HeadView {  // bf16 rows of D contiguous columns per head, element strides
  const void* ptr;
  long long sb, ss, sh;
  int rows;
};

// the 4-D map (D, H, S, B) of a BSHD view (heads inner), or (D, S, H, B) of
// a BHSD one; boxes of 64 columns x 64 rows of one head, 128-byte swizzle
bool bf16_map(CUtensorMap* map, const HeadView& x, int d, int heads, int batch, bool bhsd) {
  const cuuint64_t inner = bhsd ? x.rows : heads, outer = bhsd ? heads : x.rows;
  const cuuint64_t s1 = 2ull * (bhsd ? x.ss : x.sh), s2 = 2ull * (bhsd ? x.sh : x.ss);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d), inner, outer,
                              static_cast<cuuint64_t>(batch)};
  // a batch of one may carry any stride: give it the dense one
  const cuuint64_t strides[3] = {s1, s2, batch > 1 ? 2ull * x.sb : s2 * outer};
  const cuuint32_t box[4] = {64, bhsd ? 64u : 1u, bhsd ? 1u : 64u, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode_tiled()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x.ptr),
                        dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the fp32 dq scratch (B*H, S_q, D) as a 3-D map, boxes of 64 columns x 64 rows
bool acc_map(CUtensorMap* map, float* acc, int d, int sq, int rows) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(sq),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[2] = {4ull * d, 4ull * d * sq};
  const cuuint32_t box[3] = {64, 64, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode_tiled()(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, acc, dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

struct Call {
  HeadView q, k, v, dout, dq;
  Params p;
  float* dq_acc;  // zeroed fp32 (B, H, S_q, D)
  int batch;
};

template <int D, bool kF32P>
int launch(const Call& c, cudaStream_t stream) {
  if (encode_tiled() == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const bool bhsd = c.p.bhsd != 0;
  CUtensorMap tq, tk, tv, tdo, tdq;
  if (!bf16_map(&tq, c.q, D, c.p.heads, c.batch, bhsd) ||
      !bf16_map(&tk, c.k, D, c.p.heads, c.batch, bhsd) ||
      !bf16_map(&tv, c.v, D, c.p.heads, c.batch, bhsd) ||
      !bf16_map(&tdo, c.dout, D, c.p.heads, c.batch, bhsd) ||
      !acc_map(&tdq, c.dq_acc, D, c.p.sq, c.batch * c.p.heads))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int smem = Smem<D, kF32P>::kBytes + 1024;  // + the 1024-byte alignment
  cudaError_t err = cudaFuncSetAttribute(attn_bwd_sm90_kernel<D, kF32P>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (c.p.q_splits < 1 || (c.p.q_splits > 1 && c.p.dkv_acc == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(cdiv(c.p.skv, kBKV) * c.p.q_splits, c.p.heads, c.batch);
  attn_bwd_sm90_kernel<D, kF32P><<<grid, kThreads, smem, stream>>>(tq, tk, tv, tdo, tdq, c.p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  int rc = convert(c.dq_acc, static_cast<bf16*>(const_cast<void*>(c.dq.ptr)), c.dq.sb, c.dq.ss,
                   c.dq.sh, c.batch, c.p.sq, c.p.heads, D, c.p.sm_scale, stream);
  if (rc != 0 || c.p.q_splits == 1) return rc;
  const long long plane = static_cast<long long>(c.batch) * c.p.heads * c.p.skv * D;
  rc = convert(c.p.dkv_acc, c.p.dk, c.p.dk_sb, c.p.dk_ss, c.p.dk_sh, c.batch, c.p.skv,
               c.p.heads, D, c.p.sm_scale, stream);
  if (rc != 0) return rc;
  return convert(c.p.dkv_acc + plane, c.p.dv, c.p.dv_sb, c.p.dv_ss, c.p.dv_sh, c.batch,
                 c.p.skv, c.p.heads, D, 1.f, stream);
}

template <bool kF32P>
int launch_dim(int head_dim, const Call& c, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64:
      return launch<64, kF32P>(c, st);
    case 128:
      return launch<128, kF32P>(c, st);
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
  c.dq = {dq, st[12], st[13], st[14], sq};
  c.p.lse = static_cast<const float*>(lse);
  c.p.di = static_cast<const float*>(di);
  c.p.dk = static_cast<bf16*>(dk);
  c.p.dv = static_cast<bf16*>(dv);
  c.p.dk_sb = st[15], c.p.dk_ss = st[16], c.p.dk_sh = st[17];
  c.p.dv_sb = st[18], c.p.dv_ss = st[19], c.p.dv_sh = st[20];
  c.p.dkv_acc = static_cast<float*>(dkv_acc);
  c.p.q_splits = q_splits;
  c.p.sq = sq;
  c.p.skv = skv;
  c.p.kv_len = kv_len;
  c.p.heads = num_heads;
  c.p.bhsd = bhsd;
  c.p.qscale = sm_scale * kLog2e;
  c.p.sm_scale = sm_scale;
  c.dq_acc = static_cast<float*>(dq_acc);
  c.batch = batch;
  return c;
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
  return launch_dim<false>(head_dim, c, stream);
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
  return launch_dim<true>(head_dim, c, stream);
}
