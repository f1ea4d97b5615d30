// Forward of multi-head softmax attention for Hopper (sm_90a): one
// warp-specialised wgmma + TMA kernel (FlashAttention-3's forward shape),
// `attn_fwd_sm90_kernel<D>` at head widths D = 64 and 128, behind two entry
// points:
//   * `mha_bshd_fwd_bf16`: q and k/v of their own lengths in any (batch, row,
//     head) strides (the BSHD layout; Flux's single blocks and WAN's self- and
//     cross-attention read the column slices of their fused projections in
//     place), keys at or past `kv_len` masked;
//   * `mha_fwd_bf16`: the same on contiguous (B, H, S, D) tensors.
// Either can write the per-row natural-log lse the backward needs.
//
// Replaces: adv_grpo_tpu/ops/attention.py `_bshd_fwd_kernel` (through
// `_bshd_fwd`, public `mha_bshd`) and `_fwd_kernel` (through `_flash_fwd`,
// behind the custom VJP `_flash_mha` and the public `mha`, which
// `context_parallel_attention` runs on the gathered keys). On the TPU they
// are two bodies only because Mosaic tiles the last dimension by 128 lanes;
// here the layout is strides.
//
// Contract (the TPU kernels'): s is the fp32 product of the bf16 q and k as
// stored, scaled in fp32 by qscale = sm_scale * log2(e) (one FFMA with the
// running max in the exponent; q is never pre-scaled); keys at or past
// kv_len are masked; the softmax runs online in base 2 with fp32 max and
// sum; p is cast to bf16 for p.v, which accumulates in fp32; o = acc / l,
// where a row with l == 0 divides by 1; lse = ln2 * (m + log2 max(l,
// 1e-37)), fp32 (B, H, S_q), when a pointer is given.
//
// Bound on this card: tensor-core math. Per (batch item, head) the forward is
// 2 products of S_q x kv_len x D; at WAN's 8,100 tokens x 12 heads of 128
// that is 403 GFLOP against ~100 MB of q, k, v and o, far above the ~295
// flop/byte ridge.
//
// Design:
//  * one CTA of 3 warpgroups per (q tile of 128 rows, head, batch item). WG0,
//    after setmaxnreg.dec, is the producer: one thread TMA-loads the CTA's Q
//    tile once, then streams the 128-row K and V tiles through a ring of
//    2 stages, K and V each with their own full / empty mbarriers (so S_j
//    can start before V_j lands). WG1 and WG2, after setmaxnreg.inc, each
//    own 64 q rows and keep their O accumulator (64 x D fp32), running max
//    and sum in registers for the whole walk;
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
//    descriptors read directly. The K / V maps end at kv_len: rows past it
//    read as zeros, and the kv tiles wholly past kv_len are not walked; keys
//    inside the last tile at or past kv_len get -inf. q rows past S_q read as
//    zeros and are never stored (nor their lse);
//  * shared memory: Q 128 x D plus 2 (K, V) pairs of 128 x D bf16; at D =
//    128, 32 + 2 x 64 KB: one CTA per SM. A third stage (fits at 224 KB)
//    read no faster at either head width.

#include <cuda_bf16.h>
#include <math.h>

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
constexpr float kLn2 = 0.6931471805599453f;

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

struct Params {
  bf16* o;
  float* lse;  // (B, H, S_q) fp32, natural log; null when not wanted
  long long o_sb, o_ss, o_sh;  // element strides
  int sq, kv_len, heads;
  int bhsd;  // the maps are (D, S, H, B) rather than (D, H, S, B)
  float qscale;
};

struct Bars {
  uint64_t *q_full, *k_full, *v_full, *k_empty, *v_empty;
};

template <int D>
__device__ __forceinline__ Bars bars_of(uint8_t* smem) {
  uint64_t* const b = reinterpret_cast<uint64_t*>(smem + Smem<D>::kBars);
  return {b, b + 1, b + 1 + kStages, b + 1 + 2 * kStages, b + 1 + 3 * kStages};
}

// one thread: Q once, then K_j and V_j into stage j % kStages once both
// consumers have released the tile that stage held
template <int D>
__device__ __forceinline__ void produce(const CUtensorMap* tm_q, const CUtensorMap* tm_k,
                                        const CUtensorMap* tm_v, const Params& p, uint8_t* smem,
                                        int q0, int n_kv) {
  using L = Smem<D>;
  const Bars bar = bars_of<D>(smem);
  const int h = blockIdx.y, b = blockIdx.z;
  // dims 1 and 2 of the maps: (heads, rows) for BSHD, (rows, heads) for BHSD
  const int q1 = p.bhsd ? q0 : h, q2 = p.bhsd ? h : q0;
  mbar_arrive_expect_tx(bar.q_full, L::kQBytes);
  for (int c = 0; c < D / 64; ++c)
    tma_load_4d(smem + L::kQ + c * kBQ * 128, tm_q, bar.q_full, 64 * c, q1, q2, b);
  for (int j = 0; j < n_kv; ++j) {
    const int s = j % kStages, free_parity = ((j / kStages) & 1) ^ 1, kv0 = j * kBKV;
    const int c1 = p.bhsd ? kv0 : h, c2 = p.bhsd ? h : kv0;
    const int off = s * L::kKvBytes;
    mbar_wait(bar.k_empty + s, free_parity);
    mbar_arrive_expect_tx(bar.k_full + s, L::kKvBytes);
    for (int c = 0; c < D / 64; ++c)
      tma_load_4d(smem + L::kK + off + c * kBKV * 128, tm_k, bar.k_full + s, 64 * c, c1, c2, b);
    mbar_wait(bar.v_empty + s, free_parity);
    mbar_arrive_expect_tx(bar.v_full + s, L::kKvBytes);
    for (int c = 0; c < D / 64; ++c)
      tma_load_4d(smem + L::kV + off + c * kBKV * 128, tm_v, bar.v_full + s, 64 * c, c1, c2, b);
  }
}

// the running max (unscaled) and this thread's share of the sum of its rows
// g and g + 8
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
// before kv_len: mask, new max, P = exp2(S qscale - max) in place of S and the
// rescaled sums; returns the factors (a0, a1) that rescale O
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

template <int D>
__device__ __forceinline__ void consume(const Params& p, uint8_t* smem, int q0, int n_kv) {
  using L = Smem<D>;
  const Bars bar = bars_of<D>(smem);
  const int cw = threadIdx.x / 128 - 1;  // q rows 64 cw .. 64 cw + 63 of the tile
  const int tid = threadIdx.x % 128, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int h = blockIdx.y, b = blockIdx.z;
  const uint32_t sq_ = smem_u32(smem + L::kQ) + cw * 64 * 128;
  const uint32_t sk = smem_u32(smem + L::kK), sv = smem_u32(smem + L::kV);
  const int my_turn = kBarTurn + cw, next_turn = kBarTurn + 1 - cw;
  const float qscale = p.qscale;

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

  if (cw == 1) named_bar_arrive(kBarTurn, kTurnThreads);  // consumer 0 takes the first turn
  mbar_wait(bar.q_full, 0);

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
  rescale_pack<D>(o, pa, s, softmax(s, rows, p.kv_len, t, qscale));

  // turn j: S_j, then O += P_{j-1} V_{j-1}
  for (int j = 1; j < n_kv; ++j) {
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
    const float2 a = softmax(s, rows, p.kv_len - j * kBKV, t, qscale);
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(pa);
    if (tid == 0) mbar_arrive(bar.v_empty + sp);
    rescale_pack<D>(o, pa, s, a);
  }

  // the last turn: O += P_{n-1} V_{n-1}; consumer 1 ends the alternation
  {
    const int sp = (n_kv - 1) % kStages;
    mbar_wait(bar.v_full + sp, ((n_kv - 1) / kStages) & 1);
    named_bar_sync(my_turn, kTurnThreads);
    wgmma_fence();
    issue_pv<D>(o, pa, vt(n_kv - 1));
    wgmma_commit();
    if (cw == 0) named_bar_arrive(next_turn, kTurnThreads);
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(pa);
  }

  // o = acc / l (a row with l == 0 divides by 1), rows < S_q
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    rows.l0 += __shfl_xor_sync(0xffffffffu, rows.l0, off);
    rows.l1 += __shfl_xor_sync(0xffffffffu, rows.l1, off);
  }
  const float div0 = rows.l0 == 0.f ? 1.f : rows.l0, div1 = rows.l1 == 0.f ? 1.f : rows.l1;
  const int r0 = q0 + 64 * cw + 16 * (tid / 32) + g, r1 = r0 + 8;
  bf16* const ob = p.o + b * p.o_sb + h * p.o_sh + 2 * t;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    if (r0 < p.sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + r0 * p.o_ss + 8 * n) =
          __floats2bfloat162_rn(o[4 * n] / div0, o[4 * n + 1] / div0);
    if (r1 < p.sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + r1 * p.o_ss + 8 * n) =
          __floats2bfloat162_rn(o[4 * n + 2] / div1, o[4 * n + 3] / div1);
  }
  if (p.lse != nullptr && t == 0) {
    // natural-log lse for the backward: ln(sum e^s) = ln2 * lse2
    float* const lse = p.lse + (static_cast<long long>(b) * p.heads + h) * p.sq;
    if (r0 < p.sq) lse[r0] = (rows.m0 * qscale + log2f(fmaxf(rows.l0, 1e-37f))) * kLn2;
    if (r1 < p.sq) lse[r1] = (rows.m1 * qscale + log2f(fmaxf(rows.l1, 1e-37f))) * kLn2;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    attn_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                         const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v,
                         const __grid_constant__ Params p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* const smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int q0 = static_cast<int>(blockIdx.x) * kBQ;
  const int n_kv = cdiv(p.kv_len, kBKV);  // the kv tiles wholly past kv_len are not walked
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
    if (threadIdx.x == 0) produce<D>(&tm_q, &tm_k, &tm_v, p, smem, q0, n_kv);
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    consume<D>(p, smem, q0, n_kv);
  }
}

// ── host side ──

template <int D>
int launch(const HeadView& q, const HeadView& k, const HeadView& v, const Params& p, int batch,
           cudaStream_t stream) {
  if (encode_tiled() == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const bool bhsd = p.bhsd != 0;
  CUtensorMap tq, tk, tv;
  if (!bf16_map(&tq, q, D, p.heads, batch, bhsd, kBQ) ||
      !bf16_map(&tk, k, D, p.heads, batch, bhsd, kBKV) ||
      !bf16_map(&tv, v, D, p.heads, batch, bhsd, kBKV))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int smem = Smem<D>::kBytes + 1024;  // + the 1024-byte alignment
  cudaError_t err = cudaFuncSetAttribute(attn_fwd_sm90_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(cdiv(p.sq, kBQ), p.heads, batch);
  attn_fwd_sm90_kernel<D><<<grid, kThreads, smem, stream>>>(tq, tk, tv, p);
  return static_cast<int>(cudaGetLastError());
}

// q, k, v as head views (k and v of kv_len rows: the maps end there), o
// through its strides
int launch_dim(int head_dim, const HeadView& q, const HeadView& k, const HeadView& v,
               const Params& p, int batch, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64:
      return launch<64>(q, k, v, p, batch, st);
    case 128:
      return launch<128>(q, k, v, p, batch, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

Params make_params(void* o, void* lse, const long long* o_strides, int sq, int kv_len,
                   int num_heads, bool bhsd, float qscale) {
  Params p{};
  p.o = static_cast<bf16*>(o);
  p.lse = static_cast<float*>(lse);
  p.o_sb = o_strides[0], p.o_ss = o_strides[1], p.o_sh = o_strides[2];
  p.sq = sq;
  p.kv_len = kv_len;
  p.heads = num_heads;
  p.bhsd = bhsd;
  p.qscale = qscale;
  return p;
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
  const Params p = make_params(o, lse, strides + 9, sq, kv_len, num_heads, false, qscale);
  return launch_dim(head_dim, hq, hk, hv, p, batch, stream);
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
  const Params p = make_params(o, lse, q_side, sq, kv_len, num_heads, true, qscale);
  return launch_dim(head_dim, vq, vk, vv, p, batch, stream);
}
