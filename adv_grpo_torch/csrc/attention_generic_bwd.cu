// The generic attention backward for Hopper (sm_90a): fp32 at any head width
// d <= 128, bf16 at the widths d <= 128 other than 64 and 128, and the
// fused-RMS joint backward in bf16 at d = 128, in the four layouts of the
// wgmma + TMA backward (attention_generic.cuh).
//
// Replaces, where the wgmma + TMA kernel (attention_bwd_sm90.cu) does not
// reach: adv_grpo_tpu/ops/joint_attention.py `_joint_bwd_kernel` (#4) and
// `_single_bwd_kernel` (#5), adv_grpo_tpu/ops/attention.py `_bshd_bwd*`
// (#9) and `_bwd_dkv_kernel` / `_bwd_dq_kernel` (#11). With the fused
// qk-RMS it returns what the wgmma entries return, the cotangents of the
// normalised q and k (dyq, dyk) and dv; the RMS's closed-form backward runs
// in PyTorch after it (ops/fused_norms.py `rms_bwd_closed`).
//
// Bound on this card: in fp32 the tensor cores at a third of their TF32
// rate (3xTF32, 165 TFLOP/s of fp32-accurate products; FFMA would give 67),
// in bf16 the tensor cores (989 TFLOP/s; unused by the bf16 instance).
// PERF.md has the times beside both bounds.
//
// Both dtypes: FlashAttention-2's split into two kernels, with no atomics,
// so a result is the same on every run (each sum is taken in one fixed
// order by one thread). From the forward's lse and di =
// sum(o * do) (fp32 (B, H, S) per stream), in the twins' order
// (ops/joint_attention.py `attention_bwd_reference`, ops/attention.py
// `bshd_bwd_reference`, `flash_bwd_reference`): s = q.k (kJoint, on the
// pre-pass's q^ and k^) or q.k * sm_scale * log2 e (kBshd, kBhsd); p =
// exp2(s - lse * log2 e); dv = dt(p)^T do; dp = do v^T; t = dt(p (dp - di));
// dk = t^T q_s (kJoint; kBshd / kBhsd: t^T q * sm_scale); dq = t k *
// sm_scale; kBhsd keeps p and t in fp32. Both kernels recompute s and dp
// (7 products where the bound counts 5).
//
// fp32 design (the *_tf32 kernels): every product on the tensor cores as
// three TF32 mma.sync m16n8k8 from operands split in registers (sm90.cuh
// `split_tf32`, `mma_tf32`; the 3xTF32 split as in the forward, the
// fragment products attention_generic.cuh's). mma.sync and not the
// forward's wgmma: here each of q, k, v and do is the A operand of one
// product and the B operand of another, in both orientations (k as s^T's
// A and as dq's B^T), and TF32 wgmma reads shared memory K-major only, so
// a wgmma design needs both planes of each in both layouts, twice the
// shared memory; mma.sync reads one fp32 tile in any order and splits in
// registers, at its TF32 rate (314 TFLOP/s measured on this card, PERF.md
// §6 PR 23). CTAs of 4 warps, 16 rows a warp,
// two CTAs an SM; the walked tiles arrive by cp.async, two stages deep;
// each tile's dk / dv / dq sums are added into the accumulators with
// rounding to nearest (attention_generic.cuh `update_3xtf32`).
// kJoint's dk reads q^ (the score operand) and scales by ln 2 at the end,
// so the pre-pass writes no q_s and the q side stages one tensor less.
//  * attn_generic_dkv_tf32_kernel: one CTA per (64-row kv tile, head,
//    batch item) keeps its K and V tiles in shared memory and the dk / dv
//    sums in registers, and walks 16-row q tiles (q, do, lse, di) of both
//    streams: s^T = k q^T and dp^T = v do^T with k, v as the A operand,
//    then dv += p^T do and dk += t^T q with p^T, t^T from the accumulators
//    (101 KB of shared memory at d = 128).
//  * attn_generic_dq_tf32_kernel: one CTA per (64-row q tile, head, batch
//    item) keeps its q and do tiles in shared memory and the dq sums in
//    registers, and walks kv tiles (16 rows at d = 128, else 32) up to
//    kv_len: s = q k^T, dp = do v^T, dq += t k (101 KB at d = 128).
//
// bf16 design (unchanged FFMA kernels):
//  * attn_generic_dkv_kernel: one CTA per (64-row kv tile, head, batch
//    item) holds its K and V tiles and the dk / dv sums in registers and
//    walks every q tile of both streams; kv rows at or past kv_len get 0.
//  * attn_generic_dq_kernel: one CTA per (64-row q tile, head, batch item)
//    holds its q and do tiles and the dq sums and walks the kv tiles up to
//    kv_len.
// Thread (ty, tx) of 256 owns rows 4ty..4ty+3 of its tile and the columns
// tx + 16j of the 64 x 64 score tile, tx + 16c of the D-wide sums; tiles are
// staged in shared memory as fp32, rows padded by one word.

#include <type_traits>

#include "attention_generic.cuh"

namespace generic_attn {
namespace {

constexpr int kB = 64;  // the rows of a q tile and of a kv tile

template <int DMAX>
struct BwdSmem {
  static constexpr int kLd = DMAX + 1;
  static constexpr int kLdP = kB + 1;
  static constexpr int kTile = kB * kLd;
  // dkv: K, V, Q, Q_s, dO, P, then lse2 and di of the q tile
  static constexpr int kDkvFloats = 5 * kTile + kB * kLdP + 2 * kB;
  // dq: Q, dO, K, V, T, then lse2 and di
  static constexpr int kDqFloats = 4 * kTile + kB * kLdP + 2 * kB;
};

// the 4 x 4 scores of thread (ty, tx): rows 4ty + i of sA times rows tx + 16j
// of sB, over the DMAX columns (zero past d)
template <int DMAX>
__device__ __forceinline__ void dot_tile(float (&s)[4][4], const float* sA, const float* sB,
                                         int ty, int tx) {
  constexpr int kLd = DMAX + 1;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int e = 0; e < DMAX; ++e) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = sA[(4 * ty + i) * kLd + e];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = sB[(tx + 16 * j) * kLd + e];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
  }
}

// acc[i][c] += sum_r sX[r][4ty + i] * sY[r][tx + 16c] over the kB rows r of
// a [kB][kLdP] tile sX (x^T y: the dk / dv sums) when `transposed`, else
// sum_r sX[4ty + i][r] * sY[r][tx + 16c] (x y: the dq sums)
template <int DMAX, bool transposed>
__device__ __forceinline__ void acc_tile(float (&acc)[4][DMAX / 16], const float* sX,
                                         const float* sY, int ty, int tx) {
  constexpr int C = DMAX / 16, kLd = DMAX + 1, kLdP = kB + 1;
#pragma unroll 4
  for (int r = 0; r < kB; ++r) {
    float x[4], y[C];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      x[i] = transposed ? sX[r * kLdP + 4 * ty + i] : sX[(4 * ty + i) * kLdP + r];
#pragma unroll
    for (int c = 0; c < C; ++c) y[c] = sY[r * kLd + tx + 16 * c];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < C; ++c) acc[i][c] = fmaf(x[i], y[c], acc[i][c]);
  }
}

// lse2 = lse * log2 e and di of rows [r0, r0 + n) of a q tile into shared
// memory (0 past n)
__device__ __forceinline__ void load_stats(float* lse2, float* di, const Stream& S, int b, int h,
                                           int heads, int r0, int n) {
  for (int r = threadIdx.x; r < kB; r += blockDim.x) {
    const long long o = (static_cast<long long>(b) * heads + h) * S.q_rows + r0 + r;
    lse2[r] = r < n ? __fmul_rn(S.lse[o], kLog2e) : 0.f;
    di[r] = r < n ? S.di[o] : 0.f;
  }
}

// p and t of the thread's 4 x 4 scores: p = exp2(s * score_scale - lse2) for
// rows below nq and columns below nk (else 0), t = p (dp - di); with
// round_pt both rounded to dt
template <typename T>
__device__ __forceinline__ void p_and_t(float (&s)[4][4], float (&dp)[4][4], const Params& p,
                                        const float* lse2, const float* di, int ty, int tx,
                                        int nq, int nk, bool rows_are_q) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      // the q row and kv column of this entry: (4ty + i, tx + 16j) in the dq
      // kernel's tile, transposed in the dkv kernel's
      const int qr = rows_are_q ? 4 * ty + i : tx + 16 * j;
      const int kc = rows_are_q ? tx + 16 * j : 4 * ty + i;
      float pv = 0.f;
      if (qr < nq && kc < nk) pv = exp2f(s[i][j] * p.score_scale - lse2[qr]);
      const float tv = pv * (dp[i][j] - di[qr]);
      s[i][j] = p.round_pt ? round_to<T>(pv) : pv;
      dp[i][j] = p.round_pt ? round_to<T>(tv) : tv;
    }
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
    attn_generic_dkv_kernel(const __grid_constant__ Params p) {
  using L = BwdSmem<DMAX>;
  constexpr int C = DMAX / 16;
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + L::kTile;
  float* sQ = sV + L::kTile;
  float* sQs = sQ + L::kTile;
  float* sDo = sQs + L::kTile;
  float* sP = sDo + L::kTile;
  float* sLse2 = sP + kB * L::kLdP;
  float* sDi = sLse2 + kB;
  const int h = blockIdx.y, b = blockIdx.z;
  int t = blockIdx.x;
  const Stream& KS = p.st[stream_of(p, kB, true, t)];
  const int c0 = t * kB;
  const int nk = imin(kB, KS.kv_valid - c0);  // valid kv rows of this tile (may be <= 0)
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;

  float dk[4][C], dv[4][C];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < C; ++c) dk[i][c] = dv[i][c] = 0.f;

  if (nk > 0) {
    // the tile's rows are the kv rows in the dkv kernel: sK / sV rows index
    // the score columns
    load_tile<T, DMAX>(sK, L::kLd, kB, KS.k, b, h, c0, nk, p.d);
    load_tile<T, DMAX>(sV, L::kLd, kB, KS.v, b, h, c0, nk, p.d);
    for (int qsi = 0; qsi < p.nst; ++qsi) {
      const Stream& QS = p.st[qsi];
      const bool own_qs = QS.qs.p != QS.q.p;
      for (int r0 = 0; r0 < QS.q_rows; r0 += kB) {
        const int nq = imin(kB, QS.q_rows - r0);
        __syncthreads();  // the last q tile is read
        load_tile<T, DMAX>(sQ, L::kLd, kB, QS.q, b, h, r0, nq, p.d);
        if (own_qs) load_tile<T, DMAX>(sQs, L::kLd, kB, QS.qs, b, h, r0, nq, p.d);
        load_tile<T, DMAX>(sDo, L::kLd, kB, QS.dout, b, h, r0, nq, p.d);
        load_stats(sLse2, sDi, QS, b, h, p.heads, r0, nq);
        __syncthreads();
        // scores transposed: rows 4ty + i are kv rows, columns tx + 16j q rows
        float s[4][4], dp[4][4];
        dot_tile<DMAX>(s, sK, sQ, ty, tx);
        dot_tile<DMAX>(dp, sV, sDo, ty, tx);
        p_and_t<T>(s, dp, p, sLse2, sDi, ty, tx, nq, nk, false);
        // p^T and t^T as [q row][kv row] tiles: dv += p^T do, dk += t^T q_s
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) sP[(tx + 16 * j) * L::kLdP + 4 * ty + i] = s[i][j];
        __syncthreads();
        acc_tile<DMAX, true>(dv, sP, sDo, ty, tx);
        __syncthreads();
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) sP[(tx + 16 * j) * L::kLdP + 4 * ty + i] = dp[i][j];
        __syncthreads();
        acc_tile<DMAX, true>(dk, sP, own_qs ? sQs : sQ, ty, tx);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = c0 + 4 * ty + i;
    if (row >= KS.kv_rows) continue;
    T* gk = at_mut<T>(KS.dk, b, row, h);
    T* gv = at_mut<T>(KS.dv, b, row, h);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      if (tx + 16 * c >= p.d) continue;
      gk[tx + 16 * c] = from_f<T>(dk[i][c] * p.dk_scale);
      gv[tx + 16 * c] = from_f<T>(dv[i][c]);
    }
  }
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
    attn_generic_dq_kernel(const __grid_constant__ Params p) {
  using L = BwdSmem<DMAX>;
  constexpr int C = DMAX / 16;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sDo = sQ + L::kTile;
  float* sK = sDo + L::kTile;
  float* sV = sK + L::kTile;
  float* sT = sV + L::kTile;
  float* sLse2 = sT + kB * L::kLdP;
  float* sDi = sLse2 + kB;
  const int h = blockIdx.y, b = blockIdx.z;
  int t = blockIdx.x;
  const Stream& QS = p.st[stream_of(p, kB, false, t)];
  const int r0 = t * kB;
  const int nq = imin(kB, QS.q_rows - r0);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;

  load_tile<T, DMAX>(sQ, L::kLd, kB, QS.q, b, h, r0, nq, p.d);
  load_tile<T, DMAX>(sDo, L::kLd, kB, QS.dout, b, h, r0, nq, p.d);
  load_stats(sLse2, sDi, QS, b, h, p.heads, r0, nq);
  float dq[4][C];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < C; ++c) dq[i][c] = 0.f;
  for (int ksi = 0; ksi < p.nst; ++ksi) {
    const Stream& KS = p.st[ksi];
    for (int c0 = 0; c0 < KS.kv_valid; c0 += kB) {
      const int nk = imin(kB, KS.kv_valid - c0);
      __syncthreads();  // the last kv tile and t are read
      load_tile<T, DMAX>(sK, L::kLd, kB, KS.k, b, h, c0, nk, p.d);
      load_tile<T, DMAX>(sV, L::kLd, kB, KS.v, b, h, c0, nk, p.d);
      __syncthreads();
      float s[4][4], dp[4][4];
      dot_tile<DMAX>(s, sQ, sK, ty, tx);
      dot_tile<DMAX>(dp, sDo, sV, ty, tx);
      p_and_t<T>(s, dp, p, sLse2, sDi, ty, tx, nq, nk, true);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sT[(4 * ty + i) * L::kLdP + tx + 16 * j] = dp[i][j];
      __syncthreads();
      acc_tile<DMAX, false>(dq, sT, sK, ty, tx);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + 4 * ty + i;
    if (row >= QS.q_rows) continue;
    T* g = at_mut<T>(QS.out, b, row, h);
#pragma unroll
    for (int c = 0; c < C; ++c)
      if (tx + 16 * c < p.d) g[tx + 16 * c] = from_f<T>(dq[i][c] * p.dq_scale);
  }
}

// ── fp32: the tensor cores in a 3xTF32 split ──

constexpr int kTfThreads = 128;  // 4 warps, 16 rows of the CTA's 64 each
constexpr int kTfStages = 2;     // walked tiles in flight

template <int DMAX>
struct TfDkvSmem {
  static constexpr int kLd = DMAX + 4;
  static constexpr int kBQ = 16;                          // q rows of a stage
  static constexpr int kStage = 2 * kBQ * kLd + 2 * kBQ;  // q, do rows, lse, di
  static constexpr int kRing = 2 * kB * kLd;              // after the K and V tiles
  static constexpr size_t kBytes =
      static_cast<size_t>(kRing + kTfStages * kStage) * sizeof(float);
};

template <int DMAX>
struct TfDqSmem {
  static constexpr int kLd = DMAX + 4;
  static constexpr int kBKV = DMAX == 128 ? 16 : 32;  // kv rows of a stage
  static constexpr int kStage = 2 * kBKV * kLd;        // K rows, then V rows
  static constexpr int kRing = 2 * kB * kLd;           // after the q and do tiles
  static constexpr size_t kBytes =
      static_cast<size_t>(kRing + kTfStages * kStage) * sizeof(float);
};

template <int DMAX>
__global__ void __launch_bounds__(kTfThreads, 2)
    attn_generic_dkv_tf32_kernel(const __grid_constant__ Params p) {
  using L = TfDkvSmem<DMAX>;
  constexpr int LD = L::kLd, KS = DMAX / 8, NT = DMAX / 8, BQ = L::kBQ, SN = BQ / 8;
  extern __shared__ __align__(16) float smem[];
  float* sK = smem;
  float* sV = smem + kB * LD;
  float* ring = smem + L::kRing;
  const int h = blockIdx.y, b = blockIdx.z;
  int t = blockIdx.x;
  const Stream& KVS = p.st[stream_of(p, kB, true, t)];
  const int c0 = t * kB;
  const int nk = imin(kB, KVS.kv_valid - c0);  // valid kv rows of this tile (may be <= 0)
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, c = lane & 3;

  float dk[NT][4], dv[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[nt][e] = dv[nt][e] = 0.f;

  if (nk > 0) {
    const int n0 = cdiv(p.st[0].q_rows, BQ);
    const int ntiles = n0 + (p.nst > 1 ? cdiv(p.st[1].q_rows, BQ) : 0);
    auto tile_rows = [&](int i, int& r0) {
      const int si = i < n0 ? 0 : 1;
      r0 = (i - (si ? n0 : 0)) * BQ;
      return imin(BQ, p.st[si].q_rows - r0);
    };
    auto issue = [&](int i) {
      const Stream& QS = p.st[i < n0 ? 0 : 1];
      int r0;
      const int nq = tile_rows(i, r0);
      float* st = ring + (i % kTfStages) * L::kStage;
      load_tile_async<DMAX>(st, LD, BQ, QS.q, b, h, r0, nq, p.d);
      load_tile_async<DMAX>(st + BQ * LD, LD, BQ, QS.dout, b, h, r0, nq, p.d);
      const long long o = (static_cast<long long>(b) * p.heads + h) * QS.q_rows + r0;
      for (int r = threadIdx.x; r < BQ; r += blockDim.x) {
        sm90::cp_async4(st + 2 * BQ * LD + r, r < nq ? QS.lse + o + r : QS.lse, r < nq);
        sm90::cp_async4(st + 2 * BQ * LD + BQ + r, r < nq ? QS.di + o + r : QS.di, r < nq);
      }
    };
    // the K and V tiles travel in the first group, with q tile 0
    load_tile_async<DMAX>(sK, LD, kB, KVS.k, b, h, c0, nk, p.d);
    load_tile_async<DMAX>(sV, LD, kB, KVS.v, b, h, c0, nk, p.d);
#pragma unroll
    for (int i = 0; i < kTfStages - 1; ++i) {
      if (i < ntiles) issue(i);
      sm90::cp_async_commit();
    }
    const float* k0 = sK + (16 * warp + g) * LD + c;
    const float* v0 = sV + (16 * warp + g) * LD + c;
    for (int i = 0; i < ntiles; ++i) {
      sm90::cp_async_wait<kTfStages - 2>();
      __syncthreads();  // q tile i has landed; every warp is done with tile i - 1
      if (i + kTfStages - 1 < ntiles) issue(i + kTfStages - 1);
      sm90::cp_async_commit();
      int r0;
      const int nq = tile_rows(i, r0);
      const float* sQ = ring + (i % kTfStages) * L::kStage;
      const float* sDo = sQ + BQ * LD;
      const float* sLse = sQ + 2 * BQ * LD;
      const float* sDi = sLse + BQ;

      // s^T = k q^T and dp^T = v do^T: rows the warp's 16 kv rows, columns
      // the tile's BQ q rows (one small accumulator: dk and dv hold 2 NT x
      // 4 registers a lane)
      float st[SN][4], dpt[SN][4];
      scores_3xtf32<KS, SN, false>(st, k0, sQ + g * LD + c, LD);
      scores_3xtf32<KS, SN, false>(dpt, v0, sDo + g * LD + c, LD);
      // p^T and t^T = p^T (dp^T - di)
#pragma unroll
      for (int nt = 0; nt < SN; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kr = 16 * warp + g + 8 * (e >> 1), qc = 8 * nt + 2 * c + (e & 1);
          float pv = 0.f;
          if (kr < nk && qc < nq)
            pv = exp2f(st[nt][e] * p.score_scale - __fmul_rn(sLse[qc], kLog2e));
          st[nt][e] = pv;
          dpt[nt][e] = pv * (dpt[nt][e] - sDi[qc]);
        }
      // dv += p^T do, dk += t^T q (two n-tiles a group, for the same reason)
      uint32_t big[SN][4], small[SN][4];
      split_p(st, big, small);
      update_3xtf32<SN, NT, 2>(dv, big, small, sDo + 2 * c * LD + g, LD);
      split_p(dpt, big, small);
      update_3xtf32<SN, NT, 2>(dk, big, small, sQ + 2 * c * LD + g, LD);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = c0 + 16 * warp + g + 8 * r;
    if (row >= KVS.kv_rows) continue;
    float* gk = at_mut<float>(KVS.dk, b, row, h);
    float* gv = at_mut<float>(KVS.dv, b, row, h);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int col = 8 * nt + 2 * c;
      if (col >= p.d) continue;
      *reinterpret_cast<float2*>(gk + col) =
          make_float2(dk[nt][2 * r] * p.dk_scale, dk[nt][2 * r + 1] * p.dk_scale);
      *reinterpret_cast<float2*>(gv + col) = make_float2(dv[nt][2 * r], dv[nt][2 * r + 1]);
    }
  }
}

template <int DMAX>
__global__ void __launch_bounds__(kTfThreads, 2)
    attn_generic_dq_tf32_kernel(const __grid_constant__ Params p) {
  using L = TfDqSmem<DMAX>;
  constexpr int LD = L::kLd, KS = DMAX / 8, NT = DMAX / 8, BKV = L::kBKV, SN = BKV / 8;
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;
  float* sDo = smem + kB * LD;
  float* ring = smem + L::kRing;
  const int h = blockIdx.y, b = blockIdx.z;
  int t = blockIdx.x;
  const Stream& QS = p.st[stream_of(p, kB, false, t)];
  const int r0 = t * kB;
  const int nq = imin(kB, QS.q_rows - r0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, c = lane & 3;

  // the kv tiles of stream 0, then of stream 1, up to kv_len
  const int n0 = cdiv(p.st[0].kv_valid, BKV);
  const int ntiles = n0 + (p.nst > 1 ? cdiv(p.st[1].kv_valid, BKV) : 0);
  auto tile_rows = [&](int i, int& c0) {
    const int si = i < n0 ? 0 : 1;
    c0 = (i - (si ? n0 : 0)) * BKV;
    return imin(BKV, p.st[si].kv_valid - c0);
  };
  auto issue = [&](int i) {
    const Stream& K = p.st[i < n0 ? 0 : 1];
    int c0;
    const int nk = tile_rows(i, c0);
    float* st = ring + (i % kTfStages) * L::kStage;
    load_tile_async<DMAX>(st, LD, BKV, K.k, b, h, c0, nk, p.d);
    load_tile_async<DMAX>(st + BKV * LD, LD, BKV, K.v, b, h, c0, nk, p.d);
  };

  // the q and do tiles travel in the first group, with kv tile 0; lse2 and
  // di of the lane's rows g and g + 8 stay in registers
  load_tile_async<DMAX>(sQ, LD, kB, QS.q, b, h, r0, nq, p.d);
  load_tile_async<DMAX>(sDo, LD, kB, QS.dout, b, h, r0, nq, p.d);
#pragma unroll
  for (int i = 0; i < kTfStages - 1; ++i) {
    if (i < ntiles) issue(i);
    sm90::cp_async_commit();
  }
  float lse2[2], di[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = 16 * warp + g + 8 * r;
    const long long o = (static_cast<long long>(b) * p.heads + h) * QS.q_rows + r0 + row;
    lse2[r] = row < nq ? __fmul_rn(QS.lse[o], kLog2e) : 0.f;
    di[r] = row < nq ? QS.di[o] : 0.f;
  }
  float dq[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[nt][e] = 0.f;
  const float* q0 = sQ + (16 * warp + g) * LD + c;
  const float* do0 = sDo + (16 * warp + g) * LD + c;
  for (int i = 0; i < ntiles; ++i) {
    sm90::cp_async_wait<kTfStages - 2>();
    __syncthreads();  // kv tile i has landed; every warp is done with tile i - 1
    if (i + kTfStages - 1 < ntiles) issue(i + kTfStages - 1);
    sm90::cp_async_commit();
    int c0;
    const int nk = tile_rows(i, c0);
    const float* sK = ring + (i % kTfStages) * L::kStage;
    const float* sV = sK + BKV * LD;

    float s[SN][4], dp[SN][4];
    scores_3xtf32<KS, SN>(s, q0, sK + g * LD + c, LD);
    scores_3xtf32<KS, SN>(dp, do0, sV + g * LD + c, LD);
    // t = p (dp - di), p = exp2(s * score_scale - lse2) inside the tile
#pragma unroll
    for (int nt = 0; nt < SN; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qr = 16 * warp + g + 8 * (e >> 1), kc = 8 * nt + 2 * c + (e & 1);
        float pv = 0.f;
        if (qr < nq && kc < nk) pv = exp2f(s[nt][e] * p.score_scale - lse2[e >> 1]);
        s[nt][e] = pv * (dp[nt][e] - di[e >> 1]);
      }
    // dq += t k
    uint32_t tb[SN][4], ts[SN][4];
    split_p(s, tb, ts);
    update_3xtf32<SN, NT>(dq, tb, ts, sK + 2 * c * LD + g, LD);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 16 * warp + g + 8 * r;
    if (row >= QS.q_rows) continue;
    float* gq = at_mut<float>(QS.out, b, row, h);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int col = 8 * nt + 2 * c;
      if (col < p.d)
        *reinterpret_cast<float2*>(gq + col) =
            make_float2(dq[nt][2 * r] * p.dq_scale, dq[nt][2 * r + 1] * p.dq_scale);
    }
  }
}

template <int DMAX>
int launch_bwd_tf32(const Params& p, int batch, cudaStream_t stream) {
  const auto dkv = attn_generic_dkv_tf32_kernel<DMAX>;
  const auto dq = attn_generic_dq_tf32_kernel<DMAX>;
  constexpr size_t dkv_bytes = TfDkvSmem<DMAX>::kBytes, dq_bytes = TfDqSmem<DMAX>::kBytes;
  static bool dkv_done[sm90::kMaxDevices] = {}, dq_done[sm90::kMaxDevices] = {};
  cudaError_t err = sm90::opt_in_smem(dkv, static_cast<int>(dkv_bytes), dkv_done);
  if (err == cudaSuccess) err = sm90::opt_in_smem(dq, static_cast<int>(dq_bytes), dq_done);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int kv_tiles = tiles_of(p, kB, true), q_tiles = tiles_of(p, kB, false);
  if (kv_tiles > 0) {
    dkv<<<dim3(kv_tiles, p.heads, batch), kTfThreads, dkv_bytes, stream>>>(p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (q_tiles > 0) dq<<<dim3(q_tiles, p.heads, batch), kTfThreads, dq_bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DMAX>
int launch_bwd(const Params& p, int batch, cudaStream_t stream) {
  using L = BwdSmem<DMAX>;
  const auto dkv = attn_generic_dkv_kernel<T, DMAX>;
  const auto dq = attn_generic_dq_kernel<T, DMAX>;
  const size_t dkv_bytes = L::kDkvFloats * sizeof(float);
  const size_t dq_bytes = L::kDqFloats * sizeof(float);
  cudaFuncSetAttribute(dkv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(dkv_bytes));
  cudaFuncSetAttribute(dq, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(dq_bytes));
  const int kv_tiles = tiles_of(p, kB, true), q_tiles = tiles_of(p, kB, false);
  if (kv_tiles > 0) {
    dkv<<<dim3(kv_tiles, p.heads, batch), kThreads, dkv_bytes, stream>>>(p);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (q_tiles > 0) dq<<<dim3(q_tiles, p.heads, batch), kThreads, dq_bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int run(const long long* desc, int nst, int mode, int batch, int heads, int d, float qscale,
        float sm_scale, float eps, cudaStream_t stream) {
  constexpr bool f32 = std::is_same<T, float>::value;
  Params p{};
  // fp32 reads q^ for both s and dk, so the pre-pass writes no q_s
  int rc = setup_streams<T>(p, desc, nst, mode, batch, heads, d, qscale, sm_scale, eps, true,
                            stream, !f32);
  if (rc != 0) return rc;
  // kJoint: s on q^ (which holds sm_scale * log2 e), dk on q_s (which holds
  // sm_scale; fp32: on q^, times ln 2); kBshd / kBhsd: the fp32 scores
  // scaled, dk scaled at the end
  p.score_scale = mode == kJoint ? 1.f : qscale;
  p.dk_scale = mode == kJoint ? (f32 ? kLn2 : 1.f) : sm_scale;
  p.dq_scale = sm_scale;
  p.round_pt = mode != kBhsd;
  if constexpr (f32) {
    if (d <= 32) return launch_bwd_tf32<32>(p, batch, stream);
    if (d <= 64) return launch_bwd_tf32<64>(p, batch, stream);
    return launch_bwd_tf32<128>(p, batch, stream);
  } else {
    if (d <= 32) return launch_bwd<T, 32>(p, batch, stream);
    if (d <= 64) return launch_bwd<T, 64>(p, batch, stream);
    return launch_bwd<T, 128>(p, batch, stream);
  }
}

}  // namespace
}  // namespace generic_attn

// desc: `nst` streams of generic_attn::kDescLen int64 each (attention_generic.cuh
// `Desc`: the lengths, the Views of q, k, v, do, dq, dk, dv, the lse, di and
// RMS weight pointers, the kJoint scratches); dtype: 0 fp32, 1 bf16; mode:
// generic_attn::Mode; qscale = sm_scale * log2 e. Writes dq (kJoint: dyq),
// dk (dyk) and dv of every stream; dk and dv are 0 at kv rows at or past
// kv_valid. Returns the first cudaGetLastError() that is not 0.
extern "C" int attention_generic_bwd(const long long* desc, int nst, int dtype, int mode,
                                     int batch, int num_heads, int head_dim, float qscale,
                                     float sm_scale, float eps, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (head_dim < 1 || head_dim > 128 || nst < 1 || nst > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return generic_attn::run<float>(desc, nst, mode, batch, num_heads, head_dim, qscale,
                                    sm_scale, eps, s);
  return generic_attn::run<__nv_bfloat16>(desc, nst, mode, batch, num_heads, head_dim, qscale,
                                          sm_scale, eps, s);
}
