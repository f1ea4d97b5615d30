// Joint image+text attention with fused per-head qk-RMS, forward, for Hopper
// (sm_90a). Two entry points share one kernel: `joint_attention_fwd_bf16`
// (two token streams) and `mha_rms_fwd_bf16` (one stream, the text stream
// absent). Each can also write the per-row log-sum-exp the backward
// (joint_attention_bwd.cu) needs.
//
// Replaces: adv_grpo_tpu/ops/joint_attention.py `_joint_fwd_kernel` (called
// through `_joint_fwd`, public `joint_mha`) and `_single_fwd_kernel` (called
// through `_single_fwd`, public `mha_rms`), including their
// `save_residuals=True` lse output. SD3.5-M runs them 24 and 13 times per
// MMDiT forward.
//
// Bound on this card: tensor-core math. At the 512^2 slice shape (1024 image
// + 154 text tokens, 24 heads of 64) one call is ~4*B*H*S^2*d = 8.5 GFLOP per
// batch item against ~1.4 MB of q/k/v/o per item, far above the ~295 flop/byte
// ridge. The TPU kernel keeps the whole (S_q x S_kv) fp32 score tile (~4.8 MB)
// on chip; that cannot fit the 227 KB of shared memory a block has here.
//
// Design (FlashAttention-2 shape; wgmma/TMA come later):
//  * one block of 4 warps per (q tile of 64 rows, head, batch item); the q
//    tiles of the image stream come first in the grid, then the text stream's;
//  * the block walks the image kv tiles and then the text kv tiles (64 rows
//    each) into ONE fp32 accumulator with an online softmax, so the streams
//    are never concatenated and nothing is padded in device memory;
//  * q/k/v are read in place from the (B, S, H*64) projection layout through
//    their batch and row strides (a 64-wide column slice per head);
//  * RMS in fp32, then x weight; for q only, x sm_scale*log2(e), then the cast
//    to bf16 (the TPU op order); scores, running max and sum in fp32 with
//    exp2; p cast to bf16 before p.v; p.v accumulated in fp32; divide by l at
//    the end; the natural-log lse = ln2 * (m + log2 l), as the TPU kernel
//    writes it, into an fp32 (B, H, S) array when one is given;
//  * the ragged q rows and the kv columns past each stream's length (the 154
//    text tokens) are masked in the kernel;
//  * each warp owns 16 q rows end to end: Q.K^T and P.V are bf16 mma.sync
//    (m16n8k16) tensor-core products whose score, probability and output
//    tiles never leave registers — the score accumulator's layout is the
//    P operand's, so only the shared k/v tiles go through shared memory.
//    The next k/v tile is fetched into registers during the current tile's
//    math and stored into the other half of a double-buffered shared tile.

#include "attention_tiles.cuh"

namespace {

using namespace attn;

struct Stream {  // one token stream in (B, S, H*64) layout; strides in elements
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* o;
  float* lse;  // (B, H, S) fp32, or null when not wanted
  long long q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, o_sb, o_ss;
  int len;
  const float* wq;  // (64,) RMS weights, or null when there is no qk-norm
  const float* wk;
};

// kv tile number `i` of the walk over the image stream, then the text stream
struct KvTile {
  const bf16* k;
  const bf16* v;
  long long k_ss, v_ss;
  int row0, len;
  const float* wk;
};

__device__ __forceinline__ KvTile kv_tile(const Stream& img, const Stream& txt, int img_tiles,
                                          int i, long long b, int h) {
  const bool in_txt = i >= img_tiles;
  const Stream& s = in_txt ? txt : img;
  KvTile t;
  t.k = s.k + b * s.k_sb + h * kD;
  t.v = s.v + b * s.v_sb + h * kD;
  t.k_ss = s.k_ss;
  t.v_ss = s.v_ss;
  t.row0 = (in_txt ? i - img_tiles : i) * kBKV;
  t.len = s.len;
  t.wk = s.wk;
  return t;
}

__global__ void __launch_bounds__(kThreads)
    attn_fwd_kernel(const __grid_constant__ Stream img, const __grid_constant__ Stream txt,
                    int img_qtiles, float qscale, float eps) {
  __shared__ __align__(16) bf16 qs[kBQ * kLd];
  __shared__ __align__(16) bf16 ks[2][kBKV * kLd];  // double-buffered k/v tiles
  __shared__ __align__(16) bf16 vs[2][kBKV * kLd];

  const int h = blockIdx.y;
  const long long b = blockIdx.z;
  const bool q_txt = static_cast<int>(blockIdx.x) >= img_qtiles;
  const Stream& sq = q_txt ? txt : img;
  const int q0 = (static_cast<int>(blockIdx.x) - (q_txt ? img_qtiles : 0)) * kBQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;  // mma fragment row group / column pair
  const int img_tiles = (img.len + kBKV - 1) / kBKV;
  const int n_tiles = img_tiles + (txt.len + kBKV - 1) / kBKV;

  TileRegs kr, vr;
  fetch_tile(kr, sq.q + b * sq.q_sb + h * kD, sq.q_ss, q0, sq.len);
  store_tile(qs, kr, sq.wq, eps, qscale);
  {
    const KvTile t0 = kv_tile(img, txt, img_tiles, 0, b, h);
    fetch_tile(kr, t0.k, t0.k_ss, t0.row0, t0.len);
    fetch_tile(vr, t0.v, t0.v_ss, t0.row0, t0.len);
    store_tile(ks[0], kr, t0.wk, eps, 1.f);
    store_tile(vs[0], vr, nullptr, eps, 1.f);
  }
  __syncthreads();

  uint32_t qa[kD / 16][4];  // this warp's 16 q rows as A fragments
  load_a_frags(qa, qs, 16 * warp, g, t);

  float o[kD / 8][4];  // output rows g and g+8, columns 8n + 2t, +1
  zero(o);
  float m0 = -INFINITY, m1 = -INFINITY;  // running max of rows g, g+8
  float l0 = 0.f, l1 = 0.f;              // this thread's share of the row sums

  for (int i = 0; i < n_tiles; ++i) {
    const bool more = i + 1 < n_tiles;
    KvTile next;
    if (more) {  // next tile's loads stay in flight during this tile's math
      next = kv_tile(img, txt, img_tiles, i + 1, b, h);
      fetch_tile(kr, next.k, next.k_ss, next.row0, next.len);
      fetch_tile(vr, next.v, next.v_ss, next.row0, next.len);
    }

    float sc[kBKV / 8][4];  // scores: rows g, g+8 x columns 8j + 2t, +1
    zero(sc);
    mma_abt(sc, qa, ks[i & 1], lane);

    const KvTile cur = kv_tile(img, txt, img_tiles, i, b, h);
    const int nvalid = cur.len - cur.row0;
    if (nvalid < kBKV) {
#pragma unroll
      for (int j = 0; j < kBKV / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (8 * j + 2 * t + (e & 1) >= nvalid) sc[j][e] = -INFINITY;
    }

    // online softmax in base 2 (q carries sm_scale*log2(e)); a row's four
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
    for (int n = 0; n < kD / 8; ++n) {
      o[n][0] *= a0;
      o[n][1] *= a0;
      o[n][2] *= a1;
      o[n][3] *= a1;
    }
    mma_ab(o, pa, vs[i & 1], lane);

    if (more) {
      store_tile(ks[(i + 1) & 1], kr, next.wk, eps, 1.f);
      store_tile(vs[(i + 1) & 1], vr, nullptr, eps, 1.f);
    }
    __syncthreads();  // tile i+1 is in shared memory; tile i is free again
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const int r0 = q0 + 16 * warp + g;
  store_rows(sq.o + b * sq.o_sb + h * kD, sq.o_ss, r0, sq.len, o, l0, l1, t);
  if (sq.lse != nullptr && t == 0) {
    // natural-log lse for the backward: ln(sum e^s) = ln2 * lse2
    float* lse = sq.lse + (b * gridDim.y + h) * sq.len;
    if (r0 < sq.len) lse[r0] = (m0 + log2f(fmaxf(l0, 1e-37f))) * kLn2;
    if (r0 + 8 < sq.len) lse[r0 + 8] = (m1 + log2f(fmaxf(l1, 1e-37f))) * kLn2;
  }
}

int launch(const Stream& img, const Stream& txt, int batch, int num_heads, float qscale,
           float eps, void* stream) {
  const int img_qtiles = (img.len + kBQ - 1) / kBQ;
  const int txt_qtiles = (txt.len + kBQ - 1) / kBQ;
  const dim3 grid(img_qtiles + txt_qtiles, num_heads, batch);
  attn_fwd_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      img, txt, img_qtiles, qscale, eps);
  return static_cast<int>(cudaGetLastError());
}

Stream make_stream(const void* q, const void* k, const void* v, void* o, void* lse, int len,
                   const long long* st, const void* wq, const void* wk) {
  Stream s;
  s.q = static_cast<const bf16*>(q);
  s.k = static_cast<const bf16*>(k);
  s.v = static_cast<const bf16*>(v);
  s.o = static_cast<bf16*>(o);
  s.lse = static_cast<float*>(lse);
  s.q_sb = st[0]; s.q_ss = st[1];
  s.k_sb = st[2]; s.k_ss = st[3];
  s.v_sb = st[4]; s.v_ss = st[5];
  s.o_sb = st[6]; s.o_ss = st[7];
  s.len = len;
  s.wq = static_cast<const float*>(wq);
  s.wk = static_cast<const float*>(wk);
  return s;
}

}  // namespace

// q/k/v/o of each stream: bf16 (B, S, H*64) with unit stride along the last
// dim. strides: 16 host int64s, the (batch, row) strides of q, k, v, o of the
// image stream and then of the text stream. lse_img / lse_txt: contiguous fp32
// (B, H, S) outputs of the natural-log log-sum-exp per row, or null. The four
// RMS weights are fp32 (64,) device pointers, all null for no qk-norm.
// qscale = sm_scale * log2(e). Returns cudaGetLastError().
extern "C" int joint_attention_fwd_bf16(const void* q_img, const void* k_img,
                                        const void* v_img, void* o_img, void* lse_img,
                                        int s_img, const void* q_txt, const void* k_txt,
                                        const void* v_txt, void* o_txt, void* lse_txt,
                                        int s_txt, const long long* strides,
                                        const void* wq_img, const void* wk_img,
                                        const void* wq_txt, const void* wk_txt, int batch,
                                        int num_heads, float qscale, float eps, void* stream) {
  const Stream img =
      make_stream(q_img, k_img, v_img, o_img, lse_img, s_img, strides, wq_img, wk_img);
  const Stream txt =
      make_stream(q_txt, k_txt, v_txt, o_txt, lse_txt, s_txt, strides + 8, wq_txt, wk_txt);
  return launch(img, txt, batch, num_heads, qscale, eps, stream);
}

// Single-stream attention (SD3.5's dual self-attention): the same kernel with
// an empty text stream. strides: 8 host int64s for q, k, v, o.
extern "C" int mha_rms_fwd_bf16(const void* q, const void* k, const void* v, void* o,
                                void* lse, int s, const long long* strides, const void* wq,
                                const void* wk, int batch, int num_heads, float qscale,
                                float eps, void* stream) {
  const long long none[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  const Stream img = make_stream(q, k, v, o, lse, s, strides, wq, wk);
  const Stream txt =
      make_stream(nullptr, nullptr, nullptr, nullptr, nullptr, 0, none, nullptr, nullptr);
  return launch(img, txt, batch, num_heads, qscale, eps, stream);
}
