// Backward of the joint image+text attention with fused per-head qk-RMS, for
// Hopper (sm_90a). Two entry points: `joint_attention_bwd_bf16` (two token
// streams) and `mha_rms_bwd_bf16` (one stream, the text stream absent).
//
// Replaces: adv_grpo_tpu/ops/joint_attention.py `_joint_bwd_kernel` (called
// through `_joint_bwd_fused`) and `_single_bwd_kernel` (through
// `_single_bwd_fused`). A backward of SD3.5-M with respect to its LoRA runs
// them 24 and 12 times (layer 0's dual attention reads the patch embedding,
// which no LoRA factor reaches, so it is never differentiated).
//
// Contract, as on the TPU: from q, k, v, the RMS weights, the output
// cotangent do, and the per-row lse (natural log, from the forward) and
// di = sum_d o*do, produce dyq, dyk (cotangents of the NORMALISED q and k;
// the caller applies the closed-form RMS backward) and dv for both streams,
// the streams never concatenated.
//
// Bound on this card: tensor-core math. Per (batch item, head) the backward
// is 5 products of S x S x 64 (s, dp, dv, dk, dq) plus the recompute of s and
// dp for dq — about 2.5x the forward's flops against a few MB of operands,
// far above the ~295 flop/byte ridge. The TPU kernel keeps the whole
// (S_q x S_kv) score, p, dp and ds tiles (~25 MB) in VMEM; a block here has
// 227 KB of shared memory and a thread at most 255 registers.
//
// Design (FlashAttention-2 backward, deterministic: no atomics):
//  * kernel A, one block of 4 warps per (kv tile of 64 rows, head, batch
//    item), kv tiles of the image stream first: each warp owns 16 kv rows and
//    keeps their k and v as mma A fragments and their dk, dv accumulators in
//    registers while the block walks the q tiles of both streams. Per q tile
//    it recomputes s^T = k q^T, p^T = exp2(s^T - lse2), dp^T = v do^T and
//    t^T = bf16(p^T (dp^T - di)), and accumulates dv += bf16(p^T) do and
//    dk += t^T bf16(yq * sm_scale);
//  * kernel B, one block per (q tile, head, batch item), the forward's
//    shape: each warp keeps its 16 rows of qs2 and do as A fragments and its
//    dq accumulator in registers, walks the kv tiles of both streams (the
//    next tile prefetched into registers, double-buffered shared tiles) and
//    accumulates dq += t bf16(yk); dq is divided by 1/sm_scale at the end,
//    which for the d=64 default sm_scale = 1/8 (a power of two) equals the TPU
//    kernel's bf16(bf16(yk) * sm_scale) operand exactly;
//  * the TPU op order: RMS in fp32, then x weight; q pre-scaled by
//    sm_scale*log2(e) before the bf16 cast (qs2); p = exp2(s - lse*log2(e));
//    t = p*(dp - di) cast to bf16 before the dk and dq products; sm_scale in
//    the q/k operands of those products; fp32 accumulation; bf16 outputs;
//  * q/k/v/do are read in place through their (batch, row) strides; the
//    ragged tails are masked in the kernel: q rows past a stream's length
//    carry lse = +inf (so p = 0) and di = 0 in kernel A, kv columns past it
//    (the 154 text tokens) get p = 0 in kernel B, and rows past a length are
//    never stored. Nothing is padded in device memory.

#include "attention_tiles.cuh"

namespace {

using namespace attn;

struct BwdStream {  // one token stream; (B, S, H*64) tensors, strides in elements
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* dout;
  const float* lse;  // (B, H, S) fp32, natural log
  const float* di;   // (B, H, S) fp32
  bf16* dq;          // outputs, contiguous (B, S, H*64)
  bf16* dk;
  bf16* dv;
  long long q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, do_sb, do_ss;
  int len;
  const float* wq;  // (64,) RMS weights, or null when there is no qk-norm
  const float* wk;
};

struct Tile {  // tile `i` of the walk over the image stream, then the text stream
  const BwdStream* s;
  int row0;
};

__device__ __forceinline__ Tile tile_at(const BwdStream& img, const BwdStream& txt,
                                        int img_tiles, int i) {
  const bool in_txt = i >= img_tiles;
  return Tile{in_txt ? &txt : &img, (in_txt ? i - img_tiles : i) * kBKV};
}

// Kernel A: dk and dv of one kv tile.
__global__ void __launch_bounds__(kThreads)
    attn_bwd_dkdv_kernel(const __grid_constant__ BwdStream img,
                         const __grid_constant__ BwdStream txt, int img_tiles, int hd,
                         float qscale, float sm_scale, float eps) {
  __shared__ __align__(16) bf16 sm[3][kBQ * kLd];  // qs2, bf16(yq*sm_scale), do
  __shared__ float lse2_s[kBQ];
  __shared__ float di_s[kBQ];

  const int h = blockIdx.y;
  const long long b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n_q = img_tiles + (txt.len + kBQ - 1) / kBQ;
  const Tile kv = tile_at(img, txt, img_tiles, blockIdx.x);
  const BwdStream& skv = *kv.s;

  // this warp's 16 kv rows of normalised k and of v, as A fragments
  uint32_t ka[kD / 16][4], va[kD / 16][4];
  {
    TileRegs kr, vr;
    fetch_tile(kr, skv.k + b * skv.k_sb + h * kD, skv.k_ss, kv.row0, skv.len);
    fetch_tile(vr, skv.v + b * skv.v_sb + h * kD, skv.v_ss, kv.row0, skv.len);
    store_tile(sm[0], kr, skv.wk, eps, 1.f);
    store_tile(sm[1], vr, nullptr, eps, 1.f);
    __syncthreads();
    load_a_frags(ka, sm[0], 16 * warp, g, t);
    load_a_frags(va, sm[1], 16 * warp, g, t);
    __syncthreads();
  }

  float dk[kD / 8][4], dv[kD / 8][4];
  zero(dk);
  zero(dv);

  for (int j = 0; j < n_q; ++j) {
    const Tile qt = tile_at(img, txt, img_tiles, j);
    const BwdStream& sq = *qt.s;
    {
      TileRegs qr, dr;
      fetch_tile(qr, sq.q + b * sq.q_sb + h * kD, sq.q_ss, qt.row0, sq.len);
      fetch_tile(dr, sq.dout + b * sq.do_sb + h * kD, sq.do_ss, qt.row0, sq.len);
      store_tile(sm[0], qr, sq.wq, eps, qscale, sm[1], sm_scale);
      store_tile(sm[2], dr, nullptr, eps, 1.f);
      if (threadIdx.x < kBQ) {
        const int r = qt.row0 + threadIdx.x;
        const long long at = (b * gridDim.y + h) * sq.len + r;
        // a q row past the stream's length gets p = exp2(s - inf) = 0
        lse2_s[threadIdx.x] = r < sq.len ? sq.lse[at] * kLog2e : INFINITY;
        di_s[threadIdx.x] = r < sq.len ? sq.di[at] : 0.f;
      }
    }
    __syncthreads();

    // p^T: kv rows g, g+8 x q columns 8n + 2t, +1
    float p[8][4];
    zero(p);
    mma_abt(p, ka, sm[0], lane);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) p[n][e] = exp2f(p[n][e] - lse2_s[8 * n + 2 * t + (e & 1)]);
    {
      uint32_t pa[4][4];
      acc_to_a(pa, p);
      mma_ab(dv, pa, sm[2], lane);  // dv += bf16(p^T) do
    }
    float dp[8][4];
    zero(dp);
    mma_abt(dp, va, sm[2], lane);  // dp^T = v do^T
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dp[n][e] = p[n][e] * (dp[n][e] - di_s[8 * n + 2 * t + (e & 1)]);
    {
      uint32_t ta[4][4];
      acc_to_a(ta, dp);
      mma_ab(dk, ta, sm[1], lane);  // dk += t^T bf16(yq * sm_scale)
    }
    __syncthreads();  // the shared tiles are free for the next q tile
  }

  const int r0 = kv.row0 + 16 * warp + g;
  const long long off = b * static_cast<long long>(skv.len) * hd + h * kD;
  store_rows(skv.dk + off, hd, r0, skv.len, dk, 1.f, 1.f, t);
  store_rows(skv.dv + off, hd, r0, skv.len, dv, 1.f, 1.f, t);
}

// Kernel B: dq of one q tile.
__global__ void __launch_bounds__(kThreads)
    attn_bwd_dq_kernel(const __grid_constant__ BwdStream img,
                       const __grid_constant__ BwdStream txt, int img_tiles, int hd,
                       float qscale, float sm_scale, float eps) {
  __shared__ __align__(16) bf16 ks[2][kBKV * kLd];  // double-buffered k/v tiles
  __shared__ __align__(16) bf16 vs[2][kBKV * kLd];

  const int h = blockIdx.y;
  const long long b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n_kv = img_tiles + (txt.len + kBKV - 1) / kBKV;
  const Tile qt = tile_at(img, txt, img_tiles, blockIdx.x);
  const BwdStream& sq = *qt.s;
  const int r0 = qt.row0 + 16 * warp + g, r1 = r0 + 8;

  float lse2_0 = 0.f, lse2_1 = 0.f, di0 = 0.f, di1 = 0.f;  // rows past len: unused
  {
    const float* lse = sq.lse + (b * gridDim.y + h) * sq.len;
    const float* di = sq.di + (b * gridDim.y + h) * sq.len;
    if (r0 < sq.len) lse2_0 = lse[r0] * kLog2e, di0 = di[r0];
    if (r1 < sq.len) lse2_1 = lse[r1] * kLog2e, di1 = di[r1];
  }

  // stage qs2 and do through the second buffers, tile 0 into the first
  TileRegs kr, vr;
  fetch_tile(kr, sq.q + b * sq.q_sb + h * kD, sq.q_ss, qt.row0, sq.len);
  fetch_tile(vr, sq.dout + b * sq.do_sb + h * kD, sq.do_ss, qt.row0, sq.len);
  store_tile(ks[1], kr, sq.wq, eps, qscale);
  store_tile(vs[1], vr, nullptr, eps, 1.f);
  {
    const Tile t0 = tile_at(img, txt, img_tiles, 0);
    fetch_tile(kr, t0.s->k + b * t0.s->k_sb + h * kD, t0.s->k_ss, t0.row0, t0.s->len);
    fetch_tile(vr, t0.s->v + b * t0.s->v_sb + h * kD, t0.s->v_ss, t0.row0, t0.s->len);
    store_tile(ks[0], kr, t0.s->wk, eps, 1.f);
    store_tile(vs[0], vr, nullptr, eps, 1.f);
  }
  __syncthreads();
  uint32_t qa[kD / 16][4], da[kD / 16][4];  // this warp's rows of qs2 and do
  load_a_frags(qa, ks[1], 16 * warp, g, t);
  load_a_frags(da, vs[1], 16 * warp, g, t);
  __syncthreads();

  float dq[kD / 8][4];
  zero(dq);
  for (int i = 0; i < n_kv; ++i) {
    const bool more = i + 1 < n_kv;
    Tile next;
    if (more) {  // next tile's loads stay in flight during this tile's math
      next = tile_at(img, txt, img_tiles, i + 1);
      const BwdStream& s = *next.s;
      fetch_tile(kr, s.k + b * s.k_sb + h * kD, s.k_ss, next.row0, s.len);
      fetch_tile(vr, s.v + b * s.v_sb + h * kD, s.v_ss, next.row0, s.len);
    }
    const bf16* kt = ks[i & 1];
    const bf16* vt = vs[i & 1];

    float p[8][4];  // rows g, g+8 x kv columns 8n + 2t, +1
    zero(p);
    mma_abt(p, qa, kt, lane);
    const Tile cur = tile_at(img, txt, img_tiles, i);
    const int nvalid = cur.s->len - cur.row0;
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool valid = 8 * n + 2 * t + (e & 1) < nvalid;
        p[n][e] = valid ? exp2f(p[n][e] - (e < 2 ? lse2_0 : lse2_1)) : 0.f;
      }
    float dp[8][4];
    zero(dp);
    mma_abt(dp, da, vt, lane);  // dp = do v^T
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[n][e] = p[n][e] * (dp[n][e] - (e < 2 ? di0 : di1));
    uint32_t ta[4][4];
    acc_to_a(ta, dp);
    mma_ab(dq, ta, kt, lane);  // dq += t bf16(yk)

    if (more) {
      store_tile(ks[(i + 1) & 1], kr, next.s->wk, eps, 1.f);
      store_tile(vs[(i + 1) & 1], vr, nullptr, eps, 1.f);
    }
    __syncthreads();  // tile i+1 is in shared memory; tile i is free again
  }

  const float inv = 1.f / sm_scale;
  store_rows(sq.dq + b * static_cast<long long>(sq.len) * hd + h * kD, hd, r0, sq.len, dq, inv,
             inv, t);
}

BwdStream make_stream(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* di, void* dq, void* dk, void* dv, int len,
                      const long long* st, const void* wq, const void* wk) {
  BwdStream s;
  s.q = static_cast<const bf16*>(q);
  s.k = static_cast<const bf16*>(k);
  s.v = static_cast<const bf16*>(v);
  s.dout = static_cast<const bf16*>(dout);
  s.lse = static_cast<const float*>(lse);
  s.di = static_cast<const float*>(di);
  s.dq = static_cast<bf16*>(dq);
  s.dk = static_cast<bf16*>(dk);
  s.dv = static_cast<bf16*>(dv);
  s.q_sb = st[0]; s.q_ss = st[1];
  s.k_sb = st[2]; s.k_ss = st[3];
  s.v_sb = st[4]; s.v_ss = st[5];
  s.do_sb = st[6]; s.do_ss = st[7];
  s.len = len;
  s.wq = static_cast<const float*>(wq);
  s.wk = static_cast<const float*>(wk);
  return s;
}

int launch(const BwdStream& img, const BwdStream& txt, int batch, int num_heads, float sm_scale,
           float eps, void* stream) {
  const int img_tiles = (img.len + kBKV - 1) / kBKV;
  const int n_tiles = img_tiles + (txt.len + kBKV - 1) / kBKV;
  const dim3 grid(n_tiles, num_heads, batch);
  const int hd = num_heads * kD;
  const float qscale = sm_scale * kLog2e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  attn_bwd_dkdv_kernel<<<grid, kThreads, 0, s>>>(img, txt, img_tiles, hd, qscale, sm_scale, eps);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  attn_bwd_dq_kernel<<<grid, kThreads, 0, s>>>(img, txt, img_tiles, hd, qscale, sm_scale, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Per stream: q, k, v, do bf16 (B, S, H*64) with unit stride along the last
// dim; lse and di contiguous fp32 (B, H, S); outputs dq, dk, dv contiguous
// bf16 (B, S, H*64). strides: 16 host int64s, the (batch, row) strides of q,
// k, v, do of the image stream and then of the text stream. The four RMS
// weights are fp32 (64,) device pointers, all null for no qk-norm. Returns
// cudaGetLastError().
extern "C" int joint_attention_bwd_bf16(
    const void* q_img, const void* k_img, const void* v_img, const void* do_img,
    const void* lse_img, const void* di_img, void* dq_img, void* dk_img, void* dv_img, int s_img,
    const void* q_txt, const void* k_txt, const void* v_txt, const void* do_txt,
    const void* lse_txt, const void* di_txt, void* dq_txt, void* dk_txt, void* dv_txt, int s_txt,
    const long long* strides, const void* wq_img, const void* wk_img, const void* wq_txt,
    const void* wk_txt, int batch, int num_heads, float sm_scale, float eps, void* stream) {
  const BwdStream img = make_stream(q_img, k_img, v_img, do_img, lse_img, di_img, dq_img, dk_img,
                                    dv_img, s_img, strides, wq_img, wk_img);
  const BwdStream txt = make_stream(q_txt, k_txt, v_txt, do_txt, lse_txt, di_txt, dq_txt, dk_txt,
                                    dv_txt, s_txt, strides + 8, wq_txt, wk_txt);
  return launch(img, txt, batch, num_heads, sm_scale, eps, stream);
}

// Single-stream backward (SD3.5's dual self-attention): the same kernels with
// an empty text stream. strides: 8 host int64s for q, k, v, do.
extern "C" int mha_rms_bwd_bf16(const void* q, const void* k, const void* v, const void* dout,
                                const void* lse, const void* di, void* dq, void* dk, void* dv,
                                int s, const long long* strides, const void* wq, const void* wk,
                                int batch, int num_heads, float sm_scale, float eps,
                                void* stream) {
  const long long none[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  const BwdStream img =
      make_stream(q, k, v, dout, lse, di, dq, dk, dv, s, strides, wq, wk);
  const BwdStream txt = make_stream(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                                    nullptr, nullptr, nullptr, 0, none, nullptr, nullptr);
  return launch(img, txt, batch, num_heads, sm_scale, eps, stream);
}
