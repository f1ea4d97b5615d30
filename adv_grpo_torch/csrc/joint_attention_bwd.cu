// Backward of softmax attention with the fused per-head qk-RMS for Hopper
// (sm_90a): one FlashAttention-2 backward, a template on the head width D (64
// or 128), behind two entry points:
//   * `joint_attention_bwd_bf16`: two token streams (image, text), qk-RMS
//     optional; D = 64 (SD3.5-M, with RMS) and D = 128 (Flux.1-dev, without);
//   * `mha_rms_bwd_bf16`: one stream with qk-RMS, D = 64 (SD3.5's dual
//     self-attention).
// (The multi-head backwards without RMS, `mha_bshd_bwd_bf16` and
// `mha_bwd_bf16`, are the wgmma + TMA kernel of attention_bwd_sm90.cu.)
//
// Replaces: adv_grpo_tpu/ops/joint_attention.py `_joint_bwd_kernel` (called
// through `_joint_bwd_fused`) and `_single_bwd_kernel` (through
// `_single_bwd_fused`). A backward of SD3.5-M with respect to its LoRA runs
// them 24 and 12 times; one of Flux.1-dev runs the joint one 19 times.
//
// Contract, as on the TPU: from q, k, v, the RMS weights, the output
// cotangent do, and the per-row lse (natural log, from the forward) and
// di = sum_d o*do, produce dyq, dyk (cotangents of the NORMALISED q and k;
// the caller applies the closed-form RMS backward; without RMS they are dq
// and dk) and dv for each stream, the streams never concatenated.
//
// Bound on this card: tensor-core math. Per (batch item, head) the backward
// is 5 products of S_q x S_kv x D (s, dp, dv, dk, dq) plus the recompute of s
// and dp for dq — 2.5x the forward's flops (3.5x with the recompute) against
// a few MB of operands, far above the ~295 flop/byte ridge. The TPU kernels
// keep whole score tiles (tens of MB) in VMEM; a block here has 227 KB of
// shared memory and a thread at most 255 registers.
//
// Design (FlashAttention-2 backward, deterministic: no atomics):
//  * kernel A, one block of 4 warps per (kv tile of 64 rows, head, batch
//    item), the first stream's kv tiles first: the block's normalised k and
//    v stay in shared memory, and each warp owns 16 kv rows and keeps their
//    fp32 dk, dv accumulators in registers (2 x D/2 per thread: 128 at
//    D = 128, which is why k and v are not held as register fragments too)
//    while the block walks the q tiles of both streams. Per q tile, in
//    column chunks of 64 (D = 64) or 32 (D = 128, to keep the score tiles at
//    32 registers), it recomputes s^T = k q^T, p^T = exp2(s^T - lse2),
//    dp^T = v do^T and t^T = bf16(p^T (dp^T - di)), and accumulates
//    dv += bf16(p^T) do and dk += t^T bf16(yq * sm_scale);
//  * kernel B, one block per (q tile, head, batch item), the forward's
//    shape: the block's qs2 and do stay in shared memory, each warp keeps its
//    16 rows' dq accumulator in registers and walks the kv tiles of both
//    streams (double-buffered shared tiles; at D = 64 the next tile's loads
//    stay in flight during this tile's math, at D = 128 they would spill and
//    follow it), accumulating dq += t bf16(yk) in the same
//    chunks; dq is multiplied by sm_scale once at the end (see the rounding
//    note below);
//  * op order of the TPU's fused bodies (`_joint_bwd_kernel`,
//    `_single_bwd_kernel`): RMS in fp32, then x weight; q pre-scaled by
//    sm_scale*log2(e) before the bf16 cast (qs2); p = exp2(s - lse*log2(e));
//    p cast to bf16 before the dv product and t = p*(dp - di) before the dk
//    and dq products; fp32 accumulation; bf16 outputs;
//  * rounding note: the TPU forms the dq operand bf16(bf16(yk) * sm_scale);
//    here dq = sm_scale * (t bf16(yk)) in fp32. At D = 64 (sm_scale = 1/8, a
//    power of two) the two are equal; at D = 128 the TPU's operand carries
//    one more bf16 rounding (relative 2^-9 per element), which the port does
//    not; the plain twin (ops/attention.py attention_bwd_reference) follows
//    the kernel;
//  * every operand is read in place through its strides; ragged tails are
//    masked in the kernel: q rows past a stream's length carry lse = +inf
//    (so p = 0) and di = 0 in kernel A; keys past a stream's length get p = 0
//    in both kernels; rows past a length are never stored. Nothing is padded
//    in device memory.

#include "attention_tiles.cuh"

namespace {

using namespace attn;

struct Strides {  // in elements
  long long b, s, h;
};

struct BwdStream {  // one token stream
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* dout;
  const float* lse;  // (B, H, len) fp32, natural log
  const float* di;   // (B, H, len) fp32
  bf16* dq;
  bf16* dk;
  bf16* dv;
  Strides q_st, k_st, v_st, do_st, dq_st, dk_st, dv_st;
  int len;  // rows of each of q, k, v, do and of the outputs
  const float* wq;  // (D,) RMS weights, or null when there is no qk-norm
  const float* wk;
};

template <typename T>
__device__ __forceinline__ T* at(T* base, const Strides& st, long long b, int h) {
  return base + b * st.b + h * st.h;
}

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// score columns per chunk: a 16 x chunk fp32 tile is chunk/2 registers a
// thread, and kernel A holds two of them beside its 2 x D/2 accumulators
template <int D>
__host__ __device__ constexpr int chunk_of() {
  return D == 64 ? 64 : 32;
}

template <int D>
__host__ __device__ constexpr int tile_elems() {
  return kBKV * ld_of<D>();
}

// kernel A: k, v, qs2, bf16(yq * sm_scale), do
template <int D>
constexpr int dkdv_smem_bytes() {
  return 5 * tile_elems<D>() * static_cast<int>(sizeof(bf16));
}

// kernel B: k and v double-buffered, qs2, do
template <int D>
constexpr int dq_smem_bytes() {
  return 6 * tile_elems<D>() * static_cast<int>(sizeof(bf16));
}

// Kernel A: dk and dv of one kv tile.
template <int D>
__global__ void __launch_bounds__(kThreads)
    attn_bwd_dkdv_kernel(const __grid_constant__ BwdStream s0,
                         const __grid_constant__ BwdStream s1, int s0_kv_tiles, float qscale,
                         float sm_scale, float eps) {
  constexpr int ld = ld_of<D>();
  constexpr int kC = chunk_of<D>();
  constexpr int kN = kC / 8;
  extern __shared__ uint4 smem_u4[];
  bf16* const ks = reinterpret_cast<bf16*>(smem_u4);
  bf16* const vs = ks + tile_elems<D>();
  bf16* const qs = ks + 2 * tile_elems<D>();  // qs2 of the current q tile
  bf16* const qsc = ks + 3 * tile_elems<D>();  // the dk operand bf16(yq * sm_scale)
  bf16* const dos = ks + 4 * tile_elems<D>();
  __shared__ float lse2_s[kBQ];
  __shared__ float di_s[kBQ];

  const int h = blockIdx.y;
  const long long b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const bool second = static_cast<int>(blockIdx.x) >= s0_kv_tiles;
  const BwdStream& skv = second ? s1 : s0;
  const int kv0 = (static_cast<int>(blockIdx.x) - (second ? s0_kv_tiles : 0)) * kBKV;
  const int s0_q_tiles = cdiv(s0.len, kBQ);
  const int n_q = kv0 < skv.len ? s0_q_tiles + cdiv(s1.len, kBQ) : 0;

  {
    TileRegsT<D> kr, vr;
    fetch_tile<D>(kr, at(skv.k, skv.k_st, b, h), skv.k_st.s, kv0, skv.len);
    fetch_tile<D>(vr, at(skv.v, skv.v_st, b, h), skv.v_st.s, kv0, skv.len);
    store_tile<D>(ks, kr, skv.wk, eps, 1.f);
    store_tile<D>(vs, vr, nullptr, eps, 1.f);
  }  // the first q tile's barrier publishes them
  const int r0 = kv0 + 16 * warp + g;  // this thread's kv rows r0, r0 + 8
  const bool live0 = r0 < skv.len, live1 = r0 + 8 < skv.len;
  const bf16* const kw = ks + 16 * warp * ld;
  const bf16* const vw = vs + 16 * warp * ld;

  float dk[D / 8][4], dv[D / 8][4];
  zero(dk);
  zero(dv);

  for (int j = 0; j < n_q; ++j) {
    const bool q_second = j >= s0_q_tiles;
    const BwdStream& sq = q_second ? s1 : s0;
    const int q0 = (j - (q_second ? s0_q_tiles : 0)) * kBQ;
    {
      TileRegsT<D> qr, dr;
      fetch_tile<D>(qr, at(sq.q, sq.q_st, b, h), sq.q_st.s, q0, sq.len);
      fetch_tile<D>(dr, at(sq.dout, sq.do_st, b, h), sq.do_st.s, q0, sq.len);
      store_tile<D>(qs, qr, sq.wq, eps, qscale, qsc, sm_scale);
      store_tile<D>(dos, dr, nullptr, eps, 1.f);
      if (threadIdx.x < kBQ) {
        const int r = q0 + threadIdx.x;
        const long long row = (b * gridDim.y + h) * sq.len + r;
        // a q row past the stream's length gets p = exp2(s - inf) = 0
        lse2_s[threadIdx.x] = r < sq.len ? sq.lse[row] * kLog2e : INFINITY;
        di_s[threadIdx.x] = r < sq.len ? sq.di[row] : 0.f;
      }
    }
    __syncthreads();

    // not unrolled: at D = 128 two interleaved chunks beside the 2 x 64
    // accumulator registers spill (255 registers); one at a time takes 243
#pragma unroll 1
    for (int c = 0; c < kBQ; c += kC) {
      // p^T: kv rows g, g+8 x q columns c + 8n + 2t, +1
      float p[kN][4];
      zero(p);
      mma_abt_ss<D>(p, kw, qs + c * ld, lane);
#pragma unroll
      for (int n = 0; n < kN; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          p[n][e] = (e < 2 ? live0 : live1)
                        ? exp2f(p[n][e] - lse2_s[c + 8 * n + 2 * t + (e & 1)])
                        : 0.f;
      {
        uint32_t pa[kN / 2][4];
        acc_to_a(pa, p);
        mma_ab<D>(dv, pa, dos + c * ld, lane);  // dv += bf16(p^T) do
      }
      float dp[kN][4];
      zero(dp);
      mma_abt_ss<D>(dp, vw, dos + c * ld, lane);  // dp^T = v do^T
#pragma unroll
      for (int n = 0; n < kN; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dp[n][e] = p[n][e] * (dp[n][e] - di_s[c + 8 * n + 2 * t + (e & 1)]);
      {
        uint32_t ta[kN / 2][4];
        acc_to_a(ta, dp);
        mma_ab<D>(dk, ta, qsc + c * ld, lane);  // dk += t^T bf16(yq * sm_scale)
      }
    }
    __syncthreads();  // the q-side tiles are free for the next q tile
  }

  store_rows<D>(at(skv.dk, skv.dk_st, b, h), skv.dk_st.s, r0, skv.len, dk, 1.f, 1.f, t);
  store_rows<D>(at(skv.dv, skv.dv_st, b, h), skv.dv_st.s, r0, skv.len, dv, 1.f, 1.f, t);
}

// Kernel B: dq of one q tile.
template <int D>
__global__ void __launch_bounds__(kThreads)
    attn_bwd_dq_kernel(const __grid_constant__ BwdStream s0,
                       const __grid_constant__ BwdStream s1, int s0_q_tiles, float qscale,
                       float sm_scale, float eps) {
  constexpr int ld = ld_of<D>();
  constexpr int kC = chunk_of<D>();
  constexpr int kN = kC / 8;
  // at D = 128 the next tile's 64 registers would spill beside the 64 of the
  // dq accumulator: there it is fetched after the math (the forward's rule)
  constexpr bool kPrefetch = D == 64;
  extern __shared__ uint4 smem_u4[];
  bf16* const smem = reinterpret_cast<bf16*>(smem_u4);
  // k buffers 0 and 1, v buffers 0 and 1, then qs2 and do
  auto ks = [smem](int i) { return smem + (i & 1) * tile_elems<D>(); };
  auto vs = [smem](int i) { return smem + (2 + (i & 1)) * tile_elems<D>(); };
  bf16* const qs = smem + 4 * tile_elems<D>();
  bf16* const dos = smem + 5 * tile_elems<D>();

  const int h = blockIdx.y;
  const long long b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const bool q_second = static_cast<int>(blockIdx.x) >= s0_q_tiles;
  const BwdStream& sq = q_second ? s1 : s0;
  const int q0 = (static_cast<int>(blockIdx.x) - (q_second ? s0_q_tiles : 0)) * kBQ;
  const int r0 = q0 + 16 * warp + g, r1 = r0 + 8;
  const int s0_kv_tiles = cdiv(s0.len, kBKV);
  const int n_kv = s0_kv_tiles + cdiv(s1.len, kBKV);

  float lse2_0 = 0.f, lse2_1 = 0.f, di0 = 0.f, di1 = 0.f;  // rows past len: unused
  {
    const float* lse = sq.lse + (b * gridDim.y + h) * sq.len;
    const float* di = sq.di + (b * gridDim.y + h) * sq.len;
    if (r0 < sq.len) lse2_0 = lse[r0] * kLog2e, di0 = di[r0];
    if (r1 < sq.len) lse2_1 = lse[r1] * kLog2e, di1 = di[r1];
  }

  // kv tile i of the walk over the first stream, then the second
  auto kv_at = [&](int i, const BwdStream*& s, int& row0) {
    const bool second = i >= s0_kv_tiles;
    s = second ? &s1 : &s0;
    row0 = (second ? i - s0_kv_tiles : i) * kBKV;
  };

  TileRegsT<D> kr, vr;
  fetch_tile<D>(kr, at(sq.q, sq.q_st, b, h), sq.q_st.s, q0, sq.len);
  fetch_tile<D>(vr, at(sq.dout, sq.do_st, b, h), sq.do_st.s, q0, sq.len);
  store_tile<D>(qs, kr, sq.wq, eps, qscale);
  store_tile<D>(dos, vr, nullptr, eps, 1.f);
  {
    const BwdStream* s;
    int row0;
    kv_at(0, s, row0);
    fetch_tile<D>(kr, at(s->k, s->k_st, b, h), s->k_st.s, row0, s->len);
    fetch_tile<D>(vr, at(s->v, s->v_st, b, h), s->v_st.s, row0, s->len);
    store_tile<D>(ks(0), kr, s->wk, eps, 1.f);
    store_tile<D>(vs(0), vr, nullptr, eps, 1.f);
  }
  __syncthreads();
  const bf16* const qw = qs + 16 * warp * ld;  // this warp's rows of qs2 and do
  const bf16* const dw = dos + 16 * warp * ld;

  float dq[D / 8][4];
  zero(dq);
  for (int i = 0; i < n_kv; ++i) {
    const bool more = i + 1 < n_kv;
    const BwdStream* next = nullptr;
    int next0 = 0;
    if (more) kv_at(i + 1, next, next0);
    if (kPrefetch && more) {  // the next tile's loads stay in flight during the math
      fetch_tile<D>(kr, at(next->k, next->k_st, b, h), next->k_st.s, next0, next->len);
      fetch_tile<D>(vr, at(next->v, next->v_st, b, h), next->v_st.s, next0, next->len);
    }
    const bf16* kt = ks(i);
    const bf16* vt = vs(i);
    const BwdStream* cur;
    int cur0;
    kv_at(i, cur, cur0);
    const int nvalid = cur->len - cur0;

#pragma unroll
    for (int c = 0; c < kBKV; c += kC) {
      float p[kN][4];  // rows g, g+8 x kv columns c + 8n + 2t, +1
      zero(p);
      mma_abt_ss<D>(p, qw, kt + c * ld, lane);
#pragma unroll
      for (int n = 0; n < kN; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool valid = c + 8 * n + 2 * t + (e & 1) < nvalid;
          p[n][e] = valid ? exp2f(p[n][e] - (e < 2 ? lse2_0 : lse2_1)) : 0.f;
        }
      float dp[kN][4];
      zero(dp);
      mma_abt_ss<D>(dp, dw, vt + c * ld, lane);  // dp = do v^T
#pragma unroll
      for (int n = 0; n < kN; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) dp[n][e] = p[n][e] * (dp[n][e] - (e < 2 ? di0 : di1));
      uint32_t ta[kN / 2][4];
      acc_to_a(ta, dp);
      mma_ab<D>(dq, ta, kt + c * ld, lane);  // dq += t bf16(yk)
    }

    if (more) {
      if (!kPrefetch) {
        fetch_tile<D>(kr, at(next->k, next->k_st, b, h), next->k_st.s, next0, next->len);
        fetch_tile<D>(vr, at(next->v, next->v_st, b, h), next->v_st.s, next0, next->len);
      }
      store_tile<D>(ks(i + 1), kr, next->wk, eps, 1.f);
      store_tile<D>(vs(i + 1), vr, nullptr, eps, 1.f);
    }
    __syncthreads();  // tile i+1 is in shared memory; tile i is free again
  }

  const float inv = 1.f / sm_scale;  // dq = sm_scale * (t bf16(yk))
  store_rows<D>(at(sq.dq, sq.dq_st, b, h), sq.dq_st.s, r0, sq.len, dq, inv, inv, t);
}

template <int D>
int launch(const BwdStream& s0, const BwdStream& s1, int batch, int num_heads, float sm_scale,
           float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float qscale = sm_scale * kLog2e;
  const int s0_kv_tiles = cdiv(s0.len, kBKV);
  const int s0_q_tiles = cdiv(s0.len, kBQ);
  const dim3 grid_a(s0_kv_tiles + cdiv(s1.len, kBKV), num_heads, batch);
  const dim3 grid_b(s0_q_tiles + cdiv(s1.len, kBQ), num_heads, batch);
  constexpr int smem_a = dkdv_smem_bytes<D>(), smem_b = dq_smem_bytes<D>();
  // above the static 48 KB only after opting in
  cudaError_t err = cudaFuncSetAttribute(attn_bwd_dkdv_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem_a);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(attn_bwd_dq_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem_b);
  if (err != cudaSuccess) return static_cast<int>(err);
  attn_bwd_dkdv_kernel<D><<<grid_a, kThreads, smem_a, st>>>(s0, s1, s0_kv_tiles, qscale,
                                                            sm_scale, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  attn_bwd_dq_kernel<D><<<grid_b, kThreads, smem_b, st>>>(s0, s1, s0_q_tiles, qscale,
                                                          sm_scale, eps);
  return static_cast<int>(cudaGetLastError());
}

int launch_dim(int head_dim, const BwdStream& s0, const BwdStream& s1, int batch,
               int num_heads, float sm_scale, float eps, void* stream) {
  switch (head_dim) {
    case 64:
      return launch<64>(s0, s1, batch, num_heads, sm_scale, eps, stream);
    case 128:
      return launch<128>(s0, s1, batch, num_heads, sm_scale, eps, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// A stream in the (B, S, H*D) layout (heads D columns apart) of the joint
// entry points: st holds the (batch, row) strides of q, k, v, do; the outputs
// are contiguous (B, S, H*D).
BwdStream joint_stream(const void* q, const void* k, const void* v, const void* dout,
                       const void* lse, const void* di, void* dq, void* dk, void* dv, int len,
                       const long long* st, int num_heads, int head_dim, const void* wq,
                       const void* wk) {
  BwdStream s{};
  s.q = static_cast<const bf16*>(q);
  s.k = static_cast<const bf16*>(k);
  s.v = static_cast<const bf16*>(v);
  s.dout = static_cast<const bf16*>(dout);
  s.lse = static_cast<const float*>(lse);
  s.di = static_cast<const float*>(di);
  s.dq = static_cast<bf16*>(dq);
  s.dk = static_cast<bf16*>(dk);
  s.dv = static_cast<bf16*>(dv);
  const long long hd = static_cast<long long>(num_heads) * head_dim;
  s.q_st = {st[0], st[1], head_dim};
  s.k_st = {st[2], st[3], head_dim};
  s.v_st = {st[4], st[5], head_dim};
  s.do_st = {st[6], st[7], head_dim};
  s.dq_st = s.dk_st = s.dv_st = {len * hd, hd, head_dim};
  s.len = len;
  s.wq = static_cast<const float*>(wq);
  s.wk = static_cast<const float*>(wk);
  return s;
}

}  // namespace

// Per stream: q, k, v, do bf16 (B, S, H*D), D = head_dim (64 or 128), with
// unit stride along the last dim; lse and di contiguous fp32 (B, H, S);
// outputs dq, dk, dv contiguous bf16 (B, S, H*D). strides: 16 host int64s,
// the (batch, row) strides of q, k, v, do of the image stream and then of the
// text stream. The four RMS weights are fp32 (D,) device pointers, all null
// for no qk-norm. Returns cudaGetLastError() (cudaErrorInvalidValue for
// another head_dim).
extern "C" int joint_attention_bwd_bf16(
    const void* q_img, const void* k_img, const void* v_img, const void* do_img,
    const void* lse_img, const void* di_img, void* dq_img, void* dk_img, void* dv_img, int s_img,
    const void* q_txt, const void* k_txt, const void* v_txt, const void* do_txt,
    const void* lse_txt, const void* di_txt, void* dq_txt, void* dk_txt, void* dv_txt, int s_txt,
    const long long* strides, const void* wq_img, const void* wk_img, const void* wq_txt,
    const void* wk_txt, int batch, int num_heads, int head_dim, float sm_scale, float eps,
    void* stream) {
  const BwdStream img = joint_stream(q_img, k_img, v_img, do_img, lse_img, di_img, dq_img,
                                     dk_img, dv_img, s_img, strides, num_heads, head_dim, wq_img,
                                     wk_img);
  const BwdStream txt = joint_stream(q_txt, k_txt, v_txt, do_txt, lse_txt, di_txt, dq_txt,
                                     dk_txt, dv_txt, s_txt, strides + 8, num_heads, head_dim,
                                     wq_txt, wk_txt);
  return launch_dim(head_dim, img, txt, batch, num_heads, sm_scale, eps, stream);
}

// Single-stream backward with qk-RMS (SD3.5's dual self-attention), head
// width 64: the same kernels with an empty second stream. strides: 8 host
// int64s for q, k, v, do.
extern "C" int mha_rms_bwd_bf16(const void* q, const void* k, const void* v, const void* dout,
                                const void* lse, const void* di, void* dq, void* dk, void* dv,
                                int s, const long long* strides, const void* wq, const void* wk,
                                int batch, int num_heads, float sm_scale, float eps,
                                void* stream) {
  const BwdStream img =
      joint_stream(q, k, v, dout, lse, di, dq, dk, dv, s, strides, num_heads, 64, wq, wk);
  return launch<64>(img, BwdStream{}, batch, num_heads, sm_scale, eps, stream);
}
