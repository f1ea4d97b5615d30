// Joint image+text attention with optional fused per-head qk-RMS, forward,
// for Hopper (sm_90a). Four entry points on the forward core of
// attention_fwd.cuh, compiled once here: `joint_attention_fwd_bf16` (two
// token streams), `mha_rms_fwd_bf16` (one stream), `mha_bshd_fwd_bf16` (one
// stream through arbitrary strides, with a kv_len mask) and `mha_fwd_bf16`
// (the (B, H, S, D) layout; see below). Each can also write the per-row
// log-sum-exp the backward (joint_attention_bwd.cu) needs. The joint entry
// points pre-scale q, as the TPU's joint kernels do; the two multi-head
// entry points scale the fp32 scores, as `_bshd_fwd_kernel` and `_fwd_kernel`
// do (attention_fwd.cuh, kScaleScores).
//
// Replaces: adv_grpo_tpu/ops/joint_attention.py `_joint_fwd_kernel` (called
// through `_joint_fwd`, public `joint_mha`) and `_single_fwd_kernel` (called
// through `_single_fwd`, public `mha_rms`), including their
// `save_residuals=True` lse output. SD3.5-M runs them 24 and 13 times per
// MMDiT forward at head width 64 with the qk-RMS fused; Flux.1-dev runs the
// joint one 19 times per forward at head width 128 without it (its qk-norm
// and RoPE come before).
//
// Bound on this card: tensor-core math. At the SD3.5-M 512^2 shape (1024
// image + 154 text tokens, 24 heads of 64) one call is ~4*B*H*S^2*d = 8.5
// GFLOP per batch item against ~1.4 MB of q/k/v/o per item, and at Flux's
// (1024 + 512 tokens, 24 heads of 128) 29 GFLOP against 38 MB: both far above
// the ~295 flop/byte ridge. The TPU kernel keeps the whole (S_q x S_kv) fp32
// score tile on chip; that cannot fit the 227 KB of shared memory a block has
// here, so the port walks kv tiles with an online softmax (attention_fwd.cuh).

#include "attention_fwd.cuh"

namespace {

using namespace attn;

// A stream in the (B, S, H*D) layout: heads D columns apart. st: the
// (batch, row) strides of q, k, v, o.
Stream bshd_stream(const void* q, const void* k, const void* v, void* o, void* lse, int len,
                   const long long* st, int head_dim, const void* wq, const void* wk) {
  Stream s{};
  s.q = static_cast<const bf16*>(q);
  s.k = static_cast<const bf16*>(k);
  s.v = static_cast<const bf16*>(v);
  s.o = static_cast<bf16*>(o);
  s.lse = static_cast<float*>(lse);
  s.q_sb = st[0]; s.q_ss = st[1];
  s.k_sb = st[2]; s.k_ss = st[3];
  s.v_sb = st[4]; s.v_ss = st[5];
  s.o_sb = st[6]; s.o_ss = st[7];
  s.q_sh = s.k_sh = s.v_sh = s.o_sh = head_dim;
  s.len = s.kv_len = len;
  s.wq = static_cast<const float*>(wq);
  s.wk = static_cast<const float*>(wk);
  return s;
}

}  // namespace

// q/k/v/o of each stream: bf16 (B, S, H*D), D = head_dim (64 or 128), with
// unit stride along the last dim. strides: 16 host int64s, the (batch, row)
// strides of q, k, v, o of the image stream and then of the text stream.
// lse_img / lse_txt: contiguous fp32 (B, H, S) outputs of the natural-log
// log-sum-exp per row, or null. The four RMS weights are fp32 (D,) device
// pointers, all null for no qk-norm. qscale = sm_scale * log2(e). Returns
// cudaGetLastError() (cudaErrorInvalidValue for another head_dim).
extern "C" int joint_attention_fwd_bf16(const void* q_img, const void* k_img,
                                        const void* v_img, void* o_img, void* lse_img,
                                        int s_img, const void* q_txt, const void* k_txt,
                                        const void* v_txt, void* o_txt, void* lse_txt,
                                        int s_txt, const long long* strides,
                                        const void* wq_img, const void* wk_img,
                                        const void* wq_txt, const void* wk_txt, int batch,
                                        int num_heads, int head_dim, float qscale, float eps,
                                        void* stream) {
  const Stream img = bshd_stream(q_img, k_img, v_img, o_img, lse_img, s_img, strides, head_dim,
                                 wq_img, wk_img);
  const Stream txt = bshd_stream(q_txt, k_txt, v_txt, o_txt, lse_txt, s_txt, strides + 8,
                                 head_dim, wq_txt, wk_txt);
  return launch_fwd_dim<false>(head_dim, img, txt, batch, num_heads, qscale, eps, stream);
}

// Single-stream attention with qk-RMS (SD3.5's dual self-attention): the
// same kernel with no second stream. strides: 8 host int64s for q, k, v, o.
extern "C" int mha_rms_fwd_bf16(const void* q, const void* k, const void* v, void* o,
                                void* lse, int s, const long long* strides, const void* wq,
                                const void* wk, int batch, int num_heads, int head_dim,
                                float qscale, float eps, void* stream) {
  const Stream img = bshd_stream(q, k, v, o, lse, s, strides, head_dim, wq, wk);
  return launch_fwd_dim<false>(head_dim, img, empty_stream(), batch, num_heads, qscale, eps,
                              stream);
}

// Bidirectional multi-head attention read in place through strides.
//
// Replaces: adv_grpo_tpu/ops/attention.py `_bshd_fwd_kernel` (called through
// `_bshd_fwd`, public `mha_bshd`), the attention of Flux's single blocks
// (38 per Flux.1-dev forward over the [text ; image] sequence, 24 heads of
// 128) and of WAN. Like the TPU kernel it masks keys at or past `kv_len`
// and can write the per-row lse; unlike it, it needs no zero padding of S to
// a block multiple: ragged q rows and kv columns are masked in the kernel.
// Every stride of q, k, v and o is an argument — batch, row and head — so the
// (B, H, S, D) layout of the TPU's `mha` (`_fwd_kernel`) is the same kernel
// with row stride D and head stride S*D (`mha_fwd_bf16` below).
//
// q, o: bf16 with `sq` rows; k, v: bf16 with `skv` rows; unit stride along
// the head's D = head_dim (64 or 128) columns. strides: 12 host int64s, the
// (batch, row, head) strides of q, k, v, o. Keys at rows >= kv_len (1 <=
// kv_len <= skv) are masked. lse: contiguous fp32 (B, H, sq), or null.
// qscale = sm_scale * log2(e). Returns cudaGetLastError()
// (cudaErrorInvalidValue for another head_dim).
extern "C" int mha_bshd_fwd_bf16(const void* q, const void* k, const void* v, void* o,
                                 void* lse, int sq, int kv_len, const long long* strides,
                                 int batch, int num_heads, int head_dim, float qscale,
                                 void* stream) {
  Stream s{};
  s.q = static_cast<const bf16*>(q);
  s.k = static_cast<const bf16*>(k);
  s.v = static_cast<const bf16*>(v);
  s.o = static_cast<bf16*>(o);
  s.lse = static_cast<float*>(lse);
  s.q_sb = strides[0]; s.q_ss = strides[1]; s.q_sh = strides[2];
  s.k_sb = strides[3]; s.k_ss = strides[4]; s.k_sh = strides[5];
  s.v_sb = strides[6]; s.v_ss = strides[7]; s.v_sh = strides[8];
  s.o_sb = strides[9]; s.o_ss = strides[10]; s.o_sh = strides[11];
  s.len = sq;
  s.kv_len = kv_len;
  return launch_fwd_dim<true>(head_dim, s, empty_stream(), batch, num_heads, qscale, 0.f,
                              stream);
}

// Bidirectional multi-head attention on contiguous (B, H, S, D) tensors.
//
// Replaces: adv_grpo_tpu/ops/attention.py `_fwd_kernel` (called through
// `_flash_fwd`, behind the custom VJP `_flash_mha` and the public `mha`),
// which `context_parallel_attention` runs on the all-gathered keys and values
// of its sequence shards. On the TPU `_fwd_kernel` and `_bshd_fwd_kernel` are
// two bodies only because Mosaic tiles the last dimension by 128 lanes, so
// the (B, S, H*D) layout needs head groups of 128 columns; here layout is
// strides, and this entry point is `mha_bshd_fwd_bf16`'s kernel with BHSD
// strides: batch H*S*D, head S*D, row D. Same numerics as the TPU kernel:
// fp32 scores x sm_scale, keys at or past kv_len masked, p cast to bf16 for
// p.v, o = acc / l, lse = m + log(max(l, 1e-37)).
//
// Bound on this card: tensor-core math (4*B*H*S_q*S_kv*D FLOP against
// 2*B*H*(S_q + S_kv)*D bf16 values: at WAN's 12 heads of 128 and 8,100
// tokens, 403 GFLOP against 100 MB, over 4,000 flop/byte).
//
// q, o: bf16 (B, H, sq, D); k, v: bf16 (B, H, skv, D); D = head_dim (64 or
// 128). Keys at rows >= kv_len (1 <= kv_len <= skv) are masked. lse:
// contiguous fp32 (B, H, sq), or null. qscale = sm_scale * log2(e). Returns
// cudaGetLastError() (cudaErrorInvalidValue for another head_dim).
extern "C" int mha_fwd_bf16(const void* q, const void* k, const void* v, void* o, void* lse,
                            int sq, int skv, int kv_len, int batch, int num_heads, int head_dim,
                            float qscale, void* stream) {
  const long long hq = static_cast<long long>(sq) * head_dim;    // head stride of q, o
  const long long hkv = static_cast<long long>(skv) * head_dim;  // of k, v
  Stream s{};
  s.q = static_cast<const bf16*>(q);
  s.k = static_cast<const bf16*>(k);
  s.v = static_cast<const bf16*>(v);
  s.o = static_cast<bf16*>(o);
  s.lse = static_cast<float*>(lse);
  s.q_sb = s.o_sb = num_heads * hq;
  s.k_sb = s.v_sb = num_heads * hkv;
  s.q_sh = s.o_sh = hq;
  s.k_sh = s.v_sh = hkv;
  s.q_ss = s.k_ss = s.v_ss = s.o_ss = head_dim;
  s.len = sq;
  s.kv_len = kv_len;
  return launch_fwd_dim<true>(head_dim, s, empty_stream(), batch, num_heads, qscale, 0.f,
                              stream);
}
