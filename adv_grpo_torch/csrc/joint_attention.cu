// Joint image+text attention with optional fused per-head qk-RMS, forward,
// for Hopper (sm_90a). Two entry points on the forward core of
// attention_fwd.cuh, compiled once here: `joint_attention_fwd_bf16` (two
// token streams) and `mha_rms_fwd_bf16` (one stream). Each can also write the
// per-row log-sum-exp the backward (joint_attention_bwd.cu) needs. Both
// pre-scale q, as the TPU's joint kernels do. The plain multi-head forwards
// `mha_bshd_fwd_bf16` and `mha_fwd_bf16` are in attention_fwd_sm90.cu.
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
  return launch_fwd_dim(head_dim, img, txt, batch, num_heads, qscale, eps, stream);
}

// Single-stream attention with qk-RMS (SD3.5's dual self-attention): the
// same kernel with no second stream. strides: 8 host int64s for q, k, v, o.
extern "C" int mha_rms_fwd_bf16(const void* q, const void* k, const void* v, void* o,
                                void* lse, int s, const long long* strides, const void* wq,
                                const void* wk, int batch, int num_heads, int head_dim,
                                float qscale, float eps, void* stream) {
  const Stream img = bshd_stream(q, k, v, o, lse, s, strides, head_dim, wq, wk);
  return launch_fwd_dim(head_dim, img, empty_stream(), batch, num_heads, qscale, eps, stream);
}
