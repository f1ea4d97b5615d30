"""The joint attention forward's kernel-order twin against the JAX kernels.

``joint_fwd_tiled_reference`` (adv_grpo_torch/ops/joint_attention.py) is the
plain twin of the card's joint forward (#2, and #3 with one stream): it
rounds q^ and k^ where the kernel does, walks 128-row kv tiles of the image
stream and then of the text stream with an online base-2 softmax, and casts
p to the inputs' dtype for p.v. Here it is held on the CPU against the TPU's
``_joint_fwd_kernel`` and ``_single_fwd_kernel``, run by the Pallas
interpreter through the JAX custom-VJP forward rules (which also return the
lse the backward consumes), on the same inputs drawn from a seed with numpy.

Bounds: fp32 against fp32, 1e-4 absolute on the output and the lse (the two
differ only in summation order and in the online rescaling, ~1e-6). In bf16
the twin and the TPU kernel round q^, k^ and p at the same places, but the
TPU kernel casts p = exp2(s - m) with the row's final max and the twin with
the running max, and each rounds o once: the outputs lie within 2 bf16
spacings of an output of magnitude <= 1 (2 * 2^-8 = 7.8125e-3), the lse
within 1e-3 (fp32 throughout, from bf16 operands).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adv_grpo_torch.ops import joint_attention as t_attn
from adv_grpo_tpu.ops import joint_attention as j_attn

TOL_FP32 = 1e-4
TOL_BF16_O = 2 * 2.0 ** -8
TOL_BF16_LSE = 1e-3
EPS = 1e-6


def _inputs(seed, b, s_i, s_t, h, d):
    rng = np.random.default_rng(seed)
    streams = [rng.standard_normal((b, s, h * d)).astype(np.float32)
               for s in (s_i, s_i, s_i, s_t, s_t, s_t)]
    weights = [(1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32) for _ in range(4)]
    return streams, weights


def _jax_joint(streams, weights, h, d, use_rms, dtype):
    """The TPU joint kernel in interpret mode: (o_img, o_txt, lse_img,
    lse_txt), the text stream zero-padded to a multiple of 8 and its padded
    columns masked, as ``joint_mha`` does."""
    q_i, k_i, v_i, q_t, k_t, v_t = (jnp.asarray(a, dtype) for a in streams)
    s_t = q_t.shape[1]
    pad = -s_t % 8
    if pad:
        q_t, k_t, v_t = (jnp.pad(a, ((0, 0), (0, pad), (0, 0))) for a in (q_t, k_t, v_t))
    w = [jnp.asarray(a) if use_rms else jnp.ones((d,), jnp.float32) for a in weights]
    (o_i, o_t), res = j_attn._joint_mha_p_fwd(
        q_i, k_i, v_i, q_t, k_t, v_t, *w, h, d ** -0.5, EPS, use_rms, True,
        s_t if pad else None)
    lse_i, lse_t = res[12], res[13]
    return o_i, o_t[:, :s_t], lse_i, lse_t[..., :s_t]


def _twin(streams, weights, h, use_rms, dtype):
    t = [torch.from_numpy(a).to(dtype) for a in streams]
    w = [torch.from_numpy(a) for a in weights]
    pairs = [(w[0], w[1]), (w[2], w[3])] if use_rms else None
    (o_i, o_t), (lse_i, lse_t) = t_attn.joint_fwd_tiled_reference(
        t[0::3], t[1::3], t[2::3], num_heads=h, rms_weights=pairs, eps=EPS)
    return o_i, o_t, lse_i, lse_t


def _close(got, want, atol):
    g = got.float().numpy()
    w = np.asarray(jnp.asarray(want, jnp.float32))
    assert g.shape == w.shape
    np.testing.assert_allclose(g, w, rtol=0, atol=atol)


# SD3.5-M's head width with the fused qk-RMS and Flux's without it (and each
# the other way), over a 256-token image stream (two kv tiles) and a ragged
# text stream: 37 tokens (one partial tile) and SD3's 154 (a full tile and 26
# columns of the next)
JOINT_CASES = [(d, use_rms, s_t) for d, use_rms in [(64, True), (128, False), (64, False),
                                                      (128, True)]
               for s_t in (37, 154)]


@pytest.mark.parametrize("d,use_rms,s_t", JOINT_CASES)
def test_twin_matches_jax_joint_kernel_fp32(d, use_rms, s_t):
    streams, weights = _inputs(d + s_t, 2, 256, s_t, 2, d)
    got = _twin(streams, weights, 2, use_rms, torch.float32)
    want = _jax_joint(streams, weights, 2, d, use_rms, jnp.float32)
    for g, w in zip(got, want):
        _close(g, w, TOL_FP32)


@pytest.mark.parametrize("d,use_rms,s_t", [(64, True, 154), (128, False, 37)])
def test_twin_matches_jax_joint_kernel_bf16(d, use_rms, s_t):
    streams, weights = _inputs(7 + d, 2, 256, s_t, 2, d)
    o_i, o_t, lse_i, lse_t = _twin(streams, weights, 2, use_rms, torch.bfloat16)
    assert o_i.dtype == torch.bfloat16 and lse_i.dtype == torch.float32
    w_oi, w_ot, w_li, w_lt = _jax_joint(streams, weights, 2, d, use_rms, jnp.bfloat16)
    _close(o_i, w_oi, TOL_BF16_O)
    _close(o_t, w_ot, TOL_BF16_O)
    _close(lse_i, w_li, TOL_BF16_LSE)
    _close(lse_t, w_lt, TOL_BF16_LSE)


@pytest.mark.parametrize("d,use_rms,s", [(64, True, 256), (64, True, 200), (128, False, 200),
                                         (64, False, 136)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_single_stream_twin_matches_jax_single_kernel(d, use_rms, s, dtype):
    """The single-stream form (#3): one stream through the same twin against
    ``_single_fwd_kernel`` (S a multiple of 8, so the JAX path is the kernel;
    200 and 136 end inside the second kv tile)."""
    streams, weights = _inputs(3 + s, 2, s, 1, 2, d)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16,
                                                                         torch.bfloat16)
    q, k, v = (jnp.asarray(a, jdt) for a in streams[:3])
    w = [jnp.asarray(a) if use_rms else jnp.ones((d,), jnp.float32) for a in weights[:2]]
    want_o, res = j_attn._mha_rms_p_fwd(q, k, v, *w, 2, d ** -0.5, EPS, use_rms, True)
    tw = [torch.from_numpy(a) for a in weights[:2]]
    (o,), (lse,) = t_attn.joint_fwd_tiled_reference(
        [torch.from_numpy(streams[0]).to(tdt)], [torch.from_numpy(streams[1]).to(tdt)],
        [torch.from_numpy(streams[2]).to(tdt)], num_heads=2,
        rms_weights=[tuple(tw)] if use_rms else None, eps=EPS)
    o_tol, lse_tol = (TOL_FP32, TOL_FP32) if dtype == "float32" else (TOL_BF16_O, TOL_BF16_LSE)
    _close(o, want_o, o_tol)
    _close(lse, res[-1], lse_tol)


@pytest.mark.parametrize("s_i,s_t", [(1, 1), (127, 129), (300, 0), (129, 257)])
def test_twin_equals_the_plain_version_at_tile_edges(s_i, s_t):
    """At the kernel's tile edges (streams of 1, 127, 129, 257 and 300 tokens,
    an empty text stream) the twin in fp32 is the plain concatenated softmax:
    output and lse within fp32 summation order (1e-5)."""
    torch.manual_seed(s_i + s_t)
    h, d = 2, 64
    qi, ki, vi = (torch.randn(1, s_i, h * d) for _ in range(3))
    qt, kt, vt = (torch.randn(1, s_t, h * d) for _ in range(3))
    w = [1.0 + 0.1 * torch.randn(d) for _ in range(4)]
    (o_i, o_t), (l_i, l_t) = t_attn.joint_fwd_tiled_reference(
        [qi, qt], [ki, kt], [vi, vt], num_heads=h, rms_weights=[(w[0], w[1]), (w[2], w[3])])
    r_i, r_t, rl_i, rl_t = t_attn.joint_mha_reference(qi, ki, vi, qt, kt, vt, num_heads=h,
                                                      rms_weights=w, return_lse=True)
    for g, r in ((o_i, r_i), (o_t, r_t), (l_i, rl_i), (l_t, rl_t)):
        assert g.shape == r.shape
        torch.testing.assert_close(g, r, rtol=0, atol=1e-5)
