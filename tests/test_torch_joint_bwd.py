"""The joint attention backward's kernel-order twin against the JAX kernels.

``attention_bwd_reference`` (adv_grpo_torch/ops/joint_attention.py), the CPU
path of ``joint_attention_bwd`` and ``mha_rms_bwd``, is the plain twin of the
card's joint backward (#4, and #5 with one stream): from q, k, v, do and the
forward's lse and di it gives the cotangents of the normalised q and k and of
v per stream, rounding where the kernel rounds. Here it is held on the CPU
against the TPU's ``_joint_bwd_fused`` and ``_single_bwd_fused`` bodies, run
by the Pallas interpreter with the RMS weights tiled by ``_tile_w2``, on the
same inputs, lse and di drawn from a seed with numpy. The text stream goes to
the JAX body as ``_joint_mha_p_bwd`` hands it over: zero-padded to a multiple
of 8, with ``t_valid`` masking the padded keys; the padded rows, which the
port never forms, are sliced off.

Bounds: fp32 against fp32, 1e-4 relative and absolute (the two differ only
in summation order and in the RMS's 1 / sqrt: the twin takes the kernels'
fixed-order sum of squares and a correctly rounded 1 / sqrt, the TPU body
rsqrt of the mean). In bf16 both round q^, k^, q_s, p and t to bf16 at the
same places; a last-bit difference of the fp32 values before a rounding
(the RMS's order, the products' sum order) flips it now and then, and at d =
128 the TPU rounds dq's k operand once more (bf16(k^ * sm_scale), ROADMAP
Queue 3): each cotangent stays within one bf16 spacing in relative L2 (2^-8)
of the TPU body's.

The operands: ``joint_operands`` (from which both twins, forward and
backward, take q^ and k^) against the kernels' arithmetic written out here
in numpy, bit for bit; and with them the forward twin's lse makes every row
of the backward's p sum to one.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adv_grpo_torch.ops import attention as t_attention
from adv_grpo_torch.ops import joint_attention as t_attn
from adv_grpo_tpu.ops import joint_attention as j_attn
from adv_grpo_tpu.ops.attention import LSE_LANES

EPS = 1e-6
H = 2
S_IMG = 96  # a multiple of 8 (the JAX body's whole-tile geometry), not of 64
TOL_FP32 = 1e-4
TOL_BF16 = 2.0 ** -8
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(seed, b, s_i, s_t, d, dtype):
    """q, k, v of both streams, do per stream (numpy fp32 of values in
    ``dtype``), the RMS weights, and the lse and di of the fp32 plain forward
    on those values."""
    rng = np.random.default_rng(seed)
    tdt = DTYPES[dtype][1]

    def draw(s):
        return torch.from_numpy(rng.standard_normal((b, s, H * d)).astype(np.float32)).to(tdt)

    streams = [draw(s) for s in (s_i, s_i, s_i, s_t, s_t, s_t)]
    dos = [draw(s_i), draw(s_t)]
    weights = [torch.from_numpy((1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32))
               for _ in range(4)]
    f32 = [t.float() for t in streams]
    oi, ot, lse_i, lse_t = t_attn.joint_mha_reference(*f32, num_heads=H, rms_weights=weights,
                                                      return_lse=True)
    dis = [t_attention.bwd_row_stats(o, do.float(), H) for o, do in ((oi, dos[0]), (ot, dos[1]))]
    return streams, dos, weights, [lse_i, lse_t], dis


def _lanes(a):
    """(B, H, S) -> the TPU layout's lane-broadcast (B, H, S, LSE_LANES)."""
    a = jnp.asarray(a.numpy())
    return jnp.broadcast_to(a[..., None], a.shape + (LSE_LANES,))


def _jax(t, jdt):
    return jnp.asarray(t.float().numpy(), jdt)


def _close(got, want, dtype):
    g = got.float().numpy()
    w = np.asarray(jnp.asarray(want, jnp.float32))
    assert g.shape == w.shape
    if dtype == "float32":
        np.testing.assert_allclose(g, w, rtol=TOL_FP32, atol=TOL_FP32)
    else:
        rel = np.linalg.norm(g - w) / np.linalg.norm(w)
        assert rel <= TOL_BF16, rel


# SD3.5-M's head width with the fused qk-RMS and Flux's without it (and each
# the other way), a text stream of 40 tokens (a multiple of 8) and of 37
# (zero-padded to 40, t_valid = 37)
JOINT_CASES = [(d, use_rms, s_t) for d, use_rms in [(64, True), (128, False), (64, False),
                                                      (128, True)]
               for s_t in (40, 37)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d,use_rms,s_t", JOINT_CASES)
def test_twin_matches_jax_joint_bwd_body(d, use_rms, s_t, dtype):
    streams, dos, weights, lses, dis = _inputs(d + s_t, 2, S_IMG, s_t, d, dtype)
    jdt = DTYPES[dtype][0]
    q_i, k_i, v_i, q_t, k_t, v_t = (_jax(a, jdt) for a in streams)
    do_i, do_t = (_jax(a, jdt) for a in dos)
    lse_t, di_t = lses[1], dis[1]
    pad = -s_t % 8
    if pad:  # as _joint_mha_p_bwd gets the text stream from the forward
        q_t, k_t, v_t, do_t = (jnp.pad(a, ((0, 0), (0, pad), (0, 0)))
                               for a in (q_t, k_t, v_t, do_t))
        lse_t, di_t = (torch.nn.functional.pad(a, (0, pad)) for a in (lse_t, di_t))
    w = [jnp.asarray(a.numpy()) if use_rms else jnp.ones((d,), jnp.float32) for a in weights]
    hpb = 128 // d
    want = j_attn._joint_bwd_fused(
        q_i, k_i, v_i, q_t, k_t, v_t, j_attn._tile_w2(w[0], w[2], hpb),
        j_attn._tile_w2(w[1], w[3], hpb), do_i, do_t, _lanes(lses[0]), _lanes(lse_t),
        _lanes(dis[0]), _lanes(di_t), H, d ** -0.5, EPS, use_rms, True,
        s_t if pad else None)
    want = list(want[:3]) + [a[:, :s_t] for a in want[3:]]

    n0 = t_attn.joint_attention_bwd.launches
    got = t_attn.joint_attention_bwd(*streams, *dos, *lses, *dis, num_heads=H,
                                     rms_weights=weights if use_rms else None, eps=EPS)
    assert t_attn.joint_attention_bwd.launches == n0  # the CPU path launches nothing
    for g, w_ in zip(got, want):  # dyq, dyk, dv of the image stream, then the text
        assert g.dtype == DTYPES[dtype][1]
        _close(g, w_, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d,use_rms", [(64, True), (64, False), (128, False), (128, True)])
def test_twin_matches_jax_single_bwd_body(d, use_rms, dtype):
    """The single-stream form (#5) against ``_single_bwd_fused`` over 136
    tokens (a multiple of 8; two 64-row q tiles and eight rows of a third)."""
    streams, dos, weights, lses, dis = _inputs(3 + d, 2, 136, 1, d, dtype)
    jdt = DTYPES[dtype][0]
    q, k, v = (_jax(a, jdt) for a in streams[:3])
    w = [jnp.asarray(a.numpy()) if use_rms else jnp.ones((d,), jnp.float32)
         for a in weights[:2]]
    hpb = 128 // d
    o, lse = t_attn.mha_rms_reference(*(t.float() for t in streams[:3]), num_heads=H,
                                      rms_weights=weights[:2], return_lse=True)
    di = t_attention.bwd_row_stats(o, dos[0].float(), H)
    want = j_attn._single_bwd_fused(q, k, v, jnp.tile(w[0], hpb)[None],
                                    jnp.tile(w[1], hpb)[None], _jax(dos[0], jdt), _lanes(lse),
                                    _lanes(di), H, d ** -0.5, EPS, use_rms, True)
    n0 = t_attn.mha_rms_bwd.launches
    got = t_attn.mha_rms_bwd(*streams[:3], dos[0], lse, di, num_heads=H,
                             rms_weights=weights[:2] if use_rms else None, eps=EPS)
    assert t_attn.mha_rms_bwd.launches == n0
    for g, w_ in zip(got, want):
        _close(g, w_, dtype)


def _bf16(a):
    """numpy fp32 rounded to bf16 (round to nearest even), as fp32."""
    return torch.from_numpy(np.ascontiguousarray(a)).to(torch.bfloat16).float().numpy()


def _kernel_operand(x, w, d, halves, scale):
    """The kernels' arithmetic (csrc/sm90.cuh ``sum_sq``, ``rms_scale``,
    ``scale_chunk``) on (B, S, H*D) values, written out in numpy fp32: each
    8-column chunk's squares summed in column order; a q row's chunks c % 8 <
    4 and the others summed apart and then added, a k row's in chunk order;
    1 / sqrt(ss * (1 / D) + eps), each step rounded once; then bf16(x * rs *
    w * scale). Returns (B, H, S, D)."""
    b, s, hd = x.shape
    x = x.reshape(b, s, hd // d, d).transpose(0, 2, 1, 3).astype(np.float32)
    if w is None:
        return _bf16(x * np.float32(scale))
    sq = (x * x).reshape(b, hd // d, s, d // 8, 8)
    chunk = sq[..., 0]
    for e in range(1, 8):
        chunk = chunk + sq[..., e]
    groups = ([[c for c in range(d // 8) if c % 8 < 4], [c for c in range(d // 8) if c % 8 >= 4]]
              if halves else [list(range(d // 8))])
    sums = []
    for g in groups:
        ss = chunk[..., g[0]]
        for c in g[1:]:
            ss = ss + chunk[..., c]
        sums.append(ss)
    ss = sums[0] if len(sums) == 1 else sums[0] + sums[1]
    rs = np.float32(1.0) / np.sqrt(ss * np.float32(1.0 / d) + np.float32(EPS))
    y = x * rs[..., None] * w.astype(np.float32)
    return _bf16(y if scale is None else y * np.float32(scale))


@pytest.mark.parametrize("d,use_rms", [(64, True), (128, True), (64, False), (128, False)])
def test_joint_operands_are_the_kernels_bit_for_bit(d, use_rms):
    """q^, q_s and k^ of ``joint_operands`` (which the forward twin also
    takes its q^ and k^ from) against the kernels' arithmetic in numpy, bit
    for bit, on bf16 inputs of both streams."""
    streams, _, weights, _, _ = _inputs(11 + d, 2, S_IMG, 37, d, "bfloat16")
    pairs = [(weights[0], weights[1]), (weights[2], weights[3])] if use_rms else None
    ops = t_attn.joint_operands(streams[0::3], streams[1::3], num_heads=H, rms_weights=pairs,
                                eps=EPS)
    qscale = d ** -0.5 * t_attention.LOG2E
    for i, (q_hat, q_s, k_hat) in enumerate(ops):
        q, k = (streams[3 * i + j].float().numpy() for j in (0, 1))
        wq, wk = (weights[2 * i + j].numpy() if use_rms else None for j in (0, 1))
        np.testing.assert_array_equal(q_hat.numpy(), _kernel_operand(q, wq, d, True, qscale))
        np.testing.assert_array_equal(q_s.numpy(), _kernel_operand(q, wq, d, True, d ** -0.5))
        want_k = (_kernel_operand(k, wk, d, False, None) if use_rms
                  else k.reshape(2, -1, H, d).transpose(0, 2, 1, 3))
        np.testing.assert_array_equal(k_hat.numpy(), want_k)


@pytest.mark.parametrize("d,use_rms", [(64, True), (128, False)])
def test_backward_p_is_the_forwards(d, use_rms):
    """bf16 inputs: with the forward twin's lse, the backward's p = exp2(q^
    k^T - lse * log2 e) over its operands sums to one in every row of both
    streams, within fp32 rounding (1e-5): the scores the backward recomputes
    are the ones the forward's lse was taken over."""
    streams, _, weights, _, _ = _inputs(5 + d, 2, S_IMG, 37, d, "bfloat16")
    pairs = [(weights[0], weights[1]), (weights[2], weights[3])] if use_rms else None
    _, lses = t_attn.joint_fwd_tiled_reference(streams[0::3], streams[1::3], streams[2::3],
                                               num_heads=H, rms_weights=pairs, eps=EPS)
    ops = t_attn.joint_operands(streams[0::3], streams[1::3], num_heads=H, rms_weights=pairs,
                                eps=EPS)
    q_hat = torch.cat([o[0] for o in ops], dim=2)
    k_hat = torch.cat([o[2] for o in ops], dim=2)
    lse2 = torch.cat(lses, dim=-1)[..., None] * t_attention.LOG2E
    rows = torch.exp2(q_hat @ k_hat.transpose(-1, -2) - lse2).sum(-1)
    torch.testing.assert_close(rows, torch.ones_like(rows), rtol=0, atol=1e-5)
