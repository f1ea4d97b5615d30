"""The plain twins the generic attention kernels follow, single-stream,
BSHD and BHSD, against the TPU kernels in the Pallas interpreter at d = 16
and 32 (tests/test_torch_kernel_range.py holds the route, the joint twins at
both widths in both dtypes and the rest; the two files run on two workers).
Each width and each dtype once per layout here, since every such
comparison compiles its own interpreted kernels: the single stream bf16 at
16 and fp32 at 32, BSHD the other way round, BHSD at 16 in both (32 in fp32
is tests/test_torch_flash.py's).

``attention_bwd_reference`` (one stream), ``bshd_bwd_reference`` and
``flash_bwd_reference`` are the order the generic kernels
(csrc/attention_generic_{fwd,bwd}.cu) compute in; the card holds the kernels
to them (chip_smoke.py ``run_kernel_range_slice``, tests/test_torch_cuda.py).
Bounds as in tests/test_torch_kernel_range.py; the BSHD and BHSD backwards in
bf16 within 2 bf16 spacings in relative L2 (2^-7): the TPU's split bodies
keep p and t in fp32 where ``bshd_bwd_reference`` rounds them to bf16, and
the BHSD ones round them where ``flash_bwd_reference`` does not.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adv_grpo_torch.ops import attention as t_mha
from adv_grpo_torch.ops import joint_attention as t_attn
from adv_grpo_tpu.ops import attention as j_mha
from adv_grpo_tpu.ops import joint_attention as j_attn
from tests.test_torch_kernel_range import (
    DTYPES, EPS, TOL_BF16_BWD, TOL_BF16_LSE, TOL_BF16_O, TOL_FP32, _close, _draw, _lanes)


@pytest.mark.parametrize("d,h,dtype", [(16, 8, "bfloat16"), (32, 4, "float32")])
def test_single_stream_twins_match_the_tpu_single_kernels(d, h, dtype):
    """The single-stream (``mha_rms``) twins with the fused qk-RMS against
    ``_mha_rms_p_fwd`` / ``_single_bwd_fused`` over 40 tokens."""
    jdt, tdt = DTYPES[dtype]
    s, b = 40, 1
    arrs, rng = _draw(3 * d + h, [(b, s, h * d)] * 4, dtype)
    w = [(1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32) for _ in range(2)]
    t = [torch.from_numpy(a).to(tdt) for a in arrs]
    tw = [torch.from_numpy(a) for a in w]
    (o,), (lse,) = t_attn.joint_fwd_tiled_reference([t[0]], [t[1]], [t[2]], num_heads=h,
                                                    rms_weights=[tuple(tw)], eps=EPS)
    j = [jnp.asarray(a, jdt) for a in arrs]
    want_o, res = j_attn._mha_rms_p_fwd(j[0], j[1], j[2], *map(jnp.asarray, w), h, d ** -0.5,
                                        EPS, True, True)
    fwd_tol = (TOL_FP32, TOL_FP32) if dtype == "float32" else (TOL_BF16_O, TOL_BF16_LSE)
    _close(o.float().numpy(), want_o, fwd_tol[0], dtype, "o")
    _close(lse.numpy(), res[-1], fwd_tol[1], dtype, "lse")

    ro, rl = t_attn.mha_rms_reference(*(a.float() for a in t[:3]), num_heads=h,
                                      rms_weights=tw, return_lse=True)
    di = t_mha.bwd_row_stats(ro, t[3].float(), h)
    got = t_attn.attention_bwd_reference([t[0]], [t[1]], [t[2]], [t[3]], [rl], [di],
                                         num_heads=h, rms_weights=[tuple(tw)], eps=EPS)[0]
    want = j_attn._single_bwd_fused(j[0], j[1], j[2], jnp.tile(jnp.asarray(w[0]), h)[None],
                                    jnp.tile(jnp.asarray(w[1]), h)[None], j[3], _lanes(rl),
                                    _lanes(di), h, d ** -0.5, EPS, True, True)
    bwd_tol = TOL_FP32 if dtype == "float32" else TOL_BF16_BWD
    for g_, w_ in zip(got, want):
        _close(g_.float().numpy(), w_, bwd_tol, dtype, "bwd")


@pytest.mark.parametrize("d,h,dtype", [(16, 8, "float32"), (32, 4, "bfloat16")])
def test_bshd_twins_match_the_tpu_bshd_kernels(d, h, dtype):
    """``mha_bshd``'s plain forward and its backward twin
    (``bshd_bwd_reference``, p and t rounded to the inputs' dtype) against
    the JAX ``mha_bshd`` with its split bodies in the interpreter: 16 queries
    against 32 keys, keys past 27 masked."""
    jdt, tdt = DTYPES[dtype]
    b, sq, skv, kv_len = 1, 16, 32, 27
    arrs, _ = _draw(5 * d + h, [(b, sq, h * d), (b, skv, h * d), (b, skv, h * d),
                                (b, sq, h * d)], dtype)
    q, k, v, do = (torch.from_numpy(a).to(tdt) for a in arrs)

    def f(q_, k_, v_):
        return j_mha.mha_bshd(q_, k_, v_, num_heads=h, kv_len=kv_len, block_q=16, block_kv=16,
                              backend="pallas_interpret")

    o, vjp = jax.vjp(f, *(jnp.asarray(a, jdt) for a in arrs[:3]))
    want = [o] + list(vjp(jnp.asarray(arrs[3], jdt)))
    got_o, lse = t_mha.mha_bshd_reference(q.float(), k.float(), v.float(), num_heads=h,
                                          kv_len=kv_len, return_lse=True)
    _close(got_o.to(tdt).float().numpy(), want[0],
           TOL_FP32 if dtype == "float32" else TOL_BF16_O, dtype, "o")
    di = t_mha.bwd_row_stats(got_o.to(tdt), do.float(), h)
    grads = t_mha.bshd_bwd_reference(q, k, v, do, lse, di, num_heads=h, kv_len=kv_len)
    for g_, w_ in zip(grads, want[1:]):
        assert g_.dtype == tdt
        _close(g_.float().numpy(), w_, TOL_FP32 if dtype == "float32" else 2 * TOL_BF16_BWD,
               dtype, "bwd")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bhsd_twins_match_the_tpu_mha_kernels_at_d16(dtype):
    """``mha`` on (B, H, S, D) at d = 16 (tests/test_torch_flash.py holds d =
    32 and up in fp32): the plain forward and the all-fp32 backward twin
    (``flash_bwd_reference``) against the JAX ``mha`` in the interpreter,
    keys past 50 masked."""
    jdt, tdt = DTYPES[dtype]
    b, h, sq, skv, d, kv_len = 1, 2, 40, 64, 16, 50
    arrs, _ = _draw(7, [(b, h, sq, d), (b, h, skv, d), (b, h, skv, d), (b, h, sq, d)], dtype)

    def f(q_, k_, v_):
        return j_mha.mha(q_, k_, v_, kv_len=kv_len, backend="pallas_interpret")

    o, vjp = jax.vjp(f, *(jnp.asarray(a, jdt) for a in arrs[:3]))
    want = [o] + list(vjp(jnp.asarray(arrs[3], jdt)))
    leaves = [torch.from_numpy(a).to(tdt).requires_grad_() for a in arrs[:3]]
    out = t_mha.mha(*leaves, kv_len=kv_len)
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(arrs[3]).to(tdt))
    _close(out.detach().float().numpy(), want[0],
           TOL_FP32 if dtype == "float32" else TOL_BF16_O, dtype, "o")
    for g_, w_ in zip(grads, want[1:]):
        _close(g_.float().numpy(), w_, TOL_FP32 if dtype == "float32" else 2 * TOL_BF16_BWD,
               dtype, "bwd")
