"""Gradients of the port's ops against ``jax.grad`` of the JAX package's.

The same numpy inputs and output cotangents go through the JAX function (at
``backend="reference"`` and ``"pallas_interpret"``, where the TPU backward
kernels run in the Pallas interpreter) and through the port's autograd
Functions on CPU tensors, where the forward and the backward-kernel twin run
as plain PyTorch in the TPU kernel's op order. fp32 throughout.

Tolerance for attention: rtol = atol = 2e-3, the bound the JAX package's own
interpret-vs-reference gradient tests use (tests/test_joint_attention.py:66);
the norms' closed forms agree to fp32 summation order (1e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adv_grpo_torch.ops import attention as t_attention
from adv_grpo_torch.ops import fused_norms as t_norms
from adv_grpo_torch.ops import joint_attention as t_attn
from adv_grpo_tpu.ops import attention as j_attention
from adv_grpo_tpu.ops import fused_norms as j_norms
from adv_grpo_tpu.ops import joint_attention as j_attn

BACKENDS = ["reference", "pallas_interpret"]
TOL = 2e-3


def _np(rng, *shape, scale=0.5):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _torch_grads(fn, arrays, cots):
    leaves = [torch.from_numpy(a).requires_grad_() for a in arrays]
    outs = fn(*leaves)
    outs = outs if isinstance(outs, tuple) else (outs,)
    return torch.autograd.grad(outs, leaves, [torch.from_numpy(c) for c in cots])


def _jax_grads(fn, arrays, cots):
    def loss(*args):
        outs = fn(*args)
        outs = outs if isinstance(outs, tuple) else (outs,)
        return sum(jnp.sum(o * c) for o, c in zip(outs, cots))

    grad = jax.jit(jax.grad(loss, argnums=tuple(range(len(arrays)))))
    return grad(*map(jnp.asarray, arrays))


def _assert_grads(got, want, tol):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=tol, atol=tol)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("s_t", [12, 10])  # 10: unaligned text, the t_valid path
@pytest.mark.parametrize("use_rms", [True, False])
@pytest.mark.parametrize("h,d", [(4, 32), (2, 64), (1, 128)])  # 128: Flux's heads
def test_joint_mha_grads_match_jax(backend, s_t, use_rms, h, d):
    rng = np.random.default_rng(3)
    b, s_i = 2, 24
    arrays = [_np(rng, b, s_i, h * d) for _ in range(3)] + [_np(rng, b, s_t, h * d)
                                                           for _ in range(3)]
    if use_rms:
        arrays += [1.0 + _np(rng, d, scale=0.1) for _ in range(4)]
    cots = [_np(rng, b, s_i, h * d, scale=1.0), _np(rng, b, s_t, h * d, scale=1.0)]

    def jfn(*a):
        return j_attn.joint_mha(*a[:6], num_heads=h, rms_weights=a[6:] or None,
                                backend=backend)

    def tfn(*a):
        return t_attn.joint_mha(*a[:6], num_heads=h, rms_weights=a[6:] or None)

    _assert_grads(_torch_grads(tfn, arrays, cots), _jax_grads(jfn, arrays, cots), TOL)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("s", [24, 20])  # 20: not 8-aligned, JAX's unfused path
@pytest.mark.parametrize("use_rms", [True, False])
@pytest.mark.parametrize("h,d", [(4, 32), (2, 64)])
def test_mha_rms_grads_match_jax(backend, s, use_rms, h, d):
    rng = np.random.default_rng(4)
    b = 2
    arrays = [_np(rng, b, s, h * d) for _ in range(3)]
    if use_rms:
        arrays += [1.0 + _np(rng, d, scale=0.1) for _ in range(2)]
    cots = [_np(rng, b, s, h * d, scale=1.0)]

    def jfn(*a):
        return j_attn.mha_rms(*a[:3], num_heads=h, rms_weights=a[3:] or None,
                              backend=backend)

    def tfn(*a):
        return t_attn.mha_rms(*a[:3], num_heads=h, rms_weights=a[3:] or None)

    _assert_grads(_torch_grads(tfn, arrays, cots), _jax_grads(jfn, arrays, cots), TOL)


@pytest.mark.parametrize("use_rms", [True, False])
def test_backward_twins_match_autograd_of_the_plain_forward(use_rms):
    """The plain twins of the two backward kernels (from lse and di, in the
    kernel's op order) against torch autograd of the plain forwards: the
    cotangents of the normalised q and k, and of v. fp32: 1e-5."""
    g = torch.Generator().manual_seed(0)
    h, d, b, s_i, s_t = 2, 32, 2, 20, 6
    w = [1.0 + 0.1 * torch.randn(d, generator=g) for _ in range(4)] if use_rms else None
    raw = [torch.randn(b, s, h * d, generator=g) * 0.5 for s in (s_i,) * 3 + (s_t,) * 3]
    # autograd of the plain forward on the normalised q/k gives dyq, dyk
    normed = list(raw)
    if use_rms:
        for i, wi in zip((0, 1, 3, 4), w):
            normed[i] = t_norms.rms_reference(raw[i], wi, h, 1e-6, torch.float32)
    leaves = [t.clone().requires_grad_() for t in normed]
    do = [torch.randn(b, s_i, h * d, generator=g), torch.randn(b, s_t, h * d, generator=g)]

    oi, ot, lse_i, lse_t = t_attn.joint_mha_reference(*raw, num_heads=h, rms_weights=w,
                                                      return_lse=True)
    di = [t_attention.bwd_row_stats(o, c, h) for o, c in zip((oi, ot), do)]
    want = torch.autograd.grad(t_attn.joint_mha_reference(*leaves, num_heads=h), leaves, do)
    got = t_attn.joint_attention_bwd(*raw, *do, lse_i, lse_t, *di, num_heads=h,
                                     rms_weights=w)
    for a, e in zip(got, want):  # dyq, dyk, dv of the image stream, then the text
        torch.testing.assert_close(a, e, rtol=1e-5, atol=1e-5)

    o, lse = t_attn.mha_rms_reference(*raw[:3], num_heads=h,
                                      rms_weights=None if w is None else w[:2],
                                      return_lse=True)
    want = torch.autograd.grad(t_attn.mha_rms_reference(*leaves[:3], num_heads=h),
                               leaves[:3], do[0])
    got = t_attn.mha_rms_bwd(*raw[:3], do[0], lse, t_attention.bwd_row_stats(o, do[0], h),
                             num_heads=h, rms_weights=None if w is None else w[:2])
    for a, e in zip(got, want):
        torch.testing.assert_close(a, e, rtol=1e-5, atol=1e-5)


# (body, S, kv_len, block): the TPU's fused single-pass body (S^2 scores
# under its budget, no blocks given), its split dk/dv + dq bodies (blocks
# given), and the fused body with a kv_len mask
BSHD_BODIES = {"fused": (24, None, None), "split": (32, None, 16), "kv_len": (32, 27, None)}


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("body", list(BSHD_BODIES))
@pytest.mark.parametrize("h,d", [(2, 64), (1, 128)])
def test_mha_bshd_grads_match_jax(backend, body, h, d):
    """``mha_bshd``'s backward (the plain twin of ``mha_bshd_bwd_bf16`` on
    CPU tensors) against ``jax.grad`` of the JAX ``mha_bshd``. With kv_len,
    the rows at or past it are the JAX caller's zero padding: q/k/v zero
    there and a zero output cotangent (the JAX kernels' padded q rows carry a
    non-zero p and rely on it, adv_grpo_tpu/ops/attention.py:523-528)."""
    s, kv_len, block = BSHD_BODIES[body]
    rng = np.random.default_rng(7)
    b = 2
    arrays = [_np(rng, b, s, h * d) for _ in range(3)]
    cots = [_np(rng, b, s, h * d, scale=1.0)]
    if kv_len is not None:
        for a in arrays + cots:
            a[:, kv_len:] = 0.0

    def jfn(q, k, v):
        return j_attention.mha_bshd(q, k, v, num_heads=h, kv_len=kv_len, block_q=block,
                                    block_kv=block, backend=backend)

    def tfn(q, k, v):
        return t_attention.mha_bshd(q, k, v, num_heads=h, kv_len=kv_len)

    got = _torch_grads(tfn, arrays, cots)
    _assert_grads(got, _jax_grads(jfn, arrays, cots), TOL)
    if kv_len is not None:  # masked keys: no gradient reaches them
        assert not got[1][:, kv_len:].any() and not got[2][:, kv_len:].any()


@pytest.mark.parametrize("sq,skv,kv_len", [(20, 20, None), (20, 20, 13), (12, 20, 17)])
def test_bshd_twin_matches_autograd_of_the_plain_forward(sq, skv, kv_len):
    """The plain twin of the BSHD backward kernel (from lse and di, in the
    kernel's op order, with the kv_len column mask; q and k/v of their own
    lengths) against torch autograd of the plain forward. fp32: 1e-5."""
    g = torch.Generator().manual_seed(1)
    h, d, b = 2, 32, 2
    q = torch.randn(b, sq, h * d, generator=g) * 0.5
    k, v = (torch.randn(b, skv, h * d, generator=g) * 0.5 for _ in range(2))
    do = torch.randn(b, sq, h * d, generator=g)
    o, lse = t_attention.mha_bshd_reference(q, k, v, num_heads=h, kv_len=kv_len,
                                            return_lse=True)
    got = t_attention.mha_bshd_bwd(q, k, v, do, lse, t_attention.bwd_row_stats(o, do, h),
                                   num_heads=h, kv_len=kv_len)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(t_attention.mha_bshd_reference(*leaves, num_heads=h,
                                                              kv_len=kv_len), leaves, do)
    for a, e in zip(got, want):  # dq, dk, dv
        torch.testing.assert_close(a, e, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("backend", BACKENDS)
def test_modulated_layer_norm_grads_match_jax(backend):
    rng = np.random.default_rng(5)
    b, s, d = 2, 16, 128
    arrays = [_np(rng, b, s, d, scale=1.0) + 0.3, _np(rng, b, d), _np(rng, b, d)]
    cots = [_np(rng, b, s, d, scale=1.0)]
    jfn = lambda x, sc, sh: j_norms.modulated_layer_norm(x, sc, sh, backend=backend)  # noqa
    _assert_grads(_torch_grads(t_norms.modulated_layer_norm, arrays, cots),
                  _jax_grads(jfn, arrays, cots), 1e-5)


def test_rms_bwd_closed_and_row_stats_match_jax():
    rng = np.random.default_rng(6)
    x, dy, w = _np(rng, 2, 10, 128), _np(rng, 2, 10, 128), 1.0 + _np(rng, 32, scale=0.1)
    want_dx, want_dw = j_norms.rms_bwd_closed(jnp.asarray(x), jnp.asarray(w),
                                              jnp.asarray(dy), 4, 1e-6)
    got_dx, got_dw = t_norms.rms_bwd_closed(torch.from_numpy(x), torch.from_numpy(w),
                                            torch.from_numpy(dy), 4, 1e-6)
    np.testing.assert_allclose(got_dx.numpy(), np.asarray(want_dx), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_dw.numpy(), np.asarray(want_dw), rtol=1e-5, atol=1e-5)
    _, want_di = j_attention.bwd_row_stats(jnp.asarray(x), jnp.asarray(dy),
                                           jnp.zeros((2, 4, 10)), 4)
    got_di = t_attention.bwd_row_stats(torch.from_numpy(x), torch.from_numpy(dy), 4)
    np.testing.assert_allclose(got_di.numpy(), np.asarray(want_di)[..., 0], rtol=1e-5,
                               atol=1e-5)
