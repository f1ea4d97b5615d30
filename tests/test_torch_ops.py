"""Parity of the PyTorch port's ops (adv_grpo_torch.ops) with the JAX package.

The same inputs, drawn from a seed with numpy, go through the JAX function at
both ``backend="reference"`` and ``backend="pallas_interpret"`` (the TPU kernel
run by the Pallas interpreter) and through the port's function on CPU tensors,
where the port runs its plain PyTorch version. Everything is fp32, so the
tolerances below only absorb summation order, except where noted.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adv_grpo_torch.ops import attention as t_mha
from adv_grpo_torch.ops import fused_norms as t_norms
from adv_grpo_torch.ops import joint_attention as t_attn
from adv_grpo_tpu.ops import attention as j_mha
from adv_grpo_tpu.ops import fused_norms as j_norms
from adv_grpo_tpu.ops import joint_attention as j_attn

BACKENDS = ["reference", "pallas_interpret"]
# fp32 against fp32: the plain port and the JAX reference differ only in
# summation order (~1e-6)
TOL_REF = 1e-5
# against the Pallas kernel: its base-2 softmax with the sm_scale*log2(e)
# pre-scale of q rounds differently — the bound the JAX package's own
# interpret-vs-reference tests use (tests/test_joint_attention.py)
TOL_KERNEL = 2e-4


def _tol(backend):
    return TOL_REF if backend == "reference" else TOL_KERNEL


def _np(rng, *shape, scale=0.5):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("s", [16, 10])
def test_modulated_layer_norm_matches_jax(backend, s):
    rng = np.random.default_rng(0)
    b, d = 2, 128
    x = _np(rng, b, s, d, scale=1.0) + 0.3
    sc, sh = _np(rng, b, d), _np(rng, b, d)
    want = j_norms.modulated_layer_norm(jnp.asarray(x), jnp.asarray(sc), jnp.asarray(sh),
                                        backend=backend)
    got = t_norms.modulated_layer_norm(torch.from_numpy(x), torch.from_numpy(sc),
                                       torch.from_numpy(sh))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


def test_rms_reference_matches_jax():
    rng = np.random.default_rng(1)
    x, w = _np(rng, 2, 10, 128), 1.0 + _np(rng, 32, scale=0.1)
    want = j_norms._rms_reference(jnp.asarray(x), jnp.asarray(w), 4, 1e-6, jnp.float32)
    got = t_norms.rms_reference(torch.from_numpy(x), torch.from_numpy(w), 4, 1e-6,
                                torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


def _attn_inputs(seed, b, s_i, s_t, hd, d):
    rng = np.random.default_rng(seed)
    streams = [_np(rng, b, s_i, hd) for _ in range(3)] + [_np(rng, b, s_t, hd)
                                                          for _ in range(3)]
    weights = [1.0 + _np(rng, d, scale=0.1) for _ in range(4)]
    return streams, weights


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("s_t", [12, 10])  # 10: unaligned text, the t_valid path
@pytest.mark.parametrize("use_rms", [True, False])
@pytest.mark.parametrize("h,d", [(4, 32), (2, 64)])
def test_joint_mha_matches_jax(backend, s_t, use_rms, h, d):
    streams, weights = _attn_inputs(0, 2, 32, s_t, h * d, d)
    jw = tuple(jnp.asarray(w) for w in weights) if use_rms else None
    tw = tuple(torch.from_numpy(w) for w in weights) if use_rms else None
    want = j_attn.joint_mha(*(jnp.asarray(a) for a in streams), num_heads=h,
                            rms_weights=jw, backend=backend)
    got = t_attn.joint_mha(*(torch.from_numpy(a) for a in streams), num_heads=h,
                           rms_weights=tw)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=_tol(backend))


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("s", [32, 20])
@pytest.mark.parametrize("use_rms", [True, False])
@pytest.mark.parametrize("h,d", [(4, 32), (2, 64)])
def test_mha_rms_matches_jax(backend, s, use_rms, h, d):
    streams, weights = _attn_inputs(1, 2, s, 1, h * d, d)
    q, k, v = streams[:3]
    jw = (jnp.asarray(weights[0]), jnp.asarray(weights[1])) if use_rms else None
    tw = (torch.from_numpy(weights[0]), torch.from_numpy(weights[1])) if use_rms else None
    want = j_attn.mha_rms(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), num_heads=h,
                          rms_weights=jw, backend=backend)
    got = t_attn.mha_rms(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                         num_heads=h, rms_weights=tw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=_tol(backend))


def test_cpu_path_launches_no_kernel():
    """On CPU tensors the wrappers take the plain path and count no launch,
    forward or backward."""
    counters = (t_norms.modulated_layer_norm, t_attn.joint_mha, t_attn.mha_rms,
                t_attn.joint_attention_bwd, t_attn.mha_rms_bwd, t_norms.rms_norm_heads,
                t_mha.mha_bshd)
    before = [f.launches for f in counters]
    x = torch.randn(1, 4, 64, requires_grad=True)
    y = t_norms.modulated_layer_norm(x, torch.zeros(1, 64), torch.zeros(1, 64))
    y = t_norms.rms_norm_heads(y, torch.ones(64), num_heads=1)
    o_i, o_t = t_attn.joint_mha(y, y, y, y, y, y, num_heads=1)
    o = t_mha.mha_bshd(y, y, y, num_heads=1, kv_len=3)
    (o_i.sum() + o_t.sum() + t_attn.mha_rms(y, y, y, num_heads=1).sum() + o.sum()).backward()
    assert x.grad is not None
    assert [f.launches for f in counters] == before


# ── the Flux kernels' plain versions against the TPU kernels (interpret mode) ──
# fp32 on both sides: the plain port and the Pallas kernel run by the
# interpreter differ only in summation order and the kernels' base-2 softmax
# (~1e-6), inside 1e-5
TOL_FLUX = 1e-5


@pytest.mark.parametrize("num_heads,hd", [(2, 256), (1, 256)])  # d = 128; one row-wide head
def test_rms_norm_heads_matches_jax_kernel_with_grads(num_heads, hd):
    rng = np.random.default_rng(4)
    b, s = 2, 16
    d = hd // num_heads
    x = _np(rng, b, s, hd, scale=1.0) + 0.2
    w = 1.0 + _np(rng, d, scale=0.1)
    dy = _np(rng, b, s, hd, scale=1.0)

    def jfn(x_, w_):
        return j_norms.rms_norm_heads(x_, w_, num_heads=num_heads,
                                      backend="pallas_interpret")

    want, vjp = jax.vjp(jfn, jnp.asarray(x), jnp.asarray(w))
    want_dx, want_dw = vjp(jnp.asarray(dy))
    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    got = t_norms.rms_norm_heads(tx, tw, num_heads=num_heads)
    got.backward(torch.from_numpy(dy))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=TOL_FLUX)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want_dx), rtol=0, atol=TOL_FLUX)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(want_dw), rtol=0, atol=TOL_FLUX)


# (S_q, S_kv, kv_len) at the edges of the card kernel's 128-row q and kv tiles
# (csrc/attention_fwd_sm90.cu): lengths 1, 63, 65, 127, 129 and 200, S_q !=
# S_kv both ways, kv_len of 1 and 129 (one key into the second tile) and
# inside the last tile
FWD_TILE_EDGES = [(1, 1, None), (63, 63, None), (65, 65, None), (127, 127, None),
                  (129, 129, None), (200, 200, None), (63, 200, None), (200, 65, None),
                  (129, 127, 1), (65, 200, 129), (127, 200, 150), (1, 129, 100)]


@pytest.mark.parametrize(
    "h,d,sq,skv,kv_len",
    [(h, d, 256, 256, kv) for h, d in [(2, 128), (4, 64)] for kv in [None, 200]]
    + [(h, d, sq, skv, kv) for h, d in [(2, 128), (4, 64)] for sq, skv, kv in FWD_TILE_EDGES],
    ids=[f"{h}-{d}-{kv}" for h, d in [(2, 128), (4, 64)] for kv in [None, 200]]
    + [f"{h}-{d}-{kv}-sq{sq}-skv{skv}" for h, d in [(2, 128), (4, 64)]
       for sq, skv, kv in FWD_TILE_EDGES])
def test_mha_bshd_matches_jax_kernel(h, d, sq, skv, kv_len):
    """The plain forward (what the card kernel is held to) against the TPU's
    ``_bshd_fwd_kernel`` in interpret mode, at S = 256 and at the card
    kernel's tile edges."""
    rng = np.random.default_rng(5)
    q = _np(rng, 2, sq, h * d)
    k, v = (_np(rng, 2, skv, h * d) for _ in range(2))
    want = j_mha.mha_bshd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), num_heads=h,
                          kv_len=kv_len, backend="pallas_interpret")
    got = t_mha.mha_bshd(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                         num_heads=h, kv_len=kv_len)
    assert got.shape == (2, sq, h * d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL_FLUX)


def test_mha_bshd_kv_len_masks_the_tail():
    """Keys at or past kv_len do not reach the output: changing them changes
    nothing, and the lse is that of the first kv_len keys."""
    rng = np.random.default_rng(6)
    q, k, v = (torch.from_numpy(_np(rng, 1, 40, 128)) for _ in range(3))
    o, lse = t_mha.mha_bshd_fwd(q, k, v, 1, 128 ** -0.5, 25, want_lse=True)
    k2, v2 = k.clone(), v.clone()
    k2[:, 25:], v2[:, 25:] = 7.0, -3.0
    torch.testing.assert_close(t_mha.mha_bshd(q, k2, v2, num_heads=1, kv_len=25), o)
    ref_o, ref_lse = t_mha.mha_bshd_fwd(q, k[:, :25], v[:, :25], 1, 128 ** -0.5, None,
                                        want_lse=True)
    torch.testing.assert_close(o, ref_o)
    torch.testing.assert_close(lse, ref_lse)


@pytest.mark.parametrize("s_t", [12, 10])
def test_joint_mha_without_rms_at_head_dim_128_matches_jax_kernel(s_t):
    streams, _ = _attn_inputs(2, 2, 32, s_t, 2 * 128, 128)
    want = j_attn.joint_mha(*(jnp.asarray(a) for a in streams), num_heads=2,
                            backend="pallas_interpret")
    got = t_attn.joint_mha(*(torch.from_numpy(a) for a in streams), num_heads=2)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=TOL_FLUX)
