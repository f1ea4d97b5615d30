"""The port's ``mha`` on (B, H, S, D) (kernels #10 / #11 on the card) against
the JAX ``mha`` running its Pallas kernels in interpret mode, on the CPU.

The same fp32 inputs, made with numpy, go through the JAX function (block
128, ``backend="pallas_interpret"``, the way tests/test_attention.py runs the
TPU kernels ``_fwd_kernel``, ``_bwd_dkv_kernel`` and ``_bwd_dq_kernel``) and
through the port's ``mha``, whose CPU path is the plain forward and the
all-fp32 backward twin ``flash_bwd_reference``. Tolerance 1e-4: both sides
compute in fp32, in a different order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adv_grpo_tpu.ops import attention as jattn
from adv_grpo_torch.ops import attention as tattn


def _inputs(b, h, sq, skv, d, seed):
    rng = np.random.default_rng(seed)
    q, do = (rng.standard_normal((b, h, sq, d)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((b, h, skv, d)).astype(np.float32) for _ in range(2))
    return q, k, v, do


def _jax_mha(q, k, v, do, kv_len, block=128):
    def f(q, k, v):
        return jattn.mha(q, k, v, kv_len=kv_len, block_q=block, block_kv=block,
                         backend="pallas_interpret")

    o, vjp = jax.vjp(f, *(jnp.asarray(a) for a in (q, k, v)))
    return [np.asarray(o)] + [np.asarray(g) for g in vjp(jnp.asarray(do))]


def _torch_mha(q, k, v, do, kv_len):
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    o = tattn.mha(*leaves, kv_len=kv_len)
    grads = torch.autograd.grad(o, leaves, torch.from_numpy(do))
    return [o.detach().numpy()] + [g.numpy() for g in grads]


# (S_q, S_kv, kv_len) at the edges of the card kernels' 128-row q and kv
# tiles (csrc/attention_fwd_sm90.cu): lengths 1, 63, 65, 127, 129 and 200,
# S_q != S_kv both ways, kv_len of 1 and 129 (one key into the second tile)
# and inside the last tile. The JAX kernels take whole-sequence blocks there
# (block None): 128 does not divide these lengths.
FWD_TILE_EDGES = [(1, 1, None), (63, 63, None), (65, 65, None), (127, 127, None),
                  (129, 129, None), (200, 200, None), (63, 200, None), (200, 65, None),
                  (129, 127, 1), (65, 200, 129), (127, 200, 150), (1, 129, 100)]


@pytest.mark.parametrize(
    "d,sq,skv,kv_len",
    [(d, 256, 256, kv) for kv in [None, 200] for d in [32, 64, 128]]
    + [(d, sq, skv, kv) for d in [64, 128] for sq, skv, kv in FWD_TILE_EDGES],
    ids=[f"{kv}-{d}" for kv in [None, 200] for d in [32, 64, 128]]
    + [f"{kv}-{d}-sq{sq}-skv{skv}" for d in [64, 128] for sq, skv, kv in FWD_TILE_EDGES])
def test_mha_matches_jax_pallas_interpret(d, sq, skv, kv_len):
    """o, dq, dk, dv at S = 256 (blocks of 128) and at the tile edges."""
    seed = d + (kv_len or 0) if sq == skv == 256 else d + sq + 2 * skv
    q, k, v, do = _inputs(1, 2, sq, skv, d, seed=seed)
    block = 128 if sq == skv == 256 else None
    for name, got, want in zip(("o", "dq", "dk", "dv"), _torch_mha(q, k, v, do, kv_len),
                               _jax_mha(q, k, v, do, kv_len, block)):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4, err_msg=name)


@pytest.mark.parametrize("kv_len", [None, 200])
def test_mha_queries_shorter_than_keys_match_jax(kv_len):
    """S_q = 128 against S_kv = 256: what one rank of a context-parallel run
    computes on its query shard against the gathered keys."""
    q, k, v, do = _inputs(2, 2, 128, 256, 64, seed=7)
    for name, got, want in zip(("o", "dq", "dk", "dv"), _torch_mha(q, k, v, do, kv_len),
                               _jax_mha(q, k, v, do, kv_len)):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4, err_msg=name)


@pytest.mark.parametrize("sq,skv,kv_len", [(64, 64, None), (40, 96, 70), (96, 40, 33)])
def test_flash_bwd_reference_is_the_gradient_of_attention_reference(sq, skv, kv_len):
    """The all-fp32 twin of #11, from the plain forward's o and lse, against
    fp32 autograd of ``attention_reference`` (1e-5: the same algebra in
    another order); dk/dv rows of masked keys are zero."""
    g = torch.Generator().manual_seed(sq + skv)
    q, do = (torch.randn(2, 3, sq, 32, generator=g) for _ in range(2))
    k, v = (torch.randn(2, 3, skv, 32, generator=g) for _ in range(2))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    o, lse = tattn.attention_reference(*leaves, sm_scale=0.2, kv_len=kv_len, return_lse=True)
    want = torch.autograd.grad(o, leaves, do)
    got = tattn.flash_bwd_reference(q, k, v, o.detach(), lse.detach(), do, sm_scale=0.2,
                                    kv_len=kv_len)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    if kv_len is not None:
        assert not got[1][:, :, kv_len:].any() and not got[2][:, :, kv_len:].any()


def test_mha_on_the_cpu_launches_no_kernel():
    """CPU tensors take the plain versions only: neither counter moves, and
    ``kv_len >= S_kv`` is no mask (as in the JAX ``mha``)."""
    n = (tattn.mha.launches, tattn.mha.cross_launches, tattn.mha_bwd.launches)
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(1, 2, 16, 24, 64, seed=3))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    o = tattn.mha(*leaves, kv_len=24)
    torch.autograd.grad(o, leaves, do)
    torch.testing.assert_close(tattn.mha(q, k, v), o.detach(), rtol=0, atol=0)
    assert (tattn.mha.launches, tattn.mha.cross_launches, tattn.mha_bwd.launches) == n


def test_mha_on_a_cuda_tensor_never_falls_back():
    """The wrapper decides by the tensor's device: a CUDA-typed call without
    a card raises instead of running the plain version (meta tensors stand
    in for CUDA ones here: they are not CPU tensors, so they must be refused
    before any launch)."""
    x = torch.empty(1, 2, 8, 64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tattn.mha(x, x, x)
