"""The plain twin of ``mha_bshd``'s backward kernel (#9, csrc/attention_bwd_sm90.cu)
against the JAX package, and the kernel library's C interface against its
ctypes bindings.

The twin (``bshd_bwd_reference``, the CPU path of ``mha_bshd``'s backward)
follows the kernel's op order: s on q and k as given, scaled in fp32; p and t
= p (dp - di) rounded to the inputs' dtype before their products; dk and dq
scaled by sm_scale after them. That is the order of the TPU's split bodies
``_bshd_bwd_dkv_kernel`` / ``_bshd_bwd_dq_kernel``, which the JAX ``mha_bshd``
runs when block sizes are given (adv_grpo_tpu/ops/attention.py ``_bshd_bwd``);
here they run in the Pallas interpreter, as the JAX package's own tests run
them. In fp32 the rounding is a no-op, and both sides agree to fp32
summation order: tolerance 1e-4.
"""

import ctypes
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adv_grpo_torch.kernels import build
from adv_grpo_torch.ops import attention as tattn
from adv_grpo_tpu.ops import attention as jattn

# (B, S_q, S_kv, H, D, kv_len): lengths that are not multiples of the
# kernel's 64-row q and 128-row kv tiles, S_q != S_kv both ways, kv_len
# masks; H * D a multiple of 128, so the JAX package keeps its BSHD bodies
# (``_bshd_group_geometry``) instead of falling back to ``mha``
SPLIT_CASES = [(2, 80, 80, 2, 64, None), (1, 80, 48, 2, 64, 37), (2, 48, 96, 1, 128, 70),
               (1, 96, 80, 2, 128, None), (1, 112, 112, 1, 128, 100)]
BLOCK = 16  # the TPU bodies' q and kv blocks (a divisor of every length above)


def _inputs(b, sq, skv, h, d, seed):
    rng = np.random.default_rng(seed)
    q, do = (rng.standard_normal((b, sq, h * d)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((b, skv, h * d)).astype(np.float32) * 0.5 for _ in range(2))
    return q * 0.5, k, v, do


@pytest.mark.parametrize("b,sq,skv,h,d,kv_len", SPLIT_CASES)
def test_bshd_twin_matches_jax_split_bodies(b, sq, skv, h, d, kv_len):
    """``mha_bshd``'s gradient on CPU tensors (the plain forward, then the
    twin from its lse and di) against ``jax.vjp`` of the JAX ``mha_bshd``
    with its split backward bodies in the Pallas interpreter; fp32, 1e-4.
    dk and dv are exactly zero at keys past kv_len."""
    q, k, v, do = _inputs(b, sq, skv, h, d, seed=sq + skv + d)

    def f(q_, k_, v_):
        return jattn.mha_bshd(q_, k_, v_, num_heads=h, kv_len=kv_len, block_q=BLOCK,
                              block_kv=BLOCK, backend="pallas_interpret")

    o, vjp = jax.vjp(f, *(jnp.asarray(a) for a in (q, k, v)))
    want = [np.asarray(o)] + [np.asarray(g) for g in vjp(jnp.asarray(do))]

    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    n0 = tattn.mha_bshd_bwd.launches
    out = tattn.mha_bshd(*leaves, num_heads=h, kv_len=kv_len)
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(do))
    assert tattn.mha_bshd_bwd.launches == n0  # the CPU path launches nothing
    got = [out.detach().numpy()] + [g.numpy() for g in grads]
    for name, a, e in zip(("o", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a, e, rtol=1e-4, atol=1e-4, err_msg=name)
    if kv_len is not None:
        assert not grads[1][:, kv_len:].any() and not grads[2][:, kv_len:].any()


@pytest.mark.parametrize("d", [64, 128])
def test_bshd_twin_in_bf16_is_within_its_rounding_of_fp32(d):
    """The twin on bf16 inputs rounds p and t to bf16 before their products
    and each cotangent to bf16 at the end; against the twin on the same
    values in fp32 each cotangent stays within 4 * 2^-9 relative L2: bf16
    keeps 8 significant bits (a rounding is at most 2^-9 relative), and the
    three roundings (p or t, then the output) plus the summation order
    cannot add up to more than four. It must also differ from fp32, or the
    rounding was not applied."""
    b, s, h = 1, 96, 2
    q, k, v, do = (torch.from_numpy(a).to(torch.bfloat16) for a in _inputs(b, s, s, h, d, 3))
    o, lse = tattn.mha_bshd_reference(q.float(), k.float(), v.float(), num_heads=h,
                                      return_lse=True)
    di = tattn.bwd_row_stats(o, do.float(), h)
    got = tattn.bshd_bwd_reference(q, k, v, do, lse, di, num_heads=h, kv_len=80)
    ref = tattn.bshd_bwd_reference(q.float(), k.float(), v.float(), do.float(), lse, di,
                                   num_heads=h, kv_len=80)
    rounded_only_out = [r.to(torch.bfloat16).float() for r in ref]
    for a, r, r_out in zip(got, ref, rounded_only_out):
        assert a.dtype == torch.bfloat16
        rel = ((a.float() - r).norm() / r.norm()).item()
        assert rel <= 4 * 2.0 ** -9, rel
    # p and t rounded too: dv and dk differ from fp32 rounded at the output only
    assert not torch.equal(got[2].float(), rounded_only_out[2])
    assert not torch.equal(got[1].float(), rounded_only_out[1])


_C_TYPES = {"void*": "p", "constvoid*": "p", "constlonglong*": "p", "int": "i",
            "longlong": "ll", "float": "f"}
_CTYPES_KIND = {ctypes.c_void_p: "p", ctypes.c_int: "i", ctypes.c_longlong: "ll",
                ctypes.c_float: "f"}


def _extern_c_entry_points():
    """{name: [kind of each parameter]} of every ``extern "C"`` function
    defined in the kernel sources."""
    found = {}
    for path in sorted(os.listdir(build.CSRC_DIR)):
        if not path.endswith((".cu", ".cuh")):
            continue
        with open(os.path.join(build.CSRC_DIR, path)) as f:
            src = f.read()
        for name, params in re.findall(r'extern\s+"C"\s+int\s+(\w+)\s*\(([^)]*)\)', src):
            # each parameter's type with the blanks taken out ("const void* q" -> "constvoid*")
            kinds = [_C_TYPES[re.sub(r"\s+", "", re.match(r"(.*?)\w+\s*$", param, re.S)[1])]
                     for param in params.split(",")]
            assert name not in found, f"{name} defined twice"
            found[name] = kinds
    return found


def test_extern_c_entry_points_match_the_ctypes_signatures():
    """Every C entry point has a ctypes signature of the same name, arity and
    parameter kinds, and every signature a C entry point: a mismatch would
    show only as a crash on the card."""
    entry = _extern_c_entry_points()
    sigs = {name: [_CTYPES_KIND[t] for t in args]
            for name, args in build._SIGNATURES.items()}
    assert set(entry) == set(sigs)
    for name, kinds in entry.items():
        assert kinds == sigs[name], name
    # the two multi-head backwards live in the wgmma + TMA source
    with open(os.path.join(build.CSRC_DIR, "attention_bwd_sm90.cu")) as f:
        src = f.read()
    assert 'extern "C" int mha_bshd_bwd_bf16' in src and 'extern "C" int mha_bwd_bf16' in src
