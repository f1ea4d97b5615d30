"""What the attention kernels take on the card, and the plain twins the
generic kernels are held to, at the small head widths.

``attention_route`` (adv_grpo_torch/ops/attention.py) decides, before any
launch, which kernel a CUDA call takes: the wgmma + TMA kernels ("sm90", bf16
at head width 64 or 128, as before) or the generic kernels of
``csrc/attention_generic_{fwd,bwd}.cu`` ("generic": fp32 at any width up to
128 on the tensor cores in 3xTF32, bf16 at the other widths on FFMA, and the
single-stream and fused-RMS joint backwards at 128). Here, on the CPU: the route over every (dtype, width, RMS,
mode, direction), the limits that still raise, the wrappers refusing a
non-CPU tensor before any launch on the generic route too, the generic
kernels' descriptor and modes against their C header, and the joint twins
the generic kernels follow (``joint_fwd_tiled_reference``,
``attention_bwd_reference``, with the fused qk-RMS) against the TPU kernels
in the Pallas interpreter at d = 16 and 32, in fp32 and bf16, where no other
test holds them there (tests/test_torch_kernel_range_twins.py: the
single-stream, BSHD and BHSD twins).

Bounds: fp32 against fp32 1e-4 (summation order and the kernels' base-2
softmax). bf16: the twin and the TPU kernel round at the same places, but a
last-bit difference before a rounding flips it now and then: the forward
within 2 bf16 spacings of outputs of magnitude <= 1 (2^-7), the lse 1e-3;
each backward cotangent within one bf16 spacing in relative L2 (2^-8), as
tests/test_torch_joint_bwd.py bounds the same twins at d = 64 and 128.
"""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adv_grpo_torch.kernels import build
from adv_grpo_torch.ops import attention as t_mha
from adv_grpo_torch.ops import fused_norms as t_norms
from adv_grpo_torch.ops import joint_attention as t_attn
from adv_grpo_tpu.ops import joint_attention as j_attn
from adv_grpo_tpu.ops.attention import LSE_LANES

CUDA = torch.device("cuda")  # a device object only: no card is needed to route
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
MODES = ("joint", "single", "bshd", "bhsd")
EPS = 1e-6
TOL_FP32 = 1e-4
TOL_BF16_O, TOL_BF16_LSE, TOL_BF16_BWD = 2 * 2.0 ** -8, 1e-3, 2.0 ** -8


# ── the route ──


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("d", [8, 16, 32, 48, 64, 80, 128])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_route_takes_every_width_up_to_128(dtype, d, mode):
    """No (dtype, width <= 128 in whole 16-byte vectors, RMS, mode,
    direction) raises; bf16 at 64 / 128 keeps the wgmma kernels but for the
    backwards they do not build (the single stream's at 128, and the joint
    one's with the fused RMS at 128); all else takes the generic kernels."""
    dt = DTYPES[dtype][1]
    for rms in (False, True):
        for direction in ("fwd", "bwd"):
            got = t_mha.attention_route(CUDA, dt, d, mode=mode, rms=rms, direction=direction)
            want = "generic"
            if dt == torch.bfloat16 and d in (64, 128):
                fused_rms_bwd = (direction == "bwd" and d == 128
                                 and (mode == "single" or (mode == "joint" and rms)))
                want = "generic" if fused_rms_bwd else "sm90"
            assert got == want, (rms, direction)
            assert t_mha.attention_route(torch.device("cpu"), dt, d, mode=mode, rms=rms,
                                         direction=direction) == "plain"


@pytest.mark.parametrize("dtype,d,limit", [("float32", 256, "up to 128"),
                                           ("bfloat16", 256, "up to 128"),
                                           ("bfloat16", 12, "multiples of 8"),
                                           ("float32", 6, "multiples of 4"),
                                           ("float32", 0, "up to 128")])
def test_route_raises_past_its_limits_naming_them(dtype, d, limit):
    """A head wider than 128, or not a whole number of 16-byte vectors,
    raises on the card with the limit in the message (no model of either
    package has one); the CPU's plain versions take any width."""
    dt = DTYPES[dtype][1]
    for mode in MODES:
        with pytest.raises(ValueError, match=limit):
            t_mha.attention_route(CUDA, dt, d, mode=mode, what="x")
        assert t_mha.attention_route(torch.device("cpu"), dt, d, mode=mode) == "plain"


def test_route_raises_on_other_devices_and_dtypes():
    with pytest.raises(ValueError, match="unsupported device"):
        t_mha.attention_route(torch.device("meta"), torch.float32, 32, mode="joint")
    with pytest.raises(TypeError, match="fp32 or bf16"):
        t_mha.attention_route(CUDA, torch.float16, 64, mode="bshd")
    with pytest.raises(ValueError, match="unknown mode"):
        t_mha.attention_route(CUDA, torch.float32, 64, mode="causal")


def _wrapper_calls(x4, x3, heads, stats):
    """A call of every attention wrapper, forward and backward, on the given
    tensors."""
    w = [torch.ones(x3.shape[-1] // heads, device=x3.device)] * 4
    return [
        lambda: t_mha.mha(x4, x4, x4),
        lambda: t_mha.mha_bwd(x4, x4, x4, x4, stats, x4, sm_scale=0.1),
        lambda: t_mha.mha_bshd(x3, x3, x3, num_heads=heads),
        lambda: t_mha.mha_bshd_bwd(x3, x3, x3, x3, stats, stats, num_heads=heads),
        lambda: t_attn.joint_mha(x3, x3, x3, x3, x3, x3, num_heads=heads, rms_weights=w),
        lambda: t_attn.mha_rms(x3, x3, x3, num_heads=heads, rms_weights=w[:2]),
        lambda: t_attn.joint_attention_bwd(x3, x3, x3, x3, x3, x3, x3, x3, stats, stats, stats,
                                           stats, num_heads=heads, rms_weights=w),
        lambda: t_attn.mha_rms_bwd(x3, x3, x3, x3, stats, stats, num_heads=heads,
                                   rms_weights=w[:2]),
    ]


@pytest.mark.parametrize("dtype,d", [("float32", 32), ("float32", 16), ("float32", 128),
                                     ("bfloat16", 48), ("bfloat16", 16)])
def test_generic_route_on_a_non_cpu_tensor_never_falls_back(dtype, d):
    """As ``mha``'s test in tests/test_torch_flash.py: the wrappers decide by
    the tensor's device, so a call that routes to the generic kernels (meta
    tensors stand in for CUDA ones here) raises before any launch instead of
    running the plain version, forward and backward, and no counter moves;
    so do the fp32 norms."""
    dt = DTYPES[dtype][1]
    heads = 2
    x4 = torch.empty(1, heads, 8, d, device="meta", dtype=dt)
    x3 = torch.empty(1, 8, heads * d, device="meta", dtype=dt)
    stats = torch.empty(1, heads, 8, device="meta")
    counters = (t_mha.mha, t_mha.mha_bwd, t_mha.mha_bshd, t_mha.mha_bshd_bwd, t_attn.joint_mha,
                t_attn.mha_rms, t_attn.joint_attention_bwd, t_attn.mha_rms_bwd)
    before = [(f.launches, f.generic_launches) for f in counters]
    for call in _wrapper_calls(x4, x3, heads, stats):
        with pytest.raises(ValueError, match="unsupported device"):
            call()
    assert [(f.launches, f.generic_launches) for f in counters] == before
    y = torch.empty(1, 8, 64, device="meta")
    norms = (t_norms.modulated_layer_norm, t_norms.layer_norm, t_norms.rms_norm_heads)
    n0 = [f.launches for f in norms]
    for call in (lambda: t_norms.modulated_layer_norm(y, y[:, 0], y[:, 0]),
                 lambda: t_norms.layer_norm(y),
                 lambda: t_norms.rms_norm_heads(y, torch.ones(16, device="meta"), num_heads=4)):
        with pytest.raises(ValueError, match="unsupported device"):
            call()
    assert [f.launches for f in norms] == n0


def test_cpu_tensors_at_generic_widths_take_the_plain_versions():
    """fp32 CPU tensors at d = 16 run the plain versions, forward and
    backward, and neither route's counter moves."""
    counters = (t_mha.mha, t_mha.mha_bwd, t_mha.mha_bshd, t_mha.mha_bshd_bwd, t_attn.joint_mha,
                t_attn.mha_rms, t_attn.joint_attention_bwd, t_attn.mha_rms_bwd)
    before = [(f.launches, f.generic_launches) for f in counters]
    g = torch.Generator().manual_seed(0)
    x = torch.randn(1, 10, 32, generator=g, requires_grad=True)
    w = [torch.ones(16)] * 4
    oi, ot = t_attn.joint_mha(x, x, x, x, x, x, num_heads=2, rms_weights=w)
    o = t_attn.mha_rms(x, x, x, num_heads=2, rms_weights=w[:2]) + t_mha.mha_bshd(
        x, x, x, num_heads=2, kv_len=7)
    x4 = x.view(1, 10, 2, 16).transpose(1, 2)
    o4 = t_mha.mha(x4, x4, x4)
    (oi.sum() + ot.sum() + o.sum() + o4.sum()).backward()
    assert torch.isfinite(x.grad).all()
    assert [(f.launches, f.generic_launches) for f in counters] == before


# ── the generic kernels' C interface ──


def _header():
    with open(os.path.join(build.CSRC_DIR, "attention_generic.cuh")) as f:
        return f.read()


def _enum(src, name):
    body = re.search(r"enum " + name + r" \{(.*?)\};", src, re.S)[1]
    return {k: int(v) for k, v in re.findall(r"(k\w+) = (\d+)", body)}


def test_generic_descriptor_matches_the_header():
    """The wrapper's descriptor slots and modes are the C header's: a slot
    off by one would show only as a wrong answer or a crash on the card."""
    src = _header()
    desc = _enum(src, "Desc")
    ours = {**t_mha._DESC_INTS, **t_mha._DESC_VIEWS, **t_mha._DESC_PTRS}
    names = {"q_rows": "kQRows", "kv_rows": "kKvRows", "kv_valid": "kKvValid", "q": "kQ",
             "k": "kK", "v": "kV", "o": "kO", "do": "kDo", "dq": "kDq", "dk": "kDk",
             "dv": "kDv", "lse": "kLse", "di": "kDi", "wq": "kWq", "wk": "kWk",
             "qhat": "kQhat", "qs": "kQs", "khat": "kKhat"}
    assert {names[k]: v for k, v in ours.items()} == {k: v for k, v in desc.items()
                                                      if k != "kDescLen"}
    assert desc["kDescLen"] == t_mha._DESC_LEN
    views = sorted(t_mha._DESC_VIEWS.values())
    assert all(b - a == 4 for a, b in zip(views, views[1:]))  # (pointer, 3 strides) each
    modes = _enum(src, "Mode")
    assert {"joint": modes["kJoint"], "single": modes["kJoint"], "bshd": modes["kBshd"],
            "bhsd": modes["kBhsd"]} == t_mha.GENERIC_MODES


def test_sum_of_squares_pads_a_partial_chunk_with_zeros():
    """At a width that is no multiple of 8 (fp32 d = 12: three 16-byte
    vectors), the twin's fixed-order sum of squares takes the partial last
    chunk as padded with zeros, as the generic pre-pass does; at d = 8 and
    16 it is the plain chunked sum."""
    g = torch.Generator().manual_seed(1)
    for d in (12, 8, 16):
        x = torch.randn(2, 3, 5, d, generator=g)
        got = t_attn._sum_sq(x, halves=True)[..., 0]
        sq = torch.nn.functional.pad(x * x, (0, -d % 8)).unflatten(-1, (-1, 8))
        want = sq[..., 0]
        for e in range(1, 8):
            want = want + sq[..., e]
        want = want.sum(-1) if want.shape[-1] > 1 else want[..., 0]
        torch.testing.assert_close(got, want, rtol=1e-6, atol=0)


# ── the twins against the TPU kernels in the interpreter, d = 16 and 32 ──


def _draw(seed, shapes, dtype):
    """numpy fp32 draws of values representable in ``dtype``."""
    rng = np.random.default_rng(seed)
    tdt = DTYPES[dtype][1]
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(tdt).float().numpy()
            for s in shapes], rng


def _close(got, want, tol, dtype, kind):
    g = np.asarray(got, np.float32)
    w = np.asarray(jnp.asarray(want, jnp.float32))
    assert g.shape == w.shape
    if dtype == "float32" or kind != "bwd":
        np.testing.assert_allclose(g, w, rtol=0 if kind != "bwd" else tol, atol=tol)
    else:
        assert np.linalg.norm(g - w) / np.linalg.norm(w) <= tol


def _lanes(a):
    a = jnp.asarray(np.asarray(a, np.float32))
    return jnp.broadcast_to(a[..., None], a.shape + (LSE_LANES,))


# (d, heads): 128 / d heads fill the TPU kernels' 128-wide column group
WIDTHS = [(16, 8), (32, 4)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d,h", WIDTHS)
def test_joint_twins_match_the_tpu_joint_kernels(d, h, dtype):
    """The joint forward twin and the backward twin, with the fused qk-RMS,
    against ``_joint_mha_p_fwd`` / ``_joint_bwd_fused`` (24 image tokens and
    a ragged text stream of 13, padded to 16 with ``t_valid``)."""
    jdt, tdt = DTYPES[dtype]
    s_i, s_t, b = 24, 13, 1
    arrs, rng = _draw(d + h, [(b, s, h * d) for s in (s_i,) * 3 + (s_t,) * 3 + (s_i, s_t)],
                      dtype)
    w = [(1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32) for _ in range(4)]
    t = [torch.from_numpy(a).to(tdt) for a in arrs]
    tw = [torch.from_numpy(a) for a in w]
    pairs = [(tw[0], tw[1]), (tw[2], tw[3])]
    (o_i, o_t), (l_i, l_t) = t_attn.joint_fwd_tiled_reference(t[0:6:3], t[1:6:3], t[2:6:3],
                                                              num_heads=h, rms_weights=pairs,
                                                              eps=EPS)

    pad = -s_t % 8
    j = [jnp.asarray(a, jdt) for a in arrs]
    jt = [jnp.pad(a, ((0, 0), (0, pad), (0, 0))) for a in j[3:6] + j[7:8]]
    (w_oi, w_ot), res = j_attn._joint_mha_p_fwd(j[0], j[1], j[2], *jt[:3], *map(jnp.asarray, w),
                                                 h, d ** -0.5, EPS, True, True, s_t)
    fwd_tol = (TOL_FP32, TOL_FP32) if dtype == "float32" else (TOL_BF16_O, TOL_BF16_LSE)
    _close(o_i.float().numpy(), w_oi, fwd_tol[0], dtype, "o")
    _close(o_t.float().numpy(), w_ot[:, :s_t], fwd_tol[0], dtype, "o")
    _close(l_i.numpy(), res[12], fwd_tol[1], dtype, "lse")
    _close(l_t.numpy(), res[13][..., :s_t], fwd_tol[1], dtype, "lse")

    f32 = [a.float() for a in t[:6]]
    ref = t_attn.joint_mha_reference(*f32, num_heads=h, rms_weights=tw, return_lse=True)
    lses = [ref[2], ref[3]]
    dis = [t_mha.bwd_row_stats(o, do.float(), h) for o, do in ((ref[0], t[6]), (ref[1], t[7]))]
    got = t_attn.attention_bwd_reference(t[0:6:3], t[1:6:3], t[2:6:3], t[6:8], lses, dis,
                                         num_heads=h, rms_weights=pairs, eps=EPS)
    lse_t, di_t = (torch.nn.functional.pad(a, (0, pad)) for a in (lses[1], dis[1]))
    want = j_attn._joint_bwd_fused(
        j[0], j[1], j[2], *jt[:3], j_attn._tile_w2(jnp.asarray(w[0]), jnp.asarray(w[2]), h),
        j_attn._tile_w2(jnp.asarray(w[1]), jnp.asarray(w[3]), h), j[6], jt[3],
        _lanes(lses[0]), _lanes(lse_t), _lanes(dis[0]), _lanes(di_t), h, d ** -0.5, EPS, True,
        True, s_t)
    want = list(want[:3]) + [a[:, :s_t] for a in want[3:]]
    bwd_tol = TOL_FP32 if dtype == "float32" else TOL_BF16_BWD
    for g_, w_ in zip([a for s in got for a in s], want):
        assert g_.dtype == tdt
        _close(g_.float().numpy(), w_, bwd_tol, dtype, "bwd")
