"""The arithmetic of the fp32 generic attention kernels, on the CPU.

The fp32 instances of ``csrc/attention_generic_{fwd,bwd}.cu`` run every
product on the tensor cores as three TF32 products (3xTF32, CUTLASS's
OpMultiplyAddFastF32): each fp32 operand x splits into big = tf32(x), rounded
to nearest with ties away from zero (``cvt.rna.tf32.f32``; ``sm90.cuh``
``tf32_rna``), and small = tf32(x - big); a product is big*small +
small*big + big*big, summed in fp32 in 8-deep steps (one ``wgmma`` k8 step
in the forward, one ``mma.sync m16n8k8`` in the backward), the small
products apart from big*big and added to it at the end, but for the
forward's p v, whose three products go into one fresh sum per kv tile.
Those kernels build only on the card, so
this file emulates their arithmetic in torch, test-local (nothing of it
enters the package): the split, the forward's 32-row kv tiles with the
online base-2 softmax, and the backward's recomputed s and dp, with kJoint's
dk taken on q^ and scaled by ln 2. The emulation, on inputs drawn with numpy
from a seed, is held against the JAX package's attention in the same mode
(``backend="reference"``, as the JAX tests run it on the CPU; the backward
through ``jax.vjp``) for the joint mode with the fused qk-RMS, BSHD with
kv_len, and BHSD.

Bounds, the card's gates (chip_smoke.py, unchanged): the forward within
KR_FWD_F32 = 1e-5 relative L2 of fp32 attention (3xTF32 drops only
small*small, 2^-22 of a product, so fp32 summation order sets the error),
and dq / dk / dv within KR_BWD_F32 = 1e-4 (the backward's error grows with
the lse and di it starts from and with its longer sums). One case shows the
gate tells the designs apart: a single TF32 pass (big*big alone) misses 1e-5
at a d = 128 head over 2,048 keys, where 3xTF32 meets it.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adv_grpo_torch.ops import attention as t_mha
from adv_grpo_torch.ops import joint_attention as t_attn
from adv_grpo_torch.ops.fused_norms import rms_bwd_closed
from adv_grpo_tpu.ops import attention as j_mha
from adv_grpo_tpu.ops import joint_attention as j_attn

KR_FWD_F32, KR_BWD_F32 = 1e-5, 1e-4  # chip_smoke.py's fp32 gates
EPS = 1e-6
LOG2E, LN2 = 1.4426950408889634, 0.6931471805599453
KV_TILE = 32  # the forward's kv rows per step (attention_generic_fwd.cu kTfBKV)


# ── the kernels' arithmetic ──


def tf32(x):
    """fp32 ``x`` rounded to TF32 (10 mantissa bits), to nearest with ties
    away from zero, on the bit pattern: plus half a TF32 unit, the 13 low
    bits cleared."""
    bits = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    r = (bits + 0x1000) & 0xFFFFE000
    return torch.where(r >= 2 ** 31, r - 2 ** 32, r).to(torch.int32).view(torch.float32)


def split(x):
    big = tf32(x)
    return big, tf32(x - big)


def mm(a, b, passes=3, apart=True):
    """a @ b (fp32, (..., M, K) @ (..., K, N)) as the kernels form it, in
    8-deep steps: with 3 passes small*big and big*small, then big*big,
    summed in fp32 (``apart``: the small products in a sum of their own,
    added to big*big's at the end; else all three into one sum, small ones
    first, as the forward's p v over a tile); with 1 pass big*big alone (a
    single TF32 product)."""
    (ab, a_s), (bb, b_s) = split(a), split(b)
    big = torch.zeros(a.shape[:-1] + b.shape[-1:], dtype=torch.float32)
    small = torch.zeros_like(big)
    for k0 in range(0, a.shape[-1], 8):
        ks = slice(k0, k0 + 8)
        if passes == 3:
            acc = small if apart else big
            acc = acc + a_s[..., ks] @ bb[..., ks, :]
            acc = acc + ab[..., ks] @ b_s[..., ks, :]
            small, big = (acc, big) if apart else (small, acc)
        big = big + ab[..., ks] @ bb[..., ks, :]
    return big + small


def fwd(q, kvs, score_scale, passes=3):
    """The forward on (B, H, S_q, D) score operand ``q``: the kv tiles of each
    (k, v, kv_valid) of ``kvs`` in turn (one per stream), an online base-2
    softmax; returns o and lse (natural log)."""
    m = torch.full(q.shape[:-1], -math.inf)
    l = torch.zeros(q.shape[:-1])
    o = torch.zeros(q.shape)
    for k, v, kv_valid in kvs:
        for c0 in range(0, kv_valid, KV_TILE):
            c1 = min(c0 + KV_TILE, kv_valid)
            s = mm(q, k[..., c0:c1, :].transpose(-1, -2), passes) * score_scale
            m_new = torch.maximum(m, s.amax(-1))
            a = torch.exp2(m - m_new)
            p = torch.exp2(s - m_new[..., None])
            l = l * a + p.sum(-1)
            o = o * a[..., None] + mm(p, v[..., c0:c1, :], passes, apart=False)
            m = m_new
    return o / l[..., None], (m + torch.log2(l)) * LN2


def bwd(q, k, v, do, lse, di, kv_valid, score_scale, dk_scale, dq_scale):
    """dq, dk, dv from the score operand ``q`` and (B, H, S, D) k, v, do:
    s = q k^T, p = exp2(s - lse log2 e), dv = p^T do, dp = do v^T, t = p
    (dp - di), dk = t^T q, dq = t k, each product in 3xTF32; dk, dv 0 past
    kv_valid."""
    kk, vv = k[..., :kv_valid, :], v[..., :kv_valid, :]
    s = mm(q, kk.transpose(-1, -2)) * score_scale
    p = torch.exp2(s - (lse * LOG2E)[..., None])
    dp = mm(do, vv.transpose(-1, -2))
    t = p * (dp - di[..., None])
    pad = (0, 0, 0, k.shape[-2] - kv_valid)
    dv = torch.nn.functional.pad(mm(p.transpose(-1, -2), do), pad)
    dk = torch.nn.functional.pad(mm(t.transpose(-1, -2), q) * dk_scale, pad)
    return mm(t, kk) * dq_scale, dk, dv


# ── helpers ──


def _draw(seed, shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes], rng


def _rel(got, want):
    g = np.asarray(got, np.float64)
    w = np.asarray(want, np.float64)
    assert g.shape == w.shape
    return float(np.linalg.norm(g - w) / np.linalg.norm(w))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _from4(x):
    return t_mha.from_bhsd(x).numpy()


# ── the joint mode with the fused qk-RMS ──


@pytest.mark.parametrize("d,h,s_i,s_t", [(32, 2, 40, 13), (128, 1, 70, 9)])
def test_joint_rms_split_meets_the_gates(d, h, s_i, s_t):
    """Two streams (a ragged text stream), the qk-RMS fused: the emulated
    forward against ``joint_mha`` and the emulated backward, taken through
    the RMS's closed form as the wrapper does, against its ``jax.vjp``."""
    b = 1
    arrs, rng = _draw(d + s_i, [(b, s, h * d) for s in (s_i,) * 3 + (s_t,) * 3 + (s_i, s_t)])
    w = [(1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32) for _ in range(4)]
    qi, ki, vi, qt, kt, vt, doi, dot = map(_t, arrs)
    pairs = [(_t(w[0]), _t(w[1])), (_t(w[2]), _t(w[3]))]
    sm = d ** -0.5

    ops = t_attn.joint_operands([qi, qt], [ki, kt], num_heads=h, rms_weights=pairs, eps=EPS,
                                sm_scale=sm)
    q_hat = torch.cat([ops[0][0], ops[1][0]], 2)
    k_hat = torch.cat([ops[0][2], ops[1][2]], 2)
    v = torch.cat([t_mha.to_bhsd(vi, h), t_mha.to_bhsd(vt, h)], 2)
    kvs = [(ops[0][2], t_mha.to_bhsd(vi, h), s_i), (ops[1][2], t_mha.to_bhsd(vt, h), s_t)]
    o, lse = fwd(q_hat, kvs, 1.0)

    jw = tuple(map(jnp.asarray, w))
    ja = list(map(jnp.asarray, arrs[:6]))

    def joint(*x):
        return j_attn.joint_mha(*x, num_heads=h, rms_weights=jw, eps=EPS, backend="reference")

    (wo_i, wo_t), vjp = jax.vjp(joint, *ja)
    want_o = np.concatenate([np.asarray(wo_i), np.asarray(wo_t)], 1)
    assert _rel(_from4(o), want_o) <= KR_FWD_F32

    do = torch.cat([t_mha.to_bhsd(doi, h), t_mha.to_bhsd(dot, h)], 2)
    di = t_mha.bwd_row_stats(t_mha.from_bhsd(o), t_mha.from_bhsd(do), h)
    dyq, dyk, dv = (t_mha.from_bhsd(x) for x in bwd(q_hat, k_hat, v, do, lse, di, s_i + s_t,
                                                    1.0, LN2, sm))
    got = []
    for x_q, x_k, (wq, wk), sl in ((qi, ki, pairs[0], slice(0, s_i)),
                                   (qt, kt, pairs[1], slice(s_i, None))):
        got += [rms_bwd_closed(x_q, wq, dyq[:, sl], h, EPS)[0],
                rms_bwd_closed(x_k, wk, dyk[:, sl], h, EPS)[0], dv[:, sl]]
    want = vjp((jnp.asarray(arrs[6]), jnp.asarray(arrs[7])))
    for g_, w_ in zip(got, want):
        assert _rel(g_.numpy(), w_) <= KR_BWD_F32


# ── BSHD with kv_len, BHSD ──


@pytest.mark.parametrize("layout,d,h,sq,skv,kv_len", [
    ("bshd", 64, 2, 50, 70, 45), ("bshd", 16, 3, 33, 40, None),
    ("bhsd", 128, 1, 65, 97, 90), ("bhsd", 4, 2, 17, 33, None)])
def test_bshd_bhsd_split_meets_the_gates(layout, d, h, sq, skv, kv_len):
    """The scores scaled in fp32 (score_scale = sm_scale log2 e), dk on q
    times sm_scale: against ``mha_bshd`` / ``mha`` and their ``jax.vjp``,
    with kv_len masking the last keys (dk, dv exactly 0 there)."""
    b = 1
    if layout == "bshd":
        shapes = [(b, sq, h * d), (b, skv, h * d), (b, skv, h * d), (b, sq, h * d)]
    else:
        shapes = [(b, h, sq, d), (b, h, skv, d), (b, h, skv, d), (b, h, sq, d)]
    arrs, _ = _draw(d + sq + skv, shapes)
    to4 = (lambda x: t_mha.to_bhsd(x, h)) if layout == "bshd" else (lambda x: x)
    back = t_mha.from_bhsd if layout == "bshd" else (lambda x: x)
    q, k, v, do = (to4(_t(a)) for a in arrs)
    sm = d ** -0.5
    kv = skv if kv_len is None else kv_len
    o, lse = fwd(q, [(k, v, kv)], sm * LOG2E)

    if layout == "bshd":
        def attn(*x):
            return j_mha.mha_bshd(*x, num_heads=h, kv_len=kv_len, backend="reference")
    else:
        def attn(*x):
            return j_mha.mha(*x, kv_len=kv_len, backend="reference")

    want_o, vjp = jax.vjp(attn, *map(jnp.asarray, arrs[:3]))
    assert _rel(back(o).numpy(), want_o) <= KR_FWD_F32

    di = t_mha.bwd_row_stats(t_mha.from_bhsd(o), t_mha.from_bhsd(do), h)
    got = bwd(q, k, v, do, lse, di, kv, sm * LOG2E, sm, sm)
    want = vjp(jnp.asarray(arrs[3]))
    for g_, w_ in zip(got, want):
        assert _rel(back(g_).numpy(), w_) <= KR_BWD_F32
    assert not got[1][..., kv:, :].any() and not got[2][..., kv:, :].any()


# ── the gate tells the designs apart ──


def test_a_single_tf32_pass_misses_the_forward_gate():
    """One head of 128 over 2,048 keys: 3xTF32 within KR_FWD_F32 of JAX's
    fp32 attention, one TF32 pass (about three decimal digits per operand)
    well outside it."""
    d, sq, skv = 128, 64, 2048
    arrs, _ = _draw(7, [(1, 1, sq, d), (1, 1, skv, d), (1, 1, skv, d)])
    q, k, v = map(_t, arrs)
    want = np.asarray(j_mha.mha(*map(jnp.asarray, arrs), backend="reference"))
    scale = d ** -0.5 * LOG2E
    three = _rel(fwd(q, [(k, v, skv)], scale)[0].numpy(), want)
    one = _rel(fwd(q, [(k, v, skv)], scale, passes=1)[0].numpy(), want)
    assert three <= KR_FWD_F32 < 10 * KR_FWD_F32 <= one


def test_tf32_rounds_to_nearest_ties_away():
    """The bit-pattern rounding is cvt.rna's: a tie (half a TF32 unit)
    rounds away from zero in both signs, below it towards the nearer value;
    big + small recovers x to 2^-22 of its size."""
    unit = 2.0 ** -10  # a TF32 unit at 1.0
    x = torch.tensor([1 + unit / 2, -(1 + unit / 2), 1 + unit / 2 - 2.0 ** -23, 1 + 1.5 * unit,
                      3.0, 0.0], dtype=torch.float32)
    got = tf32(x)
    assert got.tolist() == [1 + unit, -(1 + unit), 1.0, 1 + 2 * unit, 3.0, 0.0]
    y = torch.from_numpy(np.random.default_rng(3).standard_normal(4096).astype(np.float32))
    big, small = split(y)
    assert (tf32(big) == big).all() and (tf32(small) == small).all()
    assert ((big.double() + small.double() - y.double()).abs()
            <= 2.0 ** -22 * y.double().abs()).all()
