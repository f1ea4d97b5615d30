"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips where no CUDA device is visible (the kernels
have no interpreter mode). Run on a GPU machine with

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest

Inputs are bf16; the plain versions run in fp32 on the same values. Bounds:
the LayerNorm (modulated and plain) and RMS outputs are rounded once from
fp32, so they lie within
one bf16 spacing of the fp32 result (spacing taken at
|y| >= 2^-8, below which fp32 rounding of the cancelling terms dominates);
attention uses the bf16 bound of the TPU kernel's own tests, 2e-2 absolute;
the attention backwards 2e-2 relative L2 per cotangent (bf16 rounding of p
and t, the same budget), at head widths 64 and 128 and for the BSHD backward
with its kv_len mask, #9 against its twin ``bshd_bwd_reference``; the (B, H,
S, D) ``mha`` kernels (#10, #11) against the same bounds, #11 against its
all-fp32 twin; the wgmma + TMA backward (#9, #11) and forward (#8, #10) at
their tile edges; the joint forward (#2, #3) on the same forward kernel at
its tile edges on both streams, against the fp32 plain version and within 1
bf16 spacing (taken at each row's largest output) of its kernel-order twin
``joint_fwd_tiled_reference``; the joint backward (#4, #5) on the wgmma +
TMA backward at its tile edges, its pre-pass's operands bit for bit against
``joint_operands`` (the forward twin's q^ and k^), its cotangents within the
backwards' 2e-2 of its twin, three kernels a call; the generic kernels
(fp32 at every head width up to 128, bf16 at the widths the wgmma kernels
lack, the fused-RMS backward at 128) at their tile edges against the twins
(fp32 1e-5 forward, 1e-4 backward in relative L2) and, in fp32, at the
full-width rows with two calls bitwise equal, the fp32 norms (1e-6), and
the CI-sized presets on the card.
"""

import re

import pytest
import torch

from adv_grpo_torch.ops import attention, fused_norms, joint_attention
from adv_grpo_torch.ops.attention import bwd_row_stats

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


def _randn(dev, *shape, dtype=torch.bfloat16, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(shape, generator=g, device=dev).to(dtype)


# the LayerNorm kernel's edges: row counts that leave the persistent grid's
# last walk short (1, 7, 154, 308, 8100), batch items whose rows leave warps
# of their last CTA idle (8 x 77, 3 x 1), both register widths a warp holds
# (6 vectors a lane: d 64 and 1024 with lanes idle, 1536; 12 a lane: 3072)
# and the first width a CTA owns (3080); the wide rows 8192 and 32768 are in
# the cases above
LN_EDGES = [(1, 1, 1536), (1, 7, 1536), (1, 308, 1536), (1, 8100, 1536), (8, 77, 1536),
            (8, 1024, 1536), (2, 33, 1024), (1, 1024, 3072), (3, 1, 3072), (1, 9, 3080)]


@pytest.mark.parametrize("b,s,d", [(2, 154, 1536), (2, 1024, 1536), (3, 7, 64),
                                   (1, 5, 8192), (1, 3, 32768)] + LN_EDGES)
def test_modulated_layer_norm_kernel(dev, b, s, d):
    x = _randn(dev, b, s, d) + 0.5
    mods = _randn(dev, b, 3 * d, seed=1)
    sc, sh = mods[:, :d], mods[:, 2 * d:]  # strided chunks, as from AdaLN
    n0 = fused_norms.modulated_layer_norm.launches
    y = fused_norms.modulated_layer_norm(x, sc, sh)
    torch.cuda.synchronize()
    assert fused_norms.modulated_layer_norm.launches == n0 + 1
    ref = fused_norms.lnmod_reference(x.float(), sc.float(), sh.float(), 1e-6,
                                      torch.float32)
    assert y.dtype == torch.bfloat16
    ulp = torch.exp2(torch.floor(torch.log2(ref.abs().clamp_min(2.0 ** -8))) - 7)
    assert ((y.float() - ref).abs() <= ulp).all()


@pytest.mark.parametrize("b,s,d", [(1, 8100, 1536), (2, 8100, 1536), (2, 77, 1536),
                                   (3, 7, 64), (1, 5, 8192), (1, 3, 32768)]
                         + [e for e in LN_EDGES if e != (1, 8100, 1536)])
def test_layer_norm_kernel(dev, b, s, d):
    """The no-affine LN (WAN's cross-attention norm, 8,100 ragged rows at
    full size) against the fp32 plain version; then the autograd path: the
    kernel forward with the closed-form backward against fp32 autograd of
    the plain version (2e-2 relative L2, bf16 inputs and cotangent)."""
    x = _randn(dev, b, s, d) * 2.0 + 0.5
    n0 = fused_norms.layer_norm.launches
    y = fused_norms.layer_norm(x)
    torch.cuda.synchronize()
    assert fused_norms.layer_norm.launches == n0 + 1
    ref = fused_norms.ln_reference(x.float(), 1e-6, torch.float32)
    assert y.dtype == torch.bfloat16 and y.shape == x.shape
    assert ((y.float() - ref).abs() <= _bf16_ulp(ref)).all()

    leaf = x.clone().requires_grad_()
    dy = _randn(dev, b, s, d, seed=2)
    (dx,) = torch.autograd.grad(fused_norms.layer_norm(leaf), leaf, dy)
    assert fused_norms.layer_norm.launches == n0 + 2
    fl = x.float().requires_grad_()
    (ref_dx,) = torch.autograd.grad(fused_norms.ln_reference(fl, 1e-6, torch.float32), fl,
                                    dy.float())
    assert dx.dtype == torch.bfloat16 and _rel_l2(dx, ref_dx) <= 2e-2


@pytest.mark.parametrize("b,s", [(2, 0), (0, 5)])
def test_layer_norms_take_zero_rows(dev, b, s):
    """No rows: an empty bf16 output of x's shape, and no launch."""
    x = torch.empty((b, s, 1536), dtype=torch.bfloat16, device=dev)
    mods = _randn(dev, b, 2 * 1536)
    n_mod, n_ln = fused_norms.modulated_layer_norm.launches, fused_norms.layer_norm.launches
    y = fused_norms.modulated_layer_norm(x, mods[:, :1536], mods[:, 1536:])
    z = fused_norms.layer_norm(x)
    torch.cuda.synchronize()
    assert y.shape == z.shape == x.shape and y.dtype == z.dtype == torch.bfloat16
    assert fused_norms.modulated_layer_norm.launches == n_mod
    assert fused_norms.layer_norm.launches == n_ln


def test_layer_norm_kernel_takes_contiguous_rows_only(dev):
    """Strided rows (a column slice of a wider tensor) raise; their
    contiguous copy is normalised as the plain version does."""
    wide = _randn(dev, 2, 33, 3 * 1536) + 0.3
    x = wide[..., 1536:2 * 1536]
    with pytest.raises(ValueError, match="contiguous"):
        fused_norms.layer_norm(x)
    y = fused_norms.layer_norm(x.contiguous())
    ref = fused_norms.ln_reference(x.float(), 1e-6, torch.float32)
    assert ((y.float() - ref).abs() <= _bf16_ulp(ref)).all()


@pytest.mark.parametrize("s_i,s_t", [(1024, 154), (100, 10), (64, 64)])
@pytest.mark.parametrize("use_rms", [True, False])
def test_joint_mha_kernel(dev, s_i, s_t, use_rms):
    h, b = 4, 2
    hd = 64 * h
    # q/k/v as column slices of one fused projection: strided rows, read in place
    img = _randn(dev, b, s_i, 3 * hd, seed=2)
    txt = _randn(dev, b, s_t, 3 * hd, seed=3)
    qi, ki, vi = img.split(hd, dim=-1)
    qt, kt, vt = txt.split(hd, dim=-1)
    w = [1.0 + 0.1 * _randn(dev, 64, dtype=torch.float32, seed=4 + i) for i in range(4)]
    w = w if use_rms else None
    oi, ot = joint_attention.joint_mha(qi, ki, vi, qt, kt, vt, num_heads=h,
                                       rms_weights=w)
    ri, rt = joint_attention.joint_mha_reference(
        *(t.float() for t in (qi, ki, vi, qt, kt, vt)), num_heads=h, rms_weights=w)
    assert oi.shape == (b, s_i, hd) and ot.shape == (b, s_t, hd)
    assert (oi.float() - ri).abs().max() <= 2e-2
    assert (ot.float() - rt).abs().max() <= 2e-2


@pytest.mark.parametrize("s", [1024, 77])
@pytest.mark.parametrize("use_rms", [True, False])
def test_mha_rms_kernel(dev, s, use_rms):
    h, b = 3, 2
    q, k, v = (_randn(dev, b, s, 64 * h, seed=i) for i in range(3))
    w = [1.0 + 0.1 * _randn(dev, 64, dtype=torch.float32, seed=9 + i) for i in range(2)]
    w = w if use_rms else None
    n0 = joint_attention.mha_rms.launches
    o = joint_attention.mha_rms(q, k, v, num_heads=h, rms_weights=w)
    assert joint_attention.mha_rms.launches == n0 + 1
    r = joint_attention.mha_rms_reference(q.float(), k.float(), v.float(), num_heads=h,
                                          rms_weights=w)
    assert (o.float() - r).abs().max() <= 2e-2


def _rel_l2(got, ref):
    return ((got.float() - ref.float()).norm() / ref.float().norm()).item()


@pytest.mark.parametrize("s_i,s_t", [(1024, 154), (100, 10), (64, 64)])
@pytest.mark.parametrize("use_rms", [True, False])
def test_attention_backward_kernels(dev, s_i, s_t, use_rms):
    """Both backward kernels against their plain twin on the same inputs and
    row statistics, q/k/v/do read in place as column slices of one fused
    projection (strided rows), then the whole autograd backward of joint_mha
    against fp32 autograd of the plain forward."""
    h, b = 4, 2
    hd = 64 * h
    img = _randn(dev, b, s_i, 4 * hd, seed=20)
    txt = _randn(dev, b, s_t, 4 * hd, seed=21)
    qi, ki, vi, doi = img.split(hd, dim=-1)
    qt, kt, vt, dot = txt.split(hd, dim=-1)
    w = [1.0 + 0.1 * _randn(dev, 64, dtype=torch.float32, seed=22 + i) for i in range(4)]
    w = w if use_rms else None
    pairs = None if w is None else [tuple(w[:2]), tuple(w[2:])]
    f32 = lambda ts: [t.float() for t in ts]  # noqa: E731

    oi, ot, lse_i, lse_t = joint_attention.joint_attention_fwd(
        qi, ki, vi, qt, kt, vt, w, h, 1e-6, 0.125, True)
    di_i, di_t = bwd_row_stats(oi, doi, h), bwd_row_stats(ot, dot, h)
    n0 = joint_attention.joint_attention_bwd.launches
    got = joint_attention.joint_attention_bwd(qi, ki, vi, qt, kt, vt, doi, dot, lse_i, lse_t,
                                              di_i, di_t, num_heads=h, rms_weights=w)
    assert joint_attention.joint_attention_bwd.launches == n0 + 1
    (a, b_, c), (d, e, f) = joint_attention.attention_bwd_reference(
        f32([qi, qt]), f32([ki, kt]), f32([vi, vt]), f32([doi, dot]), [lse_i, lse_t],
        [di_i, di_t], num_heads=h, rms_weights=pairs)
    for g_, r in zip(got, (a, b_, c, d, e, f)):
        assert g_.shape == r.shape and _rel_l2(g_, r) <= 2e-2

    o, lse = joint_attention.mha_rms_fwd(qi, ki, vi, None if w is None else w[:2], h,
                                         1e-6, 0.125, True)
    di = bwd_row_stats(o, doi, h)
    n0 = joint_attention.mha_rms_bwd.launches
    got = joint_attention.mha_rms_bwd(qi, ki, vi, doi, lse, di, num_heads=h,
                                      rms_weights=None if w is None else w[:2])
    assert joint_attention.mha_rms_bwd.launches == n0 + 1
    ref = joint_attention.attention_bwd_reference(
        f32([qi]), f32([ki]), f32([vi]), f32([doi]), [lse], [di], num_heads=h,
        rms_weights=None if pairs is None else pairs[:1])[0]
    for g_, r in zip(got, ref):
        assert _rel_l2(g_, r) <= 2e-2

    leaves = [t.detach().clone().requires_grad_() for t in (qi, ki, vi, qt, kt, vt)]
    wl = None if w is None else [x.clone().requires_grad_() for x in w]
    outs = joint_attention.joint_mha(*leaves, num_heads=h, rms_weights=wl)
    grads = torch.autograd.grad(outs, leaves + (wl or []), (doi, dot))
    fl = [t.detach().float().requires_grad_() for t in leaves]
    fw = None if w is None else [x.detach().clone().requires_grad_() for x in w]
    ref_outs = joint_attention.joint_mha_reference(*fl, num_heads=h, rms_weights=fw)
    ref_grads = torch.autograd.grad(ref_outs, fl + (fw or []), (doi.float(), dot.float()))
    for g_, r in zip(grads, ref_grads):
        assert _rel_l2(g_, r) <= 2e-2


def _bf16_ulp(ref):
    return torch.exp2(torch.floor(torch.log2(ref.abs().clamp_min(2.0 ** -8))) - 7)


@pytest.mark.parametrize("b,s,hd,heads", [(1, 1536, 3072, 24), (2, 77, 256, 2),
                                          (1, 1560, 5120, 1), (2, 9, 96, 12),
                                          (1, 3, 2056, 1), (2, 8100, 1536, 1)])
@pytest.mark.parametrize("strided", [False, True])
def test_rms_norm_heads_kernel(dev, b, s, hd, heads, strided):
    """Per-head (d = 128, 128, 8) and whole-row (5120, 2056, and WAN's 1536
    over 8,100 rows) RMS, rows read in place from a column slice of a wider
    projection when ``strided``."""
    d = hd // heads
    if strided:
        x = (_randn(dev, b, s, 3 * hd, seed=5) + 0.3)[..., hd:2 * hd]
    else:
        x = _randn(dev, b, s, hd, seed=5) + 0.3
    w = 1.0 + 0.1 * _randn(dev, d, dtype=torch.float32, seed=6)
    n0 = fused_norms.rms_norm_heads.launches
    y = fused_norms.rms_norm_heads(x, w, num_heads=heads)
    torch.cuda.synchronize()
    assert fused_norms.rms_norm_heads.launches == n0 + 1
    ref = fused_norms.rms_reference(x.float(), w, heads, 1e-6, torch.float32)
    assert y.dtype == torch.bfloat16 and y.shape == (b, s, hd) and y.is_contiguous()
    assert ((y.float() - ref).abs() <= _bf16_ulp(ref)).all()


@pytest.mark.parametrize("b,s,h,d,kv_len", [(1, 1536, 24, 128, None), (2, 256, 4, 64, 200),
                                            (2, 100, 2, 128, 77), (1, 4608, 2, 128, 4600),
                                            (3, 33, 3, 64, None)])
@pytest.mark.parametrize("strided", [False, True])
def test_mha_bshd_kernel(dev, b, s, h, d, kv_len, strided):
    """Against the fp32 plain version: output and lse, ragged S, kv_len
    masking, q/k/v read in place as column slices of one fused projection."""
    hd = h * d
    if strided:
        q, k, v = _randn(dev, b, s, 3 * hd, seed=7).split(hd, dim=-1)
    else:
        q, k, v = (_randn(dev, b, s, hd, seed=7 + i) for i in range(3))
    n0 = attention.mha_bshd.launches
    o, lse = attention.mha_bshd_fwd(q, k, v, h, d ** -0.5, kv_len, want_lse=True)
    torch.cuda.synchronize()
    assert attention.mha_bshd.launches == n0 + 1
    ref, ref_lse = attention.mha_bshd_reference(q.float(), k.float(), v.float(), num_heads=h,
                                                kv_len=kv_len, return_lse=True)
    assert o.shape == (b, s, hd) and lse.shape == (b, h, s)
    assert (o.float() - ref).abs().max() <= 2e-2
    assert (lse - ref_lse).abs().max() <= 2e-2
    torch.testing.assert_close(attention.mha_bshd(q, k, v, num_heads=h, kv_len=kv_len), o,
                               rtol=0, atol=0)


@pytest.mark.parametrize("b,sq,skv,h,d,kv_len", [
    (1, 8100, 512, 12, 128, None), (2, 300, 77, 2, 128, None), (2, 45, 200, 3, 64, 190),
    (1, 8100, 8100, 2, 128, None)])
@pytest.mark.parametrize("strided", [False, True])
def test_mha_bshd_kernel_query_and_key_lengths_differ(dev, b, sq, skv, h, d, kv_len, strided):
    """The forward at S_q != S_kv, neither a multiple of the tile (WAN's
    cross-attention: 8,100 video queries on 512 text keys), and WAN's
    self-attention length, against the fp32 plain version (output and lse)."""
    q, k, v, _ = _bshd_backward_case(dev, b, sq, skv, h, d, kv_len, strided, 50)
    n0, c0 = attention.mha_bshd.launches, attention.mha_bshd.cross_launches
    o, lse = attention.mha_bshd_fwd(q, k, v, h, d ** -0.5, kv_len, want_lse=True)
    torch.cuda.synchronize()
    assert attention.mha_bshd.launches == n0 + 1
    assert attention.mha_bshd.cross_launches == c0 + (sq != skv)
    ref, ref_lse = attention.mha_bshd_reference(q.float(), k.float(), v.float(), num_heads=h,
                                                kv_len=kv_len, return_lse=True)
    assert o.shape == (b, sq, h * d) and lse.shape == (b, h, sq)
    assert (o.float() - ref).abs().max() <= 2e-2
    assert (lse - ref_lse).abs().max() <= 2e-2


@pytest.mark.parametrize("s_i,s_t", [(1024, 512), (100, 10), (64, 64)])
@pytest.mark.parametrize("use_rms", [True, False])
def test_joint_mha_kernel_head_dim_128(dev, s_i, s_t, use_rms):
    """The d = 128 instance of the joint forward (Flux: no RMS), strided
    q/k/v, with and without the fused qk-RMS, against the fp32 plain version."""
    h, b = 3, 2
    hd = 128 * h
    qi, ki, vi = _randn(dev, b, s_i, 3 * hd, seed=12).split(hd, dim=-1)
    qt, kt, vt = _randn(dev, b, s_t, 3 * hd, seed=13).split(hd, dim=-1)
    w = [1.0 + 0.1 * _randn(dev, 128, dtype=torch.float32, seed=14 + i) for i in range(4)]
    w = w if use_rms else None
    n0 = joint_attention.joint_mha.launches
    oi, ot = joint_attention.joint_mha(qi, ki, vi, qt, kt, vt, num_heads=h, rms_weights=w)
    assert joint_attention.joint_mha.launches == n0 + 1
    ri, rt = joint_attention.joint_mha_reference(
        *(t.float() for t in (qi, ki, vi, qt, kt, vt)), num_heads=h, rms_weights=w)
    assert (oi.float() - ri).abs().max() <= 2e-2
    assert (ot.float() - rt).abs().max() <= 2e-2


def _bshd_backward_case(dev, b, sq, skv, h, d, kv_len, strided, seed):
    hd = h * d
    if strided:  # q/do and k/v as column slices of wider projections
        q, do = _randn(dev, b, sq, 3 * hd, seed=seed).split(hd, dim=-1)[:2]
        k, v = _randn(dev, b, skv, 3 * hd, seed=seed + 1).split(hd, dim=-1)[1:]
    else:
        q, do = (_randn(dev, b, sq, hd, seed=seed + i) for i in range(2))
        k, v = (_randn(dev, b, skv, hd, seed=seed + 2 + i) for i in range(2))
    return q, k, v, do


@pytest.mark.parametrize("b,sq,skv,h,d,kv_len", [
    (1, 1536, 1536, 24, 128, None), (2, 256, 256, 4, 64, 200), (2, 100, 100, 2, 128, 77),
    (1, 4608, 4608, 2, 128, 4600), (3, 33, 33, 3, 64, None), (2, 100, 160, 2, 128, 150),
    (1, 8100, 512, 12, 128, None), (2, 300, 77, 2, 128, None), (2, 45, 200, 3, 64, 190)])
@pytest.mark.parametrize("strided", [False, True])
def test_mha_bshd_backward_kernel(dev, b, sq, skv, h, d, kv_len, strided):
    """``mha_bshd_bwd_bf16`` against its plain twin on the same inputs and row
    statistics (ragged S, kv_len masking, q and k/v of other lengths, strided
    rows), dk/dv rows past kv_len exactly zero; then the whole autograd
    backward of ``mha_bshd`` against fp32 autograd of the plain forward."""
    q, k, v, do = _bshd_backward_case(dev, b, sq, skv, h, d, kv_len, strided, 30)
    o, lse = attention.mha_bshd_fwd(q, k, v, h, d ** -0.5, kv_len, want_lse=True)
    di = bwd_row_stats(o, do, h)
    n0, c0 = attention.mha_bshd_bwd.launches, attention.mha_bshd_bwd.cross_launches
    got = attention.mha_bshd_bwd(q, k, v, do, lse, di, num_heads=h, kv_len=kv_len)
    torch.cuda.synchronize()
    assert attention.mha_bshd_bwd.launches == n0 + 1
    assert attention.mha_bshd_bwd.cross_launches == c0 + (sq != skv)
    ref = attention.bshd_bwd_reference(q.float(), k.float(), v.float(), do.float(), lse, di,
                                       num_heads=h, kv_len=kv_len)
    for g_, r in zip(got, ref):
        assert g_.shape == r.shape and _rel_l2(g_, r) <= 2e-2
    if kv_len is not None:
        assert not got[1][:, kv_len:].any() and not got[2][:, kv_len:].any()

    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    o = attention.mha_bshd(*leaves, num_heads=h, kv_len=kv_len)
    grads = torch.autograd.grad(o, leaves, do)
    assert attention.mha_bshd_bwd.launches == n0 + 2
    fl = [t.detach().float().requires_grad_() for t in leaves]
    ref_grads = torch.autograd.grad(
        attention.mha_bshd_reference(*fl, num_heads=h, kv_len=kv_len), fl, do.float())
    for g_, r in zip(grads, ref_grads):
        assert _rel_l2(g_, r) <= 2e-2


@pytest.mark.parametrize("s_i,s_t", [(1024, 512), (100, 10), (64, 64)])
def test_joint_attention_backward_kernel_head_dim_128(dev, s_i, s_t):
    """The d = 128 instance of the joint backward (Flux's double blocks, no
    RMS), strided q/k/v/do, against its plain twin and, through the whole
    autograd backward of ``joint_mha``, against fp32 autograd."""
    h, b = 3, 2
    hd = 128 * h
    qi, ki, vi, doi = _randn(dev, b, s_i, 4 * hd, seed=40).split(hd, dim=-1)
    qt, kt, vt, dot = _randn(dev, b, s_t, 4 * hd, seed=41).split(hd, dim=-1)
    streams = (qi, ki, vi, qt, kt, vt)
    oi, ot, lse_i, lse_t = joint_attention.joint_attention_fwd(*streams, None, h, 1e-6,
                                                               128 ** -0.5, True)
    di_i, di_t = bwd_row_stats(oi, doi, h), bwd_row_stats(ot, dot, h)
    n0 = joint_attention.joint_attention_bwd.launches
    got = joint_attention.joint_attention_bwd(*streams, doi, dot, lse_i, lse_t, di_i, di_t,
                                              num_heads=h)
    torch.cuda.synchronize()
    assert joint_attention.joint_attention_bwd.launches == n0 + 1
    (a, b_, c), (d, e, f) = joint_attention.attention_bwd_reference(
        [qi.float(), qt.float()], [ki.float(), kt.float()], [vi.float(), vt.float()],
        [doi.float(), dot.float()], [lse_i, lse_t], [di_i, di_t], num_heads=h)
    for g_, r in zip(got, (a, b_, c, d, e, f)):
        assert g_.shape == r.shape and _rel_l2(g_, r) <= 2e-2

    leaves = [t.detach().clone().requires_grad_() for t in streams]
    grads = torch.autograd.grad(joint_attention.joint_mha(*leaves, num_heads=h), leaves,
                                (doi, dot))
    assert joint_attention.joint_attention_bwd.launches == n0 + 2
    fl = [t.detach().float().requires_grad_() for t in leaves]
    ref_grads = torch.autograd.grad(joint_attention.joint_mha_reference(*fl, num_heads=h), fl,
                                    (doi.float(), dot.float()))
    for g_, r in zip(grads, ref_grads):
        assert _rel_l2(g_, r) <= 2e-2


def test_wrappers_raise_on_what_the_kernels_do_not_take(dev):
    """What no kernel takes raises: mixed dtypes, fp16, a width that is not
    a whole number of 16-byte vectors, a head wider than 128, strides and
    statistics the kernels cannot read. fp32, and bf16 at the widths up to
    128 that the wgmma kernels do not build, take the generic kernels
    (``test_generic_attention_tile_edges``)."""
    x = _randn(dev, 1, 8, 128)
    with pytest.raises(TypeError):  # fp32 x with bf16 scale and shift
        fused_norms.modulated_layer_norm(x.float(), x[:, 0], x[:, 0])
    with pytest.raises(ValueError):  # D not a multiple of 8
        fused_norms.modulated_layer_norm(x[..., :100].contiguous(), x[:, 0, :100],
                                         x[:, 0, :100])
    wide = _randn(dev, 1, 8, 256)
    with pytest.raises(ValueError):  # head dim 256
        joint_attention.mha_rms(wide, wide, wide, num_heads=1)
    with pytest.raises(TypeError):  # fp16 attention
        joint_attention.mha_rms(x.half(), x.half(), x.half(), num_heads=2)
    stats = torch.zeros(1, 2, 8, device=dev)
    with pytest.raises(TypeError):  # fp32 cotangent
        joint_attention.mha_rms_bwd(x, x, x, x.float(), stats, stats, num_heads=2)
    with pytest.raises(ValueError):  # lse of the wrong shape
        joint_attention.mha_rms_bwd(x, x, x, x, stats[:, :1], stats, num_heads=2)
    with pytest.raises(ValueError):  # bf16 row statistics
        joint_attention.joint_attention_bwd(x, x, x, x, x, x, x, x, stats.bfloat16(), stats,
                                            stats, stats, num_heads=2)
    with pytest.raises(ValueError):  # a row stride that is not a multiple of 8
        y = _randn(dev, 1, 8, 130)[..., :128]
        joint_attention.mha_rms_bwd(y, y, y, y, stats, stats, num_heads=2)
    z = _randn(dev, 1, 8, 24)
    with pytest.raises(ValueError):  # head dim 12 in bf16: not a whole 16-byte vector
        attention.mha_bshd(z, z, z, num_heads=2)
    with pytest.raises(ValueError):  # head dim 12
        joint_attention.joint_mha(z, z, z, z, z, z, num_heads=2)
    with pytest.raises(ValueError):  # head dim 12: no backward kernel either
        joint_attention.mha_rms_bwd(z, z, z, z, stats, stats, num_heads=2)
    with pytest.raises(ValueError):  # head dim 256: no single-stream backward either
        joint_attention.mha_rms_bwd(wide, wide, wide, wide, stats[:, :1], stats[:, :1],
                                    num_heads=1)
    s1 = stats[:, :1]
    with pytest.raises(ValueError):  # head dim 256: no fused qk-RMS backward either
        joint_attention.joint_attention_bwd(wide, wide, wide, wide, wide, wide, wide, wide, s1,
                                            s1, s1, s1, num_heads=1,
                                            rms_weights=[torch.ones(256, device=dev)] * 4)
    with pytest.raises(ValueError):  # head dim 12: no BSHD backward either
        attention.mha_bshd_bwd(z, z, z, z, stats, stats, num_heads=2)
    with pytest.raises(TypeError):  # fp32 RMS input, bf16 output
        fused_norms.rms_norm_heads(x.float(), torch.ones(64, device=dev), num_heads=2,
                                   out_dtype=torch.bfloat16)
    with pytest.raises(ValueError):  # d = 24 in 4 heads: not a divisor of 256
        fused_norms.rms_norm_heads(_randn(dev, 1, 8, 96), torch.ones(24, device=dev),
                                   num_heads=4)
    with pytest.raises(ValueError):  # a bf16 RMS weight
        fused_norms.rms_norm_heads(x, torch.ones(64, device=dev).bfloat16(), num_heads=2)
    with pytest.raises(TypeError):  # fp16 LN input
        fused_norms.layer_norm(x.half())
    with pytest.raises(TypeError):  # fp32 LN output of a bf16 input
        fused_norms.layer_norm(x, out_dtype=torch.float32)
    with pytest.raises(ValueError):  # D not a multiple of 8
        fused_norms.layer_norm(_randn(dev, 1, 8, 100))
    with pytest.raises(ValueError):  # not (B, S, D)
        fused_norms.layer_norm(x[0])


# ── the wgmma + TMA backward (#9 and #11) at its tile edges ──────────────


@pytest.mark.parametrize("layout,b,sq,skv,h,d,kv_len,strided", [
    ("bshd", 1, 1, 1, 2, 128, None, False), ("bshd", 1, 127, 127, 2, 64, None, False),
    ("bshd", 2, 128, 128, 2, 128, 1, False), ("bshd", 1, 129, 129, 2, 128, 128, True),
    ("bshd", 1, 257, 257, 3, 64, 129, True), ("bshd", 2, 129, 257, 2, 128, None, True),
    ("bshd", 1, 257, 127, 2, 64, 1, False), ("bhsd", 1, 1, 257, 2, 128, 129, False),
    ("bhsd", 2, 129, 1, 2, 64, None, False), ("bhsd", 1, 257, 128, 2, 128, 1, False),
    ("bhsd", 1, 127, 129, 2, 64, 128, False), ("bhsd", 1, 128, 257, 3, 128, 129, False),
    # few kv tiles over a long q walk: CTAs share each tile's walk (q_splits 2)
    ("bshd", 1, 2048, 130, 2, 64, 129, False), ("bhsd", 1, 2100, 200, 1, 128, 150, False)])
def test_attention_backward_sm90_tile_edges(dev, layout, b, sq, skv, h, d, kv_len, strided):
    """The backward kernel of csrc/attention_bwd_sm90.cu through both entry
    points (``mha_bshd_bwd_bf16``: #9, ``mha_bwd_bf16``: #11) at the edges of
    its 128-row kv and 64-row q tiles (S = 1, 127, 128, 129, 257; kv_len =
    1, 128, 129), S_q != S_kv both ways, strided rows (a fused q/k/v
    projection read in place when S_q = S_kv), and grids small enough that
    CTAs split the q walk (``bwd_scratch``): against the plain twin within
    2e-2 relative L2 per cotangent (with one key, where dq and dk vanish,
    1e-3 absolute), dk and dv rows past kv_len exactly zero,
    and a second call equal to the first (dk, dv bitwise; dq, reduce-added
    into a scratch zeroed per call in an order that varies, within 1e-3)."""
    sm = d ** -0.5
    if layout == "bshd":
        hd = h * d
        if strided and sq == skv:
            q, k, v = _randn(dev, b, sq, 3 * hd, seed=70).split(hd, dim=-1)
            do = _randn(dev, b, sq, hd, seed=71)
        else:
            q, k, v, do = _bshd_backward_case(dev, b, sq, skv, h, d, kv_len, strided, 70)
        o, lse = attention.mha_bshd_fwd(q, k, v, h, sm, kv_len, want_lse=True)
        di = bwd_row_stats(o, do, h)

        def run():
            return attention.mha_bshd_bwd(q, k, v, do, lse, di, num_heads=h, kv_len=kv_len)

        twin = attention.bshd_bwd_reference(q.float(), k.float(), v.float(), do.float(), lse,
                                            di, num_heads=h, kv_len=kv_len)
        kv_dim = 1
    else:
        q, do = _randn(dev, b, h, sq, d, seed=72), _randn(dev, b, h, sq, d, seed=73)
        k, v = _randn(dev, b, h, skv, d, seed=74), _randn(dev, b, h, skv, d, seed=75)
        o, lse = attention.mha_fwd(q, k, v, sm, kv_len, want_lse=True)

        def run():
            return attention.mha_bwd(q, k, v, o, lse, do, sm_scale=sm, kv_len=kv_len)

        twin = attention.flash_bwd_reference(q.float(), k.float(), v.float(), o, lse,
                                             do.float(), sm_scale=sm, kv_len=kv_len)
        kv_dim = 2
    got = run()
    torch.cuda.synchronize()
    for i, (g_, r) in enumerate(zip(got, twin)):
        assert g_.shape == r.shape and torch.isfinite(g_).all()
        if (kv_len or skv) == 1 and i < 2:
            # one key: p = 1 and dp = di, so dq and dk vanish up to rounding
            assert (g_.float() - r).abs().max() <= 1e-3
        else:
            assert _rel_l2(g_, r) <= 2e-2
    if kv_len is not None and kv_len < skv:
        for g_ in got[1:]:
            assert not g_.narrow(kv_dim, kv_len, skv - kv_len).any()
    again = run()
    torch.cuda.synchronize()
    assert torch.equal(again[1], got[1]) and torch.equal(again[2], got[2])
    # (relative, and absolute where dq vanishes: with one key it is exactly 0)
    assert (again[0].float() - got[0].float()).norm() <= 1e-3 * got[0].float().norm() + 1e-6


# ── the wgmma + TMA forward (#8 and #10) at its tile edges ───────────────


@pytest.mark.parametrize("layout,b,sq,skv,h,d,kv_len,strided", [
    ("bshd", 1, 1, 1, 2, 128, None, False), ("bshd", 1, 127, 127, 2, 64, None, False),
    ("bshd", 2, 128, 128, 2, 128, 1, False), ("bshd", 1, 129, 129, 2, 128, 128, True),
    ("bshd", 1, 257, 257, 3, 64, 129, True), ("bshd", 2, 129, 257, 2, 128, None, True),
    ("bshd", 1, 257, 127, 2, 64, 1, False), ("bshd", 1, 300, 600, 2, 128, 450, True),
    ("bshd", 2, 65, 300, 2, 64, 100, True), ("bhsd", 1, 1, 257, 2, 128, 129, False),
    ("bhsd", 2, 129, 1, 2, 64, None, False), ("bhsd", 1, 257, 128, 2, 128, 1, False),
    ("bhsd", 1, 127, 129, 2, 64, 128, False), ("bhsd", 1, 128, 257, 3, 128, 129, False),
    ("bhsd", 1, 65, 257, 2, 128, 100, False), ("bhsd", 2, 300, 1178, 2, 64, 1100, False)])
def test_attention_forward_sm90_tile_edges(dev, layout, b, sq, skv, h, d, kv_len, strided):
    """The forward kernel of csrc/attention_fwd_sm90.cu through both entry
    points (``mha_bshd_fwd_bf16``: #8, ``mha_fwd_bf16``: #10) at the edges of
    its 128-row q and kv tiles: S = 1, 127, 128, 129, 257, 300; S_q != S_kv
    both ways; kv_len inside the first kv tile (1, 100) and inside the last
    walked one (129, 450, 1100), with the tiles wholly past it (e.g. keys
    1,152..1,177 at kv_len 1,100) never walked; q, k, v read in place as
    column slices of fused projections; with and without the lse. Against
    the fp32 plain version: o within 1e-2 relative L2, lse within 5e-3
    absolute (``test_mha_kernels``' limits); without the lse, o bitwise the
    same; one launch per call, counted as cross-attention when S_q !=
    S_kv."""
    sm = d ** -0.5
    if layout == "bshd":
        hd = h * d
        if strided and sq == skv:
            q, k, v = _randn(dev, b, sq, 3 * hd, seed=80).split(hd, dim=-1)
        else:
            q, k, v, _ = _bshd_backward_case(dev, b, sq, skv, h, d, kv_len, strided, 80)
        op, fwd = attention.mha_bshd, lambda lse: attention.mha_bshd_fwd(q, k, v, h, sm, kv_len,
                                                                         want_lse=lse)
        ref, ref_lse = attention.mha_bshd_reference(q.float(), k.float(), v.float(), num_heads=h,
                                                    kv_len=kv_len, return_lse=True)
    else:
        q, k, v = (_randn(dev, b, h, n, d, seed=81 + i) for i, n in enumerate((sq, skv, skv)))
        op, fwd = attention.mha, lambda lse: attention.mha_fwd(q, k, v, sm, kv_len, want_lse=lse)
        ref, ref_lse = attention.attention_reference(q.float(), k.float(), v.float(), sm_scale=sm,
                                                     kv_len=kv_len, return_lse=True)
    n0, c0 = op.launches, op.cross_launches
    o, lse = fwd(True)
    o2, none = fwd(False)
    torch.cuda.synchronize()
    assert op.launches == n0 + 2 and op.cross_launches == c0 + 2 * (sq != skv)
    assert none is None and o.shape == q.shape and lse.shape == (b, h, sq)
    assert torch.isfinite(o).all() and torch.isfinite(lse).all()
    assert _rel_l2(o, ref) <= 1e-2 and (lse - ref_lse).abs().max() <= 5e-3
    assert torch.equal(o2, o)


# ── the joint forward (#2, #3) on the wgmma + TMA kernel ────────────────


def _joint_streams(dev, b, s_i, s_t, h, d, strided, seed):
    """q, k, v of the image and the text stream; ``strided``: column slices
    of one fused (B, S, 3*H*D) projection per stream, read in place."""
    hd = h * d
    if strided:
        return (*_randn(dev, b, s_i, 3 * hd, seed=seed).split(hd, dim=-1),
                *_randn(dev, b, s_t, 3 * hd, seed=seed + 1).split(hd, dim=-1))
    return tuple(_randn(dev, b, s, hd, seed=seed + i)
                 for i, s in enumerate((s_i, s_i, s_i, s_t, s_t, s_t)))


def _check_joint_out(outs, ref, twin, heads):
    """Each output against the fp32 plain version (2e-2 absolute, the lse
    too, as ``test_mha_bshd_kernel``: with one or two keys the bf16 rounding
    of q^ and k^ reaches the lse undiluted) and within 1 bf16 spacing of the
    kernel-order twin (lse 1e-4), the spacing taken at the largest |twin| of
    each (row, head): the twin rounds q^, k^ and p where the kernel does and
    computes q^ and k^ bit for bit as it does, but its fp32 products sum in
    another order, and a last-bit difference that flips the rounding of a p
    moves the whole row by up to about one spacing at its largest output."""
    (o_outs, lse_outs), (o_ref, lse_ref), (o_twin, lse_twin) = outs, ref, twin
    for o, r, tw in zip(o_outs, o_ref, o_twin):
        assert o.shape == r.shape and torch.isfinite(o).all()
        assert (o.float() - r).abs().max() <= 2e-2
        b, s, hd = tw.shape
        t4, o4 = (x.float().view(b, s, heads, hd // heads) for x in (tw, o))
        peak = t4.abs().amax(-1, keepdim=True)
        assert ((o4 - t4).abs() <= _bf16_ulp(peak)).all()
    for lse, r, tw in zip(lse_outs, lse_ref, lse_twin):
        assert lse.shape == r.shape and torch.isfinite(lse).all()
        assert (lse - r).abs().max() <= 2e-2 and (lse - tw).abs().max() <= 1e-4


@pytest.mark.parametrize("s_i,s_t", [(1, 1), (127, 129), (128, 128), (129, 154), (154, 1),
                                     (257, 127), (1, 257)])
@pytest.mark.parametrize("d,use_rms,strided", [(64, True, True), (128, False, True),
                                                (64, False, False), (128, True, False)])
def test_joint_attention_forward_sm90_tile_edges(dev, s_i, s_t, d, use_rms, strided):
    """``joint_attention_fwd_bf16`` (#2) at the edges of its 128-row q and kv
    tiles on both streams (1, 127, 128, 129, 154, 257 tokens; q tiles that
    hold only text), d = 64 / 128 with and without the fused qk-RMS (weights
    1 + 0.1 randn, so a missed rewrite of q or k shows), contiguous and
    column-slice inputs; with the lse against the fp32 plain version and
    the kernel-order twin, without it the same output bitwise; one launch
    per call."""
    b, h = 2, 2
    streams = _joint_streams(dev, b, s_i, s_t, h, d, strided, 90 + s_i + s_t)
    w = ([1.0 + 0.1 * _randn(dev, d, dtype=torch.float32, seed=95 + i) for i in range(4)]
         if use_rms else None)
    n0 = joint_attention.joint_mha.launches
    o_i, o_t, l_i, l_t = joint_attention.joint_attention_fwd(*streams, w, h, 1e-6, d ** -0.5,
                                                             True)
    o_i2, o_t2, none_i, none_t = joint_attention.joint_attention_fwd(*streams, w, h, 1e-6,
                                                                     d ** -0.5, False)
    torch.cuda.synchronize()
    assert joint_attention.joint_mha.launches == n0 + 2
    assert none_i is None and none_t is None
    assert torch.equal(o_i2, o_i) and torch.equal(o_t2, o_t)
    r_i, r_t, rl_i, rl_t = joint_attention.joint_mha_reference(
        *(t.float() for t in streams), num_heads=h, rms_weights=w, return_lse=True)
    qi, ki, vi, qt, kt, vt = streams
    pairs = [(w[0], w[1]), (w[2], w[3])] if use_rms else None
    twin = joint_attention.joint_fwd_tiled_reference([qi, qt], [ki, kt], [vi, vt], num_heads=h,
                                                     rms_weights=pairs)
    _check_joint_out(([o_i, o_t], [l_i, l_t]), ([r_i, r_t], [rl_i, rl_t]), twin, h)


@pytest.mark.parametrize("s", [1, 127, 128, 129, 257, 1024])
@pytest.mark.parametrize("d,use_rms", [(64, True), (128, False), (64, False), (128, True)])
def test_mha_rms_forward_sm90_tile_edges(dev, s, d, use_rms):
    """``mha_rms_fwd_bf16`` (#3): the joint kernel with no second stream, at
    the tile edges, against the fp32 plain version and the twin."""
    b, h = 2, 3
    q, k, v = (_randn(dev, b, s, h * d, seed=100 + i) for i in range(3))
    w = ([1.0 + 0.1 * _randn(dev, d, dtype=torch.float32, seed=105 + i) for i in range(2)]
         if use_rms else None)
    n0 = joint_attention.mha_rms.launches
    o, lse = joint_attention.mha_rms_fwd(q, k, v, w, h, 1e-6, d ** -0.5, True)
    torch.cuda.synchronize()
    assert joint_attention.mha_rms.launches == n0 + 1
    r, rl = joint_attention.mha_rms_reference(q.float(), k.float(), v.float(), num_heads=h,
                                              rms_weights=w, return_lse=True)
    twin = joint_attention.joint_fwd_tiled_reference([q], [k], [v], num_heads=h,
                                                     rms_weights=[tuple(w)] if w else None)
    _check_joint_out(([o], [lse]), ([r], [rl]), twin, h)


def test_joint_forward_raises_on_views_the_maps_cannot_take(dev):
    """A view whose base is not 16-byte aligned, or whose row stride is not a
    multiple of 8 elements, raises: no fallback to the plain version."""
    h, d = 2, 64
    wide = _randn(dev, 1, 40, 2 * h * d + 8)
    good = wide[..., :h * d]
    odd_base = wide[..., 1:1 + h * d]  # 2-byte offset
    odd_rows = _randn(dev, 1, 40, h * d + 4)[..., :h * d]  # row stride 132
    n0, m0 = joint_attention.joint_mha.launches, joint_attention.mha_rms.launches
    for bad in (odd_base, odd_rows):
        with pytest.raises(ValueError, match="16-byte aligned"):
            joint_attention.joint_mha(good, good, good, bad, good, good, num_heads=h)
        with pytest.raises(ValueError, match="16-byte aligned"):
            joint_attention.mha_rms(good, bad, good, num_heads=h)
    assert joint_attention.joint_mha.launches == n0 and joint_attention.mha_rms.launches == m0


# ── the joint backward (#4, #5) on the wgmma + TMA kernel ───────────────


def _check_joint_bwd(got, streams, dos, lses, dis, heads, pairs):
    """The pre-pass's operands of the call that gave ``got`` against the twin's
    (``joint_operands``, the forward twin's q^ and k^) bit for bit; then each
    cotangent (dyq, dyk, dv per stream) against the plain twin on the same
    inputs and row statistics, 2e-2 relative L2 (bf16 p and t) or 1e-5
    absolute: with a single key p = 1 and dp = di, so the exact dyq and dyk
    vanish and both sides hold only the fp32 rounding of dp - di (~1e-6),
    where relative L2 has no scale; a wrong product gives O(1)."""
    n = len(dos)
    qs, ks, vs = streams[0::3][:n], streams[1::3][:n], streams[2::3][:n]
    ops = joint_attention.bwd_operands(qs[0], [q.shape[1] for q in qs], pairs is not None)
    want = joint_attention.joint_operands(qs, ks, num_heads=heads, rms_weights=pairs)
    for gs, ws in zip(ops, want):
        for g_, w_ in zip(gs, ws):
            if g_ is not None:
                assert torch.equal(attention.to_bhsd(g_, heads).float(), w_)
    f32 = lambda ts: [t.float() for t in ts]  # noqa: E731
    twin = joint_attention.attention_bwd_reference(f32(qs), f32(ks), f32(vs), f32(dos), lses,
                                                   dis, num_heads=heads, rms_weights=pairs)
    for g_, r in zip(got, [a for st in twin for a in st]):
        assert g_.shape == r.shape and torch.isfinite(g_).all()
        assert _rel_l2(g_, r) <= 2e-2 or (g_.float() - r).abs().max() <= 1e-5


@pytest.mark.parametrize("s_i,s_t", [(1, 154), (100, 1), (129, 63), (64, 64), (257, 65),
                                     (100, 154)])
@pytest.mark.parametrize("d,use_rms", [(64, True), (64, False), (128, False)])
@pytest.mark.parametrize("strided", [False, True])
def test_joint_attention_backward_sm90_tile_edges(dev, s_i, s_t, d, use_rms, strided):
    """``joint_attention_bwd_bf16`` (#4) at the edges of its 128-row kv and
    64-row q tiles on both streams (1, 63, 64, 65, 100, 129, 154, 257 tokens;
    the image stream not a multiple of 64), d = 64 with and without the qk-RMS
    and d = 128 without, contiguous inputs and column slices of a fused (B, S,
    3*H*D) projection read in place: the pre-pass bitwise, the cotangents
    against the twin; one wrapper launch per call."""
    b, h = 2, 2
    streams = _joint_streams(dev, b, s_i, s_t, h, d, strided, 110 + s_i + s_t)
    dos = [_randn(dev, b, s, h * d, seed=115 + i) for i, s in enumerate((s_i, s_t))]
    w = ([1.0 + 0.1 * _randn(dev, d, dtype=torch.float32, seed=117 + i) for i in range(4)]
         if use_rms else None)
    pairs = [(w[0], w[1]), (w[2], w[3])] if use_rms else None
    o_i, o_t, l_i, l_t = joint_attention.joint_attention_fwd(*streams, w, h, 1e-6, d ** -0.5,
                                                             True)
    dis = [bwd_row_stats(o, c, h) for o, c in zip((o_i, o_t), dos)]
    n0 = joint_attention.joint_attention_bwd.launches
    got = joint_attention.joint_attention_bwd(*streams, *dos, l_i, l_t, *dis, num_heads=h,
                                              rms_weights=w)
    torch.cuda.synchronize()
    assert joint_attention.joint_attention_bwd.launches == n0 + 1
    _check_joint_bwd(got, streams, dos, [l_i, l_t], dis, h, pairs)


@pytest.mark.parametrize("s", [1, 63, 65, 154, 1024])
@pytest.mark.parametrize("use_rms", [True, False])
@pytest.mark.parametrize("strided", [False, True])
def test_mha_rms_backward_sm90_tile_edges(dev, s, use_rms, strided):
    """``mha_rms_bwd_bf16`` (#5): the joint backward with no second stream, at
    the tile edges, with and without the qk-RMS, contiguous and fused-slice
    inputs: the pre-pass bitwise, the cotangents against the twin."""
    b, h, d = 2, 3, 64
    streams = _joint_streams(dev, b, s, 0, h, d, strided, 120 + s)
    do = _randn(dev, b, s, h * d, seed=125)
    w = ([1.0 + 0.1 * _randn(dev, d, dtype=torch.float32, seed=126 + i) for i in range(2)]
         if use_rms else None)
    o, lse = joint_attention.mha_rms_fwd(*streams[:3], w, h, 1e-6, d ** -0.5, True)
    di = bwd_row_stats(o, do, h)
    n0 = joint_attention.mha_rms_bwd.launches
    got = joint_attention.mha_rms_bwd(*streams[:3], do, lse, di, num_heads=h, rms_weights=w)
    torch.cuda.synchronize()
    assert joint_attention.mha_rms_bwd.launches == n0 + 1
    _check_joint_bwd(got, streams, [do], [lse], [di], h, [tuple(w)] if use_rms else None)


@pytest.mark.parametrize("s_t", [154, 0])
def test_joint_backward_call_is_three_kernels(dev, s_t):
    """One call of #4 (or #5, no text stream) launches three kernels on the
    card: the operand pre-pass, the backward and the dq convert (device
    kernels counted by torch.profiler); two calls give dk and dv bitwise (dq
    is reduce-added in an order that varies)."""
    from torch.profiler import ProfilerActivity, profile

    b, h, d = 2, 2, 64
    streams = _joint_streams(dev, b, 100, s_t, h, d, False, 130)
    dos = [_randn(dev, b, s, h * d, seed=135 + i) for i, s in enumerate((100, s_t)) if s]
    w = [1.0 + 0.1 * _randn(dev, d, dtype=torch.float32, seed=137 + i) for i in range(4)]
    if s_t:
        o_i, o_t, l_i, l_t = joint_attention.joint_attention_fwd(*streams, w, h, 1e-6, 0.125,
                                                                 True)
        dis = [bwd_row_stats(o, c, h) for o, c in zip((o_i, o_t), dos)]
        fn = lambda: joint_attention.joint_attention_bwd(  # noqa: E731
            *streams, *dos, l_i, l_t, *dis, num_heads=h, rms_weights=w)
    else:
        o, lse = joint_attention.mha_rms_fwd(*streams[:3], w[:2], h, 1e-6, 0.125, True)
        di = bwd_row_stats(o, dos[0], h)
        fn = lambda: joint_attention.mha_rms_bwd(  # noqa: E731
            *streams[:3], dos[0], lse, di, num_heads=h, rms_weights=w[:2])
    first = fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        second = fn()
        torch.cuda.synchronize()
    kernels = [e.key for e in prof.key_averages() if e.device_type.name == "CUDA"]
    assert len(kernels) == 3 and sum(e.count for e in prof.key_averages()
                                     if e.device_type.name == "CUDA") == 3, kernels
    assert {re.search(r"attn_bwd_[a-z0-9_]+", k)[0] for k in kernels} == {
        "attn_bwd_prepass_kernel", "attn_bwd_sm90_kernel", "attn_bwd_convert_kernel"}, kernels
    for a, c in zip(first, second):
        assert a.shape == c.shape
    for i in range(len(first) // 3):
        assert torch.equal(first[3 * i + 1], second[3 * i + 1])
        assert torch.equal(first[3 * i + 2], second[3 * i + 2])


# ── kernels #10 / #11: mha on (B, H, S, D) ───────────────────────────────


@pytest.mark.parametrize("b,h,sq,skv,d,kv_len", [
    (1, 12, 8100, 8100, 128, None), (2, 24, 1178, 1178, 64, 1100), (1, 12, 2025, 8100, 128, None),
    (2, 3, 100, 100, 64, 77), (1, 2, 33, 200, 128, 190), (3, 2, 300, 45, 64, None)])
def test_mha_kernels(dev, b, h, sq, skv, d, kv_len):
    """``mha_fwd_bf16`` (#10) against the fp32 plain forward (output 1e-2
    relative L2: over thousands of keys a typical |o| is near an absolute
    2e-2; lse 5e-3 absolute) and ``mha_bwd_bf16`` (#11) against its all-fp32 twin
    on the same o and lse (2e-2 relative L2; dk/dv rows past kv_len exactly
    zero), ragged S and S_q != S_kv; then the autograd path of ``mha``."""
    q, do = _randn(dev, b, h, sq, d, seed=50), _randn(dev, b, h, sq, d, seed=51)
    k, v = _randn(dev, b, h, skv, d, seed=52), _randn(dev, b, h, skv, d, seed=53)
    sm = d ** -0.5
    n0, c0 = attention.mha.launches, attention.mha.cross_launches
    o, lse = attention.mha_fwd(q, k, v, sm, kv_len, want_lse=True)
    torch.cuda.synchronize()
    assert attention.mha.launches == n0 + 1
    assert attention.mha.cross_launches == c0 + (sq != skv)
    ref, ref_lse = attention.attention_reference(q.float(), k.float(), v.float(), sm_scale=sm,
                                                 kv_len=kv_len, return_lse=True)
    assert _rel_l2(o, ref) <= 1e-2 and (lse - ref_lse).abs().max() <= 5e-3

    m0 = attention.mha_bwd.launches
    got = attention.mha_bwd(q, k, v, o, lse, do, sm_scale=sm, kv_len=kv_len)
    torch.cuda.synchronize()
    assert attention.mha_bwd.launches == m0 + 1
    twin = attention.flash_bwd_reference(q.float(), k.float(), v.float(), o, lse, do.float(),
                                         sm_scale=sm, kv_len=kv_len)
    for g_, r in zip(got, twin):
        assert g_.shape == r.shape and _rel_l2(g_, r) <= 2e-2
    if kv_len is not None:
        assert not got[1][:, :, kv_len:].any() and not got[2][:, :, kv_len:].any()

    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    grads = torch.autograd.grad(attention.mha(*leaves, kv_len=kv_len), leaves, do)
    assert attention.mha_bwd.launches == m0 + 2
    fl = [t.detach().float().requires_grad_() for t in leaves]
    ref_grads = torch.autograd.grad(
        attention.attention_reference(*fl, sm_scale=sm, kv_len=kv_len), fl, do.float())
    for g_, r in zip(grads, ref_grads):
        assert _rel_l2(g_, r) <= 2e-2


def test_mha_raises_on_what_the_kernels_do_not_take(dev):
    x = _randn(dev, 1, 2, 64, 64)
    wide = _randn(dev, 1, 2, 64, 256)
    with pytest.raises(ValueError):  # head dim 256 (32 takes the generic kernel)
        attention.mha(wide, wide, wide)
    with pytest.raises(TypeError):  # fp16 (fp32 takes the generic kernel)
        attention.mha(x.half(), x.half(), x.half())
    with pytest.raises(ValueError):  # not contiguous
        attention.mha(x.transpose(1, 2), x.transpose(1, 2), x.transpose(1, 2))
    with pytest.raises(ValueError):  # (B, S, H*D)
        attention.mha(x[0], x[0], x[0])
    stats = torch.zeros(1, 2, 64, device=dev)
    with pytest.raises(ValueError):  # lse of the wrong shape
        attention.mha_bwd(x, x, x, x, stats[:, :1], x, sm_scale=0.125)


# ── the generic kernels: fp32, and bf16 at the widths the wgmma ones lack ──



def _routes_generic(dtype, d, mode, rms):
    """Whether a direction of ``mode`` (with the fused RMS or without)
    routes to the generic kernels: the pure route, on a device object only,
    so no card is asked while collecting."""
    return any(attention.attention_route(torch.device("cuda"), getattr(torch, dtype), d,
                                         mode=mode, rms=rms, direction=r) == "generic"
               for r in ("fwd", "bwd"))

# S at the generic kernels' tile edges (64-row q tiles; 128-row forward and
# 64-row backward kv tiles): per mode the chip_smoke.py ``_kr_case`` shape;
# the text stream's length the other way round; joint and single with the
# fused qk-RMS and without it (Flux's joint call); BSHD / BHSD over 150 keys
# with kv_len in the first tile (40) and in the last (140)
_EDGE_S = (1, 63, 64, 65, 129)
_EDGE_TEXT = {1: 129, 63: 64, 64: 63, 65: 1, 129: 37}
_EDGE_CASES = ([("joint", rms, lambda s: (1, s, _EDGE_TEXT[s], 2)) for rms in (True, False)]
               + [("single", rms, lambda s: (2, s, 2)) for rms in (True, False)]
               + [("bshd", False, lambda s, kv=kv: (1, s, 150, 2, kv)) for kv in (40, 140)]
               + [("bhsd", False, lambda s, kv=kv: (1, 2, s, 150, kv)) for kv in (40, 140)])


@pytest.fixture
def no_tf32(dev):
    """fp32 matmuls of the plain versions in full fp32."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    yield dev
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


# every (dtype, head width) of tests/test_torch_kernel_range.py's route test,
# each case whose mode routes there to the generic kernels, at each S
_EDGE_PARAMS = [(dt, d, s, i) for dt in ("float32", "bfloat16")
                for d in (8, 16, 32, 48, 64, 80, 128)
                for i, (mode, rms, _) in enumerate(_EDGE_CASES)
                if _routes_generic(dt, d, mode, rms)
                for s in _EDGE_S]


@pytest.mark.parametrize("dtype,d,s,case", _EDGE_PARAMS)
def test_generic_attention_tile_edges(no_tf32, dtype, d, s, case):
    """Each (mode, direction) of the width that routes to the generic kernels,
    forward and backward, against the plain versions (chip_smoke.py
    ``_kr_case``: fp32 within 1e-5 / 1e-4 relative L2 of the twins; bf16
    within 2e-2 of fp32 and, for the joint and single forward, 1 bf16
    spacing of the twin at each row's largest output), each call one generic
    launch and no wgmma one; then the autograd path of the public wrapper
    with dk / dv exactly zero past kv_len."""
    import chip_smoke

    mode, rms, shape_of = _EDGE_CASES[case]
    dt = getattr(torch, dtype)
    shape = shape_of(s)
    g = torch.Generator(device="cuda").manual_seed(d + s + case)
    chip_smoke._kr_case(mode, dt, d, shape, g, rms=rms)
    if mode in ("bshd", "bhsd") and attention.attention_route(
            torch.device("cuda"), dt, d, mode=mode, direction="bwd") == "generic":
        streams, _, h = chip_smoke._kr_inputs(mode, dt, d, shape, g)
        q, k, v, do = (t.detach().requires_grad_() if i < 3 else t
                       for i, t in enumerate(streams[0]))
        kv = shape[-1]
        n0 = (attention.mha_bshd_bwd.generic_launches + attention.mha_bwd.generic_launches)
        if mode == "bshd":
            out = attention.mha_bshd(q, k, v, num_heads=h, kv_len=kv)
        else:
            out = attention.mha(q, k, v, kv_len=kv)
        dq, dk, dv = torch.autograd.grad(out, (q, k, v), do)
        torch.cuda.synchronize()
        assert attention.mha_bshd_bwd.generic_launches + attention.mha_bwd.generic_launches == n0 + 1
        rows = (slice(None), slice(kv, None)) if mode == "bshd" else (
            slice(None), slice(None), slice(kv, None))
        assert not dk[rows].any() and not dv[rows].any()
        assert torch.isfinite(dq).all()


# chip_smoke.py's full-width fp32 rows (KR_FULL), by "name mode"
_FULL_ROWS = ("sd3 joint", "sd3 single", "flux joint", "wan bshd", "cp bhsd")


@pytest.mark.parametrize("row", _FULL_ROWS)
def test_generic_fp32_full_width_repeats_bitwise(no_tf32, row):
    """The fp32 generic kernels (3xTF32 on the tensor cores) at the full-width
    rows, with and without the fused qk-RMS as the models call them: forward
    and backward against the twins at the unchanged bounds (chip_smoke.py
    ``_kr_case``: 1e-5 / 1e-4 relative L2), then two calls each way on the
    same inputs bitwise equal (no atomics, so an fp32 run repeats)."""
    import chip_smoke

    name, mode, shape, d, rms = next(r for r in chip_smoke.KR_FULL if f"{r[0]} {r[1]}" == row)
    g = torch.Generator(device="cuda").manual_seed(23)
    chip_smoke._kr_case(mode, torch.float32, d, shape, g, rms=rms)
    streams, pairs, h = chip_smoke._kr_inputs(mode, torch.float32, d, shape, g, rms)
    kv_len = shape[-1] if mode in ("bshd", "bhsd") else None
    ref, ref_lse = chip_smoke._kr_plain_fwd(mode, streams, pairs, h, d, kv_len)
    for call in (lambda: chip_smoke._kr_fwd(mode, streams, pairs, h, d, kv_len),
                 lambda: chip_smoke._kr_bwd(mode, streams, pairs, h, d, kv_len, ref, ref_lse,
                                            False)):
        first = [t.clone() for t in chip_smoke._flat(call())]
        again = chip_smoke._flat(call())
        assert len(first) == len(again) and all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.parametrize("b,s,d", [(2, 154, 1536), (1, 8100, 1536), (1, 5, 3072), (2, 7, 32),
                                   (1, 3, 16384), (8, 77, 1536), (1, 9, 3080), (3, 1, 4)])
def test_fp32_layer_norm_kernels(no_tf32, b, s, d):
    """``lnmod_f32`` and ``ln_f32`` (the LayerNorm template with 4-element
    vectors: a warp a row up to d = 1536 in 6 or 12 vectors a lane, a CTA a
    row above) against the fp32 plain versions, 1e-6 relative L2, one launch
    each, fp32 out; the autograd path's closed-form backward beside it."""
    dev = no_tf32
    x = _randn(dev, b, s, d, dtype=torch.float32) + 0.5
    mods = _randn(dev, b, 3 * d, dtype=torch.float32, seed=1)
    sc, sh = mods[:, :d], mods[:, 2 * d:]
    n_mod, n_ln = fused_norms.modulated_layer_norm.launches, fused_norms.layer_norm.launches
    y = fused_norms.modulated_layer_norm(x, sc, sh)
    z = fused_norms.layer_norm(x)
    torch.cuda.synchronize()
    assert (fused_norms.modulated_layer_norm.launches, fused_norms.layer_norm.launches) == (
        n_mod + 1, n_ln + 1)
    assert y.dtype == z.dtype == torch.float32
    assert _rel_l2(y, fused_norms.lnmod_reference(x, sc, sh, 1e-6, torch.float32)) <= 1e-6
    assert _rel_l2(z, fused_norms.ln_reference(x, 1e-6, torch.float32)) <= 1e-6
    leaf = x.clone().requires_grad_()
    dy = _randn(dev, b, s, d, dtype=torch.float32, seed=2)
    (dx,) = torch.autograd.grad(fused_norms.layer_norm(leaf), leaf, dy)
    fl = x.clone().requires_grad_()
    (ref_dx,) = torch.autograd.grad(fused_norms.ln_reference(fl, 1e-6, torch.float32), fl, dy)
    assert _rel_l2(dx, ref_dx) <= 1e-5


@pytest.mark.parametrize("b,s,hd,heads", [(1, 1536, 3072, 24), (2, 9, 32, 2), (1, 8100, 1536, 1),
                                          (1, 40, 32, 1), (3, 7, 64, 16), (1, 5, 16384, 1)])
@pytest.mark.parametrize("strided", [False, True])
def test_fp32_rms_norm_heads_kernel(no_tf32, b, s, hd, heads, strided):
    """``rms_heads_f32``: heads of 4..128 reduced by lane shuffles, one head
    over the whole row by the block; rows read through their strides."""
    dev = no_tf32
    x = _randn(dev, b, s, 2 * hd if strided else hd, dtype=torch.float32)[..., :hd]
    w = 1.0 + 0.1 * _randn(dev, hd // heads, dtype=torch.float32, seed=3)
    n0 = fused_norms.rms_norm_heads.launches
    y = fused_norms.rms_norm_heads(x, w, num_heads=heads)
    torch.cuda.synchronize()
    assert fused_norms.rms_norm_heads.launches == n0 + 1 and y.dtype == torch.float32
    assert _rel_l2(y, fused_norms.rms_reference(x, w, heads, 1e-6, torch.float32)) <= 1e-6


def test_ci_presets_run_on_the_card(no_tf32, tmp_path):
    """The README's five CPU commands with ``--device cpu`` dropped (the fp32
    tiny SD3, Flux and WAN presets) and ``cli.infer`` at full SD3.5-M width
    in fp32, through their entry points on the card: every launch count as
    derived from the configs, finite metrics (chip_smoke.py
    ``run_kernel_range_presets``)."""
    import chip_smoke

    counts = chip_smoke.run_kernel_range_presets(str(tmp_path))
    assert counts["sd3"]["joint"] and counts["flux"]["bshd"] and counts["wan"]["ln"]
