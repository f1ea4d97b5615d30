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
all-fp32 twin; the wgmma + TMA backward (#9, #11) at its tile edges.
"""

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


@pytest.mark.parametrize("b,s,d", [(2, 154, 1536), (2, 1024, 1536), (3, 7, 64),
                                   (1, 5, 8192), (1, 3, 32768)])
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
                                   (3, 7, 64), (1, 5, 8192), (1, 3, 32768)])
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
    x = _randn(dev, 1, 8, 128)
    with pytest.raises(TypeError):  # fp32
        fused_norms.modulated_layer_norm(x.float(), x[:, 0].float(), x[:, 0].float())
    with pytest.raises(ValueError):  # D not a multiple of 8
        fused_norms.modulated_layer_norm(x[..., :100].contiguous(), x[:, 0, :100],
                                         x[:, 0, :100])
    with pytest.raises(ValueError):  # head dim 32
        joint_attention.mha_rms(x, x, x, num_heads=4)
    with pytest.raises(TypeError):  # fp32 attention
        joint_attention.mha_rms(x.float(), x.float(), x.float(), num_heads=2)
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
    z = _randn(dev, 1, 8, 192)
    with pytest.raises(ValueError):  # head dim 96
        attention.mha_bshd(z, z, z, num_heads=2)
    with pytest.raises(ValueError):  # head dim 96
        joint_attention.joint_mha(z, z, z, z, z, z, num_heads=2)
    with pytest.raises(ValueError):  # head dim 96: no backward kernel either
        joint_attention.mha_rms_bwd(z, z, z, z, stats, stats, num_heads=2)
    with pytest.raises(ValueError):  # the single-stream RMS backward takes d = 64 only
        joint_attention.mha_rms_bwd(x, x, x, x, stats[:, :1], stats[:, :1], num_heads=1)
    s1 = stats[:, :1]
    with pytest.raises(ValueError):  # no fused qk-RMS in the backward at d = 128
        joint_attention.joint_attention_bwd(x, x, x, x, x, x, x, x, s1, s1, s1, s1, num_heads=1,
                                            rms_weights=[torch.ones(128, device=dev)] * 4)
    with pytest.raises(ValueError):  # head dim 96: no BSHD backward either
        attention.mha_bshd_bwd(z, z, z, z, stats, stats, num_heads=2)
    with pytest.raises(TypeError):  # fp32 RMS input
        fused_norms.rms_norm_heads(x.float(), torch.ones(64, device=dev), num_heads=2)
    with pytest.raises(ValueError):  # d = 24 in 4 heads: not a divisor of 256
        fused_norms.rms_norm_heads(_randn(dev, 1, 8, 96), torch.ones(24, device=dev),
                                   num_heads=4)
    with pytest.raises(ValueError):  # a bf16 RMS weight
        fused_norms.rms_norm_heads(x, torch.ones(64, device=dev).bfloat16(), num_heads=2)
    with pytest.raises(TypeError):  # fp32 LN input
        fused_norms.layer_norm(x.float())
    with pytest.raises(TypeError):  # fp32 LN output
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
    with pytest.raises(ValueError):  # head dim 32
        attention.mha(x[..., :32].contiguous(), x[..., :32].contiguous(),
                      x[..., :32].contiguous())
    with pytest.raises(TypeError):  # fp32
        attention.mha(x.float(), x.float(), x.float())
    with pytest.raises(ValueError):  # not contiguous
        attention.mha(x.transpose(1, 2), x.transpose(1, 2), x.transpose(1, 2))
    with pytest.raises(ValueError):  # (B, S, H*D)
        attention.mha(x[0], x[0], x[0])
    stats = torch.zeros(1, 2, 64, device=dev)
    with pytest.raises(ValueError):  # lse of the wrong shape
        attention.mha_bwd(x, x, x, x, stats[:, :1], x, sm_scale=0.125)
