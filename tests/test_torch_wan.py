"""The port's WAN text-to-video slice against the JAX package, on the CPU in
fp32.

* ``layer_norm`` (the no-affine LN, kernel #6's plain version and its
  closed-form backward) against the JAX ``layer_norm`` at its reference
  backend and with the TPU kernel in interpret mode, forward and gradient;
* ``wan_sde_step_with_logprob`` on shared noise, and ``wan_schedule`` bit for
  bit;
* ``WanTransformer``: the JAX model gets random numpy parameters in its own
  tree (non-zero biases and LoRA B), ``wan_state_dict_from_jax`` carries them
  to the port, and both run the same inputs: at ``WanConfig.tiny`` and at a
  narrow config with the real head geometry (1 head x 128, RoPE axes
  44/42/42), where the JAX side runs the TPU attention kernel in interpret
  mode on its sequence zero-padded to 128 (the port pads nothing); square and
  non-square grids, one and several frames, ``lora_scale`` 1 and 0. Bound
  1e-4: one or two blocks of fp32 sums in another order;
* the state dict's diffusers names (against the diffusers-layout mirror) and
  the round trip through the JAX ``convert_wan``;
* ``WanVideoVAE.decode`` at 1, 2 and 3 latent frames, with and without
  decoder attention blocks (the encoder: tests/test_torch_wan_vae_encoder.py);
* the rollout: the deterministic chain with the per-step KL (non-zero LoRA B)
  and its decode against JAX; the stochastic window's replay; the demo CLI.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util
from PIL import Image

from adv_grpo_torch.cli import train as t_train
from adv_grpo_torch.cli import wan_sde_demo as t_demo
from adv_grpo_torch.core.sde import wan_sde_step_with_logprob as t_step
from adv_grpo_torch.models.convert import wan_state_dict_from_jax, wan_vae_state_dict_from_jax
from adv_grpo_torch.models.wan import WanConfig as TWanConfig
from adv_grpo_torch.models.wan import WanTransformer as TWanTransformer
from adv_grpo_torch.models.wan_vae import WanVAEConfig as TWanVAEConfig
from adv_grpo_torch.models.wan_vae import WanVideoVAE as TWanVideoVAE
from adv_grpo_torch.ops.fused_norms import layer_norm as t_layer_norm
from adv_grpo_torch.rollout import wan as t_rollout
from adv_grpo_torch.train.wan_pipeline import WanPipeline as TWanPipeline
from adv_grpo_tpu.core.sde import wan_sde_step_with_logprob as j_step
from adv_grpo_tpu.models.convert import convert_wan
from adv_grpo_tpu.models.wan import WanConfig as JWanConfig
from adv_grpo_tpu.models.wan import WanTransformer as JWanTransformer
from adv_grpo_tpu.models.wan_vae import WanVAEConfig as JWanVAEConfig
from adv_grpo_tpu.models.wan_vae import WanVideoVAE as JWanVideoVAE
from adv_grpo_tpu.ops.fused_norms import layer_norm as j_layer_norm
from adv_grpo_tpu.rollout import wan as j_rollout
from adv_grpo_tpu.train.wan_pipeline import WanPipeline as JWanPipeline
from tests.mirrors.wan_torch import WanTransformerMirror
from tests.mirrors.wan_vae_torch import AutoencoderKLWanMirror
from tests.test_torch_models import _leaf

ATOL = RTOL = 1e-4

# (port config kwargs, JAX-only kwargs, text tokens)
GEOMETRIES = {
    "tiny": (dict(), dict(), 6),
    # the real head geometry cut to 1 head and 1 block; the JAX side runs the
    # TPU attention kernel in interpret mode
    "narrow_d128": (dict(num_layers=1, attention_head_dim=128, num_attention_heads=1,
                         text_dim=32, ffn_dim=64, rope_axes_dims=(44, 42, 42)),
                    dict(attention_backend="pallas_interpret"), 8),
}


def wan_configs(geometry, **kw):
    tkw, jkw, s_txt = GEOMETRIES[geometry]
    return TWanConfig.tiny(**tkw, **kw), JWanConfig.tiny(**tkw, **jkw, **kw), s_txt


def _fill(shapes, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda path, s: _leaf(path, s.shape, rng).astype(np.float32), shapes)


def jax_wan_params(jcfg, seed, s_txt):
    """Random numpy parameters in the JAX model's own tree (``eval_shape`` of
    ``init``: no compile)."""
    shapes = jax.eval_shape(JWanTransformer(jcfg).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, jcfg.in_channels, 1, 2, 2)), jnp.zeros((1,)),
                            jnp.zeros((1, s_txt, jcfg.text_dim)))
    return _fill(shapes, seed)


def jax_wan_vae_params(jvcfg, seed):
    shapes = jax.eval_shape(JWanVideoVAE(jvcfg).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 3, 1 + jvcfg.temporal_factor, 8, 8)))
    return _fill(shapes, seed)


def _t(a):
    return torch.from_numpy(np.asarray(a))


# ── kernel #6's plain version and its backward ────────────────────────────


@pytest.mark.parametrize("backend", ["reference", "pallas_interpret"])
@pytest.mark.parametrize("shape", [(2, 16, 256), (1, 24, 136)])
def test_layer_norm_matches_jax(backend, shape):
    """Forward against the JAX ``layer_norm`` at ``backend``, and the
    gradient against ``jax.grad`` (through ``_layer_norm_p``'s closed-form
    VJP at pallas_interpret, autodiff of the reference at reference), on an
    offset input so the mean matters. Bound 1e-5: one row of fp32 sums."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(shape) * 2.0 + 0.7).astype(np.float32)
    cot = rng.standard_normal(shape).astype(np.float32)

    def jf(a):
        return j_layer_norm(a, out_dtype=jnp.float32, backend=backend)

    want = np.asarray(jf(jnp.asarray(x)))
    want_dx = np.asarray(jax.grad(lambda a: jnp.sum(jf(a) * cot))(jnp.asarray(x)))
    xt = _t(x).requires_grad_()
    got = t_layer_norm(xt)
    (dx,) = torch.autograd.grad(got, xt, _t(cot))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(dx.numpy(), want_dx, rtol=1e-5, atol=1e-5)
    with torch.no_grad():  # the non-autograd path gives the same forward
        torch.testing.assert_close(t_layer_norm(_t(x)), got.detach(), rtol=0, atol=0)


# ── the SDE step and the schedule ─────────────────────────────────────────


@pytest.mark.parametrize("mode", ["stochastic", "deterministic", "prev_sample"])
def test_wan_sde_step_matches_jax(mode):
    """All fields on shared noise, per-sample sigmas including the last step
    (sigma_prev = 0); 1e-6."""
    rng = np.random.default_rng(2)
    v, x, noise, prev = (rng.standard_normal((3, 4, 2, 3, 3)).astype(np.float32)
                         for _ in range(4))
    sig = np.array([0.9997, 0.6, 0.05], np.float32)
    sig_prev = np.array([0.9, 0.4, 0.0], np.float32)
    kw = dict(sigma_min=0.0, sigma_max=0.9993)
    extra = dict(prev_sample=prev) if mode == "prev_sample" else dict(
        noise=noise, deterministic=mode == "deterministic")
    want = j_step(v, x, sig, sig_prev, **kw, **extra)
    got = t_step(*(_t(a) for a in (v, x, sig, sig_prev)), **kw,
                 **{k: _t(a) if isinstance(a, np.ndarray) else a for k, a in extra.items()})
    for i in range(4):
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want[i]), rtol=1e-6, atol=1e-6)
    assert torch.isfinite(got.log_prob).all()


@pytest.mark.parametrize("steps,shift", [(50, 3.0), (8, 3.0), (4, 3.0), (1, 3.0), (20, 5.0)])
def test_wan_schedule_matches_jax(steps, shift):
    for a, b in zip(t_rollout.wan_schedule(steps, shift), j_rollout.wan_schedule(steps, shift)):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)


# ── the transformer ───────────────────────────────────────────────────────


@pytest.mark.parametrize("geometry", list(GEOMETRIES))
@pytest.mark.parametrize("grid", [(1, 4, 4), (3, 6, 10)])
@pytest.mark.parametrize("lora_scale", [1.0, 0.0])
def test_wan_transformer_matches_jax(geometry, grid, lora_scale):
    """Latent grids (F', H', W') of 1 x 2 x 2 and 3 x 3 x 5 tokens (12 and 45:
    neither a multiple of 128, so the JAX model pads and masks)."""
    tcfg, jcfg, s_txt = wan_configs(geometry, lora_rank=4, lora_alpha=8.0)
    params = jax_wan_params(jcfg, 1, s_txt)
    rng = np.random.default_rng(0)
    lat = rng.standard_normal((2, tcfg.in_channels) + grid).astype(np.float32)
    t = np.array([900.0, 300.0], np.float32)
    ctx = (rng.standard_normal((2, s_txt, tcfg.text_dim)) * 0.2).astype(np.float32)
    want = JWanTransformer(jcfg).apply(params, jnp.asarray(lat), jnp.asarray(t),
                                       jnp.asarray(ctx), lora_scale=lora_scale)
    model = TWanTransformer(tcfg, device="cpu")
    model.load_state_dict(wan_state_dict_from_jax(params, tcfg))
    with torch.no_grad():
        got = model(_t(lat), _t(t), _t(ctx), lora_scale=lora_scale)
    assert got.shape == lat.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_wan_round_trip_through_convert_wan(geometry):
    """The port's state dict (diffusers names) through the JAX package's
    diffusers -> Flax converter gives back the JAX tree exactly; its
    ``assert_consumed`` rejects any stray or misnamed key."""
    tcfg, jcfg, s_txt = wan_configs(geometry)
    params = jax_wan_params(jcfg, 2, s_txt)
    sd = wan_state_dict_from_jax(params, tcfg)
    back = traverse_util.flatten_dict(convert_wan({k: v.numpy() for k, v in sd.items()}, jcfg))
    want = traverse_util.flatten_dict(params["params"])
    assert set(back) == set(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(back[k]), np.asarray(want[k]),
                                      err_msg="/".join(k))


@pytest.mark.parametrize("lora_rank", [0, 4])
def test_wan_state_dict_names_load_strictly(lora_rank):
    """The converter's names and shapes are the port model's, which are the
    diffusers WanTransformer3DModel's (the mirror's), plus the LoRA factors."""
    tcfg, jcfg, s_txt = wan_configs("tiny", lora_rank=lora_rank, lora_alpha=8.0)
    sd = wan_state_dict_from_jax(jax_wan_params(jcfg, 3, s_txt), tcfg)
    model = TWanTransformer(tcfg, device="cpu")
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd)  # strict
    mirror = {k: tuple(v.shape) for k, v in WanTransformerMirror(jcfg).state_dict().items()}
    ours = {k: tuple(v.shape) for k, v in model.state_dict().items()
            if not k.endswith(("lora_a", "lora_b"))}
    assert ours == mirror
    assert ("blocks.1.attn2.to_out.0.lora_b" in sd) == (lora_rank > 0)
    assert "blocks.0.ffn.net.0.proj.lora_a" not in sd  # the FFN has no LoRA
    assert all(v.dtype == torch.float32 for k, v in model.state_dict().items()
               if k.endswith(("lora_a", "lora_b", "norm_q.weight", "scale_shift_table",
                              "norm2.bias")))


def _init_kind(a):
    a = np.asarray(a)
    return "zeros" if not a.any() else "ones" if np.all(a == 1.0) else "random"


def test_wan_random_init_follows_the_jax_initialisers():
    """``WanPipeline.random_init`` draws every parameter from the family of
    the JAX package's initialiser: the JAX ``init`` of the tiny transformer
    and VAE, carried to the port's names by the converters, is zeros where
    the port's draw is zeros (biases, LoRA B), ones where it is ones (the
    LayerNorm and RMS scales, ``norm2``'s weight, the VAE's gammas), and
    random elsewhere with the same scale (the tables' 0.02, the kernels'
    1/sqrt(fan_in); within 30% on tensors of 256 or more values)."""
    jcfg = JWanConfig.tiny(lora_rank=4)
    jvcfg = JWanVAEConfig.tiny()
    key = jax.random.PRNGKey(0)
    jt = jax.jit(JWanTransformer(jcfg).init)(
        key, jnp.zeros((1, jcfg.in_channels, 1, 2, 2)), jnp.zeros((1,)),
        jnp.zeros((1, 6, jcfg.text_dim)))
    jv = jax.jit(JWanVideoVAE(jvcfg).init)(key, jnp.zeros((1, 3, 3, 8, 8)))
    tcfg, tvcfg = TWanConfig.tiny(lora_rank=4), TWanVAEConfig.tiny()
    pipe = TWanPipeline.random_init(torch.Generator().manual_seed(0), tcfg, tvcfg, "cpu")
    pairs = [(wan_state_dict_from_jax(jax.device_get(jt), tcfg), pipe.transformer),
             (wan_vae_state_dict_from_jax(jax.device_get(jv), tvcfg), pipe.vae)]
    checked = 0
    for want_sd, module in pairs:
        got_sd = module.state_dict()
        assert set(want_sd) == set(got_sd)
        for k, want in want_sd.items():
            got = got_sd[k].float()
            assert _init_kind(got) == _init_kind(want), k
            if _init_kind(want) == "random" and want.numel() >= 256:
                assert abs(got.std().item() / want.std().item() - 1.0) < 0.3, k
                checked += 1
    assert checked > 20
    assert _init_kind(pipe.transformer.blocks[0].norm2.bias.detach()) == "zeros"


# ── the VAE decoder ───────────────────────────────────────────────────────


def _vae_pair(seed, **kw):
    jvcfg = JWanVAEConfig.tiny(**kw)
    vparams = jax_wan_vae_params(jvcfg, seed)
    tvcfg = TWanVAEConfig.tiny(**kw)
    vae = TWanVideoVAE(tvcfg, device="cpu")
    vae.load_state_dict(wan_vae_state_dict_from_jax(vparams, tvcfg))
    return jvcfg, vparams, tvcfg, vae


@pytest.mark.parametrize("frames", [1, 2, 3])
@pytest.mark.parametrize("attn", [False, True])
def test_wan_vae_decode_matches_jax(frames, attn):
    """``decode`` (per-channel stats, then the decoder) at 1, 2 and 3 latent
    frames (1, 3 and 5 video frames through the temporal upsample), with
    decoder attention blocks in every stage when ``attn``; non-zero stats."""
    kw = dict(latents_mean=(0.1, -0.2, 0.0, 0.3), latents_std=(1.5, 0.5, 1.0, 2.0))
    if attn:
        kw.update(attn_scales=(0.5, 1.0), dim_mult=(1, 2, 2),
                  temperal_downsample=(False, True))
    jvcfg, vparams, tvcfg, vae = _vae_pair(4, **kw)
    lat = np.random.default_rng(1).standard_normal((2, 4, frames, 3, 5)).astype(np.float32)
    jvae = JWanVideoVAE(jvcfg)
    want = np.asarray(jvae.apply(vparams, jnp.asarray(lat), method=jvae.decode))
    with torch.no_grad():
        got = vae.decode(_t(lat))
    assert got.shape == want.shape == (2, 3, jvcfg.temporal_factor * (frames - 1) + 1,
                                       3 * jvcfg.spatial_factor, 5 * jvcfg.spatial_factor)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_wan_vae_names_are_diffusers():
    """The VAE's names and shapes are the diffusers AutoencoderKLWan's (the
    mirror's: encoder, quant convs and decoder)."""
    kw = dict(attn_scales=(0.5, 1.0), dim_mult=(1, 2, 2), temperal_downsample=(True, False))
    _, _, tvcfg, vae = _vae_pair(5, **kw)
    mirror = AutoencoderKLWanMirror(base_dim=tvcfg.base_dim, z_dim=tvcfg.z_dim,
                                    dim_mult=tvcfg.dim_mult,
                                    num_res_blocks=tvcfg.num_res_blocks,
                                    attn_scales=tvcfg.attn_scales,
                                    temperal_downsample=tvcfg.temperal_downsample)
    want = {k: tuple(v.shape) for k, v in mirror.state_dict().items()}
    assert {k: tuple(v.shape) for k, v in vae.state_dict().items()} == want


# ── the rollout ───────────────────────────────────────────────────────────


@pytest.fixture(scope="module")
def pipes():
    """The tiny wan_smoke pipeline in both packages, the same numpy weights
    (non-zero LoRA B, so the KL policy differs)."""
    jcfg = JWanConfig.tiny(lora_rank=4, lora_alpha=8.0)
    kw = dict(z_dim=16, latents_mean=(0.0,) * 16, latents_std=(1.0,) * 16)
    jvcfg = JWanVAEConfig.tiny(**kw)
    tparams, vparams = jax_wan_params(jcfg, 6, 6), jax_wan_vae_params(jvcfg, 7)
    jpipe = JWanPipeline(jcfg, jvcfg, JWanTransformer(jcfg), JWanVideoVAE(jvcfg), tparams,
                         vparams, text_seq_len=6, latent_frames=2)
    tpipe = TWanPipeline.from_jax(tparams, vparams, TWanConfig.tiny(lora_rank=4, lora_alpha=8.0),
                                  TWanVAEConfig.tiny(**kw), "cpu")
    return jpipe, tpipe


def test_wan_deterministic_rollout_with_kl_matches_jax(pipes):
    """``wan_denoise_with_logprob`` in deterministic mode with the per-step KL
    (two forwards per step, ``lora_scale`` 1 and 0 on the same modules) from
    the same initial latents: every latent, log-prob and KL, and the decoded
    video. 1e-4 (the KL 1e-4 relative: a ratio of small differences)."""
    jpipe, tpipe = pipes
    rng = np.random.default_rng(0)
    lat = rng.standard_normal((2, 16, 2, 4, 4)).astype(np.float32)
    emb = (rng.standard_normal((2, 6, 32)) * 0.2).astype(np.float32)
    kw = dict(num_steps=4, deterministic=True, kl_reward=0.5)

    jvt = jpipe.velocity_fn(jpipe.transformer_params)
    jvr = jpipe.velocity_fn(jpipe.transformer_params, lora_scale=0.0)
    want = j_rollout.wan_denoise_with_logprob(
        lambda x, t, s: (jvt if s else jvr)(x, t, jnp.asarray(emb)), jnp.asarray(lat),
        jax.random.PRNGKey(0), j_rollout.WanSamplerConfig(**kw))
    want_vid = np.asarray(jpipe.decode(want.final_latents))

    tv = {s: tpipe.velocity_fn(s) for s in (1.0, 0.0)}
    with torch.no_grad():
        got = t_rollout.wan_denoise_with_logprob(
            lambda x, t, s: tv[s](x, t, _t(emb)), _t(lat), torch.Generator().manual_seed(0),
            t_rollout.WanSamplerConfig(**kw))
        got_vid = tpipe.decode(got.final_latents)
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL, atol=ATOL)
    assert (got.kl > 0).all() and torch.isfinite(got.log_probs).all()
    np.testing.assert_allclose(got.kl.numpy(), np.asarray(want.kl), rtol=1e-4, atol=1e-12)
    assert got_vid.shape == want_vid.shape == (2, 3, 3, 8, 8)
    np.testing.assert_allclose(got_vid.numpy(), want_vid, rtol=RTOL, atol=ATOL)


def test_wan_window_record_replays(pipes):
    """The stochastic window's recorded log-probs equal the replay of each
    recorded transition through ``make_wan_log_prob_fn`` (1e-6); with
    ``kl_reward`` 0 the KL record is zeros."""
    _, tpipe = pipes
    g = torch.Generator().manual_seed(1)
    lat = tpipe.prepare_latents(g, 2, 4)
    emb = torch.randn(2, 6, 32, generator=g) * 0.2
    fn = tpipe.velocity_fn()
    cfg = t_rollout.WanSamplerConfig(num_steps=5)
    replay = t_rollout.make_wan_log_prob_fn(cfg)
    with torch.no_grad():
        out = t_rollout.wan_denoise_window_with_logprob(
            lambda x, t, s: fn(x, t, emb), lat, g, cfg, 2, torch.tensor([0, 3]))
        assert out.latents.shape == (2, 3, 16, 2, 4, 4) and out.log_probs.shape == (2, 2)
        for j in range(2):
            lp, _, _ = replay(fn, out.latents[:, j], out.latents[:, j + 1], out.timesteps[:, j],
                              out.sigmas[:, j], out.sigmas_prev[:, j], emb, None, None, None,
                              None)
            torch.testing.assert_close(lp, out.log_probs[:, j], rtol=1e-6, atol=1e-6)
    assert torch.isfinite(out.log_probs).all() and not out.kl.any()
    assert out.sigmas_prev[1, 1] == 0.0  # the last step of the chain is in the window


def test_wan_demo_cli_writes_png(tmp_path, monkeypatch, capsys):
    """``cli.wan_sde_demo --device cpu`` writes the frame strip of the tiny
    WAN (wan_smoke: 32^2 frames, 9 of them) and prints the mean log-prob and
    KL."""
    monkeypatch.delenv("WAN_DIR", raising=False)
    path = t_demo.main(["--device", "cpu", "--out_dir", str(tmp_path), "--kl_reward", "0.1"])
    assert os.path.basename(path) == "wan_sde_kl0.1.png"
    img = np.asarray(Image.open(path))
    assert img.shape == (32, 9 * 32, 3) and img.dtype == np.uint8 and img.min() < img.max()
    out = capsys.readouterr().out
    assert "mean logprob" in out and "mean KL" in out
    det = t_demo.main(["--device", "cpu", "--out_dir", str(tmp_path), "--deterministic"])
    assert os.path.basename(det) == "wan_det.png"


@pytest.mark.parametrize("cli", ["demo", "train"])
def test_wan_cli_refuses_a_checkpoint_dir(tmp_path, monkeypatch, cli):
    """A set WAN_DIR that holds no diffusers transformer (no config.json):
    both CLIs raise instead of silently building the random tiny model
    (loading a written directory: tests/test_torch_family_loaders.py)."""
    monkeypatch.setenv("WAN_DIR", str(tmp_path))
    with pytest.raises(FileNotFoundError, match="config.json"):
        if cli == "demo":
            t_demo.main(["--device", "cpu", "--out_dir", str(tmp_path)])
        else:
            t_train.main(["--config", "wan_smoke", "--device", "cpu", "--max_epochs", "1",
                          "--set", f"save_dir={tmp_path}"])
