"""The port's Flux slice against the JAX package, on the CPU in fp32.

* ``FluxTransformer``: the JAX model gets random numpy parameters in its own
  tree (non-zero biases and LoRA B), ``flux_state_dict_from_jax`` carries
  them to the port, and both run the same inputs: at ``FluxConfig.tiny`` and
  at a narrow config with the real head geometry (1 head x 128, RoPE axes
  16/56/56), where the JAX side runs the TPU attention kernels in interpret
  mode (``joint_mha``, ``mha_bshd``); guidance embedded or not; a non-square
  grid. Bound 1e-4: two to four blocks of fp32 sums in another order.
* the converter round trip through the JAX ``convert_flux``, exact;
* ``flow_sde_step_with_logprob`` on shared noise;
* the schedule and the token packing;
* the slice: the tiny ``flux_smoke`` inference from the same initial latents
  in both packages (final latents and images), the stochastic window's
  replay through ``compute_flux_log_prob``, and the CLI writing its PNG.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util
from PIL import Image

from adv_grpo_torch.cli import infer as t_infer
from adv_grpo_torch.core.sde import flow_sde_step_with_logprob as t_step
from adv_grpo_torch.models.convert import flux_state_dict_from_jax
from adv_grpo_torch.models.flux import FluxConfig as TFluxConfig
from adv_grpo_torch.models.flux import FluxTransformer as TFluxTransformer
from adv_grpo_torch.models.lora import LoRALinear, _fused_operand, fused_qkv_proj
from adv_grpo_torch.models.vae import VAEConfig as TVAEConfig
from adv_grpo_torch.rollout import flux as t_rollout
from adv_grpo_torch.train.flux_pipeline import FluxPipeline as TFluxPipeline
from adv_grpo_tpu.core.sde import flow_sde_step_with_logprob as j_step
from adv_grpo_tpu.models.convert import convert_flux
from adv_grpo_tpu.models.flux import FluxConfig as JFluxConfig
from adv_grpo_tpu.models.flux import FluxTransformer as JFluxTransformer
from adv_grpo_tpu.models.flux import make_latent_ids
from adv_grpo_tpu.models.vae import AutoencoderKL, VAEConfig
from adv_grpo_tpu.rollout import flux as j_rollout
from adv_grpo_tpu.train.flux_pipeline import FluxPipeline as JFluxPipeline
from tests.test_torch_models import _leaf

ATOL = RTOL = 1e-4

# (port config kwargs, JAX-only kwargs, grid (gh, gw), text tokens)
GEOMETRIES = {
    "tiny": (dict(), dict(), (3, 5), 6),
    # the real head geometry, cut to 1 head and 1 + 1 blocks; the JAX side
    # runs the TPU attention kernels in interpret mode
    "narrow_d128": (dict(in_channels=16, num_double_layers=1, num_single_layers=1,
                         attention_head_dim=128, num_attention_heads=1,
                         joint_attention_dim=32, pooled_projection_dim=24,
                         rope_axes_dims=(16, 56, 56)),
                    dict(attention_backend="pallas_interpret"), (4, 6), 8),
}


def _configs(geometry, **kw):
    tkw, jkw, grid, s_txt = GEOMETRIES[geometry]
    tcfg = TFluxConfig.tiny(**tkw, **kw)
    jcfg = JFluxConfig.tiny(**tkw, **jkw, **kw)
    return tcfg, jcfg, grid, s_txt


def jax_flux_params(jcfg, seed, s_txt):
    """Random numpy parameters in the JAX model's own tree (``eval_shape`` of
    ``init``: no compile)."""
    model = JFluxTransformer(jcfg)
    img_ids, txt_ids = make_latent_ids(2, 2), np.zeros((s_txt, 3), np.int32)
    shapes = jax.eval_shape(
        lambda k, a, t, c, p: model.init(k, a, t, c, p, img_ids, txt_ids),
        jax.random.PRNGKey(0), jnp.zeros((1, 4, jcfg.in_channels)), jnp.zeros((1,)),
        jnp.zeros((1, s_txt, jcfg.joint_attention_dim)),
        jnp.zeros((1, jcfg.pooled_projection_dim)))
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda path, s: _leaf(path, s.shape, rng).astype(np.float32), shapes)


def _inputs(cfg, grid, s_txt, guidance, seed=0):
    rng = np.random.default_rng(seed)
    s = grid[0] * grid[1]
    lat = rng.standard_normal((2, s, cfg.in_channels)).astype(np.float32)
    t = np.array([900.0, 300.0], np.float32)
    ctx = (rng.standard_normal((2, s_txt, cfg.joint_attention_dim)) * 0.2).astype(np.float32)
    pooled = (rng.standard_normal((2, cfg.pooled_projection_dim)) * 0.2).astype(np.float32)
    g = np.array([3.5, 2.0], np.float32) if guidance else None
    return lat, t, ctx, pooled, g


@pytest.mark.parametrize("geometry", list(GEOMETRIES))
@pytest.mark.parametrize("guidance", [True, False])
def test_flux_transformer_matches_jax(geometry, guidance):
    tcfg, jcfg, grid, s_txt = _configs(geometry, lora_rank=4, lora_alpha=8.0,
                                       guidance_embeds=guidance)
    params = jax_flux_params(jcfg, 1, s_txt)
    lat, t, ctx, pooled, g = _inputs(tcfg, grid, s_txt, guidance)
    img_ids, txt_ids = make_latent_ids(*grid), np.zeros((s_txt, 3), np.int32)
    want = JFluxTransformer(jcfg).apply(
        params, jnp.asarray(lat), jnp.asarray(t), jnp.asarray(ctx), jnp.asarray(pooled),
        img_ids, txt_ids, guidance=None if g is None else jnp.asarray(g), lora_scale=0.7)

    model = TFluxTransformer(tcfg, device="cpu")
    model.load_state_dict(flux_state_dict_from_jax(params, tcfg))
    with torch.no_grad():
        got = model(torch.from_numpy(lat), torch.from_numpy(t), torch.from_numpy(ctx),
                    torch.from_numpy(pooled), img_ids, txt_ids,
                    guidance=None if g is None else torch.from_numpy(g), lora_scale=0.7)
    assert got.shape == (2, grid[0] * grid[1], tcfg.in_channels)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("geometry", list(GEOMETRIES))
@pytest.mark.parametrize("guidance", [True, False])
def test_flux_round_trip_through_convert_flux(geometry, guidance):
    """The port's state dict (diffusers names) through the JAX package's
    diffusers -> Flax converter gives back the JAX tree exactly; its
    ``assert_consumed`` rejects any stray or misnamed key."""
    tcfg, jcfg, _, s_txt = _configs(geometry, lora_rank=0, guidance_embeds=guidance)
    params = jax_flux_params(jcfg, 2, s_txt)
    sd = flux_state_dict_from_jax(params, tcfg)
    back = convert_flux({k: v.numpy() for k, v in sd.items()}, jcfg)
    want = traverse_util.flatten_dict(params["params"])
    got = traverse_util.flatten_dict(back)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]),
                                      err_msg="/".join(k))


@pytest.mark.parametrize("lora_rank", [0, 4])
def test_flux_state_dict_names_load_strictly(lora_rank):
    tcfg, jcfg, _, s_txt = _configs("tiny", lora_rank=lora_rank, lora_alpha=8.0)
    sd = flux_state_dict_from_jax(jax_flux_params(jcfg, 3, s_txt), tcfg)
    model = TFluxTransformer(tcfg, device="cpu")
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd)  # strict
    assert "single_transformer_blocks.1.attn.norm_k.weight" in sd
    assert "transformer_blocks.0.attn.norm_added_q.weight" in sd
    assert "time_text_embed.guidance_embedder.linear_2.bias" in sd
    assert ("transformer_blocks.1.attn.add_v_proj.lora_b" in sd) == (lora_rank > 0)
    assert ("single_transformer_blocks.0.proj_out.lora_a" in sd) == (lora_rank > 0)
    assert "transformer_blocks.0.ff.net.0.proj.lora_a" not in sd  # the MLPs have no LoRA
    assert all(v.dtype == torch.float32 for k, v in model.state_dict().items()
               if k.endswith(("lora_a", "lora_b", "norm_q.weight")))


@pytest.mark.parametrize("lora_rank", [0, 3])
def test_fused_qkv_proj_equals_separate_projections(lora_rank):
    g = torch.Generator().manual_seed(0)
    mods = [LoRALinear(12, n, lora_rank=lora_rank, lora_alpha=6.0) for n in (8, 8, 20)]
    for m in mods:
        for p in m.parameters():
            p.data.normal_(0.0, 0.3, generator=g)
    x = torch.randn(2, 5, 12, generator=g)
    with torch.no_grad():
        got = fused_qkv_proj(mods, x, lora_scale=0.5)
        want = [m(x, 0.5) for m in mods]
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("change", ["reuse", "in_place", "new_data", "inference_mode", "grad"])
def test_fused_qkv_proj_operand_follows_parameters(change):
    """The concatenated operand is kept between no-grad calls and rebuilt
    after any change of the parameters; with autograd on it is rebuilt per
    call, so gradients reach the parameters as through separate layers."""
    g = torch.Generator().manual_seed(1)
    mods = [LoRALinear(12, n, lora_rank=3, lora_alpha=6.0) for n in (8, 20)]
    for m in mods:
        for p in m.parameters():
            p.data.normal_(0.0, 0.3, generator=g)
    x = torch.randn(2, 5, 12, generator=g)
    with torch.no_grad():
        fused_qkv_proj(mods, x)
        operand = _fused_operand(mods)
        if change == "in_place":
            mods[1].lora_a.add_(0.5)
        elif change == "new_data":
            mods[0].weight.data = mods[0].weight.data * 2.0
    if change == "grad":
        got = fused_qkv_proj(mods, x)
        sum(o.square().sum() for o in got).backward()
        fused_grads = [p.grad.clone() for m in mods for p in m.parameters()]
        for m in mods:
            m.zero_grad()
        sum(m(x).square().sum() for m in mods).backward()
        for a, b in zip(fused_grads, [p.grad for m in mods for p in m.parameters()]):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
        return
    with torch.inference_mode(change == "inference_mode"), torch.no_grad():
        got = fused_qkv_proj(mods, x)
        want = [m(x) for m in mods]
        assert (_fused_operand(mods) is operand) == (change == "reuse")
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("noise_level", [0.7, 0.0])
def test_flow_sde_step_matches_jax(noise_level):
    """All fields at noise 0.7 (the first sigma is 1.0: the sigma_at_one
    guard); at noise 0 the step is deterministic and the log-probability is
    NaN on both sides, so only the sample is compared."""
    rng = np.random.default_rng(2)
    v, x, noise = (rng.standard_normal((3, 16, 8)).astype(np.float32) for _ in range(3))
    sig = np.array([1.0, 0.8, 0.5], np.float32)
    sig_prev = np.array([0.9, 0.6, 0.2], np.float32)
    want = j_step(v, x, sig, sig_prev, noise_level, sigma_at_one=0.95, noise=noise)
    got = t_step(*(torch.from_numpy(a) for a in (v, x, sig, sig_prev)), noise_level,
                 sigma_at_one=0.95, noise=torch.from_numpy(noise))
    fields = range(4) if noise_level else range(1)
    for i in fields:
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want[i]), rtol=1e-6, atol=1e-6)
    if not noise_level:
        assert torch.isnan(got.log_prob).all() and np.isnan(np.asarray(want.log_prob)).all()


@pytest.mark.parametrize("steps,seq", [(28, 1024), (4, 16), (1, 4096)])
def test_flux_schedule_and_packing_match_jax(steps, seq):
    assert t_rollout.calculate_shift(seq) == j_rollout.calculate_shift(seq)
    for a, b in zip(t_rollout.flux_schedule(steps, seq), j_rollout.flux_schedule(steps, seq)):
        np.testing.assert_array_equal(a, b)
    lat = np.random.default_rng(0).standard_normal((2, 4, 6, 10)).astype(np.float32)
    packed = t_rollout.pack_latents(torch.from_numpy(lat))
    np.testing.assert_array_equal(packed.numpy(),
                                  np.asarray(j_rollout.pack_latents(jnp.asarray(lat))))
    np.testing.assert_array_equal(t_rollout.unpack_latents(packed, 6, 10).numpy(), lat)


@pytest.fixture(scope="module")
def pipes():
    """The tiny flux_smoke pipeline in both packages, the same numpy weights."""
    jcfg = JFluxConfig.tiny(lora_rank=4, lora_alpha=8.0)
    vcfg = VAEConfig.tiny(latent_channels=4)
    vae = AutoencoderKL(vcfg)
    vshapes = jax.eval_shape(vae.init, jax.random.PRNGKey(0), jnp.zeros((1, 3, 16, 16)))
    rng = np.random.default_rng(5)
    vparams = jax.tree_util.tree_map_with_path(
        lambda path, s: _leaf(path, s.shape, rng).astype(np.float32), vshapes)
    tparams = jax_flux_params(jcfg, 4, 6)
    jpipe = JFluxPipeline(jcfg, vcfg, JFluxTransformer(jcfg), vae, tparams, vparams,
                          text_seq_len=6, guidance=3.5)
    tpipe = TFluxPipeline.from_jax(tparams, vparams, TFluxConfig.tiny(lora_rank=4,
                                                                      lora_alpha=8.0),
                                   TVAEConfig.tiny(latent_channels=4), "cpu",
                                   latent_hw=8, text_seq_len=6, guidance=3.5)
    return jpipe, tpipe


def test_flux_inference_matches_jax(pipes):
    """The inference path of ``cli.infer`` (noise level 0, 4 steps) from the
    same initial latents: final latents and decoded images."""
    jpipe, tpipe = pipes
    rng = np.random.default_rng(0)
    lat = t_rollout.pack_latents(torch.from_numpy(
        rng.standard_normal((2, 4, 8, 8)).astype(np.float32)))
    emb = (rng.standard_normal((2, 6, 32)) * 0.2).astype(np.float32)
    pool = (rng.standard_normal((2, 24)) * 0.2).astype(np.float32)

    jv = jpipe.velocity_fn(jpipe.transformer_params)
    out = j_rollout.flux_denoise_window_with_logprob(
        lambda x, t: jv(x, t, jnp.asarray(emb), jnp.asarray(pool)), jnp.asarray(lat.numpy()),
        jax.random.PRNGKey(0), 4, 0, 0.0, 0)
    want_lat = np.asarray(out.final_latents)
    want_img = np.asarray(jpipe.decode(out.final_latents))

    tv = tpipe.velocity_fn()
    with torch.no_grad():
        tout = t_rollout.flux_denoise_window_with_logprob(
            lambda x, t: tv(x, t, torch.from_numpy(emb), torch.from_numpy(pool)), lat,
            torch.Generator().manual_seed(0), 4, 0, 0.0, 0)
        got_img = tpipe.decode(tout.final_latents)
    np.testing.assert_allclose(tout.final_latents.numpy(), want_lat, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got_img.numpy(), want_img, rtol=RTOL, atol=ATOL)
    assert got_img.shape == (2, 3, 16, 16) and tout.log_probs.shape == (2, 0)


def test_flux_window_record_replays(pipes):
    """The stochastic window's recorded log-probs equal the replay of each
    recorded transition through ``compute_flux_log_prob``."""
    _, tpipe = pipes
    g = torch.Generator().manual_seed(1)
    lat = tpipe.prepare_latents(g, 2)
    emb, pool = torch.randn(2, 6, 32, generator=g) * 0.2, torch.randn(2, 24, generator=g) * 0.2
    fn = tpipe.velocity_fn()
    cfg = t_rollout.FluxSamplerConfig(num_steps=5, noise_level=0.7)
    rt = torch.tensor([0, 2])
    with torch.no_grad():
        out = t_rollout.flux_denoise_window_with_logprob(
            lambda x, t: fn(x, t, emb, pool), lat, g, cfg.num_steps, 2, cfg.noise_level, rt)
        assert out.latents.shape == (2, 3, 16, 16) and out.log_probs.shape == (2, 2)
        for j in range(2):
            lp, _, _ = t_rollout.compute_flux_log_prob(
                fn, out.latents[:, j], out.latents[:, j + 1], out.timesteps[:, j],
                out.sigmas[:, j], out.sigmas_prev[:, j], emb, pool, None, None, cfg)
            torch.testing.assert_close(lp, out.log_probs[:, j], rtol=1e-6, atol=1e-6)
    assert torch.isfinite(out.log_probs).all()
    full = t_rollout.flux_denoise_with_logprob(lambda x, t: fn(x, t, emb, pool), lat,
                                               torch.Generator().manual_seed(2), cfg)
    assert full.all_latents.shape == (2, 6, 16, 16) and full.timesteps.shape == (2, 5)


def test_flux_infer_cli_writes_png(tmp_path, monkeypatch):
    monkeypatch.delenv("FLUX_DIR", raising=False)
    paths = t_infer.main(["--config", "flux_smoke", "--prompts", "a flower",
                          "--out_dir", str(tmp_path), "--device", "cpu"])
    assert [os.path.basename(p) for p in paths] == ["node0_rank0_00000_0.png"]
    img = np.asarray(Image.open(paths[0]))
    assert img.shape == (16, 16, 3) and img.dtype == np.uint8 and img.min() < img.max()


def test_flux_cli_refuses_a_checkpoint_dir(tmp_path, monkeypatch):
    """A set FLUX_DIR that holds no diffusers transformer (no config.json)
    raises instead of silently building the random tiny model (loading a
    written directory: tests/test_torch_family_loaders.py)."""
    monkeypatch.setenv("FLUX_DIR", str(tmp_path))
    with pytest.raises(FileNotFoundError, match="config.json"):
        t_infer.main(["--config", "flux_smoke", "--prompts", "a", "--out_dir",
                      str(tmp_path), "--device", "cpu"])
