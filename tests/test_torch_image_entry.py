"""The port's image entries against the JAX package, on the CPU in fp32: the
image-to-image distribution transfer (``SD3Pipeline.encode_image``,
``denoise_from_image``, ``cli.infer --image``) and the Flux Kontext
conditioning (``FluxPipeline.encode_image``, ``flux_denoise_with_logprob``'s
``cond_latents``).

The tiny JAX pipelines get random numpy weights (encoders included) and are
carried to the port with ``from_jax``; images and latents are numpy draws
from a seed. ``denoise_from_image`` draws its posterior sample and its noise
from a torch generator where the JAX function splits a key, so the JAX side
is held against its deterministic part: the rollout from the port's noised
latents at noise level 0. Bounds: 1e-4 absolute and relative (fp32 conv and
transformer stacks, sums in another order); the port against its own
formula exactly.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from adv_grpo_torch.cli import infer as t_infer
from adv_grpo_torch.core.scheduler import flow_match_schedule
from adv_grpo_torch.models.flux import FluxConfig as TFluxConfig
from adv_grpo_torch.models.mmdit import MMDiTConfig as TMMDiTConfig
from adv_grpo_torch.models.vae import VAEConfig as TVAEConfig
from adv_grpo_torch.rollout import flux as t_flux
from adv_grpo_torch.rollout import sampler as t_sampler
from adv_grpo_torch.train.flux_pipeline import FluxPipeline as TFluxPipeline
from adv_grpo_torch.train.pipeline import SD3Pipeline as TSD3Pipeline
from adv_grpo_tpu.models.flux import FluxConfig as JFluxConfig
from adv_grpo_tpu.models.flux import FluxTransformer as JFluxTransformer
from adv_grpo_tpu.models.vae import AutoencoderKL, VAEConfig
from adv_grpo_tpu.rollout import flux as j_flux
from adv_grpo_tpu.rollout import sampler as j_sampler
from adv_grpo_tpu.train.flux_pipeline import FluxPipeline as JFluxPipeline
from tests.test_torch_flux import jax_flux_params
from tests.test_torch_models import _leaf, jax_tiny_pipeline

TOL = 1e-4


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.fixture(scope="module")
def sd3_pipes():
    jpipe = jax_tiny_pipeline(23)
    tpipe = TSD3Pipeline.from_jax(
        jpipe.transformer_params, jpipe.vae_params,
        TMMDiTConfig.tiny(lora_rank=4, lora_alpha=8.0),
        TVAEConfig.tiny(latent_channels=16), "cpu", text_seq_len=6)
    return jpipe, tpipe


@pytest.fixture(scope="module")
def flux_pipes():
    jcfg = JFluxConfig.tiny(lora_rank=4, lora_alpha=8.0)
    vcfg = VAEConfig.tiny(latent_channels=4)
    vae = AutoencoderKL(vcfg)
    vshapes = jax.eval_shape(vae.init, jax.random.PRNGKey(0), jnp.zeros((1, 3, 16, 16)))
    rng = np.random.default_rng(29)
    vparams = jax.tree_util.tree_map_with_path(
        lambda path, s: _leaf(path, s.shape, rng).astype(np.float32), vshapes)
    tparams = jax_flux_params(jcfg, 31, 6)
    jpipe = JFluxPipeline(jcfg, vcfg, JFluxTransformer(jcfg), vae, tparams, vparams,
                          text_seq_len=6)
    tpipe = TFluxPipeline.from_jax(tparams, vparams, TFluxConfig.tiny(lora_rank=4, lora_alpha=8.0),
                                   TVAEConfig.tiny(latent_channels=4), "cpu", latent_hw=8,
                                   text_seq_len=6)
    return jpipe, tpipe


def _images(seed, n=2, hw=16):
    return np.random.default_rng(seed).uniform(-1, 1, (n, 3, hw, hw)).astype(np.float32)


def test_sd3_encode_image_matches_jax(sd3_pipes):
    """The posterior's mode, normalised: (z - shift) * scaling."""
    jpipe, tpipe = sd3_pipes
    images = _images(0)
    want = np.asarray(jpipe.encode_image(jnp.asarray(images)))
    with torch.no_grad():
        got = tpipe.encode_image(_t(images))
    assert got.shape == (2, 16, 8, 8)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    # a sample from a generator: the mode plus exp(logvar / 2) * its draw
    with torch.no_grad():
        mean, logvar = tpipe.vae.encode_moments(_t(images))
        g = torch.Generator().manual_seed(4)
        sample = tpipe.encode_image(_t(images), g)
        noise = torch.randn(mean.shape, generator=torch.Generator().manual_seed(4))
    cfg = tpipe.vae_cfg
    torch.testing.assert_close(
        sample, (mean + torch.exp(0.5 * logvar) * noise - cfg.shift_factor) * cfg.scaling_factor,
        rtol=0, atol=0)


def test_flux_encode_image_matches_jax(flux_pipes):
    """Packed (B, S, 4C) latents under the Flux VAE's scale and shift."""
    jpipe, tpipe = flux_pipes
    images = _images(1)
    want = np.asarray(jpipe.encode_image(jnp.asarray(images)))
    with torch.no_grad():
        got = tpipe.encode_image(_t(images))
    assert got.shape == (2, 16, 16)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def _toy_velocity(latents, t, embeds, pooled):
    """A deterministic pseudo-model (the JAX tests' ``toy_velocity_fn``)."""
    scale = 0.9 + 0.0001 * t[:, None, None, None]
    return -latents * scale + 0.01 * embeds.mean(dim=(1, 2))[:, None, None, None]


def _toy_encode(images, generator):
    """A stand-in encoder: 2x2 mean pooling to the latent grid, four channels."""
    b = images.shape[0]
    pooled = images.reshape(b, 3, 4, 2, 4, 2).mean(dim=(3, 5))
    return torch.cat([pooled, pooled[:, :1]], dim=1)


def test_denoise_from_image_passes_through_and_gathers_its_window():
    """The twin of tests/test_rollout.py's image-to-image test: the window at
    ``start_idx`` runs, the record replays through ``compute_log_prob``."""
    rng = np.random.default_rng(2)
    images = _t(rng.standard_normal((2, 3, 8, 8)).astype(np.float32))
    emb = _t(rng.standard_normal((2, 3, 8)).astype(np.float32))
    pooled, neg, negp = torch.zeros(2, 5), torch.zeros(2, 3, 8), torch.zeros(2, 5)
    cfg = t_sampler.SamplerConfig(num_steps=4, train_num_steps=2, guidance_scale=4.5,
                                  noise_level=0.8)
    out = t_sampler.denoise_from_image(_toy_velocity, _toy_encode, images, emb, pooled, neg,
                                       negp, torch.Generator().manual_seed(6), cfg, start_idx=2)
    assert out.latents.shape == (2, 3, 4, 4, 4)
    # the last step ends at sigma 0, where the step is deterministic
    assert torch.isfinite(out.log_probs).all() and (out.log_probs[:, 0] < 0).all()
    sched = flow_match_schedule(4, shift=3.0)
    np.testing.assert_array_equal(out.timesteps[0].numpy(), sched.timesteps[2:4])
    for j in range(2):
        lp, _, _ = t_sampler.compute_log_prob(
            _toy_velocity, out.latents[:, j], out.latents[:, j + 1], out.timesteps[:, j],
            out.sigmas[:, j], out.sigmas_prev[:, j], emb, pooled, neg, negp, cfg)
        torch.testing.assert_close(lp, out.log_probs[:, j], rtol=1e-6, atol=2e-7)
    # a window over the skipped steps records x passed through at log-prob 0
    early = t_sampler.denoise_from_image(_toy_velocity, _toy_encode, images, emb, pooled, neg,
                                         negp, torch.Generator().manual_seed(6), cfg,
                                         start_idx=2, random_timestep=0)
    assert torch.equal(early.latents[:, 0], early.latents[:, 2])
    assert (early.log_probs == 0).all()
    # ... and the steps that run are outside the window: the noise-0 rollout
    det = t_sampler.denoise_from_image(_toy_velocity, _toy_encode, images, emb, pooled, neg,
                                       negp, torch.Generator().manual_seed(6),
                                       t_sampler.SamplerConfig(num_steps=4, train_num_steps=2,
                                                               guidance_scale=4.5,
                                                               noise_level=0.0), start_idx=2)
    torch.testing.assert_close(early.final_latents, det.final_latents, rtol=0, atol=0)


def test_denoise_from_image_holds_its_formula_on_its_own_draws(sd3_pipes):
    """One generator, in this order: the posterior sample, the noise, the
    rollout; x = (1 - sigma) * x0 + sigma * noise at sigma[start_idx]."""
    _, tpipe = sd3_pipes
    rng = np.random.default_rng(3)
    images = _t(_images(3))
    emb, pool = (_t((rng.standard_normal(s) * 0.2).astype(np.float32)) for s in
                 ((2, 6, 64), (2, 48)))
    cfg = t_sampler.SamplerConfig(num_steps=5, train_num_steps=2, guidance_scale=4.5,
                                  noise_level=0.7)
    fn = tpipe.velocity_fn()
    with torch.no_grad():
        got = t_sampler.denoise_from_image(fn, tpipe.encode_image, images, emb, pool, emb * 0,
                                           pool * 0, torch.Generator().manual_seed(8), cfg,
                                           start_idx=2, random_timestep=3)
        g = torch.Generator().manual_seed(8)
        x0 = tpipe.encode_image(images, g)
        noise = torch.randn(x0.shape, generator=g)
        sigma = np.float32(flow_match_schedule(5, shift=3.0).sigmas[2])
        lat = float(np.float32(1) - sigma) * x0 + float(sigma) * noise
        want = t_sampler.denoise_with_logprob(fn, lat, emb, pool, emb * 0, pool * 0, g, cfg,
                                              random_timestep=3, start_idx=2)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_denoise_from_image_matches_jax_from_its_latents(sd3_pipes):
    """Noise level 0: the port's transfer from step 2 equals the JAX rollout
    with ``start_idx`` 2 from the same noised latents."""
    jpipe, tpipe = sd3_pipes
    rng = np.random.default_rng(4)
    images = _images(4)
    emb, pool, nemb, npool = ((rng.standard_normal(s) * 0.2).astype(np.float32) for s in
                              ((2, 6, 64), (2, 48), (2, 6, 64), (2, 48)))
    kw = dict(num_steps=4, train_num_steps=0, guidance_scale=4.5, noise_level=0.0)
    captured = {}

    def encode(imgs, generator):
        captured["x0"] = tpipe.encode_image(imgs, generator)
        return captured["x0"]

    with torch.no_grad():
        got = t_sampler.denoise_from_image(tpipe.velocity_fn(), encode, _t(images), _t(emb),
                                           _t(pool), _t(nemb), _t(npool),
                                           torch.Generator().manual_seed(9),
                                           t_sampler.SamplerConfig(**kw), start_idx=2)
        g = torch.Generator().manual_seed(9)
        tpipe.encode_image(_t(images), g)  # the posterior draw
        noise = torch.randn(captured["x0"].shape, generator=g)
    sigma = np.float32(flow_match_schedule(4, shift=3.0).sigmas[2])
    lat = (np.float32(1) - sigma) * captured["x0"].numpy() + sigma * noise.numpy()
    want = j_sampler.denoise_with_logprob(
        jpipe.velocity_fn(jpipe.transformer_params), jnp.asarray(lat), emb, pool, nemb, npool,
        jax.random.PRNGKey(0), j_sampler.SamplerConfig(**kw), 2, start_idx=2)
    np.testing.assert_allclose(got.final_latents.numpy(), np.asarray(want.final_latents),
                               rtol=TOL, atol=TOL)
    assert not np.allclose(got.final_latents.numpy(), lat, atol=1e-3)  # steps 2, 3 ran


def _write_image(path, seed):
    small = np.random.default_rng(seed).integers(0, 256, (4, 4, 3), dtype=np.uint8)
    Image.fromarray(small).resize((24, 24), Image.BICUBIC).save(path)
    return str(path)


def test_infer_image_writes_a_png_on_the_cpu(tmp_path):
    """``--image`` at ``--start_idx`` 2 of 4 steps: a 16^2 PNG (the image
    resized to the latent side times the VAE's downscale) that follows the
    image, and ``config.external_image_path`` takes the same route."""
    argv = ["--config", "eval_sd3_fast", "--prompts", "a flower", "--set", "smoke_test=True",
            "--set", "sample.eval_num_steps=4", "--latent_hw", "8", "--device", "cpu",
            "--start_idx", "2"]
    pngs = []
    for i, img in enumerate((_write_image(tmp_path / "a.png", 0),
                             _write_image(tmp_path / "b.png", 1))):
        paths = t_infer.main(argv + ["--image", img, "--out_dir", str(tmp_path / f"o{i}")])
        assert [os.path.basename(p) for p in paths] == ["node0_rank0_00000_0.png"]
        pngs.append(np.asarray(Image.open(paths[0])))
    assert pngs[0].shape == (16, 16, 3) and pngs[0].dtype == np.uint8
    assert not np.array_equal(pngs[0], pngs[1])
    paths = t_infer.main(argv + ["--set", f"external_image_path={tmp_path / 'a.png'}",
                                 "--out_dir", str(tmp_path / "o2")])
    np.testing.assert_array_equal(np.asarray(Image.open(paths[0])), pngs[0])


def test_infer_image_refuses_flux(tmp_path, monkeypatch):
    """The JAX CLI's refusal, in its words: the transfer is an SD3 entry."""
    monkeypatch.delenv("FLUX_DIR", raising=False)
    with pytest.raises(SystemExit, match="SD3 entry"):
        t_infer.main(["--config", "flux_smoke", "--prompts", "a", "--device", "cpu",
                      "--image", _write_image(tmp_path / "a.png", 0), "--out_dir",
                      str(tmp_path)])


def _kontext_velocity(lib):
    """A velocity over [sample ; conditioning] tokens that mixes the
    sequence, so the conditioning moves the sample tokens."""
    def fn(x, t):
        mean = x.mean(axis=1, keepdims=True) if lib is jnp else x.mean(dim=1, keepdim=True)
        return -0.8 * x + 0.3 * mean + 1e-4 * t[:, None, None]
    return fn


@pytest.mark.parametrize("noise_level", [0.0, 0.7])
def test_flux_kontext_rollout_matches_jax(noise_level):
    """``cond_latents`` concatenated along the sequence for the model call and
    the velocity's sample tokens stepping x; at noise 0 equal to JAX (at 0.7
    the draws differ and only the shapes and the effect of conditioning are
    held); conditioning changes the trajectory (tests/test_flux_wan.py:49-58)."""
    rng = np.random.default_rng(5)
    lat = rng.standard_normal((2, 16, 16)).astype(np.float32)
    cond = rng.standard_normal((2, 16, 16)).astype(np.float32)
    cfg = dict(num_steps=4, noise_level=noise_level)
    got = t_flux.flux_denoise_with_logprob(_kontext_velocity(torch), _t(lat),
                                           torch.Generator().manual_seed(0),
                                           t_flux.FluxSamplerConfig(**cfg), cond_latents=_t(cond))
    plain = t_flux.flux_denoise_with_logprob(_kontext_velocity(torch), _t(lat),
                                             torch.Generator().manual_seed(0),
                                             t_flux.FluxSamplerConfig(**cfg))
    assert got.all_latents.shape == (2, 5, 16, 16) and got.log_probs.shape == (2, 4)
    assert float((got.final_latents - plain.final_latents).abs().max()) > 1e-3
    if noise_level:
        return
    want = j_flux.flux_denoise_with_logprob(_kontext_velocity(jnp), jnp.asarray(lat),
                                            jax.random.PRNGKey(0), j_flux.FluxSamplerConfig(**cfg),
                                            cond_latents=jnp.asarray(cond))
    for name in ("final_latents", "all_latents", "log_probs", "timesteps"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   rtol=1e-6, atol=1e-6, err_msg=name)


def test_flux_kontext_with_encoded_conditioning(flux_pipes):
    """The Kontext entry end to end on the port's side: packed latents of an
    image from ``encode_image`` condition a rollout whose model sees 2S
    tokens (the transformer on a 4 x 8 token grid)."""
    from adv_grpo_torch.models.flux import make_latent_ids

    _, tpipe = flux_pipes
    rng = np.random.default_rng(6)
    emb = _t((rng.standard_normal((2, 6, 32)) * 0.2).astype(np.float32))
    pool = _t((rng.standard_normal((2, 24)) * 0.2).astype(np.float32))
    seen = []

    def velocity(x, t):
        seen.append(x.shape[1])
        return tpipe.transformer(x, t, emb, pool, make_latent_ids(4, 8),
                                 np.zeros((6, 3), np.int32),
                                 guidance=torch.full(t.shape, 3.5))

    with torch.no_grad():
        cond = tpipe.encode_image(_t(_images(7)))
        lat = tpipe.prepare_latents(torch.Generator().manual_seed(1), 2, 8)
        out = t_flux.flux_denoise_with_logprob(velocity, lat, torch.Generator().manual_seed(2),
                                               t_flux.FluxSamplerConfig(num_steps=3,
                                                                        noise_level=0.0),
                                               cond_latents=cond)
    assert seen == [32] * 3 and out.final_latents.shape == (2, 16, 16)
    assert torch.isfinite(out.all_latents).all()
