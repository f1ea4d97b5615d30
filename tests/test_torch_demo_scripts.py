"""The port's demo sweeps against the JAX scripts' samplers, on the CPU in
fp32: ``cli.flux_sde_demo`` (scripts/demo/flux_sde_demo.py, plain and
``--kontext``) at ``flux_smoke``'s size and ``cli.sde_noise_sweep``
(scripts/demo/sde_noise_sweep.py) at ``smoke_sd3_fast``'s.

Each JAX script draws its inputs and noise from a JAX key; here both sides
take the same numpy weights (the JAX trees filled by the tests' helpers and
carried to the port), the same inputs, and the same noise: the JAX draws of
each step (``jax.random.split`` then ``normal``, as the scan does) handed to
the port's ``torch.randn`` calls in order. Held: every latent and log-prob
of each level within the rollout tests' 1e-4, and the PNG each level writes
against the one the JAX script writes from its own latents (the same shape,
within one uint8 level). Then each CLI's ``main`` on the CPU writes its
PNGs.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from adv_grpo_torch.cli import flux_sde_demo as t_flux_demo
from adv_grpo_torch.cli import sde_noise_sweep as t_sweep
from adv_grpo_torch.cli.common import make_hash_text_encoder
from adv_grpo_torch.models.convert import flux_state_dict_from_jax
from adv_grpo_torch.models.flux import FluxConfig as TFluxConfig
from adv_grpo_torch.models.flux import FluxTransformer as TFluxTransformer
from adv_grpo_torch.models.mmdit import MMDiTConfig as TMMDiTConfig
from adv_grpo_torch.models.vae import VAEConfig as TVAEConfig
from adv_grpo_torch.train.pipeline import SD3Pipeline as TSD3Pipeline
from adv_grpo_tpu.models.flux import FluxConfig as JFluxConfig
from adv_grpo_tpu.models.flux import FluxTransformer as JFluxTransformer
from adv_grpo_tpu.models.flux import make_latent_ids
from adv_grpo_tpu.native.lib import images_to_uint8
from adv_grpo_tpu.rollout import flux as j_flux
from adv_grpo_tpu.rollout import sampler as j_sampler
from tests.test_torch_flux import jax_flux_params
from tests.test_torch_models import jax_tiny_pipeline

TOL = 1e-4
FLUX_STEPS, FLUX_GUIDANCE, FLUX_GRID = 4, 3.5, 4  # flux_smoke: 4 steps, 64^2 -> 4 x 4 tokens
SD3_STEPS, SD3_HW = 4, 8


def _jax_noise(key, steps, shape):
    """The noise of each step of a JAX rollout scan started from ``key``."""
    draws = []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        draws.append(np.asarray(jax.random.normal(sub, shape, jnp.float32)))
    return draws


def _feed_randn(monkeypatch, draws):
    """``torch.randn`` returns ``draws`` in order (each of the asked shape)."""
    it = iter(draws)

    def randn(*shape, generator=None, device=None, dtype=None, **kw):
        shape = tuple(shape[0]) if len(shape) == 1 and not isinstance(shape[0], int) else shape
        a = next(it)
        assert a.shape == shape
        return torch.from_numpy(a.copy()).to(device=device, dtype=dtype or torch.float32)

    monkeypatch.setattr(torch, "randn", randn)
    return it


def _png(path):
    return np.asarray(Image.open(path))


@pytest.fixture(scope="module")
def flux_models():
    jcfg = JFluxConfig.tiny()
    params = jax_flux_params(jcfg, 41, t_flux_demo.TEXT_TOKENS)
    tcfg = TFluxConfig.tiny()
    model = TFluxTransformer(tcfg, device="cpu")
    model.load_state_dict(flux_state_dict_from_jax(params, tcfg))
    return JFluxTransformer(jcfg), params, jcfg, model


@pytest.mark.parametrize("kontext,levels", [(False, (0.0, 0.7)), (True, (0.7,))])
def test_flux_sweep_matches_jax_script(flux_models, tmp_path, monkeypatch, kontext, levels):
    """The JAX script's loop (``flux_denoise_with_logprob`` with the script's
    velocity: ids of the sample grid, and with ``--kontext`` the
    conditioning grid on frame 1) against ``sweep`` on the same latents,
    text, conditioning and noise."""
    jmodel, params, jcfg, model = flux_models
    rng = np.random.default_rng(7)
    c, hw = jcfg.in_channels // 4, 2 * FLUX_GRID
    lat = rng.standard_normal((1, c, hw, hw)).astype(np.float32)
    txt = rng.standard_normal((1, t_flux_demo.TEXT_TOKENS, jcfg.joint_attention_dim))
    pooled = rng.standard_normal((1, jcfg.pooled_projection_dim))
    txt, pooled = txt.astype(np.float32), pooled.astype(np.float32)
    cond = rng.standard_normal(lat.shape).astype(np.float32) if kontext else None

    packed = j_flux.pack_latents(jnp.asarray(lat))
    ids = make_latent_ids(FLUX_GRID, FLUX_GRID)
    if kontext:
        cond_ids = ids.copy()
        cond_ids[:, 0] = 1
        ids = np.concatenate([ids, cond_ids], axis=0)
    txt_ids = np.zeros((txt.shape[1], 3), np.int32)

    def velocity(tokens, t):
        return jmodel.apply(params, tokens, t, jnp.asarray(txt), jnp.asarray(pooled), ids,
                            txt_ids, guidance=jnp.full((tokens.shape[0],), FLUX_GUIDANCE))

    key = jax.random.PRNGKey(1)  # the script's PRNGKey(seed + 1), seed 0
    wants, draws = [], []
    for nl in levels:
        wants.append(j_flux.flux_denoise_with_logprob(
            velocity, packed, key, j_flux.FluxSamplerConfig(num_steps=FLUX_STEPS, noise_level=nl),
            cond_latents=None if cond is None else j_flux.pack_latents(jnp.asarray(cond))))
        draws += _jax_noise(key, FLUX_STEPS, packed.shape)
    left = _feed_randn(monkeypatch, draws)
    with torch.no_grad():
        got = t_flux_demo.sweep(model, torch.from_numpy(lat), torch.from_numpy(txt),
                                torch.from_numpy(pooled), levels, FLUX_STEPS, FLUX_GUIDANCE,
                                str(tmp_path), 0, None if cond is None else torch.from_numpy(cond))
    assert next(left, None) is None
    tag = "kontext_" if kontext else ""
    for nl, want, (path, out) in zip(levels, wants, got):
        assert os.path.basename(path) == f"{tag}noise_{nl:.1f}.png"
        for name in ("all_latents", "log_probs", "timesteps"):
            np.testing.assert_allclose(getattr(out, name).numpy(), np.asarray(getattr(want, name)),
                                       rtol=TOL, atol=TOL, err_msg=name)
        final = np.asarray(j_flux.unpack_latents(want.final_latents, hw, hw))
        vis = final[0:1, :3] / (np.abs(final[0:1, :3]).max() + 1e-6)
        ref = np.asarray(Image.fromarray(images_to_uint8(vis)[0]).resize((256, 256),
                                                                          Image.NEAREST))
        png = _png(path)
        assert png.shape == ref.shape == (256, 256, 3)
        assert np.abs(png.astype(int) - ref.astype(int)).max() <= 1


def test_sd3_noise_sweep_matches_jax_script(tmp_path, monkeypatch):
    """The JAX script's loop (the whole chain in the stochastic window, CFG
    4.5, the latents and noise from one key) against ``sweep`` on the tiny
    SD3 with the hash text encoder, at noise 0.7: latents, log-probs and
    the decoded PNG."""
    jpipe = jax_tiny_pipeline(43)
    tpipe = TSD3Pipeline.from_jax(
        jpipe.transformer_params, jpipe.vae_params, TMMDiTConfig.tiny(lora_rank=4, lora_alpha=8.0),
        TVAEConfig.tiny(latent_channels=16), "cpu", text_seq_len=6)
    encode = make_hash_text_encoder(seq_len=6, embed_dim=64, pooled_dim=48)
    prompt, levels = "a photo of a red panda", (0.7,)  # both levels: the CLI test
    embeds, pooled = encode([prompt])
    neg_e, neg_p = encode([""])

    key = jax.random.PRNGKey(0)
    lat = np.asarray(jax.random.normal(key, (1, 16, SD3_HW, SD3_HW)))
    wants, draws = [], []
    for nl in levels:
        cfg = j_sampler.SamplerConfig(num_steps=SD3_STEPS, train_num_steps=SD3_STEPS,
                                      noise_level=nl, guidance_scale=4.5)
        out = j_sampler.denoise_with_logprob(
            jpipe.velocity_fn(jpipe.transformer_params), jnp.asarray(lat), jnp.asarray(embeds),
            jnp.asarray(pooled), jnp.asarray(neg_e), jnp.asarray(neg_p), key, cfg, 0)
        wants.append((out, images_to_uint8(np.asarray(jpipe.decode(out.final_latents),
                                                      np.float32))[0]))
        draws += [lat] + _jax_noise(key, SD3_STEPS, lat.shape)
    left = _feed_randn(monkeypatch, draws)
    got = t_sweep.sweep(tpipe, encode, prompt, levels, SD3_STEPS, 4.5, SD3_HW, str(tmp_path))
    assert next(left, None) is None
    for nl, (want, ref), (path, out) in zip(levels, wants, got):
        assert os.path.basename(path) == f"noise_{nl:.1f}.png"
        for name in ("final_latents", "latents", "log_probs"):
            np.testing.assert_allclose(getattr(out, name).numpy(), np.asarray(getattr(want, name)),
                                       rtol=TOL, atol=TOL, err_msg=name)
        png = _png(path)
        assert png.shape == ref.shape == (2 * SD3_HW, 2 * SD3_HW, 3)
        assert np.abs(png.astype(int) - ref.astype(int)).max() <= 1


def test_flux_demo_cli_writes_pngs(tmp_path, monkeypatch, capsys):
    """``main`` at ``flux_smoke`` (the tiny random-init Flux): one PNG a
    level, plain and ``--kontext``, and the JAX script's lines."""
    monkeypatch.delenv("FLUX_DIR", raising=False)
    paths = [p for p, _ in t_flux_demo.main(["--noise_levels", "0.0,0.7", "--device", "cpu",
                                              "--out_dir", str(tmp_path)])]
    paths += [p for p, _ in t_flux_demo.main(["--kontext", "--noise_levels", "0.7", "--device",
                                               "cpu", "--out_dir", str(tmp_path)])]
    assert [os.path.basename(p) for p in paths] == ["noise_0.0.png", "noise_0.7.png",
                                                   "kontext_noise_0.7.png"]
    assert all(_png(p).shape == (256, 256, 3) for p in paths)
    out = capsys.readouterr().out
    assert "mean logprob: deterministic" in out and out.count("| latent std:") == 3


def test_sd3_noise_sweep_cli_writes_pngs(tmp_path, capsys):
    """``main`` at ``smoke_sd3_fast`` (the tiny SD3, hash text encoder)."""
    paths = [p for p, _ in t_sweep.main(["--config", "smoke_sd3_fast", "--latent_hw", "8",
                                          "--noise_levels", "0.0,0.7", "--device", "cpu",
                                          "--out_dir", str(tmp_path)])]
    assert [os.path.basename(p) for p in paths] == ["noise_0.0.png", "noise_0.7.png"]
    assert all(_png(p).shape == (16, 16, 3) for p in paths)
    assert capsys.readouterr().out.count("mean logprob:") == 2
