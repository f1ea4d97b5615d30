"""The port's inference slice against the JAX package, and its CLI on the CPU.

Slice parity: the tiny SD3 pipeline (random numpy weights in the JAX trees,
carried to the port via ``from_jax``) runs the deterministic CFG rollout
(noise level 0, guidance 4.5, 4 steps) from the same numpy latents in both
packages, then the VAE decode; final latents and images must agree. Also: the fp32 CPS step on
shared noise, the port's window record (replayed logprobs equal the sampled
ones), and ``python -m adv_grpo_torch.cli.infer`` writing its PNG.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from adv_grpo_torch.cli import infer as t_infer
from adv_grpo_torch.core.sde import cps_step_with_logprob as t_cps
from adv_grpo_torch.models.mmdit import MMDiTConfig as TMMDiTConfig
from adv_grpo_torch.models.vae import VAEConfig as TVAEConfig
from adv_grpo_torch.rollout import sampler as t_sampler
from adv_grpo_torch.train.pipeline import SD3Pipeline as TSD3Pipeline
from adv_grpo_tpu.core.sde import cps_step_with_logprob as j_cps
from adv_grpo_tpu.rollout import sampler as j_sampler
from tests.test_torch_models import jax_tiny_pipeline


@pytest.fixture(scope="module")
def pipes():
    jpipe = jax_tiny_pipeline(7)
    tpipe = TSD3Pipeline.from_jax(
        jpipe.transformer_params, jpipe.vae_params,
        TMMDiTConfig.tiny(lora_rank=4, lora_alpha=8.0),
        TVAEConfig.tiny(latent_channels=16), "cpu", text_seq_len=6)
    return jpipe, tpipe


def test_denoise_and_decode_match_jax(pipes):
    jpipe, tpipe = pipes
    rng = np.random.default_rng(0)
    lat = rng.standard_normal((2, 16, 8, 8)).astype(np.float32)
    emb = [(rng.standard_normal((2, 6, 64)) * 0.2).astype(np.float32) for _ in range(2)]
    pool = [(rng.standard_normal((2, 48)) * 0.2).astype(np.float32) for _ in range(2)]
    kw = dict(num_steps=4, train_num_steps=0, noise_level=0.0, guidance_scale=4.5)

    out = j_sampler.denoise_with_logprob(
        jpipe.velocity_fn(jpipe.transformer_params), jnp.asarray(lat), emb[0], pool[0],
        emb[1], pool[1], jax.random.PRNGKey(0), j_sampler.SamplerConfig(**kw), 0)
    want_lat = np.asarray(out.final_latents)
    want_img = np.asarray(jpipe.decode(out.final_latents))

    t = lambda a: torch.from_numpy(a)  # noqa: E731
    with torch.no_grad():
        tout = t_sampler.denoise_with_logprob(
            tpipe.velocity_fn(), t(lat), t(emb[0]), t(pool[0]), t(emb[1]), t(pool[1]),
            torch.Generator().manual_seed(0), t_sampler.SamplerConfig(**kw))
        got_img = tpipe.decode(tout.final_latents)
    # fp32 throughout: 4 steps x 2 CFG forwards of a 4-layer model, sums reordered
    np.testing.assert_allclose(tout.final_latents.numpy(), want_lat, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got_img.numpy(), want_img, rtol=1e-4, atol=1e-4)
    assert tout.log_probs.shape == (2, 0)


@pytest.mark.parametrize("noise_level", [0.0, 0.7])
def test_cps_step_matches_jax(noise_level):
    rng = np.random.default_rng(1)
    v, x, noise = (rng.standard_normal((3, 4, 5, 5)).astype(np.float32) for _ in range(3))
    sig, sig_prev = np.float32(0.8), np.array([0.6, 0.5, 0.4], np.float32)
    want = j_cps(v, x, sig, sig_prev, noise_level, noise=noise)
    got = t_cps(torch.from_numpy(v), torch.from_numpy(x), float(sig),
                torch.from_numpy(sig_prev), noise_level, noise=torch.from_numpy(noise))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)
    replay = t_cps(torch.from_numpy(v), torch.from_numpy(x), float(sig),
                   torch.from_numpy(sig_prev), noise_level, prev_sample=got.prev_sample)
    torch.testing.assert_close(replay.log_prob, got.log_prob, rtol=0, atol=0)


def test_window_record_replays(pipes):
    """Per-sample windows: latents[:, j] -> latents[:, j+1] re-scored with the
    recorded sigmas gives the recorded logprob (the replay identity)."""
    _, tpipe = pipes
    g = torch.Generator().manual_seed(0)
    cfg = t_sampler.SamplerConfig(num_steps=5, train_num_steps=2, noise_level=0.7,
                                  guidance_scale=1.0)
    lat = torch.randn(2, 16, 8, 8, generator=g)
    emb, pool = torch.randn(2, 6, 64, generator=g), torch.randn(2, 48, generator=g)
    rt = torch.tensor([0, 2])
    fn = tpipe.velocity_fn()
    with torch.no_grad():
        out = t_sampler.denoise_with_logprob(fn, lat, emb, pool, None, None, g, cfg, rt)
        assert out.latents.shape == (2, 3, 16, 8, 8) and out.log_probs.shape == (2, 2)
        for j in range(2):
            v = fn(out.latents[:, j], out.timesteps[:, j], emb, pool)
            rep = t_cps(v, out.latents[:, j], out.sigmas[:, j], out.sigmas_prev[:, j],
                        cfg.noise_level, prev_sample=out.latents[:, j + 1])
            torch.testing.assert_close(rep.log_prob, out.log_probs[:, j], rtol=1e-6,
                                       atol=1e-7)
    assert (out.log_probs < 0).all()  # inside the window the step is stochastic


def test_infer_cli_writes_png(tmp_path):
    paths = t_infer.main(["--config", "eval_sd3_fast", "--prompts", "a flower",
                          "--set", "smoke_test=True", "--set", "sample.eval_num_steps=3",
                          "--latent_hw", "8", "--out_dir", str(tmp_path),
                          "--device", "cpu"])
    assert [os.path.basename(p) for p in paths] == ["node0_rank0_00000_0.png"]
    img = np.asarray(Image.open(paths[0]))
    assert img.shape == (16, 16, 3) and img.dtype == np.uint8


@pytest.mark.parametrize("extra", [["--lora", "x"], ["--image", "x.png"],
                                   ["--set", "pretrained.model='/no/such/dir'"]])
def test_infer_cli_refuses_unported_branches(tmp_path, extra):
    """A checkpoint directory that does not exist and an ``--image`` file
    that does not exist raise (the transfer itself: tests/
    test_torch_image_entry.py); ``--lora`` is ported, and what it still
    cannot read, an orbax LoRA tree (the JAX package's
    ``checkpoint-N/lora``), raises naming the way across."""
    argv = ["--config", "eval_sd3_fast", "--prompts", "a", "--out_dir", str(tmp_path),
            "--device", "cpu"]
    if extra[0] == "--set":
        with pytest.raises(FileNotFoundError):
            t_infer.main(argv + extra)
    elif extra[0] == "--lora":
        orbax = tmp_path / extra[1]
        (orbax / "d").mkdir(parents=True)
        (orbax / "_METADATA").write_text("{}")
        with pytest.raises(ValueError, match="export_peft_lora"):
            t_infer.main(argv + ["--set", "smoke_test=True", "--lora", str(orbax)])
    else:
        with pytest.raises(FileNotFoundError, match="x.png"):
            t_infer.main(argv + ["--set", "smoke_test=True"] + extra)
