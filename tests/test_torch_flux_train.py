"""The port's Flux GRPO training slice against the JAX package, on the CPU.

Numpy inputs made from a seed go through both packages, fp32 throughout; the
JAX Flux parameters (random, non-zero biases and LoRA B) are carried to the
port with ``flux_state_dict_from_jax``. Covered: the LoRA subtree's JAX path
names, the LoRA gradients of the GRPO loss through ``compute_flux_log_prob``
(the tiny Flux, and the narrow 1 head x 128 geometry where the JAX side runs
the TPU attention backward kernels in interpret mode), one whole inner epoch
against JAX ``make_train_epoch_fn`` (family flux), the trainer's Flux sampler
(window record replay, ``same_latent``), and the train CLI.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adv_grpo_torch.cli import train as t_train
from adv_grpo_torch.core import grpo as t_grpo
from adv_grpo_torch.models import convert as t_convert
from adv_grpo_torch.models.convert import flux_state_dict_from_jax
from adv_grpo_torch.models.flux import FluxTransformer as TFluxTransformer
from adv_grpo_torch.models.lora import freeze_non_lora, lora_params as t_lora_params
from adv_grpo_torch.models.vae import VAEConfig as TVAEConfig
from adv_grpo_torch.rollout import flux as t_rollout
from adv_grpo_torch.rollout import sampler as t_sampler
from adv_grpo_torch.train import grpo_trainer as t_trainer
from adv_grpo_torch.train import train_state as t_state
from adv_grpo_torch.train.flux_pipeline import FluxPipeline as TFluxPipeline
from adv_grpo_tpu.core import grpo as j_grpo
from adv_grpo_tpu.models.flux import FluxTransformer as JFluxTransformer
from adv_grpo_tpu.models.flux import make_latent_ids
from adv_grpo_tpu.models.lora import lora_params as j_lora_params
from adv_grpo_tpu.models.lora import merge_lora_params as j_merge_lora_params
from adv_grpo_tpu.rollout import flux as j_rollout
from adv_grpo_tpu.rollout import sampler as j_sampler
from adv_grpo_tpu.train import grpo_trainer as j_trainer
from adv_grpo_tpu.train import train_state as j_state
from adv_grpo_tpu.train.flux_pipeline import FluxPipeline as JFluxPipeline
from tests.test_torch_flux import GEOMETRIES, _configs, jax_flux_params
from tests.test_torch_train import _train_cfg


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _pipes(geometry, seed):
    """The same random numpy Flux weights in both packages' pipelines (no
    VAE: the replay and the epoch never decode)."""
    tcfg, jcfg, _, s_txt = _configs(geometry, lora_rank=4, lora_alpha=8.0)
    params = jax_flux_params(jcfg, seed, s_txt)
    jpipe = JFluxPipeline(jcfg, None, JFluxTransformer(jcfg), None, params, None,
                          text_seq_len=s_txt, guidance=3.5)
    model = TFluxTransformer(tcfg, device="cpu")
    model.load_state_dict(flux_state_dict_from_jax(params, tcfg))
    tpipe = TFluxPipeline(tcfg, None, model, None, torch.device("cpu"), text_seq_len=s_txt,
                          guidance=3.5)
    return jpipe, tpipe, s_txt


def _window_record(tcfg, s_txt, seed, num_mini=2, bs=2, T=2, grid=4, num_steps=4):
    """A Flux rollout record of the trainer's layout, (num_mini, bs, ...):
    packed latents, the schedule's timesteps and sigmas at each sample's
    window steps, advantages and embeddings."""
    rng = np.random.default_rng(seed)
    s = grid * grid
    sigmas, timesteps = t_rollout.flux_schedule(num_steps, s)
    steps = rng.integers(0, num_steps - T + 1, size=(num_mini, bs))[..., None] + np.arange(T)
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return dict(
        latents=f32(rng.standard_normal((num_mini, bs, T + 1, s, tcfg.in_channels))),
        timesteps=f32(timesteps[steps]), sigmas=f32(sigmas[steps]),
        sigmas_prev=f32(sigmas[steps + 1]),
        advantages=f32(rng.standard_normal((num_mini, bs))),
        embeds=f32(rng.standard_normal((num_mini, bs, s_txt, tcfg.joint_attention_dim)) * 0.2),
        pooled=f32(rng.standard_normal((num_mini, bs, tcfg.pooled_projection_dim)) * 0.2))


# ── the LoRA subtree's names ─────────────────────────────────────────────


@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_flux_lora_paths_match_jax(geometry):
    """``lora_params`` of a Flux model gives the JAX tree's flat paths
    (``double_{i}/attn/add_to_q/lora_a``, ``single_{i}/to_v/lora_b``), so
    ``lora_from_jax`` / ``lora_to_jax`` carry a JAX LoRA subtree key for key
    and bit for bit."""
    tcfg, jcfg, _, s_txt = _configs(geometry, lora_rank=4, lora_alpha=8.0)
    params = jax_flux_params(jcfg, 6, s_txt)
    want = j_lora_params(params["params"])
    model = TFluxTransformer(tcfg, device="cpu")
    model.load_state_dict(flux_state_dict_from_jax(params, tcfg))
    assert set(t_lora_params(model)) == set(want)
    assert "double_0/attn/add_to_q/lora_a" in want and "single_0/proj_mlp/lora_b" in want
    got = t_convert.lora_to_jax(model)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], np.asarray(v), err_msg=k)
    moved = {k: np.asarray(v) * 2.0 for k, v in want.items()}
    t_convert.lora_from_jax(model, moved)
    for k, v in t_convert.lora_to_jax(model).items():
        np.testing.assert_array_equal(v, moved[k], err_msg=k)


def test_flux_rope_cache_serves_a_training_forward_after_inference():
    """The RoPE angles cached by an inference_mode forward are not reused by a
    forward that autograd records (inference tensors cannot be saved for a
    backward)."""
    tcfg, _, grid, s_txt = _configs("tiny", lora_rank=4)
    model = TFluxTransformer(tcfg, device="cpu")
    g = torch.Generator().manual_seed(0)
    for p in model.parameters():
        p.data.normal_(0.0, 0.1, generator=g)
    args = (torch.randn(1, 4, tcfg.in_channels, generator=g), torch.tensor([500.0]),
            torch.randn(1, s_txt, tcfg.joint_attention_dim, generator=g),
            torch.randn(1, tcfg.pooled_projection_dim, generator=g), make_latent_ids(2, 2),
            np.zeros((s_txt, 3), np.int32))
    with torch.inference_mode():
        ref = model(*args)
    lora = freeze_non_lora(model)
    out = model(*args)
    grads = torch.autograd.grad(out.sum(), list(lora.values()))
    torch.testing.assert_close(out.detach(), ref.clone(), rtol=0, atol=0)
    assert all(torch.isfinite(x).all() for x in grads)


# ── gradients of the GRPO loss through the Flux replay ───────────────────


@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_flux_lora_grads_of_the_grpo_loss_match_jax(geometry):
    """LoRA gradients of the GRPO loss of one window step replayed through
    ``compute_flux_log_prob`` (the Flow-SDE step's log-probability, fp32)
    against ``jax.grad`` of the JAX loss on the same weights and record; old
    log-probs 1e-4 from the replayed ones, inside the clip range, so every
    row carries gradient. At ``narrow_d128`` the JAX side differentiates
    through the TPU kernels in interpret mode (``_joint_bwd_kernel`` at
    d = 128, ``_bshd_bwd_fused_kernel``), the port through the kernels' plain
    twins. Bound: 2e-3 relative to each gradient's largest element (the
    attention gradients' bound, tests/test_torch_grads.py), through 2 to 4
    blocks of fp32 sums in another order."""
    jpipe, tpipe, s_txt = _pipes(geometry, 7)
    grid = GEOMETRIES[geometry][2]
    if grid[0] != grid[1]:  # the pipelines' velocity closures take a square grid
        grid = (4, 4)
    rec = _window_record(tpipe.flux_cfg, s_txt, 8, num_mini=1, grid=grid[0])
    scfg = dict(num_steps=4, train_num_steps=2, noise_level=0.7, guidance_scale=1.0)
    mb = [rec["latents"][0, :, 0], rec["latents"][0, :, 1], rec["timesteps"][0, :, 0],
          rec["sigmas"][0, :, 0], rec["sigmas_prev"][0, :, 0], rec["embeds"][0],
          rec["pooled"][0]]
    adv = rec["advantages"][0]
    kw = dict(clip_range=1e-3, adv_clip_max=5.0)

    lora = freeze_non_lora(tpipe.transformer)
    with torch.no_grad():
        lp0 = t_rollout.compute_flux_log_prob(tpipe.velocity_fn(), *map(_t, mb), None, None,
                                              t_sampler.SamplerConfig(**scfg))[0]
    old = (lp0.numpy() + 1e-4).astype(np.float32)
    lp = t_rollout.compute_flux_log_prob(tpipe.velocity_fn(), *map(_t, mb), None, None,
                                         t_sampler.SamplerConfig(**scfg))[0]
    loss = t_grpo.grpo_loss(lp, _t(old), _t(adv), **kw).loss
    got = dict(zip(lora, torch.autograd.grad(loss, list(lora.values()))))

    frozen = jpipe.transformer_params

    def jloss(lora_flat):
        params = {**frozen, "params": j_merge_lora_params(frozen["params"], lora_flat)}
        jlp = j_rollout.compute_flux_log_prob(
            jpipe.velocity_fn(params), *map(jnp.asarray, mb), None, None,
            j_sampler.SamplerConfig(**scfg))[0]
        return j_grpo.grpo_loss(jlp, jnp.asarray(old), jnp.asarray(adv), **kw).loss

    want = jax.jit(jax.grad(jloss))(j_lora_params(frozen["params"]))
    assert set(got) == set(want)
    for k, w in want.items():
        w = np.asarray(w)
        tol = 2e-3 * max(float(np.abs(w).max()), 1e-12)
        np.testing.assert_allclose(got[k].numpy(), w, rtol=0, atol=tol, err_msg=k)
    assert any(np.abs(np.asarray(w)).max() > 0 for k, w in want.items() if k.endswith("a"))


# ── one inner epoch ──────────────────────────────────────────────────────


def test_flux_train_epoch_matches_jax():
    """One Flux inner epoch, 2 minibatches x 2 window steps = 4 microbatches,
    accumulation 2, EMA every step: both packages from the same LoRA, record
    and advantages; old log-probs the replayed ones moved by ~1e-3 around the
    1e-3 clip range, so both branches of the clip are live. Tolerances as in
    tests/test_torch_train.py test_train_epoch_matches_jax: the diagnostics
    1e-4 relative, LoRA and EMA 1e-4 relative plus 2e-6 absolute. Adam
    divides each element by its own magnitude plus epsilon, so a gradient
    element near epsilon turns a summation-order difference d into an update
    difference lr * d / epsilon: at the preset's 1e-8 the tiny Flux has such
    elements (1e-4 apart), so both packages run with epsilon 1e-4 here (an
    element below it moves in proportion to its gradient)."""
    jpipe, tpipe, s_txt = _pipes("tiny", 9)
    cfg = _train_cfg(gradient_accumulation_steps=1, ema=True, ema_interval=1,
                     clip_range=1e-3, adam_epsilon=1e-4)
    scfg = dict(num_steps=4, train_num_steps=2, noise_level=0.7, guidance_scale=1.0)
    rec = _window_record(tpipe.flux_cfg, s_txt, 10)
    neg_e = np.zeros((2, s_txt, tpipe.flux_cfg.joint_attention_dim), np.float32)
    neg_p = np.zeros((2, tpipe.flux_cfg.pooled_projection_dim), np.float32)
    with torch.no_grad():
        lp0 = torch.stack([torch.stack([t_rollout.compute_flux_log_prob(
            tpipe.velocity_fn(), _t(rec["latents"][i, :, j]), _t(rec["latents"][i, :, j + 1]),
            _t(rec["timesteps"][i, :, j]), _t(rec["sigmas"][i, :, j]),
            _t(rec["sigmas_prev"][i, :, j]), _t(rec["embeds"][i]), _t(rec["pooled"][i]),
            None, None, t_sampler.SamplerConfig(**scfg))[0]
            for j in range(2)], dim=1) for i in range(2)])
    rng = np.random.default_rng(11)
    rec["log_probs"] = (lp0.numpy() + rng.standard_normal(lp0.shape) * 1e-3).astype(np.float32)

    jlora0 = j_lora_params(jpipe.transformer_params["params"])
    jst = j_state.create_generator_state(jlora0, cfg, 2)
    jfn = j_trainer.make_train_epoch_fn(jpipe, j_sampler.SamplerConfig(**scfg), cfg)
    jst, jinfo = jfn(jst, jpipe.transformer_params, {k: jnp.asarray(v) for k, v in rec.items()},
                     jnp.asarray(neg_e), jnp.asarray(neg_p))

    tst = t_state.create_generator_state(freeze_non_lora(tpipe.transformer), cfg, 2)
    tfn = t_trainer.make_train_epoch_fn(tpipe, t_sampler.SamplerConfig(**scfg), cfg)
    tst, tinfo = tfn(tst, {k: _t(v) for k, v in rec.items()}, _t(neg_e), _t(neg_p))

    assert tst.global_step == int(jst.global_step) == 2
    assert 0 < tinfo["clipfrac"] < 1
    for k in ("loss", "policy_loss", "approx_kl", "clipfrac", "clipfrac_gt_one",
              "clipfrac_lt_one"):
        np.testing.assert_allclose(tinfo[k], float(jinfo[k]), rtol=1e-4, atol=1e-9,
                                   err_msg=k)
    moved = 0
    for k, p in t_lora_params(tpipe.transformer).items():
        want = np.asarray(jst.lora[k])
        moved += not np.array_equal(want, np.asarray(jlora0[k]))
        np.testing.assert_allclose(p.detach().numpy(), want, rtol=1e-4, atol=2e-6, err_msg=k)
        np.testing.assert_allclose(tst.ema[k].numpy(), np.asarray(jst.ema.params[k]),
                                   rtol=1e-4, atol=2e-6, err_msg=k)
    assert moved == len(jlora0)


# ── the trainer's Flux sampler and the CLI ───────────────────────────────


@pytest.mark.parametrize("same_latent", [False, True])
def test_flux_sample_fn_record_replays(same_latent):
    """The trainer's Flux sampling batch: every window step of its record
    replays to the recorded log-probability through ``compute_flux_log_prob``
    (the replay identity, fp32 1e-6); with ``same_latent`` the members of a
    group start from one latent and their trajectories still differ."""
    tcfg, _, _, s_txt = _configs("tiny", lora_rank=4, lora_alpha=8.0)
    tpipe = TFluxPipeline.random_init(torch.Generator().manual_seed(12), tcfg,
                                      TVAEConfig.tiny(latent_channels=4), "cpu", latent_hw=8,
                                      text_seq_len=s_txt)
    scfg = t_sampler.SamplerConfig(num_steps=4, train_num_steps=2, noise_level=0.7,
                                   guidance_scale=1.0)
    sample = t_trainer.make_flux_sample_fn(tpipe, scfg, 8, same_latent=same_latent,
                                           group_size=2)
    g = torch.Generator().manual_seed(13)
    emb = torch.randn(4, s_txt, tpipe.flux_cfg.joint_attention_dim, generator=g) * 0.2
    pooled = torch.randn(4, tpipe.flux_cfg.pooled_projection_dim, generator=g) * 0.2
    out, images = sample(emb, pooled, None, None, g, torch.zeros(4, dtype=torch.long))
    assert out.latents.shape == (4, 3, 16, 16) and out.log_probs.shape == (4, 2)
    assert images.shape == (4, 3, 16, 16) and torch.isfinite(images).all()
    first = out.latents[:, 0]  # rt = 0: the initial latents
    assert torch.equal(first[0], first[1]) == same_latent
    assert not torch.equal(out.latents[0, 1], out.latents[1, 1])
    with torch.no_grad():
        for j in range(2):
            lp, _, _ = t_rollout.compute_flux_log_prob(
                tpipe.velocity_fn(), out.latents[:, j], out.latents[:, j + 1],
                out.timesteps[:, j], out.sigmas[:, j], out.sigmas_prev[:, j], emb, pooled,
                None, None, scfg)
            torch.testing.assert_close(lp, out.log_probs[:, j], rtol=1e-6, atol=1e-6)


def test_flux_train_cli_runs_two_epochs_on_the_cpu(tmp_path, monkeypatch):
    """``cli.train --config flux_smoke --device cpu --max_epochs 2`` trains the
    tiny Flux (the JAX tests/test_flux_trainer.py:82): finite diagnostics in
    both epochs, 2 x 2 minibatches x 2 window steps at accumulation 2 -> 4
    optimizer steps, and every LoRA factor moved."""
    monkeypatch.delenv("FLUX_DIR", raising=False)
    trainer = t_train.main(["--config", "flux_smoke", "--device", "cpu", "--max_epochs", "2",
                            "--set", f"save_dir={tmp_path}"])
    assert trainer.family == "flux" and trainer.epoch == 2
    lines = (tmp_path / "metrics.jsonl").read_text().splitlines()
    assert len(lines) == 2
    for rec in map(json.loads, lines):
        for k in ("reward_avg", "loss", "approx_kl", "clipfrac"):
            assert np.isfinite(rec[k]), (k, rec[k])
    assert all(np.isfinite(x) for x in trainer.last_inner_losses)
    assert trainer.state.global_step == 4
    start = t_train.build_trainer(trainer.config, device="cpu")
    assert set(start.state.lora) == set(trainer.state.lora)
    assert all(not torch.equal(p, start.state.lora[k]) for k, p in trainer.state.lora.items())
    assert (tmp_path / "samples_epoch_00000.jpg").exists()
