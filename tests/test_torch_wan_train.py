"""The port's WAN GRPO training slice against the JAX package, on the CPU.

Numpy inputs made from a seed go through both packages, fp32 throughout; the
JAX WAN parameters (random, non-zero biases and LoRA B) are carried to the
port with ``wan_state_dict_from_jax``. Covered: the LoRA subtree's JAX path
names, the RoPE cache across inference and training forwards, the LoRA
gradients of the GRPO loss through ``make_wan_log_prob_fn`` (the tiny WAN,
and the narrow 1 head x 128 geometry where the JAX side runs the TPU BSHD
attention backward in interpret mode on its padded sequence), one whole inner
epoch against JAX ``make_train_epoch_fn`` (family wan), the trainer's WAN
sampler (window record replay, ``same_latent``, the KL branch's two
policies on the same modules) and the train CLI.
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
from adv_grpo_torch.models.convert import wan_state_dict_from_jax
from adv_grpo_torch.models.lora import freeze_non_lora, lora_params as t_lora_params
from adv_grpo_torch.models.wan import WanTransformer as TWanTransformer
from adv_grpo_torch.models.wan_vae import WanVAEConfig as TWanVAEConfig
from adv_grpo_torch.rollout import sampler as t_sampler
from adv_grpo_torch.rollout import wan as t_rollout
from adv_grpo_torch.train import grpo_trainer as t_trainer
from adv_grpo_torch.train import train_state as t_state
from adv_grpo_torch.train.wan_pipeline import WanPipeline as TWanPipeline
from adv_grpo_tpu.core import grpo as j_grpo
from adv_grpo_tpu.models.lora import lora_params as j_lora_params
from adv_grpo_tpu.models.lora import merge_lora_params as j_merge_lora_params
from adv_grpo_tpu.models.wan import WanTransformer as JWanTransformer
from adv_grpo_tpu.rollout import sampler as j_sampler
from adv_grpo_tpu.rollout import wan as j_rollout
from adv_grpo_tpu.train import grpo_trainer as j_trainer
from adv_grpo_tpu.train import train_state as j_state
from adv_grpo_tpu.train.wan_pipeline import WanPipeline as JWanPipeline
from tests.test_torch_train import _train_cfg
from tests.test_torch_wan import GEOMETRIES, jax_wan_params, wan_configs

SCFG = dict(num_steps=4, train_num_steps=2, noise_level=0.7, guidance_scale=1.0)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _pipes(geometry, seed):
    """The same random numpy WAN weights in both packages' pipelines (no VAE:
    the replay and the epoch never decode)."""
    tcfg, jcfg, s_txt = wan_configs(geometry, lora_rank=4, lora_alpha=8.0)
    params = jax_wan_params(jcfg, seed, s_txt)
    jpipe = JWanPipeline(jcfg, None, JWanTransformer(jcfg), None, params, None,
                         text_seq_len=s_txt, latent_frames=2)
    model = TWanTransformer(tcfg, device="cpu")
    model.load_state_dict(wan_state_dict_from_jax(params, tcfg))
    tpipe = TWanPipeline(tcfg, None, model, None, torch.device("cpu"), text_seq_len=s_txt,
                         latent_frames=2)
    return jpipe, tpipe, s_txt


def _window_record(tcfg, s_txt, seed, num_mini=2, bs=2, T=2, grid=(2, 4, 6)):
    """A WAN rollout record of the trainer's layout, (num_mini, bs, ...): 5-D
    latents, the schedule's timesteps and sigmas at each sample's window
    steps (the last step included), advantages and embeddings."""
    rng = np.random.default_rng(seed)
    sigmas, timesteps = t_rollout.wan_schedule(SCFG["num_steps"])
    steps = rng.integers(0, SCFG["num_steps"] - T + 1, size=(num_mini, bs))[..., None]
    steps = steps + np.arange(T)
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return dict(
        latents=f32(rng.standard_normal((num_mini, bs, T + 1, tcfg.in_channels) + grid)),
        timesteps=f32(timesteps[steps]), sigmas=f32(sigmas[steps]),
        sigmas_prev=f32(sigmas[steps + 1]),
        advantages=f32(rng.standard_normal((num_mini, bs))),
        embeds=f32(rng.standard_normal((num_mini, bs, s_txt, tcfg.text_dim)) * 0.2),
        pooled=np.zeros((num_mini, bs, 8), np.float32))


# ── the LoRA subtree's names and the RoPE cache ─────────────────────────


@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_wan_lora_paths_match_jax(geometry):
    """``lora_params`` of a WAN model gives the JAX tree's flat paths
    (``block_{i}/to_q/lora_a``, ``block_{i}/cross_to_out/lora_b``), so
    ``lora_from_jax`` / ``lora_to_jax`` carry a JAX LoRA subtree key for key
    and bit for bit."""
    tcfg, jcfg, s_txt = wan_configs(geometry, lora_rank=4, lora_alpha=8.0)
    params = jax_wan_params(jcfg, 6, s_txt)
    want = j_lora_params(params["params"])
    model = TWanTransformer(tcfg, device="cpu")
    model.load_state_dict(wan_state_dict_from_jax(params, tcfg))
    assert set(t_lora_params(model)) == set(want)
    assert "block_0/cross_to_k/lora_a" in want and "block_0/to_out/lora_b" in want
    assert len(want) == 16 * tcfg.num_layers  # 8 projections x (A, B) per block
    got = t_convert.lora_to_jax(model)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], np.asarray(v), err_msg=k)
    moved = {k: np.asarray(v) * 2.0 for k, v in want.items()}
    t_convert.lora_from_jax(model, moved)
    for k, v in t_convert.lora_to_jax(model).items():
        np.testing.assert_array_equal(v, moved[k], err_msg=k)


def test_wan_rope_cache_serves_a_training_forward_after_inference():
    """The RoPE angles cached by an inference_mode forward are not reused by a
    forward that autograd records (inference tensors cannot be saved for a
    backward); a second grid gets its own angles."""
    _, tpipe, s_txt = _pipes("tiny", 0)
    model = tpipe.transformer
    g = torch.Generator().manual_seed(0)
    args = (torch.randn(1, 16, 2, 4, 4, generator=g), torch.tensor([500.0]),
            torch.randn(1, s_txt, 32, generator=g))
    with torch.inference_mode():
        ref = model(*args)
        model(torch.randn(1, 16, 1, 2, 6, generator=g), *args[1:])
    lora = freeze_non_lora(model)
    out = model(*args)
    grads = torch.autograd.grad(out.sum(), list(lora.values()))
    torch.testing.assert_close(out.detach(), ref.clone(), rtol=0, atol=0)
    assert all(torch.isfinite(x).all() for x in grads)
    assert len(model._rope) == 3


# ── gradients of the GRPO loss through the WAN replay ───────────────────


@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_wan_lora_grads_of_the_grpo_loss_match_jax(geometry):
    """LoRA gradients of the GRPO loss of one window step replayed through
    ``make_wan_log_prob_fn`` (the WAN step's log-probability, fp32) against
    ``jax.grad`` of the JAX loss on the same weights and record; old
    log-probs 1e-4 from the replayed ones, inside the clip range, so every
    row carries gradient. At ``narrow_d128`` the JAX side differentiates
    through the TPU BSHD kernels in interpret mode (self-attention over 24
    video tokens and cross-attention to 8 text tokens, both padded to 128),
    the port through the kernel's plain twin. Bound: 2e-3 relative to each
    gradient's largest element (the attention gradients' bound,
    tests/test_torch_grads.py)."""
    jpipe, tpipe, s_txt = _pipes(geometry, 7)
    rec = _window_record(tpipe.wan_cfg, s_txt, 8, num_mini=1)
    mb = [rec["latents"][0, :, 0], rec["latents"][0, :, 1], rec["timesteps"][0, :, 0],
          rec["sigmas"][0, :, 0], rec["sigmas_prev"][0, :, 0], rec["embeds"][0],
          rec["pooled"][0]]
    adv = rec["advantages"][0]
    kw = dict(clip_range=1e-3, adv_clip_max=5.0)
    t_lp = t_rollout.make_wan_log_prob_fn(t_rollout.WanSamplerConfig(num_steps=4))

    lora = freeze_non_lora(tpipe.transformer)
    with torch.no_grad():
        lp0 = t_lp(tpipe.velocity_fn(), *map(_t, mb), None, None, None)[0]
    old = (lp0.numpy() + 1e-4).astype(np.float32)
    lp = t_lp(tpipe.velocity_fn(), *map(_t, mb), None, None, None)[0]
    loss = t_grpo.grpo_loss(lp, _t(old), _t(adv), **kw).loss
    got = dict(zip(lora, torch.autograd.grad(loss, list(lora.values()))))

    frozen = jpipe.transformer_params
    j_lp = j_rollout.make_wan_log_prob_fn(j_rollout.WanSamplerConfig(num_steps=4))

    def jloss(lora_flat):
        params = {**frozen, "params": j_merge_lora_params(frozen["params"], lora_flat)}
        jlp = j_lp(jpipe.velocity_fn(params), *map(jnp.asarray, mb), None, None, None)[0]
        return j_grpo.grpo_loss(jlp, jnp.asarray(old), jnp.asarray(adv), **kw).loss

    want = jax.jit(jax.grad(jloss))(j_lora_params(frozen["params"]))
    assert set(got) == set(want)
    for k, w in want.items():
        w = np.asarray(w)
        tol = 2e-3 * max(float(np.abs(w).max()), 1e-12)
        np.testing.assert_allclose(got[k].numpy(), w, rtol=0, atol=tol, err_msg=k)
    assert all(np.abs(np.asarray(w)).max() > 0 for w in want.values())


# ── one inner epoch ──────────────────────────────────────────────────────


def test_wan_train_epoch_matches_jax():
    """One WAN inner epoch, 2 minibatches x 2 window steps = 4 microbatches,
    accumulation 2, EMA every step: both packages from the same LoRA, record
    and advantages. The record's next latents are drawn from each step's
    transition (mean + step std x noise, as a rollout records them), so the
    log-probs are O(1); old log-probs the replayed ones moved by ~1e-3 around
    the 1e-3 clip range, so both branches of the clip are live. Tolerances
    and Adam's epsilon as in tests/test_torch_flux_train.py
    test_flux_train_epoch_matches_jax (diagnostics 1e-4 relative; LoRA and
    EMA 1e-4 relative plus 2e-6 absolute; epsilon 1e-4)."""
    jpipe, tpipe, s_txt = _pipes("tiny", 9)
    cfg = _train_cfg(gradient_accumulation_steps=1, ema=True, ema_interval=1,
                     clip_range=1e-3, adam_epsilon=1e-4)
    rec = _window_record(tpipe.wan_cfg, s_txt, 10)
    neg_e = np.zeros((2, s_txt, tpipe.wan_cfg.text_dim), np.float32)
    neg_p = np.zeros((2, 8), np.float32)
    t_lp = t_rollout.make_wan_log_prob_fn(t_rollout.WanSamplerConfig(num_steps=4))
    rng = np.random.default_rng(11)
    lp0 = np.zeros((2, 2, 2), np.float32)
    with torch.no_grad():
        for i in range(2):
            for j in range(2):
                lat = rec["latents"][i, :, j]
                args = (_t(rec["timesteps"][i, :, j]), _t(rec["sigmas"][i, :, j]),
                        _t(rec["sigmas_prev"][i, :, j]), _t(rec["embeds"][i]), None, None,
                        None, None)
                _, mean, std = t_lp(tpipe.velocity_fn(), _t(lat), _t(lat), *args)
                nxt = mean + std * torch.randn(mean.shape, generator=torch.Generator()
                                               .manual_seed(i * 2 + j))
                rec["latents"][i, :, j + 1] = nxt.numpy()
                lp0[i, :, j] = t_lp(tpipe.velocity_fn(), _t(lat), nxt, *args)[0].numpy()
    assert np.abs(lp0).max() < 5.0
    rec["log_probs"] = (lp0 + rng.standard_normal(lp0.shape) * 1e-3).astype(np.float32)

    jlora0 = j_lora_params(jpipe.transformer_params["params"])
    jst = j_state.create_generator_state(jlora0, cfg, 2)
    jfn = j_trainer.make_train_epoch_fn(jpipe, j_sampler.SamplerConfig(**SCFG), cfg)
    jst, jinfo = jfn(jst, jpipe.transformer_params, {k: jnp.asarray(v) for k, v in rec.items()},
                     jnp.asarray(neg_e), jnp.asarray(neg_p))

    tst = t_state.create_generator_state(freeze_non_lora(tpipe.transformer), cfg, 2)
    tfn = t_trainer.make_train_epoch_fn(tpipe, t_sampler.SamplerConfig(**SCFG), cfg)
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


# ── the trainer's WAN sampler and the CLI ────────────────────────────────


def _random_pipeline(seed):
    tcfg, _, s_txt = wan_configs("tiny", lora_rank=4, lora_alpha=8.0)
    c = tcfg.in_channels
    vcfg = TWanVAEConfig.tiny(z_dim=c, latents_mean=(0.0,) * c, latents_std=(1.0,) * c)
    pipe = TWanPipeline.random_init(torch.Generator().manual_seed(seed), tcfg, vcfg, "cpu",
                                    latent_hw=4, latent_frames=2, text_seq_len=s_txt)
    with torch.no_grad():  # non-zero adapters, so the two policies differ
        for name, p in pipe.transformer.named_parameters():
            if name.endswith("lora_b"):
                p.normal_(0.0, 0.1, generator=torch.Generator().manual_seed(seed + 1))
    return pipe, s_txt


@pytest.mark.parametrize("same_latent", [False, True])
def test_wan_sample_fn_record_replays(same_latent):
    """The trainer's WAN sampling batch: every window step of its record
    replays to the recorded log-probability through ``make_wan_log_prob_fn``
    (fp32 1e-6); with ``same_latent`` the members of a group start from one
    latent and their trajectories still differ; the video is frame-major."""
    tpipe, s_txt = _random_pipeline(12)
    scfg = t_sampler.SamplerConfig(**SCFG)
    sample = t_trainer.make_wan_sample_fn(tpipe, scfg, 4, same_latent=same_latent,
                                          group_size=2)
    g = torch.Generator().manual_seed(13)
    emb = torch.randn(4, s_txt, tpipe.wan_cfg.text_dim, generator=g) * 0.2
    out, video = sample(emb, torch.zeros(4, 8), None, None, g, torch.tensor([0, 0, 2, 1]))
    assert out.latents.shape == (4, 3, 16, 2, 4, 4) and out.log_probs.shape == (4, 2)
    assert video.shape == (4, 3, 3, 8, 8) and torch.isfinite(video).all()
    first = out.latents[:, 0]
    assert torch.equal(first[0], first[1]) == same_latent  # one group, rt = 0 for both
    assert not out.kl.any()  # the pipeline carries no kl_reward
    replay = t_rollout.make_wan_log_prob_fn(t_rollout.WanSamplerConfig(num_steps=4))
    with torch.no_grad():
        for j in range(2):
            lp, _, _ = replay(tpipe.velocity_fn(), out.latents[:, j], out.latents[:, j + 1],
                              out.timesteps[:, j], out.sigmas[:, j], out.sigmas_prev[:, j],
                              emb, None, None, None, None)
            torch.testing.assert_close(lp, out.log_probs[:, j], rtol=1e-6, atol=1e-6)


def test_wan_kl_branch_alternates_the_policies_on_the_same_modules():
    """With a ``kl_reward`` on the pipeline the sampler runs ``lora_scale`` 1
    and 0 in turn on the same modules, whose fused q/k/v operand is cached on
    the parameters, not the scale: each policy's velocity equals the one it
    gives alone (the adapter-free one a model with zeroed LoRA B's), the
    recorded KL is positive, and it equals the KL recomputed from the record."""
    tpipe, s_txt = _random_pipeline(14)
    g = torch.Generator().manual_seed(15)
    x = torch.randn(2, 16, 2, 4, 4, generator=g)
    emb = torch.randn(2, s_txt, tpipe.wan_cfg.text_dim, generator=g) * 0.2
    t = torch.tensor([900.0, 400.0])
    v1, v0 = tpipe.velocity_fn(1.0), tpipe.velocity_fn(0.0)
    with torch.no_grad():
        first = v1(x, t, emb)
        ref0 = v0(x, t, emb)
        again = v1(x, t, emb)
        saved = {k: p.detach().clone() for k, p in t_lora_params(tpipe.transformer).items()}
        for k, p in t_lora_params(tpipe.transformer).items():
            if k.endswith("lora_b"):
                p.zero_()
        plain = v1(x, t, emb)
        t_convert.lora_from_jax(tpipe.transformer, {k: v.numpy() for k, v in saved.items()})
    torch.testing.assert_close(again, first, rtol=0, atol=0)
    torch.testing.assert_close(ref0, plain, rtol=1e-6, atol=1e-6)
    assert not torch.allclose(first, ref0)

    tpipe.kl_reward = 0.5
    sample = t_trainer.make_wan_sample_fn(tpipe, t_sampler.SamplerConfig(**SCFG), 4)
    out, _ = sample(emb, None, None, None, torch.Generator().manual_seed(16), 0)
    assert (out.kl > 0).all()
    sig_min, sig_max = 0.0, float(t_rollout.wan_schedule(4)[0][1])
    with torch.no_grad():
        for j in range(2):
            args = (out.latents[:, j], out.sigmas[:, j], out.sigmas_prev[:, j])
            steps = [t_rollout.wan_sde_step_with_logprob(
                v(out.latents[:, j], out.timesteps[:, j], emb), args[0], *args[1:],
                sigma_min=sig_min, sigma_max=sig_max, prev_sample=out.latents[:, j + 1])
                for v in (v1, v0)]
            kl = ((steps[0].prev_sample_mean - steps[1].prev_sample_mean) ** 2
                  / (2.0 * steps[0].std_dev_t ** 2)).mean(dim=(1, 2, 3, 4))
            torch.testing.assert_close(kl, out.kl[:, j], rtol=1e-5, atol=1e-12)


def test_wan_eval_fn_runs_the_given_lora_deterministically():
    """The trainer's WAN eval: the deterministic chain under the given LoRA
    values (here the adapter-free ones), equal to the same chain run with
    those values in place, and the live LoRA restored afterwards."""
    tpipe, s_txt = _random_pipeline(17)
    live = {k: p.detach().clone() for k, p in t_lora_params(tpipe.transformer).items()}
    zeroed = {k: torch.zeros_like(v) if k.endswith("lora_b") else v for k, v in live.items()}
    evaluate = t_trainer.make_wan_eval_fn(tpipe, t_sampler.SamplerConfig(**SCFG), 4)
    emb = torch.randn(2, s_txt, tpipe.wan_cfg.text_dim,
                      generator=torch.Generator().manual_seed(18)) * 0.2
    video = evaluate(zeroed, emb, None, None, None, torch.Generator().manual_seed(19))
    assert video.shape == (2, 3, 3, 8, 8) and torch.isfinite(video).all()
    for k, p in t_lora_params(tpipe.transformer).items():
        assert torch.equal(p, live[k]), k
    g = torch.Generator().manual_seed(19)
    lat = tpipe.prepare_latents(g, 2, 4)
    v0 = tpipe.velocity_fn(0.0)  # zero LoRA B == the adapter-free policy
    with torch.no_grad():
        out = t_rollout.wan_denoise_with_logprob(
            lambda x, t, s: v0(x, t, emb), lat, g,
            t_rollout.WanSamplerConfig(num_steps=4, deterministic=True))
        want = tpipe.decode(out.final_latents)
    torch.testing.assert_close(video, want, rtol=1e-5, atol=1e-5)


def test_wan_train_cli_runs_two_epochs_on_the_cpu(tmp_path, monkeypatch):
    """``cli.train --config wan_smoke --device cpu --max_epochs 2`` trains the
    tiny WAN: finite diagnostics and rollout TFLOP/s in both epochs, 2 x 2
    minibatches x 2 window steps at accumulation 2 -> 4 optimizer steps,
    every LoRA factor moved, the sample strip written (first frames)."""
    monkeypatch.delenv("WAN_DIR", raising=False)
    trainer = t_train.main(["--config", "wan_smoke", "--device", "cpu", "--max_epochs", "2",
                            "--set", f"save_dir={tmp_path}"])
    assert trainer.family == "wan" and trainer.epoch == 2
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
