"""The port's GRPO training slice against the JAX package, on the CPU.

Numpy inputs made from a seed go through both packages; fp32 throughout. The
tiny JAX SD3 pipeline (random numpy weights with non-zero LoRA B) is carried
to the port with ``from_jax``. Covered: the three repaired faults (fp32 LoRA
factors, an explicit device, ``cfg_sequential``), the loss and advantages,
the optimizer against optax, the window-step replay in its three CFG modes,
one whole inner epoch against JAX ``make_train_epoch_fn``, and the train CLI.
"""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adv_grpo_torch.cli import infer as t_infer
from adv_grpo_torch.cli import train as t_train
from adv_grpo_torch.cli.common import build_pipeline, resolve_config
from adv_grpo_torch.config.base import get_config as t_base_config
from adv_grpo_torch.core import ema as t_ema
from adv_grpo_torch.core import grpo as t_grpo
from adv_grpo_torch.models import convert as t_convert
from adv_grpo_torch.models.lora import freeze_non_lora, lora_params as t_lora_params
from adv_grpo_torch.models.mmdit import MMDiT as TMMDiT
from adv_grpo_torch.models.mmdit import MMDiTConfig as TMMDiTConfig
from adv_grpo_torch.models.vae import VAEConfig as TVAEConfig
from adv_grpo_torch.rewards.registry import multi_score as t_multi_score
from adv_grpo_torch.rollout import sampler as t_sampler
from adv_grpo_torch.train import grpo_trainer as t_trainer
from adv_grpo_torch.train import train_state as t_state
from adv_grpo_torch.train.pipeline import SD3Pipeline as TSD3Pipeline
from adv_grpo_tpu.core import ema as j_ema
from adv_grpo_tpu.core import grpo as j_grpo
from adv_grpo_tpu.core.scheduler import flow_match_schedule
from adv_grpo_tpu.data.krepeat import DistributedKRepeatSampler
from adv_grpo_tpu.models.lora import lora_params as j_lora_params
from adv_grpo_tpu.rollout import sampler as j_sampler
from adv_grpo_tpu.train import grpo_trainer as j_trainer
from adv_grpo_tpu.train import train_state as j_state
from tests.test_torch_models import jax_tiny_pipeline


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _port_pipeline(jpipe, dtype=torch.float32):
    return TSD3Pipeline.from_jax(
        jpipe.transformer_params, jpipe.vae_params,
        TMMDiTConfig.tiny(lora_rank=4, lora_alpha=8.0, dtype=dtype),
        TVAEConfig.tiny(latent_channels=16), "cpu", text_seq_len=6)


@pytest.fixture(scope="module")
def pipes():
    jpipe = jax_tiny_pipeline(11)
    return jpipe, _port_pipeline(jpipe)


# ── the three repaired faults ────────────────────────────────────────────


def test_lora_factors_are_fp32_in_a_bf16_model():
    m = TMMDiT(TMMDiTConfig.tiny(lora_rank=4, dtype=torch.bfloat16), device="meta")
    sd = {k: v.dtype for k, v in m.state_dict().items()}
    assert sd["transformer_blocks.0.attn.to_q.weight"] == torch.bfloat16
    assert sd["transformer_blocks.0.attn.to_q.lora_a"] == torch.float32
    assert sd["transformer_blocks.0.attn.to_add_out.lora_b"] == torch.float32


def test_from_jax_carries_lora_without_rounding(pipes):
    jpipe, _ = pipes
    bf = _port_pipeline(jpipe, dtype=torch.bfloat16)
    want = j_lora_params(jpipe.transformer_params["params"])
    got = t_convert.lora_to_jax(bf.mmdit)
    assert set(got) == set(want) and len(got) == 4 * 8 * 2 - 2  # last block: no to_add_out
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], np.asarray(v))
    # and back: a JAX LoRA subtree written into the port, bit for bit
    moved = {k: np.asarray(v) * 2.0 for k, v in want.items()}
    t_convert.lora_from_jax(bf.mmdit, moved)
    for k, v in t_convert.lora_to_jax(bf.mmdit).items():
        np.testing.assert_array_equal(v, moved[k])


def test_no_cpu_fallback_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour when no CUDA device is visible")
    config = resolve_config("smoke_sd3_fast")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_pipeline(config)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_infer.main(["--config", "eval_sd3_fast", "--prompts", "a", "--set",
                      "smoke_test=True", "--out_dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_train.main(["--config", "smoke_sd3_fast", "--max_epochs", "1", "--set",
                      f"save_dir={tmp_path}"])


def test_sampler_config_matches_jax_fields():
    t_fields = {f.name: f.default for f in dataclasses.fields(t_sampler.SamplerConfig)}
    j_fields = {f.name: f.default for f in dataclasses.fields(j_sampler.SamplerConfig)}
    assert t_fields == j_fields and "cfg_sequential" in t_fields


# ── loss, advantages, EMA, optimizer ─────────────────────────────────────


@pytest.mark.parametrize("case", ["mixed", "tiny_diff", "kl"])
def test_grpo_loss_matches_jax(case):
    rng = np.random.default_rng(0)
    n = 16
    old = rng.standard_normal(n).astype(np.float32)
    # |lp - lp_old| ~ 1e-7 is where exp and expm1 differ; else spread around
    # the clip range
    scale = 1e-7 if case == "tiny_diff" else 2e-5
    lp = (old + rng.standard_normal(n) * scale).astype(np.float32)
    adv = (rng.standard_normal(n) * 3).astype(np.float32)
    kw = dict(clip_range=1e-5 if case != "tiny_diff" else 1e-8, adv_clip_max=5.0)
    means = {}
    if case == "kl":
        means = dict(prev_sample_mean=rng.standard_normal((n, 4, 2, 2)).astype(np.float32),
                     prev_sample_mean_ref=rng.standard_normal((n, 4, 2, 2)).astype(np.float32))
        kw["beta"] = 0.5
    want = j_grpo.grpo_loss(jnp.asarray(lp), jnp.asarray(old), jnp.asarray(adv), **kw,
                            **{k: jnp.asarray(v) for k, v in means.items()})
    got = t_grpo.grpo_loss(_t(lp), _t(old), _t(adv), **kw,
                           **{k: _t(v) for k, v in means.items()})
    for name in t_grpo.GRPOLossResult._fields:
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   rtol=1e-6, atol=1e-9, err_msg=name)
    if case != "tiny_diff":
        assert 0 < float(got.clipfrac) < 1  # both branches of the clip are taken
    else:
        assert float(got.clipfrac) > 0  # expm1 resolves a 1e-7 ratio deviation


@pytest.mark.parametrize("global_std", [False, True])
def test_group_advantages_match_jax(global_std):
    rng = np.random.default_rng(1)
    r = rng.standard_normal(12).astype(np.float32)
    ids = np.repeat(np.arange(3), 4)[rng.permutation(12)]
    want = j_grpo.group_advantages(jnp.asarray(r), jnp.asarray(ids), 3,
                                   global_std=global_std)
    got = t_grpo.group_advantages(_t(r), _t(ids).long(), 3, global_std=global_std)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_ema_decay_matches_jax():
    for step in (0, 1, 7, 100, 10_000):
        assert float(t_ema.ema_decay_at(step, 0.9)) == float(j_ema.ema_decay_at(step, 0.9))


def _train_cfg(**overrides):
    cfg = t_base_config().train
    cfg.update(overrides)
    return cfg


def test_apply_microbatch_grads_matches_optax():
    """5 gradient dicts, accumulation 2 (2 sync steps), the first pair large
    enough that the global-norm clip fires; the EMA every sync step. The same
    arithmetic in the same order: 1e-6 relative."""
    cfg = _train_cfg(gradient_accumulation_steps=1, ema=True, ema_interval=1)
    rng = np.random.default_rng(2)
    lora = {f"block_0/attn/to_{n}/lora_{c}": (rng.standard_normal((16, 4)) * 0.1)
            .astype(np.float32) for n in "qk" for c in "ab"}
    jst = j_state.create_generator_state({k: jnp.asarray(v) for k, v in lora.items()}, cfg, 2)
    params = {k: torch.nn.Parameter(_t(v.copy())) for k, v in lora.items()}
    tst = t_state.create_generator_state(params, cfg, 2)
    for i in range(5):
        g = {k: (rng.standard_normal(v.shape) * (2.0 if i < 2 else 0.01)).astype(np.float32)
             for k, v in lora.items()}
        jst = j_state.apply_microbatch_grads(jst, {k: jnp.asarray(v) for k, v in g.items()})
        t_state.apply_microbatch_grads(tst, {k: _t(v) for k, v in g.items()})
    assert (tst.global_step, tst.micro_step) == (int(jst.global_step), int(jst.micro_step))
    for k in lora:
        assert not np.array_equal(params[k].detach().numpy(), lora[k])
        np.testing.assert_allclose(params[k].detach().numpy(), np.asarray(jst.lora[k]),
                                   rtol=1e-6, atol=0)
        np.testing.assert_allclose(tst.ema[k].numpy(), np.asarray(jst.ema.params[k]),
                                   rtol=1e-6, atol=0)


# ── the replay and the inner epoch ───────────────────────────────────────


def _window_record(seed, num_mini=2, bs=2, T=2, hw=8):
    """A rollout record of the trainer's layout, (num_mini, bs, ...), with
    the schedule's timesteps and sigmas at each sample's window steps."""
    rng = np.random.default_rng(seed)
    sched = flow_match_schedule(4, shift=3.0, num_train_timesteps=1000)
    steps = rng.integers(0, 2, size=(num_mini, bs))[..., None] + np.arange(T)
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return dict(
        latents=f32(rng.standard_normal((num_mini, bs, T + 1, 16, hw, hw))),
        timesteps=f32(np.asarray(sched.timesteps)[steps]),
        sigmas=f32(np.asarray(sched.sigmas)[steps]),
        sigmas_prev=f32(np.asarray(sched.sigmas)[steps + 1]),
        advantages=f32(rng.standard_normal((num_mini, bs))),
        embeds=f32(rng.standard_normal((num_mini, bs, 6, 64)) * 0.2),
        pooled=f32(rng.standard_normal((num_mini, bs, 48)) * 0.2),
    ), f32(rng.standard_normal((bs, 6, 64)) * 0.2), f32(rng.standard_normal((bs, 48)) * 0.2)


@pytest.mark.parametrize("mode", ["batched", "sequential", "none"])
def test_compute_log_prob_matches_jax(pipes, mode):
    jpipe, tpipe = pipes
    rec, neg_e, neg_p = _window_record(3)
    cfg = dict(num_steps=4, train_num_steps=2, noise_level=0.8,
               guidance_scale=1.0 if mode == "none" else 4.5,
               cfg_sequential=mode == "sequential")
    args = [rec["latents"][0, :, 0], rec["latents"][0, :, 1], rec["timesteps"][0, :, 0],
            rec["sigmas"][0, :, 0], rec["sigmas_prev"][0, :, 0], rec["embeds"][0],
            rec["pooled"][0], neg_e, neg_p]
    want = j_sampler.compute_log_prob(jpipe.velocity_fn(jpipe.transformer_params),
                                      *map(jnp.asarray, args), j_sampler.SamplerConfig(**cfg))
    with torch.no_grad():
        got = t_sampler.compute_log_prob(tpipe.velocity_fn(), *map(_t, args),
                                         t_sampler.SamplerConfig(**cfg))
    for g, w in zip(got, want):  # log_prob, prev_sample_mean, std_dev_t
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)


def test_train_epoch_matches_jax():
    """One inner epoch, 2 minibatches x 2 window steps = 4 microbatches,
    accumulation 2: both packages from the same LoRA, the same record and
    advantages. Old log-probs are the replayed ones moved by ~1e-3 around the
    1e-3 clip range, so both branches of the clip are live.

    Tolerances (fp32): the diagnostics to 1e-4 relative (4-layer forward and
    backward, sums reordered); LoRA and EMA to 1e-4 relative plus 2e-6
    absolute — Adam divides each gradient element by its own magnitude, so a
    difference d in an element g moves the update by up to lr * d / (|g| +
    eps) = 3e-4 * 1e-9 / 1e-8 for the smallest elements."""
    jpipe = jax_tiny_pipeline(13)
    tpipe = _port_pipeline(jpipe)
    cfg = _train_cfg(gradient_accumulation_steps=1, ema=True, ema_interval=1,
                     clip_range=1e-3)
    scfg = dict(num_steps=4, train_num_steps=2, noise_level=0.8, guidance_scale=4.5)
    rec, neg_e, neg_p = _window_record(4)

    # old log-probs: the replay under the starting weights, moved by ~1e-3
    with torch.no_grad():
        lp0 = torch.stack([torch.stack([t_sampler.compute_log_prob(
            tpipe.velocity_fn(), _t(rec["latents"][i, :, j]), _t(rec["latents"][i, :, j + 1]),
            _t(rec["timesteps"][i, :, j]), _t(rec["sigmas"][i, :, j]),
            _t(rec["sigmas_prev"][i, :, j]), _t(rec["embeds"][i]), _t(rec["pooled"][i]),
            _t(neg_e), _t(neg_p), t_sampler.SamplerConfig(**scfg))[0]
            for j in range(2)], dim=1) for i in range(2)])
    rng = np.random.default_rng(5)
    rec["log_probs"] = (lp0.numpy() + rng.standard_normal(lp0.shape) * 1e-3).astype(np.float32)

    jlora0 = j_lora_params(jpipe.transformer_params["params"])
    jst = j_state.create_generator_state(jlora0, cfg, 2)
    jfn = j_trainer.make_train_epoch_fn(jpipe, j_sampler.SamplerConfig(**scfg), cfg)
    jst, jinfo = jfn(jst, jpipe.transformer_params, {k: jnp.asarray(v) for k, v in rec.items()},
                     jnp.asarray(neg_e), jnp.asarray(neg_p))

    lora = freeze_non_lora(tpipe.mmdit)
    tst = t_state.create_generator_state(lora, cfg, 2)
    tfn = t_trainer.make_train_epoch_fn(tpipe, t_sampler.SamplerConfig(**scfg), cfg)
    tst, tinfo = tfn(tst, {k: _t(v) for k, v in rec.items()}, _t(neg_e), _t(neg_p))

    assert tst.global_step == int(jst.global_step) == 2
    assert 0 < tinfo["clipfrac"] < 1
    for k in ("loss", "policy_loss", "approx_kl", "clipfrac", "clipfrac_gt_one",
              "clipfrac_lt_one"):
        np.testing.assert_allclose(tinfo[k], float(jinfo[k]), rtol=1e-4, atol=1e-9,
                                   err_msg=k)
    moved = 0
    for k, p in t_lora_params(tpipe.mmdit).items():
        want = np.asarray(jst.lora[k])
        moved += not np.array_equal(want, np.asarray(jlora0[k]))
        np.testing.assert_allclose(p.detach().numpy(), want, rtol=1e-4, atol=2e-6, err_msg=k)
        np.testing.assert_allclose(tst.ema[k].numpy(), np.asarray(jst.ema.params[k]),
                                   rtol=1e-4, atol=2e-6, err_msg=k)
    assert moved == len(jlora0)


# ── the trainer and its CLI ──────────────────────────────────────────────


def test_train_cli_runs_two_epochs_on_the_cpu(tmp_path):
    argv = ["--config", "smoke_sd3_fast", "--set", "sample.train_batch_size=2",
            "--max_epochs", "2", "--device", "cpu", "--latent_hw", "8",
            "--set", f"save_dir={tmp_path}", "--set", "train.ema_interval=2"]
    trainer = t_train.main(argv)
    lines = (tmp_path / "metrics.jsonl").read_text().splitlines()
    assert len(lines) == 2
    for rec in map(json.loads, lines):
        for k in ("reward_avg", "loss", "approx_kl", "clipfrac"):
            assert np.isfinite(rec[k]), (k, rec[k])
    # 2 epochs x 2 minibatches x 2 window steps, accumulation 2 -> 4 steps
    assert trainer.state.global_step == 4
    start = t_train.build_trainer(trainer.config, latent_hw=8, device="cpu")
    unchanged = [k for k, p in trainer.state.lora.items() if torch.equal(p, start.state.lora[k])]
    # the last block's text query feeds only the text output, which that block
    # drops: its B factor starts at 0 and gets no gradient (nor weight decay)
    assert unchanged == ["block_1/attn/add_q_proj/lora_b"]
    assert any(not torch.equal(e, start.state.lora[k]) for k, e in trainer.state.ema.items())
    assert (tmp_path / "samples_epoch_00000.jpg").exists()
    # eval on the EMA weights puts the live LoRA back afterwards
    live = {k: p.detach().clone() for k, p in trainer.state.lora.items()}
    images, metrics = trainer.eval_phase(["a cat", "a dog"])
    assert images.shape == (2, 3, 16, 16) and np.isfinite(metrics["eval_reward_avg"])
    assert all(torch.equal(p, live[k]) for k, p in trainer.state.lora.items())


def test_krepeat_refuses_one_slot_on_one_device():
    """train_batch_size=1 on one device cannot hold the preset's k = 2 repeats:
    both packages' samplers raise."""
    with pytest.raises(ValueError, match="divisible"):
        DistributedKRepeatSampler(8, batch_size=1, k=2, num_replicas=1, rank=0)
    cfg = resolve_config("smoke_sd3_fast")
    cfg.sample.train_batch_size = 1
    with pytest.raises(ValueError, match="divisible"):
        t_train.build_trainer(cfg, latent_hw=8, device="cpu")


def test_device_rewards_raise_with_their_name():
    """Every reward of the JAX registry is ported; an unknown name raises
    KeyError naming itself and listing the known ones, as in the JAX
    package (tests/test_torch_rewards_rest.py holds the lists equal)."""
    with pytest.raises(KeyError, match="unknown reward 'siglip_cotrain2'.*'siglip_cotrain'"):
        t_multi_score({"jpeg_compressibility": 1, "siglip_cotrain2": 1})
    t_multi_score({"jpeg_compressibility": 1, "pickscore": 1, "dino_cotrain": 1,
                   "siglip_cotrain": 1, "discriminator": 1, "geneval": 1})
    fn = t_multi_score({"jpeg_compressibility": 1})
    images = torch.rand(2, 3, 16, 16) * 2 - 1
    details, _ = fn(images, ["a", "b"])
    np.testing.assert_array_equal(details["avg"], details["jpeg_compressibility"])


def test_rebatch_and_advantages_match_jax():
    x = np.arange(30, dtype=np.float32).reshape(10, 3)
    got = t_trainer.rebatch_for_training({"x": _t(x)}, 3)["x"].numpy()
    np.testing.assert_array_equal(got, j_trainer.rebatch_for_training({"x": x}, 3)["x"])
    from adv_grpo_tpu.core.stat_tracking import PerPromptStatTracker

    ids = np.array([0, 0, 1, 1, 2, 2])
    r = np.array([1.0, 2.0, 0.5, 0.5, 3.0, -1.0], np.float32)
    a, sa = t_trainer.compute_advantages(PerPromptStatTracker(), ids, r)
    b, sb = j_trainer.compute_advantages(PerPromptStatTracker(), ids, r)
    np.testing.assert_array_equal(a, b)
    assert sa == sb

