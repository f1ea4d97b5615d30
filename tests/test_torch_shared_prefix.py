"""The port's group-shared prefix (``sample.same_latent`` on SD3) against the
JAX package, on the CPU.

The tiny JAX SD3 pipeline (random numpy weights, non-zero LoRA B) is carried
to the port with ``from_jax``; latents and embeddings are numpy draws from a
seed; fp32 throughout. Covered: ``denoise_prefix`` at window starts 0-3 with
CFG on and off; ``denoise_with_logprob(start_idx)`` at noise 0 (the skipped
steps pass x through at log-prob 0 and draw no noise); the shared-prefix
sampler against the plain ``same_latent`` sampler at noise 0, and its window
replay; a ``same_latent`` trainer epoch through the shared prefix; and
``rollout_flops`` with a prefix.

Bounds: 1e-4 absolute and relative for the 4-layer model over up to 4 steps
at two batch sizes (fp32 sums in another order), 1e-6 for the replay
identity.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adv_grpo_torch.cli import train as t_train
from adv_grpo_torch.cli.common import apply_overrides, resolve_config
from adv_grpo_torch.core.sde import cps_step_with_logprob as t_cps
from adv_grpo_torch.models.mmdit import MMDiTConfig as TMMDiTConfig
from adv_grpo_torch.models.vae import VAEConfig as TVAEConfig
from adv_grpo_torch.rollout import sampler as t_sampler
from adv_grpo_torch.train import grpo_trainer as t_trainer
from adv_grpo_torch.train.pipeline import SD3Pipeline as TSD3Pipeline
from adv_grpo_torch.utils import flops as t_flops
from adv_grpo_torch.utils.metrics import SPANS
from adv_grpo_tpu.models.mmdit import MMDiTConfig as JMMDiTConfig
from adv_grpo_tpu.rollout import sampler as j_sampler
from adv_grpo_tpu.utils import flops as j_flops
from tests.test_torch_models import jax_tiny_pipeline

TOL = 1e-4


@pytest.fixture(scope="module")
def pipes():
    jpipe = jax_tiny_pipeline(17)
    tpipe = TSD3Pipeline.from_jax(
        jpipe.transformer_params, jpipe.vae_params,
        TMMDiTConfig.tiny(lora_rank=4, lora_alpha=8.0),
        TVAEConfig.tiny(latent_channels=16), "cpu", text_seq_len=6)
    return jpipe, tpipe


def _inputs(seed, b=2):
    rng = np.random.default_rng(seed)
    lat = rng.standard_normal((b, 16, 8, 8)).astype(np.float32)
    emb = [(rng.standard_normal((b, 6, 64)) * 0.2).astype(np.float32) for _ in range(2)]
    pool = [(rng.standard_normal((b, 48)) * 0.2).astype(np.float32) for _ in range(2)]
    return lat, emb[0], pool[0], emb[1], pool[1]


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("guidance", [4.5, 1.0])
@pytest.mark.parametrize("rt", [0, 1, 2, 3])
def test_denoise_prefix_matches_jax(pipes, rt, guidance):
    jpipe, tpipe = pipes
    args = _inputs(rt)
    cfg = dict(num_steps=4, train_num_steps=2, noise_level=0.8, guidance_scale=guidance)
    want = j_sampler.denoise_prefix(jpipe.velocity_fn(jpipe.transformer_params),
                                    *map(jnp.asarray, args), j_sampler.SamplerConfig(**cfg), rt)
    with torch.no_grad():
        got = t_sampler.denoise_prefix(tpipe.velocity_fn(), *map(_t, args),
                                       t_sampler.SamplerConfig(**cfg), rt)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    if rt == 0:
        np.testing.assert_array_equal(got.numpy(), args[0])


@pytest.mark.parametrize("start_idx,rt", [(2, 2), (1, 3), (3, 0)])
def test_start_idx_matches_jax_at_noise_0(pipes, start_idx, rt):
    """Noise level 0: the port's rollout from ``start_idx`` equals JAX's; the
    window gathers by step, so a window over skipped steps records x passed
    through at log-prob 0."""
    jpipe, tpipe = pipes
    args = _inputs(10 + start_idx)
    cfg = dict(num_steps=5, train_num_steps=2, noise_level=0.0, guidance_scale=4.5)
    want = j_sampler.denoise_with_logprob(
        jpipe.velocity_fn(jpipe.transformer_params), *map(jnp.asarray, args),
        jax.random.PRNGKey(0), j_sampler.SamplerConfig(**cfg), random_timestep=rt,
        start_idx=start_idx)
    with torch.no_grad():
        got = t_sampler.denoise_with_logprob(
            tpipe.velocity_fn(), *map(_t, args), torch.Generator().manual_seed(0),
            t_sampler.SamplerConfig(**cfg), random_timestep=rt, start_idx=start_idx)
    for name in ("final_latents", "latents", "log_probs", "timesteps", "sigmas",
                 "sigmas_prev"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   rtol=TOL, atol=TOL, err_msg=name)
    for j in range(2):
        if rt + j < start_idx:  # a skipped step
            np.testing.assert_array_equal(got.latents[:, j + 1].numpy(),
                                          got.latents[:, j].numpy())
            assert (got.log_probs[:, j] == 0).all()


def test_skipped_steps_draw_no_noise():
    """Like the JAX ``skip_step``, which splits no key: the steps before
    ``start_idx`` leave the generator where it was, and the model is called
    for the others only."""
    calls = []

    def velocity(x, t, e, p):
        calls.append(float(t[0]))
        return -0.5 * x

    cfg = t_sampler.SamplerConfig(num_steps=5, train_num_steps=2, noise_level=0.7,
                                  guidance_scale=1.0)
    x = torch.randn(2, 4, 4, 4, generator=torch.Generator().manual_seed(1))
    g = torch.Generator().manual_seed(3)
    t_sampler.denoise_with_logprob(velocity, x, None, None, None, None, g, cfg,
                                   random_timestep=2, start_idx=2)
    ref = torch.Generator().manual_seed(3)
    for _ in range(3):  # the three steps that ran
        torch.randn(x.shape, generator=ref)
    assert torch.equal(g.get_state(), ref.get_state())
    assert len(calls) == 3


def _group_inputs(tcfg, b=4, group=2, seed=7):
    """Embeddings in the driver's layout: each slot's repeated across its
    group."""
    rng = np.random.default_rng(seed)
    emb = np.repeat(rng.standard_normal((b // group, 6, tcfg.joint_attention_dim)) * 0.1,
                    group, axis=0).astype(np.float32)
    pool = np.repeat(rng.standard_normal((b // group, tcfg.pooled_projection_dim)) * 0.1,
                     group, axis=0).astype(np.float32)
    neg = np.zeros_like(emb), np.zeros_like(pool)
    return [_t(a) for a in (emb, pool) + neg]


@pytest.mark.parametrize("guidance", [4.5, 1.0])
@pytest.mark.parametrize("rt", [0, 2])
def test_shared_prefix_equals_plain_same_latent_at_noise_0(pipes, rt, guidance):
    """The twin of tests/test_rollout.py's shared-prefix test: at noise 0 the
    shared prefix and the plain ``same_latent`` sampler are the same map
    from the same initial latents (both draw them first from the
    generator)."""
    _, tpipe = pipes
    cfg = t_sampler.SamplerConfig(num_steps=4, train_num_steps=2, noise_level=0.0,
                                  guidance_scale=guidance)
    emb, pool, neg_e, neg_p = _group_inputs(tpipe.mmdit_cfg)
    plain = t_trainer.make_sample_fn(tpipe, cfg, 8, same_latent=True, group_size=2)
    shared = t_trainer.make_shared_prefix_sample_fn(tpipe, cfg, 8, group_size=2)
    out_p, img_p = plain(emb, pool, neg_e, neg_p, torch.Generator().manual_seed(3),
                         torch.full((4,), rt))
    out_s, img_s = shared(emb, pool, neg_e, neg_p, torch.Generator().manual_seed(3), rt)
    for name in ("final_latents", "latents", "log_probs", "timesteps", "sigmas"):
        np.testing.assert_allclose(getattr(out_s, name).numpy(), getattr(out_p, name).numpy(),
                                   rtol=TOL, atol=TOL, err_msg=name)
    np.testing.assert_allclose(img_s.numpy(), img_p.numpy(), rtol=TOL, atol=TOL)
    # a group shares its initial latent; the groups differ
    lat0 = out_s.latents[:, 0] if rt == 0 else out_p.latents[:, 0]
    assert torch.equal(lat0[0], lat0[1]) and not torch.equal(lat0[0], lat0[2])


def test_same_latent_off_draws_independent_latents(pipes):
    _, tpipe = pipes
    cfg = t_sampler.SamplerConfig(num_steps=2, train_num_steps=1, noise_level=0.7,
                                  guidance_scale=1.0)
    emb, pool, neg_e, neg_p = _group_inputs(tpipe.mmdit_cfg)
    for same, shared in ((True, True), (False, False)):
        fn = t_trainer.make_sample_fn(tpipe, cfg, 8, same_latent=same, group_size=2)
        out, _ = fn(emb, pool, neg_e, neg_p, torch.Generator().manual_seed(0),
                    torch.zeros(4, dtype=torch.long))
        assert torch.equal(out.latents[0, 0], out.latents[1, 0]) == shared


def test_shared_prefix_window_replays(pipes):
    """A stochastic shared-prefix rollout: each recorded window transition
    re-scored through the CPS step gives its recorded log-prob."""
    _, tpipe = pipes
    cfg = t_sampler.SamplerConfig(num_steps=4, train_num_steps=2, noise_level=0.7,
                                  guidance_scale=1.0)
    emb, pool, neg_e, neg_p = _group_inputs(tpipe.mmdit_cfg)
    shared = t_trainer.make_shared_prefix_sample_fn(tpipe, cfg, 8, group_size=2)
    out, _ = shared(emb, pool, neg_e, neg_p, torch.Generator().manual_seed(5), 1)
    fn = tpipe.velocity_fn()
    with torch.no_grad():
        for j in range(2):
            v = fn(out.latents[:, j], out.timesteps[:, j], emb, pool)
            rep = t_cps(v, out.latents[:, j], out.sigmas[:, j], out.sigmas_prev[:, j],
                        cfg.noise_level, prev_sample=out.latents[:, j + 1])
            torch.testing.assert_close(rep.log_prob, out.log_probs[:, j], rtol=1e-6,
                                       atol=1e-6)
    assert (out.log_probs < 0).all()
    # the members of a group left the prefix as one latent and split in the window
    assert torch.equal(out.latents[0, 0], out.latents[1, 0])
    assert not torch.equal(out.latents[0, 1], out.latents[1, 1])


def test_same_latent_epoch_takes_the_shared_prefix():
    """The twin of tests/test_trainer_e2e.py's shared-prefix epoch: the
    trainer routes ``same_latent`` through the shared prefix, hands it one
    int window start, records the prefix's denoising at one row a prompt slot
    and the window's at the whole batch, and trains (2 minibatches x 2
    window steps)."""
    config = apply_overrides(resolve_config("smoke_sd3_fast"), [
        "sample.train_batch_size=2", "sample.same_latent=True", "save_dir="])
    trainer = t_train.build_trainer(config, latent_hw=8, device="cpu")
    assert trainer.shared_prefix and trainer.mini == 2
    starts, sample_fn = [], trainer.sample_fn

    def recording(*args):
        starts.append(args[-1])
        return sample_fn(*args)

    trainer.sample_fn = recording
    before = max((s.id for s in SPANS.spans()), default=0)
    samples = trainer.sample_phase(0)
    assert all(type(rt) is int for rt in starts) and len(starts) == trainer.num_batches
    assert starts == [trainer.window_start(i) for i in range(trainer.num_batches)]
    b = samples["embeds"].shape[0] // trainer.num_batches
    denoise = [s for s in SPANS.spans() if s.id > before and s.name == "denoise"]
    assert [s.rows for s in denoise] == [b // 2, b] * trainer.num_batches
    assert all(s.dev_s == s.t1 - s.t0 for s in denoise)  # on the CPU: the host's time
    trainer.run(max_epochs=1)
    assert trainer.state.micro_step == 2 * 2
    # groups of one keep the plain sampler
    single = t_train.build_trainer(apply_overrides(config, ["sample.mini_num_image_per_prompt=1",
                                                            "sample.num_image_per_prompt=2"]),
                                   latent_hw=8, device="cpu")
    assert not single.shared_prefix


@pytest.mark.parametrize("prefix_steps,group", [(0, 1), (0, 8), (3, 1), (3, 8), (5, 4)])
@pytest.mark.parametrize("do_cfg", [True, False])
def test_rollout_flops_match_jax(prefix_steps, group, do_cfg):
    kw = dict(prefix_steps=prefix_steps, group_size=group)
    got = t_flops.rollout_flops(TMMDiTConfig.sd35_medium(), 1024, 154, 8, 10, do_cfg, **kw)
    want = j_flops.rollout_flops(JMMDiTConfig.sd35_medium(), 1024, 154, 8, 10, do_cfg, **kw)
    assert got == want
