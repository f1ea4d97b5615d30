"""Parity of the port's MMDiT and VAE decoder with the JAX models.

The JAX package's tiny SD3 pipeline gets random numpy parameters in its own
tree structure (non-zero biases and LoRA B, so every mapping matters),
``adv_grpo_torch.models.convert`` turns them into the port's state dicts, and
both forwards run on the same numpy inputs in fp32 on the CPU (the JAX ops on
their reference path, the port's on its plain path).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adv_grpo_torch.models.mmdit import MMDiTConfig as TMMDiTConfig
from adv_grpo_torch.models.vae import VAEConfig as TVAEConfig
from adv_grpo_torch.train.pipeline import SD3Pipeline as TSD3Pipeline
from adv_grpo_tpu.models.mmdit import MMDiT, MMDiTConfig
from adv_grpo_tpu.models.vae import AutoencoderKL, VAEConfig
from adv_grpo_tpu.train.pipeline import SD3Pipeline

# fp32 end to end; 4 transformer layers (or the VAE's conv stack) of
# reordered sums stay well inside this
ATOL = RTOL = 1e-4


def _leaf(path, shape, rng):
    name = str(path[-1].key)
    if name == "kernel":  # lecun-normal scale, fan_in = all but the last axis
        return rng.standard_normal(shape) * np.prod(shape[:-1]) ** -0.5
    if name == "lora_a":
        return rng.standard_normal(shape) / shape[-1]
    if name in ("bias", "lora_b"):  # non-zero, so the mapping of both is tested
        return rng.standard_normal(shape) * 0.05
    return 1.0 + 0.1 * rng.standard_normal(shape)  # RMS / GroupNorm scales


def jax_tiny_pipeline(seed, lora_rank=4, lora_alpha=8.0):
    """The JAX tiny SD3 pipeline with random numpy parameters of the model's
    own tree structure (``jax.eval_shape`` of ``init``: no init compile)."""
    cfg = MMDiTConfig.tiny(lora_rank=lora_rank, lora_alpha=lora_alpha)
    vcfg = VAEConfig.tiny(latent_channels=16)
    mmdit, vae = MMDiT(cfg), AutoencoderKL(vcfg)
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(mmdit.init, key, jnp.zeros((1, 16, 8, 8)), jnp.zeros((1,)),
                            jnp.zeros((1, 6, 64)), jnp.zeros((1, 48)))
    vshapes = jax.eval_shape(vae.init, key, jnp.zeros((1, 3, 16, 16)))
    rng = np.random.default_rng(seed)
    fill = lambda tree: jax.tree_util.tree_map_with_path(  # noqa: E731
        lambda path, s: _leaf(path, s.shape, rng).astype(np.float32), tree)
    return SD3Pipeline(cfg, vcfg, mmdit, vae, fill(shapes), fill(vshapes),
                       text_seq_len=6)


@pytest.fixture(scope="module")
def pipes():
    jpipe = jax_tiny_pipeline(0)
    tpipe = TSD3Pipeline.from_jax(
        jpipe.transformer_params, jpipe.vae_params,
        TMMDiTConfig.tiny(lora_rank=4, lora_alpha=8.0),
        TVAEConfig.tiny(latent_channels=16), "cpu", text_seq_len=6)
    return jpipe, tpipe


@pytest.mark.parametrize("lora_scale", [1.0, 0.0])
def test_mmdit_forward_matches_jax(pipes, lora_scale):
    jpipe, tpipe = pipes
    rng = np.random.default_rng(1)
    lat = rng.standard_normal((2, 16, 8, 8)).astype(np.float32)
    t = np.array([1000.0, 312.5], np.float32)
    ctx = (rng.standard_normal((2, 6, 64)) * 0.2).astype(np.float32)
    pooled = (rng.standard_normal((2, 48)) * 0.2).astype(np.float32)
    want = jpipe.velocity_fn(jpipe.transformer_params, lora_scale)(lat, t, ctx, pooled)
    with torch.no_grad():
        got = tpipe.velocity_fn(lora_scale)(*(torch.from_numpy(a)
                                              for a in (lat, t, ctx, pooled)))
    assert got.shape == (2, 16, 8, 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_lora_changes_the_output(pipes):
    """Guard for the parity above: with non-zero B the adapters are live."""
    _, tpipe = pipes
    args = (torch.randn(1, 16, 8, 8), torch.tensor([500.0]), torch.randn(1, 6, 64),
            torch.randn(1, 48))
    with torch.no_grad():
        on, off = tpipe.velocity_fn(1.0)(*args), tpipe.velocity_fn(0.0)(*args)
    assert (on - off).abs().max() > 1e-3


def test_vae_decode_matches_jax(pipes):
    jpipe, tpipe = pipes
    z = np.random.default_rng(2).standard_normal((2, 16, 8, 8)).astype(np.float32)
    want = jpipe.decode(z)
    with torch.no_grad():
        got = tpipe.decode(torch.from_numpy(z))
    assert got.shape == (2, 3, 16, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_random_init_is_seeded_and_finite():
    cfg = TMMDiTConfig.tiny(lora_rank=4)
    make = lambda seed: TSD3Pipeline.random_init(  # noqa: E731
        torch.Generator().manual_seed(seed), cfg, TVAEConfig.tiny(latent_channels=16),
        "cpu", text_seq_len=6)
    a, b, c = make(0), make(0), make(1)
    sa, sb, sc = (p.mmdit.state_dict() for p in (a, b, c))
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert any(not torch.equal(sa[k], sc[k]) for k in sa)
    assert all(torch.isfinite(v).all() for v in sa.values())
    # qk-norm weights stay fp32 whatever the compute dtype
    bf = TSD3Pipeline.random_init(torch.Generator().manual_seed(0), cfg,
                                  TVAEConfig.tiny(latent_channels=16), "cpu",
                                  dtype=torch.bfloat16, text_seq_len=6)
    dtypes = {k: v.dtype for k, v in bf.mmdit.state_dict().items()}
    assert dtypes["transformer_blocks.0.attn.norm_q.weight"] == torch.float32
    assert dtypes["transformer_blocks.0.attn.to_q.weight"] == torch.bfloat16
