"""The port's WAN VAE encoder (``WanVideoVAE.encode_raw`` / ``encode``,
``WanDownsample``) against the JAX package, on the CPU in fp32.

The JAX VAE gets random numpy parameters in its own tree (non-zero biases,
gammas near 1), ``wan_vae_state_dict_from_jax`` carries encoder and decoder
to the port, and both encode the same clips: 1, 2, 3, 5 and 9 frames (the
temporal downsample's frame-0 bypass and its windows 2j-2..2j; under 3
frames it has none and frame 0 alone comes out), non-square, with and
without attention blocks, the latent statistics non-trivial. Bound 1e-4: a
conv stack of fp32 sums in another order. The posterior sample draws from a
``torch.Generator`` (the JAX package from a key: the same distribution,
other bits), so it is held to its formula on the port's own draws. The
encoder is registered after the decoder, so a seeded ``init_params_`` draws
the decoder's bits as it did before the encoder existed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from adv_grpo_torch.models.convert import wan_vae_state_dict_from_jax
from adv_grpo_torch.models.lora import init_params_
from adv_grpo_torch.models.wan_vae import WanCausalConv3d, WanDecoder3d
from adv_grpo_torch.models.wan_vae import WanVAEConfig as TWanVAEConfig
from adv_grpo_torch.models.wan_vae import WanVideoVAE as TWanVideoVAE
from adv_grpo_tpu.models.wan_vae import WanVAEConfig as JWanVAEConfig
from adv_grpo_tpu.models.wan_vae import WanVideoVAE as JWanVideoVAE
from tests.test_torch_wan import jax_wan_vae_params

ATOL = RTOL = 1e-4
STATS = dict(latents_mean=(0.1, -0.2, 0.0, 0.3), latents_std=(1.5, 0.5, 1.0, 2.0))
GEOMETRIES = {
    "t3d": dict(),  # one temporal downsample stage
    # a spatial-only stage, then a temporal one; attention in every stage
    "mixed_attn": dict(dim_mult=(1, 2, 2), temperal_downsample=(False, True),
                       attn_scales=(0.5, 1.0)),
    # two temporal stages (the 4x of Wan2.1), one res block each
    "t4x": dict(dim_mult=(1, 2, 2), temperal_downsample=(True, True)),
}


def _pair(geometry, seed=4):
    kw = dict(GEOMETRIES[geometry], **STATS)
    jcfg, tcfg = JWanVAEConfig.tiny(**kw), TWanVAEConfig.tiny(**kw)
    params = jax_wan_vae_params(jcfg, seed)
    vae = TWanVideoVAE(tcfg, device="cpu")
    vae.load_state_dict(wan_vae_state_dict_from_jax(params, tcfg))
    return jcfg, params, vae


def _clip(frames, h, w, seed=1):
    return np.random.default_rng(seed).uniform(-1, 1, (2, 3, frames, h, w)).astype(np.float32)


@pytest.mark.parametrize("frames", [1, 2, 3, 5, 9])
@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_encode_matches_jax(geometry, frames):
    """``encode_raw`` (mean and clipped logvar, checkpoint space) and
    ``encode`` (normalised, no noise) against the JAX VAE on a non-square
    clip."""
    jcfg, params, vae = _pair(geometry)
    sf = jcfg.spatial_factor
    vid = _clip(frames, 2 * sf, 3 * sf)
    jvae = JWanVideoVAE(jcfg)
    jmean, jlogvar = jvae.apply(params, jnp.asarray(vid), method=jvae.encode_raw)
    jz = jvae.apply(params, jnp.asarray(vid), method=jvae.encode)
    with torch.no_grad():
        mean, logvar = vae.encode_raw(torch.from_numpy(vid))
        z = vae.encode(torch.from_numpy(vid))
    assert mean.shape == jmean.shape
    if (frames - 1) % jcfg.temporal_factor == 0:
        assert mean.shape == (2, jcfg.z_dim, jcfg.latent_frames(frames), 2, 3)
    assert mean.dtype == logvar.dtype == z.dtype == torch.float32
    for got, want in ((mean, jmean), (logvar, jlogvar), (z, jz)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("geometry", ["t3d", "t4x"])
def test_round_trip_matches_jax(geometry):
    """decode(encode(x)), the JAX ``WanVideoVAE.__call__`` without a key,
    on 5 square frames."""
    jcfg, params, vae = _pair(geometry, seed=6)
    sf = jcfg.spatial_factor
    vid = _clip(5, 2 * sf, 2 * sf, seed=3)
    want = JWanVideoVAE(jcfg).apply(params, jnp.asarray(vid))
    with torch.no_grad():
        got = vae.decode(vae.encode(torch.from_numpy(vid)))
    assert got.shape == vid.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_logvar_is_clipped():
    """A quant conv biased far out puts logvar at the clip, -30 and 20 (the
    JAX ``jnp.clip``)."""
    jcfg, params, vae = _pair("t3d")
    with torch.no_grad():
        vae.quant_conv.bias[jcfg.z_dim:] = torch.tensor([1e3, -1e3, 1e3, -1e3])
        _, logvar = vae.encode_raw(torch.from_numpy(_clip(1, 4, 4)))
    assert torch.equal(logvar[:, 0::2], torch.full_like(logvar[:, 0::2], 20.0))
    assert torch.equal(logvar[:, 1::2], torch.full_like(logvar[:, 1::2], -30.0))


def test_encode_samples_from_the_generator():
    """``encode(x, generator)``: (mean + exp(logvar / 2) * N(0, 1) - mu) /
    sigma, the noise the generator's; the same seed gives the same latents,
    another seed others."""
    _, _, vae = _pair("t3d")
    vid = torch.from_numpy(_clip(5, 8, 8))
    with torch.no_grad():
        mean, logvar = vae.encode_raw(vid)
        z = vae.encode(vid, torch.Generator().manual_seed(3))
        noise = torch.randn(mean.shape, generator=torch.Generator().manual_seed(3))
        again = vae.encode(vid, torch.Generator().manual_seed(3))
        other = vae.encode(vid, torch.Generator().manual_seed(4))
    mu = torch.tensor(STATS["latents_mean"]).reshape(1, -1, 1, 1, 1)
    std = torch.tensor(STATS["latents_std"]).reshape(1, -1, 1, 1, 1)
    torch.testing.assert_close(z, (mean + torch.exp(0.5 * logvar) * noise - mu) / std,
                               rtol=0, atol=0)
    assert torch.equal(z, again) and not torch.equal(z, other)


class _DecoderOnly(nn.Module):
    """The VAE as it was registered before the encoder: post_quant_conv,
    then the decoder."""

    def __init__(self, cfg):
        super().__init__()
        self.post_quant_conv = WanCausalConv3d(cfg.z_dim, cfg.z_dim, 1, cfg)
        self.decoder = WanDecoder3d(cfg)


@pytest.mark.parametrize("geometry", ["t3d", "mixed_attn"])
def test_random_init_keeps_the_decoders_bits(geometry):
    """``init_params_`` over the whole VAE from a seed gives the decoder the
    bits it gets without the encoder (registered after it); the encoder's
    draws follow and are not zero."""
    cfg = TWanVAEConfig.tiny(**GEOMETRIES[geometry])
    whole = init_params_(TWanVideoVAE(cfg), torch.Generator().manual_seed(0))
    alone = init_params_(_DecoderOnly(cfg), torch.Generator().manual_seed(0))
    got = whole.state_dict()
    for k, v in alone.state_dict().items():
        assert torch.equal(got[k], v), k
    assert whole.encoder.conv_in.weight.abs().sum() > 0
