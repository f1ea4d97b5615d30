"""The port's WAN slice at Wan2.1's published frame counts, on the CPU in
fp32, against the JAX package:

* ``WanVideoVAE.decode`` run over chunks of latent frames (each causal conv
  carrying its last two input frames to the next chunk) against the JAX
  whole-sequence decode, at every chunk length, on a tiny VAE with two
  temporal upsamples as Wan2.1 has and a non-square 3 x 5 latent grid.
  Bound: relative L2 1e-5 (fp32 conv stacks summing in other orders);
* the chunk ``WanDecoder3d.chunk_frames`` takes at Wan2.1's grids (33 and 81
  frames of 480^2, 81 of 480x832), on the meta device: every intermediate
  of a chunk under 2^31 elements, one chunk at 33 frames;
* the deterministic rollout with the per-step KL and its decode at 4 latent
  frames of a non-square grid, decoded whole and one latent frame at a time
  (the tolerance of tests/test_torch_wan.py's rollout test, 1e-4);
* ``build_pipeline``'s grid at 81 frames;
* ``chip_smoke.py``'s query-blocked plain attention (#8's plain version and
  #9's plain twin a block of query rows at a time, as the card runs them at
  32,760 tokens) against the whole plain call.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from adv_grpo_torch.cli.common import (_wan_grid, apply_overrides, build_pipeline,
                                         resolve_config)
from adv_grpo_torch.models.wan import WanConfig as TWanConfig
from adv_grpo_torch.models.wan_vae import WanDecoder3d
from adv_grpo_torch.models.wan_vae import WanVAEConfig as TWanVAEConfig
from adv_grpo_torch.ops import attention
from adv_grpo_torch.rollout import wan as t_rollout
from adv_grpo_torch.train.wan_pipeline import WanPipeline as TWanPipeline
from adv_grpo_tpu.models.wan import WanConfig as JWanConfig
from adv_grpo_tpu.models.wan import WanTransformer as JWanTransformer
from adv_grpo_tpu.models.wan_vae import WanVAEConfig as JWanVAEConfig
from adv_grpo_tpu.models.wan_vae import WanVideoVAE as JWanVideoVAE
from adv_grpo_tpu.rollout import wan as j_rollout
from adv_grpo_tpu.train.wan_pipeline import WanPipeline as JWanPipeline
from tests.test_torch_wan import ATOL, RTOL, _t, _vae_pair, jax_wan_params, jax_wan_vae_params

DECODE_REL_L2 = 1e-5
# Wan2.1's two temporal upsamples (4x in time), 4x spatial, non-zero stats
TWO_UP = dict(dim_mult=(1, 2, 2), temperal_downsample=(True, True),
              latents_mean=(0.1, -0.2, 0.0, 0.3), latents_std=(1.5, 0.5, 1.0, 2.0))


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.fixture(scope="module")
def vae_pair():
    jvcfg, vparams, _, vae = _vae_pair(8, **TWO_UP)
    return JWanVideoVAE(jvcfg), vparams, vae


@pytest.mark.parametrize("frames,chunk", [(5, c) for c in range(1, 6)]
                         + [(6, c) for c in range(1, 7)])
def test_chunked_decode_matches_jax_whole_sequence(vae_pair, monkeypatch, frames, chunk):
    """``decode`` in chunks of ``chunk`` latent frames (the last one shorter
    where ``chunk`` does not divide ``frames``) against the JAX
    whole-sequence decode: 1 + 4 (frames - 1) video frames of 12 x 20."""
    jvae, vparams, vae = vae_pair
    lat = np.random.default_rng(frames).standard_normal((1, 4, frames, 3, 5)).astype(np.float32)
    want = np.asarray(jvae.apply(vparams, jnp.asarray(lat), method=jvae.decode))
    monkeypatch.setattr(vae.decoder, "chunk_frames", lambda shape: chunk)
    with torch.no_grad():
        got = vae.decode(_t(lat)).numpy()
    assert got.shape == want.shape == (1, 3, 1 + 4 * (frames - 1), 12, 20)
    assert _rel_l2(got, want) <= DECODE_REL_L2


@pytest.mark.parametrize("frames,hw,chunk", [(33, (480, 480), 9), (81, (480, 480), 11),
                                             (81, (480, 832), 7)])
def test_chunk_frames_at_wan21_grids(frames, hw, chunk):
    """Wan2.1's decoder at 33 frames of 480^2 decodes in one chunk; at 81
    frames the whole sequence passes 2^31 elements (the last nearest-2x
    output: 192 x 81 x 480 x 480 or x 832), so it takes the fewest even
    chunks under the limit."""
    cfg = TWanVAEConfig.wan()
    dec = WanDecoder3d(cfg, device="meta")
    shape = (1, cfg.z_dim, cfg.latent_frames(frames), hw[0] // 8, hw[1] // 8)
    T = shape[2]
    assert dec.chunk_frames(shape) == chunk
    assert dec._largest(1, chunk, *shape[3:]) < 2 ** 31
    assert dec._largest(1, T, *shape[3:]) >= 192 * frames * hw[0] * hw[1]
    if chunk < T:
        assert dec._largest(1, -(-T // (-(-T // chunk) - 1)), *shape[3:]) >= 2 ** 31


def test_chunk_size_model_refuses_an_unknown_block():
    """The size walk behind ``chunk_frames`` knows the decoder's three block
    kinds and raises on any other, rather than sizing it as an upsample."""
    dec = WanDecoder3d(TWanVAEConfig.wan(), device="meta")
    dec.up_blocks.append(torch.nn.Identity())
    with pytest.raises(TypeError, match="Identity"):
        dec.chunk_frames((1, 16, 21, 60, 104))


@pytest.fixture(scope="module")
def long_pipes():
    """The tiny WAN in both packages with a two-upsample VAE, 4 latent
    frames, the same numpy weights (non-zero LoRA B)."""
    jcfg = JWanConfig.tiny(lora_rank=4, lora_alpha=8.0)
    kw = dict(TWO_UP, z_dim=16, latents_mean=(0.0,) * 16, latents_std=(1.0,) * 16)
    jvcfg = JWanVAEConfig.tiny(**kw)
    tparams, vparams = jax_wan_params(jcfg, 16, 6), jax_wan_vae_params(jvcfg, 17)
    jpipe = JWanPipeline(jcfg, jvcfg, JWanTransformer(jcfg), JWanVideoVAE(jvcfg), tparams,
                         vparams, text_seq_len=6, latent_frames=4)
    tpipe = TWanPipeline.from_jax(tparams, vparams, TWanConfig.tiny(lora_rank=4, lora_alpha=8.0),
                                  TWanVAEConfig.tiny(**kw), "cpu", latent_frames=4)
    return jpipe, tpipe


def test_wan_rollout_and_decode_at_four_frames_match_jax(long_pipes, monkeypatch):
    """The deterministic chain with the per-step KL from 4 latent frames of
    a 4 x 6 grid (24 tokens), then the decode to 13 frames of 16 x 24:
    every latent, log-prob and KL, and the video decoded whole and one
    latent frame at a time, against JAX."""
    jpipe, tpipe = long_pipes
    rng = np.random.default_rng(3)
    lat = rng.standard_normal((1, 16, 4, 4, 6)).astype(np.float32)
    emb = (rng.standard_normal((1, 6, 32)) * 0.2).astype(np.float32)
    kw = dict(num_steps=3, deterministic=True, kl_reward=0.5)

    jvt = jpipe.velocity_fn(jpipe.transformer_params)
    jvr = jpipe.velocity_fn(jpipe.transformer_params, lora_scale=0.0)
    want = j_rollout.wan_denoise_with_logprob(
        lambda x, t, s: (jvt if s else jvr)(x, t, jnp.asarray(emb)), jnp.asarray(lat),
        jax.random.PRNGKey(0), j_rollout.WanSamplerConfig(**kw))
    want_vid = np.asarray(jpipe.decode(want.final_latents))

    tv = {s: tpipe.velocity_fn(s) for s in (1.0, 0.0)}
    with torch.no_grad():
        got = t_rollout.wan_denoise_with_logprob(
            lambda x, t, s: tv[s](x, t, _t(emb)), _t(lat), torch.Generator().manual_seed(0),
            t_rollout.WanSamplerConfig(**kw))
        whole = tpipe.decode(got.final_latents)
        monkeypatch.setattr(tpipe.vae.decoder, "chunk_frames", lambda shape: 1)
        framewise = tpipe.decode(got.final_latents)
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL, atol=ATOL)
    assert (got.kl > 0).all() and torch.isfinite(got.log_probs).all()
    np.testing.assert_allclose(got.kl.numpy(), np.asarray(want.kl), rtol=1e-4, atol=1e-12)
    assert whole.shape == want_vid.shape == (1, 13, 3, 16, 24)
    for vid in (whole, framewise):
        np.testing.assert_allclose(vid.numpy(), want_vid, rtol=RTOL, atol=ATOL)


def test_build_pipeline_at_81_frames():
    """``build_pipeline(frames=81)``'s grid: Wan2.1's VAE (4x in time, 8x in
    space) takes 81 frames of 480^2 to 21 x 60 x 60 latents, the JAX CLI's
    1 + (81 - 1) // 4 frames deep (``WanPipeline.from_pretrained``'s
    default); the tiny VAE (2x in time) to 41, which the tiny pipeline's
    latents take."""
    assert _wan_grid(TWanConfig.t2v_1_3b(), TWanVAEConfig.wan(), 480, 81) == (21, 60)
    assert 1 + (81 - 1) // 4 == 21
    config = apply_overrides(resolve_config("wan_smoke"), ["sample.num_frames=81"])
    pipe = build_pipeline(config, device="cpu", frames=81)
    lat = pipe.prepare_latents(torch.Generator().manual_seed(0), 1)
    assert pipe.latent_frames == pipe.vae_cfg.latent_frames(81) == 41
    assert lat.shape == (1, 16, 41, 16, 16)  # wan_smoke's 32^2 over the tiny VAE's 2x


@pytest.mark.parametrize("s_q,s_kv,rows", [(300, 300, 128), (257, 40, 64), (64, 200, 64)])
def test_blocked_plain_attention_matches_whole(s_q, s_kv, rows):
    """``blocked_bshd_reference`` (each row's softmax over all keys, as in the
    whole call) and the blocked twin (dq a block at a time, dk and dv summed
    over the blocks) within 1e-6 of ``mha_bshd_reference`` and
    ``bshd_bwd_reference``: fp32 products of other blockings."""
    g = torch.Generator().manual_seed(s_q + s_kv)
    heads = 2
    q, do = (torch.randn(1, s_q, 2 * 32, generator=g) for _ in range(2))
    k, v = (torch.randn(1, s_kv, 2 * 32, generator=g) for _ in range(2))
    o, lse = attention.mha_bshd_reference(q, k, v, num_heads=heads, return_lse=True)
    ob, lse_b = chip_smoke.blocked_bshd_reference(q, k, v, heads, rows=rows)
    torch.testing.assert_close(ob, o, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(lse_b, lse, rtol=1e-6, atol=1e-6)
    di = attention.bwd_row_stats(o, do, heads)
    want = attention.bshd_bwd_reference(q, k, v, do, lse, di, num_heads=heads)
    got = chip_smoke.blocked_bshd_bwd_reference(q, k, v, do, lse, di, heads, rows=rows)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
