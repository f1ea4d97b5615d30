"""The port's StyleGAN discriminator (the ``discriminator`` reward) against
the JAX package, on the CPU.

Numpy inputs from a seed go through both packages in fp32; the JAX D's
parameters (random, from a PRNG key) are carried to the port by
``stylegan_state_dict_from_jax``. The D is StyleGANDConfig(image_size=32,
base_channels=8), the JAX CLI's smoke D.

Covered: the resize (``jax.image.resize`` bilinear, antialiased when it
downsamples) down 64 -> 32 and 48 -> 32 and up 16 -> 32 and 20 -> 32;
``_normalise`` on inputs in [-1, 1], [0, 1] and [0, 255]; the minibatch
standard deviation at B = 4, 6 and 8, and B = 9, where the JAX group does
not divide the batch and both packages raise; ``logits_to_scores`` on its
three shapes and its refusal; the D's logits and the scorer's scores; the
state-dict round trip; ``build_reward_context``'s D from a flax
``.msgpack`` at ``STYLEGAN_D_PATH`` written by ``flax.serialization`` (and
its refusal of an orbax directory); the ``discriminator`` reward of
``multi_score``, on the device D and through a remote client.

Bounds: 1e-5 absolute (fp32, sums in another order); the resize 1e-6.
"""

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adv_grpo_torch.cli.common import build_reward_context, resolve_config
from adv_grpo_torch.models import stylegan_d as t_sg
from adv_grpo_torch.models.convert import (
    stylegan_state_dict_from_jax, stylegan_state_dict_to_jax)
from adv_grpo_torch.rewards.registry import RewardContext as TRewardContext
from adv_grpo_torch.rewards.registry import multi_score as t_multi_score
from adv_grpo_tpu.models import stylegan_d as j_sg
from adv_grpo_tpu.rewards.registry import RewardContext as JRewardContext
from adv_grpo_tpu.rewards.registry import multi_score as j_multi_score

ATOL = 1e-5
CFG = dict(image_size=32, base_channels=8)


def _images(seed, n=4, hw=32, lo=-1.0, hi=1.0):
    return np.random.default_rng(seed).uniform(lo, hi, (n, 3, hw, hw)).astype(np.float32)


@pytest.fixture(scope="module")
def disc():
    js = j_sg.StyleGANScorer(j_sg.StyleGANDConfig(**CFG))
    # init_params's computation, jitted (op by op it takes ~20 s here)
    params = jax.jit(js.model.init)(jax.random.PRNGKey(0), jnp.zeros((2, 3, 32, 32)))["params"]
    params = jax.tree_util.tree_map(np.asarray, jax.device_get(params))
    cfg = t_sg.StyleGANDConfig(**CFG)
    ts = t_sg.StyleGANScorer.from_state_dict(stylegan_state_dict_from_jax(params, cfg), "cpu",
                                             cfg)
    return dict(js=js, params=params, ts=ts, cfg=cfg)


@pytest.mark.parametrize("src", [64, 48, 16, 20])
def test_resize_matches_jax_image_resize(src):
    x = _images(1, n=2, hw=src)
    want = jax.image.resize(jnp.asarray(x), (2, 3, 32, 32), method="bilinear")
    got = t_sg.resize_bilinear(torch.from_numpy(x), 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    if src > 32:  # antialiased: not the plain bilinear interpolation
        plain = torch.nn.functional.interpolate(torch.from_numpy(x), size=(32, 32),
                                                mode="bilinear", align_corners=False)
        assert np.abs(plain.numpy() - np.asarray(want)).max() > 1e-3


@pytest.mark.parametrize("lo,hi", [(-1.0, 1.0), (0.0, 1.0), (0.0, 255.0)])
def test_normalise_matches_jax(disc, lo, hi):
    x = _images(2, lo=lo, hi=hi)
    want = disc["js"]._normalise(jnp.asarray(x))
    got = t_sg.StyleGANScorer.normalise(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    assert float(got.min()) < 0.0 <= float(got.max()) <= 1.0 + 1e-6


@pytest.mark.parametrize("batch", [4, 6, 8])
def test_minibatch_stddev_matches_jax(batch):
    x = np.random.default_rng(batch).standard_normal((batch, 5, 4, 4)).astype(np.float32)
    want = j_sg.minibatch_stddev(jnp.asarray(x.transpose(0, 2, 3, 1)))
    got = t_sg.minibatch_stddev(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want).transpose(0, 3, 1, 2), atol=ATOL)


def test_minibatch_stddev_group_that_does_not_divide_raises_in_both():
    """B = 9: g = 9 // (9 // 4) = 4, which does not divide 9."""
    x = np.zeros((9, 2, 4, 4), np.float32)
    with pytest.raises(TypeError):  # the JAX reshape
        j_sg.minibatch_stddev(jnp.asarray(x.transpose(0, 2, 3, 1)))
    with pytest.raises(ValueError, match="group 4 .* B = 9"):
        t_sg.minibatch_stddev(torch.from_numpy(x))
    assert [t_sg.mbstd_group(b) for b in (4, 5, 6, 7, 8, 10, 15, 16)] == [4, 5, 6, 7, 4, 5, 5, 4]


@pytest.mark.parametrize("shape", [(5,), (5, 1), (5, 1, 3, 3)])
def test_logits_to_scores_matches_jax(shape):
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    np.testing.assert_allclose(t_sg.logits_to_scores(torch.from_numpy(x)).numpy(),
                               np.asarray(j_sg.logits_to_scores(jnp.asarray(x))), atol=1e-6)


def test_logits_to_scores_refuses_other_shapes():
    with pytest.raises(ValueError, match="logits shape"):
        t_sg.logits_to_scores(torch.zeros(5, 2))


def test_discriminator_logits_and_scores_match_jax(disc):
    x = _images(3)
    want = j_sg.StyleGANDiscriminator(j_sg.StyleGANDConfig(**CFG)).apply(
        {"params": disc["params"]}, jnp.asarray(x))
    with torch.no_grad():
        got = disc["ts"].model(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    for hw, lo, hi in ((64, 0.0, 255.0), (16, 0.0, 1.0)):  # renormalised and resized
        x = _images(hw, hw=hw, lo=lo, hi=hi)
        np.testing.assert_allclose(disc["ts"].score(x).numpy(),
                                   np.asarray(disc["js"].score(disc["params"], jnp.asarray(x))),
                                   atol=ATOL)


def test_state_dict_round_trip(disc):
    sd = disc["ts"].model.state_dict()
    tree = stylegan_state_dict_to_jax(sd, disc["cfg"])
    assert jax.tree_util.tree_structure(tree) == jax.tree_util.tree_structure(disc["params"])
    back = stylegan_state_dict_from_jax(tree, disc["cfg"])
    assert all(torch.equal(back[k], sd[k]) for k in sd)
    with pytest.raises(ValueError, match="placed"):
        stylegan_state_dict_from_jax({**tree, "extra": {"kernel": np.zeros(1)}}, disc["cfg"])


def test_context_reads_the_msgpack_the_jax_params_write(disc, tmp_path, monkeypatch):
    path = tmp_path / "d.msgpack"
    path.write_bytes(flax.serialization.to_bytes(disc["params"]))
    monkeypatch.setenv("STYLEGAN_D_PATH", str(path))
    cfg = resolve_config("smoke_sd3_fast")
    ctx = build_reward_context(cfg, {"discriminator"}, device="cpu")
    x = _images(4)
    np.testing.assert_array_equal(ctx.stylegan.score(x).numpy(), disc["ts"].score(x).numpy())
    monkeypatch.setenv("STYLEGAN_D_PATH", str(tmp_path))
    with pytest.raises(ValueError, match="orbax"):
        build_reward_context(cfg, {"discriminator"}, device="cpu")


def test_multi_score_discriminator_matches_jax(disc):
    x = _images(5)
    names = {"discriminator": 2.0}
    want, _ = j_multi_score(names, JRewardContext(stylegan=disc["js"],
                                                  stylegan_params=disc["params"]))(x, ["a"] * 4)
    got, _ = t_multi_score(names, TRewardContext(stylegan=disc["ts"]))(x, ["a"] * 4)
    for key in ("discriminator", "avg"):
        np.testing.assert_allclose(got[key], want[key], atol=ATOL)
    # without a device D: the remote client on the uint8 copy, in both
    judge = lambda u8, prompts, meta=None: u8.reshape(len(u8), -1).mean(1) / 255.0  # noqa: E731
    want, _ = j_multi_score(names, JRewardContext(remote={"discriminator": judge}))(x, ["a"] * 4)
    got, _ = t_multi_score(names, TRewardContext(remote={"discriminator": judge}))(x, ["a"] * 4)
    np.testing.assert_array_equal(got["avg"], want["avg"])
