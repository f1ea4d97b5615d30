"""The port's PickScore reward against the JAX package, on the CPU.

Numpy inputs from a seed go through both packages in fp32; the JAX
``CLIPDualEncoder`` params (random, from a PRNG key) are carried to the port
by ``models.convert.clip_dual_state_dict_from_jax``. Covered: the text and
vision towers, the preprocessing, ``PickScoreScorer``, the CLIP criterion
and its gradient, and the PickScore branches of ``multi_score``.

Bounds: towers and scores 1e-5 absolute (fp32, sums in another order); the
preprocessing 1e-6, but for pixels at a uint8 rounding tie, where the two
packages' fp32 sums can round to neighbouring levels: those differ by
exactly one level and are at most 0.1% of the pixels; the criterion and its
gradient 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adv_grpo_torch.adversarial import clip_criterion as t_crit
from adv_grpo_torch.models.clip_text import CLIPTextConfig as TTextConfig
from adv_grpo_torch.models.convert import clip_dual_state_dict_from_jax
from adv_grpo_torch.models.vit import ViTConfig as TViTConfig
from adv_grpo_torch.rewards import preprocess as t_pp
from adv_grpo_torch.rewards.registry import RewardContext as TRewardContext
from adv_grpo_torch.rewards.registry import multi_score as t_multi_score
from adv_grpo_torch.rewards.scorers import CLIPDualEncoder, PickScoreScorer as TPickScore
from adv_grpo_tpu.adversarial import clip_criterion as j_crit
from adv_grpo_tpu.models.clip_text import CLIPTextConfig as JTextConfig
from adv_grpo_tpu.models.vit import ViTConfig as JViTConfig
from adv_grpo_tpu.rewards import preprocess as j_pp
from adv_grpo_tpu.rewards.registry import RewardContext as JRewardContext
from adv_grpo_tpu.rewards.registry import multi_score as j_multi_score
from adv_grpo_tpu.rewards.scorers import PickScoreScorer as JPickScore

ATOL = 1e-5


def _np(x):
    return np.asarray(x, np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def scorers():
    """The tiny JAX scorer with random params, and the port's with the same
    weights."""
    js = JPickScore(JTextConfig.tiny(projection_dim=16), JViTConfig.tiny(projection_dim=16),
                    image_size=28)
    params = js.init_params(jax.random.PRNGKey(0))
    ts = port_scorer(params)
    return js, params, ts


def port_scorer(params, tcfg=None):
    """The port's tiny scorer with the JAX ``params``."""
    tcfg, vcfg = tcfg or TTextConfig.tiny(projection_dim=16), TViTConfig.tiny(projection_dim=16)
    clip = CLIPDualEncoder(tcfg, vcfg)
    clip.load_state_dict(clip_dual_state_dict_from_jax(jax.device_get(params), tcfg, vcfg))
    return TPickScore(clip.eval(), image_size=28)


def _images(seed, n=3, hw=64):
    return np.random.default_rng(seed).uniform(-1, 1, (n, 3, hw, hw)).astype(np.float32)


def test_converter_fills_every_tensor(scorers):
    _, params, ts = scorers
    sd = clip_dual_state_dict_from_jax(jax.device_get(params), ts.clip.text_model.cfg,
                                       ts.clip.vision_model.cfg)
    assert set(sd) == set(ts.clip.state_dict())
    assert sd["logit_scale"].shape == () and sd["logit_scale"].dtype == torch.float32


@pytest.mark.parametrize("eos_at", [None, 0, 5, 15], ids=["no_eos", "eos0", "eos5", "eos15"])
def test_text_tower_matches_jax(scorers, eos_at):
    """final, penultimate and pooled outputs; pooling at the FIRST eos (two
    eos tokens in the row), position 0 with none."""
    js, params, ts = scorers
    cfg = js.clip.text_cfg
    ids = np.random.default_rng(1).integers(0, cfg.vocab_size - 1, (3, 16)).astype(np.int32)
    if eos_at is not None:
        ids[:, eos_at] = cfg.eos_token_id
        ids[:, -1] = cfg.eos_token_id
    want = js.clip.text_model.apply({"params": params["text"]}, jnp.asarray(ids))
    with torch.no_grad():
        got = ts.clip.text_model(_t(ids).long())
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), _np(w), rtol=0, atol=ATOL)


@pytest.mark.parametrize("hidden_act", ["quick_gelu", "gelu"])
def test_text_activations_match_jax(hidden_act):
    """The CLIP-L activation (quick_gelu) and CLIP-H's exact gelu."""
    js = JPickScore(JTextConfig.tiny(projection_dim=16, hidden_act=hidden_act),
                    JViTConfig.tiny(projection_dim=16), image_size=28)
    params = js.init_params(jax.random.PRNGKey(3))
    ts = port_scorer(params, TTextConfig.tiny(projection_dim=16, hidden_act=hidden_act))
    ids = np.random.default_rng(2).integers(0, 63, (2, 16)).astype(np.int32)
    want = js.clip.text_features(params, jnp.asarray(ids))
    with torch.no_grad():
        np.testing.assert_allclose(ts.clip.text_features(_t(ids).long()).numpy(), _np(want),
                                   rtol=0, atol=ATOL)


def test_vision_tower_matches_jax(scorers):
    js, params, ts = scorers
    pix = np.random.default_rng(4).standard_normal((3, 3, 28, 28)).astype(np.float32)
    want = js.clip.vision_model.apply({"params": params["vision"]}, jnp.asarray(pix))
    with torch.no_grad():
        got = ts.clip.vision_model(_t(pix))
    for key in ("tokens", "cls", "tokens_pre_norm", "pooled"):
        np.testing.assert_allclose(got[key].numpy(), _np(want[key]), rtol=0, atol=ATOL,
                                   err_msg=key)


def test_clip_h_widths():
    """The full-size towers' shapes (meta device: no memory): CLIP-H/14 at
    224^2 has 257 tokens of 1280 in 16 heads of 80, text 24 x 1024."""
    clip = CLIPDualEncoder(TTextConfig.clip_h_text(), TViTConfig.clip_h(), device="meta")
    vm, tm = clip.vision_model, clip.text_model
    assert vm.position_embedding.shape == (257, 1280) and len(vm.layers) == 32
    assert vm.cfg.hidden_size // vm.cfg.num_heads == 80
    assert vm.visual_projection.weight.shape == (1024, 1280)
    assert len(tm.layers) == 24 and tm.text_projection.weight.shape == (1024, 1024)
    assert JViTConfig.clip_h().num_heads == vm.cfg.num_heads


@pytest.mark.parametrize("hw,size", [(512, 224), (64, 28), (64, 224)])
def test_preprocess_matches_jax(hw, size):
    """fp32 to 1e-6; a pixel may sit at a uint8 rounding tie, where the two
    packages' fp32 sums can land on either side: it then differs by exactly
    one level (1/255 before the normalisation), and such pixels are at most
    0.1% of the whole."""
    images = _images(5, n=2, hw=hw)
    want = _np(j_pp.preprocess(jnp.asarray(images), size, j_pp.CLIP_MEAN, j_pp.CLIP_STD))
    got = t_pp.preprocess(_t(images), size, t_pp.CLIP_MEAN, t_pp.CLIP_STD).numpy()
    assert got.shape == want.shape == (2, 3, size, size)
    levels = np.abs(got - want) * np.asarray(t_pp.CLIP_STD).reshape(1, 3, 1, 1) * 255.0
    off = levels > 1e-6 * 255.0 * max(t_pp.CLIP_STD)
    assert off.mean() <= 1e-3, off.mean()
    np.testing.assert_allclose(levels[off], 1.0, atol=1e-3)


def test_quantize_rounds_half_up():
    x = torch.tensor([0.5 / 255, 1.5 / 255, 2.5 / 255, 1.0, 0.0])
    got = t_pp.quantize_uint8(x) * 255
    np.testing.assert_array_equal(got.round().numpy(), [1, 2, 3, 255, 0])
    np.testing.assert_array_equal(got.numpy(), _np(j_pp.quantize_uint8(jnp.asarray(x.numpy())))
                                  * 255)


def test_scorer_matches_jax(scorers):
    js, params, ts = scorers
    images, ids = _images(6), np.full((3, 16), 3, np.int32)
    want = js.score(params, jnp.asarray(images), jnp.asarray(ids))
    np.testing.assert_allclose(ts.score(images, ids).numpy(), _np(want), rtol=0, atol=ATOL)
    wi, wt = js.features(params, jnp.asarray(images), jnp.asarray(ids))
    gi, gt = ts.features(_t(images), ids)
    np.testing.assert_allclose(gi.detach().numpy(), _np(wi), atol=ATOL)
    np.testing.assert_allclose(gt.detach().numpy(), _np(wt), atol=ATOL)


def _criterion_inputs(seed, b=4, d=8, ties=False):
    rng = np.random.default_rng(seed)

    def norm(x):
        return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)

    t, i0, i1 = (norm(rng.standard_normal((b, d))) for _ in range(3))
    if ties:
        l0 = np.array([0.5, 1.0, 0.5, 0.0], np.float32)[:b]
        l1 = np.array([0.5, 0.0, 0.5, 1.0], np.float32)[:b]
    else:
        l0, l1 = np.ones(b, np.float32), np.zeros(b, np.float32)
    return t, i0, i1, l0, l1


@pytest.mark.parametrize("in_batch", [False, True], ids=["pairwise", "in_batch"])
@pytest.mark.parametrize("ties", [False, True], ids=["labels", "ties"])
def test_clip_criterion_and_its_gradient_match_jax(in_batch, ties):
    t, i0, i1, l0, l1 = _criterion_inputs(7, ties=ties)
    scale = 12.5

    def j_loss(t, i0, i1):
        b = j_crit.CLIPCriterionBatch(t, i0, i1, jnp.asarray(l0), jnp.asarray(l1))
        return j_crit.clip_criterion_loss(b, scale, in_batch_negatives=in_batch)

    want, want_g = jax.value_and_grad(j_loss, argnums=(0, 1, 2))(
        jnp.asarray(t), jnp.asarray(i0), jnp.asarray(i1))
    feats = [_t(a).requires_grad_() for a in (t, i0, i1)]
    got = t_crit.clip_criterion_loss(
        t_crit.CLIPCriterionBatch(*feats, _t(l0), _t(l1)), scale, in_batch_negatives=in_batch)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=0, atol=1e-6)
    for f, w in zip(feats, want_g):
        np.testing.assert_allclose(f.grad.numpy(), _np(w), rtol=0, atol=1e-6)


def test_d_step_loss_and_accuracy_match_jax(scorers):
    js, params, ts = scorers
    real, fake, ids = _images(8), _images(9), np.full((3, 16), 3, np.int32)
    want_loss, want_acc = j_crit.pickscore_d_step_loss_and_acc(
        js, params, jnp.asarray(real), jnp.asarray(fake), jnp.asarray(ids))
    loss, acc = t_crit.pickscore_d_step_loss_and_acc(ts, real, fake, ids)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=0, atol=ATOL)
    assert acc.item() == float(want_acc) and not acc.requires_grad


def test_multi_score_serves_frozen_and_live_pickscore(scorers):
    """'pickscore' scores with the frozen tail, 'pickscore_cotrain' with the
    live one; both equal the JAX scores of their weights; 'avg' is the
    weighted sum."""
    import copy

    js, params, ts = scorers
    ts = port_scorer(params)
    images, prompts = _images(10), ["a cat", "a dog", "a cow"]
    tokenize = lambda ps: np.full((len(ps), 16), 3, np.int32)  # noqa: E731
    tail = torch.nn.ModuleList([ts.clip.vision_model.layers[-1]])
    ctx = TRewardContext(pickscore=ts, pickscore_params=tail, tokenize=tokenize,
                         pickscore_frozen_params=copy.deepcopy(tail))
    fn = t_multi_score({"pickscore": 2.0, "pickscore_cotrain": 0.5, "jpeg_compressibility": 1.0},
                       ctx)
    want, _ = j_multi_score({"pickscore": 2.0, "jpeg_compressibility": 1.0},
                            JRewardContext(pickscore=js, pickscore_params=params,
                                           tokenize=tokenize))(jnp.asarray(images), prompts)
    got, meta = fn(images, prompts)
    assert meta == {} and set(got) == {"pickscore", "pickscore_cotrain", "jpeg_compressibility",
                                       "avg"}
    np.testing.assert_allclose(got["pickscore"], want["pickscore"], atol=ATOL)
    np.testing.assert_allclose(got["pickscore_cotrain"], want["pickscore"], atol=ATOL)
    np.testing.assert_array_equal(got["jpeg_compressibility"], want["jpeg_compressibility"])
    np.testing.assert_allclose(got["avg"], 2.0 * got["pickscore"] + 0.5 * got["pickscore_cotrain"]
                               + got["jpeg_compressibility"], rtol=1e-12)
    # move the live tail: only the co-trained score follows it
    with torch.no_grad():
        for p in tail.parameters():
            p.add_(0.05)
    moved, _ = fn(images, prompts)
    np.testing.assert_array_equal(moved["pickscore"], got["pickscore"])
    assert np.abs(moved["pickscore_cotrain"] - got["pickscore_cotrain"]).max() > 1e-4


def test_multi_score_needs_its_context():
    fn = t_multi_score({"pickscore": 1.0})
    with pytest.raises(RuntimeError, match="pickscore"):
        fn(np.zeros((1, 3, 8, 8), np.float32), ["x"])


def test_pil_weights_are_a_copy():
    for n_in, n_out in ((512, 224), (64, 28), (28, 224), (100, 37)):
        np.testing.assert_array_equal(t_pp.pil_resample_weights(n_in, n_out),
                                      j_pp.pil_resample_weights(n_in, n_out))
