"""The port's DINO discriminators against the JAX package, on the CPU.

Numpy inputs from a seed go through both packages in fp32; the JAX DINOv2
backbone, heads and fusion (random, from a PRNG key) are carried to the port
by ``models.convert``. The backbone is a tiny DINOv2 (3 layers of 32 in 2
heads) at 126^2, so that an image has 81 patch tokens and the patch score
draws 64 of them. Its LayerScale vectors are drawn away from their 1e-5
init before they are carried across: at 1e-5 every block is nearly the
identity, and the parity would not see a LayerScale that is missing.

Covered: the ViT forward (tokens, CLS, the captured middle and last
blocks), the ImageNet preprocessing (upsampling and downsampling),
``DINOScorer``'s four scores (the JAX patch indices passed to the port),
``DINOMultiScorer.score``, both hinge losses and their head gradients, the
JAX golden cases of tests/test_rewards_adversarial.py:87-122, and the five
DINO rewards of ``multi_score``.

Bounds: 1e-5 absolute (fp32, sums in another order); the preprocessing
1e-6, but for pixels at a uint8 rounding tie, where the two packages' fp32
sums can round to neighbouring levels (tests/test_torch_clip.py). A dozen
such pixels of an upsampled image move the features by a few 1e-5, so the
scores are held on images at the backbone's resolution, where the PIL
resize is the identity; the resize itself is held by
``test_imagenet_preprocess_matches_jax``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adv_grpo_torch.adversarial import dino_hinge as t_hinge
from adv_grpo_torch.models.convert import (
    dino_head_state_dict_from_jax, dino_multi_state_dict_from_jax, vit_state_dict_from_jax)
from adv_grpo_torch.models.vit import ViTConfig as TViTConfig
from adv_grpo_torch.models.vit import VisionTransformer as TViT
from adv_grpo_torch.rewards import preprocess as t_pp
from adv_grpo_torch.rewards.registry import RewardContext as TRewardContext
from adv_grpo_torch.rewards.registry import multi_score as t_multi_score
from adv_grpo_torch.rewards.scorers import DINOHead, DINOMultiHeads
from adv_grpo_torch.rewards.scorers import DINOMultiScorer as TMulti
from adv_grpo_torch.rewards.scorers import DINOScorer as TDINO
from adv_grpo_tpu.adversarial import dino_hinge as j_hinge
from adv_grpo_tpu.models.vit import ViTConfig as JViTConfig
from adv_grpo_tpu.rewards import preprocess as j_pp
from adv_grpo_tpu.rewards.registry import RewardContext as JRewardContext
from adv_grpo_tpu.rewards.registry import multi_score as j_multi_score
from adv_grpo_tpu.rewards.scorers import DINOMultiScorer as JMulti
from adv_grpo_tpu.rewards.scorers import DINOScorer as JDINO

ATOL = 1e-5
SIZE = 126  # 9 x 9 patches of 14
TINY = dict(image_size=SIZE, num_layers=3, hidden_size=32, intermediate_size=64, num_heads=2)
LAYERS = (1, 2)


def _np(x):
    return np.asarray(x, np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _images(seed, n=3, hw=SIZE):
    return np.random.default_rng(seed).uniform(-1, 1, (n, 3, hw, hw)).astype(np.float32)


def _draw_layer_scale(backbone, seed):
    """LayerScale vectors uniform on [0.5, 1.5] in place of 1e-5."""
    rng = np.random.default_rng(seed)
    out = jax.tree_util.tree_map(np.asarray, jax.device_get(backbone))
    for name, blk in out.items():
        if name.startswith("layer_"):
            for ls in ("ls1", "ls2"):
                blk[ls] = rng.uniform(0.5, 1.5, blk[ls].shape).astype(np.float32)
    return out


def port_dino(backbone, cfg=None, image_size=SIZE):
    cfg = cfg or TViTConfig.dinov2_base(**TINY)
    vision = TViT(cfg)
    vision.load_state_dict(vit_state_dict_from_jax(backbone, cfg))
    return TDINO(vision, image_size=image_size)


def port_head(params):
    head = DINOHead(32)
    head.load_state_dict(dino_head_state_dict_from_jax(jax.device_get(params)))
    return head


def port_multi(params):
    multi = DINOMultiHeads(32, len(params["heads"]))
    multi.load_state_dict(dino_multi_state_dict_from_jax(jax.device_get(params)))
    return multi


@pytest.fixture(scope="module")
def dino():
    """The JAX scorer with its backbone (LayerScale drawn), head and
    multi-layer heads, and the port's with the same weights."""
    jd = JDINO(JViTConfig.dinov2_base(**TINY), image_size=SIZE)
    key = jax.random.PRNGKey(0)
    k1, k2, k3 = jax.random.split(key, 3)
    backbone = _draw_layer_scale(jd.init_backbone(k1), 1)
    head = jd.init_head(k2)
    jm = JMulti(jd, layer_ids=LAYERS, temperature=2.0)
    multi = jm.init_heads(k3)
    td = port_dino(backbone)
    tm = TMulti(td, layer_ids=LAYERS, temperature=2.0)
    return dict(jd=jd, jm=jm, backbone=backbone, head=head, multi=multi, td=td, tm=tm,
                t_head=port_head(head), t_multi=port_multi(multi))


def test_converter_fills_every_tensor(dino):
    td = dino["td"]
    sd = vit_state_dict_from_jax(dino["backbone"], td.vision_cfg)
    assert set(sd) == set(td.vision.state_dict())
    assert "layers.0.ls1" in sd and "pre_layernorm.weight" not in sd
    assert not hasattr(td.vision, "visual_projection")
    assert set(dino_multi_state_dict_from_jax(dino["multi"])) == set(
        DINOMultiHeads(32, len(LAYERS)).state_dict())


def test_backbone_is_frozen(dino):
    td = dino["td"]
    assert not any(p.requires_grad for p in td.vision.parameters())
    assert not td.features(_images(0, n=1)).requires_grad


def test_vit_forward_matches_jax(dino):
    """tokens, CLS, the pre-norm tokens and the raw outputs of a middle and
    the last block (before post_layernorm), LayerScale drawn."""
    jd, td = dino["jd"], dino["td"]
    pix = np.random.default_rng(2).standard_normal((2, 3, SIZE, SIZE)).astype(np.float32)
    want = jd.vision.apply({"params": dino["backbone"]}, jnp.asarray(pix), capture_layers=LAYERS)
    with torch.no_grad():
        got = td.vision(_t(pix), capture_layers=LAYERS)
    assert set(got) == set(want) == {"tokens", "cls", "tokens_pre_norm", "layer_tokens"}
    for key in ("tokens", "cls", "tokens_pre_norm"):
        np.testing.assert_allclose(got[key].numpy(), _np(want[key]), rtol=0, atol=ATOL,
                                   err_msg=key)
    assert sorted(got["layer_tokens"]) == list(LAYERS)
    for i in LAYERS:
        np.testing.assert_allclose(got["layer_tokens"][i].numpy(), _np(want["layer_tokens"][i]),
                                   rtol=0, atol=ATOL, err_msg=f"layer {i}")
    # LayerScale matters at these values: the blocks are far from the identity
    assert np.abs(_np(want["layer_tokens"][1]) - _np(want["layer_tokens"][2])).max() > 0.1


def test_dinov2_base_widths():
    """DINOv2-B/14 at 518^2 (meta device: no memory): 1,370 tokens of 768,
    12 layers of 12 heads, LayerScale, no pre-LN, no projection."""
    cfg = TViTConfig.dinov2_base()
    vm = TViT(cfg, device="meta")
    assert vm.position_embedding.shape == (1370, 768) and len(vm.layers) == 12
    assert vm.layers[0].ls1.shape == (768,) and cfg.layer_norm_eps == 1e-6
    assert not hasattr(vm, "pre_layernorm") and not hasattr(vm, "visual_projection")
    j = JViTConfig.dinov2_base()
    assert (j.num_heads, j.intermediate_size, j.layer_scale_init) == (
        cfg.num_heads, cfg.intermediate_size, cfg.layer_scale_init)


@pytest.mark.parametrize("hw,size", [(16, 28), (64, 28), (512, 518)],
                         ids=["up16to28", "down64to28", "up512to518"])
def test_imagenet_preprocess_matches_jax(hw, size):
    """The DINO pipeline: upsampling (16 -> 28, DINO's 512 -> 518) and
    downsampling (64 -> 28) with the ImageNet statistics; 1e-6, a pixel at
    a uint8 rounding tie one level apart, at most 0.1% of them."""
    assert (t_pp.IMAGENET_MEAN, t_pp.IMAGENET_STD) == (j_pp.IMAGENET_MEAN, j_pp.IMAGENET_STD)
    images = _images(5, n=2, hw=hw)
    want = _np(j_pp.preprocess(jnp.asarray(images), size, j_pp.IMAGENET_MEAN, j_pp.IMAGENET_STD))
    got = t_pp.preprocess(_t(images), size, t_pp.IMAGENET_MEAN, t_pp.IMAGENET_STD).numpy()
    assert got.shape == want.shape == (2, 3, size, size)
    levels = np.abs(got - want) * np.asarray(t_pp.IMAGENET_STD).reshape(1, 3, 1, 1) * 255.0
    off = levels > 1e-6 * 255.0 * max(t_pp.IMAGENET_STD)
    assert off.mean() <= 1e-3, off.mean()
    np.testing.assert_allclose(levels[off], 1.0, atol=1e-3)


def _jax_patch_indices(key, b, n, n_patches=64):
    """The indices the JAX patch score draws from ``key``."""
    return np.asarray(jax.random.randint(key, (b, min(n_patches, n)), 0, n))


def test_dino_scores_match_jax(dino):
    jd, td, bp, hp, th = dino["jd"], dino["td"], dino["backbone"], dino["head"], dino["t_head"]
    images, refs = _images(6), np.stack([_images(7), _images(8)], axis=1)  # (B, R=2, ...)
    want, want_f, want_rf = jd.similarity_to_refs_with_feats(bp, jnp.asarray(images),
                                                             jnp.asarray(refs))
    got, got_f, got_rf = td.similarity_to_refs_with_feats(images, refs)
    for g, w in ((got, want), (got_f, want_f), (got_rf, want_rf)):
        np.testing.assert_allclose(g.numpy(), _np(w), rtol=0, atol=ATOL)
    assert got_rf.shape == (3, 2, 32)
    np.testing.assert_allclose(td.similarity_to_refs(images, refs).numpy(),
                               _np(jd.similarity_to_refs(bp, jnp.asarray(images),
                                                         jnp.asarray(refs))), atol=ATOL)
    np.testing.assert_allclose(td.cotrain_score(th, images).numpy(),
                               _np(jd.cotrain_score(bp, hp, jnp.asarray(images))), atol=ATOL)
    key = jax.random.PRNGKey(11)
    idx = _jax_patch_indices(key, 3, td.num_patches)
    assert idx.shape == (3, 64) and td.num_patches == 81
    np.testing.assert_allclose(
        td.patch_cotrain_score(th, images, idx=_t(idx).long()).numpy(),
        _np(jd.patch_cotrain_score(bp, hp, jnp.asarray(images), key)), atol=ATOL)


def test_identical_reference_scores_one(dino):
    """tests/test_rewards_adversarial.py:183-196: an identical reference
    among the references gives similarity 1."""
    images = _images(9, n=2)
    refs = np.stack([images, images * 0.5], axis=1)
    np.testing.assert_allclose(dino["td"].similarity_to_refs(images, refs).numpy(), 1.0,
                               atol=1e-4)


def test_patch_indices_are_uniform_with_replacement(dino):
    td = dino["td"]
    idx = td.draw_patch_indices(400, torch.Generator().manual_seed(0))
    assert idx.shape == (400, 64) and idx.dtype == torch.long
    assert int(idx.min()) == 0 and int(idx.max()) == td.num_patches - 1
    counts = torch.bincount(idx.reshape(-1), minlength=td.num_patches).float()
    assert counts.std() / counts.mean() < 0.1  # 316 draws a patch on average
    assert any(len(set(row.tolist())) < 64 for row in idx)  # repeats within an image


@pytest.mark.parametrize("apply_sigmoid", [True, False], ids=["sigmoid", "raw"])
def test_multi_score_matches_jax(dino, apply_sigmoid):
    jm, tm = dino["jm"], dino["tm"]
    images = _images(10)
    want = jm.score(dino["backbone"], dino["multi"], jnp.asarray(images),
                    apply_sigmoid=apply_sigmoid)
    got = tm.score(dino["t_multi"], images, apply_sigmoid=apply_sigmoid)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=0, atol=ATOL)
    if apply_sigmoid:
        assert ((got > 0) & (got < 1)).all()


def _tokens(seed, b=4, n=81, d=32):
    return np.random.default_rng(seed).standard_normal((b, 1 + n, d)).astype(np.float32)


def _head_grads(module):
    return {k: p.grad.numpy() for k, p in module.named_parameters()}


def test_hinge_loss_and_its_head_gradient_match_jax(dino):
    jd, hp = dino["jd"], dino["head"]
    real, fake = _tokens(12), _tokens(13) + 0.5
    key = jax.random.PRNGKey(3)
    k1, k2 = jax.random.split(key)
    idx_r, idx_f = (np.asarray(jax.random.randint(k, (4, 64), 0, 81)) for k in (k1, k2))

    def j_loss(p):
        out = j_hinge.dino_hinge_loss(lambda q, x: jd.head.apply({"params": q}, x), p,
                                      jnp.asarray(real), jnp.asarray(fake), key)
        return out.loss, out

    (_, want), j_grad = jax.value_and_grad(j_loss, has_aux=True)(hp)
    head = port_head(hp)
    got = t_hinge.dino_hinge_loss(head, _t(real), _t(fake), _t(idx_r).long(), _t(idx_f).long())
    got.loss.backward()
    for name in t_hinge.DinoDStepResult._fields:
        np.testing.assert_allclose(getattr(got, name).item(), float(getattr(want, name)),
                                   rtol=0, atol=ATOL, err_msg=name)
    want_g = dino_head_state_dict_from_jax(jax.device_get(j_grad))
    for name, g in _head_grads(head).items():
        np.testing.assert_allclose(g, want_g[name].numpy(), rtol=0, atol=ATOL, err_msg=name)


def test_multi_hinge_loss_and_its_gradient_match_jax(dino):
    jd, jm, mp = dino["jd"], dino["jm"], dino["multi"]
    real = [_tokens(20 + i) for i in range(2)]
    fake = [_tokens(30 + i) - 0.5 for i in range(2)]

    def j_loss(p):
        out = j_hinge.dino_multi_hinge_loss(
            lambda q, x: jd.head.apply({"params": q}, x),
            lambda q, x: jm.fusion.apply({"params": q}, x), p,
            [jnp.asarray(a) for a in real], [jnp.asarray(a) for a in fake])
        return out.loss, out

    (_, want), j_grad = jax.value_and_grad(j_loss, has_aux=True)(mp)
    multi = port_multi(mp)
    got = t_hinge.dino_multi_hinge_loss(multi.heads, multi.fusion, [_t(a) for a in real],
                                        [_t(a) for a in fake])
    got.loss.backward()
    for name in t_hinge.DinoDStepResult._fields:
        np.testing.assert_allclose(getattr(got, name).item(), float(getattr(want, name)),
                                   rtol=0, atol=ATOL, err_msg=name)
    want_g = dino_multi_state_dict_from_jax(jax.device_get(j_grad))
    got_g = _head_grads(multi)
    assert set(got_g) == set(want_g)
    for name, g in got_g.items():
        np.testing.assert_allclose(g, want_g[name].numpy(), rtol=0, atol=ATOL, err_msg=name)


def test_hinge_golden_values_and_accuracy():
    """tests/test_rewards_adversarial.py:87-105: a head that is the mean over
    the features sets each logit exactly."""
    def head(x):
        return x.mean(-1)

    idx = torch.zeros((2, 2), dtype=torch.long)
    real = torch.full((2, 5, 4), 2.0)  # logit 2: relu(1 - 2) = 0
    out = t_hinge.dino_hinge_loss(head, real, torch.full((2, 5, 4), -3.0), idx, idx)
    assert (out.image_loss.item(), out.patch_loss.item(), out.accuracy.item()) == (0.0, 0.0, 1.0)
    # misclassified fakes: logit +3, fake hinge relu(1 + 3) = 4
    out2 = t_hinge.dino_hinge_loss(head, real, torch.full((2, 5, 4), 3.0), idx, idx)
    np.testing.assert_allclose(out2.image_loss.item(), 2.0)
    np.testing.assert_allclose(out2.accuracy.item(), 0.5)
    np.testing.assert_allclose(out2.loss.item(),
                               out2.image_loss.item() + 0.3 * out2.patch_loss.item())


def test_hinge_gradient_direction():
    """tests/test_rewards_adversarial.py:107-122: the gradient raises the
    real logits and lowers the fake ones."""
    p = torch.zeros(4, requires_grad=True)
    idx = torch.zeros((2, 2), dtype=torch.long)
    t_hinge.dino_hinge_loss(lambda x: (x * p).sum(-1), torch.ones((2, 3, 4)),
                            -torch.ones((2, 3, 4)), idx, idx).loss.backward()
    assert (p.grad < 0).all()


FIVE = {"image_similarity": 1.0, "image_similarity_eval": 0.5, "dino_cotrain": 2.0,
        "dino_patch_cotrain": 0.25, "dino_multi_cotrain": 1.5}


def test_multi_score_serves_the_five_dino_rewards(dino):
    """Each reward against the JAX ``multi_score`` (the patch reward against
    the JAX scorer's pieces at the indices the port's generator draws: the
    JAX key's draws cannot be matched bit for bit), the detail keys
    (``image_similarity_eval`` adds ``feat`` / ``ref_feat``) and 'avg'."""
    jd, td, bp, hp = dino["jd"], dino["td"], dino["backbone"], dino["head"]
    images, prompts = _images(14), ["a cat", "a dog", "a cow"]
    refs = _images(15)[:, None]  # (B, R=1, ...), as the reference store gives them
    ctx = TRewardContext(dino=td, dino_head_params=dino["t_head"], dino_multi=dino["tm"],
                         dino_multi_params=dino["t_multi"], rng=torch.Generator().manual_seed(5))
    got, meta = t_multi_score(FIVE, ctx)(images, prompts, ref_images=refs)
    jctx = JRewardContext(dino=jd, dino_backbone_params=bp, dino_head_params=hp,
                          dino_multi=dino["jm"], dino_multi_params=dino["multi"],
                          rng=jax.random.PRNGKey(5))
    want, _ = j_multi_score(FIVE, jctx)(jnp.asarray(images), prompts,
                                        ref_images=jnp.asarray(refs))
    assert meta == {} and set(got) == set(want) == set(FIVE) | {"feat", "ref_feat", "avg"}
    for name in ("image_similarity", "image_similarity_eval", "dino_cotrain",
                 "dino_multi_cotrain", "feat", "ref_feat"):
        np.testing.assert_allclose(got[name], want[name], rtol=0, atol=ATOL, err_msg=name)
    assert got["feat"].shape == (3, 32) and got["ref_feat"].shape == (3, 1, 32)
    idx = td.draw_patch_indices(3, torch.Generator().manual_seed(5)).numpy()
    toks = jd.features(bp, jnp.asarray(images))
    sel = np.take_along_axis(np.asarray(toks[:, 1:]), idx[..., None], axis=1)
    head = lambda x: np.asarray(jd.head.apply({"params": hp}, jnp.asarray(x)))  # noqa: E731
    want_patch = 0.7 * head(toks[:, 0]) + 0.3 * head(sel).mean(1)
    np.testing.assert_allclose(got["dino_patch_cotrain"], want_patch, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got["avg"], sum(w * got[k] for k, w in FIVE.items()), rtol=1e-12)
    # the shared generator moved on: the next batch draws other patches
    again, _ = t_multi_score({"dino_patch_cotrain": 1.0}, ctx)(images, prompts)
    assert not np.array_equal(again["dino_patch_cotrain"], got["dino_patch_cotrain"])


def test_dino_rewards_need_their_context(dino):
    images = _images(16, n=1)
    with pytest.raises(RuntimeError, match="ref_images"):
        t_multi_score({"image_similarity": 1.0}, TRewardContext(dino=dino["td"]))(images, ["x"])
    with pytest.raises(RuntimeError, match="rng"):
        t_multi_score({"dino_patch_cotrain": 1.0}, TRewardContext(
            dino=dino["td"], dino_head_params=dino["t_head"]))(images, ["x"])
    with pytest.raises(RuntimeError, match="dino_multi"):
        t_multi_score({"dino_multi_cotrain": 1.0}, TRewardContext())(images, ["x"])
