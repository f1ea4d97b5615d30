"""The port's SigLIP tower and scorers against the JAX package, and its
HF-layout converter against ``transformers``, on the CPU.

Numpy inputs from a seed go through both packages in fp32 at the tiny tower
(2 layers of 32 in 2 heads, 28^2, 4 patches); the JAX parameters (random,
from a PRNG key) are carried to the port by
``siglip_state_dict_from_jax`` / ``dino_head_state_dict_from_jax`` (the
SigLIP cotrain head is DINO's fc1 / GELU / fc2). The scores are held on
images at the tower's resolution, where the PIL resize is the identity
(tests/test_torch_dino.py says why).

Covered: the tower's tokens and pooled embedding and the MAP head alone;
``SigLIPScorer``'s ``pooled``, ``similarity_to_refs`` and
``cotrain_score``; both SigLIP rewards of ``multi_score`` (5-D and 4-D
references); ``siglip_state_dict_from_hf`` against a tiny
``transformers.SiglipVisionModel``'s pooled output and its strictness.

Bounds: 1e-5 absolute (fp32, sums in another order).
"""

import jax
import numpy as np
import pytest
import torch

from adv_grpo_torch.models.convert import (
    dino_head_state_dict_from_jax, siglip_state_dict_from_hf, siglip_state_dict_from_jax)
from adv_grpo_torch.models.siglip import MAPHead as TMAPHead
from adv_grpo_torch.models.siglip import SigLIPVisionConfig as TConfig
from adv_grpo_torch.models.siglip import SigLIPVisionTower as TTower
from adv_grpo_torch.rewards.registry import RewardContext as TRewardContext
from adv_grpo_torch.rewards.registry import multi_score as t_multi_score
from adv_grpo_torch.rewards.scorers import DINOHead
from adv_grpo_torch.rewards.scorers import SigLIPScorer as TSigLIP
from adv_grpo_tpu.models.siglip import MAPHead as JMAPHead
from adv_grpo_tpu.models.siglip import SigLIPVisionConfig as JConfig
from adv_grpo_tpu.models.siglip import SigLIPVisionTower as JTower
from adv_grpo_tpu.rewards.registry import RewardContext as JRewardContext
from adv_grpo_tpu.rewards.registry import multi_score as j_multi_score
from adv_grpo_tpu.rewards.scorers import SigLIPScorer as JSigLIP

ATOL = 1e-5
SIZE = 28


def _images(seed, n=3, hw=SIZE):
    return np.random.default_rng(seed).uniform(-1, 1, (n, 3, hw, hw)).astype(np.float32)


@pytest.fixture(scope="module")
def siglip():
    js = JSigLIP(JConfig.tiny(), image_size=SIZE)
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    backbone = jax.device_get(js.init_backbone(k1))
    head = jax.device_get(js.init_head(k2))
    cfg = TConfig.tiny()
    tower = TTower(cfg)
    tower.load_state_dict(siglip_state_dict_from_jax(backbone, cfg))
    t_head = DINOHead(cfg.hidden_size)
    t_head.load_state_dict(dino_head_state_dict_from_jax(head))
    return dict(js=js, backbone=backbone, head=head, ts=TSigLIP(tower, SIZE), t_head=t_head)


def test_converter_fills_every_tensor(siglip):
    sd = siglip_state_dict_from_jax(siglip["backbone"], TConfig.tiny())
    assert set(sd) == set(siglip["ts"].vision.state_dict())


def test_tower_matches_jax(siglip):
    pix = _images(1, hw=SIZE)
    want = JTower(JConfig.tiny()).apply({"params": siglip["backbone"]}, pix)
    with torch.no_grad():
        got = siglip["ts"].vision(torch.from_numpy(pix))
    for key in ("tokens", "pooled"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=ATOL)


def test_map_head_matches_jax():
    """The head alone on random tokens: the residual is the attention
    output's, not the probe's."""
    tokens = np.random.default_rng(2).standard_normal((2, 5, 32)).astype(np.float32)
    jhead = JMAPHead(JConfig.tiny())
    params = jax.device_get(jhead.init(jax.random.PRNGKey(3), tokens)["params"])
    params = jax.tree_util.tree_map(np.asarray, params)
    head = TMAPHead(TConfig.tiny())
    sd = siglip_state_dict_from_jax({"head": params, "patch_embed": {
        "kernel": np.zeros((588, 32), np.float32), "bias": np.zeros(32, np.float32)},
        "position_embedding": np.zeros((4, 32), np.float32), "post_layernorm": {
            "scale": np.ones(32, np.float32), "bias": np.zeros(32, np.float32)}},
        TConfig.tiny(num_layers=0))
    head.load_state_dict({k[len("head."):]: v for k, v in sd.items() if k.startswith("head.")})
    with torch.no_grad():
        got = head(torch.from_numpy(tokens)).numpy()
    np.testing.assert_allclose(got, np.asarray(jhead.apply({"params": params}, tokens)),
                               atol=ATOL)


def test_scorer_functions_match_jax(siglip):
    js, ts, bb = siglip["js"], siglip["ts"], siglip["backbone"]
    images, refs = _images(4, n=3), _images(5, n=4)
    np.testing.assert_allclose(ts.pooled(images).numpy(), np.asarray(js.pooled(bb, images)),
                               atol=ATOL)
    sim = ts.similarity_to_refs(images, refs).numpy()
    np.testing.assert_allclose(sim, np.asarray(js.similarity_to_refs(bb, images, refs)),
                               atol=ATOL)
    # the images against themselves: each finds itself
    np.testing.assert_allclose(ts.similarity_to_refs(images, images).numpy(), 1.0, atol=ATOL)
    got = ts.cotrain_score(siglip["t_head"], images).numpy()
    np.testing.assert_allclose(got, np.asarray(js.cotrain_score(bb, siglip["head"], images)),
                               atol=ATOL)


@pytest.mark.parametrize("ref_dims", [5, 4])
def test_multi_score_siglip_rewards_match_jax(siglip, ref_dims):
    names = {"siglip_image_similarity": 0.7, "siglip_cotrain": 0.3}
    images = _images(6, n=2)
    refs = _images(7, n=4).reshape(2, 2, 3, SIZE, SIZE)
    if ref_dims == 4:
        refs = refs.reshape(4, 3, SIZE, SIZE)
    jctx = JRewardContext(siglip=siglip["js"], siglip_backbone_params=siglip["backbone"],
                          siglip_head_params=siglip["head"])
    tctx = TRewardContext(siglip=siglip["ts"], siglip_head_params=siglip["t_head"])
    want, _ = j_multi_score(names, jctx)(images, ["a", "b"], ref_images=refs)
    got, _ = t_multi_score(names, tctx)(images, ["a", "b"], ref_images=refs)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], atol=ATOL)


def _hf_siglip(size=SIZE):
    transformers = pytest.importorskip("transformers")
    cfg = transformers.SiglipVisionConfig(
        hidden_size=32, intermediate_size=64, num_hidden_layers=2, num_attention_heads=2,
        image_size=size, patch_size=14, layer_norm_eps=1e-6, hidden_act="gelu_pytorch_tanh")
    torch.manual_seed(0)
    model = transformers.SiglipVisionModel(cfg).eval()
    with torch.no_grad():
        for p in model.parameters():
            p.normal_(0.0, 0.3)
    return model


@pytest.mark.parametrize("size", [SIZE, 32])
def test_hf_converter_matches_transformers(size):
    """At 32^2, which 14 does not divide (as so400m's 384^2), HF's stride-14
    Conv2d leaves the last rows and columns out; so does the port."""
    model = _hf_siglip(size)
    pix = torch.from_numpy(_images(8, n=2, hw=size))
    with torch.no_grad():
        want = model(pixel_values=pix)
    cfg = TConfig.tiny(image_size=size)
    sd = siglip_state_dict_from_hf(model.state_dict(), cfg)
    tower = TTower(cfg)
    tower.load_state_dict(sd)
    with torch.no_grad():
        got = tower(pix)
    np.testing.assert_allclose(got["pooled"].numpy(), want.pooler_output.numpy(), atol=ATOL)
    np.testing.assert_allclose(got["tokens"].numpy(), want.last_hidden_state.numpy(), atol=ATOL)


def test_hf_converter_drops_the_text_tower_and_refuses_leftovers():
    sd = dict(_hf_siglip().state_dict())
    sd.update({"text_model.embeddings.token_embedding.weight": torch.zeros(3, 2),
               "logit_scale": torch.zeros(1), "logit_bias": torch.zeros(1)})
    assert set(siglip_state_dict_from_hf(sd, TConfig.tiny())) == set(
        TTower(TConfig.tiny()).state_dict())
    sd["vision_model.stray.weight"] = torch.zeros(1)
    with pytest.raises(ValueError, match="not consumed"):
        siglip_state_dict_from_hf(sd, TConfig.tiny())
    with pytest.raises(ValueError, match="position table"):
        siglip_state_dict_from_hf(dict(_hf_siglip().state_dict()), TConfig.tiny(image_size=42))
