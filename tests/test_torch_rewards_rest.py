"""The port's PickScore patch and contrastive-external rewards against the
JAX package, and every reward name of the JAX registry through the port's
``multi_score`` and ``build_reward_context``, on the CPU.

The PickScore towers are the tiny ones (``tests/test_torch_clip.py``'s
``scorers`` fixture: JAX parameters carried across by
``clip_dual_state_dict_from_jax``), at 28^2 where the PIL resize is the
identity. ``contrastive_external_reward`` runs on one batch per gate
branch, all under one prompt: of four images, the three lowest-scoring
against the highest as the reference (the external score is above the top
score: no correction), and three images against themselves (the external
mean is below the top score: the correction applies).

Bounds: 1e-5 absolute (fp32, sums in another order).
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adv_grpo_torch.cli import common as t_common
from adv_grpo_torch.cli import eval as t_eval
from adv_grpo_torch.rewards.registry import KNOWN_REWARDS
from adv_grpo_torch.rewards.registry import RewardContext as TRewardContext
from adv_grpo_torch.rewards.registry import multi_score as t_multi_score
from adv_grpo_torch.rewards.scorers import contrastive_external_reward, pickscore_patch_score
from adv_grpo_tpu.rewards import scorers as j_scorers
from adv_grpo_tpu.rewards.registry import RewardContext as JRewardContext
from adv_grpo_tpu.rewards.registry import multi_score as j_multi_score
from tests.test_torch_clip import scorers  # noqa: F401  (the tiny PickScore in both packages)

ATOL = 1e-5
SIZE = 28


def _images(seed, n=3):
    return np.random.default_rng(seed).uniform(-1, 1, (n, 3, SIZE, SIZE)).astype(np.float32)


def _ids(n, seed=0):
    return np.random.default_rng(seed).integers(1, 40, (n, 16)).astype(np.int32)


def test_pickscore_patch_score_matches_jax(scorers):  # noqa: F811
    js, params, ts = scorers
    images, ids = _images(1), _ids(3)
    want = j_scorers.pickscore_patch_score(js, params, jnp.asarray(images), jnp.asarray(ids))
    got = pickscore_patch_score(ts, images, ids)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    # the live tail passed in is the scorer's own layers here
    tail = list(ts.clip.vision_model.layers)[-1:]
    np.testing.assert_array_equal(pickscore_patch_score(ts, images, ids, tail).numpy(),
                                  got.numpy())


def gate_batches(scorer, images, ids):
    """{"closed": (the lowest-scoring images but one, the best as the
    reference), "open": (the images but one, against themselves)} under the
    prompt ``ids`` (one row)."""
    order = np.argsort(scorer.score(images, np.repeat(ids, len(images), 0)).cpu().numpy())
    return {"closed": (images[order[:-1]], images[order[-1:]]),
            "open": (images[:-1], images[:-1])}


@pytest.mark.parametrize("branch", ["closed", "open"])
def test_contrastive_external_reward_matches_jax_on_both_branches(scorers, branch):  # noqa: F811
    js, params, ts = scorers
    images, refs = gate_batches(ts, _images(2, n=4), _ids(1))[branch]
    ids = np.repeat(_ids(1), 3, 0)
    want, jaux = j_scorers.contrastive_external_reward(js, params, jnp.asarray(images),
                                                       jnp.asarray(refs), jnp.asarray(ids))
    got, aux = contrastive_external_reward(ts, images, refs, ids)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    for key in ("raw_scores", "ref_scores"):
        np.testing.assert_allclose(aux[key].numpy(), np.asarray(jaux[key]), atol=ATOL)
    corrected = not np.array_equal(got.numpy(), aux["raw_scores"].numpy())
    assert corrected == (branch == "open")


def test_multi_score_pickscore_rewards_match_jax(scorers):  # noqa: F811
    js, params, ts = scorers
    names = {"pickscore_patch": 0.5, "constractive_external": 2.0, "pickscore": 1.0}
    images = _images(4, n=2)
    refs = _images(5, n=4).reshape(2, 2, 3, SIZE, SIZE)
    tokenize = lambda prompts: _ids(len(prompts), 7)  # noqa: E731
    jctx = JRewardContext(pickscore=js, pickscore_params=params, tokenize=tokenize)
    tctx = TRewardContext(pickscore=ts, tokenize=tokenize)
    want, _ = j_multi_score(names, jctx)(images, ["a", "b"], ref_images=refs)
    got, _ = t_multi_score(names, tctx)(images, ["a", "b"], ref_images=refs)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], atol=ATOL)


def test_every_jax_reward_name_is_known():
    """The JAX registry's DEVICE | HOST | REMOTE sets, read from its error."""
    with pytest.raises(KeyError) as err:
        j_multi_score({"no_such_reward": 1.0}, JRewardContext())
    jax_names = set(re.findall(r"'(\w+)'", str(err.value).split("known: ")[1]))
    assert jax_names == set(KNOWN_REWARDS)
    with pytest.raises(KeyError, match="unknown reward 'no_such_reward'.*siglip_cotrain"):
        t_multi_score({"no_such_reward": 1.0})
    t_multi_score({name: 1.0 for name in KNOWN_REWARDS})  # every name accepted


def test_smoke_context_scores_every_new_device_reward():
    cfg = t_common.resolve_config("smoke_sd3_fast")
    names = {"siglip_image_similarity": 1.0, "siglip_cotrain": 1.0, "pickscore_patch": 1.0,
             "constractive_external": 1.0, "discriminator": 1.0}
    ctx = t_common.build_reward_context(cfg, set(names), device="cpu")
    images = torch.from_numpy(_images(6, n=4))
    details, _ = t_multi_score(names, ctx)(images, ["a"] * 4, ref_images=images[:, None])
    for name in names:
        assert details[name].shape == (4,) and np.isfinite(details[name]).all()
    np.testing.assert_allclose(details["siglip_image_similarity"], 1.0, atol=1e-5)


def test_eval_scores_the_reference_rewards_against_a_store(tmp_path, monkeypatch):
    """cli.eval routes siglip_image_similarity and constractive_external to
    the reference store (NEEDS_REFS); with one they score."""
    from tests.test_torch_eval_cli import ALPHA, RANK, TMMDiTConfig, TSD3Pipeline, TVAEConfig
    from tests.test_torch_models import jax_tiny_pipeline

    jpipe = jax_tiny_pipeline(2, lora_rank=RANK, lora_alpha=ALPHA)
    monkeypatch.setattr(t_common, "build_pipeline", lambda *a, **k: TSD3Pipeline.from_jax(
        jpipe.transformer_params, jpipe.vae_params,
        TMMDiTConfig.tiny(lora_rank=RANK, lora_alpha=ALPHA),
        TVAEConfig.tiny(latent_channels=16), "cpu", text_seq_len=6))
    (tmp_path / "refs.json").write_text("{}")  # every prompt takes the fallback frame
    out = t_eval.main([
        "--config", "eval_sd3_fast", "--out_dir", str(tmp_path / "out"), "--device", "cpu",
        "--limit", "2", "--batch", "2", "--rewards", "--latent_hw", "8",
        "--set", "smoke_test=True", "--set", "pretrained.model=", "--set",
        "sample.eval_num_steps=2", "--set", "resolution=32",
        "--set", "eval_reward_fn={'siglip_image_similarity': 1.0, 'constractive_external': 1.0}",
        "--set", f"json_path={tmp_path / 'refs.json'}",
        "--set", f"test_reference_image_path={tmp_path}"])
    assert set(out["reward_counts"]) == {"avg", "siglip_image_similarity",
                                         "constractive_external"}
    assert all(c == 2 for c in out["reward_counts"].values())
    assert all(np.isfinite(v) for v in out["reward_means"].values())
