"""The port's BLIP text encoder, ImageReward and BERT tokenizer against the
JAX package and ``transformers``, on the CPU.

Numpy inputs from a seed go through both packages in fp32 at tiny widths (a
2-layer med-BERT of 32 in 2 heads cross-attending to a 2-layer ViT of 32 at
28^2 in patches of 14); the JAX parameters (random, from a PRNG key) are
carried to the port by ``imagereward_state_dict_from_jax``. The images are
at the ViT's resolution, where the PIL resize is the identity.

Covered: the text encoder with and without image tokens, with a padding
mask; ``ImageRewardModel.score``; the ImageReward checkpoint written in its
own names (``chip_smoke.imagereward_pt_state_dict``) read back by
``imagereward_state_dict_from_pt`` (bitwise) and by the JAX
``convert_imagereward`` (the scores), its strictness; the native
``ImageRewardScorer`` from ``IMAGEREWARD_PT`` and ``BERT_TOKENIZER_DIR``
against the JAX scorer's native scoring (``transformers.BertTokenizer`` and
the JAX model) and both ``imagereward`` rewards of ``multi_score``;
``blip_text_state_dict_from_hf`` against ``transformers.BlipTextModel`` with
and without cross-attention; ``BertTokenizer`` id for id (and its mask)
against ``transformers.BertTokenizer`` on vocabularies written by
``chip_smoke.write_bert_tokenizer`` and by ``save_pretrained``, with
accents, CJK, punctuation, control characters, a word over 100 characters,
``[DEC]`` / ``[ENC]``, special tokens in the text, upper case and
truncation at 35; the refusals.

Bounds: 1e-5 absolute (fp32, sums in another order); ids exactly.
"""

import os

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from adv_grpo_torch.data.tokenizers import BertTokenizer
from adv_grpo_torch.models import blip as t_blip
from adv_grpo_torch.models.convert import (
    blip_text_state_dict_from_hf, imagereward_state_dict_from_jax,
    imagereward_state_dict_from_pt)
from adv_grpo_torch.rewards import vlm as t_vlm
from adv_grpo_torch.rewards.registry import RewardContext as TRewardContext
from adv_grpo_torch.rewards.registry import multi_score as t_multi_score
from adv_grpo_tpu.models import blip as j_blip
from adv_grpo_tpu.models import convert as j_convert
from adv_grpo_tpu.models.vit import ViTConfig as JViTConfig
from adv_grpo_tpu.rewards import vlm as j_vlm
from adv_grpo_tpu.rewards.registry import RewardContext as JRewardContext
from adv_grpo_tpu.rewards.registry import multi_score as j_multi_score
from chip_smoke import imagereward_pt_state_dict, write_bert_tokenizer

ATOL = 1e-5
SIZE = 28
VIT = dict(image_size=SIZE, patch_size=14, hidden_size=32, intermediate_size=64, num_layers=2,
           num_heads=2)
WORDS = (["a", "red", "bicycle", "flower", "city", "at", "night", "the", "of", "un", "##aff",
          "##able", "cafe", "naive", "photo", "##graph", "##s", "我", "爱", "東", "京", ",", ".",
          "!", "'", "-", "(", ")", "$", "σας", "##σ", "i", "##stanbul", "x", "##x"]
         + [chr(c) for c in range(ord("a"), ord("z") + 1)])
PROMPTS = ["A red bicycle, at night!", "Café naïve — photographs", "我爱東京 city",
           "unaffable (the) $cafe's", "a\tflower\n of\x00 the​ citý",
           "x" * 101 + " flower", "[DEC] a flower [ENC] at [CLS] night[SEP]", "",
           "ΣΑΣ İstanbul", " ".join(["flower"] * 40), "Un-Affable, UNAFFABLE. unaffable!"]


def _images(seed, n=2):
    return np.random.default_rng(seed).uniform(-1, 1, (n, 3, SIZE, SIZE)).astype(np.float32)


def _random_prompts(seed, n=40):
    rng = np.random.default_rng(seed)
    chars = list("abcxyz ABC.,!'-$ éüñ我爱京\t\n") + ["##", "[DEC]", "[ENC]", "[cls]", "[MASK]"]
    return ["".join(rng.choice(chars, rng.integers(0, 30))) for _ in range(n)]


@pytest.fixture(scope="module")
def tokenizer_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("bert"))
    write_bert_tokenizer(d, WORDS)
    return d


@pytest.fixture(scope="module")
def ir(tokenizer_dir):
    text_cfg = j_blip.BlipTextConfig.tiny(encoder_width=32, vocab_size=len(
        open(os.path.join(tokenizer_dir, "vocab.txt")).readlines()) + 2,
        max_position_embeddings=40)
    vision_cfg = JViTConfig(layer_norm_eps=1e-6, use_pre_ln=False, layer_scale_init=None,
                            projection_dim=None, **VIT)
    jm = j_blip.ImageRewardModel(text_cfg, vision_cfg, image_size=SIZE)
    params = jax.tree_util.tree_map(np.asarray, jax.device_get(
        jm.init_params(jax.random.PRNGKey(0))))
    t_text = t_blip.BlipTextConfig.tiny(encoder_width=32, vocab_size=text_cfg.vocab_size,
                                        max_position_embeddings=40)
    t_vision = t_blip.blip_vit_l16(SIZE, **{k: v for k, v in VIT.items() if k != "image_size"})
    tm = t_blip.ImageRewardModel(t_text, t_vision, SIZE)
    tm.load_state_dict(imagereward_state_dict_from_jax(params, t_text, t_vision))
    ids, mask = BertTokenizer(tokenizer_dir)(["a red flower at night", "the city"], 35)
    return dict(jm=jm, params=params, tm=tm.eval(), t_text=t_text, t_vision=t_vision,
                ids=ids, mask=mask)


def test_text_encoder_matches_jax(ir):
    tokens = np.random.default_rng(1).standard_normal((2, 5, 32)).astype(np.float32)
    jtext = j_blip.BlipTextEncoder(ir["jm"].text_cfg)
    for image_tokens in (tokens, None):
        want = jtext.apply({"params": ir["params"]["text"]}, ir["ids"], ir["mask"].astype(bool),
                           image_tokens)
        with torch.no_grad():
            got = ir["tm"].text(torch.from_numpy(ir["ids"]), torch.from_numpy(ir["mask"]).bool(),
                                None if image_tokens is None else torch.from_numpy(image_tokens))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_imagereward_score_matches_jax(ir):
    images = _images(2)
    want = ir["jm"].score(ir["params"], images, ir["ids"], ir["mask"].astype(bool))
    got = ir["tm"].score(images, ir["ids"], ir["mask"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.fixture(scope="module")
def checkpoint(ir, tmp_path_factory):
    """The tiny model in ImageReward.pt's names, with BLIP's ITC projections."""
    sd = imagereward_pt_state_dict(ir["tm"].state_dict())
    sd["blip.vision_proj.weight"] = torch.zeros(4, 32)
    sd["blip.text_proj.weight"] = torch.zeros(4, 32)
    path = str(tmp_path_factory.mktemp("ir") / "ImageReward.pt")
    torch.save(sd, path)
    return path, sd


def test_checkpoint_converts_back_bitwise_and_as_the_jax_converter_reads_it(ir, checkpoint):
    path, sd = checkpoint
    model = t_vlm.load_imagereward(path, "cpu", ir["t_text"], ir["t_vision"])
    want = ir["tm"].state_dict()
    assert all(torch.equal(model.state_dict()[k], want[k]) for k in want)
    jparams = j_convert.convert_imagereward({k: v.float().numpy() for k, v in sd.items()},
                                            text_layers=2, vision_layers=2)
    images = _images(3)
    np.testing.assert_allclose(
        model.score(images, ir["ids"], ir["mask"]).numpy(),
        np.asarray(ir["jm"].score(jparams, images, ir["ids"], ir["mask"].astype(bool))),
        atol=ATOL)
    with pytest.raises(ValueError, match="not consumed"):
        imagereward_state_dict_from_pt({**sd, "blip.itm_head.weight": torch.zeros(2, 32)},
                                       ir["t_text"], ir["t_vision"])


def test_native_scorer_and_reward_match_jax(ir, checkpoint, tokenizer_dir, monkeypatch):
    """The port's native path from the files against the JAX scorer's native
    scoring (``_make_native``'s steps on the tiny JAX model, its tokens
    from ``transformers.BertTokenizer``)."""
    transformers = pytest.importorskip("transformers")
    hf_tok = transformers.BertTokenizer.from_pretrained(tokenizer_dir)

    def jax_score_fn(prompt, pil_images):
        ids = hf_tok([prompt], padding="max_length", truncation=True, max_length=35,
                     return_tensors="np")
        imgs = np.stack([np.asarray(im, np.float32).transpose(2, 0, 1) / 255.0 * 2.0 - 1.0
                         for im in pil_images])
        n = len(pil_images)
        return np.asarray(ir["jm"].score(ir["params"], imgs,
                                         np.repeat(ids.input_ids, n, 0),
                                         np.repeat(ids.attention_mask, n, 0).astype(bool)))

    monkeypatch.setenv("BERT_TOKENIZER_DIR", tokenizer_dir)
    ts = t_vlm.ImageRewardScorer(model_path=checkpoint[0], device="cpu",
                                 text_cfg=ir["t_text"], vision_cfg=ir["t_vision"])
    js = j_vlm.ImageRewardScorer(score_fn=jax_score_fn)
    images = _images(4, n=3)
    prompts = ["a red flower", "Café at night", "我爱東京"]
    names = {"imagereward": 1.5, "jpeg_compressibility": 0.1}
    want, _ = j_multi_score(names, JRewardContext(remote={
        "imagereward": lambda u8, p, m=None: js(u8, p)}))(images, prompts)
    got, _ = t_multi_score(names, TRewardContext(remote={
        "imagereward": lambda u8, p, m=None: ts(u8, p)}))(images, prompts)
    for key in ("imagereward", "avg"):
        np.testing.assert_allclose(got[key], want[key], atol=ATOL)


def test_native_scorer_needs_its_files(monkeypatch):
    monkeypatch.delenv("IMAGEREWARD_PT", raising=False)
    monkeypatch.delenv("BERT_TOKENIZER_DIR", raising=False)
    with pytest.raises(RuntimeError, match="IMAGEREWARD_PT"):
        t_vlm.ImageRewardScorer(device="cpu")


@pytest.mark.parametrize("cross", [True, False])
def test_hf_text_converter_matches_transformers(cross):
    transformers = pytest.importorskip("transformers")
    cfg = transformers.BlipTextConfig(
        vocab_size=50, hidden_size=32, encoder_hidden_size=24, intermediate_size=64,
        num_hidden_layers=2, num_attention_heads=2, max_position_embeddings=16,
        layer_norm_eps=1e-12, hidden_act="gelu", is_decoder=cross)
    torch.manual_seed(0)
    model = transformers.BlipTextModel(cfg).eval()
    with torch.no_grad():
        for p in model.parameters():
            p.normal_(0.0, 0.3)
    rng = np.random.default_rng(2)
    ids = torch.from_numpy(rng.integers(0, 50, (2, 7)))
    mask = torch.ones(2, 7, dtype=torch.long)
    mask[1, 4:] = 0
    image = torch.from_numpy(rng.standard_normal((2, 5, 24)).astype(np.float32))
    with torch.no_grad():
        want = model(input_ids=ids, attention_mask=mask,
                     encoder_hidden_states=image if cross else None).last_hidden_state
    tcfg = t_blip.BlipTextConfig.tiny()
    enc = t_blip.BlipTextEncoder(tcfg, cross_attention=cross)
    enc.load_state_dict(blip_text_state_dict_from_hf(model.state_dict(), tcfg))
    with torch.no_grad():
        got = enc(ids, mask.bool(), image if cross else None)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL)


def _hf_bert(directory):
    transformers = pytest.importorskip("transformers")
    return transformers.BertTokenizer.from_pretrained(directory)


def _check_ids(directory, prompts):
    hf, ours = _hf_bert(directory), BertTokenizer(directory)
    want = hf(prompts, padding="max_length", truncation=True, max_length=35, return_tensors="np")
    ids, mask = ours(prompts, 35)
    for p, row, w in zip(prompts, ids, want.input_ids):
        assert row.tolist() == w.tolist(), p
    np.testing.assert_array_equal(mask, want.attention_mask)


def test_bert_tokenizer_matches_transformers(tokenizer_dir):
    tok = BertTokenizer(tokenizer_dir)
    assert tok.added.ids["[DEC]"] == len(tok.vocab) and tok.added.ids["[ENC]"] == len(tok.vocab) + 1
    _check_ids(tokenizer_dir, PROMPTS + _random_prompts(0))


@pytest.mark.parametrize("options", [dict(do_lower_case=False), dict(strip_accents=False),
                                     dict(do_lower_case=False, strip_accents=True),
                                     dict(tokenize_chinese_chars=False)])
def test_bert_tokenizer_options_match_transformers(tokenizer_dir, tmp_path, options):
    """A directory ``save_pretrained`` writes, with its options."""
    transformers = pytest.importorskip("transformers")
    words = WORDS + ["Café", "A", "B", "##É", "City"]
    with open(tmp_path / "vocab.txt", "w", encoding="utf-8") as f:
        f.write("".join(w + "\n" for w in open(os.path.join(tokenizer_dir, "vocab.txt"),
                                               encoding="utf-8").read().split("\n")[:-1]
                        + words))
    hf = transformers.BertTokenizer(str(tmp_path / "vocab.txt"), **options)
    hf.add_special_tokens({"bos_token": "[DEC]"})
    hf.add_special_tokens({"additional_special_tokens": ["[ENC]"]})
    hf.save_pretrained(str(tmp_path / "saved"))
    _check_ids(str(tmp_path / "saved"), PROMPTS + _random_prompts(1, 20))


def test_bert_tokenizer_from_a_bare_vocab(tokenizer_dir, tmp_path):
    """vocab.txt alone: the default special tokens, lower case."""
    with open(tmp_path / "vocab.txt", "w", encoding="utf-8") as f:
        f.write(open(os.path.join(tokenizer_dir, "vocab.txt"), encoding="utf-8").read())
    _check_ids(str(tmp_path), PROMPTS)


def test_bert_tokenizer_refuses_what_it_does_not_implement(tokenizer_dir, tmp_path):
    transformers = pytest.importorskip("transformers")
    hf = transformers.BertTokenizer(os.path.join(tokenizer_dir, "vocab.txt"))
    hf.add_tokens(["newword"])
    hf.save_pretrained(str(tmp_path / "a"))
    with pytest.raises(NotImplementedError, match="non-special added token 'newword'"):
        BertTokenizer(str(tmp_path / "a"))
    os.makedirs(tmp_path / "b")
    (tmp_path / "b" / "vocab.txt").write_text("[PAD]\n[UNK]\n")
    (tmp_path / "b" / "added_tokens.json").write_text('{"[DEC]": 2}')
    with pytest.raises(NotImplementedError, match="added_tokens.json"):
        BertTokenizer(str(tmp_path / "b"))
    (tmp_path / "b" / "tokenizer_config.json").write_text('{"do_basic_tokenize": false}')
    with pytest.raises(NotImplementedError, match="do_basic_tokenize"):
        BertTokenizer(str(tmp_path / "b"))


def test_imagereward_pil_round_trip_is_the_uint8_grid(ir):
    """The scorer reads the uint8 copy as PIL images: its score is the
    model's on those uint8 levels mapped back to [-1, 1]."""
    u8 = np.random.default_rng(5).integers(0, 256, (2, SIZE, SIZE, 3), dtype=np.uint8)
    fn = t_vlm.imagereward_score_fn(ir["tm"], lambda prompts, n: (ir["ids"][:1], ir["mask"][:1]))
    got = fn("x", [Image.fromarray(a) for a in u8])
    want = ir["tm"].score(u8.transpose(0, 3, 1, 2).astype(np.float32) / 255.0 * 2.0 - 1.0,
                          np.repeat(ir["ids"][:1], 2, 0), np.repeat(ir["mask"][:1], 2, 0))
    np.testing.assert_array_equal(got, want.numpy())
