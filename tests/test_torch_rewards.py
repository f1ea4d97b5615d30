"""The port's CLIP-L score, LAION aesthetic score and OCR rewards against the
JAX package, on the CPU, and the ``pickscore_sd3_fast`` preset they serve.

The towers are the JAX package's smoke towers (text and vision 2 layers of
32 at 28^2; the aesthetic tower projecting to 768) with random weights from
a PRNG key, carried to the port by ``clip_dual_state_dict_from_jax`` /
``vit_state_dict_from_jax``; the aesthetic head is the repository's
published ``sac+logos+ava1-l14-linearMSE.pth``, read by both packages'
converters. The OCR engine is a plain function of the image, injected into
both packages (PaddleOCR is on neither machine). Bounds: scores 1e-5
absolute (fp32, sums in another order); the head's converters, the edit
distance, the OCR rewards and the preset exactly.
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adv_grpo_torch.cli import common as t_common
from adv_grpo_torch.cli import train as t_train
from adv_grpo_torch.models import convert as t_convert
from adv_grpo_torch.models.clip_text import CLIPTextConfig as TTextConfig
from adv_grpo_torch.models.clip_text import activation
from adv_grpo_torch.models.vit import ViTConfig as TViTConfig
from adv_grpo_torch.rewards import host as t_host
from adv_grpo_torch.rewards.preprocess import CLIP_MEAN, CLIP_STD, preprocess
from adv_grpo_torch.rewards.registry import RewardContext as TRewardContext
from adv_grpo_torch.rewards.registry import multi_score as t_multi_score
from adv_grpo_torch.rewards.scorers import AestheticScorer as TAesthetic
from adv_grpo_torch.rewards.scorers import CLIPScorer as TCLIPScorer
from adv_grpo_torch.utils import safetensors_io
from adv_grpo_torch.utils.images import images_to_uint8
from adv_grpo_tpu.cli import common as j_common
from adv_grpo_tpu.models import convert as j_convert
from adv_grpo_tpu.models.clip_text import CLIPTextConfig as JTextConfig
from adv_grpo_tpu.models.vit import ViTConfig as JViTConfig
from adv_grpo_tpu.models.vit import _act as j_act
from adv_grpo_tpu.native.lib import levenshtein as j_levenshtein
from adv_grpo_tpu.rewards import host as j_host
from adv_grpo_tpu.rewards.registry import RewardContext as JRewardContext
from adv_grpo_tpu.rewards.registry import multi_score as j_multi_score
from adv_grpo_tpu.rewards.scorers import AestheticScorer as JAesthetic
from adv_grpo_tpu.rewards.scorers import CLIPScorer as JCLIPScorer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AESTHETIC_PTH = os.path.join(REPO, "adv_grpo_tpu", "data", "assets",
                             "sac+logos+ava1-l14-linearMSE.pth")
ATOL = 1e-5


def _images(seed, n=3, hw=64):
    return np.random.default_rng(seed).uniform(-1, 1, (n, 3, hw, hw)).astype(np.float32)


def _tokenize(prompts):
    return np.full((len(prompts), 16), 3, np.int32)


def engine(img_u8):
    """A stand-in OCR engine: text read off the image's mean (deterministic,
    so both packages see the same text for the same uint8 image)."""
    m = int(np.asarray(img_u8, np.int64).sum()) % 7
    return ["", "hello", "HELLO world", "hel lo", "xhellox", "héllo", "zzzz"][m]


def _clip_towers(hidden_act="quick_gelu"):
    tcfg = (TTextConfig.tiny(projection_dim=16),
            TViTConfig.tiny(projection_dim=16, hidden_act=hidden_act))
    jcfg = (JTextConfig.tiny(projection_dim=16),
            JViTConfig.tiny(projection_dim=16, hidden_act=hidden_act))
    return tcfg, jcfg


def _clip_pair(hidden_act="quick_gelu", seed=0):
    (ttext, tvis), (jtext, jvis) = _clip_towers(hidden_act)
    js = JCLIPScorer(jtext, jvis, image_size=28)
    params = jax.device_get(js.init_params(jax.random.PRNGKey(seed)))
    ts = TCLIPScorer.from_state_dict(
        t_convert.clip_dual_state_dict_from_jax(params, ttext, tvis), "cpu", ttext, tvis, 28)
    return js, params, ts


def _pth():
    return torch.load(AESTHETIC_PTH, map_location="cpu", weights_only=True)


def _aesthetic_pair(seed=1):
    js = JAesthetic(JViTConfig.tiny(projection_dim=768), image_size=28)
    params = jax.device_get(js.init_params(jax.random.PRNGKey(seed)))
    params["head"] = j_convert.convert_aesthetic_mlp({k: v.numpy() for k, v in _pth().items()})
    vcfg = TViTConfig.tiny(projection_dim=768)
    ts = TAesthetic.from_state_dicts(t_convert.vit_state_dict_from_jax(params["vision"], vcfg),
                                     t_convert.aesthetic_state_dict_from_pth(_pth()), "cpu",
                                     vcfg, 28)
    return js, params, ts


def test_clip_l_widths_and_quick_gelu():
    """``ViTConfig.clip_l`` is the JAX config field for field; its activation
    is x * sigmoid(1.702 x), as the JAX tower's."""
    want = {k: v for k, v in JViTConfig.clip_l().__dict__.items() if k != "dtype"}
    assert TViTConfig.clip_l().__dict__ == want
    assert (TViTConfig.clip_l().projection_dim, TViTConfig.clip_l().hidden_act) == (768,
                                                                                    "quick_gelu")
    x = np.linspace(-6, 6, 101, dtype=np.float32)
    got = activation("quick_gelu")(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, x / (1 + np.exp(-1.702 * x)), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got, np.asarray(j_act("quick_gelu")(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("hidden_act", ["quick_gelu", "gelu"])
def test_clip_scorer_matches_jax(hidden_act):
    """``score`` = exp(logit_scale) * cos / 30 and ``image_similarity`` = the
    cosine of the image features: end to end at the tower's 28^2, and at
    64^2 from the same preprocessed pixels (a resized pixel at a uint8
    rounding tie may land one level apart in the two packages,
    tests/test_torch_clip.py::test_preprocess_matches_jax, and one level
    moves these tiny towers' scores by ~1e-4)."""
    from adv_grpo_tpu.rewards.scorers import _l2norm

    js, params, ts = _clip_pair(hidden_act)
    a, b, ids = _images(0, hw=28), _images(1, hw=28), _tokenize(["a", "b", "c"])
    want = np.asarray(js.score(params, jnp.asarray(a), jnp.asarray(ids)))
    np.testing.assert_allclose(ts.score(a, ids).numpy(), want, atol=ATOL)
    want_sim = np.asarray(js.image_similarity(params, jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(ts.image_similarity(a, b).numpy(), want_sim, atol=ATOL)
    np.testing.assert_allclose(ts.image_similarity(a, a).numpy(), 1.0, atol=1e-6)
    big = _images(2, hw=64)
    pix = preprocess(torch.from_numpy(big), 28, CLIP_MEAN, CLIP_STD)
    img = _l2norm(js.clip.image_features(params, jnp.asarray(pix.numpy())))
    txt = _l2norm(js.clip.text_features(params, jnp.asarray(ids)))
    want = np.exp(params["logit_scale"]) * np.asarray(jnp.sum(img * txt, axis=-1)) / 30.0
    np.testing.assert_allclose(ts.score(big, ids).numpy(), want, atol=ATOL)


def test_aesthetic_head_reads_the_repository_pth_through_both_converters():
    """The port's ``.pth`` converter and its ``_from_jax`` carrier of the JAX
    ``convert_aesthetic_mlp`` tree give the same state dict, bitwise; a
    leftover or a missing weight raises."""
    sd = _pth()
    got = t_convert.aesthetic_state_dict_from_pth(sd)
    carried = t_convert.aesthetic_head_state_dict_from_jax(
        j_convert.convert_aesthetic_mlp({k: v.numpy() for k, v in sd.items()}))
    assert set(got) == set(carried) == {f"{m}.{p}" for m in ("fc0", "fc1", "fc2", "fc3", "out")
                                        for p in ("weight", "bias")}
    for k in got:
        assert got[k].dtype == torch.float32 and torch.equal(got[k], carried[k]), k
    with pytest.raises(ValueError, match="not consumed"):
        t_convert.aesthetic_state_dict_from_pth({**sd, "layers.1.weight": torch.zeros(1)})
    with pytest.raises(KeyError, match="layers.7.bias"):
        t_convert.aesthetic_state_dict_from_pth({k: v for k, v in sd.items()
                                                 if k != "layers.7.bias"})


def test_aesthetic_scorer_matches_jax():
    """The tiny tower (projection 768) and the published head: the head
    L2-normalises, then four Linear layers with no activation between them
    and the output layer."""
    js, params, ts = _aesthetic_pair()
    images = _images(2, n=4)
    want = np.asarray(js.score(params, jnp.asarray(images)))
    got = ts.score(images)
    assert got.shape == (4,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    emb = torch.randn(2, 768, generator=torch.Generator().manual_seed(0))
    x = emb / emb.norm(dim=-1, keepdim=True)
    for m in (ts.head.fc0, ts.head.fc1, ts.head.fc2, ts.head.fc3, ts.head.out):
        x = m(x)
    torch.testing.assert_close(ts.head(emb), x.squeeze(-1), rtol=0, atol=0)


def _hf_clip_sd(text_projection, vision_projection, seed):
    """A random HF ``CLIPModel`` state dict at the smoke towers (through the
    port's ``CLIPDualEncoder`` names; chip_smoke writes real checkpoints the
    same way)."""
    from adv_grpo_torch.rewards.scorers import CLIPDualEncoder
    from chip_smoke import hf_clip_model_state_dict

    clip = CLIPDualEncoder(TTextConfig.tiny(projection_dim=text_projection),
                           TViTConfig.tiny(projection_dim=vision_projection))
    clip.init_params_(torch.Generator().manual_seed(seed))
    with torch.no_grad():
        for n, p in clip.named_parameters():
            if n.endswith("bias"):  # non-zero, so the mapping of every bias is tested
                p.normal_(0, 0.05, generator=torch.Generator().manual_seed(len(n)))
    return hf_clip_model_state_dict(clip.state_dict())


def test_clip_vision_converter_matches_jax():
    """``clip_vision_state_dict_from_hf`` equals the JAX ``convert_clip_vision``
    (carried by ``vit_state_dict_from_jax``) bitwise, from a whole
    ``CLIPModel`` and from its vision tower alone; any other leftover raises."""
    hf = _hf_clip_sd(768, 768, 3)
    vcfg = TViTConfig.tiny(projection_dim=768)
    want = t_convert.vit_state_dict_from_jax(
        j_convert.convert_clip_vision({k: v.numpy() for k, v in hf.items()}, 2), vcfg)
    vision_only = {k: v for k, v in hf.items() if k.startswith("vision_model.")
                   or k == "visual_projection.weight"}
    for sd in (hf, vision_only):
        got = t_convert.clip_vision_state_dict_from_hf(sd, vcfg)
        assert set(got) == set(want)
        assert all(torch.equal(got[k].float(), want[k]) for k in want)
    with pytest.raises(ValueError, match="not consumed"):
        t_convert.clip_vision_state_dict_from_hf({**hf, "extra.weight": torch.zeros(1)}, vcfg)


def _contexts():
    js, cparams, ts = _clip_pair()
    ja, aparams, ta = _aesthetic_pair()
    jctx = JRewardContext(clip=js, clip_params=cparams, aesthetic=ja, aesthetic_params=aparams,
                          tokenize=_tokenize, ocr=j_host.OcrScorer(engine))
    tctx = TRewardContext(clip=ts, aesthetic=ta, tokenize=_tokenize,
                          ocr=t_host.OcrScorer(engine))
    return jctx, tctx


def test_multi_score_serves_the_new_rewards_like_jax():
    """``clipscore``, ``aesthetic`` and ``ocr`` in one ensemble, the same
    injected engine on both sides: each score and the weighted ``avg``."""
    jctx, tctx = _contexts()
    weights = {"clipscore": 0.3, "aesthetic": 0.2, "ocr": 0.5}
    images = _images(4, n=6, hw=32)
    prompts = ['a sign "hello"', 'a sign "Hello World"', "no quotes here", 'say "héllo"',
               'a "zz" mark', 'a shirt "HELLO"']
    want, _ = j_multi_score(weights, jctx)(jnp.asarray(images), prompts)
    got, meta = t_multi_score(weights, tctx)(images, prompts)
    assert meta == {} and set(got) == set(want) == set(weights) | {"avg"}
    np.testing.assert_array_equal(got["ocr"], want["ocr"])
    for k in ("clipscore", "aesthetic", "avg"):
        np.testing.assert_allclose(got[k], want[k], atol=ATOL, err_msg=k)
    assert len(set(got["ocr"].tolist())) > 2  # the engine's texts give several rewards


def test_multi_score_video_ocr_matches_jax():
    """``video_ocr`` on (B, F, 3, H, W) clips: every 4th frame, the clip's mean."""
    ctxs = (JRewardContext(ocr=j_host.VideoOcrScorer(engine)),
            TRewardContext(ocr=t_host.VideoOcrScorer(engine)))
    video = np.random.default_rng(5).uniform(-1, 1, (3, 9, 3, 16, 16)).astype(np.float32)
    prompts = ['a "hello" sign', 'a "zzzz" sign', "unquoted"]
    want, _ = j_multi_score({"video_ocr": 1.0}, ctxs[0])(video, prompts)
    got, _ = t_multi_score({"video_ocr": 1.0}, ctxs[1])(torch.from_numpy(video), prompts)
    np.testing.assert_array_equal(got["video_ocr"], want["video_ocr"])
    assert got["video_ocr"][2] == 0.0


def _random_strings(rng, n):
    alphabet = list("abcABC xyz") + ["é", "ß", "中", "文", "🙂", "Ω"]
    return ["".join(rng.choice(alphabet, size=rng.integers(0, 9))) for _ in range(n)]


def test_levenshtein_counts_utf8_bytes_like_jax():
    rng = np.random.default_rng(6)
    pairs = list(zip(_random_strings(rng, 200), _random_strings(rng, 200)))
    pairs += [("", ""), ("é", "e"), ("中文", "中"), ("kitten", "sitting")]
    for a, b in pairs:
        assert t_host.levenshtein(a, b) == j_levenshtein(a, b), (a, b)
    assert t_host.levenshtein("é", "e") == 2  # bytes: c3 a9 against 65
    assert t_host.levenshtein("kitten", "sitting") == 3


def test_ocr_reward_from_text_matches_jax():
    rng = np.random.default_rng(7)
    texts, targets = _random_strings(rng, 200), _random_strings(rng, 200)
    pairs = list(zip(texts, targets)) + [("hello world", "Hello World"), ("xhellox", "hello"),
                                         ("helXo", "hello"), ("zzzzzzzzzzzz", "hi"),
                                         ("anything", " "), ("中文字", "中文")]
    for text, target in pairs:
        assert t_host.ocr_reward_from_text(text, target) == \
            j_host.ocr_reward_from_text(text, target), (text, target)


def test_ocr_scorer_matches_jax_and_penalises_failures():
    """uint8 HWC and float CHW images; an unquoted prompt and an engine that
    raises both score 0.0."""
    def flaky(img):
        if int(np.asarray(img).sum()) % 3 == 0:
            raise RuntimeError("engine failure")
        return engine(img)

    images = _images(8, n=8, hw=16)
    prompts = [f'a "{w}" sign' for w in ("hello", "HELLO", "hi", "zz", "hé")] + [
        "none", 'x "" y', 'open "quote']
    for eng in (engine, flaky):
        want = j_host.OcrScorer(eng)(images, prompts)
        got = t_host.OcrScorer(eng)(images, prompts)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(t_host.OcrScorer(eng)(images_to_uint8(images), prompts),
                                      want)
    assert t_host.OcrScorer(engine)(images[:1], ["no quote"])[0] == 0.0


def test_no_engine_raises_the_jax_error(monkeypatch):
    monkeypatch.setitem(sys.modules, "paddleocr", None)  # not importable
    errors = []
    for scorer in (j_host.OcrScorer(), t_host.OcrScorer(), j_host.VideoOcrScorer(),
                   t_host.VideoOcrScorer()):
        with pytest.raises(RuntimeError) as info:
            scorer(np.zeros((1, 1, 8, 8, 3), np.uint8) if "Video" in type(scorer).__name__
                   else np.zeros((1, 8, 8, 3), np.uint8), ['a "b"'])
        errors.append(str(info.value))
    assert len(set(errors)) == 1 and errors[0].startswith("No OCR engine available")


def _configs(names_preset="pickscore_sd3_fast", *overrides):
    from adv_grpo_tpu.cli.common import apply_overrides as j_apply
    from adv_grpo_tpu.cli.common import resolve_config as j_resolve

    overrides = ["smoke_test=True", *overrides]
    return (t_common.apply_overrides(t_common.resolve_config(names_preset), overrides),
            j_apply(j_resolve(names_preset), overrides))


def _write(directory, sd):
    os.makedirs(directory, exist_ok=True)
    safetensors_io.save_file({k: v.contiguous() for k, v in sd.items()},
                             os.path.join(directory, "model.safetensors"))
    return str(directory)


def test_reward_context_builds_clip_l_aesthetic_and_ocr(monkeypatch, tmp_path):
    """smoke_test: the JAX package's tiny towers at 28^2 (the aesthetic one
    projecting to 768), constant token ids 3 at 16; the OCR scorer takes the
    engine it is given (the video one for ``video_ocr``)."""
    for env in ("CLIP_DIR", "AESTHETIC_PATH"):
        monkeypatch.delenv(env, raising=False)
    cfg, _ = _configs()
    ctx = t_common.build_reward_context(cfg, {"clipscore", "aesthetic", "ocr"}, device="cpu",
                                        ocr_engine=engine)
    assert ctx.clip.image_size == ctx.aesthetic.image_size == 28
    assert ctx.clip.clip.vision_model.cfg == TViTConfig.tiny(projection_dim=16)
    assert ctx.aesthetic.vision_cfg == TViTConfig.tiny(projection_dim=768)
    np.testing.assert_array_equal(ctx.tokenize(["a", "b"]), np.full((2, 16), 3, np.int32))
    assert type(ctx.ocr) is t_host.OcrScorer and ctx.ocr.engine is engine
    video = t_common.build_reward_context(cfg, {"video_ocr"}, device="cpu", ocr_engine=engine)
    assert type(video.ocr) is t_host.VideoOcrScorer and video.clip is None
    # AESTHETIC_PATH alone leaves both random (the JAX package loads them together)
    monkeypatch.setenv("AESTHETIC_PATH", AESTHETIC_PTH)
    alone = t_common.build_reward_context(cfg, {"aesthetic"}, device="cpu")
    assert all(torch.equal(v, ctx.aesthetic.head.state_dict()[k])
               for k, v in alone.aesthetic.head.state_dict().items())


def test_reward_context_loads_clip_dir_and_aesthetic_path_like_jax(monkeypatch, tmp_path):
    """``CLIP_DIR`` (an HF ``CLIPModel`` directory) for ``clipscore``; with
    ``AESTHETIC_PATH`` (the repository's ``.pth``) for ``aesthetic``: the
    scores of both packages' contexts agree."""
    images, prompts = _images(9, n=4), ["a", "b", "c", "d"]
    for proj, name in ((16, "clipscore"), (768, "aesthetic")):
        monkeypatch.setenv("CLIP_DIR", _write(tmp_path / name, _hf_clip_sd(proj, proj, 11)))
        monkeypatch.setenv("AESTHETIC_PATH", AESTHETIC_PTH)
        tcfg, jcfg = _configs()
        tctx = t_common.build_reward_context(tcfg, {name}, device="cpu")
        jctx = j_common.build_reward_context(jcfg, {name})
        want, _ = j_multi_score({name: 1.0}, jctx)(jnp.asarray(images), prompts)
        got, _ = t_multi_score({name: 1.0}, tctx)(images, prompts)
        np.testing.assert_allclose(got[name], want[name], atol=ATOL, err_msg=name)
    head = tctx.aesthetic.head.state_dict()
    assert all(torch.equal(v, head[k]) for k, v in
               t_convert.aesthetic_state_dict_from_pth(_pth()).items())


def _ocr_dataset(directory, n=8):
    """A train split of the repository's OCR prompts (``dataset/ocr`` holds
    only its test split)."""
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(REPO, "dataset", "ocr", "test.txt")) as f:
        lines = [line for line in f.read().splitlines() if line.strip()][:n]
    for split in ("train", "test"):
        with open(os.path.join(directory, f"{split}.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")
    return str(directory)


def test_pickscore_sd3_fast_trains_with_an_injected_engine(tmp_path):
    """One epoch of the preset on the tiny SD3 and towers: PickScore and OCR
    scored per image (the OCR reward on the prompts' quoted spans), the
    policy updated."""
    seen = []

    def recording_engine(img):
        seen.append(img.shape)
        return engine(img)

    argv = ["--config", "pickscore_sd3_fast", "--device", "cpu", "--latent_hw", "8",
            "--max_epochs", "1", "--set", "smoke_test=True", "--set", "pretrained.model=",
            "--set", f"dataset={_ocr_dataset(tmp_path / 'ocr')}",
            "--set", "sample.num_steps=3", "--set", "sample.eval_num_steps=3",
            "--set", "sample.num_image_per_prompt=4", "--set", "sample.mini_num_image_per_prompt=2",
            "--set", "sample.train_batch_size=2", "--set", "sample.num_batches_per_epoch=2",
            "--set", "train.batch_size=2", "--set", "train.gradient_accumulation_steps=1",
            "--set", "wandb_init=False", "--set", f"save_dir={tmp_path / 'run'}"]
    trainer = t_train.main(argv, ocr_engine=recording_engine)
    assert trainer.reward_ctx.ocr.engine is recording_engine
    assert len(seen) == 2 * 4 and seen[0] == (16, 16, 3)  # 2 batches of 4 images
    (record,) = [json.loads(line) for line in (tmp_path / "run" / "metrics.jsonl").open()]
    for k in ("reward_avg", "reward_pickscore", "reward_ocr", "loss", "approx_kl"):
        assert np.isfinite(record[k]), (k, record)
    assert trainer.state.micro_step == 2 * 2
