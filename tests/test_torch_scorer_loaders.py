"""The port's scorer checkpoint loaders against the JAX package's, on the CPU.

PickScore: a tiny ``transformers.CLIPModel`` (the towers of the smoke
preset: text 2 layers of 32, vision 2 layers of 32 at 28^2) with random
weights and the ``position_ids`` buffers older checkpoints carry; DINOv2: a
tiny ``Dinov2Model`` (as tests/test_convert.py builds it) and its copy in
timm / original-checkpoint names, each with its ``mask_token``. The port's
converters are held to the JAX ones bitwise (their trees carried across by
``clip_dual_state_dict_from_jax`` / ``vit_state_dict_from_jax``), the scores
of the loaded PickScore to the JAX scorer's within 1e-5 in fp32, the
DINOv2 tokens to the JAX backbone's within 2e-4 (tests/test_convert.py's
bound against HF). Then ``build_reward_context`` from ``PICKSCORE_DIR`` /
``DINOV2_DIR`` directories written here against the JAX context, and a
PickScore context and ``load_real_text_encoder`` with ``transformers``
blocked against the JAX package's (CLIP rows and pooled within 1e-5, the
bf16 T5 rows within 2e-2 relative L2, as tests/test_torch_text_encoders.py
holds them).
"""

import json
import os
import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adv_grpo_torch.cli import common as t_common
from adv_grpo_torch.models import convert as t_convert
from adv_grpo_torch.models.clip_text import CLIPTextConfig as TTextConfig
from adv_grpo_torch.models.vit import ViTConfig as TViTConfig
from adv_grpo_torch.models.vit import VisionTransformer as TViT
from adv_grpo_torch.rewards.scorers import PickScoreScorer as TPickScore
from adv_grpo_torch.utils import safetensors_io
from adv_grpo_tpu.cli import common as j_common
from adv_grpo_tpu.models import convert as j_convert
from adv_grpo_tpu.models.clip_text import CLIPTextConfig as JTextConfig
from adv_grpo_tpu.models.vit import ViTConfig as JViTConfig
from adv_grpo_tpu.models.vit import VisionTransformer as JViT
from adv_grpo_tpu.rewards.scorers import PickScoreScorer as JPickScore
from tests.test_mirror_parity import randomize

transformers = pytest.importorskip("transformers")

T_TEXT, T_VISION = TTextConfig.tiny(projection_dim=16), TViTConfig.tiny(projection_dim=16)
DINO_KW = dict(image_size=28, num_layers=2, hidden_size=32, intermediate_size=64, num_heads=2)


def _np_sd(sd):
    return {k: v.detach().float().numpy() for k, v in sd.items()}


def _equal(got, want):
    assert set(got) == set(want)
    differ = [k for k in want if not torch.equal(got[k].float(), want[k].float())]
    assert not differ, differ[:5]


def _images(seed, n=3, hw=64):
    return np.random.default_rng(seed).uniform(-1, 1, (n, 3, hw, hw)).astype(np.float32)


@pytest.fixture(scope="module")
def clip_sd():
    """A tiny HF ``CLIPModel`` state dict at the smoke towers, random
    weights (logit scale too), with both ``position_ids`` buffers."""
    cfg = transformers.CLIPConfig(
        text_config=dict(vocab_size=64, hidden_size=32, intermediate_size=64,
                         num_hidden_layers=2, num_attention_heads=2, max_position_embeddings=16,
                         hidden_act="quick_gelu", eos_token_id=63, bos_token_id=62),
        vision_config=dict(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                           num_attention_heads=2, image_size=28, patch_size=14,
                           hidden_act="gelu"),
        projection_dim=16)
    model = randomize(transformers.CLIPModel(cfg).eval(), seed=11, std=0.1)
    sd = {k: v.detach().clone() for k, v in model.state_dict().items()}
    sd["text_model.embeddings.position_ids"] = torch.arange(16)[None]
    sd["vision_model.embeddings.position_ids"] = torch.arange(5)[None]
    return sd


@pytest.fixture(scope="module")
def dino_sds():
    """A tiny HF ``Dinov2Model`` state dict and its timm / original copy
    (fused qkv, ``ls{1,2}.gamma``, ``mask_token``), random weights."""
    cfg = transformers.Dinov2Config(hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
                                    mlp_ratio=2, image_size=28, patch_size=14,
                                    layerscale_value=0.5)
    hf = {k: v.detach().clone() for k, v in
          randomize(transformers.Dinov2Model(cfg).eval(), seed=12, std=0.1).state_dict().items()}
    e = "embeddings."
    timm = {"cls_token": hf[e + "cls_token"], "pos_embed": hf[e + "position_embeddings"],
            "mask_token": hf[e + "mask_token"],
            "patch_embed.proj.weight": hf[e + "patch_embeddings.projection.weight"],
            "patch_embed.proj.bias": hf[e + "patch_embeddings.projection.bias"],
            "norm.weight": hf["layernorm.weight"], "norm.bias": hf["layernorm.bias"]}
    for i in range(2):
        h, b = f"encoder.layer.{i}.", f"blocks.{i}."
        for name in ("weight", "bias"):
            timm[f"{b}attn.qkv.{name}"] = torch.cat(
                [hf[f"{h}attention.attention.{n}.{name}"] for n in ("query", "key", "value")])
            for src, dst in (("norm1", "norm1"), ("norm2", "norm2"), ("mlp.fc1", "mlp.fc1"),
                             ("mlp.fc2", "mlp.fc2"), ("attention.output.dense", "attn.proj")):
                timm[f"{b}{dst}.{name}"] = hf[f"{h}{src}.{name}"]
        timm[b + "ls1.gamma"] = hf[h + "layer_scale1.lambda1"]
        timm[b + "ls2.gamma"] = hf[h + "layer_scale2.lambda1"]
    return hf, timm


def test_clip_model_converter_matches_jax(clip_sd):
    """Every weight bitwise the JAX ``convert_clip_model``'s (patch bias
    zeros, logit scale 0-d fp32), and the loaded scorer's scores within 1e-5
    of the JAX scorer's on the same images and ids."""
    sd = t_convert.clip_model_state_dict_from_hf(clip_sd, T_TEXT, T_VISION)
    jparams = j_convert.convert_clip_model(_np_sd(clip_sd), 2, 2)
    _equal(sd, t_convert.clip_dual_state_dict_from_jax(jparams, T_TEXT, T_VISION))
    assert sd["logit_scale"].shape == () and sd["logit_scale"].dtype == torch.float32
    ts = TPickScore.from_state_dict(sd, "cpu", T_TEXT, T_VISION, 28)
    js = JPickScore(JTextConfig.tiny(projection_dim=16), JViTConfig.tiny(projection_dim=16),
                    image_size=28)
    images = _images(0)
    ids = np.random.default_rng(1).integers(0, 63, (3, 16))
    ids[:, 9] = 63
    want = np.asarray(js.score(jax.tree_util.tree_map(jnp.asarray, jparams), jnp.asarray(images),
                               jnp.asarray(ids)))
    np.testing.assert_allclose(ts.score(images, ids).numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("layout", ["hf", "timm"])
def test_dinov2_converters_match_jax(dino_sds, layout):
    """Both layouts (the layout told by the keys): every weight bitwise the
    JAX converter's, and the backbone's tokens within 2e-4 of the JAX
    backbone's; the two layouts load the same weights."""
    hf, timm = dino_sds
    src = hf if layout == "hf" else timm
    cfg = TViTConfig.dinov2_base(**DINO_KW)
    sd = t_convert.dinov2_state_dict(src, cfg)
    jconv = j_convert.convert_dinov2_hf if layout == "hf" else j_convert.convert_dinov2
    jparams = jconv(_np_sd(src), 2)
    _equal(sd, t_convert.vit_state_dict_from_jax(jparams, cfg))
    _equal(sd, t_convert.dinov2_state_dict_from_hf(hf, cfg))
    model = TViT(cfg).eval()
    model.load_state_dict(sd)
    pix = np.random.default_rng(2).normal(size=(2, 3, 28, 28)).astype(np.float32)
    with torch.no_grad():
        got = model(torch.from_numpy(pix))["tokens"].numpy()
    want = JViT(JViTConfig.dinov2_base(**DINO_KW)).apply(
        {"params": jax.tree_util.tree_map(jnp.asarray, jparams)}, jnp.asarray(pix))["tokens"]
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=2e-4)


@pytest.mark.parametrize("which", ["clip", "dinov2_hf", "dinov2_timm"])
def test_converters_are_strict(clip_sd, dino_sds, which):
    """A weight left over raises "not consumed"; a missing one "missing
    weight"; a position table of another length names both lengths."""
    cfg = TViTConfig.dinov2_base(**DINO_KW)
    sd, convert, table = {
        "clip": (clip_sd, lambda s: t_convert.clip_model_state_dict_from_hf(s, T_TEXT, T_VISION),
                 "vision_model.embeddings.position_embedding.weight"),
        "dinov2_hf": (dino_sds[0], lambda s: t_convert.dinov2_state_dict(s, cfg),
                      "embeddings.position_embeddings"),
        "dinov2_timm": (dino_sds[1], lambda s: t_convert.dinov2_state_dict(s, cfg),
                        "pos_embed")}[which]
    with pytest.raises(ValueError, match="1 checkpoint weights were not consumed"):
        convert({**sd, "extra.weight": torch.zeros(1)})
    missing = dict(sd)
    del missing[sorted(k for k in sd if "layers.1." in k or "layer.1." in k
                       or "blocks.1." in k)[0]]
    with pytest.raises(KeyError, match="missing weight"):
        convert(missing)
    short = {**sd, table: sd[table][..., :4, :] if sd[table].ndim == 3 else sd[table][:4]}
    with pytest.raises(ValueError, match="has 4 rows, the config needs 5"):
        convert(short)


def _write(directory, sd):
    os.makedirs(directory, exist_ok=True)
    safetensors_io.save_file({k: v.contiguous() for k, v in sd.items()},
                             os.path.join(directory, "model.safetensors"))
    return str(directory)


def _configs(*overrides):
    from adv_grpo_tpu.cli.common import resolve_config as j_resolve

    overrides = ["smoke_test=True", *overrides]
    return (t_common.apply_overrides(t_common.resolve_config("pickscore_cotrain_sd3_fast"),
                                     overrides),
            j_common.apply_overrides(j_resolve("pickscore_cotrain_sd3_fast"), overrides))


def test_reward_context_loads_pickscore_like_jax(clip_sd, tmp_path, monkeypatch):
    """``PICKSCORE_DIR`` (a safetensors CLIPModel directory): the port's
    weights bitwise the file's, its frozen and live scores within 1e-5 of
    the JAX context's; no RANDOM-INIT warning."""
    monkeypatch.setenv("PICKSCORE_DIR", _write(tmp_path / "ps", clip_sd))
    tcfg, jcfg = _configs()
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message=".*RANDOM-INIT")
        ctx = t_common.build_reward_context(tcfg, {"pickscore", "pickscore_cotrain"}, "cpu")
    jctx = j_common.build_reward_context(jcfg, {"pickscore", "pickscore_cotrain"})
    _equal(ctx.pickscore.clip.state_dict(),
           t_convert.clip_model_state_dict_from_hf(clip_sd, T_TEXT, T_VISION))
    images, prompts = _images(3, n=2), ["a flower", "b"]
    got = ctx.pickscore.score(images, ctx.tokenize(prompts)).numpy()
    want = jctx.pickscore.score(jctx.pickscore_params, jnp.asarray(images),
                                jnp.asarray(jctx.tokenize(prompts)))
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-5)


@pytest.mark.parametrize("layout", ["hf", "timm"])
def test_reward_context_loads_dinov2_like_jax(dino_sds, tmp_path, monkeypatch, layout):
    """``DINOV2_DIR`` in either layout: the backbone bitwise the converted
    file, frozen; its tokens within 2e-4 of the JAX context's backbone on
    the same images; no RANDOM-INIT warning. A path that does not exist
    gives the random backbone with the warning (non-smoke, as in JAX)."""
    src = dino_sds[0] if layout == "hf" else dino_sds[1]
    monkeypatch.setenv("DINOV2_DIR", _write(tmp_path / "dino", src))
    tcfg, jcfg = _configs()
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message=".*RANDOM-INIT")
        ctx = t_common.build_reward_context(tcfg, {"dino_patch_cotrain"}, "cpu")
    jctx = j_common.build_reward_context(jcfg, {"dino_patch_cotrain"})
    cfg = TViTConfig.dinov2_base(**DINO_KW)
    _equal(ctx.dino.vision.state_dict(), t_convert.dinov2_state_dict(src, cfg))
    assert not any(p.requires_grad for p in ctx.dino.vision.parameters())
    images = _images(4, hw=28)
    got = ctx.dino.features(images).numpy()
    want = jctx.dino.features(jctx.dino_backbone_params, jnp.asarray(images))
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=2e-4)
    if layout == "hf":
        monkeypatch.setenv("DINOV2_DIR", str(tmp_path / "absent"))
        tcfg, _ = _configs("smoke_test=False")
        with pytest.warns(UserWarning, match="DINOv2 backbone scorer is RANDOM-INIT"):
            ctx = t_common.build_reward_context(tcfg, {"image_similarity"}, "cpu")
        assert ctx.dino.vision_cfg.hidden_size == 768 and ctx.dino.image_size == 518


@pytest.fixture(scope="module")
def sd3_dir(tmp_path_factory):
    from tests.test_torch_loaders import write_sd3_dir

    return write_sd3_dir(str(tmp_path_factory.mktemp("sd3_dir")))


def test_without_transformers_the_directory_still_tokenizes(sd3_dir, monkeypatch):
    """With ``transformers`` blocked: the PickScore context reads the
    directory's ``tokenizer/`` and gives the JAX context's ids; the real
    text encoder reads ``tokenizer{,_2,_3}/`` and its embeddings equal the
    JAX package's (computed first, with ``transformers``)."""
    from tests.test_torch_text_encoders import _jax_t5_as_arrays, _rel_l2

    tcfg, jcfg = _configs(f"pretrained.model={sd3_dir}")
    prompts = ["a flower", "zebra " * 40, "", "flow er"]
    jids = j_common.build_reward_context(jcfg, {"pickscore"}).tokenize(prompts)
    _jax_t5_as_arrays(monkeypatch)
    holder = type("P", (), {"text_seq_len": 154, "device": torch.device("cpu")})()
    je, jp = j_common.load_real_text_encoder(jcfg, holder)(prompts)
    monkeypatch.setitem(sys.modules, "transformers", None)
    monkeypatch.setitem(sys.modules, "tokenizers", None)
    np.testing.assert_array_equal(
        t_common.build_reward_context(tcfg, {"pickscore"}, "cpu").tokenize(prompts), jids)
    te, tp = t_common.load_real_text_encoder(tcfg, holder)(prompts)
    np.testing.assert_allclose(te[:, :77], np.asarray(je)[:, :77], rtol=0, atol=1e-5)
    np.testing.assert_allclose(tp, np.asarray(jp), rtol=0, atol=1e-5)
    assert _rel_l2(te[:, 77:], np.asarray(je)[:, 77:]) < 2e-2


@pytest.mark.parametrize("which", ["clip", "dinov2_hf", "dinov2_timm"])
def test_chip_smoke_writes_the_published_layouts(clip_sd, dino_sds, which):
    """The directories ``chip_smoke.py`` writes for the card: the HF
    ``CLIPModel`` / ``Dinov2Model`` names (and the timm copy's), held to the
    HF models' own keys; read back by the port's converters bitwise."""
    from chip_smoke import hf_clip_model_state_dict, hf_dinov2_state_dict

    cfg = TViTConfig.dinov2_base(**DINO_KW)
    if which == "clip":
        port = t_convert.clip_model_state_dict_from_hf(clip_sd, T_TEXT, T_VISION)
        written = hf_clip_model_state_dict(port)
        back = t_convert.clip_model_state_dict_from_hf(written, T_TEXT, T_VISION)
        want_keys = set(clip_sd)
    else:
        port = t_convert.dinov2_state_dict(dino_sds[0], cfg)
        layout = which.split("_")[1]
        written = hf_dinov2_state_dict(port, layout)
        back = t_convert.dinov2_state_dict(written, cfg)
        want_keys = set(dino_sds[0] if layout == "hf" else dino_sds[1])
    assert set(written) == want_keys
    _equal(back, port)


def test_cotrain_runs_start_from_the_files(sd3_dir, clip_sd, dino_sds, tmp_path, monkeypatch):
    """The slice on the CPU, with ``transformers`` and ``tokenizers``
    blocked: ``cli.precompute_embeds`` from the tiny directory (its own
    tokenizers), then one epoch of ``pickscore_cotrain_sd3_fast`` from the
    directory's transformer and VAE, the store and ``PICKSCORE_DIR`` (the
    frozen tail bitwise the file's last layer) and one of
    ``dino_cotrain_sd3_patch_fast`` with ``DINOV2_DIR`` as well (the
    backbone bitwise the file's after it): finite metrics, no RANDOM-INIT
    warning. The runs read a copy without ``tokenizer*/``: the smoke text
    tower has 16 positions, the directory's CLIP tokenizer gives 77 ids (on
    the card the phase of ``chip_smoke.py`` runs CLIP-H with them)."""
    import shutil

    from adv_grpo_torch.cli import precompute_embeds as t_pre
    from adv_grpo_torch.cli import train as t_train
    from adv_grpo_torch.data.datasets import TextPromptDataset
    from tests.test_torch_cotrain import _refs

    monkeypatch.setitem(sys.modules, "transformers", None)
    monkeypatch.setitem(sys.modules, "tokenizers", None)
    monkeypatch.setenv("PICKSCORE_DIR", _write(tmp_path / "ps", clip_sd))
    monkeypatch.setenv("DINOV2_DIR", _write(tmp_path / "dino", dino_sds[1]))
    store = str(tmp_path / "store")
    t_pre.main(["--config", "smoke_sd3_fast", "--set", f"pretrained.model={sd3_dir}",
                "--set", "dataset=dataset/pickscore_small", "--set", "smoke_test=False",
                "--splits", "train", "--out", store, "--device", "cpu"])
    prompts = TextPromptDataset("dataset/pickscore_small").prompts
    weights = str(tmp_path / "weights")
    shutil.copytree(sd3_dir, weights, ignore=shutil.ignore_patterns("tokenizer*"))
    common = ["--device", "cpu", "--latent_hw", "8", "--max_epochs", "1",
              "--set", "smoke_test=True", "--set", f"pretrained.model={weights}",
              "--set", f"text_embeds_dir={store}", "--set", "dataset=dataset/pickscore_small",
              "--set", "sample.train_batch_size=2", "--set", "sample.num_batches_per_epoch=2",
              "--set", "train.gradient_accumulation_steps=1", "--set", "wandb_init=False",
              "--set", f"json_path={_refs(tmp_path, prompts)}",
              "--set", f"reference_image_path={tmp_path}"]
    ps_file = t_convert.clip_model_state_dict_from_hf(clip_sd, T_TEXT, T_VISION)
    dino_file = t_convert.dinov2_state_dict(dino_sds[1], TViTConfig.dinov2_base(**DINO_KW))
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message=".*RANDOM-INIT")
        for preset, extra in (("pickscore_cotrain_sd3_fast", []),
                              ("dino_cotrain_sd3_patch_fast", ["--set", "d_times=2"])):
            run = tmp_path / preset
            trainer = t_train.main(["--config", preset, "--set", f"save_dir={run}"]
                                   + common + extra)
            records = [json.loads(line) for line in (run / "metrics.jsonl").open()]
            keys = ("d_loss", "d_acc") if records[0]["d_epoch"] else ("loss", "approx_kl")
            assert len(records) == 1 and all(np.isfinite(records[0][k])
                                             for k in ("reward_avg",) + keys), records
            ctx = trainer.reward_ctx
            if ctx.dino is None:
                _equal({f"vision_model.layers.1.{k}": v
                        for k, v in ctx.pickscore_frozen_params[0].state_dict().items()},
                       {k: v for k, v in ps_file.items()
                        if k.startswith("vision_model.layers.1.")})
            else:  # the eval's PickScore is frozen whole
                _equal(ctx.pickscore.clip.state_dict(), ps_file)
                _equal(ctx.dino.vision.state_dict(), dino_file)
