"""The port's SD3 checkpoint loaders against the JAX package's, on a tiny
diffusers-layout directory this file writes (as tests/test_preflight.py does).

The directory: ``transformer/`` (the torch mirror of diffusers'
``SD3Transformer2DModel`` at the tiny MMDiT config, fp32, with its persisted
base-scaled sincos table), ``vae/`` (the mirror ``AutoencoderKL``, encoder and
decoder, 32-channel blocks: the loaders keep GroupNorm's 32 groups), two
CLIP text towers in ``text_encoder/`` (quick_gelu) and ``text_encoder_2/``
(gelu) and a T5 encoder in ``text_encoder_3/`` (two fp16 shards and their
index), in HF ``CLIPTextModelWithProjection`` / ``T5EncoderModel`` names
(``chip_smoke.hf_clip_state_dict`` / ``hf_t5_state_dict``, which write the
card's directory too, held to the HF models' own names in
tests/test_torch_text_encoders.py), each with the
``config.json`` keys the loaders read; and tiny tokenizers (a byte-pair CLIP
vocabulary, a unigram T5 ``tokenizer.json``) beside them. Writing it needs
no ``transformers``; the slice tests that tokenize are in
tests/test_torch_text_encoders.py.

Tolerances: the loaded weights, ``lora_a`` and the detected pos-embed
convention bitwise; velocity, VAE moments and decode in fp32 within 1e-5
(sums reordered); the preflight report equal.
"""

import json
import os
import shutil
import string
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import safetensors.torch
import torch

from adv_grpo_torch.models import convert as t_convert
from adv_grpo_torch.models.lora import lora_params as t_lora_params
from adv_grpo_torch.models.lora import merge_lora_params as t_merge
from adv_grpo_torch.utils import safetensors_io
from adv_grpo_tpu.models import convert as j_convert
from adv_grpo_tpu.models.lora import lora_params as j_lora_params
from adv_grpo_tpu.models.lora import merge_lora_params as j_merge
from adv_grpo_tpu.models.mmdit import MMDiTConfig
from adv_grpo_tpu.models.vae import AutoencoderKL, VAEConfig
from chip_smoke import hf_clip_state_dict, hf_t5_state_dict
from tests.mirrors.sd3_torch import AutoencoderKLMirror, SD3TransformerMirror
from tests.test_mirror_parity import randomize

MCFG = MMDiTConfig.tiny(lora_rank=0, dtype=jnp.float32)
VCFG = VAEConfig.tiny(block_out_channels=(32, 32), norm_num_groups=32, latent_channels=16)
CLIP_EOS = 57  # "<|endoftext|>" in the tiny vocabulary below


def _save(sd, path):
    safetensors.torch.save_file({k: v.contiguous() for k, v in sd.items()}, path)


def _write_tokenizers(root):
    """A byte-pair CLIP vocabulary (letters, their word-final forms, four
    merges, the two specials: ids 0-57) in tokenizer/ and tokenizer_2/, a
    unigram T5 tokenizer.json in tokenizer_3/."""
    from tokenizers import Tokenizer, decoders, models, pre_tokenizers, processors

    letters = string.ascii_lowercase
    vocab = {c: i for i, c in enumerate(letters)}
    vocab.update({c + "</w>": 26 + i for i, c in enumerate(letters)})
    merges = ["f l", "fl o", "o w", "e r</w>"]
    for m in merges:
        vocab[m.replace(" ", "")] = len(vocab)
    vocab["<|startoftext|>"], vocab["<|endoftext|>"] = len(vocab), len(vocab) + 1
    assert vocab["<|endoftext|>"] == CLIP_EOS
    for sub in ("tokenizer", "tokenizer_2"):
        os.makedirs(os.path.join(root, sub))
        with open(os.path.join(root, sub, "vocab.json"), "w") as f:
            json.dump(vocab, f)
        with open(os.path.join(root, sub, "merges.txt"), "w") as f:
            f.write("#version: 0.2\n" + "\n".join(merges) + "\n")
    pieces = ([("<pad>", 0.0), ("</s>", 0.0), ("<unk>", 0.0), ("▁", -2.0)]
              + [(c, -3.0) for c in letters] + [("▁" + c, -2.5) for c in letters]
              + [("▁flower", -1.0), ("▁a", -1.5)])
    tok = Tokenizer(models.Unigram(pieces, unk_id=2, byte_fallback=False))
    tok.pre_tokenizer = pre_tokenizers.Metaspace(replacement="▁", prepend_scheme="always")
    tok.post_processor = processors.TemplateProcessing(
        single="$A </s>", pair="$A </s> $B </s>", special_tokens=[("</s>", 1)])
    tok.decoder = decoders.Metaspace(replacement="▁", prepend_scheme="always")
    d = os.path.join(root, "tokenizer_3")
    os.makedirs(d)
    tok.save(os.path.join(d, "tokenizer.json"))
    with open(os.path.join(d, "tokenizer_config.json"), "w") as f:
        json.dump({"eos_token": "</s>", "pad_token": "<pad>", "unk_token": "<unk>",
                   "extra_ids": 0, "additional_special_tokens": []}, f)


def write_sd3_dir(root):
    """The tiny SD3 directory described in the module docstring."""
    torch.manual_seed(0)
    mirror = randomize(SD3TransformerMirror(MCFG), seed=0).eval()
    os.makedirs(os.path.join(root, "transformer"))
    _save(mirror.state_dict(), os.path.join(root, "transformer", "model.safetensors"))
    with open(os.path.join(root, "transformer", "config.json"), "w") as f:
        json.dump({"patch_size": MCFG.patch_size, "in_channels": MCFG.in_channels,
                   "out_channels": MCFG.out_channels, "num_layers": MCFG.num_layers,
                   "attention_head_dim": MCFG.attention_head_dim,
                   "num_attention_heads": MCFG.num_attention_heads,
                   "joint_attention_dim": MCFG.joint_attention_dim,
                   "pooled_projection_dim": MCFG.pooled_projection_dim,
                   "pos_embed_max_size": MCFG.pos_embed_max_size, "qk_norm": "rms_norm",
                   "dual_attention_layers": list(MCFG.dual_attention_layers),
                   "sample_size": MCFG.sample_size}, f)
    vae = randomize(AutoencoderKLMirror(VCFG), seed=1, std=0.05).eval()
    os.makedirs(os.path.join(root, "vae"))
    _save(vae.state_dict(), os.path.join(root, "vae", "model.safetensors"))
    with open(os.path.join(root, "vae", "config.json"), "w") as f:
        json.dump({"latent_channels": VCFG.latent_channels,
                   "block_out_channels": list(VCFG.block_out_channels),
                   "layers_per_block": VCFG.layers_per_block, "norm_num_groups": 32,
                   "scaling_factor": VCFG.scaling_factor, "shift_factor": VCFG.shift_factor}, f)
    from adv_grpo_torch.models.clip_text import CLIPTextConfig, CLIPTextEncoder
    from adv_grpo_torch.models.t5 import T5Config, T5Encoder

    for sub, hidden, act in (("text_encoder", 16, "quick_gelu"), ("text_encoder_2", 32, "gelu")):
        cfg = CLIPTextConfig(hidden_size=hidden, intermediate_size=2 * hidden, num_layers=2,
                             num_heads=2, projection_dim=24, hidden_act=act,
                             eos_token_id=CLIP_EOS)
        model = randomize(CLIPTextEncoder(cfg), seed=2 + hidden, std=0.05)
        os.makedirs(os.path.join(root, sub))
        _save(hf_clip_state_dict(model.half().state_dict()),
              os.path.join(root, sub, "model.safetensors"))
        with open(os.path.join(root, sub, "config.json"), "w") as f:
            json.dump({"architectures": ["CLIPTextModelWithProjection"], "hidden_size": hidden,
                       "intermediate_size": 2 * hidden, "num_hidden_layers": 2,
                       "num_attention_heads": 2, "projection_dim": 24, "hidden_act": act,
                       "max_position_embeddings": 77, "vocab_size": 49408,
                       "bos_token_id": 56, "eos_token_id": CLIP_EOS,
                       "torch_dtype": "float16"}, f)
    t5cfg = T5Config(d_model=MCFG.joint_attention_dim, d_kv=8, d_ff=48, num_layers=2,
                     num_heads=4, dtype=torch.float32)
    t5 = hf_t5_state_dict(randomize(T5Encoder(t5cfg), seed=4, std=0.05).half().state_dict())
    d = os.path.join(root, "text_encoder_3")
    os.makedirs(d)
    names = sorted(t5)
    shards = {"model-00001-of-00002.safetensors": names[: len(names) // 2],
              "model-00002-of-00002.safetensors": names[len(names) // 2:]}
    for fname, keys in shards.items():
        _save({k: t5[k] for k in keys}, os.path.join(d, fname))
    with open(os.path.join(d, "model.safetensors.index.json"), "w") as f:
        json.dump({"metadata": {}, "weight_map": {k: fn for fn, ks in shards.items()
                                                  for k in ks}}, f)
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump({"architectures": ["T5EncoderModel"], "d_model": t5cfg.d_model,
                   "d_kv": t5cfg.d_kv, "d_ff": t5cfg.d_ff, "num_layers": t5cfg.num_layers,
                   "num_heads": t5cfg.num_heads, "vocab_size": 32128,
                   "feed_forward_proj": "gated-gelu", "relative_attention_num_buckets": 32,
                   "relative_attention_max_distance": 128, "torch_dtype": "float16"}, f)
    _write_tokenizers(root)
    return root


@pytest.fixture(scope="module")
def sd3_dir(tmp_path_factory):
    return write_sd3_dir(str(tmp_path_factory.mktemp("sd3_dir")))


@pytest.fixture(scope="module")
def loaded(sd3_dir):
    """The directory loaded by both packages in fp32 with LoRA rank 2."""
    jpipe = j_convert.load_sd3_pipeline(sd3_dir, lora_rank=2, lora_alpha=4.0,
                                        dtype=jnp.float32, remat=False)
    tpipe = t_convert.load_sd3_pipeline(sd3_dir, lora_rank=2, lora_alpha=4.0,
                                        dtype=torch.float32, device="cpu")
    return jpipe, tpipe


# ── the reader ───────────────────────────────────────────────────────────────


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16, torch.float32])
def test_directory_reads_as_the_package_reads_it(tmp_path, dtype):
    """Two shards and their index: the port's ``load_torch_state_dict`` gives
    bitwise what ``safetensors.torch.load_file`` gives of each shard."""
    g = torch.Generator().manual_seed(0)
    sd = {f"layer.{i}.weight": torch.randn(3 + i, 5, generator=g).to(dtype) for i in range(6)}
    shards = {"model-00001-of-00002.safetensors": dict(list(sd.items())[:4]),
              "model-00002-of-00002.safetensors": dict(list(sd.items())[4:])}
    for name, part in shards.items():
        safetensors.torch.save_file(part, str(tmp_path / name))
    with open(tmp_path / "model.safetensors.index.json", "w") as f:
        json.dump({"weight_map": {k: n for n, p in shards.items() for k in p}}, f)
    want = {}
    for name in shards:
        want.update(safetensors.torch.load_file(str(tmp_path / name)))
    got = t_convert.load_torch_state_dict(str(tmp_path))
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == dtype and torch.equal(got[k], v), k
    # one tensor at a time, each its own storage (no view of a whole-file buffer)
    one = safetensors_io.load_file(str(tmp_path / "model-00001-of-00002.safetensors"))
    assert len({t.untyped_storage().data_ptr() for t in one.values()}) == len(one)
    assert all(t.untyped_storage().nbytes() == t.numel() * t.element_size()
               for t in one.values())
    # the .bin fallback (cast to fp32, as the JAX loader casts)
    bins = tmp_path / "bin"
    bins.mkdir()
    torch.save(sd, str(bins / "pytorch_model.bin"))
    got = t_convert.load_torch_state_dict(str(bins))
    assert all(got[k].dtype == torch.float32 and torch.equal(got[k], v.float())
               for k, v in sd.items())


# ── the SD3 directory ────────────────────────────────────────────────────────


def test_loaded_weights_and_lora_match_jax(sd3_dir, loaded):
    """Every frozen weight is the file's rounded to bf16 (held in the fp32
    model), as the JAX tree's; ``lora_a`` bitwise the JAX draws, B zero; the
    pos-embed convention the same; the VAE whole, fp32."""
    from adv_grpo_torch.models.convert import mmdit_state_dict_from_jax

    jpipe, tpipe = loaded
    assert tpipe.mmdit_cfg.pos_embed_base_size == jpipe.mmdit_cfg.pos_embed_base_size \
        == MCFG.sample_size // MCFG.patch_size
    want = mmdit_state_dict_from_jax(jpipe.transformer_params, tpipe.mmdit_cfg)
    got = tpipe.mmdit.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v.to(got[k].dtype)), k
    files = safetensors.torch.load_file(os.path.join(sd3_dir, "transformer",
                                                     "model.safetensors"))
    for k, v in files.items():
        if k != "pos_embed.pos_embed":
            assert torch.equal(got[k], v.to(torch.bfloat16).float()), k
    jl, tl = j_lora_params(jpipe.transformer_params["params"]), t_lora_params(tpipe.mmdit)
    assert set(jl) == set(tl) and len(tl) == 2 * (8 * MCFG.num_layers - 1)
    for k, v in jl.items():
        assert torch.equal(tl[k].detach(), torch.from_numpy(np.asarray(v))), k
        if k.endswith("lora_b"):
            assert not tl[k].any()
    vae = safetensors.torch.load_file(os.path.join(sd3_dir, "vae", "model.safetensors"))
    tv = tpipe.vae.state_dict()
    assert set(tv) == set(vae) and all(torch.equal(tv[k], v) for k, v in vae.items())


def test_velocity_and_vae_match_jax(loaded):
    """The same non-zero LoRA B in both; the velocity of one CFG-sized batch,
    the VAE's moments of an image and the decode of a latent (fp32, 1e-5)."""
    jpipe, tpipe = loaded
    rng = np.random.default_rng(0)
    lb = {k: (rng.standard_normal(np.shape(v)) * 0.1).astype(np.float32)
          for k, v in j_lora_params(jpipe.transformer_params["params"]).items()
          if k.endswith("lora_b")}
    jparams = {"params": j_merge(jpipe.transformer_params["params"], lb)}
    t_merge(tpipe.mmdit, lb)
    lat = rng.standard_normal((2, 16, 8, 8)).astype(np.float32)
    ctx = rng.standard_normal((2, 7, MCFG.joint_attention_dim)).astype(np.float32)
    pooled = rng.standard_normal((2, MCFG.pooled_projection_dim)).astype(np.float32)
    t = np.array([500.0, 20.0], np.float32)
    want = np.asarray(jax.jit(jpipe.velocity_fn(jparams))(lat, t, ctx, pooled))
    with torch.no_grad():
        got = tpipe.velocity_fn()(*(torch.from_numpy(a) for a in (lat, t, ctx, pooled)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)

    img = rng.uniform(-1, 1, (2, 3, 16, 16)).astype(np.float32)
    jvae = AutoencoderKL(jpipe.vae_cfg)
    jmean, jlogvar = jax.jit(lambda x: jvae.apply(jpipe.vae_params, x,
                                                  method=jvae.encode_moments))(img)
    jlat = jax.jit(lambda x: jvae.apply(jpipe.vae_params, x, method=jvae.encode))(img)
    with torch.no_grad():
        tmean, tlogvar = tpipe.vae.encode_moments(torch.from_numpy(img))
        tlat = tpipe.vae.encode(torch.from_numpy(img))
        dec = tpipe.decode(torch.from_numpy(lat))
    for g, w in ((tmean, jmean), (tlogvar, jlogvar), (tlat, jlat)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(dec.numpy(), np.asarray(jax.jit(jpipe.decode)(lat)),
                               rtol=1e-5, atol=1e-5)


def test_preflight_report_equals_jax(sd3_dir, capsys):
    want = j_convert.preflight(sd3_dir)
    got = t_convert.preflight(sd3_dir)
    assert got == want
    assert got["transformer"]["params"] > 0 and got["text_encoder_3"]["params"] > 0
    t_convert._main(["--src", sd3_dir, "--skip_text_encoders"])
    out = capsys.readouterr().out
    assert "PREFLIGHT OK" in out
    report = json.loads(out[: out.rindex("}") + 1])
    assert report == {k: v for k, v in want.items() if not k.startswith("text_encoder")}


@pytest.mark.parametrize("sub", ["transformer", "vae", "text_encoder", "text_encoder_3"])
def test_a_leftover_weight_is_not_consumed(sd3_dir, tmp_path, sub):
    """A checkpoint with one weight no module takes raises "not consumed"
    (the JAX package raises for the transformer and the VAE alike)."""
    bad = str(tmp_path / "bad")
    shutil.copytree(sd3_dir, bad)
    d = os.path.join(bad, sub)
    sd = t_convert.load_torch_state_dict(d)
    sd["leftover.weight"] = torch.zeros(2, 2)
    for f in os.listdir(d):
        if f.endswith((".safetensors", ".json")) and f != "config.json":
            os.remove(os.path.join(d, f))
    _save(sd, os.path.join(d, "model.safetensors"))
    with pytest.raises(ValueError, match="not consumed"):
        t_convert.preflight(bad)
    if sub in ("transformer", "vae"):
        with pytest.raises(ValueError, match="not consumed"):
            j_convert.preflight(bad)


def test_pos_embed_convention_detection_matches_jax():
    """The base-scaled table, the raw-integer table, one that matches
    neither, and none (a warning and the default): as the JAX package."""
    from tests.mirrors.sd3_torch import get_2d_sincos_pos_embed

    from adv_grpo_tpu.models.mmdit import _sincos_table

    dim, size, sample, patch = 32, 16, 16, 2
    coords = np.arange(size, dtype=np.float64)
    tables = {"base": get_2d_sincos_pos_embed(dim, size, base_size=sample // patch),
              "raw": _sincos_table(dim, coords, coords).reshape(size * size, dim)}
    tables["neither"] = tables["raw"] * 1.5
    for name, table in tables.items():
        for dtype in (torch.float32, torch.bfloat16):
            t = torch.from_numpy(np.asarray(table, np.float32))[None].to(dtype)
            args = (dim, size, sample, patch)
            if name == "neither":
                for fn, sd in ((t_convert.detect_pos_embed_base, {"pos_embed.pos_embed": t}),
                               (j_convert.detect_pos_embed_base,
                                {"pos_embed.pos_embed": t.float().numpy()})):
                    with pytest.raises(ValueError, match="matches neither"):
                        fn(sd, *args)
                continue
            got = t_convert.detect_pos_embed_base({"pos_embed.pos_embed": t}, *args)
            want = j_convert.detect_pos_embed_base({"pos_embed.pos_embed": t.float().numpy()},
                                                   *args)
            assert got == want == (sample // patch if name == "base" else None), (name, dtype)
    with pytest.warns(UserWarning, match="no persisted pos_embed"):
        assert t_convert.detect_pos_embed_base({}, dim, size, sample, patch, default=16) == 16
    with pytest.raises(ValueError, match="cannot be detected"):
        t_convert.detect_pos_embed_base({}, dim, size, sample, patch)


def test_a_stripped_table_loads_with_a_warning(sd3_dir, tmp_path):
    """A transformer without its persisted table loads with the diffusers
    default, warned, in both packages."""
    bare = str(tmp_path / "bare")
    shutil.copytree(sd3_dir, bare, ignore=shutil.ignore_patterns("text_encoder*", "tokenizer*"))
    path = os.path.join(bare, "transformer", "model.safetensors")
    sd = safetensors.torch.load_file(path)
    del sd["pos_embed.pos_embed"]
    _save(sd, path)
    with pytest.warns(UserWarning, match="no persisted pos_embed"):
        report = t_convert.preflight(bare)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert report == j_convert.preflight(bare)
    assert report["transformer"]["pos_embed_base_size"] == MCFG.sample_size // MCFG.patch_size
    assert report["text_encoder"] == "absent"


def test_text_encoder_needs_transformers(sd3_dir, monkeypatch):
    """With ``transformers`` blocked the real encoder still builds from the
    directory: its tokenizers are the port's own (``data.tokenizers``), and
    its embeddings equal those of the same encoders given the directory's
    tokenizers by hand."""
    import sys

    from adv_grpo_torch.cli.common import (
        apply_overrides, build_text_encoder, load_sd3_text_encoders, make_sd3_encode,
        resolve_config, sd3_tokenizers)

    config = apply_overrides(resolve_config("smoke_sd3_fast"), [f"pretrained.model={sd3_dir}"])
    pipeline = type("P", (), {"text_seq_len": 154, "device": torch.device("cpu")})()
    monkeypatch.setitem(sys.modules, "transformers", None)
    embeds, pooled = build_text_encoder(config, pipeline)(["a flower", ""])
    assert embeds.shape == (2, 154, MCFG.joint_attention_dim) and np.isfinite(embeds).all()
    want = make_sd3_encode(load_sd3_text_encoders(sd3_dir, "cpu"),
                           sd3_tokenizers(sd3_dir, 77), "cpu")(["a flower", ""])
    np.testing.assert_array_equal(embeds, want[0])
    np.testing.assert_array_equal(pooled, want[1])
