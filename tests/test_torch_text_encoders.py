"""The port's SD3 text encoders (CLIP-L, CLIP-G, T5) and prompt embeddings
against the JAX package, and the whole loader slice: ``cli.precompute_embeds``
and ``cli.infer`` of both packages from the tiny diffusers directory of
tests/test_torch_loaders.py.

Weights: the JAX T5's own tree filled from a numpy generator (carried across
by ``t5_state_dict_from_jax``), and tiny ``transformers`` models
(``T5EncoderModel``, ``CLIPTextModelWithProjection`` at quick_gelu and gelu)
whose HF state dicts both packages convert. Tolerances: fp32 encoders within
1e-5 of the JAX package (1e-4 of HF, which orders its sums otherwise); T5 in
bf16 within 2e-2 relative L2 (the same roundings, bf16 products summed in
other orders); the bucket map and the composition exactly. The slice: the
stores' CLIP halves and pooled rows within one fp16 spacing, their T5 rows
(bf16 in both packages) within 2e-2 relative L2; the 8-bit images within 2
levels.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adv_grpo_torch.models import convert as t_convert
from adv_grpo_torch.models import encode_prompt as t_ep
from adv_grpo_torch.models import t5 as t_t5
from adv_grpo_torch.models.clip_text import CLIPTextConfig as TCLIPTextConfig
from adv_grpo_torch.models.clip_text import CLIPTextEncoder as TCLIPTextEncoder
from adv_grpo_tpu.models import convert as j_convert
from adv_grpo_tpu.models import encode_prompt as j_ep
from adv_grpo_tpu.models import t5 as j_t5
from adv_grpo_tpu.models.clip_text import CLIPTextConfig as JCLIPTextConfig
from adv_grpo_tpu.models.clip_text import CLIPTextEncoder as JCLIPTextEncoder
from chip_smoke import hf_clip_state_dict, hf_t5_state_dict
from tests.test_mirror_parity import randomize
from tests.test_torch_loaders import MCFG, write_sd3_dir

transformers = pytest.importorskip("transformers")


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _jax_t5_params(cfg, seed):
    """The JAX T5's parameter tree, every leaf drawn from numpy: kernels at
    fan_in^-0.5, RMS weights near 1, embedding and bias tables N(0, 1)."""
    shapes = jax.eval_shape(j_t5.T5Encoder(cfg).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 5), jnp.int32))["params"]
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        if name == "kernel":
            return rng.standard_normal(s.shape) * s.shape[0] ** -0.5
        if name == "weight":
            return 1.0 + 0.1 * rng.standard_normal(s.shape)
        return rng.standard_normal(s.shape)

    return jax.tree_util.tree_map_with_path(
        lambda p, s: np.asarray(leaf(p, s), np.float32), shapes)


def _t5_pair(cfg_kw, seed=0):
    jcfg = j_t5.T5Config.tiny(**cfg_kw)
    tkw = dict(cfg_kw, dtype=torch.bfloat16) if "dtype" in cfg_kw else cfg_kw
    tcfg = t_t5.T5Config.tiny(**tkw)
    params = _jax_t5_params(jcfg, seed)
    model = t_t5.T5Encoder(tcfg)
    model.load_state_dict(t_convert.t5_state_dict_from_jax(params, tcfg))
    return jcfg, jax.tree_util.tree_map(jnp.asarray, params), model.eval()


def test_bucket_function_matches_jax():
    rel = np.arange(-300, 301)[None, :] - np.arange(0, 5)[:, None]
    for buckets, dist in ((32, 128), (8, 20), (16, 64)):
        np.testing.assert_array_equal(t_t5.t5_relative_position_bucket(rel, buckets, dist),
                                      j_t5.t5_relative_position_bucket(rel, buckets, dist))


@pytest.mark.parametrize("per_layer", [False, True], ids=["t5", "umt5"])
@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
def test_t5_matches_jax(per_layer, masked):
    jcfg, params, model = _t5_pair(dict(per_layer_rel_bias=per_layer), seed=int(per_layer))
    rng = np.random.default_rng(1)
    ids = rng.integers(0, jcfg.vocab_size, (2, 11)).astype(np.int32)
    mask = np.arange(11)[None, :] < np.array([[11], [6]]) if masked else None
    want = jax.jit(lambda i, m: j_t5.T5Encoder(jcfg).apply({"params": params}, i, m))(ids, mask)
    with torch.no_grad():
        got = model(torch.from_numpy(ids).long(), None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_t5_bf16_and_length_mask_match_jax():
    """bf16 compute (fp32 norms, scores and softmax) and the per-sample
    length mask (padded positions masked and zeroed)."""
    jcfg, params, model = _t5_pair(dict(dtype=jnp.bfloat16), seed=2)
    assert model.blocks[0].q.weight.dtype == torch.bfloat16
    assert model.blocks[0].ln_attn.weight.dtype == torch.float32
    ids = np.random.default_rng(3).integers(0, jcfg.vocab_size, (3, 9)).astype(np.int32)
    lengths = np.array([9, 4, 1])
    want = jax.jit(lambda i: j_t5.encode_with_length_mask(j_t5.T5Encoder(jcfg), params, i,
                                                          lengths))(ids)
    with torch.no_grad():
        got = t_t5.encode_with_length_mask(model, torch.from_numpy(ids).long(), lengths)
    assert got.dtype == torch.bfloat16 and not got[1, 4:].any() and not got[2, 1:].any()
    assert _rel_l2(got.float().numpy(), np.asarray(want, np.float32)) < 2e-2


def test_t5_from_hf_matches_hf_and_jax():
    torch.manual_seed(0)
    hf = transformers.T5EncoderModel(transformers.T5Config(
        vocab_size=101, d_model=32, d_kv=8, d_ff=48, num_layers=2, num_heads=4,
        relative_attention_num_buckets=8, relative_attention_max_distance=20,
        feed_forward_proj="gated-gelu", dropout_rate=0.0)).eval()
    randomize(hf, seed=5, std=0.1)
    sd = hf.state_dict()
    cfg = dict(vocab_size=101, d_model=32, d_kv=8, d_ff=48, num_layers=2, num_heads=4,
               relative_attention_num_buckets=8, relative_attention_max_distance=20)
    model = t_t5.T5Encoder(t_t5.T5Config(dtype=torch.float32, **cfg)).eval()
    model.load_state_dict(t_convert.t5_state_dict_from_hf(sd, 2))
    # the test writer's HF names are the HF model's (save_pretrained drops the tied copy)
    assert set(hf_t5_state_dict(model.state_dict())) == set(sd) - {"encoder.embed_tokens.weight"}
    ids = torch.tensor([[3, 4, 5, 6, 1, 0, 0, 0], [7, 8, 1, 0, 0, 0, 0, 0]])
    mask = ids.ne(0) | (torch.arange(8) < 5)[None]
    with torch.no_grad():
        want = hf(ids, attention_mask=mask.long()).last_hidden_state
        got = model(ids, mask)
    params = j_convert.convert_t5_encoder({k: v.numpy() for k, v in sd.items()}, 2)
    jgot = j_t5.T5Encoder(j_t5.T5Config(dtype=jnp.float32, **cfg)).apply(
        {"params": params}, jnp.asarray(ids.numpy()), jnp.asarray(mask.numpy()))
    valid = mask.numpy()
    np.testing.assert_allclose(got.numpy()[valid], want.numpy()[valid], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.numpy(), np.asarray(jgot), rtol=1e-5, atol=1e-5)
    extra = dict(sd, **{"encoder.extra.weight": torch.zeros(1)})
    with pytest.raises(ValueError, match="not consumed"):
        t_convert.t5_state_dict_from_hf(extra, 2)


@pytest.mark.parametrize("act", ["quick_gelu", "gelu"], ids=["clip_l", "clip_g"])
def test_clip_from_hf_matches_hf_and_jax(act):
    """CLIP-L's quick_gelu and bigG's erf gelu: final, penultimate and pooled
    outputs against HF and the JAX tower; the HF names are strict."""
    torch.manual_seed(0)
    hf_cfg = transformers.CLIPTextConfig(
        vocab_size=99, hidden_size=32, intermediate_size=64, num_hidden_layers=3,
        num_attention_heads=2, max_position_embeddings=16, projection_dim=24,
        eos_token_id=98, bos_token_id=97, hidden_act=act)
    hf = randomize(transformers.CLIPTextModelWithProjection(hf_cfg).eval(), seed=6, std=0.1)
    sd = hf.state_dict()
    kw = dict(vocab_size=99, hidden_size=32, intermediate_size=64, num_layers=3, num_heads=2,
              max_position_embeddings=16, projection_dim=24, hidden_act=act, eos_token_id=98)
    model = TCLIPTextEncoder(TCLIPTextConfig(**kw)).eval()
    model.load_state_dict(t_convert.clip_text_state_dict_from_hf(sd, 3))
    assert set(hf_clip_state_dict(model.state_dict())) == \
        set(sd) - {"text_model.embeddings.position_ids"}
    ids = torch.tensor([[97, 5, 6, 7, 98, 0, 0, 0], [97, 9, 98, 98, 3, 0, 0, 0]])
    with torch.no_grad():
        out = hf(ids, output_hidden_states=True)
        got = model(ids)
    params = j_convert.convert_clip_text({k: v.numpy() for k, v in sd.items()}, 3)
    jgot = JCLIPTextEncoder(JCLIPTextConfig(**kw)).apply({"params": params},
                                                       jnp.asarray(ids.numpy()))
    for g, h, j in zip(got, (out.last_hidden_state, out.hidden_states[-2], out.text_embeds),
                       jgot):
        np.testing.assert_allclose(g.numpy(), h.numpy(), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(g.numpy(), np.asarray(j), rtol=1e-5, atol=1e-5)
    sd = dict(sd, **{"text_model.embeddings.position_ids": torch.arange(16)[None]})
    t_convert.clip_text_state_dict_from_hf(sd, 3)  # the old buffer is consumed
    with pytest.raises(ValueError, match="not consumed"):
        t_convert.clip_text_state_dict_from_hf(dict(sd, extra=torch.zeros(1)), 3)


def test_configs_match_jax():
    for name in ("clip_l", "clip_g", "clip_h_text", "tiny"):
        got = getattr(TCLIPTextConfig, name)().__dict__
        want = dict(getattr(JCLIPTextConfig, name)().__dict__)
        want.pop("dtype")
        assert got == want, name
    for name in ("xxl", "umt5_xxl", "tiny"):
        got, want = dict(getattr(t_t5.T5Config, name)().__dict__), \
            dict(getattr(j_t5.T5Config, name)().__dict__)
        assert str(got.pop("dtype")) == f"torch.{jnp.dtype(want.pop('dtype'))}", name
        assert got == want, name


def test_compose_and_encoder_set_match_jax():
    """The composition (channel concat, zero pad to the T5 width, sequence
    concat, pooled L ++ G) and ``SD3TextEncoderSet.encode`` with injected
    encoders and tokenizers: exactly the JAX package's (one CLIP tokenizer
    handed to both towers, as the JAX class takes it); a second CLIP
    tokenizer reaches CLIP-G alone."""
    rng = np.random.default_rng(0)
    l_h, g_h = rng.standard_normal((2, 5, 6)), rng.standard_normal((2, 5, 10))
    l_p, g_p = rng.standard_normal((2, 4)), rng.standard_normal((2, 3))
    t5_h = rng.standard_normal((2, 7, 24))
    arrays = [a.astype(np.float32) for a in (l_h, l_p, g_h, g_p, t5_h)]
    want = j_ep.compose_sd3_prompt_embeds(*arrays)
    got = t_ep.compose_sd3_prompt_embeds(*(torch.from_numpy(a) for a in arrays))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got.prompt_embeds.shape == (2, 12, 24) and not got.prompt_embeds[:, :5, 16:].any()
    with pytest.raises(ValueError, match="T5 width"):
        t_ep.compose_sd3_prompt_embeds(*(torch.from_numpy(a) for a in arrays[:4]),
                                       torch.zeros(2, 7, 8))

    def fns(lib):  # fp32 numpy maps of the ids, handed over as ``lib`` arrays
        f32 = lambda a: lib(np.asarray(a, np.float32))  # noqa: E731

        def clip(width):
            return lambda ids: (f32(np.tanh(ids[..., None] * np.arange(1, width + 1))),
                                f32(np.tanh(ids[..., None] * np.arange(width) / 2)),
                                f32(ids[:, :width]))
        return (clip(6), clip(10), lambda ids: f32(np.cos(ids[..., None] * np.arange(24))),
                lambda p: np.array([[len(s) + i for i in range(5)] for s in p]),
                lambda p: np.array([[len(s) * i for i in range(7)] for s in p]))

    prompts = ["a flower", "", "a red bicycle"]
    want = j_ep.SD3TextEncoderSet(*fns(jnp.asarray)).encode(prompts)
    clip_l, clip_g, t5, tok_clip, tok_t5 = fns(torch.from_numpy)
    got = t_ep.SD3TextEncoderSet(clip_l, clip_g, t5, tok_clip, tok_clip, tok_t5).encode(prompts)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # CLIP-G takes the ids of its own tokenizer (the JAX class has one for both)
    tok_g = lambda p: tok_clip(p) + 3  # noqa: E731
    got = t_ep.SD3TextEncoderSet(clip_l, clip_g, t5, tok_clip, tok_g, tok_t5).encode(prompts)
    _, g_h, g_p = clip_g(tok_g(prompts))
    _, l_h, l_p = clip_l(tok_clip(prompts))
    for g, w in zip(got, t_ep.compose_sd3_prompt_embeds(l_h, l_p, g_h, g_p, t5(tok_t5(prompts)))):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


# ── the whole slice, from the tiny directory ─────────────────────────────────


@pytest.fixture(scope="module")
def sd3_dir(tmp_path_factory):
    return write_sd3_dir(str(tmp_path_factory.mktemp("sd3_dir")))


def _jax_t5_as_arrays(monkeypatch):
    """The JAX ``load_real_text_encoder`` jits T5 over the converter's numpy
    leaves, and its T5 indexes the numpy bias table with a traced array, which
    raises; the reference is run with the leaves as jax arrays (the JAX
    package itself is not changed)."""
    convert_t5 = j_convert.convert_t5_encoder
    monkeypatch.setattr(j_convert, "convert_t5_encoder", lambda sd, n: jax.tree_util.tree_map(
        jnp.asarray, convert_t5(sd, n)))


def test_precompute_embeds_stores_match_jax(sd3_dir, tmp_path, monkeypatch):
    """``cli.precompute_embeds`` of both packages over a dataset of the
    tokenizers' words, through the directory's tokenizers and real CLIP-L /
    CLIP-G / T5: the same prompts in the same order; the CLIP rows and the
    pooled ones within one fp16 spacing, the T5 rows within 2e-2 relative
    L2. A set ``text_embeds_dir`` and a directory without encoders refuse."""
    from adv_grpo_torch.cli import precompute_embeds as t_pre
    from adv_grpo_tpu.cli import precompute_embeds as j_pre

    _jax_t5_as_arrays(monkeypatch)
    ds = tmp_path / "ds"
    ds.mkdir()
    (ds / "train.txt").write_text("a flower\nflow er\nzebra\na flower\n")
    (ds / "test.txt").write_text("the fox\n")
    argv = ["--config", "smoke_sd3_fast", "--batch", "4", "--set", f"pretrained.model={sd3_dir}",
            "--set", f"dataset={ds}", "--set", "smoke_test=False"]
    j_pre.main(argv + ["--out", str(tmp_path / "j")])
    t_pre.main(argv + ["--out", str(tmp_path / "t"), "--device", "cpu"])
    stores = []
    for side in ("j", "t"):
        with open(tmp_path / side / "prompts.json") as f:
            prompts = json.load(f)
        stores.append((prompts, np.load(tmp_path / side / "embeds.npy"),
                       np.load(tmp_path / side / "pooled.npy")))
    (jp, je, jpool), (tp, te, tpool) = stores
    assert tp == jp == ["", "a flower", "flow er", "zebra", "the fox"]
    assert te.shape == je.shape == (5, 154, MCFG.joint_attention_dim) and te.dtype == np.float16
    for g, w in ((te[:, :77], je[:, :77]), (tpool, jpool)):
        w32 = w.astype(np.float32)
        assert np.all(np.abs(g.astype(np.float32) - w32) <= np.spacing(np.abs(w))), \
            np.abs(g.astype(np.float32) - w32).max()
    assert _rel_l2(te[:, 77:], je[:, 77:]) < 2e-2
    with pytest.raises(SystemExit):
        t_pre.main(argv + ["--out", str(tmp_path / "x"), "--device", "cpu",
                           "--set", f"text_embeds_dir={tmp_path / 't'}"])
    with pytest.raises(SystemExit):
        t_pre.main(argv[:4] + ["--set", "pretrained.model=", "--out", str(tmp_path / "x"),
                               "--device", "cpu"])


def test_infer_from_the_directory_matches_jax(sd3_dir, tmp_path, monkeypatch):
    """``cli.infer`` of both packages from the directory (live encoders, the
    MMDiT in fp32 with bf16-rounded weights, 3 steps of CFG 4.5 at 8x8
    latents), the JAX run's initial noise given to the port: the 8-bit images
    within 2 levels."""
    from PIL import Image

    from adv_grpo_torch.cli import infer as t_infer
    from adv_grpo_torch.train.pipeline import SD3Pipeline as TSD3Pipeline
    from adv_grpo_tpu.cli import infer as j_infer

    _jax_t5_as_arrays(monkeypatch)
    argv = ["--config", "eval_sd3_fast", "--prompts", "a flower", "--latent_hw", "8",
            "--set", f"pretrained.model={sd3_dir}", "--set", "mixed_precision=fp32",
            "--set", "sample.eval_num_steps=3"]
    jpath = j_infer.main(argv + ["--out_dir", str(tmp_path / "j")])[0]
    noise = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (1, 16, 8, 8)))
    monkeypatch.setattr(TSD3Pipeline, "prepare_latents",
                        lambda self, generator, batch, hw=None: torch.from_numpy(noise.copy()))
    tpath = t_infer.main(argv + ["--out_dir", str(tmp_path / "t"), "--device", "cpu"])[0]
    j_img = np.asarray(Image.open(jpath), np.int16)
    t_img = np.asarray(Image.open(tpath), np.int16)
    assert t_img.shape == j_img.shape == (16, 16, 3) and j_img.max() > j_img.min()
    assert np.abs(t_img - j_img).max() <= 2, np.abs(t_img - j_img).max()
    assert os.path.basename(tpath) == "node0_rank0_00000_0.png"


def test_pickscore_reward_tokenizes_with_the_local_clip_tokenizer(sd3_dir):
    """With ``<pretrained.model>/tokenizer`` present, the PickScore reward's
    token ids are that CLIP tokenizer's, padded and cut to 77, as the JAX
    package's ``build_reward_context`` makes them."""
    from adv_grpo_torch.cli.common import apply_overrides, build_reward_context, resolve_config
    from adv_grpo_tpu.cli import common as j_common
    from adv_grpo_tpu.cli.common import resolve_config as j_resolve_config

    overrides = ["smoke_test=True", f"pretrained.model={sd3_dir}"]
    ctx = build_reward_context(apply_overrides(resolve_config("pickscore_cotrain_sd3_fast"),
                                               overrides), {"pickscore"}, device="cpu")
    jctx = j_common.build_reward_context(
        j_common.apply_overrides(j_resolve_config("pickscore_cotrain_sd3_fast"), overrides),
        {"pickscore"})
    prompts = ["a flower", "zebra " * 40, ""]
    got = ctx.tokenize(prompts)
    np.testing.assert_array_equal(got, jctx.tokenize(prompts))
    assert got.shape == (3, 77) and got[0, 0] == 56 and got[2, 1] == 57
