"""Shared CLI plumbing: config presets, overrides, pipeline assembly, text
encoding.

Port of adv_grpo_tpu/cli/common.py:50-69 (``apply_overrides``), :88-240
(``build_pipeline`` for the sd3, flux and wan families, ``build_text_encoder``),
:242-258 (``make_hash_text_encoder``, the deterministic stand-in for the
text encoders, byte for byte the JAX package's embeddings), :261-320
(``load_real_text_encoder``: CLIP-L, CLIP-G and T5 from a local diffusers
directory) and the PickScore and DINO parts of :331-501
(``build_reward_context``).

Tokenizing needs the ``transformers`` package (``CLIPTokenizer``,
``T5TokenizerFast``, read from the directory's ``tokenizer{,_2,_3}/``),
imported only where a prompt is tokenized; without it those paths raise
naming it (there is no fall-back to the hash encoder), and a caller may
inject its own tokenizers instead.
"""

from __future__ import annotations

import ast
import functools
import os
import zlib
from typing import List, Optional

import numpy as np
import torch

__all__ = ["apply_overrides", "build_pipeline", "build_reward_context", "build_text_encoder",
           "compute_dtype", "hf_tokenizers", "load_real_text_encoder", "load_sd3_text_encoders",
           "make_hash_text_encoder", "make_sd3_encode", "resolve_config", "resolve_device"]

_FP32 = ("fp32", "float32", "no")
_BF16 = ("bf16", "bfloat16", "fp16", "float16")


def resolve_config(spec: str):
    """'module_path:preset' or a bare preset name -> config dict."""
    from adv_grpo_torch.config import grpo

    return grpo.get_config(spec.rsplit(":", 1)[-1])


def apply_overrides(config, overrides):
    """Apply 'a.b=value' override strings (the reference's --config.x=y flags).
    Values are python literals where they parse, raw strings otherwise."""
    for ov in overrides or []:
        key, sep, raw = ov.partition("=")
        if not sep:
            raise ValueError(f"override must be key=value, got {ov!r}")
        node = config
        parts = key.split(".")
        for p in parts[:-1]:
            node = node[p]
        try:
            val = ast.literal_eval(raw)
        except (ValueError, SyntaxError):
            val = raw
        node[parts[-1]] = val
    return config


def compute_dtype(config) -> torch.dtype:
    """The transformer dtype from ``mixed_precision`` ("fp16" maps to bf16)."""
    want = str(config.get("mixed_precision", "bf16"))
    if want not in _FP32 + _BF16:
        raise ValueError(f"Unrecognized mixed_precision {want!r}; expected one of "
                         f"{_FP32 + _BF16}")
    return torch.float32 if want in _FP32 else torch.bfloat16


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device that is not visible raises
    (there is no silent fall-back to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {str(device)!r} was asked for but no CUDA device is "
                           "visible; pass --device cpu to run on the CPU")
    return device


def _build_flux_pipeline(config, model_dir, lora_rank, latent_hw, device, generator):
    """The Flux branch (JAX :135-159): the tiny random-init model; a set
    ``pretrained.model`` (``FLUX_DIR``) raises, the Flux loader is not ported
    (ROADMAP Queue 1 item 5)."""
    from adv_grpo_torch.models.flux import FluxConfig
    from adv_grpo_torch.models.vae import VAEConfig
    from adv_grpo_torch.train.flux_pipeline import FluxPipeline

    if model_dir:
        raise NotImplementedError(
            f"loading the diffusers FluxTransformer2DModel at {model_dir!r} is not yet "
            "ported to adv_grpo_torch (ROADMAP Queue 1 item 5); unset FLUX_DIR for the "
            "tiny random-init model")
    fcfg = FluxConfig.tiny(lora_rank=max(lora_rank, 1) if lora_rank else 4)
    return FluxPipeline.random_init(
        generator, fcfg, VAEConfig.tiny(latent_channels=fcfg.in_channels // 4), device,
        latent_hw=latent_hw or 8, text_seq_len=6,
        guidance=float(config.sample.guidance_scale))


def _build_wan_pipeline(config, model_dir, lora_rank, latent_hw, device, generator, frames):
    """The WAN branch (JAX :160-188): the tiny random-init transformer and 3D
    VAE with 2 latent frames of ``latent_hw``; with ``frames``, the latents
    of that many video frames of ``config.resolution``^2 instead (the demo's
    sizing, cut to the patch). A set ``pretrained.model`` (``WAN_DIR``)
    raises, the WAN loaders are not ported (ROADMAP Queue 1 item 5)."""
    from adv_grpo_torch.models.wan import WanConfig
    from adv_grpo_torch.models.wan_vae import WanVAEConfig
    from adv_grpo_torch.train.wan_pipeline import WanPipeline

    if model_dir:
        raise NotImplementedError(
            f"loading the diffusers WanTransformer3DModel at {model_dir!r} is not yet "
            "ported to adv_grpo_torch (ROADMAP Queue 1 item 5); unset WAN_DIR for the "
            "tiny random-init model")
    wcfg = WanConfig.tiny(lora_rank=max(lora_rank, 1) if lora_rank else 4)
    c = wcfg.in_channels
    vcfg = WanVAEConfig.tiny(z_dim=c, latents_mean=(0.0,) * c, latents_std=(1.0,) * c)
    latent_hw, latent_frames = latent_hw or 8, 2
    if frames is not None:
        # frame counts are 1 mod the temporal factor; the grid tiles the patch
        pt, ph, _ = wcfg.patch_size
        sf = vcfg.spatial_factor
        latent_frames = vcfg.latent_frames(max(vcfg.temporal_factor + 1, frames))
        latent_hw = max(sf * 2, int(config.resolution)) // sf
        latent_frames = max(pt, latent_frames - latent_frames % pt)
        latent_hw = max(ph, latent_hw - latent_hw % ph)
    return WanPipeline.random_init(generator, wcfg, vcfg, device, latent_hw=latent_hw,
                                   latent_frames=latent_frames, text_seq_len=6)


def build_pipeline(config, latent_hw: Optional[int] = None, device="cuda",
                   frames: Optional[int] = None):
    """The pipeline for ``config`` on ``device``. sd3: the weights of a local
    diffusers-layout directory ``pretrained.model`` (``SD3Pipeline.from_pretrained``;
    check one first with ``python -m adv_grpo_torch.models.convert --src
    DIR``), else the tiny random-init model for ``smoke_test=True`` or the
    full-size SD3.5-M with random weights for ``pretrained.model=''``; any
    other ``pretrained.model`` raises. flux and wan: the tiny random-init
    model (wan: ``frames`` video frames when given). Random weights come from
    ``torch.Generator(seed)`` on that device."""
    from adv_grpo_torch.models.mmdit import MMDiTConfig
    from adv_grpo_torch.models.vae import VAEConfig
    from adv_grpo_torch.train.pipeline import SD3Pipeline

    device = resolve_device(device)
    model_dir = str(config.pretrained.model or "")
    smoke = bool(config.get("smoke_test", False))
    lora_rank = int(config.train.lora_rank) if config.use_lora else 0
    generator = torch.Generator(device=device).manual_seed(int(config.seed))
    family = str(config.get("model_family", "sd3") or "sd3")
    if family == "flux":
        return _build_flux_pipeline(config, model_dir, lora_rank, latent_hw, device,
                                    generator)
    if family == "wan":
        return _build_wan_pipeline(config, model_dir, lora_rank, latent_hw, device, generator,
                                   frames)
    if family != "sd3":
        raise NotImplementedError(f"model_family={family!r} is not yet ported to "
                                  "adv_grpo_torch (sd3, flux and wan only)")
    dtype = compute_dtype(config)
    if model_dir and os.path.isdir(model_dir):
        return SD3Pipeline.from_pretrained(model_dir, lora_rank=lora_rank,
                                           lora_alpha=float(config.train.lora_alpha),
                                           dtype=dtype, device=device)
    if model_dir and not smoke:
        raise FileNotFoundError(
            f"config.pretrained.model={model_dir!r} is not a local diffusers-layout "
            "weights directory (transformer/ vae/ text_encoder*/ with safetensors; check "
            "one with `python -m adv_grpo_torch.models.convert --src <dir>`); set "
            "smoke_test=True / pretrained.model='' for an explicitly random-init run")
    if smoke:
        mmdit_cfg = MMDiTConfig.tiny(num_layers=2, dual_attention_layers=(0,),
                                     lora_rank=max(lora_rank, 1) if lora_rank else 4)
        return SD3Pipeline.random_init(generator, mmdit_cfg,
                                       VAEConfig.tiny(latent_channels=16), device,
                                       text_seq_len=6)
    mmdit_cfg = MMDiTConfig.sd35_medium(lora_rank=lora_rank,
                                        lora_alpha=float(config.train.lora_alpha))
    return SD3Pipeline.random_init(generator, mmdit_cfg, VAEConfig.sd3(), device, dtype)


def build_text_encoder(config, pipeline):
    """Text-embedding source, by priority: a precomputed ``EmbeddingStore``
    when ``config.text_embeds_dir`` is set; the real CLIP-L + CLIP-G + T5
    stack when the diffusers directory has a ``text_encoder/``
    (:func:`load_real_text_encoder`); else the deterministic hash encoder at
    the model's widths."""
    store_dir = str(config.get("text_embeds_dir", ""))
    if store_dir:
        from adv_grpo_torch.data.embed_store import EmbeddingStore

        return EmbeddingStore(store_dir)
    model_dir = str(config.pretrained.model or "")
    if model_dir and os.path.isdir(os.path.join(model_dir, "text_encoder")):
        return load_real_text_encoder(config, pipeline)
    if getattr(pipeline, "family", "sd3") == "wan":
        # WAN has no pooled conditioning; the trainer still threads a pooled
        # array, so it gets a tiny dummy width
        return make_hash_text_encoder(seq_len=pipeline.text_seq_len,
                                      embed_dim=pipeline.wan_cfg.text_dim, pooled_dim=8)
    mcfg = getattr(pipeline, "mmdit_cfg", None) or pipeline.flux_cfg
    return make_hash_text_encoder(seq_len=pipeline.text_seq_len,
                                  embed_dim=mcfg.joint_attention_dim,
                                  pooled_dim=mcfg.pooled_projection_dim)


def _transformers(what: str, remedy: str):
    """The ``transformers`` package, imported here only; without it, an
    ``ImportError`` that names it, what needed it and ``remedy``."""
    try:
        import transformers
    except ImportError as e:
        raise ImportError(
            f"{what} needs the `transformers` package (its tokenizers read the local "
            f"tokenizer files), which is not installed here. {remedy}") from e
    return transformers


def hf_tokenizers(root: str, t5_len: int):
    """The three tokenize callables of an SD3 directory (``tokenizer/``,
    ``tokenizer_2/``: ``CLIPTokenizer`` padded and cut to 77;
    ``tokenizer_3/``: ``T5TokenizerFast`` to ``t5_len``), each mapping a list
    of prompts to an int array of token ids."""
    transformers = _transformers(
        "tokenizing prompts for the SD3 text encoders",
        "Precompute the prompt embeddings where it is (python -m "
        "adv_grpo_torch.cli.precompute_embeds) and set text_embeds_dir, or inject tokenizers")
    tok1 = transformers.CLIPTokenizer.from_pretrained(os.path.join(root, "tokenizer"))
    tok2 = transformers.CLIPTokenizer.from_pretrained(os.path.join(root, "tokenizer_2"))
    tok3 = transformers.T5TokenizerFast.from_pretrained(os.path.join(root, "tokenizer_3"))

    def ids(tok, max_length):
        return lambda prompts: tok(prompts, padding="max_length", max_length=max_length,
                                   truncation=True, return_tensors="np").input_ids

    return ids(tok1, 77), ids(tok2, 77), ids(tok3, t5_len)


def load_sd3_text_encoders(root: str, device):
    """(CLIP-L, CLIP-G, T5) from ``text_encoder{,_2,_3}/`` of a local SD3
    directory, on ``device``, in eval mode. As the JAX loader: each CLIP takes
    its width, depth, heads, projection, activation and EOS id from its
    ``config.json`` and keeps the default vocabulary (49,408) and 77
    positions; T5 takes d_model, d_kv, d_ff, layers and heads, keeps vocab
    32,128 and runs in bf16 (fp32 norms and scores). CLIP runs in fp32."""
    import json

    from adv_grpo_torch.models import convert
    from adv_grpo_torch.models.clip_text import CLIPTextConfig, CLIPTextEncoder
    from adv_grpo_torch.models.t5 import T5Config, T5Encoder
    from adv_grpo_torch.train.pipeline import _build

    def config_json(sub):
        with open(os.path.join(root, sub, "config.json")) as f:
            return json.load(f)

    def load(module, sd):
        module.load_state_dict(sd)
        return module.requires_grad_(False)

    def clip(sub, factory):
        c = config_json(sub)
        cfg = factory(hidden_size=c["hidden_size"], intermediate_size=c["intermediate_size"],
                      num_layers=c["num_hidden_layers"], num_heads=c["num_attention_heads"],
                      projection_dim=c["projection_dim"], hidden_act=c["hidden_act"],
                      eos_token_id=c.get("eos_token_id", 49407))
        sd = convert.clip_text_state_dict_from_hf(
            convert.load_torch_state_dict(os.path.join(root, sub)), cfg.num_layers)
        return load(_build(CLIPTextEncoder, cfg, device), sd)

    clip_l = clip("text_encoder", CLIPTextConfig.clip_l)
    clip_g = clip("text_encoder_2", CLIPTextConfig.clip_g)
    c = config_json("text_encoder_3")
    cfg = T5Config(d_model=c["d_model"], d_kv=c["d_kv"], d_ff=c["d_ff"],
                   num_layers=c["num_layers"], num_heads=c["num_heads"])
    sd = convert.t5_state_dict_from_hf(
        convert.load_torch_state_dict(os.path.join(root, "text_encoder_3")), cfg.num_layers)
    return clip_l, clip_g, load(_build(T5Encoder, cfg, device), sd)


def make_sd3_encode(encoders, tokenizers, device):
    """``encode(prompts) -> (embeds, pooled)`` (fp32 numpy) over the three
    encoders and their three tokenize callables, through
    ``SD3TextEncoderSet``: the CLIPs' penultimate hidden states and pooled
    projections with T5's hidden states, composed by
    ``compose_sd3_prompt_embeds``."""
    from adv_grpo_torch.models.encode_prompt import SD3TextEncoderSet

    device = torch.device(device)

    def on_device(module):
        return lambda a: module(torch.as_tensor(np.asarray(a), dtype=torch.long,
                                                device=device))

    encoder_set = SD3TextEncoderSet(*(on_device(m) for m in encoders), *tokenizers)

    def encode(prompts: List[str]):
        with torch.inference_mode():
            out = encoder_set.encode(prompts)
        return (out.prompt_embeds.float().cpu().numpy(),
                out.pooled_prompt_embeds.float().cpu().numpy())

    return encode


def load_real_text_encoder(config, pipeline, tokenizers=None):
    """CLIP-L + CLIP-G + T5 of the local diffusers directory
    ``config.pretrained.model`` on the pipeline's device, behind
    ``encode(prompts) -> (embeds (B, text_seq_len, 4096), pooled (B, 2048))``
    (the reference ``compute_text_embeddings``). T5 gets ``text_seq_len - 77``
    tokens. ``tokenizers``: three tokenize callables; by default the
    directory's HF tokenizers (:func:`hf_tokenizers`, which need
    ``transformers`` and raise without it, before any weight is read)."""
    root = str(config.pretrained.model)
    if tokenizers is None:
        tokenizers = hf_tokenizers(root, pipeline.text_seq_len - 77)
    return make_sd3_encode(load_sd3_text_encoders(root, pipeline.device), tokenizers,
                           pipeline.device)


DINO_REWARDS = {"image_similarity", "image_similarity_eval", "dino_cotrain",
                "dino_patch_cotrain", "dino_multi_cotrain"}


def build_reward_context(config, reward_names, device="cuda"):
    """The ``RewardContext`` for the reward names a preset uses (the ported
    ones: the PickScore and DINO rewards), on ``device``.

    PickScore: ``smoke_test`` takes the tiny towers (image 28); otherwise
    CLIP-H with random weights from ``config.seed + 1``, with a warning: the
    PickScore checkpoint loader is not ported, so a set ``PICKSCORE_DIR``
    raises. The token ids come from the local CLIP tokenizer
    ``<pretrained.model>/tokenizer`` where there is one (padded and cut to 77;
    it needs ``transformers`` and raises without it, a precomputed
    ``text_embeds_dir`` or not), else they are the constant 3 at the text
    tower's length, as the JAX package's are.

    DINO (:func:`_dino_context`): ``smoke_test`` takes a tiny DINOv2 (28^2,
    2 layers of 32, 2 heads); otherwise DINOv2-B/14 at 518^2 with random
    weights from ``config.seed + 3``, with a warning; a set ``DINOV2_DIR``
    raises (its loader is not ported)."""
    from adv_grpo_torch.models.clip_text import CLIPTextConfig
    from adv_grpo_torch.models.vit import ViTConfig
    from adv_grpo_torch.rewards.registry import RewardContext
    from adv_grpo_torch.rewards.scorers import PickScoreScorer

    ctx = RewardContext()
    if set(reward_names) & DINO_REWARDS:
        _dino_context(ctx, config, set(reward_names), resolve_device(device))
    if not set(reward_names) & {"pickscore", "pickscore_cotrain"}:
        return ctx
    if os.environ.get("PICKSCORE_DIR", ""):
        raise NotImplementedError(
            f"PICKSCORE_DIR={os.environ['PICKSCORE_DIR']!r}: loading a PickScore checkpoint "
            "is not yet ported to adv_grpo_torch; unset it for random CLIP-H weights")
    tok_dir = os.path.join(str(config.pretrained.model or ""), "tokenizer")
    tok = None
    if str(config.pretrained.model or "") and os.path.isdir(tok_dir):
        tok = _transformers(
            "the PickScore reward's CLIP tokenizer",
            "text_embeds_dir does not help: the reward tokenizes every prompt itself, so "
            "a PickScore preset cannot run from a diffusers directory with a tokenizer/ "
            "until tokenizers that need no `transformers` are ported").CLIPTokenizer \
            .from_pretrained(tok_dir)
    device = resolve_device(device)
    generator = torch.Generator(device=device).manual_seed(int(config.seed) + 1)
    if bool(config.get("smoke_test", False)):
        ps = PickScoreScorer.random_init(generator, device, CLIPTextConfig.tiny(projection_dim=16),
                                         ViTConfig.tiny(projection_dim=16), image_size=28)
    else:
        import warnings

        warnings.warn("PickScore CLIP-H scorer is RANDOM-INIT: its checkpoint loader is not "
                      "yet ported to adv_grpo_torch", stacklevel=2)
        ps = PickScoreScorer.random_init(generator, device)
    max_len = ps.clip.text_model.cfg.max_position_embeddings
    ctx.pickscore = ps
    if tok is not None:
        ctx.tokenize = lambda prompts: tok(prompts, padding="max_length", max_length=77,
                                           truncation=True, return_tensors="np").input_ids
    else:
        ctx.tokenize = lambda prompts: np.full((len(prompts), max_len), 3, np.int32)
    return ctx


def _dino_context(ctx, config, reward_names, device):
    """The DINO scorer, its live head, the patch generator (seeded from
    ``config.seed + 2``) and, for ``dino_multi_cotrain``, the multi-layer
    scorer and its heads. Its layers are ``config.dino_multi_layer_ids``
    (the JAX default 8 where unset); the tiny smoke backbone has two, so
    ``smoke_test`` takes layer 1."""
    from adv_grpo_torch.models.vit import ViTConfig
    from adv_grpo_torch.rewards.scorers import DINOMultiScorer, DINOScorer

    if os.environ.get("DINOV2_DIR", ""):
        raise NotImplementedError(
            f"DINOV2_DIR={os.environ['DINOV2_DIR']!r}: loading a DINOv2 checkpoint is not yet "
            "ported to adv_grpo_torch; unset it for random DINOv2-B/14 weights")
    smoke = bool(config.get("smoke_test", False))
    generator = torch.Generator(device=device).manual_seed(int(config.seed) + 3)
    if smoke:
        dino = DINOScorer.random_init(
            generator, device, ViTConfig.dinov2_base(image_size=28, num_layers=2, hidden_size=32,
                                                     intermediate_size=64, num_heads=2),
            image_size=28)
    else:
        import warnings

        warnings.warn("DINOv2 backbone is RANDOM-INIT: its checkpoint loader is not yet "
                      "ported to adv_grpo_torch", stacklevel=3)
        dino = DINOScorer.random_init(generator, device)
    ctx.dino = dino
    ctx.dino_head_params = dino.init_head(generator)
    ctx.rng = torch.Generator(device=device).manual_seed(int(config.seed) + 2)
    if "dino_multi_cotrain" in reward_names:
        layer_ids = (1,) if smoke else tuple(config.get("dino_multi_layer_ids", None) or (8,))
        ctx.dino_multi = DINOMultiScorer(dino, layer_ids=layer_ids,
                                         temperature=float(config.get("temperature", 0.2)))
        ctx.dino_multi_params = ctx.dino_multi.init_heads(generator)


def make_hash_text_encoder(seq_len: int, embed_dim: int, pooled_dim: int):
    """Deterministic per-prompt pseudo-embeddings: N(0, 0.2) from a numpy
    generator seeded by the prompt's crc32 (stable across processes, unlike
    ``hash()``), distinct across prompts."""

    @functools.lru_cache(maxsize=4096)
    def _one(prompt: str):
        rng = np.random.default_rng(zlib.crc32(prompt.encode()))
        return (rng.normal(0, 0.2, (seq_len, embed_dim)).astype(np.float32),
                rng.normal(0, 0.2, (pooled_dim,)).astype(np.float32))

    def encode(prompts: List[str]):
        pairs = [_one(p) for p in prompts]
        return np.stack([e for e, _ in pairs]), np.stack([p for _, p in pairs])

    return encode
