"""Shared CLI plumbing: config presets, overrides, pipeline assembly, text
encoding.

Port of adv_grpo_tpu/cli/common.py:50-69 (``apply_overrides``), :88-240
(``build_pipeline`` for the sd3, flux and wan families, ``build_text_encoder``),
:242-258 (``make_hash_text_encoder``, the deterministic stand-in for the
text encoders, byte for byte the JAX package's embeddings), :261-320
(``load_real_text_encoder``: CLIP-L, CLIP-G and T5 from a local diffusers
directory), :323-328 (``_scorer_weights_dir``) and :331-557 (``build_reward_context``: the
scorers from their checkpoints, ``PICKSCORE_DIR``, ``DINOV2_DIR``,
``CLIP_DIR``, ``SIGLIP_DIR``, ..., else random weights, and the remote
judges).

Prompts are tokenized by ``data.tokenizers`` from the directory's
``tokenizer{,_2,_3}/`` (the JAX package's ``transformers.CLIPTokenizer`` /
``T5TokenizerFast``, id for id, in plain Python); a caller may inject its
own tokenizers instead.
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
           "compute_dtype", "join_group", "load_real_text_encoder", "load_sd3_text_encoders",
           "make_hash_text_encoder", "make_sd3_encode", "resolve_config", "resolve_device",
           "sd3_tokenizers"]

_FP32 = ("fp32", "float32", "no")
_BF16 = ("bf16", "bfloat16", "fp16", "float16")


def resolve_config(spec: str):
    """'module_path:preset' or a bare preset name -> config dict, searching
    the grpo, sft and dpo registries in that order (the reference's
    ``--config config/{grpo,sft,dpo}.py:name``)."""
    from adv_grpo_torch.config import dpo, grpo, sft

    preset = spec.rsplit(":", 1)[-1]
    for mod in (grpo, sft, dpo):
        try:
            return mod.get_config(preset)
        except KeyError:
            continue
    raise KeyError(f"config preset {preset!r} is unknown or not yet ported to adv_grpo_torch "
                   f"(ported: {sorted({*grpo._PRESETS, *sft._PRESETS, *dpo._PRESETS})})")


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


def join_group(device):
    """Join the process group that the environment describes (``torchrun``),
    one device per process: ``cuda`` then means ``cuda:$LOCAL_RANK``, and
    the group uses NCCL there, gloo on the CPU. Returns the device (without
    such an environment, ``device`` as given)."""
    from adv_grpo_torch.parallel import mesh

    if mesh.env_requests_group():
        if device == "cuda":
            device = resolve_device(f"cuda:{mesh.local_rank()}")
            torch.cuda.set_device(device)
        mesh.init_distributed(device=device)
    return device


def _build_flux_pipeline(config, model_dir, lora_rank, latent_hw, device, generator):
    """The Flux branch (JAX :135-159): a local diffusers
    ``FluxTransformer2DModel`` directory ``pretrained.model`` (``FLUX_DIR``,
    ``<root>/transformer``, the VAE from ``<root>/vae``) through
    ``FluxPipeline.from_pretrained`` in ``compute_dtype(config)`` with
    ``tpu.remat``; else, for ``smoke_test=True``, the tiny random-init model
    (no remat, as the JAX tiny config). A set path that is not a directory
    raises unless ``smoke_test``."""
    from adv_grpo_torch.models.flux import FluxConfig
    from adv_grpo_torch.models.vae import VAEConfig
    from adv_grpo_torch.train.flux_pipeline import FluxPipeline

    guidance = float(config.sample.guidance_scale)
    if model_dir and os.path.isdir(model_dir):
        return FluxPipeline.from_pretrained(
            model_dir, lora_rank=lora_rank, lora_alpha=float(config.train.lora_alpha),
            dtype=compute_dtype(config), guidance=guidance, remat=bool(config.tpu.remat),
            latent_hw=latent_hw or int(config.resolution) // 8, device=device)
    if model_dir and not bool(config.get("smoke_test", False)):
        raise FileNotFoundError(
            f"config.pretrained.model={model_dir!r} is not a local diffusers "
            "FluxTransformer2DModel directory; set FLUX_DIR to <root>/transformer (the VAE "
            "is read from <root>/vae), or smoke_test=True for the random-init model")
    fcfg = FluxConfig.tiny(lora_rank=max(lora_rank, 1) if lora_rank else 4)
    return FluxPipeline.random_init(
        generator, fcfg, VAEConfig.tiny(latent_channels=fcfg.in_channels // 4), device,
        latent_hw=latent_hw or 8, text_seq_len=6, guidance=guidance)


def _wan_grid(wcfg, vcfg, resolution: int, frames: int):
    """(latent_frames, latent_hw) of ``frames`` video frames of
    ``resolution``^2, cut to tile the patch (frame counts are 1 mod the
    temporal factor)."""
    pt, ph, _ = wcfg.patch_size
    sf = vcfg.spatial_factor
    latent_frames = vcfg.latent_frames(max(vcfg.temporal_factor + 1, frames))
    latent_hw = max(sf * 2, resolution) // sf
    return max(pt, latent_frames - latent_frames % pt), max(ph, latent_hw - latent_hw % ph)


def _build_wan_pipeline(config, model_dir, lora_rank, latent_hw, device, generator, frames):
    """The WAN branch (JAX :160-188): a local diffusers
    ``WanTransformer3DModel`` directory ``pretrained.model`` (``WAN_DIR``,
    ``<root>/transformer``, the VAE from ``<root>/vae``) through
    ``WanPipeline.from_pretrained`` in ``compute_dtype(config)`` with
    ``tpu.remat``, with 1 + (``sample.num_frames`` - 1) // 4 latent frames;
    else, for ``smoke_test=True``, the tiny random-init transformer (no
    remat) and 3D VAE with 2 latent frames of ``latent_hw``. With ``frames``
    (the demo's sizing) the latent grid of that many video frames of
    ``config.resolution``^2 instead, in both. A set path that is not a directory raises unless
    ``smoke_test``."""
    from adv_grpo_torch.models.wan import WanConfig
    from adv_grpo_torch.models.wan_vae import WanVAEConfig
    from adv_grpo_torch.train.wan_pipeline import WanPipeline

    if model_dir and os.path.isdir(model_dir):
        num_frames = int(config.sample.get("num_frames", 9))
        pipeline = WanPipeline.from_pretrained(
            model_dir, lora_rank=lora_rank, lora_alpha=float(config.train.lora_alpha),
            dtype=compute_dtype(config), remat=bool(config.tpu.remat),
            latent_frames=1 + (num_frames - 1) // 4,
            latent_hw=latent_hw or int(config.resolution) // 8, device=device)
        if frames is not None:
            pipeline.latent_frames, pipeline.latent_hw = _wan_grid(
                pipeline.wan_cfg, pipeline.vae_cfg, int(config.resolution), frames)
        return pipeline
    if model_dir and not bool(config.get("smoke_test", False)):
        raise FileNotFoundError(
            f"config.pretrained.model={model_dir!r} is not a local diffusers "
            "WanTransformer3DModel directory; set WAN_DIR to <root>/transformer (the VAE is "
            "read from <root>/vae), or smoke_test=True for the random-init model")
    wcfg = WanConfig.tiny(lora_rank=max(lora_rank, 1) if lora_rank else 4)
    c = wcfg.in_channels
    vcfg = WanVAEConfig.tiny(z_dim=c, latents_mean=(0.0,) * c, latents_std=(1.0,) * c)
    latent_frames, latent_hw = 2, latent_hw or 8
    if frames is not None:
        latent_frames, latent_hw = _wan_grid(wcfg, vcfg, int(config.resolution), frames)
    return WanPipeline.random_init(generator, wcfg, vcfg, device, latent_hw=latent_hw,
                                   latent_frames=latent_frames, text_seq_len=6)


def build_pipeline(config, latent_hw: Optional[int] = None, device="cuda",
                   frames: Optional[int] = None):
    """The pipeline for ``config`` on ``device``. sd3: the weights of a local
    diffusers-layout directory ``pretrained.model`` (``SD3Pipeline.from_pretrained``;
    check one first with ``python -m adv_grpo_torch.models.convert --src
    DIR``), else the tiny random-init model for ``smoke_test=True`` or the
    full-size SD3.5-M with random weights for ``pretrained.model=''``; any
    other ``pretrained.model`` raises. flux and wan: the diffusers
    transformer directory ``pretrained.model`` (``FLUX_DIR`` / ``WAN_DIR``,
    with ``vae/`` beside it), else the tiny random-init model for
    ``smoke_test=True`` (wan: ``frames`` video frames when given). Random
    weights come from ``torch.Generator(seed)`` on that device. The sd3
    models, and the flux and wan ones from a directory, checkpoint their
    blocks in training as ``tpu.remat`` / ``tpu.remat_policy`` say."""
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
    # the blocks' activation checkpointing (JAX :122-123, :193-194)
    remat = dict(remat=bool(config.tpu.remat),
                 remat_policy=str(config.tpu.get("remat_policy", "save_attn")))
    if model_dir and os.path.isdir(model_dir):
        return SD3Pipeline.from_pretrained(model_dir, lora_rank=lora_rank,
                                           lora_alpha=float(config.train.lora_alpha),
                                           dtype=dtype, device=device, **remat)
    if model_dir and not smoke:
        raise FileNotFoundError(
            f"config.pretrained.model={model_dir!r} is not a local diffusers-layout "
            "weights directory (transformer/ vae/ text_encoder*/ with safetensors; check "
            "one with `python -m adv_grpo_torch.models.convert --src <dir>`); set "
            "smoke_test=True / pretrained.model='' for an explicitly random-init run")
    if smoke:
        mmdit_cfg = MMDiTConfig.tiny(num_layers=2, dual_attention_layers=(0,),
                                     lora_rank=max(lora_rank, 1) if lora_rank else 4, **remat)
        return SD3Pipeline.random_init(generator, mmdit_cfg,
                                       VAEConfig.tiny(latent_channels=16), device,
                                       text_seq_len=6)
    mmdit_cfg = MMDiTConfig.sd35_medium(lora_rank=lora_rank,
                                        lora_alpha=float(config.train.lora_alpha), **remat)
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


def sd3_tokenizers(root: str, t5_len: int):
    """The three tokenize callables of an SD3 directory (``tokenizer/``,
    ``tokenizer_2/``: CLIP, padded and cut to 77; ``tokenizer_3/``: T5 to
    ``t5_len``), each mapping a list of prompts to an int64 array of token
    ids (``data.tokenizers``)."""
    from adv_grpo_torch.data.tokenizers import CLIPTokenizer, T5Tokenizer

    t5 = T5Tokenizer(os.path.join(root, "tokenizer_3"))
    return (CLIPTokenizer(os.path.join(root, "tokenizer")),
            CLIPTokenizer(os.path.join(root, "tokenizer_2")),
            lambda prompts: t5(prompts, t5_len))


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
    directory's (:func:`sd3_tokenizers`)."""
    root = str(config.pretrained.model)
    if tokenizers is None:
        tokenizers = sd3_tokenizers(root, pipeline.text_seq_len - 77)
    return make_sd3_encode(load_sd3_text_encoders(root, pipeline.device), tokenizers,
                           pipeline.device)


DINO_REWARDS = {"image_similarity", "image_similarity_eval", "dino_cotrain",
                "dino_patch_cotrain", "dino_multi_cotrain"}


def _scorer_weights_dir(name: str) -> Optional[str]:
    """The local scorer checkpoint directory in the environment variable
    ``name``; unset, empty or a path that does not exist: None."""
    path = os.environ.get(name, "")
    return path if path and os.path.exists(path) else None


def _warn_random(what: str, env: str) -> None:
    import warnings

    warnings.warn(f"{what} scorer is RANDOM-INIT: set {env} to a local checkpoint directory "
                  "for real reward values", stacklevel=3)


def build_reward_context(config, reward_names, device="cuda", ocr_engine=None):
    """The ``RewardContext`` for the reward names a preset uses (the ported
    ones: PickScore, CLIP-L, aesthetic, OCR and DINO), on ``device``.

    PickScore: CLIP-H (``smoke_test``: the tiny towers, image 28), from the
    HF ``CLIPModel`` checkpoint in ``PICKSCORE_DIR``
    (``convert.clip_model_state_dict_from_hf``, strict), else random weights
    from ``config.seed + 1``, with a warning unless ``smoke_test``; a set
    path that does not exist counts as unset. The token ids come from the
    CLIP tokenizer ``<pretrained.model>/tokenizer`` where there is one
    (padded and cut to 77), else they are the constant 3 at the text tower's
    length, as the JAX package's are.

    DINO (:func:`_dino_context`): DINOv2-B/14 at 518^2 (``smoke_test``: 28^2,
    2 layers of 32, 2 heads) from the checkpoint in ``DINOV2_DIR``, timm's
    or HF's layout, else random weights from ``config.seed + 3`` with the
    same warning.

    ``clipscore`` and ``aesthetic`` (:func:`_clip_l_context`): CLIP-L/14;
    OCR (``ocr``, ``video_ocr``): ``ocr_engine``, a callable uint8 (H, W, 3)
    -> str, else PaddleOCR where it can be imported (with neither the
    reward raises when called).

    ``pickscore_patch`` and ``constractive_external`` score with the
    PickScore scorer above. The rest (:func:`_remaining_context`): SigLIP
    so400m from ``SIGLIP_DIR``, the StyleGAN D of ``discriminator`` (from a
    ``STYLEGAN_D_PATH`` ``.msgpack``), the judges at ``GENEVAL_URL``,
    ``DEQA_URL`` and ``UNIFIEDREWARD_URL``, the Qwen2.5-VL judge of
    ``QWENVL_MODEL_DIR`` and ImageReward (``IMAGEREWARD_PATH``)."""
    from adv_grpo_torch.models import convert
    from adv_grpo_torch.models.clip_text import CLIPTextConfig
    from adv_grpo_torch.models.vit import ViTConfig
    from adv_grpo_torch.rewards.host import OcrScorer, VideoOcrScorer
    from adv_grpo_torch.rewards.registry import RewardContext
    from adv_grpo_torch.rewards.scorers import PickScoreScorer

    ctx = RewardContext()
    device = resolve_device(device)
    smoke = bool(config.get("smoke_test", False))
    names = set(reward_names)
    if names & DINO_REWARDS:
        _dino_context(ctx, config, names, device)
    if names & {"clipscore", "aesthetic"}:
        _clip_l_context(ctx, config, names, device)
    if names & {"ocr", "video_ocr"}:
        # video_ocr scores the every-4th-frame mean of each clip
        ctx.ocr = (VideoOcrScorer if "video_ocr" in names else OcrScorer)(ocr_engine)
    _remaining_context(ctx, config, names, device)
    if not names & {"pickscore", "pickscore_cotrain", "pickscore_patch",
                    "constractive_external"}:
        return ctx
    if smoke:
        towers = CLIPTextConfig.tiny(projection_dim=16), ViTConfig.tiny(projection_dim=16), 28
    else:
        towers = CLIPTextConfig.clip_h_text(), ViTConfig.clip_h(), 224
    ps_dir = _scorer_weights_dir("PICKSCORE_DIR")
    if ps_dir:
        sd = convert.clip_model_state_dict_from_hf(convert.load_torch_state_dict(ps_dir),
                                                   *towers[:2])
        ps = PickScoreScorer.from_state_dict(sd, device, *towers)
        del sd
    else:
        if not smoke:
            _warn_random("PickScore CLIP-H", "PICKSCORE_DIR")
        generator = torch.Generator(device=device).manual_seed(int(config.seed) + 1)
        ps = PickScoreScorer.random_init(generator, device, *towers)
    ctx.pickscore = ps
    ctx.tokenize = _clip_tokenize(config, ps.clip.text_model.cfg.max_position_embeddings)
    return ctx


def _remaining_context(ctx, config, reward_names, device):
    """The scorers of the JAX branches adv_grpo_tpu/cli/common.py:444-463,
    :509-557. Random weights warn unless ``smoke_test``.

    * ``siglip_image_similarity`` / ``siglip_cotrain``: SigLIP so400m at
      384^2 (``smoke_test``: the tiny tower at 28^2) from the HF
      ``SiglipVisionModel`` (or ``SiglipModel``) checkpoint in
      ``SIGLIP_DIR``, else random from ``config.seed + 6``; its head drawn
      from that generator after the backbone.
    * ``discriminator``: the StyleGAN D at ``config.resolution`` (``smoke_test``:
      base 8 at 32^2), random from ``config.seed + 7``, or the JAX D's
      parameters in ``STYLEGAN_D_PATH``: a flax ``.msgpack``
      (``flax.serialization.to_bytes`` of the JAX params), read with
      ``utils.msgpack_io``. The JAX CLI restores an orbax directory there,
      which needs JAX; a directory raises, naming the way across.
    * ``geneval``, ``deqa``, ``unifiedreward``: the clients of
      ``rewards.remote`` at ``GENEVAL_URL`` / ``DEQA_URL`` /
      ``UNIFIEDREWARD_URL`` (or the JAX defaults); a URL ending in ``/v1``
      speaks the sglang protocol, any other the pickle one.
    * ``qwenvl``: ``QwenVLScorer(QWENVL_MODEL_DIR)``; ``imagereward``:
      ``ImageRewardScorer(IMAGEREWARD_PATH)`` on ``device`` (its own model
      needs ``IMAGEREWARD_PT`` or that path, and ``BERT_TOKENIZER_DIR``)."""
    smoke = bool(config.get("smoke_test", False))
    if reward_names & {"siglip_image_similarity", "siglip_cotrain"}:
        from adv_grpo_torch.models import convert
        from adv_grpo_torch.models.siglip import SigLIPVisionConfig
        from adv_grpo_torch.rewards.scorers import SigLIPScorer

        cfg, size = ((SigLIPVisionConfig.tiny(), 28) if smoke
                     else (SigLIPVisionConfig.so400m(), 384))
        generator = torch.Generator(device=device).manual_seed(int(config.seed) + 6)
        sig_dir = _scorer_weights_dir("SIGLIP_DIR")
        if sig_dir:
            sd = convert.siglip_state_dict_from_hf(convert.load_torch_state_dict(sig_dir), cfg)
            ctx.siglip = SigLIPScorer.from_state_dict(sd, device, cfg, size)
        else:
            if not smoke:
                _warn_random("SigLIP", "SIGLIP_DIR")
            ctx.siglip = SigLIPScorer.random_init(generator, device, cfg, size)
        ctx.siglip_head_params = ctx.siglip.init_head(generator)
    if "discriminator" in reward_names:
        from adv_grpo_torch.models import convert
        from adv_grpo_torch.models.stylegan_d import StyleGANDConfig, StyleGANScorer
        from adv_grpo_torch.utils import msgpack_io

        cfg = (StyleGANDConfig(image_size=32, base_channels=8) if smoke
               else StyleGANDConfig(image_size=int(config.resolution)))
        sg_path = os.environ.get("STYLEGAN_D_PATH")
        if sg_path:  # pretrained D weights (the reference's usage, :611)
            if os.path.isdir(sg_path):
                raise ValueError(
                    f"STYLEGAN_D_PATH={sg_path} is a directory (an orbax checkpoint, which "
                    "needs JAX); write the JAX D's parameters as a flax .msgpack "
                    "(flax.serialization.to_bytes(params)) and point STYLEGAN_D_PATH at it")
            sd = convert.stylegan_state_dict_from_jax(msgpack_io.load(sg_path), cfg)
            ctx.stylegan = StyleGANScorer.from_state_dict(sd, device, cfg)
        else:
            generator = torch.Generator(device=device).manual_seed(int(config.seed) + 7)
            ctx.stylegan = StyleGANScorer.random_init(generator, device, cfg)
    if reward_names & {"geneval", "deqa", "unifiedreward"}:
        from adv_grpo_torch.rewards import remote

        if "geneval" in reward_names:
            ctx.remote["geneval"] = remote.geneval_score_client(
                os.environ.get("GENEVAL_URL", remote.GENEVAL_URL))
        if "deqa" in reward_names:
            ctx.remote["deqa"] = remote.deqa_score_client(
                os.environ.get("DEQA_URL", remote.DEQA_URL))
        if "unifiedreward" in reward_names:
            url = os.environ.get("UNIFIEDREWARD_URL", remote.UNIFIEDREWARD_SGLANG_URL)
            # /v1 endpoints speak the OpenAI-compatible sglang protocol (the
            # reference has both, rewards.py:884, 942)
            ctx.remote["unifiedreward"] = (
                remote.unifiedreward_sglang_client(url) if url.rstrip("/").endswith("/v1")
                else remote.unifiedreward_remote_client(url))
    if "qwenvl" in reward_names:
        from adv_grpo_torch.rewards.vlm import QwenVLScorer

        judge = QwenVLScorer(model_dir=os.environ.get("QWENVL_MODEL_DIR"), device=device)
        ctx.remote["qwenvl"] = lambda imgs, prompts, meta=None: judge(imgs, prompts)
    if "imagereward" in reward_names:
        from adv_grpo_torch.rewards.vlm import ImageRewardScorer

        ir = ImageRewardScorer(model_path=os.environ.get("IMAGEREWARD_PATH"), device=device)
        ctx.remote["imagereward"] = lambda imgs, prompts, meta=None: ir(imgs, prompts)


def _clip_tokenize(config, max_len: int):
    """The reward towers' token ids: the CLIP tokenizer
    ``<pretrained.model>/tokenizer`` where there is one (padded and cut to
    77), else the constant 3 at ``max_len``, as the JAX package's are."""
    tok_dir = os.path.join(str(config.pretrained.model or ""), "tokenizer")
    if str(config.pretrained.model or "") and os.path.isdir(tok_dir):
        from adv_grpo_torch.data.tokenizers import CLIPTokenizer

        tok = CLIPTokenizer(tok_dir)
        return lambda prompts: tok(prompts, 77)
    return lambda prompts: np.full((len(prompts), max_len), 3, np.int32)


def _clip_l_context(ctx, config, reward_names, device):
    """The CLIP-L/14 scorers (``smoke_test``: the JAX package's tiny towers
    at 28^2, the aesthetic tower projecting to 768). ``clipscore``: both
    towers from the HF ``CLIPModel`` in ``CLIP_DIR``, else random weights
    from ``config.seed + 4``; the token ids as PickScore's. ``aesthetic``:
    the vision tower of ``CLIP_DIR`` and the LAION head of ``AESTHETIC_PATH``
    (the repository keeps the published ``sac+logos+ava1-l14-linearMSE.pth``),
    only both together, else both random from ``config.seed + 5``. Random
    weights warn unless ``smoke_test``."""
    from adv_grpo_torch.models import convert
    from adv_grpo_torch.models.clip_text import CLIPTextConfig
    from adv_grpo_torch.models.vit import ViTConfig
    from adv_grpo_torch.rewards.scorers import AestheticScorer, CLIPScorer

    smoke = bool(config.get("smoke_test", False))
    clip_dir = _scorer_weights_dir("CLIP_DIR")
    if "clipscore" in reward_names:
        if smoke:
            towers = (CLIPTextConfig.tiny(projection_dim=16), ViTConfig.tiny(projection_dim=16),
                      28)
        else:
            towers = CLIPTextConfig.clip_l(), ViTConfig.clip_l(), 224
        if clip_dir:
            sd = convert.clip_model_state_dict_from_hf(convert.load_torch_state_dict(clip_dir),
                                                       *towers[:2])
            ctx.clip = CLIPScorer.from_state_dict(sd, device, *towers)
        else:
            if not smoke:
                _warn_random("CLIP-L", "CLIP_DIR")
            generator = torch.Generator(device=device).manual_seed(int(config.seed) + 4)
            ctx.clip = CLIPScorer.random_init(generator, device, *towers)
        if ctx.tokenize is None:
            ctx.tokenize = _clip_tokenize(
                config, ctx.clip.clip.text_model.cfg.max_position_embeddings)
    if "aesthetic" in reward_names:
        vcfg, size = ((ViTConfig.tiny(projection_dim=768), 28) if smoke
                      else (ViTConfig.clip_l(), 224))
        aes_path = _scorer_weights_dir("AESTHETIC_PATH")
        if aes_path and clip_dir:
            head_sd = convert.aesthetic_state_dict_from_pth(
                torch.load(aes_path, map_location="cpu", weights_only=True))
            vision_sd = convert.clip_vision_state_dict_from_hf(
                convert.load_torch_state_dict(clip_dir), vcfg)
            ctx.aesthetic = AestheticScorer.from_state_dicts(vision_sd, head_sd, device, vcfg,
                                                             size)
        else:
            if not smoke:
                _warn_random("Aesthetic (LAION MLP + CLIP-L)", "AESTHETIC_PATH + CLIP_DIR")
            generator = torch.Generator(device=device).manual_seed(int(config.seed) + 5)
            ctx.aesthetic = AestheticScorer.random_init(generator, device, vcfg, size)


def _dino_context(ctx, config, reward_names, device):
    """The DINO scorer (its backbone from ``DINOV2_DIR`` or random), its live
    head, the patch generator (seeded from ``config.seed + 2``) and, for
    ``dino_multi_cotrain``, the multi-layer scorer and its heads. The heads
    are drawn from ``config.seed + 3``'s generator, after the backbone where
    that is random. Its layers are ``config.dino_multi_layer_ids`` (the JAX
    default 8 where unset); the tiny smoke backbone has two, so
    ``smoke_test`` takes layer 1."""
    from adv_grpo_torch.models import convert
    from adv_grpo_torch.models.vit import ViTConfig
    from adv_grpo_torch.rewards.scorers import DINOMultiScorer, DINOScorer

    smoke = bool(config.get("smoke_test", False))
    generator = torch.Generator(device=device).manual_seed(int(config.seed) + 3)
    if smoke:
        cfg, image_size = ViTConfig.dinov2_base(image_size=28, num_layers=2, hidden_size=32,
                                                intermediate_size=64, num_heads=2), 28
    else:
        cfg, image_size = ViTConfig.dinov2_base(), 518
    dino_dir = _scorer_weights_dir("DINOV2_DIR")
    if dino_dir:
        dino = DINOScorer.from_state_dict(
            convert.dinov2_state_dict(convert.load_torch_state_dict(dino_dir), cfg), device,
            cfg, image_size)
    else:
        if not smoke:
            _warn_random("DINOv2 backbone", "DINOV2_DIR")
        dino = DINOScorer.random_init(generator, device, cfg, image_size)
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
