"""Checkpoint directories and JAX parameter trees -> the port's state dicts.

**Checkpoints** (the port of adv_grpo_tpu/models/convert.py's loaders): a
local diffusers-layout SD3 directory (``transformer/``, ``vae/``,
``text_encoder{,_2,_3}/``, each a ``config.json`` beside ``*.safetensors``
shards or ``*.bin`` files) is read by :func:`load_torch_state_dict` and
mapped by :func:`mmdit_state_dict_from_hf`, :func:`vae_state_dict_from_hf`,
:func:`clip_text_state_dict_from_hf` and :func:`t5_state_dict_from_hf`; the
Flux and WAN folders (``FluxTransformer2DModel``, ``WanTransformer3DModel``,
``AutoencoderKLWan``) by :func:`flux_state_dict_from_hf`,
:func:`wan_state_dict_from_hf` and :func:`wan_vae_state_dict_from_hf`, UMT5
(WAN's text encoder) by :func:`umt5_state_dict_from_hf`; the scorer
checkpoints (PickScore's HF ``CLIPModel``, DINOv2 in timm's or HF's layout,
CLIP-L's vision tower, the LAION aesthetic head's ``.pth``) by
:func:`clip_model_state_dict_from_hf`, :func:`dinov2_state_dict`,
:func:`clip_vision_state_dict_from_hf` and
:func:`aesthetic_state_dict_from_pth`. Each
must consume every weight of the checkpoint or raises "not consumed" (a
dropped weight is how a wrong convention slips through).
:func:`load_sd3_pipeline`, :func:`load_flux_transformer` and
:func:`load_wan_transformer` build the denoisers (frozen fp32 weights rounded
to bf16, LoRA A drawn with numpy as the JAX loaders draw it),
:func:`load_vae` and :func:`load_wan_vae` their fp32 VAEs;
:func:`preflight` and ``python -m adv_grpo_torch.models.convert --src DIR``
check an SD3 directory without building a model.

**JAX trees** (for the parity tests): the inverse of adv_grpo_tpu.models.convert's ``convert_mmdit`` /
``convert_flux`` / ``convert_vae`` / ``convert_wan`` / ``convert_wan_vae``,
the CLIP dual encoder that ``convert_clip_model``
fills (:func:`clip_dual_state_dict_from_jax`), the DINOv2 backbone
(:func:`vit_state_dict_from_jax`, also the CLIP-L tower of the aesthetic
scorer), the DINO heads (:func:`dino_head_state_dict_from_jax`,
:func:`dino_multi_state_dict_from_jax`) and the aesthetic head
(:func:`aesthetic_head_state_dict_from_jax`):
a Flax tree of numpy arrays (as ``jax.device_get`` returns it) becomes a
``state_dict`` with diffusers names (the CLIP and DINO encoders' mirror the
JAX tree's), so the two packages compute the same function from the same
weights.

  * Dense kernels (in, out) -> Linear weights (out, in);
  * Conv kernels HWIO -> OIHW, 3-D conv kernels (kt, kh, kw, I, O) ->
    (O, I, kt, kh, kw);
  * the patch Dense (p*p*C, dim), flattened (ph, pw, C) -> the Conv2d
    ``pos_embed.proj`` weight (dim, C, p, p);
  * GroupNorm ``scale`` -> ``weight``; the WAN tables and RMS gammas take
    the diffusers shapes ((1, 6, D), (C, 1, 1, 1));
  * ``lora_a`` / ``lora_b`` carried across unchanged (the layouts agree);
  * RMS weights stay fp32 (the MMDiT keeps them fp32 in every dtype).

:func:`lora_from_jax` / :func:`lora_to_jax` carry the trainable LoRA subtree
alone (the JAX ``lora_params`` dict, flat path names) into a model and back.

Values are returned as CPU torch tensors in their source dtype;
``load_state_dict`` casts them to each parameter's dtype.
"""

from __future__ import annotations

import dataclasses
import json
import os
import warnings
from typing import Dict

import numpy as np
import torch

from adv_grpo_torch.models.lora import lora_params, merge_lora_params
from adv_grpo_torch.utils import safetensors_io


def _unwrap(params):
    return params["params"] if "params" in params else params


def _tensor(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _dense(prefix: str, p: Dict, out: Dict) -> None:
    out[prefix + ".weight"] = _tensor(np.asarray(p["kernel"]).T)
    if "bias" in p:
        out[prefix + ".bias"] = _tensor(p["bias"])
    for name in ("lora_a", "lora_b"):
        if name in p:
            out[f"{prefix}.{name}"] = _tensor(p[name])


def mmdit_state_dict_from_jax(params, cfg) -> Dict[str, torch.Tensor]:
    """adv_grpo_tpu MMDiT params -> adv_grpo_torch MMDiT state dict."""
    p = _unwrap(params)
    out: Dict[str, torch.Tensor] = {}
    kernel = np.asarray(p["pos_embed_proj"]["kernel"])  # (p*p*C, dim)
    ps, dim = cfg.patch_size, cfg.hidden_dim
    out["pos_embed.proj.weight"] = _tensor(
        kernel.reshape(ps, ps, cfg.in_channels, dim).transpose(3, 2, 0, 1))
    out["pos_embed.proj.bias"] = _tensor(p["pos_embed_proj"]["bias"])
    for src, dst in (("time_embed_1", "time_text_embed.timestep_embedder.linear_1"),
                     ("time_embed_2", "time_text_embed.timestep_embedder.linear_2"),
                     ("pooled_embed_1", "time_text_embed.text_embedder.linear_1"),
                     ("pooled_embed_2", "time_text_embed.text_embedder.linear_2"),
                     ("context_embedder", "context_embedder"),
                     ("proj_out", "proj_out")):
        _dense(dst, p[src], out)
    _dense("norm_out.linear", p["norm_out"]["linear"], out)

    attn_names = {"to_q": "to_q", "to_k": "to_k", "to_v": "to_v", "to_out": "to_out.0",
                  "add_q_proj": "add_q_proj", "add_k_proj": "add_k_proj",
                  "add_v_proj": "add_v_proj", "to_add_out": "to_add_out"}
    norms = ("norm_q", "norm_k", "norm_added_q", "norm_added_k")
    for i in range(cfg.num_layers):
        blk = p[f"block_{i}"]
        b = f"transformer_blocks.{i}."
        _dense(b + "norm1.linear", blk["norm1"]["linear"], out)
        _dense(b + "norm1_context.linear", blk["norm1_context"]["linear"], out)
        for ff in ("ff", "ff_context"):
            if ff in blk:
                _dense(b + ff + ".net.0.proj", blk[ff]["fc1"], out)
                _dense(b + ff + ".net.2", blk[ff]["fc2"], out)
        for attn in ("attn", "attn2"):
            if attn not in blk:
                continue
            for name, leaf in blk[attn].items():
                if name in norms:
                    out[f"{b}{attn}.{name}.weight"] = _tensor(leaf["weight"])
                else:
                    _dense(f"{b}{attn}.{attn_names[name]}", leaf, out)
    return out


def flux_state_dict_from_jax(params, cfg) -> Dict[str, torch.Tensor]:
    """adv_grpo_tpu FluxTransformer params (LoRA leaves included) ->
    adv_grpo_torch FluxTransformer state dict; the inverse of the JAX
    ``convert_flux``."""
    p = _unwrap(params)
    out: Dict[str, torch.Tensor] = {}
    embeds = [("x_embedder", "x_embedder"), ("context_embedder", "context_embedder"),
              ("time_embed_1", "time_text_embed.timestep_embedder.linear_1"),
              ("time_embed_2", "time_text_embed.timestep_embedder.linear_2"),
              ("pooled_embed_1", "time_text_embed.text_embedder.linear_1"),
              ("pooled_embed_2", "time_text_embed.text_embedder.linear_2"),
              ("proj_out_final", "proj_out")]
    if cfg.guidance_embeds:
        embeds += [("guidance_embed_1", "time_text_embed.guidance_embedder.linear_1"),
                   ("guidance_embed_2", "time_text_embed.guidance_embedder.linear_2")]
    for src, dst in embeds:
        _dense(dst, p[src], out)
    _dense("norm_out.linear", p["norm_out"]["linear"], out)

    attn_names = {"to_q": "to_q", "to_k": "to_k", "to_v": "to_v", "to_out": "to_out.0",
                  "add_to_q": "add_q_proj", "add_to_k": "add_k_proj",
                  "add_to_v": "add_v_proj", "to_add_out": "to_add_out"}
    norm_names = {"norm_q": "norm_q", "norm_k": "norm_k", "add_norm_q": "norm_added_q",
                  "add_norm_k": "norm_added_k"}
    for i in range(cfg.num_double_layers):
        blk = p[f"double_{i}"]
        b = f"transformer_blocks.{i}."
        _dense(b + "norm1.linear", blk["norm1"]["linear"], out)
        _dense(b + "norm1_context.linear", blk["norm1_context"]["linear"], out)
        for name, leaf in blk["attn"].items():
            if name in norm_names:
                out[f"{b}attn.{norm_names[name]}.weight"] = _tensor(leaf["weight"])
            else:
                _dense(f"{b}attn.{attn_names[name]}", leaf, out)
        for ff in ("ff", "ff_context"):
            _dense(f"{b}{ff}.net.0.proj", blk[f"{ff}_fc1"], out)
            _dense(f"{b}{ff}.net.2", blk[f"{ff}_fc2"], out)
    for i in range(cfg.num_single_layers):
        blk = p[f"single_{i}"]
        b = f"single_transformer_blocks.{i}."
        _dense(b + "norm.linear", blk["norm"]["linear"], out)
        for name in ("to_q", "to_k", "to_v"):
            _dense(f"{b}attn.{name}", blk[name], out)
        for name in ("norm_q", "norm_k"):
            out[f"{b}attn.{name}.weight"] = _tensor(blk[name]["weight"])
        _dense(b + "proj_mlp", blk["proj_mlp"], out)
        _dense(b + "proj_out", blk["proj_out"], out)
    return out


def lora_from_jax(module, lora_flat: Dict[str, np.ndarray]) -> None:
    """Write a JAX ``lora_params`` dict (numpy leaves) into ``module``'s LoRA
    parameters, in place and without rounding (the factors are fp32). The
    two key sets must agree."""
    have = set(lora_params(module))
    if set(lora_flat) != have:
        missing, extra = sorted(have - set(lora_flat)), sorted(set(lora_flat) - have)
        raise KeyError(f"LoRA trees differ: missing {missing[:3]}, unexpected {extra[:3]}")
    merge_lora_params(module, lora_flat)


def lora_to_jax(module) -> Dict[str, np.ndarray]:
    """``module``'s LoRA parameters as a JAX ``lora_params`` dict of fp32 numpy
    arrays."""
    return {k: p.detach().float().cpu().numpy() for k, p in lora_params(module).items()}


def _conv(prefix: str, p: Dict, out: Dict) -> None:
    out[prefix + ".weight"] = _tensor(np.asarray(p["kernel"]).transpose(3, 2, 0, 1))
    out[prefix + ".bias"] = _tensor(p["bias"])


def _group_norm(prefix: str, p: Dict, out: Dict) -> None:
    out[prefix + ".weight"] = _tensor(p["scale"])
    out[prefix + ".bias"] = _tensor(p["bias"])


def _resnet(prefix: str, p: Dict, out: Dict) -> None:
    _group_norm(prefix + ".norm1", p["norm1"], out)
    _conv(prefix + ".conv1", p["conv1"], out)
    _group_norm(prefix + ".norm2", p["norm2"], out)
    _conv(prefix + ".conv2", p["conv2"], out)
    if "conv_shortcut" in p:
        _conv(prefix + ".conv_shortcut", p["conv_shortcut"], out)


def _vae_mid(prefix: str, p: Dict, out: Dict) -> None:
    _resnet(prefix + ".mid_block.resnets.0", p["mid_res_0"], out)
    _resnet(prefix + ".mid_block.resnets.1", p["mid_res_1"], out)
    a = prefix + ".mid_block.attentions.0"
    _group_norm(a + ".group_norm", p["mid_attn"]["group_norm"], out)
    for name, dst in (("to_q", "to_q"), ("to_k", "to_k"), ("to_v", "to_v"),
                      ("to_out", "to_out.0")):
        _dense(f"{a}.{dst}", p["mid_attn"][name], out)


def vae_state_dict_from_jax(params, cfg) -> Dict[str, torch.Tensor]:
    """adv_grpo_tpu AutoencoderKL params (encoder and decoder) ->
    adv_grpo_torch AutoencoderKL state dict."""
    enc, dec = _unwrap(params)["encoder"], _unwrap(params)["decoder"]
    out: Dict[str, torch.Tensor] = {}
    n_blocks = len(cfg.block_out_channels)
    _conv("encoder.conv_in", enc["conv_in"], out)
    for i in range(n_blocks):
        for j in range(cfg.layers_per_block):
            _resnet(f"encoder.down_blocks.{i}.resnets.{j}", enc[f"down_{i}_res_{j}"], out)
        if i < n_blocks - 1:
            _conv(f"encoder.down_blocks.{i}.downsamplers.0.conv", enc[f"down_{i}_downsample"],
                  out)
    _vae_mid("encoder", enc, out)
    _group_norm("encoder.conv_norm_out", enc["conv_norm_out"], out)
    _conv("encoder.conv_out", enc["conv_out"], out)
    _conv("decoder.conv_in", dec["conv_in"], out)
    _vae_mid("decoder", dec, out)
    for i in range(n_blocks):
        for j in range(cfg.layers_per_block + 1):
            _resnet(f"decoder.up_blocks.{i}.resnets.{j}", dec[f"up_{i}_res_{j}"], out)
        if i < n_blocks - 1:
            _conv(f"decoder.up_blocks.{i}.upsamplers.0.conv", dec[f"up_{i}_upsample"], out)
    _group_norm("decoder.conv_norm_out", dec["conv_norm_out"], out)
    _conv("decoder.conv_out", dec["conv_out"], out)
    return out


def _wan_conv3d(prefix: str, p: Dict, out: Dict) -> None:
    """A JAX ``WanCausalConv3d`` scope ({"conv": {kernel (kt,kh,kw,I,O), bias}})
    or a plain 3-D ``nn.Conv`` -> a Conv3d weight (O, I, kt, kh, kw)."""
    p = p.get("conv", p)
    out[prefix + ".weight"] = _tensor(np.asarray(p["kernel"]).transpose(4, 3, 0, 1, 2))
    out[prefix + ".bias"] = _tensor(p["bias"])


def wan_state_dict_from_jax(params, cfg) -> Dict[str, torch.Tensor]:
    """adv_grpo_tpu WanTransformer params (LoRA leaves included) ->
    adv_grpo_torch WanTransformer state dict (diffusers names); the inverse of
    the JAX ``convert_wan``."""
    p = _unwrap(params)
    out: Dict[str, torch.Tensor] = {}
    dim = cfg.hidden_dim
    kernel = np.asarray(p["patch_embedding"]["kernel"])  # (pt*ph*pw*C, dim)
    out["patch_embedding.weight"] = _tensor(
        kernel.reshape(*cfg.patch_size, cfg.in_channels, dim).transpose(4, 3, 0, 1, 2))
    out["patch_embedding.bias"] = _tensor(p["patch_embedding"]["bias"])
    for src, dst in (("text_embedding_1", "condition_embedder.text_embedder.linear_1"),
                     ("text_embedding_2", "condition_embedder.text_embedder.linear_2"),
                     ("time_embed_1", "condition_embedder.time_embedder.linear_1"),
                     ("time_embed_2", "condition_embedder.time_embedder.linear_2"),
                     ("time_projection", "condition_embedder.time_proj"),
                     ("proj_out", "proj_out")):
        _dense(dst, p[src], out)
    out["scale_shift_table"] = _tensor(np.asarray(p["scale_shift_table_out"]).reshape(1, 2, dim))
    names = {"to_q": "attn1.to_q", "to_k": "attn1.to_k", "to_v": "attn1.to_v",
             "to_out": "attn1.to_out.0", "cross_to_q": "attn2.to_q",
             "cross_to_k": "attn2.to_k", "cross_to_v": "attn2.to_v",
             "cross_to_out": "attn2.to_out.0", "ffn_fc1": "ffn.net.0.proj",
             "ffn_fc2": "ffn.net.2"}
    norms = {"norm_q": "attn1.norm_q", "norm_k": "attn1.norm_k",
             "cross_norm_q": "attn2.norm_q", "cross_norm_k": "attn2.norm_k"}
    for i in range(cfg.num_layers):
        blk = p[f"block_{i}"]
        b = f"blocks.{i}."
        out[b + "scale_shift_table"] = _tensor(
            np.asarray(blk["scale_shift_table"]).reshape(1, 6, dim))
        for src, dst in names.items():
            _dense(b + dst, blk[src], out)
        for src, dst in norms.items():
            out[f"{b}{dst}.weight"] = _tensor(blk[src]["weight"])
        if cfg.cross_attn_norm:
            out[b + "norm2.weight"] = _tensor(blk["norm2_weight"])
            out[b + "norm2.bias"] = _tensor(blk["norm2_bias"])
    return out


def wan_vae_state_dict_from_jax(params, cfg) -> Dict[str, torch.Tensor]:
    """adv_grpo_tpu WanVideoVAE params (encoder and decoder) -> adv_grpo_torch
    WanVideoVAE state dict (diffusers AutoencoderKLWan names)."""
    enc, dec = _unwrap(params)["encoder"], _unwrap(params)["decoder"]
    out: Dict[str, torch.Tensor] = {}

    def rms(prefix, p, spatial):
        out[prefix + ".gamma"] = _tensor(np.asarray(p["gamma"]).reshape((-1,) + (1,) * spatial))

    def res(prefix, p):
        rms(prefix + ".norm1", p["norm1"], 3)
        _wan_conv3d(prefix + ".conv1", p["conv1"], out)
        rms(prefix + ".norm2", p["norm2"], 3)
        _wan_conv3d(prefix + ".conv2", p["conv2"], out)
        if "conv_shortcut" in p:
            _wan_conv3d(prefix + ".conv_shortcut", p["conv_shortcut"], out)

    def attn(prefix, p):
        rms(prefix + ".norm", p["norm"], 2)
        for name in ("to_qkv", "proj"):  # Dense (I, O) -> 1x1 Conv2d (O, I, 1, 1)
            out[f"{prefix}.{name}.weight"] = _tensor(np.asarray(p[name]["kernel"]).T[:, :, None,
                                                                                     None])
            out[f"{prefix}.{name}.bias"] = _tensor(p[name]["bias"])

    def half(tree, side, blocks, tag):
        _wan_conv3d(f"{side}.conv_in", tree["conv_in"], out)
        res(f"{side}.mid_block.resnets.0", tree["mid"]["res0"])
        attn(f"{side}.mid_block.attentions.0", tree["mid"]["attn0"])
        res(f"{side}.mid_block.resnets.1", tree["mid"]["res1"])
        n = 0
        while f"{tag}_{n}" in tree:
            p, prefix = tree[f"{tag}_{n}"], f"{side}.{blocks}.{n}"
            if "resample_conv" in p:
                _conv(prefix + ".resample.1", p["resample_conv"], out)
                if "time_conv" in p:
                    _wan_conv3d(prefix + ".time_conv", p["time_conv"], out)
            elif "to_qkv" in p:
                attn(prefix, p)
            else:
                res(prefix, p)
            n += 1
        rms(f"{side}.norm_out", tree["norm_out"], 3)
        _wan_conv3d(f"{side}.conv_out", tree["conv_out"], out)

    _wan_conv3d("post_quant_conv", dec["post_quant_conv"], out)
    half(dec, "decoder", "up_blocks", "up")
    half(enc, "encoder", "down_blocks", "down")
    _wan_conv3d("quant_conv", enc["quant_conv"], out)
    return out


def clip_dual_state_dict_from_jax(params, text_cfg, vision_cfg) -> Dict[str, torch.Tensor]:
    """adv_grpo_tpu ``CLIPDualEncoder`` params ({"text", "vision",
    "logit_scale"}) -> the state dict of ``rewards.scorers.CLIPDualEncoder``
    (the layout ``convert_clip_model`` targets); ``logit_scale`` becomes a
    0-d fp32 tensor."""
    out: Dict[str, torch.Tensor] = {}
    t, v = _unwrap(params["text"]), _unwrap(params["vision"])
    out["text_model.token_embedding.weight"] = _tensor(t["token_embedding"]["embedding"])
    out["text_model.position_embedding"] = _tensor(t["position_embedding"])
    for i in range(text_cfg.num_layers):
        blk, b = t[f"layer_{i}"], f"text_model.layers.{i}."
        for name in ("layer_norm1", "layer_norm2"):
            _group_norm(b + name, blk[name], out)
        for name in ("q_proj", "k_proj", "v_proj", "out_proj", "fc1", "fc2"):
            _dense(b + name, blk[name], out)
    _group_norm("text_model.final_layer_norm", t["final_layer_norm"], out)
    _dense("text_model.text_projection", t["text_projection"], out)
    out.update(vit_state_dict_from_jax(v, vision_cfg, "vision_model."))
    out["logit_scale"] = _tensor(params["logit_scale"]).reshape(())
    return out


def vit_state_dict_from_jax(params, cfg, prefix: str = "") -> Dict[str, torch.Tensor]:
    """adv_grpo_tpu ``VisionTransformer`` params -> the state dict of
    ``models.vit.VisionTransformer`` at ``cfg``: the CLIP towers
    (``pre_layernorm``, ``visual_projection``) and the DINOv2 backbone
    (LayerScale ``layer_{i}/ls1`` / ``ls2``, neither of the two)."""
    v, out = _unwrap(params), {}
    _dense(prefix + "patch_embed", v["patch_embed"], out)
    out[prefix + "class_embedding"] = _tensor(v["class_embedding"])
    out[prefix + "position_embedding"] = _tensor(v["position_embedding"])
    for i in range(cfg.num_layers):
        blk, b = v[f"layer_{i}"], f"{prefix}layers.{i}."
        for name in ("norm1", "norm2"):
            _group_norm(b + name, blk[name], out)
        for name in ("q_proj", "k_proj", "v_proj", "out_proj", "fc1", "fc2"):
            _dense(b + name, blk[name], out)
        for name in ("ls1", "ls2"):
            if name in blk:
                out[b + name] = _tensor(blk[name])
    for name in ("pre_layernorm", "post_layernorm"):
        if name in v:
            _group_norm(prefix + name, v[name], out)
    if "visual_projection" in v:
        _dense(prefix + "visual_projection", v["visual_projection"], out)
    return out


def dino_head_state_dict_from_jax(params, prefix: str = "") -> Dict[str, torch.Tensor]:
    """A JAX DINO head ({"fc1", "fc2"}) -> ``rewards.scorers.DINOHead``'s
    state dict."""
    h, out = _unwrap(params), {}
    for name in ("fc1", "fc2"):
        _dense(prefix + name, h[name], out)
    return out


def aesthetic_head_state_dict_from_jax(params) -> Dict[str, torch.Tensor]:
    """A JAX ``AestheticHead`` tree ({"fc0".."fc3", "out"}) ->
    ``models.aesthetic.AestheticHead``'s state dict."""
    h, out = _unwrap(params), {}
    for name, _ in AESTHETIC_LAYERS:
        _dense(name, h[name], out)
    return out


def dino_multi_state_dict_from_jax(params) -> Dict[str, torch.Tensor]:
    """A JAX ``DINOMultiScorer`` tree ({"heads": [...], "fusion": {"fuse"}})
    -> ``rewards.scorers.DINOMultiHeads``' state dict."""
    out: Dict[str, torch.Tensor] = {}
    for i, head in enumerate(params["heads"]):
        out.update(dino_head_state_dict_from_jax(head, f"heads.{i}."))
    _dense("fusion", params["fusion"]["fuse"], out)
    return out


# ── checkpoint directories (diffusers / HF layouts) ──────────────────────────


def load_torch_state_dict(model_dir: str) -> Dict[str, torch.Tensor]:
    """Every tensor of every ``*.safetensors`` file in ``model_dir`` (all the
    shards of a sharded checkpoint, whose ``*.index.json`` names them), read
    with the port's own reader; without any, every ``*.bin`` file through
    ``torch.load(weights_only=True)``, cast to fp32 as the JAX loader casts
    them. CPU tensors."""
    files = sorted(os.listdir(model_dir))
    sd: Dict[str, torch.Tensor] = {}
    st_files = [f for f in files if f.endswith(".safetensors")]
    if st_files:
        for fname in st_files:
            sd.update(safetensors_io.load_file(os.path.join(model_dir, fname)))
    else:
        for fname in [f for f in files if f.endswith(".bin")]:
            shard = torch.load(os.path.join(model_dir, fname), map_location="cpu",
                               weights_only=True)
            sd.update({k: v.float() for k, v in shard.items()})
    return sd


class _Taken:
    """State-dict view that records consumption and fails on absent keys."""

    def __init__(self, sd: Dict[str, torch.Tensor]):
        self.sd = dict(sd)
        self.used = set()

    def __call__(self, key: str) -> torch.Tensor:
        if key not in self.sd:
            raise KeyError(f"missing weight: {key}")
        self.used.add(key)
        return self.sd[key]

    def has(self, key: str) -> bool:
        return key in self.sd

    def unused(self):
        return sorted(set(self.sd) - self.used)

    def assert_consumed(self, what: str = "convert"):
        """Every checkpoint weight must be accounted for: a silently dropped
        key is how a wrong convention (the pos-embed table, say) slips by."""
        left = self.unused()
        if left:
            raise ValueError(
                f"{what}: {len(left)} checkpoint weights were not consumed, e.g. {left[:5]} "
                "— refusing to convert (weights would be silently dropped)")


_NO_DEFAULT = object()


def detect_pos_embed_base(sd: Dict[str, torch.Tensor], embed_dim: int, max_size: int,
                          sample_size: int, patch_size: int, default=_NO_DEFAULT):
    """The ``MMDiTConfig.pos_embed_base_size`` that reproduces the checkpoint's
    persisted sincos table ``pos_embed.pos_embed``: ``sample_size //
    patch_size`` for diffusers' base-scaled table, ``None`` for raw integer
    positions (the original Stability table). A table that matches neither
    raises. Without a table: ``default`` with a warning where one is given,
    else a raise (a wrong convention generates noise with no error)."""
    from adv_grpo_torch.models.mmdit import _sincos_table

    key = "pos_embed.pos_embed"
    if key not in sd:
        if default is _NO_DEFAULT:
            raise ValueError(
                "checkpoint has no persisted pos_embed.pos_embed table, so the "
                "position-scaling convention cannot be detected — pass default= "
                "(sample_size // patch_size for diffusers checkpoints, None for "
                "raw-integer Stability tables)")
        warnings.warn(
            "checkpoint has no persisted pos_embed.pos_embed table; assuming "
            f"pos_embed_base_size={default!r} — if generations look like noise, the "
            "positional-embedding convention is likely wrong")
        return default
    # slice the 3x3 probe window off a view before casting (the whole 384^2
    # table in fp64 would be 1.8 GB)
    n = min(3, max_size)
    window = sd[key].reshape(max_size, max_size, -1)[:n, :n].double().numpy()
    base = sample_size // patch_size
    for cand in (base, None):
        scale = (cand / max_size) if cand is not None else 1.0
        coords = np.arange(n, dtype=np.float64) * scale
        if np.allclose(window, _sincos_table(embed_dim, coords, coords), atol=5e-3):
            return cand  # fp16 / bf16 checkpoints quantise the stored table
    raise ValueError(
        "pos_embed.pos_embed in the checkpoint matches neither the diffusers "
        f"base-scaled sincos table (base_size={base}) nor the raw-integer table — "
        "refusing to convert (the model would run with a wrong positional embedding)")


def _frozen_keys(module) -> list:
    """A model's state-dict names but its LoRA factors (a checkpoint holds
    none)."""
    return [k for k in module.state_dict() if k.rsplit(".", 1)[-1] not in ("lora_a", "lora_b")]


def _round_bf16(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """fp32 tensors rounded to bf16, the JAX ``cast_tree_bf16`` (fp16 and bf16
    ones as they are); ``load_state_dict`` then widens what the model holds in
    fp32 (norm weights, tables) back, exactly."""
    return {k: v.to(torch.bfloat16) if v.dtype == torch.float32 else v for k, v in sd.items()}


def _take_module(sd, module_keys, what, ignore=()):
    g = _Taken(sd)
    for key in ignore:
        if g.has(key):
            g(key)
    out = {k: g(k) for k in module_keys}
    g.assert_consumed(what)
    return out


def mmdit_state_dict_from_hf(sd: Dict[str, torch.Tensor], cfg) -> Dict[str, torch.Tensor]:
    """A diffusers ``SD3Transformer2DModel`` state dict -> the port's MMDiT
    state dict (the same names; LoRA factors are not in a checkpoint). The
    persisted ``pos_embed.pos_embed`` table is consumed (read by
    :func:`detect_pos_embed_base`; the model recomputes its crop)."""
    from adv_grpo_torch.models.mmdit import MMDiT

    return _take_module(sd, _frozen_keys(MMDiT(cfg, device="meta")), "mmdit_state_dict_from_hf",
                        ignore=("pos_embed.pos_embed",))


def vae_state_dict_from_hf(sd: Dict[str, torch.Tensor], cfg) -> Dict[str, torch.Tensor]:
    """A diffusers ``AutoencoderKL`` state dict (the SD3 layout, no quant
    convs) -> the port's AutoencoderKL state dict, encoder and decoder."""
    from adv_grpo_torch.models.vae import AutoencoderKL

    keys = list(AutoencoderKL(cfg, device="meta").state_dict())
    return _take_module(sd, keys, "vae_state_dict_from_hf")


def _clip_text_from_hf(g: _Taken, num_layers: int, prefix: str = "") -> Dict[str, torch.Tensor]:
    """The mapping of the JAX ``convert_clip_text`` over ``g``: HF's CLIP text
    tower -> ``CLIPTextEncoder`` names under ``prefix`` (the ``position_ids``
    buffer older checkpoints carry is consumed and dropped)."""
    if g.has("text_model.embeddings.position_ids"):
        g("text_model.embeddings.position_ids")
    out = {"token_embedding.weight": g("text_model.embeddings.token_embedding.weight"),
           "position_embedding": g("text_model.embeddings.position_embedding.weight"),
           "text_projection.weight": g("text_projection.weight")}
    for name in ("weight", "bias"):
        out[f"final_layer_norm.{name}"] = g(f"text_model.final_layer_norm.{name}")
    for i in range(num_layers):
        b = f"text_model.encoder.layers.{i}."
        for src, dst in (("layer_norm1", "layer_norm1"), ("layer_norm2", "layer_norm2"),
                         ("self_attn.q_proj", "q_proj"), ("self_attn.k_proj", "k_proj"),
                         ("self_attn.v_proj", "v_proj"), ("self_attn.out_proj", "out_proj"),
                         ("mlp.fc1", "fc1"), ("mlp.fc2", "fc2")):
            for name in ("weight", "bias"):
                out[f"layers.{i}.{dst}.{name}"] = g(f"{b}{src}.{name}")
    return {prefix + k: v for k, v in out.items()}


def clip_text_state_dict_from_hf(sd: Dict[str, torch.Tensor],
                                 num_layers: int) -> Dict[str, torch.Tensor]:
    """An HF ``CLIPTextModelWithProjection`` state dict -> the port's
    ``CLIPTextEncoder`` state dict (the JAX ``convert_clip_text``'s mapping)."""
    g = _Taken(sd)
    out = _clip_text_from_hf(g, num_layers)
    g.assert_consumed("clip_text_state_dict_from_hf")
    return out


_VIT_BLOCK = (("layer_norm1", "norm1"), ("layer_norm2", "norm2"),
              ("self_attn.q_proj", "q_proj"), ("self_attn.k_proj", "k_proj"),
              ("self_attn.v_proj", "v_proj"), ("self_attn.out_proj", "out_proj"),
              ("mlp.fc1", "fc1"), ("mlp.fc2", "fc2"))


def _patch_linear(conv: torch.Tensor) -> torch.Tensor:
    """A patch Conv2d weight (D, 3, p, p) -> the port's ``patch_embed``
    Linear weight (D, p*p*3), flattened (ph, pw, c) as ``models.vit`` flattens
    a patch (the JAX ``w.transpose(2, 3, 1, 0).reshape(...)``, transposed)."""
    return conv.permute(0, 2, 3, 1).reshape(conv.shape[0], -1)


def _position_table(table: torch.Tensor, cfg, what: str) -> torch.Tensor:
    """A (1, N, D) or (N, D) position table as (N, D); N must be
    ``cfg.num_patches + 1`` (the class token's row first)."""
    table = table.reshape(-1, table.shape[-1])
    if table.shape[0] != cfg.num_patches + 1:
        raise ValueError(
            f"{what}: the checkpoint's position table has {table.shape[0]} rows, the config "
            f"needs {cfg.num_patches + 1} ({cfg.image_size}^2 in patches of {cfg.patch_size}, "
            "plus the class token)")
    return table


def clip_model_state_dict_from_hf(sd: Dict[str, torch.Tensor], text_cfg,
                                  vision_cfg) -> Dict[str, torch.Tensor]:
    """An HF ``CLIPModel`` state dict (PickScore's CLIP-H/14) -> the state
    dict of ``rewards.scorers.CLIPDualEncoder``: the JAX ``convert_clip_model``
    (``convert_clip_text`` and ``convert_clip_vision``) into the layout
    ``clip_dual_state_dict_from_jax`` fills. Both towers and ``logit_scale``
    consume from one view, so a weight left over anywhere raises "not
    consumed"; both ``position_ids`` buffers are consumed and dropped. The
    patch Conv2d has no bias: ``patch_embed.bias`` is zeros. ``logit_scale``
    is a 0-d fp32 tensor."""
    g = _Taken(sd)
    out = _clip_text_from_hf(g, text_cfg.num_layers, "text_model.")
    out.update(_clip_vision_from_hf(g, vision_cfg, "vision_model.",
                                    "clip_model_state_dict_from_hf"))
    out["logit_scale"] = g("logit_scale").float().reshape(())
    g.assert_consumed("clip_model_state_dict_from_hf")
    return out


def _clip_vision_from_hf(g: _Taken, cfg, prefix: str, what: str) -> Dict[str, torch.Tensor]:
    """The mapping of the JAX ``convert_clip_vision`` over ``g``: HF's CLIP
    vision tower and ``visual_projection`` -> ``models.vit.VisionTransformer``
    names under ``prefix`` (the ``position_ids`` buffer consumed and
    dropped; the bias-free patch Conv2d gets a zero ``patch_embed.bias``)."""
    v = "vision_model."
    if g.has(v + "embeddings.position_ids"):
        g(v + "embeddings.position_ids")
    patch = g(v + "embeddings.patch_embedding.weight")
    out = {
        "patch_embed.weight": _patch_linear(patch),
        "patch_embed.bias": torch.zeros(patch.shape[0], dtype=patch.dtype),
        "class_embedding": g(v + "embeddings.class_embedding"),
        "position_embedding": _position_table(
            g(v + "embeddings.position_embedding.weight"), cfg, what),
        "visual_projection.weight": g("visual_projection.weight")}
    for name in ("weight", "bias"):
        out[f"pre_layernorm.{name}"] = g(f"{v}pre_layrnorm.{name}")
        out[f"post_layernorm.{name}"] = g(f"{v}post_layernorm.{name}")
    for i in range(cfg.num_layers):
        for src, dst in _VIT_BLOCK:
            for name in ("weight", "bias"):
                out[f"layers.{i}.{dst}.{name}"] = g(f"{v}encoder.layers.{i}.{src}.{name}")
    return {prefix + k: t for k, t in out.items()}


def clip_vision_state_dict_from_hf(sd: Dict[str, torch.Tensor],
                                   vision_cfg) -> Dict[str, torch.Tensor]:
    """The CLIP vision tower alone of an HF ``CLIPModel`` or
    ``CLIPVisionModelWithProjection`` state dict (``CLIP_DIR``'s CLIP-L/14,
    the aesthetic scorer's tower) -> ``models.vit.VisionTransformer``'s state
    dict: the JAX ``convert_clip_vision``. A ``CLIPModel``'s text tower
    (``text_model.*``, ``text_projection.weight``, ``logit_scale``) is
    consumed and dropped; any other weight left over raises "not
    consumed"."""
    g = _Taken(sd)
    out = _clip_vision_from_hf(g, vision_cfg, "", "clip_vision_state_dict_from_hf")
    for key in list(g.sd):
        if key.startswith("text_model.") or key in ("text_projection.weight", "logit_scale"):
            g(key)
    g.assert_consumed("clip_vision_state_dict_from_hf")
    return out


AESTHETIC_LAYERS = (("fc0", 0), ("fc1", 2), ("fc2", 4), ("fc3", 6), ("out", 7))


def aesthetic_state_dict_from_pth(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The LAION ``sac+logos+ava1-l14-linearMSE.pth`` layout (an
    ``nn.Sequential`` whose Linear layers are ``layers.{0,2,4,6,7}``; the
    others are dropout) -> ``models.aesthetic.AestheticHead``'s state dict,
    fp32: the JAX ``convert_aesthetic_mlp``. Every weight must be consumed."""
    g = _Taken(sd)
    out = {f"{dst}.{name}": g(f"layers.{i}.{name}").float()
           for dst, i in AESTHETIC_LAYERS for name in ("weight", "bias")}
    g.assert_consumed("aesthetic_state_dict_from_pth")
    return out


def dinov2_state_dict_from_timm(sd: Dict[str, torch.Tensor], cfg) -> Dict[str, torch.Tensor]:
    """A timm / original DINOv2 state dict (``blocks.{i}``, the fused
    ``attn.qkv``, ``ls{1,2}.gamma``) -> the state dict of
    ``models.vit.VisionTransformer`` at ``cfg`` (the JAX ``convert_dinov2``
    over ``convert_timm_vit``): qkv split in three, ``cls_token`` (1, 1, D)
    and ``pos_embed`` (1, N, D) reshaped; ``mask_token``, which no forward
    reads, consumed and dropped. Strict: a weight left over raises."""
    g = _Taken(sd)
    if g.has("mask_token"):
        g("mask_token")
    out = {"patch_embed.weight": _patch_linear(g("patch_embed.proj.weight")),
           "patch_embed.bias": g("patch_embed.proj.bias"),
           "class_embedding": g("cls_token").reshape(-1),
           "position_embedding": _position_table(g("pos_embed"), cfg,
                                                 "dinov2_state_dict_from_timm")}
    for name in ("weight", "bias"):
        out[f"post_layernorm.{name}"] = g(f"norm.{name}")
    for i in range(cfg.num_layers):
        b, d = f"blocks.{i}.", f"layers.{i}."
        for name in ("weight", "bias"):
            for part, dst in zip(g(f"{b}attn.qkv.{name}").chunk(3), ("q_proj", "k_proj",
                                                                       "v_proj")):
                out[f"{d}{dst}.{name}"] = part
            for src, dst in (("norm1", "norm1"), ("norm2", "norm2"), ("attn.proj", "out_proj"),
                             ("mlp.fc1", "fc1"), ("mlp.fc2", "fc2")):
                out[f"{d}{dst}.{name}"] = g(f"{b}{src}.{name}")
        out[d + "ls1"] = g(b + "ls1.gamma")
        out[d + "ls2"] = g(b + "ls2.gamma")
    g.assert_consumed("dinov2_state_dict_from_timm")
    return out


def dinov2_state_dict_from_hf(sd: Dict[str, torch.Tensor], cfg) -> Dict[str, torch.Tensor]:
    """An HF ``Dinov2Model`` state dict (``encoder.layer.{i}``, separate
    query / key / value, ``layer_scale{1,2}.lambda1``) -> the state dict of
    ``models.vit.VisionTransformer`` at ``cfg`` (the JAX
    ``convert_dinov2_hf``); ``embeddings.mask_token`` consumed and dropped.
    Strict: a weight left over raises."""
    g = _Taken(sd)
    e = "embeddings."
    if g.has(e + "mask_token"):
        g(e + "mask_token")
    out = {"patch_embed.weight": _patch_linear(g(e + "patch_embeddings.projection.weight")),
           "patch_embed.bias": g(e + "patch_embeddings.projection.bias"),
           "class_embedding": g(e + "cls_token").reshape(-1),
           "position_embedding": _position_table(g(e + "position_embeddings"), cfg,
                                                 "dinov2_state_dict_from_hf")}
    for name in ("weight", "bias"):
        out[f"post_layernorm.{name}"] = g(f"layernorm.{name}")
    for i in range(cfg.num_layers):
        b, d = f"encoder.layer.{i}.", f"layers.{i}."
        for src, dst in (("norm1", "norm1"), ("norm2", "norm2"),
                         ("attention.attention.query", "q_proj"),
                         ("attention.attention.key", "k_proj"),
                         ("attention.attention.value", "v_proj"),
                         ("attention.output.dense", "out_proj"), ("mlp.fc1", "fc1"),
                         ("mlp.fc2", "fc2")):
            for name in ("weight", "bias"):
                out[f"{d}{dst}.{name}"] = g(f"{b}{src}.{name}")
        out[d + "ls1"] = g(b + "layer_scale1.lambda1")
        out[d + "ls2"] = g(b + "layer_scale2.lambda1")
    g.assert_consumed("dinov2_state_dict_from_hf")
    return out


def dinov2_state_dict(sd: Dict[str, torch.Tensor], cfg) -> Dict[str, torch.Tensor]:
    """A DINOv2 checkpoint in either layout, told apart by its keys as the
    JAX CLI tells them (``encoder.layer.`` means HF's)."""
    hf = any(k.startswith("encoder.layer.") for k in sd)
    return (dinov2_state_dict_from_hf if hf else dinov2_state_dict_from_timm)(sd, cfg)


_T5_BLOCK = (("0.layer_norm", "ln_attn"), ("0.SelfAttention.q", "q"),
             ("0.SelfAttention.k", "k"), ("0.SelfAttention.v", "v"),
             ("0.SelfAttention.o", "o"), ("1.layer_norm", "ln_ff"),
             ("1.DenseReluDense.wi_0", "wi_0"), ("1.DenseReluDense.wi_1", "wi_1"),
             ("1.DenseReluDense.wo", "wo"))


def t5_state_dict_from_hf(sd: Dict[str, torch.Tensor], num_layers: int) -> Dict[str, torch.Tensor]:
    """An HF ``T5EncoderModel`` state dict -> the port's ``T5Encoder`` state
    dict (the JAX ``convert_t5_encoder``'s mapping): the embedding from
    ``shared.weight`` or, without it, ``encoder.embed_tokens.weight`` (the
    tied copy is consumed where both are present); the shared relative bias
    is block 0's."""
    g = _Taken(sd)
    out = {"token_embedding.weight": _t5_embedding(g),
           "relative_attention_bias": g(
               "encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight"),
           "final_ln.weight": g("encoder.final_layer_norm.weight")}
    for i in range(num_layers):
        for src, dst in _T5_BLOCK:
            out[f"blocks.{i}.{dst}.weight"] = g(f"encoder.block.{i}.layer.{src}.weight")
    g.assert_consumed("t5_state_dict_from_hf")
    return out


def _t5_embedding(g: _Taken) -> torch.Tensor:
    """``shared.weight``, or without it ``encoder.embed_tokens.weight``; the
    tied copy is consumed where both are present."""
    emb = "shared.weight" if g.has("shared.weight") else "encoder.embed_tokens.weight"
    if emb == "shared.weight" and g.has("encoder.embed_tokens.weight"):
        g("encoder.embed_tokens.weight")
    return g(emb)


def umt5_state_dict_from_hf(sd: Dict[str, torch.Tensor],
                            num_layers: int) -> Dict[str, torch.Tensor]:
    """An HF ``UMT5EncoderModel`` state dict (WAN's text encoder) -> the
    port's ``T5Encoder`` state dict at ``per_layer_rel_bias=True`` (the JAX
    ``convert_umt5_encoder``'s mapping): every block's own relative-bias
    table, the embedding as :func:`t5_state_dict_from_hf` takes it. Strict.
    The shared-bias :func:`t5_state_dict_from_hf` refuses such a state: the
    tables of blocks 1.. are not consumed."""
    g = _Taken(sd)
    out = {"token_embedding.weight": _t5_embedding(g),
           "final_ln.weight": g("encoder.final_layer_norm.weight")}
    for i in range(num_layers):
        b = f"encoder.block.{i}.layer."
        out[f"blocks.{i}.relative_attention_bias"] = g(
            b + "0.SelfAttention.relative_attention_bias.weight")
        for src, dst in _T5_BLOCK:
            out[f"blocks.{i}.{dst}.weight"] = g(f"{b}{src}.weight")
    g.assert_consumed("umt5_state_dict_from_hf")
    return out


def t5_state_dict_from_jax(params, cfg) -> Dict[str, torch.Tensor]:
    """adv_grpo_tpu ``T5Encoder`` params -> the port's ``T5Encoder`` state
    dict (UMT5's per-block bias tables too)."""
    p = _unwrap(params)
    out = {"token_embedding.weight": _tensor(p["token_embedding"]["embedding"]),
           "final_ln.weight": _tensor(p["final_ln"]["weight"])}
    if not cfg.per_layer_rel_bias:
        out["relative_attention_bias"] = _tensor(p["relative_attention_bias"])
    for i in range(cfg.num_layers):
        blk = p[f"block_{i}"]
        if cfg.per_layer_rel_bias:
            out[f"blocks.{i}.relative_attention_bias"] = _tensor(blk["relative_attention_bias"])
        for name in ("ln_attn", "ln_ff"):
            out[f"blocks.{i}.{name}.weight"] = _tensor(blk[name]["weight"])
        for name in ("q", "k", "v", "o", "wi_0", "wi_1", "wo"):
            _dense(f"blocks.{i}.{name}", blk[name], out)
    return out


# ── configs from a directory's config.json files ─────────────────────────────


def _read_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def mmdit_config_from_json(tc: dict, **overrides):
    """``MMDiTConfig`` from a diffusers ``transformer/config.json`` (the keys
    the JAX loader reads)."""
    from adv_grpo_torch.models.mmdit import MMDiTConfig

    return MMDiTConfig(
        patch_size=tc["patch_size"], in_channels=tc["in_channels"],
        out_channels=tc.get("out_channels") or tc["in_channels"],
        num_layers=tc["num_layers"], attention_head_dim=tc["attention_head_dim"],
        num_attention_heads=tc["num_attention_heads"],
        joint_attention_dim=tc["joint_attention_dim"],
        pooled_projection_dim=tc["pooled_projection_dim"],
        pos_embed_max_size=tc.get("pos_embed_max_size", 384),
        qk_norm=tc.get("qk_norm") is not None,
        dual_attention_layers=tuple(tc.get("dual_attention_layers", ())), **overrides)


def vae_config_from_json(vc: dict, base=None):
    """``VAEConfig`` from a diffusers ``vae/config.json`` (the JAX loader's
    keys; ``norm_num_groups`` keeps its default, 32). Without ``base`` the
    topology and ``scaling_factor`` must be in the file and ``shift_factor``
    defaults to 0; with it (the Flux VAE: ``VAEConfig.flux()``) every key the
    file lacks is ``base``'s."""
    from adv_grpo_torch.models.vae import VAEConfig

    if base is None:
        base = VAEConfig(shift_factor=0.0)
        missing = [k for k in ("latent_channels", "block_out_channels", "layers_per_block",
                               "scaling_factor") if k not in vc]
        if missing:
            raise KeyError(f"vae config.json lacks {missing}")
    fields = {k: vc[k] for k in ("latent_channels", "block_out_channels", "layers_per_block",
                                 "scaling_factor", "shift_factor") if k in vc}
    if "block_out_channels" in fields:
        fields["block_out_channels"] = tuple(fields["block_out_channels"])
    return dataclasses.replace(base, **fields)


def _transformer_state(model_dir, tc, cfg):
    """(the converted MMDiT state dict, the detected pos-embed base)."""
    t_sd = load_torch_state_dict(os.path.join(model_dir, "transformer"))
    sample = tc.get("sample_size", 128)
    # a diffusers directory whose table was stripped: the diffusers
    # base-scaled convention, with a warning
    base = detect_pos_embed_base(t_sd, cfg.hidden_dim, cfg.pos_embed_max_size, sample,
                                 tc["patch_size"], default=sample // tc["patch_size"])
    return mmdit_state_dict_from_hf(t_sd, cfg), base


def _lora_factor(rng, prefix: str, k_in: int, k_out: int, r: int, out: Dict) -> None:
    """PEFT's init as the JAX loaders draw it: A ~ N(0, 1/r) drawn in fp64 by
    ``rng`` and cast to fp32, B = 0."""
    out[prefix + ".lora_a"] = torch.from_numpy(rng.normal(0, 1.0 / r, (k_in, r)).astype(np.float32))
    out[prefix + ".lora_b"] = torch.zeros(r, k_out)


def sd3_lora_init(cfg) -> Dict[str, torch.Tensor]:
    """Fresh adapters for the MMDiT's joint-attention projections, bit for
    bit the JAX loader's (``_add_lora_leaves``): per block, in the order
    to_q, to_k, to_v, to_out, add_q_proj, add_k_proj, add_v_proj, then
    to_add_out where the block has it, A ~ N(0, 1/r) drawn in fp64 by
    ``np.random.default_rng(0)`` and cast to fp32, B = 0."""
    rng = np.random.default_rng(0)
    r, dim = cfg.lora_rank, cfg.hidden_dim
    names = ("to_q", "to_k", "to_v", "to_out.0", "add_q_proj", "add_k_proj", "add_v_proj",
             "to_add_out")
    out: Dict[str, torch.Tensor] = {}
    for i in range(cfg.num_layers):
        for name in names[:-1] if i == cfg.num_layers - 1 else names:
            _lora_factor(rng, f"transformer_blocks.{i}.attn.{name}", dim, dim, r, out)
    return out


def load_sd3_pipeline(model_dir: str, *, lora_rank: int = 0, lora_alpha: float = 1.0,
                      dtype=None, device="cuda"):
    """An ``SD3Pipeline`` on ``device`` from a local diffusers-layout
    directory (``transformer/`` and ``vae/``; the text encoders are loaded by
    ``cli.common.load_real_text_encoder``). The MMDiT runs in ``dtype`` (bf16
    by default); its frozen fp32 weights are rounded to bf16 first, whatever
    ``dtype`` is, as the JAX loader's ``cast_tree_bf16`` does (the per-head
    RMS weights too, held in fp32 parameters); fp16 and bf16 weights are
    taken as they are. With ``lora_rank`` > 0 the adapters start from
    :func:`sd3_lora_init` and stay fp32. The VAE is fp32, encoder and
    decoder."""
    from adv_grpo_torch.models.mmdit import MMDiT
    from adv_grpo_torch.train.pipeline import SD3Pipeline, _build

    device = torch.device(device)
    tc = _read_json(model_dir, "transformer", "config.json")
    cfg = mmdit_config_from_json(tc, dtype=dtype or torch.bfloat16, lora_rank=lora_rank,
                                 lora_alpha=lora_alpha)
    sd, base = _transformer_state(model_dir, tc, cfg)
    cfg = dataclasses.replace(cfg, pos_embed_base_size=base)
    sd = _round_bf16(sd)
    if lora_rank > 0:
        sd.update(sd3_lora_init(cfg))
    mmdit = _build(MMDiT, cfg, device)
    mmdit.load_state_dict(sd)
    del sd
    vae_cfg, vae = load_vae(os.path.join(model_dir, "vae"), device=device)
    return SD3Pipeline(cfg, vae_cfg, mmdit, vae, device)


def flux_config_from_json(tc: dict, **overrides):
    """``FluxConfig`` from a diffusers ``FluxTransformer2DModel``
    ``config.json``, with the JAX loader's keys and defaults (Flux.1-dev's);
    ``axes_dims_rope`` becomes the RoPE axes."""
    from adv_grpo_torch.models.flux import FluxConfig

    return FluxConfig(
        in_channels=tc.get("in_channels", 64), num_double_layers=tc.get("num_layers", 19),
        num_single_layers=tc.get("num_single_layers", 38),
        attention_head_dim=tc.get("attention_head_dim", 128),
        num_attention_heads=tc.get("num_attention_heads", 24),
        joint_attention_dim=tc.get("joint_attention_dim", 4096),
        pooled_projection_dim=tc.get("pooled_projection_dim", 768),
        guidance_embeds=tc.get("guidance_embeds", True),
        rope_axes_dims=tuple(tc.get("axes_dims_rope", (16, 56, 56))), **overrides)


def flux_state_dict_from_hf(sd: Dict[str, torch.Tensor], cfg) -> Dict[str, torch.Tensor]:
    """A diffusers ``FluxTransformer2DModel`` state dict -> the port's
    ``FluxTransformer`` state dict (the JAX ``convert_flux``'s mapping; the
    port keeps diffusers' names, so the text stream's ``add_q_proj`` /
    ``norm_added_q`` are the JAX tree's ``add_to_q`` / ``add_norm_q``, and
    ``norm_out.linear`` keeps its (scale, shift) row order, which the head
    reads). ``time_text_embed.guidance_embedder.*`` is required where
    ``cfg.guidance_embeds`` and refused as not consumed where not
    (Flux.1-schnell has none). Strict."""
    from adv_grpo_torch.models.flux import FluxTransformer

    return _take_module(sd, _frozen_keys(FluxTransformer(cfg, device="meta")),
                        "flux_state_dict_from_hf")


def flux_lora_init(cfg) -> Dict[str, torch.Tensor]:
    """Fresh adapters, bit for bit the JAX loader's (``_add_flux_lora_leaves``):
    one ``np.random.default_rng(0)`` over, per double block, to_q, to_k,
    to_v, to_out, add_to_q, add_to_k, add_to_v, to_add_out (the JAX attn
    dict's order), then per single block to_q, to_k, to_v, proj_mlp and
    proj_out (k_in = dim + mlp_dim)."""
    rng = np.random.default_rng(0)
    r, dim = cfg.lora_rank, cfg.hidden_dim
    out: Dict[str, torch.Tensor] = {}
    for i in range(cfg.num_double_layers):
        for name in ("to_q", "to_k", "to_v", "to_out.0", "add_q_proj", "add_k_proj",
                     "add_v_proj", "to_add_out"):
            _lora_factor(rng, f"transformer_blocks.{i}.attn.{name}", dim, dim, r, out)
    for i in range(cfg.num_single_layers):
        b = f"single_transformer_blocks.{i}."
        for name in ("attn.to_q", "attn.to_k", "attn.to_v"):
            _lora_factor(rng, b + name, dim, dim, r, out)
        _lora_factor(rng, b + "proj_mlp", dim, 4 * dim, r, out)
        _lora_factor(rng, b + "proj_out", 5 * dim, dim, r, out)
    return out


def load_flux_transformer(model_dir: str, *, dtype=None, lora_rank: int = 0,
                          lora_alpha: float = 1.0, device="cuda"):
    """(FluxConfig, FluxTransformer on ``device``) from a local diffusers
    ``FluxTransformer2DModel`` directory (``config.json`` beside
    ``*.safetensors`` shards), the JAX ``load_flux_transformer``: in ``dtype``
    (bf16 by default), whose fp32 weights are then rounded to bf16 as
    ``cast_tree_bf16`` does; with ``lora_rank`` > 0 the adapters of
    :func:`flux_lora_init`, fp32."""
    from adv_grpo_torch.models.flux import FluxTransformer
    from adv_grpo_torch.train.pipeline import _build

    cfg = flux_config_from_json(_read_json(model_dir, "config.json"),
                                dtype=dtype or torch.bfloat16, lora_rank=lora_rank,
                                lora_alpha=lora_alpha)
    sd = flux_state_dict_from_hf(load_torch_state_dict(model_dir), cfg)
    if cfg.dtype == torch.bfloat16:
        sd = _round_bf16(sd)
    if lora_rank > 0:
        sd.update(flux_lora_init(cfg))
    model = _build(FluxTransformer, cfg, torch.device(device))
    model.load_state_dict(sd)
    return cfg, model


def load_vae(vae_dir: str, *, base=None, device="cuda"):
    """(VAEConfig, AutoencoderKL on ``device``, fp32, encoder and decoder)
    from a local diffusers ``AutoencoderKL`` directory in the SD3 layout (no
    quant convs), the config by :func:`vae_config_from_json`: SD3's VAE with
    ``base=None``; the Flux VAE with ``base=VAEConfig.flux()``, whose
    ``scaling_factor`` / ``shift_factor`` are 0.3611 / 0.1159 where
    ``config.json`` lacks them. The JAX ``FluxPipeline.from_pretrained``
    calls a ``convert.load_vae(vae_dir, base=VAEConfig.flux())`` that the
    JAX package does not define; this is what that call means."""
    from adv_grpo_torch.models.vae import AutoencoderKL
    from adv_grpo_torch.train.pipeline import _build

    cfg = vae_config_from_json(_read_json(vae_dir, "config.json"), base=base)
    vae = _build(AutoencoderKL, cfg, torch.device(device))
    vae.load_state_dict(vae_state_dict_from_hf(load_torch_state_dict(vae_dir), cfg))
    return cfg, vae


def wan_config_from_json(tc: dict, **overrides):
    """``WanConfig`` from a diffusers ``WanTransformer3DModel``
    ``config.json``, with the JAX loader's keys and defaults
    (Wan2.1-T2V-1.3B's); the RoPE axes split the head width as diffusers'
    ``WanRotaryPosEmbed`` does: h = w = 2 * ((d // 3) // 2), t the rest.
    ``qk_norm`` is read from no key, as the JAX loader reads none (the model
    always normalises q and k across the heads)."""
    from adv_grpo_torch.models.wan import WanConfig

    d = tc.get("attention_head_dim", 128)
    hw = 2 * ((d // 3) // 2)
    return WanConfig(
        in_channels=tc.get("in_channels", 16), out_channels=tc.get("out_channels", 16),
        patch_size=tuple(tc.get("patch_size", (1, 2, 2))), num_layers=tc.get("num_layers", 30),
        attention_head_dim=d, num_attention_heads=tc.get("num_attention_heads", 12),
        text_dim=tc.get("text_dim", 4096), ffn_dim=tc.get("ffn_dim", 8960),
        rope_axes_dims=(d - 2 * hw, hw, hw), cross_attn_norm=tc.get("cross_attn_norm", True),
        **overrides)


def wan_state_dict_from_hf(sd: Dict[str, torch.Tensor], cfg) -> Dict[str, torch.Tensor]:
    """A diffusers ``WanTransformer3DModel`` state dict -> the port's
    ``WanTransformer`` state dict (the JAX ``convert_wan``'s mapping under
    diffusers' names): the patch Conv3d (dim, C, pt, ph, pw) as the port
    holds it (its forward flattens it (pt, ph, pw, C) as the JAX kernel is);
    the scale-shift tables (1, 6, dim) per block and (1, 2, dim) at the root;
    ``blocks.{i}.norm2.*`` required where ``cfg.cross_attn_norm`` and refused
    where not. Strict."""
    from adv_grpo_torch.models.wan import WanTransformer

    return _take_module(sd, _frozen_keys(WanTransformer(cfg, device="meta")),
                        "wan_state_dict_from_hf")


def wan_lora_init(cfg) -> Dict[str, torch.Tensor]:
    """Fresh adapters, bit for bit the JAX loader's (``_add_wan_lora_leaves``):
    one ``np.random.default_rng(0)`` over, per block, to_q, to_k, to_v,
    to_out, cross_to_q, cross_to_k, cross_to_v, cross_to_out (``attn1.*``,
    then ``attn2.*``)."""
    rng = np.random.default_rng(0)
    r, dim = cfg.lora_rank, cfg.hidden_dim
    out: Dict[str, torch.Tensor] = {}
    for i in range(cfg.num_layers):
        for attn in ("attn1", "attn2"):
            for name in ("to_q", "to_k", "to_v", "to_out.0"):
                _lora_factor(rng, f"blocks.{i}.{attn}.{name}", dim, dim, r, out)
    return out


def load_wan_transformer(model_dir: str, *, dtype=None, lora_rank: int = 0,
                         lora_alpha: float = 1.0, device="cuda"):
    """(WanConfig, WanTransformer on ``device``) from a local diffusers
    ``WanTransformer3DModel`` directory, the JAX ``load_wan_transformer``: in
    ``dtype`` (bf16 by default), whose fp32 weights are then rounded to bf16
    as ``cast_tree_bf16`` does (the scale-shift tables, ``norm2`` and the RMS
    weights too, held in fp32 parameters); with ``lora_rank`` > 0 the
    adapters of :func:`wan_lora_init`, fp32."""
    from adv_grpo_torch.models.wan import WanTransformer
    from adv_grpo_torch.train.pipeline import _build

    cfg = wan_config_from_json(_read_json(model_dir, "config.json"),
                               dtype=dtype or torch.bfloat16, lora_rank=lora_rank,
                               lora_alpha=lora_alpha)
    sd = wan_state_dict_from_hf(load_torch_state_dict(model_dir), cfg)
    if cfg.dtype == torch.bfloat16:
        sd = _round_bf16(sd)
    if lora_rank > 0:
        sd.update(wan_lora_init(cfg))
    model = _build(WanTransformer, cfg, torch.device(device))
    model.load_state_dict(sd)
    return cfg, model


def wan_vae_config_from_json(tc: dict):
    """``WanVAEConfig`` from a diffusers ``AutoencoderKLWan`` ``config.json``,
    with the JAX ``load_wan_vae``'s keys and defaults; the per-channel
    ``latents_mean`` / ``latents_std`` live there, not in the weights."""
    from adv_grpo_torch.models.wan_vae import WanVAEConfig

    z = tc.get("z_dim", 16)
    return WanVAEConfig(
        z_dim=z, base_dim=tc.get("base_dim", 96), dim_mult=tuple(tc.get("dim_mult", (1, 2, 4, 4))),
        num_res_blocks=tc.get("num_res_blocks", 2),
        attn_scales=tuple(tc.get("attn_scales", ())),
        temperal_downsample=tuple(tc.get("temperal_downsample", (False, True, True))),
        latents_mean=tuple(tc.get("latents_mean", (0.0,) * z)),
        latents_std=tuple(tc.get("latents_std", (1.0,) * z)))


def wan_vae_state_dict_from_hf(sd: Dict[str, torch.Tensor], cfg) -> Dict[str, torch.Tensor]:
    """A diffusers ``AutoencoderKLWan`` state dict -> the port's
    ``WanVideoVAE`` state dict, encoder, ``quant_conv``, ``post_quant_conv``
    and decoder (the JAX ``convert_wan_vae``'s mapping under diffusers'
    names: the RMS ``gamma`` (C, 1, 1, 1) / (C, 1, 1), ``resample.1`` the
    spatial conv, ``time_conv`` at the temporal stages only, ``to_qkv`` /
    ``proj`` 1x1 Conv2d, ``conv_shortcut`` where the width changes). Strict."""
    from adv_grpo_torch.models.wan_vae import WanVideoVAE

    return _take_module(sd, list(WanVideoVAE(cfg, device="meta").state_dict()),
                        "wan_vae_state_dict_from_hf")


def load_wan_vae(vae_dir: str, *, device="cuda"):
    """(WanVAEConfig, WanVideoVAE on ``device``) from a local diffusers
    ``AutoencoderKLWan`` directory, the JAX ``load_wan_vae``. fp32: the JAX
    loader casts nothing."""
    from adv_grpo_torch.models.wan_vae import WanVideoVAE
    from adv_grpo_torch.train.pipeline import _build

    cfg = wan_vae_config_from_json(_read_json(vae_dir, "config.json"))
    vae = _build(WanVideoVAE, cfg, torch.device(device))
    vae.load_state_dict(wan_vae_state_dict_from_hf(load_torch_state_dict(vae_dir), cfg))
    return cfg, vae


def _count(sd) -> int:
    return int(sum(v.numel() for v in sd.values()))


def preflight(model_dir: str, check_text_encoders: bool = True) -> dict:
    """Run every converter over a local diffusers-layout SD3 directory
    without building a model: parameter counts, the detected pos-embed
    convention, the dual-attention layers, the VAE's factors and the text
    encoders ("absent" where a folder is missing); a missing weight raises
    ``KeyError``, a weight left over "not consumed". The report is the JAX
    ``preflight``'s, key for key."""
    report: dict = {"model_dir": os.path.abspath(model_dir)}
    tc = _read_json(model_dir, "transformer", "config.json")
    cfg = mmdit_config_from_json(tc)
    sd, base = _transformer_state(model_dir, tc, cfg)
    report["transformer"] = {"layers": cfg.num_layers, "params": _count(sd),
                             "pos_embed_base_size": base,
                             "dual_attention_layers": list(cfg.dual_attention_layers)}
    del sd
    vae_cfg = vae_config_from_json(_read_json(model_dir, "vae", "config.json"))
    vp = vae_state_dict_from_hf(load_torch_state_dict(os.path.join(model_dir, "vae")), vae_cfg)
    report["vae"] = {"params": _count(vp), "scaling_factor": vae_cfg.scaling_factor,
                     "shift_factor": vae_cfg.shift_factor}
    del vp
    if check_text_encoders:
        for sub in ("text_encoder", "text_encoder_2", "text_encoder_3"):
            d = os.path.join(model_dir, sub)
            if not os.path.isdir(d):
                report[sub] = "absent"
                continue
            ec = _read_json(d, "config.json")
            if sub == "text_encoder_3":
                ep = t5_state_dict_from_hf(load_torch_state_dict(d), ec["num_layers"])
            else:
                ep = clip_text_state_dict_from_hf(load_torch_state_dict(d),
                                                  ec["num_hidden_layers"])
            report[sub] = {"params": _count(ep)}
    return report


def _main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(
        description="Check a local diffusers-layout SD3 checkpoint directory against the "
                    "converters (the conversion itself happens at load time, in "
                    "load_sd3_pipeline)")
    ap.add_argument("--src", required=True, help="diffusers-layout model dir")
    ap.add_argument("--skip_text_encoders", action="store_true")
    args = ap.parse_args(argv)
    report = preflight(args.src, check_text_encoders=not args.skip_text_encoders)
    print(json.dumps(report, indent=2))
    print("PREFLIGHT OK — point config.pretrained.model at this directory")


if __name__ == "__main__":
    _main()
