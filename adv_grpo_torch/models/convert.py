"""JAX parameter trees -> the port's state dicts.

The inverse of adv_grpo_tpu.models.convert's ``convert_mmdit`` /
``convert_flux`` / ``convert_vae`` / ``convert_wan`` / ``convert_wan_vae``
(decoder half), the CLIP dual encoder that ``convert_clip_model``
fills (:func:`clip_dual_state_dict_from_jax`), the DINOv2 backbone
(:func:`vit_state_dict_from_jax`) and the DINO heads
(:func:`dino_head_state_dict_from_jax`, :func:`dino_multi_state_dict_from_jax`):
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

from typing import Dict

import numpy as np
import torch

from adv_grpo_torch.models.lora import lora_params, merge_lora_params


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


def vae_state_dict_from_jax(params, cfg) -> Dict[str, torch.Tensor]:
    """adv_grpo_tpu AutoencoderKL params -> adv_grpo_torch AutoencoderKL
    (decoder) state dict. The encoder's weights are not carried: the port's
    VAE has no encoder yet."""
    dec = _unwrap(params)["decoder"]
    out: Dict[str, torch.Tensor] = {}
    _conv("decoder.conv_in", dec["conv_in"], out)
    _resnet("decoder.mid_block.resnets.0", dec["mid_res_0"], out)
    _resnet("decoder.mid_block.resnets.1", dec["mid_res_1"], out)
    a = "decoder.mid_block.attentions.0"
    _group_norm(a + ".group_norm", dec["mid_attn"]["group_norm"], out)
    for name, dst in (("to_q", "to_q"), ("to_k", "to_k"), ("to_v", "to_v"),
                      ("to_out", "to_out.0")):
        _dense(f"{a}.{dst}", dec["mid_attn"][name], out)
    n_blocks = len(cfg.block_out_channels)
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
    """adv_grpo_tpu WanVideoVAE params -> adv_grpo_torch WanVideoVAE state dict
    (diffusers AutoencoderKLWan names). The encoder's weights are not carried:
    the port's WAN VAE has no encoder yet."""
    dec = _unwrap(params)["decoder"]
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

    _wan_conv3d("post_quant_conv", dec["post_quant_conv"], out)
    _wan_conv3d("decoder.conv_in", dec["conv_in"], out)
    res("decoder.mid_block.resnets.0", dec["mid"]["res0"])
    attn("decoder.mid_block.attentions.0", dec["mid"]["attn0"])
    res("decoder.mid_block.resnets.1", dec["mid"]["res1"])
    n = 0
    while f"up_{n}" in dec:
        p, prefix = dec[f"up_{n}"], f"decoder.up_blocks.{n}"
        if "resample_conv" in p:
            _conv(prefix + ".resample.1", p["resample_conv"], out)
            if "time_conv" in p:
                _wan_conv3d(prefix + ".time_conv", p["time_conv"], out)
        elif "to_qkv" in p:
            attn(prefix, p)
        else:
            res(prefix, p)
        n += 1
    rms("decoder.norm_out", dec["norm_out"], 3)
    _wan_conv3d("decoder.conv_out", dec["conv_out"], out)
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


def dino_multi_state_dict_from_jax(params) -> Dict[str, torch.Tensor]:
    """A JAX ``DINOMultiScorer`` tree ({"heads": [...], "fusion": {"fuse"}})
    -> ``rewards.scorers.DINOMultiHeads``' state dict."""
    out: Dict[str, torch.Tensor] = {}
    for i, head in enumerate(params["heads"]):
        out.update(dino_head_state_dict_from_jax(head, f"heads.{i}."))
    _dense("fusion", params["fusion"]["fuse"], out)
    return out
