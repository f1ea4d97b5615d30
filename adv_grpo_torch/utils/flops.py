"""Analytic FLOP counts of the MMDiT, Flux and WAN forwards.

The port's own copy of adv_grpo_tpu/utils/flops.py (``mmdit_forward_flops``,
``flux_forward_flops``, ``wan_forward_flops``, ``rollout_flops``): closed-form matmul + attention
counts, which the trainer's throughput metric and ``chip_smoke.py``'s achieved
TFLOP/s divide by measured time. AdaLN and the other per-sample (not
per-token) products are left out as negligible.
"""

from __future__ import annotations


def mmdit_forward_flops(cfg, s_img: int, s_txt: int, batch: int) -> float:
    """FLOPs of ONE MMDiT forward over ``batch`` samples: per layer and token
    of each stream qkv+out (4D^2) and the MLP (8D^2), x2 FLOP per parameter;
    dual-attention layers add a self-attention (4D^2) on the image tokens;
    attention 4*S^2*D per layer; the embedders."""
    D = cfg.hidden_dim
    L = cfg.num_layers
    n_dual = len(cfg.dual_attention_layers)
    s_tot = s_img + s_txt
    main = L * (2.0 * 12 * D * D * s_tot + 4.0 * s_tot**2 * D)
    dual = n_dual * (2.0 * 4 * D * D * s_img + 4.0 * s_img**2 * D)
    embed = 2.0 * (s_txt * cfg.joint_attention_dim * D
                   + s_img * cfg.in_channels * cfg.patch_size**2 * D)
    return batch * (main + dual + embed)


def flux_forward_flops(cfg, s_img: int, s_txt: int, batch: int) -> float:
    """FLOPs of ONE Flux transformer forward: 12D^2 parameters per token per
    block of either kind (double: q/k/v/out 4D^2 + MLP 8D^2 per stream;
    single: fused q/k/v 3D^2 + proj_mlp 4D^2 + proj_out 5D^2), x2 FLOP per
    parameter; joint attention 4*S_tot^2*D per block; the two embedders."""
    D = cfg.hidden_dim
    s_tot = s_img + s_txt
    per_token = 2.0 * 12 * D * D
    attn = 4.0 * s_tot**2 * D
    main = (cfg.num_double_layers + cfg.num_single_layers) * (per_token * s_tot + attn)
    embed = 2.0 * (s_txt * cfg.joint_attention_dim * D + s_img * cfg.in_channels * D)
    return batch * (main + embed)


def wan_forward_flops(cfg, s_vid: int, s_txt: int, batch: int) -> float:
    """FLOPs of ONE WanTransformer forward over ``batch`` samples: per layer,
    self-attention q/k/v/out (4D^2 per video token), cross-attention q/out on
    the video tokens and k/v on the text tokens (2D^2 each), the FFN (2 D
    ffn_dim per video token), x2 FLOP per parameter; attention 4 S^2 D (self)
    and 4 S S_txt D (cross) per layer; the patch and text embedders."""
    D = cfg.hidden_dim
    L = cfg.num_layers
    self_attn = 2.0 * (4 * D * D) * s_vid + 4.0 * s_vid**2 * D
    cross = (2.0 * (2 * D * D) * s_vid + 2.0 * (2 * D * D) * s_txt
             + 4.0 * s_vid * s_txt * D)
    ffn = 2.0 * (2 * D * cfg.ffn_dim) * s_vid
    main = L * (self_attn + cross + ffn)
    p = 1
    for x in cfg.patch_size:
        p *= x
    embed = (2.0 * s_vid * cfg.in_channels * p * D
             + 2.0 * s_txt * cfg.text_dim * D * 2)
    return batch * (main + embed)


def rollout_flops(cfg, s_img: int, s_txt: int, batch: int, num_steps: int,
                  do_cfg: bool, prefix_steps: int = 0, group_size: int = 1) -> float:
    """FLOPs of one MMDiT denoise rollout: ``num_steps`` forwards at the CFG
    batch. ``prefix_steps`` > 0 is the group-shared sampler: those steps run
    at ``batch / group_size`` (one latent per prompt slot) before the group
    is repeated at the window start."""
    mult = 2 if do_cfg else 1
    full = mmdit_forward_flops(cfg, s_img, s_txt, batch * mult)
    if prefix_steps <= 0 or group_size <= 1:
        return num_steps * full
    small = mmdit_forward_flops(cfg, s_img, s_txt, batch * mult // group_size)
    return prefix_steps * small + (num_steps - prefix_steps) * full
