"""The work a unit asks of the chip, counted from shapes, and the chip's
published peaks.

``mmdit_forward_flops`` and ``wan_forward_flops`` are frozen copies of
``adv_grpo_torch/utils/flops.py``'s; the attention bound is that of
``chip_smoke.py::_bound`` / ``_attn_bound`` (the larger of bytes over the HBM
rate and FLOPs over the bf16 tensor-core rate; a backward counts 5 products
to a forward's 2; each input read once, each output written once)."""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense: bf16 tensor cores, TF32, fp32 outside
# the tensor cores, HBM3 bandwidth
PEAK_FLOPS = {"bfloat16": 989e12, "tf32": 495e12, "float32": 67e12}
HBM_BYTES_PER_S = 3.35e12


def mmdit_forward_flops(cfg: dict, s_img: int, s_txt: int, batch: int) -> float:
    """One MMDiT forward over ``batch`` rows: per layer and token of each
    stream q/k/v/out (4 D^2) and the MLP (8 D^2) at 2 FLOP a parameter;
    a dual-attention layer adds a self-attention (4 D^2) on the image
    tokens; attention 4 S^2 D a layer; the embedders."""
    D = cfg["num_attention_heads"] * cfg["attention_head_dim"]
    L = cfg["num_layers"]
    n_dual = len(cfg["dual_attention_layers"])
    s_tot = s_img + s_txt
    main = L * (2.0 * 12 * D * D * s_tot + 4.0 * s_tot ** 2 * D)
    dual = n_dual * (2.0 * 4 * D * D * s_img + 4.0 * s_img ** 2 * D)
    embed = 2.0 * (s_txt * cfg["joint_attention_dim"] * D
                   + s_img * cfg["in_channels"] * cfg["patch_size"] ** 2 * D)
    return batch * (main + embed + dual)


def wan_forward_flops(cfg: dict, s_vid: int, s_txt: int, batch: int) -> float:
    """One WAN transformer forward over ``batch`` rows: per layer
    self-attention q/k/v/out (4 D^2 a video token), cross-attention q/out on
    the video tokens and k/v on the text (2 D^2 each), the FFN (2 D ffn_dim
    a video token), at 2 FLOP a parameter; attention 4 S^2 D (self) and 4 S
    S_txt D (cross); the patch and text embedders."""
    D = cfg["num_attention_heads"] * cfg["attention_head_dim"]
    self_attn = 2.0 * (4 * D * D) * s_vid + 4.0 * s_vid ** 2 * D
    cross = 2.0 * (2 * D * D) * s_vid + 2.0 * (2 * D * D) * s_txt + 4.0 * s_vid * s_txt * D
    ffn = 2.0 * (2 * D * cfg["ffn_dim"]) * s_vid
    p = 1
    for x in cfg["patch_size"]:
        p *= x
    embed = 2.0 * s_vid * cfg["in_channels"] * p * D + 2.0 * s_txt * cfg["text_dim"] * D * 2
    return batch * (cfg["num_layers"] * (self_attn + cross + ffn) + embed)


def wan_attention_calls(cfg: dict, s_vid: int, s_txt: int, rows: int, backward: bool):
    """Every layer's self-attention and cross-attention, forward or backward."""
    H, d, L = cfg["num_attention_heads"], cfg["attention_head_dim"], cfg["num_layers"]
    k = 5 if backward else 2
    return [(L, rows, H, s_vid, s_vid, d, k), (L, rows, H, s_vid, s_txt, d, k)]


def sd3_tokens(cfg: dict, latent_hw: int) -> int:
    return (latent_hw // cfg["patch_size"]) ** 2


def sd3_attention_calls(cfg: dict, s_img: int, s_txt: int, rows: int, backward: bool):
    """(count, batch, heads, s_q, s_kv, d, products) of one MMDiT forward's
    attentions, or of its backward's: the joint attention of every layer,
    the image self-attention of the dual layers (which has no backward in
    layer 0, whose input is the patch embedding and carries no gradient)."""
    H, d = cfg["num_attention_heads"], cfg["attention_head_dim"]
    S = s_img + s_txt
    dual = list(cfg["dual_attention_layers"])
    if backward:
        return [(cfg["num_layers"], rows, H, S, S, d, 5),
                (len([i for i in dual if i != 0]), rows, H, s_img, s_img, d, 5)]
    return [(cfg["num_layers"], rows, H, S, S, d, 2), (len(dual), rows, H, s_img, s_img, d, 2)]


def attention_min_s(calls, elem_bytes: int = 2, flop_rate: float = PEAK_FLOPS["bfloat16"]):
    """The least time the card needs for ``calls``: per call the larger of
    its bytes (q, k, v, o forward; q, k, v, o, do, dq, dk, dv backward) over
    the HBM rate and its FLOPs over ``flop_rate``."""
    total = 0.0
    for count, b, h, sq, skv, d, products in calls:
        tensors = 4 if products == 2 else 8
        nbytes = tensors * b * h * max(sq, skv) * d * elem_bytes
        flops = 2.0 * products * b * h * sq * skv * d
        total += count * max(nbytes / HBM_BYTES_PER_S, flops / flop_rate)
    return total
