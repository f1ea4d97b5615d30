"""Row statistics shared by the fused attention backwards.

Port of the part of adv_grpo_tpu/ops/attention.py that the SD3 path uses
(``bwd_row_stats``). The TPU layout's lane broadcast of the statistics
(``LSE_LANES``) has no counterpart here: they stay (B, H, S).
"""

from __future__ import annotations


def bwd_row_stats(o, do, num_heads):
    """di = sum_d o * do per (batch, head, row), fp32 (B, H, S), from o as the
    forward stored it (bf16 on the card) — the JAX ``bwd_row_stats``."""
    b, s, hd = o.shape
    di = (o.float() * do.float()).reshape(b, s, num_heads, hd // num_heads).sum(-1)
    return di.transpose(1, 2).contiguous()
