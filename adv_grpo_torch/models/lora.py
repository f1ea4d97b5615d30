"""LoRA-augmented Linear layer and the random parameter initialiser.

Port of adv_grpo_tpu/models/lora.py. ``LoRALinear`` computes

    y = x W^T + b + lora_scale * (alpha / r) * (x A) B

in the layer's parameter dtype (the JAX ``LoRADense`` casts every weight to
the compute dtype before its product; here the weights are held in that dtype,
bf16 on the card). A is (in, r) and B is (r, out), the JAX layout, so the
adapters carry across unchanged; the delta is computed factored and never
materialises the rank-full update. The state-dict names of the base layer are
torch's ``weight`` (out, in) and ``bias``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class LoRALinear(nn.Module):
    def __init__(self, in_features: int, out_features: int, *, lora_rank: int = 0,
                 lora_alpha: float = 1.0, bias: bool = True, dtype=torch.float32,
                 device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.in_features, self.out_features = in_features, out_features
        self.lora_rank, self.lora_alpha = lora_rank, lora_alpha
        self.weight = nn.Parameter(torch.empty(out_features, in_features, **kw))
        self.bias = nn.Parameter(torch.empty(out_features, **kw)) if bias else None
        if lora_rank > 0:
            self.lora_a = nn.Parameter(torch.empty(in_features, lora_rank, **kw))
            self.lora_b = nn.Parameter(torch.empty(lora_rank, out_features, **kw))

    def forward(self, x, lora_scale: float = 1.0):
        x = x.to(self.weight.dtype)
        y = F.linear(x, self.weight, self.bias)
        if self.lora_rank > 0:
            scaling = lora_scale * (self.lora_alpha / self.lora_rank)
            y = y + scaling * ((x @ self.lora_a) @ self.lora_b)
        return y


@torch.no_grad()
def init_params_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Random-init every parameter in place, with the distributions of the JAX
    package's flax initialisers (same families, not the same numbers):

      * matrices and conv kernels: normal, std 1/sqrt(fan_in) (flax's
        lecun_normal, untruncated here);
      * biases and LoRA B: zeros (an adapter starts as the identity);
      * LoRA A: normal, std 1/r (PEFT's gaussian init);
      * 1-D ``weight``s (RMS and GroupNorm scales): ones.
    """
    for name, p in module.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("bias", "lora_b"):
            p.zero_()
        elif leaf == "lora_a":
            p.normal_(0.0, 1.0 / p.shape[1], generator=generator)
        elif p.ndim == 1:
            p.fill_(1.0)
        else:
            p.normal_(0.0, p[0].numel() ** -0.5, generator=generator)
    return module
