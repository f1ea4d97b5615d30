"""LoRA-augmented Linear layer, the LoRA-subtree helpers, and the random
parameter initialiser.

Port of adv_grpo_tpu/models/lora.py. ``LoRALinear`` computes

    y = x W^T + b + lora_scale * (alpha / r) * (x A) B

in the layer's compute dtype (the JAX ``LoRADense`` casts every weight to
the compute dtype before its product). The base weight and bias are held in
that dtype (bf16 on the card); the LoRA factors are fp32 parameters in every
dtype, as the JAX ``param_dtype=float32``, and are cast at the product, so
optimizer and EMA updates below bf16 spacing are kept. A is (in, r) and B is
(r, out), the JAX layout, so the adapters carry across unchanged; the delta is
computed factored and never materialises the rank-full update. The state-dict
names of the base layer are torch's ``weight`` (out, in) and ``bias``.

The LoRA subtree is addressed by the JAX package's flat path names
(``block_3/attn/to_out/lora_a`` for the MMDiT, :func:`jax_lora_path`; a model
whose JAX tree is named otherwise, as Flux's ``double_3/attn/add_to_q``,
carries its own ``jax_lora_path``), so the two packages' trainers exchange it
key for key.
"""

from __future__ import annotations

import re
from typing import Dict

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
            fp32 = dict(dtype=torch.float32, device=device)
            self.lora_a = nn.Parameter(torch.empty(in_features, lora_rank, **fp32))
            self.lora_b = nn.Parameter(torch.empty(lora_rank, out_features, **fp32))

    def forward(self, x, lora_scale: float = 1.0):
        dt = self.weight.dtype
        x = x.to(dt)
        y = F.linear(x, self.weight, self.bias)
        if self.lora_rank > 0:
            scaling = lora_scale * (self.lora_alpha / self.lora_rank)
            y = y + scaling * ((x @ self.lora_a.to(dt)) @ self.lora_b.to(dt))
        return y


def fused_qkv_proj(mods, x, lora_scale: float = 1.0):
    """Apply sibling ``LoRALinear``s of the SAME input as ONE product (the JAX
    ``fused_qkv_proj``, adv_grpo_tpu/models/lora.py:90).

    The base weights and the LoRA A factors concatenate into one operand of
    ``N*out + N*r`` output columns, so ``x`` is read once for all of them; a
    product's output columns are independent, so each slice equals the
    separate ``x W_i^T + b_i`` / ``x A_i`` (the biases ride in the product's
    epilogue, zeros beside the A columns). ``scaling * (x A_i) B_i`` is then
    added per projection in the compute dtype, as the JAX op does. Without
    LoRA the outputs are column slices of one tensor (strided rows). The
    modules keep their own parameters (and state-dict names); they must share
    the input width, rank and dtype and all have biases. Returns the N
    outputs in order.
    """
    m0 = mods[0]
    dt = m0.weight.dtype
    r = m0.lora_rank
    y = F.linear(x.to(dt), *_fused_operand(mods))
    outs, off = [], 0
    for m in mods:
        outs.append(y[..., off:off + m.out_features])
        off += m.out_features
    if r > 0:
        scaling = lora_scale * (m0.lora_alpha / r)
        for i, m in enumerate(mods):
            h = y[..., off + i * r: off + (i + 1) * r]
            outs[i] = outs[i] + scaling * (h @ m.lora_b.to(dt))
    return outs


def _fused_operand(mods):
    """(weight, bias) of :func:`fused_qkv_proj`'s one product.

    Concatenating copies every base weight, so the operand is kept on the
    first module and reused while its parameters stay the same tensors,
    unmodified in place (the cache holds each parameter's storage alive and
    records its in-place version). It is rebuilt on every call when autograd
    must reach the parameters through it (a training forward)."""
    dt = mods[0].weight.dtype
    lora = [m.lora_a for m in mods if m.lora_rank > 0]
    params = [m.weight for m in mods] + lora + [m.bias for m in mods]
    grad = torch.is_grad_enabled() and any(p.requires_grad for p in params)
    mode = torch.is_inference_mode_enabled()
    cached = mods[0].__dict__.get("_fused_operand_cache")
    if not grad and cached is not None and cached[0] == mode and all(
            a.data_ptr() == p.data_ptr() and a.device == p.device and v == p._version
            for (a, v), p in zip(cached[1], params)):
        return cached[2]
    weight = torch.cat([m.weight for m in mods] + [a.t().to(dt) for a in lora])
    lora_bias = [torch.zeros(len(lora) * mods[0].lora_rank, dtype=dt, device=weight.device)]
    bias = torch.cat([m.bias for m in mods] + (lora_bias if lora else []))
    if not grad:
        mods[0]._fused_operand_cache = (mode, [(p.detach(), p._version) for p in params],
                                        (weight, bias))
    return weight, bias


def jax_lora_path(name: str) -> str:
    """Port parameter name -> the JAX flat LoRA path:
    ``transformer_blocks.3.attn.to_out.0.lora_a`` -> ``block_3/attn/to_out/lora_a``."""
    name = re.sub(r"^transformer_blocks\.(\d+)\.", r"block_\1.", name)
    return name.replace(".to_out.0.", ".to_out.").replace(".", "/")


def lora_params(module: nn.Module) -> Dict[str, nn.Parameter]:
    """The LoRA parameters of ``module`` by their JAX flat path names (the
    JAX ``lora_params``), in module order: the module's own
    ``jax_lora_path`` where it has one, else the MMDiT's."""
    path = getattr(module, "jax_lora_path", jax_lora_path)
    return {path(name): p for name, p in module.named_parameters()
            if name.rsplit(".", 1)[-1] in ("lora_a", "lora_b")}


def freeze_non_lora(module: nn.Module) -> Dict[str, nn.Parameter]:
    """The JAX trainable mask (``lora_mask``): ``requires_grad=False`` on every
    parameter but the LoRA factors. Returns :func:`lora_params`."""
    lora = lora_params(module)
    keep = {id(p) for p in lora.values()}
    for p in module.parameters():
        p.requires_grad_(id(p) in keep)
    return lora


@torch.no_grad()
def merge_lora_params(module: nn.Module, lora_flat) -> None:
    """Write LoRA values (JAX flat path names, tensors or numpy arrays) into
    ``module``'s LoRA parameters in place (the JAX ``merge_lora_params``)."""
    params = lora_params(module)
    for key, val in lora_flat.items():
        if key not in params:
            raise KeyError(f"LoRA param {key} not found in the module")
        p = params[key]
        p.copy_(torch.as_tensor(val, dtype=p.dtype).reshape(p.shape))


@torch.no_grad()
def init_params_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Random-init every parameter in place, with the distributions of the JAX
    package's flax initialisers (same families, not the same numbers):

      * matrices and conv kernels: normal, std 1/sqrt(fan_in) (flax's
        lecun_normal, untruncated here);
      * biases and LoRA B: zeros (an adapter starts as the identity);
      * LoRA A: normal, std 1/r (PEFT's gaussian init);
      * 1-D ``weight``s (RMS, LayerNorm and GroupNorm scales) and the WAN
        VAE's RMS ``gamma``: ones;
      * WAN's modulation ``scale_shift_table``: normal, std 0.02.
    """
    for name, p in module.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("bias", "lora_b"):
            p.zero_()
        elif leaf == "lora_a":
            p.normal_(0.0, 1.0 / p.shape[1], generator=generator)
        elif leaf == "scale_shift_table":
            p.normal_(0.0, 0.02, generator=generator)
        elif p.ndim == 1 or leaf == "gamma":
            p.fill_(1.0)
        else:
            p.normal_(0.0, p[0].numel() ** -0.5, generator=generator)
    return module
