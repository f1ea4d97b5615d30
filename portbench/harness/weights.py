"""Random weights and inputs from the seed, made on the device in a few large
draws, in the type each tensor is served in.

A weight depends on (seed, the module's tag, its name's place in the sorted
name list, its shape): the program's modules and the reference's are given
the same values by name, each side making them itself. The families of the
draws are those of the port's own initialisers (flax's lecun normal for
matrices, zero biases, unit norm scales), so activations keep the scale a
trained model has; the LoRA's B factor is drawn too (``LORA_B_STD``), where a
fresh adapter's would be 0.
"""

from __future__ import annotations

import math
import zlib
from typing import Dict, List, Tuple

import numpy as np
import torch

Spec = List[Tuple[str, Tuple[int, ...], torch.dtype]]

LOGIT_SCALE = 4.6052  # log(100)
# a LoRA as a tuned or resumed one is: B nonzero, so the adapters' forward
# and the A factors' gradients count (with A's std 1/r, a rank-32, alpha-64
# adapter on a 1536-wide layer adds about 14% of the layer's output)
LORA_B_STD = 0.01


def stream_seed(*parts) -> int:
    """A 63-bit generator seed from integers and strings."""
    ints = [zlib.crc32(p.encode()) if isinstance(p, str) else int(p) % 2**64 for p in parts]
    return int(np.random.SeedSequence(ints).generate_state(1, np.uint64)[0] >> np.uint64(1))


def _rule(name: str, shape, family: str):
    """("normal", std) or ("fill", value) of one tensor."""
    leaf = name.rsplit(".", 1)[-1]
    if family == "clip":
        if leaf == "logit_scale":
            return "fill", LOGIT_SCALE
        if leaf in ("class_embedding", "position_embedding"):
            return "normal", 0.02
    if leaf == "bias":
        return "fill", 0.0
    if leaf == "lora_b":
        return "normal", LORA_B_STD
    if leaf == "lora_a":
        return "normal", 1.0 / shape[1]
    if leaf == "scale_shift_table":
        return "normal", 0.02
    if len(shape) <= 1 or leaf == "gamma":
        return "fill", 1.0
    return "normal", math.prod(shape[1:]) ** -0.5


def make_weights(spec: Spec, family: str, seed: int, tag: str, device) -> Dict[str, torch.Tensor]:
    """{name: tensor} for ``spec`` ((name, shape, dtype) of every parameter):
    one standard-normal draw per dtype over all the normal tensors, in sorted
    name order, then scaled per tensor."""
    device = torch.device(device)
    g = torch.Generator(device=device).manual_seed(stream_seed(seed, tag))
    spec = sorted(spec, key=lambda s: s[0])
    out: Dict[str, torch.Tensor] = {}
    normals: Dict[torch.dtype, list] = {}
    for name, shape, dtype in spec:
        kind, val = _rule(name, shape, family)
        if kind == "fill":
            out[name] = torch.full(tuple(shape), val, dtype=dtype, device=device)
        else:
            normals.setdefault(dtype, []).append((name, tuple(shape), val))
    for dtype in sorted(normals, key=str):
        items = normals[dtype]
        total = sum(math.prod(s) for _, s, _ in items)
        buf = torch.randn(total, generator=g, device=device, dtype=dtype)
        off = 0
        for name, shape, std in items:
            n = math.prod(shape)
            out[name] = buf[off:off + n].view(shape).mul_(std)
            off += n
    return out


def module_spec(module: torch.nn.Module, prefix: str = "") -> Spec:
    return [(n, tuple(p.shape), p.dtype) for n, p in module.named_parameters()
            if n.startswith(prefix)]


@torch.no_grad()
def load_into(module: torch.nn.Module, weights: Dict[str, torch.Tensor], prefix: str = ""):
    """Copy ``weights`` into ``module``'s parameters under ``prefix`` in place;
    every such parameter must be given, with its shape and dtype."""
    params = {n: p for n, p in module.named_parameters() if n.startswith(prefix)}
    if set(params) != set(weights):
        raise ValueError(f"weights and parameters differ: only in weights "
                         f"{sorted(set(weights) - set(params))[:5]}, only in the module "
                         f"{sorted(set(params) - set(weights))[:5]}")
    for n, p in params.items():
        w = weights[n]
        if tuple(w.shape) != tuple(p.shape) or w.dtype != p.dtype:
            raise ValueError(f"{n}: weight {tuple(w.shape)} {w.dtype}, parameter "
                             f"{tuple(p.shape)} {p.dtype}")
        p.copy_(w)


def batch_seed(seed: int, what: str, index: int) -> int:
    """The seed of input ``index`` of kind ``what`` (prompts, latents)."""
    return stream_seed(seed, what, index)
