"""peft LoRA adapter interchange: read a published adapter, write ours.

Port of adv_grpo_tpu/models/peft_lora.py. The reference ships trained
adapters as peft directories, ``adapter_config.json`` +
``adapter_model.safetensors`` written by ``PeftModel.save_pretrained`` and
read by ``PeftModel.from_pretrained``. This module maps that format onto the
port's LoRA parameters by their JAX flat path names
(:func:`adv_grpo_torch.models.lora.lora_params`):

  peft key  base_model.model.transformer_blocks.{i}.attn.{proj}.lora_A.weight
  ours      block_{i}/attn/{proj}/lora_a

with ``to_out.0`` (a torch ModuleList) flattening to ``to_out``, and both
matrices transposed (a torch Linear stores (out, in); ``LoRALinear`` holds
A (in, r) and B (r, out)). The key mapping is the JAX package's, copied
verbatim (``tests/test_torch_copies.py`` holds the two equal), so an adapter
either package writes reads in the other bit for bit. Only SD3's names are
the reference's peft names; Flux's (``double_i/...``, ``single_i/...``) and
WAN's LoRA paths go through the same mapping and round-trip, as in the JAX
package. The safetensors file is read and written by
:mod:`adv_grpo_torch.utils.safetensors_io`.
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from adv_grpo_torch.utils import safetensors_io

DEFAULT_BASE_MODEL = "stabilityai/stable-diffusion-3.5-medium"

_LORA_KEY = re.compile(
    r"^(?P<module>.+?)\.lora_(?P<ab>[AB])(?:\.default)?\.weight$")
# prefixes peft versions/wrappers prepend to the module path
_PREFIXES = ("base_model.model.", "transformer.", "base_model.")


def _module_to_flax_path(module: str) -> str:
    """'transformer_blocks.3.attn.to_out.0' -> 'block_3/attn/to_out'."""
    for p in _PREFIXES:
        if module.startswith(p):
            module = module[len(p):]
            break
    # torch ModuleList wrapper: attn.to_out.0 -> to_out (only there — a bare
    # '0' elsewhere is a block index)
    module = re.sub(r"\.to_out\.0$", ".to_out", module)
    parts = module.split(".")
    out = []
    for i, part in enumerate(parts):
        if part == "transformer_blocks":
            continue
        if i > 0 and parts[i - 1] == "transformer_blocks":
            out.append(f"block_{part}")
        else:
            out.append(part)
    return "/".join(out)


def _flax_path_to_module(path: str) -> str:
    """Inverse of :func:`_module_to_flax_path` (canonical peft naming)."""
    parts = []
    for part in path.split("/"):
        m = re.fullmatch(r"block_(\d+)", part)
        if m:
            parts.extend(["transformer_blocks", m.group(1)])
        elif part == "to_out":
            parts.extend(["to_out", "0"])
        else:
            parts.append(part)
    return "base_model.model." + ".".join(parts)


def _read_state_dict(adapter_dir: str) -> Dict[str, torch.Tensor]:
    """Every ``.safetensors`` file of the directory (the JAX package's
    ``load_torch_state_dict``), else its torch ``.bin`` files."""
    files = sorted(os.listdir(adapter_dir))
    sd: Dict[str, torch.Tensor] = {}
    st_files = [f for f in files if f.endswith(".safetensors")]
    for fname in st_files:
        sd.update(safetensors_io.load_file(os.path.join(adapter_dir, fname)))
    if not st_files:
        for fname in (f for f in files if f.endswith(".bin")):
            sd.update(torch.load(os.path.join(adapter_dir, fname), map_location="cpu",
                                 weights_only=True))
    return sd


def import_peft_lora(adapter_dir: str) -> Tuple[Dict[str, np.ndarray], dict]:
    """Read a peft adapter directory into :func:`models.lora.lora_params` names.

    Returns ``(lora_flat, adapter_config)`` where ``lora_flat`` maps
    ``block_i/attn/{proj}/lora_{a,b}`` to fp32 arrays in the (in, r) / (r,
    out) layout, ready for ``merge_lora_params``.
    """
    with open(os.path.join(adapter_dir, "adapter_config.json")) as f:
        cfg = json.load(f)
    flat: Dict[str, np.ndarray] = {}
    for key, val in _read_state_dict(adapter_dir).items():
        m = _LORA_KEY.match(key)
        if m is None:
            raise ValueError(
                f"unrecognized key {key!r} in {adapter_dir} — not a peft LoRA "
                "adapter state dict")
        base = _module_to_flax_path(m.group("module"))
        # torch Linear weight is (out_features, in_features):
        #   lora_A.weight (r, in)  -> A (in, r)
        #   lora_B.weight (out, r) -> B (r, out)
        leaf = "lora_a" if m.group("ab") == "A" else "lora_b"
        flat[f"{base}/{leaf}"] = val.float().numpy().T
    r = int(cfg.get("r", 0))
    for k, v in flat.items():
        got = v.shape[1] if k.endswith("lora_a") else v.shape[0]
        if r and got != r:
            raise ValueError(
                f"{k}: rank {got} does not match adapter_config r={r}")
    return flat, cfg


def validate_against_model(cfg: dict, lora_rank: int,
                           lora_alpha: Optional[float] = None):
    """Fail loudly when the adapter's r/alpha disagree with the model config —
    a silent mismatch mis-scales the delta by alpha_model/r_model instead of
    the alpha/r the adapter was trained with."""
    r, alpha = int(cfg.get("r", 0)), cfg.get("lora_alpha")
    if r and lora_rank and r != int(lora_rank):
        raise ValueError(
            f"peft adapter r={r} but the model was built with "
            f"lora_rank={lora_rank}; rebuild with train.lora_rank={r}")
    if alpha is not None and lora_alpha is not None and \
            float(alpha) != float(lora_alpha):
        raise ValueError(
            f"peft adapter lora_alpha={alpha} but the model uses "
            f"lora_alpha={lora_alpha}; set train.lora_alpha={alpha}")


def export_peft_lora(adapter_dir: str, lora_flat, rank: int, alpha: float,
                     base_model: str = DEFAULT_BASE_MODEL):
    """Write LoRA values (JAX flat path names; tensors or numpy arrays, written
    as fp32) as a peft adapter directory loadable by
    ``PeftModel.from_pretrained`` and by the JAX package's
    ``import_peft_lora``."""
    os.makedirs(adapter_dir, exist_ok=True)
    sd = {}
    modules = set()
    for key, val in sorted(lora_flat.items()):
        base, leaf = key.rsplit("/", 1)
        module = _flax_path_to_module(base)
        modules.add(module[len("base_model.model."):])
        ab = "lora_A" if leaf == "lora_a" else "lora_B"
        if isinstance(val, torch.Tensor):
            val = val.detach().to("cpu", torch.float32).numpy()
        sd[f"{module}.{ab}.weight"] = np.ascontiguousarray(np.asarray(val, np.float32).T)
    safetensors_io.save_file(sd, os.path.join(adapter_dir, "adapter_model.safetensors"))
    # minimal adapter_config peft accepts (the reference's LoraConfig)
    target_modules = sorted(
        {re.sub(r"^transformer_blocks\.\d+\.", "", m) for m in modules})
    cfg = {
        "peft_type": "LORA",
        "base_model_name_or_path": base_model,
        "r": int(rank),
        "lora_alpha": float(alpha),
        "target_modules": target_modules,
        "lora_dropout": 0.0,
        "bias": "none",
        "init_lora_weights": "gaussian",
        "task_type": None,
    }
    with open(os.path.join(adapter_dir, "adapter_config.json"), "w") as f:
        json.dump(cfg, f, indent=2)
    return adapter_dir
