"""Checkpoints: the whole generator state, the discriminator's, and the
LoRA adapter alone in the reference's peft layout.

Port of adv_grpo_tpu/train/checkpoint.py, with the JAX package's directory
layout and its own file format in place of orbax (which needs JAX):

  {save_dir}/checkpoints/checkpoint-{global_step}/
      state.pt   the GeneratorState (train/train_state.py): LoRA, the
                 accumulator, Adam's mu / nu and count, the EMA shadow,
                 global_step and micro_step; ``torch.save`` of plain dicts
                 of tensors and ints, read with ``weights_only=True``
      extra.pt   the discriminator's state when one is trained: its
                 module's and its optimizer's ``state_dict``
      lora/      a peft adapter directory (the EMA weights when there is an
                 EMA), which ``PeftModel.from_pretrained`` and the JAX
                 package's ``load_lora_only`` read

A checkpoint is resumable (``restore_state``), as the JAX package's is; the
reference itself saves only the adapter. Across the packages the adapter
travels both ways as a peft directory; the JAX package's own ``lora/`` is an
orbax tree, which this module refuses, naming the way across (the JAX
``export_peft_lora``). :func:`generator_state_from_jax` carries a JAX
``save_state`` payload, read as numpy, into a port ``GeneratorState``.
"""

from __future__ import annotations

import os
import shutil
from typing import Optional

import numpy as np
import torch

from adv_grpo_torch.models import peft_lora

STATE_FILE, EXTRA_FILE, LORA_DIR = "state.pt", "extra.pt", "lora"
_GROUPS = ("lora", "acc", "mu", "nu", "ema")
_COUNTERS = ("count", "global_step", "micro_step")


def checkpoint_dir(save_dir: str, global_step: int) -> str:
    return os.path.join(save_dir, "checkpoints", f"checkpoint-{global_step}")


def _save(obj, path: str) -> None:
    """``torch.save`` through a temporary name, so a crash mid-write leaves
    no partial file under the final one."""
    torch.save(obj, path + ".tmp")
    os.replace(path + ".tmp", path)


def save_state(save_dir: str, global_step: int, state, extra: Optional[dict] = None) -> str:
    """Full-state save (resume-capable); returns the checkpoint directory."""
    path = os.path.abspath(checkpoint_dir(save_dir, global_step))
    os.makedirs(path, exist_ok=True)
    payload = {"lora": {k: p.detach() for k, p in state.lora.items()},
               "acc": dict(state.acc), "mu": dict(state.mu), "nu": dict(state.nu),
               "ema": None if state.ema is None else dict(state.ema)}
    payload.update({c: int(getattr(state, c)) for c in _COUNTERS})
    _save(payload, os.path.join(path, STATE_FILE))
    if extra:
        # a file of its own: the generator state restores alike whether or
        # not a D-state rides along
        _save(extra, os.path.join(path, EXTRA_FILE))
    return path


@torch.no_grad()
def copy_into(dst: dict, src: dict, what: str) -> None:
    """Copy ``src`` (LoRA path -> tensor or array) into the tensors of
    ``dst`` in place, once every name and shape is checked (``what`` names
    the source in the error)."""
    if set(dst) != set(src):
        raise ValueError(
            f"{what} does not match this model's LoRA tree (missing "
            f"{sorted(set(dst) - set(src))[:3]}..., unexpected "
            f"{sorted(set(src) - set(dst))[:3]}...) — check lora_rank / target modules")
    src = {k: torch.as_tensor(v) for k, v in src.items()}
    for k, t in dst.items():
        if tuple(src[k].shape) != tuple(t.shape):
            raise ValueError(f"LoRA leaf {k}: {what} shape {tuple(src[k].shape)} != model "
                             f"{tuple(t.shape)} (different lora_rank?)")
    for k, t in dst.items():
        t.copy_(src[k])


def restore_state(path: str, state):
    """Restore a checkpoint into ``state`` in place: the LoRA values into the
    model's own parameters, the optimizer moments, the accumulator and the
    EMA into their tensors, and the counters. Returns ``state``."""
    device = next(iter(state.lora.values())).device
    payload = torch.load(os.path.join(path, STATE_FILE), map_location=device,
                         weights_only=True)
    if (payload["ema"] is None) != (state.ema is None):
        raise ValueError(f"checkpoint at {path} and the trainer disagree on the EMA "
                         f"(checkpoint {payload['ema'] is not None}, trainer "
                         f"{state.ema is not None}): set train.ema as the run that saved it")
    for name in _GROUPS:
        if getattr(state, name) is not None:
            copy_into(getattr(state, name), payload[name], f"checkpoint {name} at {path}")
    for c in _COUNTERS:
        setattr(state, c, int(payload[c]))
    return state


def restore_extra(path: str) -> Optional[dict]:
    """The discriminator's state (or any ``extra``) of a checkpoint written
    with ``save_state(extra=...)``, on the CPU (``load_state_dict`` moves it
    to the module's device); None when the checkpoint has none (e.g. a run
    without a discriminator)."""
    extra_path = os.path.join(os.path.abspath(path), EXTRA_FILE)
    if not os.path.isfile(extra_path):
        return None
    return torch.load(extra_path, map_location="cpu", weights_only=True)


def refuse_msgpack(path: str) -> None:
    """The discriminator's warm start takes a checkpoint directory; a flax
    ``.msgpack`` (what the JAX ``cli/finetune_pickscore.py`` writes) raises."""
    if str(path).endswith(".msgpack"):
        raise NotImplementedError(
            f"weight_path={path!r}: a flax .msgpack from cli/finetune_pickscore.py is not "
            "readable here; porting that CLI (ROADMAP Queue 1, \"Eval and tooling\") brings "
            "it. A checkpoint directory of this package works")


def save_lora_only(save_dir: str, global_step: int, lora_flat: dict,
                   use_ema_weights: Optional[dict] = None, *, rank: int, alpha: float,
                   base_model: Optional[str] = None) -> str:
    """The reference's adapter-only save (checkpoint-{step}/lora) as a peft
    directory; writes the EMA weights when given. ``base_model`` names the
    model in ``adapter_config.json`` (SD3.5-M when empty)."""
    path = os.path.abspath(os.path.join(checkpoint_dir(save_dir, global_step), LORA_DIR))
    weights = use_ema_weights if use_ema_weights is not None else lora_flat
    return peft_lora.export_peft_lora(path, weights, rank, alpha,
                                      base_model=base_model or peft_lora.DEFAULT_BASE_MODEL)


def load_lora_only(path: str, expect_rank=None, expect_alpha=None) -> dict:
    """Load an adapter-only checkpoint: a peft adapter directory
    (``adapter_config.json`` + ``adapter_model.safetensors``, the format the
    reference publishes and :func:`save_lora_only` writes).
    ``expect_rank`` / ``expect_alpha`` validate it against the model it will
    be merged into. Anything else raises, the JAX package's orbax ``lora/``
    trees included."""
    if not os.path.exists(os.path.join(path, "adapter_model.safetensors")):
        if not os.path.isdir(path):
            raise FileNotFoundError(f"no LoRA adapter directory at {path}")
        raise ValueError(
            f"{path} holds no adapter_model.safetensors: not a peft adapter directory. An "
            "orbax LoRA tree (the JAX package's checkpoint-N/lora) cannot be read "
            "without JAX; convert it there with adv_grpo_tpu.models.peft_lora."
            "export_peft_lora(out_dir, adv_grpo_tpu.train.checkpoint.load_lora_only(path), "
            "rank, alpha) and pass out_dir")
    flat, cfg = peft_lora.import_peft_lora(path)
    if expect_rank is not None or expect_alpha is not None:
        peft_lora.validate_against_model(cfg, expect_rank, expect_alpha)
    return flat


def latest_checkpoint(save_dir: str) -> Optional[str]:
    """Newest checkpoint-{step} dir under save_dir/checkpoints, or None."""
    root = os.path.join(save_dir, "checkpoints")
    if not os.path.isdir(root):
        return None
    ckpts = sorted(
        (d for d in os.listdir(root) if d.startswith("checkpoint-")),
        key=lambda d: int(d.split("-")[1]),
    )
    return os.path.join(root, ckpts[-1]) if ckpts else None


def prune_checkpoints(save_dir: str, keep: int):
    """Keep the newest ``keep`` checkpoints (reference num_checkpoint_limit)."""
    root = os.path.join(save_dir, "checkpoints")
    if not os.path.isdir(root):
        return
    ckpts = sorted(
        (d for d in os.listdir(root) if d.startswith("checkpoint-")),
        key=lambda d: int(d.split("-")[1]),
    )
    for d in ckpts[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(root, d), ignore_errors=True)


def _find(tree, key):
    """The first node of ``tree`` (dicts, lists, tuples, named tuples: an
    optax state as it is, or as orbax restores it without a template) that
    has an entry ``key``, as a dict; None when there is none."""
    if hasattr(tree, "_asdict"):
        tree = tree._asdict()
    if isinstance(tree, dict):
        if key in tree:
            return tree
        children = tree.values()
    elif isinstance(tree, (list, tuple)):
        children = tree
    else:
        return None
    for child in children:
        found = _find(child, key)
        if found is not None:
            return found
    return None


def generator_state_from_jax(payload: dict, state):
    """Write a JAX ``save_state`` payload, as numpy (``{"lora", "opt_state",
    "ema", "global_step", "micro_step"}``), into the port ``GeneratorState``
    ``state`` in place and return it. From the optax state: Adam's ``mu``,
    ``nu`` and ``count`` (``ScaleByAdamState``) and, when the JAX optimizer
    accumulates (``optax.MultiSteps``), its ``acc_grads`` (else the port's
    accumulator is zero, as it is after every optimizer step) — its
    ``mini_step`` must be the port's position in the window, ``micro_step``
    modulo ``state.accum_steps``."""
    adam = _find(payload["opt_state"], "mu")
    if adam is None or "nu" not in adam:
        raise ValueError("the JAX opt_state holds no Adam state (mu, nu, count)")
    multi = _find(payload["opt_state"], "acc_grads")
    micro = int(np.asarray(payload["micro_step"]))
    if multi is not None and int(np.asarray(multi["mini_step"])) != micro % state.accum_steps:
        raise ValueError(f"the JAX MultiSteps mini_step {int(np.asarray(multi['mini_step']))} "
                         f"is not micro_step {micro} modulo the port's accumulation "
                         f"{state.accum_steps}")
    ema = payload.get("ema")
    if hasattr(ema, "_asdict"):  # an EMAState
        ema = ema._asdict()["params"]
    if (ema is None) != (state.ema is None):
        raise ValueError("the JAX payload and the port state disagree on the EMA")

    def arrays(tree):
        return {k: np.array(v, np.float32) for k, v in tree.items()}

    copy_into(state.lora, arrays(payload["lora"]), "the JAX lora")
    copy_into(state.mu, arrays(adam["mu"]), "the JAX Adam mu")
    copy_into(state.nu, arrays(adam["nu"]), "the JAX Adam nu")
    acc = (arrays(multi["acc_grads"]) if multi is not None
           else {k: np.zeros(tuple(t.shape), np.float32) for k, t in state.acc.items()})
    copy_into(state.acc, acc, "the JAX MultiSteps accumulator")
    if ema is not None:
        copy_into(state.ema, arrays(ema), "the JAX EMA")
    state.count = int(np.asarray(adam["count"]))
    state.global_step = int(np.asarray(payload["global_step"]))
    state.micro_step = micro
    return state
