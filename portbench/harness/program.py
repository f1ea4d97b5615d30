"""What every family's build shares: the port's preset with the workload's
settings (``adv_grpo_torch.cli.common.resolve_config``), the check that the
model the port built is the configuration's, parameter for parameter, the
prompt encoder both sides are given, and the EMA shadow restarted from the
LoRA the benchmark gave."""

from __future__ import annotations

import torch

from portbench.harness.textenc import make_hash_text_encoder


def program_config(workload: dict, seed: int):
    """The preset the workload names, with its settings and the seed."""
    from adv_grpo_torch.cli.common import resolve_config

    config = resolve_config(workload["preset"])
    for key, val in workload.get("set", {}).items():
        node = config
        parts = key.split(".")
        for p in parts[:-1]:
            node = node[p]
        if parts[-1] not in node:
            raise KeyError(f"workload {workload['name']}: the preset has no setting {key!r}")
        node[parts[-1]] = val
    config.seed = int(seed)
    return config


def same_spec(what: str, got, want):
    """``got`` and ``want`` ((name, shape, dtype) lists) name the same
    parameters with the same shapes and dtypes."""
    g = {n: (tuple(s), d) for n, s, d in got}
    w = {n: (tuple(s), d) for n, s, d in want}
    if g != w:
        diff = sorted(set(g.items()) ^ set(w.items()))[:6]
        raise ValueError(f"the program's {what} is not the configuration's: {diff}")


def encoder_of(cfg: dict):
    t = cfg["text_encoders"]
    return make_hash_text_encoder(t["seq_len"], t["embed_dim"], t["pooled_dim"])


@torch.no_grad()
def restart_ema(trainer):
    """The EMA shadow restarts from the LoRA as the benchmark gave it."""
    if trainer.state.ema is not None:
        for k, e in trainer.state.ema.items():
            e.copy_(trainer.state.lora[k])
