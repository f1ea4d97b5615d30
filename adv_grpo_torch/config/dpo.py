"""DPO-advantage preset, from adv_grpo_tpu/config/dpo.py.

The reference's DPO trainer is gone, but its per-group +1 / -1 best / worst
advantage survives in the stat tracker ('dpo'); ``train.beta`` is the KL
anchor to the LoRA-off policy that the DPO-style objective relies on (each
microstep replays the window once more with the LoRA off).
"""

from __future__ import annotations

from adv_grpo_torch.config import grpo


def dpo_sd3_fast(replica_count=8):
    config = grpo.pickscore_sd3_fast(replica_count)
    config.train.algorithm = "dpo"
    config.train.beta = 100.0
    config.train.clip_range = 1e-4
    config.case_name = "dpo_sd3_fast"
    config.save_dir = "logs/dpo/sd3.5-M-fast"
    return config


_PRESETS = {"dpo_sd3_fast": dpo_sd3_fast}


def get_config(name: str):
    return _PRESETS[name]()
