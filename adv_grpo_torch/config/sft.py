"""SFT- and RWR-advantage presets, from adv_grpo_tpu/config/sft.py.

The reference's dedicated SFT trainer no longer exists; its semantics survive
through the stat tracker's 'sft' advantage type (one-hot argmax per group)
and 'rwr', which the trainer takes through ``train.algorithm``.
"""

from __future__ import annotations

from adv_grpo_torch.config import grpo


def sft_sd3_fast(replica_count=8):
    config = grpo.pickscore_sd3_fast(replica_count)
    config.train.algorithm = "sft"
    config.train.clip_range = 1e-4
    config.case_name = "sft_sd3_fast"
    config.save_dir = "logs/sft/sd3.5-M-fast"
    return config


def rwr_sd3_fast(replica_count=8):
    config = grpo.pickscore_sd3_fast(replica_count)
    config.train.algorithm = "rwr"
    config.case_name = "rwr_sd3_fast"
    config.save_dir = "logs/rwr/sd3.5-M-fast"
    return config


_PRESETS = {"sft_sd3_fast": sft_sd3_fast, "rwr_sd3_fast": rwr_sd3_fast}


def get_config(name: str):
    return _PRESETS[name]()
