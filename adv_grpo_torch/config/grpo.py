"""GRPO presets of the ported paths, from adv_grpo_tpu/config/grpo.py.

Every preset of the JAX package is here (``eval_sd3_fast``,
``smoke_sd3_fast``, ``pickscore_sd3_fast``, ``pickscore_cotrain_sd3_fast``,
the three DINO co-training presets, the ``compressibility`` base they build
on, ``flux_smoke`` and ``wan_smoke``); another name raises ``KeyError``.
Values are identical to the JAX presets (``tests/test_torch_config.py``).
"""

from __future__ import annotations

import os

from adv_grpo_torch.config import base


def compressibility():
    config = base.get_config()
    config.reward_fn = {"jpeg_compressibility": 1}
    config.per_prompt_stat_tracking = True
    return config


def _sd3_fast_common(config, replica_count=8):
    config.dataset = os.path.join(os.getcwd(), "dataset/pickscore")
    config.mixed_precision = "bf16"
    config.wandb_init = True
    config.pretrained.model = "stabilityai/stable-diffusion-3.5-medium"
    config.sample.num_steps = 10
    config.sample.train_num_steps = 2
    config.sample.eval_num_steps = 40
    config.sample.guidance_scale = 4.5
    config.resolution = 512
    config.sample.train_batch_size = 1
    config.sample.num_image_per_prompt = 16
    config.sample.mini_num_image_per_prompt = 8
    config.sample.num_batches_per_epoch = int(
        48 / (replica_count * config.sample.mini_num_image_per_prompt
              / config.sample.num_image_per_prompt))
    config.sample.test_batch_size = 16
    config.sample.random_timestep = 0
    config.train.batch_size = config.sample.mini_num_image_per_prompt
    config.train.gradient_accumulation_steps = config.sample.num_batches_per_epoch // 2
    config.train.num_inner_epochs = 1
    config.train.timestep_fraction = 0.99
    config.train.clip_range = 1e-5
    config.train.beta = 0.0
    config.sample.global_std = True
    config.sample.noise_level = 0.8
    config.train.ema = True
    config.save_freq = 60
    config.eval_freq = 60
    return config


def smoke_sd3_fast(replica_count=1):
    """Explicit random-init smoke preset: tiny model, no reference weights."""
    config = _sd3_fast_common(compressibility(), replica_count)
    config.smoke_test = True
    config.pretrained.model = ""
    config.dataset = os.path.join(os.getcwd(), "dataset/pickscore_small")
    config.wandb_init = False
    config.sample.num_steps = 3
    config.sample.train_num_steps = 2
    config.sample.eval_num_steps = 3
    config.sample.num_image_per_prompt = 4
    config.sample.mini_num_image_per_prompt = 2
    config.sample.num_batches_per_epoch = 2
    config.sample.test_batch_size = 2
    config.sample.random_timestep = None
    config.train.gradient_accumulation_steps = 1
    config.train_d = False
    config.json_path = ""
    config.reward_fn = {"jpeg_compressibility": 1}
    config.eval_reward_fn = {}
    config.save_dir = "logs/smoke"
    config.save_freq = 1000
    config.eval_freq = 1000
    config.case_name = "smoke"
    return config


def pickscore_sd3_fast(replica_count=8):
    """Frozen-reward multi-reward preset (reference config/grpo.py:379-427)."""
    config = _sd3_fast_common(compressibility(), replica_count)
    config.dataset = os.path.join(os.getcwd(), "dataset/ocr")
    config.case_name = "fast_1node_16_8_multireward_11"
    config.sample.random_timestep = None
    config.save_dir = "logs/pickscore/sd3.5-M-fast_multireward"
    config.reward_fn = {"pickscore": 0.5, "ocr": 0.5}
    config.prompt_fn = "general_ocr"
    return config


def pickscore_cotrain_sd3_fast(replica_count=8):
    """Adversarial PickScore co-training (reference config/grpo.py:315-376)."""
    config = _sd3_fast_common(compressibility(), replica_count)
    config.discriminator = "pickscore"
    config.d_times = 20
    config.d_lr = 5e-6
    config.tune_layer = -1
    config.train_d = True
    config.json_path = "data/reference_images/prompt2img_merged_pickscore.json"
    config.reference_image_path = "data/reference_images/qwen_images_pickscore"
    config.case_name = "fast_pickscore_cotrain_lr_5e6_last1_16_8"
    config.save_dir = "logs/pickscore/sd3.5-M-fast_pickscore_cotrain"
    config.reward_fn = {"pickscore_cotrain": 1}
    config.eval_reward_fn = {"pickscore": 1}
    config.prompt_fn = "general_ocr"
    return config


def dino_cotrain_sd3_fast(replica_count=8):
    """DINO CLS-only co-training (reference config/grpo.py:31-99)."""
    config = _sd3_fast_common(compressibility(), replica_count)
    config.discriminator = "dino"
    config.d_times = 10
    config.d_lr = 1e-4
    config.tune_layer = -2
    config.train_d = True
    config.json_path = "data/reference_images/prompt2img_merged_pickscore.json"
    config.reference_image_path = "data/reference_images/qwen_images_pickscore"
    config.test_reference_image_path = "data/reference_images/qwen_images_pickscore_test"
    config.case_name = "fast_dino_cotrain_16_8"
    config.save_dir = "logs/dino/sd3.5-M-fast_dino_cotrain"
    config.reward_fn = {"dino_cotrain": 1}
    config.eval_reward_fn = {"pickscore": 1}
    config.prompt_fn = "general_ocr"
    return config


def dino_cotrain_sd3_patch_fast(replica_count=8):
    """DINO CLS + patch co-training, the paper's headline config (reference
    config/grpo.py:102-174)."""
    config = dino_cotrain_sd3_fast(replica_count)
    config.discriminator = "dino_patch"
    config.case_name = "fast_dino_cotrain_16_8_patch_image_loss_73"
    config.save_dir = "logs/dino/sd3.5-M-fast_dino_patch_cotrain"
    config.reward_fn = {"dino_patch_cotrain": 1}
    config.eval_reward_fn = {"pickscore": 1, "image_similarity": 1}
    config.limit = None
    return config


def dino_cotrain_sd3_multi_fast(replica_count=8):
    """Multi-layer DINO heads + fusion co-training (reference
    config/grpo.py:176-246)."""
    config = _sd3_fast_common(compressibility(), replica_count)
    config.sample.num_image_per_prompt = 8  # k = 1
    config.sample.mini_num_image_per_prompt = 8
    config.sample.num_batches_per_epoch = int(
        48 / (replica_count * config.sample.mini_num_image_per_prompt
              / config.sample.num_image_per_prompt))
    config.train.batch_size = config.sample.mini_num_image_per_prompt
    config.train.gradient_accumulation_steps = config.sample.num_batches_per_epoch // 2
    config.sample.random_timestep = 0
    config.discriminator = "dino_multi"
    config.d_times = 10
    config.d_lr = 1e-4
    config.tune_layer = -1
    config.dino_multi_layer_ids = (11,)
    config.temperature = 2.0
    config.train_d = True
    config.json_path = "data/reference_images/prompt2img_merged_pickscore.json"
    config.reference_image_path = "data/reference_images/qwen_images_pickscore"
    config.test_reference_image_path = "data/reference_images/qwen_images_pickscore_test"
    config.case_name = "fast_dino_cotrain_16_8_multi_image_loss"
    config.save_dir = "logs/dino/sd3.5-M-fast_dino_multi_cotrain"
    config.reward_fn = {"dino_multi_cotrain": 1}
    config.eval_reward_fn = {"pickscore": 1, "image_similarity": 1}
    config.prompt_fn = "general_ocr"
    return config


def flux_smoke():
    """Flux text-to-image preset: the tiny random-init model by default;
    ``FLUX_DIR`` names a diffusers FluxTransformer2DModel directory
    (``<root>/transformer``; the VAE is read from ``<root>/vae``), which
    ``cli.common.build_pipeline`` loads (set ``resolution`` to the model's,
    512 and up)."""
    config = base.get_config()
    config.model_family = "flux"
    config.smoke_test = True
    config.pretrained.model = os.environ.get("FLUX_DIR", "")
    config.resolution = 64  # tiny random-init default; real Flux: 512+
    config.sample.num_steps = 4
    config.sample.eval_num_steps = 4
    config.sample.noise_level = 0.7
    config.sample.guidance_scale = 3.5
    config.wandb_init = False
    config.save_dir = "logs/flux_smoke"
    config.case_name = "flux_smoke"
    config.dataset = os.path.join(os.getcwd(), "dataset/pickscore_small")
    config.prompt_fn = "general_ocr"
    config.sample.train_num_steps = 2
    config.sample.train_batch_size = 1
    config.sample.num_image_per_prompt = 4
    config.sample.mini_num_image_per_prompt = 4
    config.sample.num_batches_per_epoch = 2
    config.train.batch_size = 4
    config.train.gradient_accumulation_steps = 1
    config.reward_fn = {"jpeg_compressibility": 1}
    return config


def wan_smoke():
    """WAN text-to-video preset (the demo's and the trainer's): the tiny
    random-init transformer and 3D causal VAE by default; ``WAN_DIR`` names a
    diffusers WanTransformer3DModel directory (``<root>/transformer``; the
    AutoencoderKLWan is read from ``<root>/vae``), which
    ``cli.common.build_pipeline`` and the demo load."""
    config = base.get_config()
    config.model_family = "wan"
    config.smoke_test = True
    config.pretrained.model = os.environ.get("WAN_DIR", "")
    config.resolution = 32  # tiny default frame size (a multiple of the VAE factor)
    config.sample.num_steps = 4
    config.sample.eval_num_steps = 4
    config.sample.noise_level = 0.7  # WAN's SDE noise is schedule-driven
    config.sample.guidance_scale = 0.0  # the WAN rollout has no CFG batch
    config.sample.kl_reward = 0.0
    # video frames, 1 mod the VAE's temporal factor (latent F' = 1 + (F-1)/tf)
    config.sample.num_frames = 9
    config.wandb_init = False
    config.save_dir = "logs/wan_smoke"
    config.case_name = "wan_smoke"
    config.dataset = os.path.join(os.getcwd(), "dataset/pickscore_small")
    config.prompt_fn = "general_ocr"
    config.sample.train_num_steps = 2
    config.sample.train_batch_size = 1
    config.sample.num_image_per_prompt = 2
    config.sample.mini_num_image_per_prompt = 2
    config.sample.num_batches_per_epoch = 2
    config.train.batch_size = 2
    config.train.gradient_accumulation_steps = 1
    config.reward_fn = {"jpeg_compressibility": 1}
    return config


def eval_sd3_fast(replica_count=8):
    """Deterministic batch-eval preset (reference config/grpo.py:247-312)."""
    config = _sd3_fast_common(compressibility(), replica_count)
    config.sample.noise_level = 0.0
    config.train.lora_path = None
    config.eval_reward_fn = {"pickscore": 1, "image_similarity": 1}
    config.reward_fn = {"pickscore": 1}
    config.prompt_fn = "general_ocr"
    config.save_dir = "logs/eval/sd3.5-M-fast"
    return config


_PRESETS = {
    "compressibility": compressibility,
    "smoke_sd3_fast": smoke_sd3_fast,
    "pickscore_sd3_fast": pickscore_sd3_fast,
    "pickscore_cotrain_sd3_fast": pickscore_cotrain_sd3_fast,
    "dino_cotrain_sd3_fast": dino_cotrain_sd3_fast,
    "dino_cotrain_sd3_patch_fast": dino_cotrain_sd3_patch_fast,
    "dino_cotrain_sd3_multi_fast": dino_cotrain_sd3_multi_fast,
    "eval_sd3_fast": eval_sd3_fast,
    "flux_smoke": flux_smoke,
    "wan_smoke": wan_smoke,
}


def get_config(name: str):
    """Resolve a preset by name; presets of unported paths raise KeyError."""
    if name not in _PRESETS:
        raise KeyError(f"config preset {name!r} is unknown or not yet ported to "
                       f"adv_grpo_torch (ported: {sorted(_PRESETS)})")
    return _PRESETS[name]()
