"""Base configuration defaults, as plain dictionaries.

The same schema and defaults as adv_grpo_tpu/config/base.py, of whose ``tpu``
section only ``remat`` and ``remat_policy`` are kept (the per-block
activation checkpointing, ``models/remat.py``; the mesh, dtype, backend and
compile options have no meaning here), held in :class:`ConfigDict` — a
``dict`` with attribute access — so the port does not depend on
``ml_collections``. ``tests/test_torch_config.py`` holds the two trees equal,
key for key, but for ``tpu.remat``: off here, on in JAX.
"""

from __future__ import annotations


class ConfigDict(dict):
    """A dict whose keys are also attributes (``config.sample.num_steps``)."""

    def __getattr__(self, key):
        try:
            return self[key]
        except KeyError as e:
            raise AttributeError(key) from e

    def __setattr__(self, key, value):
        self[key] = value


def get_config() -> ConfigDict:
    config = ConfigDict()

    config.run_name = ""
    config.seed = 42
    config.logdir = "logs"
    config.save_freq = 20
    config.eval_freq = 20
    config.num_checkpoint_limit = 5
    config.mixed_precision = "fp16"
    config.use_lora = True
    config.dataset = ""
    config.text_embeds_dir = ""  # precomputed text-embedding store dir
    config.resolution = 768
    config.wandb_init = False

    config.pretrained = ConfigDict()
    config.pretrained.model = ""  # local dir with HF safetensors (no hub egress)
    config.pretrained.revision = "main"

    config.sample = sample = ConfigDict()
    sample.num_steps = 40
    sample.eval_num_steps = 40
    sample.guidance_scale = 4.5
    sample.train_batch_size = 1
    sample.num_image_per_prompt = 1
    sample.mini_num_image_per_prompt = 1
    sample.test_batch_size = 1
    sample.num_batches_per_epoch = 2
    sample.global_std = True
    sample.noise_level = 0.7
    sample.same_latent = False
    sample.train_num_steps = 2
    sample.random_timestep = None

    config.train = train = ConfigDict()
    train.batch_size = 1
    train.learning_rate = 3e-4
    train.adam_beta1 = 0.9
    train.adam_beta2 = 0.999
    train.adam_weight_decay = 1e-4
    train.adam_epsilon = 1e-8
    train.gradient_accumulation_steps = 1
    train.micro_splits = 1
    train.cfg_sequential = False
    train.max_grad_norm = 1.0
    train.num_inner_epochs = 1
    train.cfg = True
    train.adv_clip_max = 5
    train.clip_range = 1e-4
    train.timestep_fraction = 1.0
    train.beta = 0.0
    train.lora_path = None
    train.ema = False
    train.algorithm = "grpo"  # grpo | rwr | sft | dpo
    train.lora_rank = 32
    train.lora_alpha = 64.0
    train.ema_decay = 0.9
    train.ema_interval = 8

    config.prompt_fn = "imagenet_animals"
    config.prompt_fn_kwargs = {}
    config.reward_fn = ConfigDict()
    config.eval_reward_fn = ConfigDict()
    config.save_dir = ""
    config.per_prompt_stat_tracking = True

    # adversarial reward co-training
    config.discriminator = ""  # "pickscore" | "dino" | "dino_patch" | "dino_multi"
    config.d_times = 10
    config.d_lr = 1e-4
    config.tune_layer = -1
    config.dino_multi_layer_ids = None
    config.temperature = 0.2
    config.train_d = False
    config.weight_path = None
    config.limit = None
    config.json_path = ""
    config.reference_image_path = ""
    config.test_reference_image_path = ""
    config.external_image_path = ""  # distribution-transfer entry (cli.infer --image)
    config.case_name = ""
    config.max_global_step = 1000

    # smoke mode: tiny random-init models end-to-end (CI / dry runs)
    config.smoke_test = False

    # the JAX section's activation checkpointing, under the JAX keys. remat
    # is off here (on in JAX): every published size measured on an H100 80GB
    # fits without it, and its recompute slows each microstep. Both ported
    # policies ("save_attn", the JAX default, and "full") recompute the whole
    # block
    config.tpu = tpu = ConfigDict()
    tpu.remat = False
    tpu.remat_policy = "save_attn"
    return config
