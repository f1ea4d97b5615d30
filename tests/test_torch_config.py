"""The port's presets equal the JAX package's, key for key.

The port keeps its presets as plain dictionaries (no ml_collections); the JAX
presets are the reference. Of the JAX ``tpu`` section the port keeps
``remat`` and ``remat_policy`` (the models' activation checkpointing, the
same keys, ``remat`` off where JAX has it on: a recorded departure); its
mesh, dtype, backend and compile options have no counterpart. The SFT / RWR / DPO presets
(``config/sft.py``, ``config/dpo.py``) are found by ``resolve_config`` after
the GRPO ones, and one inner epoch of ``dpo_sd3_fast`` (``beta`` 100: each
microstep replays its window once more with the LoRA off, the KL anchor)
matches the JAX epoch.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adv_grpo_torch.cli.common import compute_dtype, resolve_config
from adv_grpo_torch.config import dpo as t_dpo
from adv_grpo_torch.config import grpo as t_grpo
from adv_grpo_torch.config import sft as t_sft
from adv_grpo_torch.models.lora import freeze_non_lora
from adv_grpo_torch.models.lora import lora_params as t_lora_params
from adv_grpo_torch.rollout import sampler as t_sampler
from adv_grpo_torch.train import grpo_trainer as t_trainer
from adv_grpo_torch.train import train_state as t_state
from adv_grpo_tpu.cli.common import resolve_config as j_resolve_config
from adv_grpo_tpu.config import dpo as j_dpo
from adv_grpo_tpu.config import grpo as j_grpo
from adv_grpo_tpu.config import sft as j_sft
from adv_grpo_tpu.models.lora import lora_params as j_lora_params
from adv_grpo_tpu.rollout import sampler as j_sampler
from adv_grpo_tpu.train import grpo_trainer as j_trainer
from adv_grpo_tpu.train import train_state as j_state
from tests.test_torch_models import jax_tiny_pipeline
from tests.test_torch_train import _port_pipeline, _t, _window_record


def _plain(tree):
    if isinstance(tree, dict):
        return {k: _plain(v) for k, v in tree.items()}
    return tree


def _jax_tree(config):
    """A JAX preset as a dict, its ``tpu`` section cut to the keys the port
    keeps, ``remat`` turned off: the port's one departure there (every
    published size measured on an H100 80GB fits without it)."""
    want = config.to_dict()
    assert want["tpu"]["remat"] is True
    want["tpu"] = {"remat": False, "remat_policy": want["tpu"]["remat_policy"]}
    return want


@pytest.mark.parametrize("preset", ["compressibility", "smoke_sd3_fast", "eval_sd3_fast",
                                    "flux_smoke", "wan_smoke", "pickscore_sd3_fast",
                                    "pickscore_cotrain_sd3_fast",
                                    "dino_cotrain_sd3_fast", "dino_cotrain_sd3_patch_fast",
                                    "dino_cotrain_sd3_multi_fast"])
def test_preset_matches_jax(preset):
    want = _jax_tree(j_grpo.get_config(preset))
    assert _plain(t_grpo.get_config(preset)) == want


def test_unported_preset_raises():
    """Every JAX preset is ported; a name that is none of them raises."""
    with pytest.raises(KeyError, match="not yet ported"):
        resolve_config("no_such_preset")
    assert set(t_grpo._PRESETS) == set(j_grpo._PRESETS)


def test_config_attribute_access_and_dtype():
    config = resolve_config("adv_grpo_tpu/config/grpo.py:eval_sd3_fast")
    assert config.sample.eval_num_steps == 40 and config.resolution == 512
    assert compute_dtype(config).is_floating_point
    config.mixed_precision = "no"
    assert str(compute_dtype(config)) == "torch.float32"
    config.mixed_precision = "int8"
    with pytest.raises(ValueError):
        compute_dtype(config)


@pytest.mark.parametrize("preset", ["sft_sd3_fast", "rwr_sd3_fast", "dpo_sd3_fast"])
def test_sft_rwr_dpo_presets_match_jax(preset):
    want = _jax_tree(j_resolve_config(preset))
    assert _plain(resolve_config(preset)) == want
    assert _plain(resolve_config(f"adv_grpo_tpu/config/x.py:{preset}")) == want
    mod = t_dpo if preset.startswith("dpo") else t_sft
    assert _plain(mod.get_config(preset)) == want


def test_registries_are_searched_grpo_sft_dpo():
    assert set(t_sft._PRESETS) == set(j_sft._PRESETS)
    assert set(t_dpo._PRESETS) == set(j_dpo._PRESETS)
    assert not set(t_grpo._PRESETS) & (set(t_sft._PRESETS) | set(t_dpo._PRESETS))
    assert resolve_config("dpo_sd3_fast").train.beta == 100.0


def test_dpo_epoch_with_its_replay_matches_jax():
    """One inner epoch of ``dpo_sd3_fast``'s train config (beta 100,
    clip_range 1e-4, accumulation cut to 1, the EMA every step) on the tiny
    SD3: 2 minibatches x 2 window steps, each microstep with its LoRA-off
    replay. Old log-probs are the replay moved by ~1e-4 around the clip
    range. Tolerances as tests/test_torch_train.py's epoch (fp32): the
    diagnostics, ``kl_loss`` among them, to 1e-4 relative; the LoRA and EMA
    to 1e-4 relative plus 2e-6 absolute."""
    jpipe = jax_tiny_pipeline(23)
    tpipe = _port_pipeline(jpipe)
    cfg = resolve_config("dpo_sd3_fast").train
    cfg.update(gradient_accumulation_steps=1, ema_interval=1, lora_rank=4, lora_alpha=8.0)
    beta = float(cfg.beta)
    assert beta == 100.0 and cfg.algorithm == "dpo"
    scfg = dict(num_steps=4, train_num_steps=2, noise_level=0.8, guidance_scale=4.5)
    rec, neg_e, neg_p = _window_record(6)
    with torch.no_grad():
        lp0 = torch.stack([torch.stack([t_sampler.compute_log_prob(
            tpipe.velocity_fn(), _t(rec["latents"][i, :, j]), _t(rec["latents"][i, :, j + 1]),
            _t(rec["timesteps"][i, :, j]), _t(rec["sigmas"][i, :, j]),
            _t(rec["sigmas_prev"][i, :, j]), _t(rec["embeds"][i]), _t(rec["pooled"][i]),
            _t(neg_e), _t(neg_p), t_sampler.SamplerConfig(**scfg))[0]
            for j in range(2)], dim=1) for i in range(2)])
    rng = np.random.default_rng(8)
    rec["log_probs"] = (lp0.numpy() + rng.standard_normal(lp0.shape) * 1e-4).astype(np.float32)

    jlora0 = j_lora_params(jpipe.transformer_params["params"])
    jst = j_state.create_generator_state(jlora0, cfg, 2)
    jfn = j_trainer.make_train_epoch_fn(jpipe, j_sampler.SamplerConfig(**scfg), cfg, beta=beta)
    jst, jinfo = jfn(jst, jpipe.transformer_params, {k: jnp.asarray(v) for k, v in rec.items()},
                     jnp.asarray(neg_e), jnp.asarray(neg_p))

    tst = t_state.create_generator_state(freeze_non_lora(tpipe.mmdit), cfg, 2)
    calls = []
    velocity_fn = tpipe.velocity_fn

    def recording(*a, **k):
        calls.append(k.get("lora_scale", 1.0))
        return velocity_fn(*a, **k)

    tpipe.velocity_fn = recording
    tfn = t_trainer.make_train_epoch_fn(tpipe, t_sampler.SamplerConfig(**scfg), cfg, beta=beta)
    tst, tinfo = tfn(tst, {k: _t(v) for k, v in rec.items()}, _t(neg_e), _t(neg_p))

    assert calls == [1.0, 0.0] * 4  # each microstep: the policy, then its LoRA-off replay
    assert tst.global_step == int(jst.global_step) == 2
    assert tinfo["kl_loss"] > 0 and np.isfinite(tinfo["loss"])
    for k in t_trainer.INFO_KEYS:
        np.testing.assert_allclose(tinfo[k], float(jinfo[k]), rtol=1e-4, atol=1e-9, err_msg=k)
    for k, p in t_lora_params(tpipe.mmdit).items():
        want = np.asarray(jst.lora[k])
        assert not np.array_equal(want, np.asarray(jlora0[k])), k
        np.testing.assert_allclose(p.detach().numpy(), want, rtol=1e-4, atol=2e-6, err_msg=k)
        np.testing.assert_allclose(tst.ema[k].numpy(), np.asarray(jst.ema.params[k]),
                                   rtol=1e-4, atol=2e-6, err_msg=k)
