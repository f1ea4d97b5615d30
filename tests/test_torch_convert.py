"""Weight carry-over and diffusers names of the port's state dicts.

``adv_grpo_torch.models.convert.mmdit_state_dict_from_jax`` is the inverse of
the JAX package's diffusers -> Flax ``convert_mmdit``: feeding the port's state
dict (as numpy) back through ``convert_mmdit`` must reproduce the JAX tree leaf
for leaf, and ``convert_mmdit``'s own ``assert_consumed`` rejects any stray or
misnamed key. The port's module must load that state dict strictly, so its
parameter names are the diffusers ones.
"""

import numpy as np
import pytest
import torch
from flax import traverse_util

from adv_grpo_torch.models.convert import (
    mmdit_state_dict_from_jax, vae_state_dict_from_jax)
from adv_grpo_torch.models.mmdit import MMDiT as TMMDiT
from adv_grpo_torch.models.mmdit import MMDiTConfig as TMMDiTConfig
from adv_grpo_torch.models.vae import AutoencoderKL as TAutoencoderKL
from adv_grpo_torch.models.vae import VAEConfig as TVAEConfig
from adv_grpo_tpu.models.convert import convert_mmdit
from adv_grpo_tpu.models.mmdit import MMDiTConfig
from tests.test_torch_models import jax_tiny_pipeline


@pytest.fixture(scope="module")
def jax_params():
    pipe = jax_tiny_pipeline(3, lora_rank=0)
    return pipe.transformer_params["params"], pipe.vae_params["params"]


def test_mmdit_round_trip_through_convert_mmdit(jax_params):
    params, _ = jax_params
    cfg = MMDiTConfig.tiny(lora_rank=0)
    sd = mmdit_state_dict_from_jax(params, TMMDiTConfig.tiny(lora_rank=0))
    back = convert_mmdit({k: v.numpy() for k, v in sd.items()}, cfg)
    want = traverse_util.flatten_dict(params)
    got = traverse_util.flatten_dict(back)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]),
                                      err_msg="/".join(k))


@pytest.mark.parametrize("lora_rank", [0, 4])
def test_mmdit_state_dict_names_load_strictly(lora_rank):
    pipe = jax_tiny_pipeline(4, lora_rank=lora_rank)
    tcfg = TMMDiTConfig.tiny(lora_rank=lora_rank, lora_alpha=8.0)
    sd = mmdit_state_dict_from_jax(pipe.transformer_params, tcfg)
    model = TMMDiT(tcfg, device="cpu")
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd)  # strict
    assert "pos_embed.proj.weight" in sd and sd["pos_embed.proj.weight"].shape == (128, 16, 2, 2)
    assert "transformer_blocks.0.ff.net.0.proj.weight" in sd
    assert "transformer_blocks.3.attn.to_add_out.weight" not in sd  # context_pre_only
    assert ("transformer_blocks.0.attn.to_q.lora_a" in sd) == (lora_rank > 0)


def test_vae_state_dict_names_load_strictly(jax_params):
    _, vparams = jax_params
    cfg = TVAEConfig.tiny(latent_channels=16)
    sd = vae_state_dict_from_jax(vparams, cfg)
    model = TAutoencoderKL(cfg, device="cpu")
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd)
    # HWIO -> OIHW
    np.testing.assert_array_equal(
        sd["decoder.conv_in.weight"].numpy(),
        np.asarray(vparams["decoder"]["conv_in"]["kernel"]).transpose(3, 2, 0, 1))
    assert sd["decoder.up_blocks.0.upsamplers.0.conv.weight"].dtype == torch.float32
