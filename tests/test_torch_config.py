"""The port's presets equal the JAX package's, key for key.

The port keeps its presets as plain dictionaries (no ml_collections); the JAX
presets are the reference. Only the JAX ``tpu`` section (mesh, remat and
compile options) has no counterpart.
"""

import pytest

from adv_grpo_torch.cli.common import compute_dtype, resolve_config
from adv_grpo_torch.config import grpo as t_grpo
from adv_grpo_tpu.config import grpo as j_grpo


def _plain(tree):
    if isinstance(tree, dict):
        return {k: _plain(v) for k, v in tree.items()}
    return tree


@pytest.mark.parametrize("preset", ["compressibility", "smoke_sd3_fast", "eval_sd3_fast",
                                    "flux_smoke", "wan_smoke", "pickscore_sd3_fast",
                                    "pickscore_cotrain_sd3_fast",
                                    "dino_cotrain_sd3_fast", "dino_cotrain_sd3_patch_fast",
                                    "dino_cotrain_sd3_multi_fast"])
def test_preset_matches_jax(preset):
    want = j_grpo.get_config(preset).to_dict()
    want.pop("tpu")
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
