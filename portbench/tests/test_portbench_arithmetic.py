"""The frozen FLOP and bound arithmetic agrees with hand counts at small
shapes, and with the port's own ``utils/flops.py`` it was copied from; the
reference's GRPO advantages agree with the port's where a group all but
ties."""

from __future__ import annotations

import json
import os

import numpy as np
import pytest

from portbench.harness import work
from portbench.tests.conftest import BENCH

TINY = dict(num_attention_heads=2, attention_head_dim=4, num_layers=1, dual_attention_layers=[0],
            joint_attention_dim=3, in_channels=2, patch_size=2)


def test_mmdit_flops_by_hand():
    # D = 8, one dual layer, 4 image and 2 text tokens, batch 3
    D, s_img, s_txt = 8, 4, 2
    per_layer = 2 * 12 * D * D * 6 + 4 * 36 * D
    dual = 2 * 4 * D * D * 4 + 4 * 16 * D
    embed = 2 * (2 * 3 * D + 4 * 2 * 4 * D)
    assert work.mmdit_forward_flops(TINY, s_img, s_txt, 3) == 3 * (per_layer + dual + embed)


@pytest.mark.parametrize("s_img,s_txt,batch", [(1024, 154, 16), (64, 6, 2), (4096, 77, 1)])
def test_mmdit_flops_equal_the_ports(s_img, s_txt, batch):
    from adv_grpo_torch.models.mmdit import MMDiTConfig
    from adv_grpo_torch.utils.flops import mmdit_forward_flops

    with open(os.path.join(BENCH, "configs", "sd3.5-medium.json")) as f:
        cfg = json.load(f)
    assert work.mmdit_forward_flops(cfg, s_img, s_txt, batch) == pytest.approx(
        mmdit_forward_flops(MMDiTConfig.sd35_medium(), s_img, s_txt, batch), rel=1e-12)


def test_attention_bound_by_hand():
    # one forward call, B=1, H=2, S=128, d=64: 2 products of 2*S*S*d per head
    flops = 2 * 2 * 1 * 2 * 128 * 128 * 64
    nbytes = 4 * 1 * 2 * 128 * 64 * 2
    want = max(flops / 989e12, nbytes / 3.35e12)
    assert work.attention_min_s([(1, 1, 2, 128, 128, 64, 2)]) == pytest.approx(want)
    # a backward: 5 products, 8 tensors; the count multiplies
    flops_b = 2 * 5 * 1 * 2 * 128 * 128 * 64
    nbytes_b = 8 * 1 * 2 * 128 * 64 * 2
    want_b = 3 * max(flops_b / 989e12, nbytes_b / 3.35e12)
    assert work.attention_min_s([(3, 1, 2, 128, 128, 64, 5)]) == pytest.approx(want_b)


def test_sd3_attention_calls():
    cfg = dict(TINY, num_layers=3, dual_attention_layers=[0, 1])
    fwd = work.sd3_attention_calls(cfg, 16, 6, 4, False)
    bwd = work.sd3_attention_calls(cfg, 16, 6, 4, True)
    assert fwd == [(3, 4, 2, 22, 22, 4, 2), (2, 4, 2, 16, 16, 4, 2)]
    # layer 0's image self-attention takes the patch embedding, which has no gradient
    assert bwd == [(3, 4, 2, 22, 22, 4, 5), (1, 4, 2, 16, 16, 4, 5)]


def test_peaks_are_the_data_sheets():
    assert work.PEAK_FLOPS["bfloat16"] == 989e12 and work.HBM_BYTES_PER_S == 3.35e12


def test_the_advantages_of_a_near_tie_follow_float32_rewards():
    """Where a group's rewards all but tie, its advantages are small and
    follow the rewards' last bits. The reference takes its rewards as
    float32, as the trainer holds them, and agrees with the port's tracker
    there; from the float64 rewards it would part from it by rounding."""
    from adv_grpo_torch.core.stat_tracking import PerPromptStatTracker
    from portbench.reference.grpo import advantages

    r = np.array([-0.4012345678, -0.4012345678 + 3e-7, -0.2, -0.3])
    ids = np.array([0, 0, 1, 1])
    port = PerPromptStatTracker(global_std=True).update(ids, np.asarray(r, np.float32))
    port = port.astype(np.float32)
    tie = ids == 0
    rel = np.abs(advantages(r, ids, True) - port)[tie] / np.abs(port[tie])
    assert rel.max() < 1e-6
    r64 = (r[tie] - r[tie].mean()) / (np.std(r) + 1e-4)
    assert (np.abs(r64 - port[tie]) / np.abs(port[tie])).max() > 1e-3
