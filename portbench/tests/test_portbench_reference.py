"""The reference at the CPU size agrees with the port's CPU path: a whole
run of each cell's path at the tiny configuration comes out correct with
limits near fp32 rounding, and the reference's modules match the port's
on the same weights."""

from __future__ import annotations

import json
import os

import torch

from portbench.harness.weights import load_into, make_weights
from portbench.reference import clip as ref_clip
from portbench.reference import sd3 as ref_sd3
from portbench.tests.conftest import HERE


def _tiny_cfg():
    with open(os.path.join(HERE, "tiny", "configs", "sd3-tiny.json")) as f:
        return json.load(f)


def test_tiny_grpo_cell_is_correct(tiny_root):
    from portbench import run

    result, checks = run.run_cell("tiny-grpo", 2 ** 31 + 5, 0.0, False, device="cpu",
                                  root=tiny_root)
    assert result["correct"], checks
    assert checks["grad_gap"][0] < 1e-4 and checks["rollout_rel"][0] < 1e-5


def test_tiny_wan_cell_is_correct(tiny_root):
    from portbench import run

    result, checks = run.run_cell("tiny-wan", 2 ** 33 + 1, 0.0, False, device="cpu",
                                  root=tiny_root)
    assert result["correct"], checks
    assert checks["decode_rel"][0] < 1e-6 and checks["reward_gap"][0] == 0.0


def test_tiny_sample_cell_is_correct(tiny_root):
    from portbench import run

    result, checks = run.run_cell("tiny-sample", 3, 0.0, False, device="cpu", root=tiny_root)
    assert result["correct"], checks


def test_mmdit_reference_matches_the_port_with_lora():
    from adv_grpo_torch.models.mmdit import MMDiT, MMDiTConfig

    cfg = _tiny_cfg()
    mcfg = MMDiTConfig.tiny(num_layers=2, dual_attention_layers=(0,), lora_rank=32)
    model = MMDiT(mcfg, device="cpu")
    w = make_weights(ref_sd3.transformer_spec(cfg), "diffusion", 1, "transformer", "cpu")
    g = torch.Generator().manual_seed(0)
    for k in w:  # a LoRA B that is not zero, so the adapters count
        if k.endswith("lora_b"):
            w[k] = torch.randn(w[k].shape, generator=g) * 0.05
    load_into(model, w)
    x = torch.randn(2, 16, 8, 8, generator=g)
    t = torch.tensor([900.0, 10.0])
    txt, pooled = torch.randn(2, 6, 64, generator=g), torch.randn(2, 48, generator=g)
    with torch.no_grad():
        want = model(x, t, txt, pooled)
        got = ref_sd3.MMDiT(cfg, w).forward(x, t, txt, pooled, ref_sd3.lora_factors(w))
    assert (got - want).norm() / want.norm() < 1e-5


def test_pickscore_reference_matches_the_port():
    from adv_grpo_torch.models.clip_text import CLIPTextConfig
    from adv_grpo_torch.models.vit import ViTConfig
    from adv_grpo_torch.rewards.scorers import PickScoreScorer

    rm = _tiny_cfg()["reward_model"]
    scorer = PickScoreScorer.random_init(torch.Generator().manual_seed(0), "cpu",
                                         CLIPTextConfig.tiny(projection_dim=16),
                                         ViTConfig.tiny(projection_dim=16), 28)
    w = make_weights(ref_clip.spec(rm["text"], rm["vision"]), "clip", 4, "pickscore", "cpu")
    load_into(scorer.clip, w)
    images = torch.rand(3, 3, 40, 40) * 2 - 1
    ids = torch.randint(0, 64, (3, 16))
    ids[:, 5] = 63
    want = scorer.score(images, ids)
    got = ref_clip.PickScore(rm["text"], rm["vision"], w).score(images, ids)
    assert (got - want).abs().max() < 1e-5


def test_control_precision_rounds_to_fp8():
    from portbench.reference import CONTROL, FP32

    x = torch.linspace(-3, 3, 101)
    assert torch.equal(FP32.operand(x), x)
    q = CONTROL.operand(x)
    assert 0 < (q - x).abs().max() < 3 / 8  # e4m3 keeps 3 mantissa bits
