"""The comparison fails what it must: the control (the reference one
precision down, in the program's place) comes out not correct, and so does
a run whose timed path is broken underneath (``portbench.faults``), once for
each fault the cells can have. The CPU-sized cells stand in for the card's
(the look for a card is skipped); the same readings at the cells' own sizes
are ``python3 -m portbench.control`` and ``python3 -m portbench.faults`` on
the card."""

from __future__ import annotations

import pytest

from portbench import faults


def _limits(root, name):
    from portbench.harness.registry import Registry

    return Registry(root).workload(name)["check"]["limits"]


@pytest.mark.parametrize("cell", ["tiny-grpo", "tiny-sample", "tiny-wan"])
def test_the_control_is_not_correct(tiny_root, cell):
    from portbench.control import readings

    out = readings(cell, 11, True, device="cpu", root=tiny_root)
    limits = _limits(tiny_root, cell)
    assert all(out["program"][k] <= v for k, v in limits.items()), out
    assert any(out["control"][k] > v for k, v in limits.items()), out
    assert out["program_correct"] and not out["control_correct"], out


def _run(root, cell):
    from portbench import run

    result, checks = run.run_cell(cell, 5, 0.0, False, device="cpu", root=root)
    return result["correct"], checks


@pytest.mark.parametrize("cell,fault,number", [
    ("tiny-grpo", "state_unchanged", "update_gap"),
    ("tiny-wan", "state_unchanged", "update_gap"),
    ("tiny-grpo", "half_batch", "grad_gap"),
    ("tiny-wan", "half_batch", "grad_gap"),
    ("tiny-wan-2b", "half_batch", "grad_gap"),
    ("tiny-grpo", "image_altered", "decode_rel"),
    ("tiny-sample", "image_altered", "decode_rel"),
    ("tiny-wan", "image_altered", "decode_rel"),
    ("tiny-grpo", "reward_altered", "reward_gap"),
    ("tiny-grpo", "velocity_altered", "rollout_rel"),
    ("tiny-sample", "velocity_altered", "latents_rel"),
    ("tiny-wan", "velocity_altered", "rollout_rel"),
])
def test_a_fault_is_not_correct(tiny_root, cell, fault, number):
    with faults.FAULTS[fault]():
        ok, checks = _run(tiny_root, cell)
    assert not ok and checks[number][0] > checks[number][1], checks


def test_the_faults_are_undone():
    from adv_grpo_torch.train import driver, grpo_trainer

    def patched():
        return (grpo_trainer.apply_microbatch_grads, driver.rebatch_for_training,
                driver.GRPOTrainer.train_phase)

    before = patched()
    for f in faults.FAULTS.values():
        with f():
            pass
    assert patched() == before
