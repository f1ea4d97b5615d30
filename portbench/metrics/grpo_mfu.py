"""Transformer FLOPs of the window's untraced epochs (rollout forwards, each
training forward and backward at 3 forwards) over their seconds, against the
bf16 dense peak."""

from portbench.harness import readers

NAME = "grpo_mfu"
UNIT = "%"
LAYER = "model step"
MOVES = "grpo_samples_per_s"
SOURCE = "host_clock"
BETTER = "higher"


def read(run):
    return readers.mfu(run, "grpo_epoch")
