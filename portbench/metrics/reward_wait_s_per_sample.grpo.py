"""The trainer's own time/reward_wait (the reward time the loop is left waiting
on) summed over the window, per sample."""

from portbench.harness import readers

NAME = "reward_wait_s_per_sample.grpo"
UNIT = "s/sample"
LAYER = "rewards"
MOVES = "grpo_samples_per_s"
SOURCE = "program_span"
BETTER = "lower"


def read(run):
    return readers.span_s_per_sample(run, "reward_wait", "grpo_epoch")
