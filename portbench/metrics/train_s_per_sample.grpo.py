"""The trainer's own time/train (the inner epoch's microsteps, ending in a
synchronise) summed over the window, per sample."""

from portbench.harness import readers

NAME = "train_s_per_sample.grpo"
UNIT = "s/sample"
LAYER = "train step"
MOVES = "grpo_samples_per_s"
SOURCE = "program_span"
BETTER = "lower"


def read(run):
    return readers.span_s_per_sample(run, "train", "grpo_epoch")
