"""The trainer's own time/rollout (sampling, VAE decode and the copy to the
host, which syncs) summed over the window's epochs, per sample."""

from portbench.harness import readers

NAME = "rollout_s_per_sample.grpo"
UNIT = "s/sample"
LAYER = "rollout"
MOVES = "grpo_samples_per_s"
SOURCE = "program_span"
BETTER = "lower"


def read(run):
    return readers.span_s_per_sample(run, "rollout", "grpo_epoch")
