"""As grpo_mfu, with the 40 CFG forwards of each sampling batch."""

from portbench.harness import readers

NAME = "sample_mfu"
UNIT = "%"
LAYER = "model step"
MOVES = "sample_images_per_s"
SOURCE = "host_clock"
BETTER = "higher"


def read(run):
    return readers.mfu(run, "sample_batch")
