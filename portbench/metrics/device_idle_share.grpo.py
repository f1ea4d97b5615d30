"""1 - the union of kernel intervals over the traced epoch's wall time (a
device-only trace)."""

from portbench.harness import readers

NAME = "device_idle_share.grpo"
UNIT = "%"
LAYER = "device"
MOVES = "grpo_samples_per_s"
SOURCE = "device_trace"
BETTER = "lower"


def read(run):
    return readers.idle_share(run, "grpo_epoch")
