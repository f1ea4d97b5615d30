"""As device_idle_share.grpo, over one traced sampling batch."""

from portbench.harness import readers

NAME = "device_idle_share.sample"
UNIT = "%"
LAYER = "device"
MOVES = "sample_images_per_s"
SOURCE = "device_trace"
BETTER = "lower"


def read(run):
    return readers.idle_share(run, "sample_batch")
