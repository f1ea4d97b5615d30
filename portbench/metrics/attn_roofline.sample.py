"""As attn_roofline.grpo, over one traced sampling batch."""

from portbench.harness import readers

NAME = "attn_roofline.sample"
UNIT = "%"
LAYER = "kernels"
MOVES = "sample_images_per_s"
SOURCE = "device_trace"
BETTER = "higher"


def read(run):
    return readers.attn_roofline(run, "sample_batch")
