"""The least time the traced epoch's attention needs (bytes or bf16 FLOPs,
whichever binds, from shapes times calls; a backward 5 products) over the
device time of the attention kernel groups in it."""

from portbench.harness import readers

NAME = "attn_roofline.grpo"
UNIT = "%"
LAYER = "kernels"
MOVES = "grpo_samples_per_s"
SOURCE = "device_trace"
BETTER = "higher"


def read(run):
    return readers.attn_roofline(run, "grpo_epoch")
