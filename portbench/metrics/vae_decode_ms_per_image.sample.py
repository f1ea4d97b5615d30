"""As vae_decode_ms_per_sample.grpo, over the sampling window, per image."""

from portbench.harness import readers

NAME = "vae_decode_ms_per_image.sample"
UNIT = "ms/image"
LAYER = "pipelines / VAE decode"
MOVES = "sample_images_per_s"
SOURCE = "device_trace"
BETTER = "lower"


def read(run):
    return readers.decode_ms_per_sample(run, "sample_batch")
