"""Device time between CUDA events the benchmark records on the stream around
the pipeline's decode (no synchronise added), over the window, per sample."""

from portbench.harness import readers

NAME = "vae_decode_ms_per_sample.grpo"
UNIT = "ms/sample"
LAYER = "pipelines / VAE decode"
MOVES = "grpo_samples_per_s"
SOURCE = "device_trace"
BETTER = "lower"


def read(run):
    return readers.decode_ms_per_sample(run, "grpo_epoch")
