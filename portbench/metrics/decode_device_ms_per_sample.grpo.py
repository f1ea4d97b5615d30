"""Device time of the pipeline's decode (the program's own 'decode' spans)
over the window's untraced epochs, per row decoded."""

from portbench.harness import spans

NAME = "decode_device_ms_per_sample.grpo"
UNIT = "ms/sample"
LAYER = "pipelines / VAE decode"
MOVES = "grpo_samples_per_s"
SOURCE = "program_span"
BETTER = "lower"


def read(run):
    s = spans.span_sum(run, "grpo_epoch", "epoch", "decode", per="rows")
    return None if s is None else 1e3 * s
