"""Device time of the optimizer (the program's 'optimizer' spans: each
microstep's fold into the running mean and, on a sync step, the clip, AdamW
and EMA) over the window's untraced epochs, per sample."""

from portbench.harness import spans

NAME = "optimizer_ms_per_sample.grpo"
UNIT = "ms/sample"
LAYER = "train step"
MOVES = "grpo_samples_per_s"
SOURCE = "program_span"
BETTER = "lower"


def read(run):
    s = spans.span_sum(run, "grpo_epoch", "epoch", "optimizer")
    return None if s is None else 1e3 * s
