"""Device time of the rollout's denoising (the program's 'denoise' spans: the
transformer forwards and SDE steps, no decode) over the window's untraced
epochs, per sample."""

from portbench.harness import spans

NAME = "denoise_s_per_sample.grpo"
UNIT = "s/sample"
LAYER = "rollout"
MOVES = "grpo_samples_per_s"
SOURCE = "program_span"
BETTER = "lower"


def read(run):
    return spans.span_sum(run, "grpo_epoch", "epoch", "denoise")
