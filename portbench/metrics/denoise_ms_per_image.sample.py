"""As denoise_s_per_sample.grpo, in the window's untraced sampling batches,
per image (ms)."""

from portbench.harness import spans

NAME = "denoise_ms_per_image.sample"
UNIT = "ms/image"
LAYER = "rollout"
MOVES = "sample_images_per_s"
SOURCE = "program_span"
BETTER = "lower"


def read(run):
    s = spans.span_sum(run, "sample_batch", "sample_images", "denoise")
    return None if s is None else 1e3 * s
