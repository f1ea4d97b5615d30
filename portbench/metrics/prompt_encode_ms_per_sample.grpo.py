"""The trainer's own time/encode_prompts (the prompt embeddings and their
copy to the device) summed over the window, per sample."""

from portbench.harness import readers

NAME = "prompt_encode_ms_per_sample.grpo"
UNIT = "ms/sample"
LAYER = "trainer"
MOVES = "grpo_samples_per_s"
SOURCE = "program_span"
BETTER = "lower"


def read(run):
    s = readers.span_s_per_sample(run, "encode_prompts", "grpo_epoch")
    return None if s is None else 1e3 * s
