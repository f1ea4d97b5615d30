"""The reward thread's own host time (the program's 'reward' spans, from the
call until the scores are on the host), per row scored, over the epochs that
reward_wait_s_per_sample.grpo reads (the whole window, its traced epoch
included), so that the two compare: the wait is the part of this time that
no other work hides."""

from portbench.harness import spans

NAME = "reward_s_per_sample.grpo"
UNIT = "s/sample"
LAYER = "rewards"
MOVES = "grpo_samples_per_s"
SOURCE = "program_span"
BETTER = "lower"


def read(run):
    return spans.span_sum(run, "grpo_epoch", "epoch", "reward", per="rows", traced=True)
