"""Faults planted in the timed path, to show that the comparison fails them,
and to read a training number's upper limit where the control leaves it
without one.

    python3 -m portbench.faults --workload <cell> --fault <name> --seeds 11,12,13

runs each seed as ``portbench.control`` does, with the fault in place, and
prints the numbers and whether they pass the cell's limits
(``program_correct``, by the rule of the benchmark's own runs), which has to
be false. The CPU tests plant the same faults at the CPU-sized cells. The
benchmark's own runs plant none.

  state_unchanged   each optimizer step leaves the LoRA and Adam's moments as
                    they were
  half_batch        each optimizer step sees the first half of its rows
                    twice (the mean over half of its batch): within each
                    minibatch, or, where a minibatch is one row, within the
                    minibatches of each optimizer step
  image_altered     the decoded images or videos scaled by 0.9 where the
                    pipeline makes them
  reward_altered    every PickScore reward shifted by 0.01
  velocity_altered  the transformer's velocity scaled by 1.01 at every step
                    of the rollout and the replay
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys

import torch


@contextlib.contextmanager
def _patched(obj, name, value):
    saved = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, saved)


def state_unchanged():
    from adv_grpo_torch.train import grpo_trainer

    orig = grpo_trainer.apply_microbatch_grads

    def unchanged(state, grads):
        lora = {k: p.detach().clone() for k, p in state.lora.items()}
        mu = {k: m.clone() for k, m in state.mu.items()}
        nu = {k: m.clone() for k, m in state.nu.items()}
        out = orig(state, grads)
        with torch.no_grad():
            for k, p in state.lora.items():
                p.copy_(lora[k])
                state.mu[k].copy_(mu[k])
                state.nu[k].copy_(nu[k])
        return out

    return _patched(grpo_trainer, "apply_microbatch_grads", unchanged)


@contextlib.contextmanager
def half_batch():
    from adv_grpo_torch.train import driver

    orig, phase = driver.rebatch_for_training, driver.GRPOTrainer.train_phase
    per_step = {}

    def train_phase(self, *args, **kwargs):
        # the minibatches of one optimizer step
        per_step["n"] = self.state.accum_steps // int(self.config.sample.train_num_steps)
        return phase(self, *args, **kwargs)

    def half(samples, n):
        out = orig(samples, n)
        g = per_step["n"]
        for k, v in out.items():
            if v.shape[1] >= 2:  # within each minibatch
                h = v.shape[1] // 2
                out[k] = torch.cat([v[:, :h], v[:, :h], v[:, 2 * h:]], 1)
            elif g >= 2:  # one row a minibatch: within each optimizer step's minibatches
                steps = []
                for s in range(0, v.shape[0], g):
                    rows = v[s:s + g]
                    h = rows.shape[0] // 2
                    steps.append(torch.cat([rows[:h], rows[:h], rows[2 * h:]]))
                out[k] = torch.cat(steps)
            else:
                raise ValueError("an optimizer step of one row has no half to leave out")
        return out

    with _patched(driver, "rebatch_for_training", half), \
            _patched(driver.GRPOTrainer, "train_phase", train_phase):
        yield


@contextlib.contextmanager
def image_altered():
    from adv_grpo_torch.train.pipeline import SD3Pipeline
    from adv_grpo_torch.train.wan_pipeline import WanPipeline

    sd3, wan = SD3Pipeline.decode, WanPipeline.decode
    with _patched(SD3Pipeline, "decode", lambda self, z: sd3(self, z) * 0.9), \
            _patched(WanPipeline, "decode", lambda self, z: wan(self, z) * 0.9):
        yield


def reward_altered():
    from adv_grpo_torch.rewards.scorers import PickScoreScorer

    orig = PickScoreScorer.score
    return _patched(PickScoreScorer, "score", lambda self, *a, **kw: orig(self, *a, **kw) + 0.01)


@contextlib.contextmanager
def velocity_altered():
    from adv_grpo_torch.rollout import sampler, wan

    cps, wstep = sampler.cps_step_with_logprob, wan.wan_sde_step_with_logprob
    with _patched(sampler, "cps_step_with_logprob", lambda v, *a, **kw: cps(v * 1.01, *a, **kw)), \
            _patched(wan, "wan_sde_step_with_logprob",
                     lambda v, *a, **kw: wstep(v * 1.01, *a, **kw)):
        yield


FAULTS = {"state_unchanged": state_unchanged, "half_batch": half_batch,
          "image_altered": image_altered, "reward_altered": reward_altered,
          "velocity_altered": velocity_altered}


def main(argv=None) -> int:
    from portbench.control import readings

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--fault", required=True, choices=sorted(FAULTS))
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("portbench.faults: no CUDA device", file=sys.stderr)
        return 2
    for s in args.seeds.split(","):
        with FAULTS[args.fault]():
            out = readings(args.workload, int(s), False)
        out["fault"] = args.fault
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
