"""The port's learning-curve check: fixed-seed tiny GRPO training must raise
a toy brightness reward, and must not with the advantages negated.

The port of tests/test_learning_curve.py:88-182 (its direction and
negated-control checks; its goldens are the JAX package's curves and do not
carry over, so there is none here). Each family trains its smoke preset
(SD3 with the group-shared prefix on, ``sample.same_latent=True``; Flux;
WAN) from the trainer the training CLI builds, with the reward replaced by
the image (or video) mean plus a crc32 prompt offset. Every epoch replays
the same rollout noise, prompt slots and window start (``pin_epoch``,
``random_timestep=1``), so the epoch-to-epoch change of the mean reward
comes from the parameter updates alone.

One departure from the JAX test's design: each prompt slot holds its own
prompt and is its own GRPO group (``num_image_per_prompt`` equal to
``mini_num_image_per_prompt``), where the JAX test puts one prompt in
every slot. With one prompt everywhere the advantages are normalised over
the whole epoch, across groups whose members share their initial latent;
they then mostly rank the groups' starting latents, which the window's
log-probabilities cannot credit, and the shared-prefix SD3 run falls at
small learning rates in both packages (probed at lr 1e-3, 4 batches: the
port's gap -0.000398, its negated +0.000375; the JAX
``tests/test_learning_curve.py::run_family("sd3")`` with ``same_latent``
-0.000183 / +0.000117). Per-slot groups leave in each group's advantages
only what its window noise did, which is what ``same_latent`` is for.

Learning rates and margins come from the probe in this file's main,
``python tests/test_torch_learning_curve.py [FAMILY ...]``, which prints
each family's direction gap at its rate, with and without negated
advantages (the reading on the CPU, the same at 1 and 4 threads: sd3
+0.001032 / -0.000951 at 1e-1, flux +0.001000 / -0.001336 at 1e-2, wan
+0.000599 / -0.000695 at 1e-2; each curve moves monotonically). Each
margin is under a third of its family's gap. A pair of runs takes 5-12 s
on one CPU worker.
"""

import sys
import zlib

import numpy as np
import pytest
import torch

EPOCHS = 8
# family -> (preset, overrides, latent side (None: the preset's), lr, margin)
FAMILIES = {
    "sd3": ("smoke_sd3_fast", ["sample.train_batch_size=2", "sample.same_latent=True",
                               "sample.mini_num_image_per_prompt=4"], 8, 1e-1, 3e-4),
    "flux": ("flux_smoke", ["sample.num_image_per_prompt=8",
                            "sample.mini_num_image_per_prompt=8"], None, 1e-2, 3e-4),
    "wan": ("wan_smoke", [], None, 1e-2, 2e-4),
}


class CurveLogger:
    def __init__(self):
        self.metrics = []

    def log(self, metrics, step=0):
        self.metrics.append(dict(metrics))

    def log_image_grid(self, *a, **k):
        pass

    def curve(self):
        return [m["reward_avg"] for m in self.metrics if "reward_avg" in m]


class _PromptDataset:
    """A distinct prompt in every slot (a crc32 reward offset each, which the
    per-prompt advantages cancel)."""

    def __init__(self, n):
        self.prompts = [f"a bright image {i}" for i in range(n)]

    def __len__(self):
        return len(self.prompts)

    def __getitem__(self, i):
        return {"prompt": self.prompts[i], "metadata": {}}


def brightness_reward(images, prompts, metadata=None, ref_images=None, only_strict=True):
    """The mean of each image (or video) plus a crc32 offset of its prompt."""
    arr = np.asarray(images, np.float32)
    scores = arr.reshape(arr.shape[0], -1).mean(axis=1).astype(np.float64)
    avg = scores + np.array([zlib.crc32(p.encode()) % 7 / 70.0 for p in prompts])
    return {"brightness": avg, "avg": avg}, {}


def pin_epoch(trainer, seed=1234):
    """Every epoch replays epoch 0's prompt slots and rollout noise: sampling
    batch i of any epoch gets batch i's slots and a generator seeded with
    (seed, i)."""
    orig, nb, count = trainer.sample_fn, int(trainer.num_batches), {"i": 0}
    slots = trainer.prompt_sampler.batch_for_epoch

    def wrapped(embeds, pooled, neg_e, neg_p, generator, rt):
        g = torch.Generator(device=trainer.device).manual_seed(seed + count["i"] % nb)
        count["i"] += 1
        return orig(embeds, pooled, neg_e, neg_p, g, rt)

    trainer.sample_fn = wrapped
    trainer.prompt_sampler.batch_for_epoch = lambda step: slots(step % nb)


def run_family(family: str, lr=None, epochs: int = EPOCHS, negate: bool = False):
    """A fixed-seed pinned run of ``family``'s smoke preset at ``lr`` (the
    family's by default); returns the per-epoch mean reward."""
    from adv_grpo_torch.cli import train
    from adv_grpo_torch.cli.common import apply_overrides, resolve_config

    preset, overrides, latent_hw, family_lr, _ = FAMILIES[family]
    config = apply_overrides(resolve_config(preset), overrides + [
        "seed=0", f"train.learning_rate={family_lr if lr is None else lr}",
        "sample.random_timestep=1", "save_dir=", "wandb_init=False"])
    trainer = train.build_trainer(config, latent_hw=latent_hw, device="cpu")
    assert trainer.shared_prefix == (family == "sd3") and trainer.k == 1
    trainer.logger = CurveLogger()
    trainer.reward_fn = brightness_reward
    trainer.dataset = _PromptDataset(len(trainer.dataset))
    pin_epoch(trainer)
    if negate:
        orig = trainer.train_phase
        trainer.train_phase = lambda samples, adv: orig(samples, -adv)
    trainer.run(max_epochs=epochs)
    curve = [float(c) for c in trainer.logger.curve()]
    assert len(curve) == epochs, curve
    return curve


def direction_gap(curve):
    """The mean of the last 2 epochs minus the mean of epochs 2-3, on the
    curve relative to epoch 1 (measured before any update): the
    post-transient slope, as the JAX test reads it."""
    rel = [c - curve[0] for c in curve]
    return float(np.mean(rel[-2:])) - float(np.mean(rel[1:3])), rel


@pytest.mark.parametrize("family", list(FAMILIES))
def test_brightness_reward_rises(family):
    margin = FAMILIES[family][-1]
    gap, rel = direction_gap(run_family(family))
    assert gap > margin, f"{family}: gap {gap:.6f} <= margin {margin}; rel curve {rel}"


@pytest.mark.parametrize("family", list(FAMILIES))
def test_sign_error_does_not_rise(family):
    """Negated advantages (the bug class this check exists for) must fail the
    direction check: the margin is discriminative, not vacuous."""
    margin = FAMILIES[family][-1]
    gap, rel = direction_gap(run_family(family, negate=True))
    assert gap <= margin, f"{family}: negated gap {gap:.6f} > margin {margin}; rel {rel}"


if __name__ == "__main__":
    import os
    import time

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    for family in sys.argv[1:] or list(FAMILIES):
        t0 = time.perf_counter()
        pos, neg = (direction_gap(run_family(family, negate=n))[0] for n in (False, True))
        print(f"{family} lr {FAMILIES[family][3]:g}: gap {pos:+.6f}, negated {neg:+.6f}, "
              f"margin {FAMILIES[family][4]:g} ({time.perf_counter() - t0:.1f} s for the pair)",
              flush=True)
