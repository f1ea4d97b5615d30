"""End-to-end GRPO training driver: one process per device.

Port of adv_grpo_tpu/train/driver.py's ``GRPOTrainer`` (``__init__`` with the
window-fit check, ``sample_phase``, ``train_phase`` with inner epochs and
``micro_splits``, ``eval_phase`` and ``run``):

  while global_step < max_global_step:
    [eval gate]  -> deterministic eval rollouts + eval rewards (EMA weights)
    sampling     -> num_batches_per_epoch stochastic-window rollouts; host
                    rewards scored in a thread pool, overlapping the next rollout
    advantages   -> per-prompt (or global) normalisation
    D-gate       -> pickscore: adaptive (reference reward < generated reward);
                    dino: periodic ((epoch + 1) % d_times != 0); a D-epoch
                    trains the discriminator on the whole epoch's pairs and
                    skips the policy update
    GRPO update  -> the inner epoch over (minibatch, window-step) microbatches

The device is the pipeline's (one card, or the CPU for the tests). Rollout
records stay on the device between the phases. The model family is the
pipeline's (``pipeline.family``): sd3, or flux or wan with their own sampling
and eval factories (whole stochastic window rollouts, no CFG batch, no shared
prefix; wan's are video). sd3 with ``sample.same_latent`` and groups of more
than one image samples through the group-shared prefix
(``make_shared_prefix_sample_fn``): one window start for the whole global
batch, every rank taking draw 0 (the JAX ``rt_static = rts[0]``).

Several processes (``parallel.mesh``: one per device, as ``torchrun``
launches them) split the work as the JAX package's hosts do: each rank
samples its own prompt slots (``DistributedKRepeatSampler`` with the group's
size and this rank, the JAX ``_local_ranks``), draws its rollout noise from
(seed, step, rank) and scores its own rows; prompt ids and rewards are
gathered, the advantages computed over the global batch and sliced back
(adv_grpo_tpu/train/driver.py:602-618); each microstep's LoRA gradients are
averaged across ranks (grpo_trainer), which with equal local batches is the
JAX global-mean gradient, so the optimizer state and the EMA stay equal on
every rank; only rank 0 logs. The eval prompts are padded to a multiple of
the world size and each rank evaluates its share (:520-560).

Also ported: the co-trained discriminators, PickScore and DINO
(``DiscriminatorBundle`` :56, the reference images and their rewards in
``sample_phase`` :339-379, the whole-epoch fp16 host copies of the pairs,
``d_phase`` :466 with a per-batch generator for the DINO patch draws,
``should_run_d_epoch`` :510 and the D branch of ``run`` :627), and the
reference images of the eval reward (``eval_phase`` :553-559). Two
departures from the JAX driver, which takes the gate on process-local
means and runs its D-steps without a collective: the adaptive gate
compares the means over every rank's rows (the JAX means at world size 1),
so all ranks take the same branch, and the D-steps average the
discriminator's gradients over the ranks, so all ranks keep the same
discriminator (the reference's DDP).

Checkpoints (``save``, ``restore``, ``warm_start_lora``,
``restore_discriminator``; :mod:`adv_grpo_torch.train.checkpoint`): rank 0
writes the generator state, the discriminator's and the peft adapter every
``save_freq`` epochs, then prunes to ``num_checkpoint_limit``; a restore
writes into the live parameters and optimizers in place, so the reward
context keeps reading the same modules. As in the JAX package, the epoch
counter, the stat tracker and the reward generators are not saved: a resumed
run starts again at epoch 0's prompt slots, noise and DINO gate.
"""

from __future__ import annotations

import dataclasses
import logging
import random as pyrandom
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, List, Optional

import numpy as np
import torch

from adv_grpo_torch.core.stat_tracking import PerPromptStatTracker
from adv_grpo_torch.data.krepeat import DistributedKRepeatSampler
from adv_grpo_torch.models.lora import freeze_non_lora
from adv_grpo_torch.parallel import mesh
from adv_grpo_torch.rollout.sampler import SamplerConfig, sample_random_timestep
from adv_grpo_torch.train import checkpoint as ckpt_lib
from adv_grpo_torch.train.grpo_trainer import (
    compute_advantages, make_eval_fn, make_flux_eval_fn, make_flux_sample_fn, make_sample_fn,
    make_shared_prefix_sample_fn, make_train_epoch_fn, make_wan_eval_fn, make_wan_sample_fn,
    rebatch_for_training)
from adv_grpo_torch.train.train_state import create_generator_state
from adv_grpo_torch.utils.flops import flux_forward_flops, rollout_flops, wan_forward_flops
from adv_grpo_torch.utils.images import images_to_uint8
from adv_grpo_torch.utils.metrics import MetricLogger, StepTimer

logger = logging.getLogger(__name__)


def _seed(*parts: int) -> int:
    """A generator seed from integers (the JAX ``fold_in`` of a step index)."""
    return int(np.random.SeedSequence([int(p) for p in parts]).generate_state(1)[0])


def masked_global_means(details, valid):
    """Per reward key, the mean over the rows of every rank where ``valid``
    is set and the value is not the reference's failure sentinel -10, and
    the count of those rows: ({key: mean, or -10 with no row}, {key:
    count}). Every rank must pass the same keys (the collectives run once per
    key, in sorted order)."""
    means, counts = {}, {}
    for key in sorted(details):
        a = np.asarray(details[key], np.float64).reshape(-1)
        ok = valid & (a != -10.0) if a.shape[0] == valid.shape[0] else a != -10.0
        total, count = mesh.all_reduce_sum_np(np.array([a[ok].sum(), ok.sum()], np.float64))
        means[key] = float(total / count) if count else -10.0
        counts[key] = int(count)
    return means, counts


@dataclasses.dataclass
class DiscriminatorBundle:
    """The live adversarial scorer state and its step: ``step_fn(params,
    opt_state, images_real, images_fake, input_ids or generator) ->
    (params, opt_state, loss, accuracy)`` (``grpo_trainer.make_pickscore_d_step``;
    the DINO kinds ``make_dino_d_step`` / ``make_dino_multi_d_step``)."""

    kind: str  # "pickscore" | "dino" | "dino_patch" | "dino_multi"
    step_fn: Callable
    opt_state: Any
    params: Any  # pickscore: the trainable tail; dino: the head; dino_multi: heads + fusion
    backbone: Any = None  # dino kinds: the frozen DINOv2 backbone the features come from
    tokenize: Optional[Callable] = None  # pickscore only


class GRPOTrainer:
    _grid_error_logged = False  # warn once per process, never silently drop

    def __init__(self, config, pipeline, dataset, text_encode_fn, reward_fn,
                 eval_reward_fn=None, latent_hw: int = 64,
                 logger: Optional[MetricLogger] = None, reference_store=None,
                 discriminator: Optional[DiscriminatorBundle] = None, reward_ctx=None):
        self.config = config
        if (discriminator is not None and bool(config.train_d)
                and discriminator.kind != str(config.discriminator)):
            raise ValueError(f"discriminator={config.discriminator!r} with train_d, but the "
                             f"bundle trains a {discriminator.kind!r} discriminator")
        self.family = getattr(pipeline, "family", "sd3")
        if self.family not in ("sd3", "flux", "wan"):
            raise NotImplementedError(f"model family {self.family!r}: adv_grpo_torch trains "
                                      "the sd3, flux and wan families only")
        self.pipeline = pipeline
        self.device = pipeline.device
        self.dataset = dataset
        self.text_encode_fn = text_encode_fn  # List[str] -> (embeds, pooled) numpy
        self.reward_fn = reward_fn
        self.eval_reward_fn = eval_reward_fn or reward_fn
        self.reference_store = reference_store
        self.disc = discriminator
        self.reward_ctx = reward_ctx  # the live co-trained params flow back here
        self.latent_hw = latent_hw

        s = config.sample
        # the stochastic window [rt, rt+T) must fit the schedule for every rt
        max_rt = (int(s.random_timestep) if s.random_timestep is not None
                  else int(s.num_steps) // 2)
        if int(s.train_num_steps) + max_rt > int(s.num_steps):
            raise ValueError(
                f"train_num_steps={int(s.train_num_steps)} does not fit the "
                f"schedule: the window start goes up to {max_rt}, so "
                f"train_num_steps must be <= {int(s.num_steps) - max_rt} "
                f"for num_steps={int(s.num_steps)}")
        self.sampler_cfg = SamplerConfig(
            num_steps=s.num_steps, train_num_steps=s.train_num_steps,
            guidance_scale=s.guidance_scale if config.train.cfg else 1.0,
            noise_level=s.noise_level)
        self.eval_cfg = dataclasses.replace(
            self.sampler_cfg, num_steps=s.eval_num_steps, train_num_steps=0,
            noise_level=0.0)
        self.mini = int(s.mini_num_image_per_prompt)
        self.k = max(int(s.num_image_per_prompt) // self.mini, 1)
        self.num_batches = int(s.num_batches_per_epoch)
        self.micro_splits = max(int(config.train.get("micro_splits", 1)), 1)
        # same_latent on sd3: the group-shared prefix, one window start for the
        # whole batch (a full-SDE rollout has no deterministic prefix to share)
        self.shared_prefix = bool(s.same_latent) and self.mini > 1 and self.family == "sd3"
        if self.family == "sd3":
            if self.shared_prefix:
                self.sample_fn = make_shared_prefix_sample_fn(pipeline, self.sampler_cfg,
                                                              latent_hw, group_size=self.mini)
            else:
                self.sample_fn = make_sample_fn(pipeline, self.sampler_cfg, latent_hw,
                                                same_latent=bool(s.same_latent),
                                                group_size=self.mini)
            self.eval_fn = make_eval_fn(pipeline, self.eval_cfg, latent_hw)
            self._s_img = (latent_hw // pipeline.mmdit_cfg.patch_size) ** 2
        else:
            # full-SDE rollouts are stochastic at every step, so there is no
            # shared prefix; same_latent shares a group's initial latent
            make_s, make_e = ((make_flux_sample_fn, make_flux_eval_fn) if self.family == "flux"
                              else (make_wan_sample_fn, make_wan_eval_fn))
            self.sample_fn = make_s(pipeline, self.sampler_cfg, latent_hw,
                                    same_latent=bool(s.same_latent), group_size=self.mini)
            self.eval_fn = make_e(pipeline, self.eval_cfg, latent_hw)
            if self.family == "flux":
                self._s_img = (latent_hw // 2) ** 2  # packed 2x2 tokens
            else:
                pt, ph, pw = pipeline.wan_cfg.patch_size
                self._s_img = ((pipeline.latent_frames // pt) * (latent_hw // ph)
                               * (latent_hw // pw))
        train_sampler_cfg = dataclasses.replace(
            self.sampler_cfg, cfg_sequential=bool(config.train.get("cfg_sequential", False)))
        self.train_epoch_fn = make_train_epoch_fn(pipeline, train_sampler_cfg, config.train,
                                                  beta=float(config.train.beta))

        # trainable LoRA subtree; every other parameter frozen
        lora = freeze_non_lora(pipeline.transformer)
        if not lora:
            raise ValueError("pipeline has no LoRA parameters (lora_rank=0?)")
        self.state = create_generator_state(lora, config.train, s.train_num_steps)

        # one process = one device = one replica: the k-repeat sampler raises
        # when the global batch cannot hold whole groups
        self.rank, self.world_size = mesh.rank(), mesh.world_size()
        self.prompt_sampler = DistributedKRepeatSampler(
            len(dataset), batch_size=int(s.train_batch_size), k=self.k,
            num_replicas=self.world_size, rank=self.rank, seed=int(config.seed))
        self.per_prompt_stats = (bool(config.per_prompt_stat_tracking)
                                 and int(s.num_image_per_prompt) > 1)
        if (str(config.train.algorithm) in ("sft", "dpo")
                and int(s.num_image_per_prompt) < 2):
            raise ValueError(
                f"train.algorithm={config.train.algorithm!r} needs "
                f"num_image_per_prompt >= 2 (group-relative labels), got "
                f"{int(s.num_image_per_prompt)}")
        self.tracker = PerPromptStatTracker(global_std=bool(s.global_std))
        self.logger = logger or MetricLogger(
            config.save_dir, wandb_init=bool(config.wandb_init),
            run_name=str(config.case_name), is_main=mesh.is_main())
        self.timer = StepTimer()
        self.executor = ThreadPoolExecutor(max_workers=4)
        self._rollout_flops_acc = 0.0
        ne, npld = self.text_encode_fn([""])
        self.neg_embeds1 = self._dev(ne)
        self.neg_pooled1 = self._dev(npld)
        self.epoch = 0

    # ── helpers ─────────────────────────────────────────────────────────

    def _dev(self, a):
        return torch.as_tensor(np.asarray(a, np.float32), device=self.device)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _neg(self, batch: int):
        return (self.neg_embeds1.expand(batch, *self.neg_embeds1.shape[1:]),
                self.neg_pooled1.expand(batch, *self.neg_pooled1.shape[1:]))

    def window_start(self, step_idx: int) -> int:
        """This rank's stochastic window start at sampling batch ``step_idx``:
        ``sample.random_timestep`` where set, else one draw per rank from the
        batch's generator, rank r taking the r-th (the JAX driver's ``rts[r]``,
        adv_grpo_tpu/train/driver.py:282-296), so every rank trains on its own
        window. The shared prefix takes one start for the whole global batch:
        every rank takes draw 0 (the JAX ``rt_static = int(rts[0])``)."""
        if self.config.sample.random_timestep is not None:
            return int(self.config.sample.random_timestep)
        draws = sample_random_timestep(np.random.default_rng(step_idx), self.sampler_cfg,
                                       shape=self.world_size)
        return int(draws[0 if self.shared_prefix else self.rank])

    # ── phases ──────────────────────────────────────────────────────────

    def sample_phase(self, epoch: int):
        rollouts, all_prompts, all_prompt_ids = [], [], []
        all_embeds, all_pooled, reward_futures = [], [], []
        all_images, all_refs, all_batch_prompts = [], [], []
        last_images = last_refs = last_prompts = None
        for i in range(self.num_batches):
            step_idx = epoch * self.num_batches + i
            slot_idx = self.prompt_sampler.batch_for_epoch(step_idx).tolist()
            slot_prompts = [self.dataset[j]["prompt"] for j in slot_idx]
            metas = [self.dataset[j]["metadata"] for j in slot_idx]
            # each slot expands to mini images
            prompts = [p for p in slot_prompts for _ in range(self.mini)]
            prompt_ids = [j for j in slot_idx for _ in range(self.mini)]
            metadata = [m for m in metas for _ in range(self.mini)]
            embeds, pooled = self.text_encode_fn(slot_prompts)
            embeds = self._dev(np.repeat(np.asarray(embeds), self.mini, axis=0))
            pooled = self._dev(np.repeat(np.asarray(pooled), self.mini, axis=0))
            B = embeds.shape[0]
            neg_e, neg_p = self._neg(B)
            rt = self.window_start(step_idx)
            # each rank draws its own noise
            generator = torch.Generator(device=self.device).manual_seed(
                _seed(self.config.seed, step_idx, self.rank))
            with self.timer("rollout"):
                rollout, images = self.sample_fn(
                    embeds, pooled, neg_e, neg_p, generator,
                    rt if self.shared_prefix else torch.full((B,), rt, dtype=torch.long))
                images_np = images.float().cpu().numpy()  # syncs: the rollout is done
            if self.family == "flux":  # one forward per step, no CFG batch
                self._rollout_flops_acc += self.sampler_cfg.num_steps * flux_forward_flops(
                    self.pipeline.flux_cfg, self._s_img, embeds.shape[1], B)
            elif self.family == "wan":
                # one forward per step; the KL adds the adapter-free forward
                kl_mult = 2.0 if float(getattr(self.pipeline, "kl_reward", 0.0)) > 0 else 1.0
                self._rollout_flops_acc += (
                    self.sampler_cfg.num_steps * kl_mult * wan_forward_flops(
                        self.pipeline.wan_cfg, self._s_img, embeds.shape[1], B))
            else:
                self._rollout_flops_acc += rollout_flops(
                    self.pipeline.mmdit_cfg, self._s_img, embeds.shape[1], B,
                    self.sampler_cfg.num_steps, self.sampler_cfg.do_cfg,
                    prefix_steps=rt if self.shared_prefix else 0, group_size=self.mini)

            refs = None
            if self.reference_store is not None:
                refs = self.reference_store.get_batch(prompts, rng=pyrandom.Random(step_idx))

            def _score(images=images_np, prompts=prompts, metadata=metadata, refs=refs):
                out = {"gen": self.reward_fn(images, prompts, metadata, ref_images=refs)[0]}
                if refs is not None and self.disc is not None:
                    # the reference images under the same reward, for the gate
                    ref_flat = refs.reshape((-1,) + refs.shape[-3:])
                    out["ref"] = self.reward_fn(ref_flat[:len(prompts)], prompts, metadata)[0]
                return out

            with self.timer("reward_dispatch"):
                reward_futures.append(self.executor.submit(_score))
            rollouts.append(rollout._asdict())
            all_prompts.extend(prompts)
            all_prompt_ids.extend(prompt_ids)
            all_embeds.append(embeds)
            all_pooled.append(pooled)
            if self.disc is not None and bool(self.config.train_d):
                # the whole epoch's pairs for the D-step, fp16 on the host
                # (reference train_sd3_fast_pickscore.py:795-800, 1003-1008)
                all_images.append(images_np.astype(np.float16))
                all_refs.append(None if refs is None else refs.astype(np.float16))
                all_batch_prompts.append(prompts)
            last_images, last_refs, last_prompts = images_np, refs, prompts

        with self.timer("reward_wait"):
            results = [f.result() for f in reward_futures]
        rewards = {k: np.concatenate([np.asarray(r["gen"][k]) for r in results])
                   for k in results[0]["gen"]}
        ref_rewards = None
        if "ref" in results[0]:
            ref_rewards = {k: np.concatenate([np.asarray(r["ref"][k]) for r in results])
                           for k in results[0]["ref"]}
        rollout = {k: torch.cat([r[k] for r in rollouts])
                   for k in rollouts[0] if k != "final_latents"}
        return dict(prompts=all_prompts, prompt_ids=np.asarray(all_prompt_ids, np.int64),
                    rollout=rollout, embeds=torch.cat(all_embeds),
                    pooled=torch.cat(all_pooled), rewards=rewards, ref_rewards=ref_rewards,
                    last_images=last_images, last_refs=last_refs, last_prompts=last_prompts,
                    epoch_images=all_images, epoch_refs=all_refs,
                    epoch_prompts=all_batch_prompts)

    def train_phase(self, samples, advantages: np.ndarray):
        r = samples["rollout"]
        data = dict(latents=r["latents"], log_probs=r["log_probs"],
                    timesteps=r["timesteps"], sigmas=r["sigmas"],
                    sigmas_prev=r["sigmas_prev"], advantages=self._dev(advantages),
                    embeds=samples["embeds"], pooled=samples["pooled"])
        n = data["latents"].shape[0]
        n_micro = self.num_batches * self.micro_splits
        if self.micro_splits > 1 and n % n_micro != 0:
            # rebatch_for_training would silently drop rows
            raise ValueError(
                f"train.micro_splits={self.micro_splits} does not divide "
                f"the minibatch: {n} rows / {self.num_batches} minibatches "
                f"is not divisible by {self.micro_splits}")
        inner_epochs = max(int(self.config.train.num_inner_epochs), 1)
        infos = []
        with self.timer("train"):
            for inner in range(inner_epochs):
                # re-traverse the epoch's samples, reshuffled per inner epoch;
                # advantages and log-probs travel with their rows
                if inner == 0:
                    d = data
                else:
                    perm = np.random.default_rng(
                        (self.epoch + 1) * 7919 + inner).permutation(n)
                    perm = torch.as_tensor(perm, device=self.device)
                    d = {k: v[perm] for k, v in data.items()}
                batched = rebatch_for_training(d, n_micro)
                neg_e, neg_p = self._neg(batched["latents"].shape[1])
                self.state, info = self.train_epoch_fn(self.state, batched, neg_e, neg_p)
                infos.append(info)
            self._sync()
        self.last_inner_losses = [i["loss"] for i in infos]
        return {k: float(np.mean([i[k] for i in infos])) for k in infos[0]}

    def d_phase(self, samples):
        """Train D on the whole epoch's generated / reference pairs, one step
        per sampling batch (the DINO kinds' patch draws from a generator
        seeded by (7, epoch * 1024 + batch), the JAX ``fold_in`` key); then
        the co-trained reward scores with the new parameters."""
        d = self.disc
        if not samples["epoch_refs"] or samples["epoch_refs"][0] is None:
            raise RuntimeError("D-step requires a reference image store")
        losses, accs = [], []
        with self.timer("d_step"):
            for b, (fake, refs, prompts) in enumerate(zip(
                    samples["epoch_images"], samples["epoch_refs"], samples["epoch_prompts"])):
                real = refs[:, 0] if refs.ndim == 5 else refs
                n = min(len(real), fake.shape[0])
                if d.kind == "pickscore":
                    last = d.tokenize(prompts[:n])
                else:
                    last = torch.Generator(device=self.device).manual_seed(
                        _seed(7, self.epoch * 1024 + b))
                d.params, d.opt_state, loss, acc = d.step_fn(d.params, d.opt_state, real[:n],
                                                             fake[:n], last)
                losses.append(float(loss))
                accs.append(float(acc))
        if self.reward_ctx is not None:
            if d.kind == "pickscore":
                self.reward_ctx.pickscore_params = d.params
            elif d.kind == "dino_multi":
                self.reward_ctx.dino_multi_params = d.params
            else:
                self.reward_ctx.dino_head_params = d.params
        return {"d_loss": float(np.mean(losses)), "d_acc": float(np.mean(accs))}

    def should_run_d_epoch(self, samples) -> bool:
        """The two gates. PickScore (reference :1025-1037): a D-epoch when
        the reference images' mean reward is below the generated ones', both
        means over the rows of every rank. DINO (reference
        train_sd3_fast_dino_patch.py:1097-1118): periodic, a D-epoch unless
        (epoch + 1) % d_times == 0."""
        if self.disc is None or not bool(self.config.train_d):
            return False
        if self.disc.kind != "pickscore":
            return (self.epoch + 1) % int(self.config.d_times) != 0
        if samples["ref_rewards"] is None:
            return False
        ref, gen = samples["ref_rewards"]["avg"], samples["rewards"]["avg"]
        s = mesh.all_reduce_sum_np(np.array([np.sum(ref), len(ref), np.sum(gen), len(gen)],
                                            np.float64))
        return float(s[0] / s[1]) < float(s[2] / s[3])

    def eval_phase(self, eval_prompts: List[str], seed: int = 0):
        """Deterministic eval on the EMA weights (the live LoRA without EMA).

        The prompts are padded to a multiple of the world size (the last one
        repeated) and each rank generates and scores its contiguous share, so
        a rank whose share is all padding still runs the collectives; the
        means (``eval_reward_*``) are over the valid rows of all ranks, whose
        number is ``eval_count_*``. Returns this rank's valid images and the
        metrics (equal on every rank)."""
        lora = self.state.ema if self.state.ema is not None else self.state.lora
        n = len(eval_prompts)
        per = -(-n // self.world_size)
        padded = list(eval_prompts) + [eval_prompts[-1]] * (per * self.world_size - n)
        start = self.rank * per
        local = padded[start:start + per]
        valid = np.arange(start, start + per) < n
        embeds, pooled = (self._dev(a) for a in self.text_encode_fn(local))
        neg_e, neg_p = self._neg(embeds.shape[0])
        generator = torch.Generator(device=self.device).manual_seed(_seed(seed, self.rank))
        images = self.eval_fn(lora, embeds, pooled, neg_e, neg_p, generator)
        images = images.float().cpu().numpy()
        refs = (self.reference_store.get_batch(local) if self.reference_store is not None
                else None)
        # score ALL local rows (a scorer's reward keys must not depend on the
        # padding), leave the padding out of the means
        details, _ = self.eval_reward_fn(images, local, [{}] * len(local), ref_images=refs,
                                         only_strict=False)
        means, counts = masked_global_means(details, valid)
        metrics = {f"eval_reward_{k}": v for k, v in means.items()}
        metrics.update({f"eval_count_{k}": n for k, n in counts.items()})
        return images[valid], metrics

    # ── main loop ───────────────────────────────────────────────────────

    def run(self, max_epochs: Optional[int] = None, eval_prompts=None):
        cfg = self.config
        while self.state.global_step < int(cfg.max_global_step):
            if max_epochs is not None and self.epoch >= max_epochs:
                break
            if eval_prompts and self.epoch % int(cfg.eval_freq) == 0 and self.epoch > 0:
                eval_images, eval_metrics = self.eval_phase(eval_prompts)
                self.logger.log(eval_metrics, step=self.state.global_step)
                self.logger.log_image_grid(
                    "eval_images", images_to_uint8(eval_images),
                    captions=eval_prompts[:len(eval_images)],  # rank 0's share
                    step=self.state.global_step, save_dir=str(cfg.save_dir))
            if cfg.save_dir and self.epoch % int(cfg.save_freq) == 0 and self.epoch > 0:
                self.save()

            samples = self.sample_phase(self.epoch)
            # gather -> advantage -> slice-back: ids (never strings) and
            # rewards of every rank, the statistics over the global batch
            ids, local_rows = mesh.gather_global(samples["prompt_ids"])
            avg, _ = mesh.gather_global(np.asarray(samples["rewards"]["avg"], np.float32))
            algo = str(cfg.train.algorithm)
            if self.per_prompt_stats or algo != "grpo":
                advantages, group_stats = compute_advantages(self.tracker, ids, avg,
                                                             algorithm=algo)
            else:
                # global normalisation over the whole gathered batch
                advantages = ((avg - avg.mean()) / (avg.std() + 1e-4)).astype(np.float32)
                group_stats = {}
            advantages = advantages[local_rows]

            metrics = {f"reward_{k}": float(np.mean(v)) for k, v in samples["rewards"].items()}
            if samples["ref_rewards"] is not None:
                metrics.update({f"reference_reward_{k}": float(np.mean(v))
                                for k, v in samples["ref_rewards"].items()})
            metrics.update(group_stats)
            if self.should_run_d_epoch(samples):
                metrics.update(self.d_phase(samples))
                metrics["d_epoch"] = 1
                # a D-epoch advances the step counter too (reference :1035-1036)
                self.state.global_step += 1
            else:
                metrics.update(self.train_phase(samples, advantages))
                metrics["d_epoch"] = 0
            metrics.update(self.timer.summary())
            rollout_s = self.timer.totals.get("rollout", 0.0)
            if rollout_s > 0 and self._rollout_flops_acc > 0:
                metrics["perf/rollout_tflops_per_sec"] = (
                    self._rollout_flops_acc / rollout_s / 1e12)
            self._rollout_flops_acc = 0.0
            self.timer.reset()
            metrics["epoch"] = self.epoch
            self.logger.log(metrics, step=self.state.global_step)
            if cfg.save_dir and self.epoch % 10 == 0:
                self._save_sample_grid(samples)
            self.epoch += 1
        return self.state

    def _save_sample_grid(self, samples):
        """Sample-image grid every 10 epochs; a failure is logged once."""
        images = samples["last_images"][:8]
        if images.ndim == 5:  # video (B, F, 3, H, W): the first frames
            images = images[:, 0]
        try:
            self.logger.log_image_grid(
                "samples_epoch", images_to_uint8(images),
                captions=samples["last_prompts"], step=self.epoch,
                save_dir=str(self.config.save_dir))
        except Exception as e:  # noqa: BLE001 — best-effort, but never silent
            if not self._grid_error_logged:
                self._grid_error_logged = True
                logger.warning("sample-grid save failed (logged once): %s: %s",
                               type(e).__name__, e)

    def save(self):
        """Write ``checkpoint-{global_step}`` (every rank holds the same
        state; rank 0 writes), then prune to ``num_checkpoint_limit``.
        Returns the checkpoint's directory on rank 0, else None."""
        cfg = self.config
        if not mesh.is_main():
            return None
        state, step = self.state, int(self.state.global_step)
        extra = None
        if self.disc is not None:
            # the co-trained reward model survives a crash too
            extra = {"d_params": self.disc.params.state_dict(),
                     "d_opt_state": self.disc.opt_state.state_dict()}
        path = ckpt_lib.save_state(str(cfg.save_dir), step, state, extra=extra)
        ckpt_lib.save_lora_only(
            str(cfg.save_dir), step, state.lora, use_ema_weights=state.ema,
            rank=int(cfg.train.lora_rank), alpha=float(cfg.train.lora_alpha),
            base_model=str(cfg.pretrained.model or ""))
        ckpt_lib.prune_checkpoints(str(cfg.save_dir), int(cfg.num_checkpoint_limit))
        return path

    def warm_start_lora(self, path: str):
        """Generator warm start from a LoRA-only adapter (``train.lora_path``,
        a peft directory): the adapter's values go into the LoRA parameters
        and re-seed the EMA shadow; the optimizer state stays as it is (fresh
        at the start of a run)."""
        loaded = ckpt_lib.load_lora_only(
            path, expect_rank=int(self.config.train.lora_rank),
            expect_alpha=float(self.config.train.lora_alpha))
        ckpt_lib.copy_into(self.state.lora, loaded, f"LoRA adapter at {path}")
        if self.state.ema is not None:
            ckpt_lib.copy_into(self.state.ema, self.state.lora, "the LoRA")
        return self.state

    def restore(self, path: str):
        """Full resume: the generator state and, when co-training, the
        discriminator's."""
        ckpt_lib.restore_state(path, self.state)
        if self.disc is not None:
            self.restore_discriminator(path)
        return self.state

    def restore_discriminator(self, path: str):
        """The discriminator's state from a checkpoint's ``extra.pt`` (the
        reference's ``config.weight_path`` warm start, and ``restore``),
        loaded into the live module and its optimizer in place: the co-trained
        reward reads the same module, and the frozen copy the 'pickscore'
        reward scores with stays as it was built."""
        ckpt_lib.refuse_msgpack(path)
        extra = ckpt_lib.restore_extra(path)
        if extra is None:
            raise FileNotFoundError(
                f"checkpoint at {path} carries no discriminator state")
        d = self.disc
        d.params.load_state_dict(extra["d_params"])
        d.opt_state.load_state_dict(extra["d_opt_state"])
        if self.reward_ctx is not None:
            if d.kind == "pickscore":
                self.reward_ctx.pickscore_params = d.params
            elif d.kind == "dino_multi":
                self.reward_ctx.dino_multi_params = d.params
            else:
                self.reward_ctx.dino_head_params = d.params
