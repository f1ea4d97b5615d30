"""The two entries a window drives, each in a closed loop of whole units:

  grpo_epoch    ``GRPOTrainer.run``, one epoch a call (rollouts, VAE
                decode, reward, advantages, the LoRA update)
  sample_batch  ``cli.infer.sample_images``, one batch of prompts a call
                (denoise, decode, images copied to the host)

Set-up builds the program, gives it its weights and runs the warm-up units
(every shape of the window, compiled and built), which the comparison
captures; the window then runs units until ``seconds`` have passed and ends
with the last whole unit. One unit of a ``--trace 1`` run is traced."""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from portbench.harness import program
from portbench.harness.registry import Registry
from portbench.harness.trace import Tracer
from portbench.harness.weights import batch_seed


@dataclasses.dataclass
class Run:
    """What a run measured, for the metric readers and the result line."""

    workload: dict
    config: dict
    family: object  # the module of families/<config's family>.py
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t_start: float
    setup_s: float = 0.0
    window_s: float = 0.0
    units: List[dict] = dataclasses.field(default_factory=list)
    spans: List[Tuple[str, float, float]] = dataclasses.field(default_factory=list)
    decode_ms: List[Tuple[float, int]] = dataclasses.field(default_factory=list)
    trace_summary: Optional[dict] = None
    peak_bytes: int = 0
    window_peak_bytes: int = 0
    captured: dict = dataclasses.field(default_factory=dict)
    # False in the readings behind a GRPO cell's limits, whose comparison
    # reads the set-up's epoch alone: no window runs after it
    window: bool = True

    @property
    def entry(self) -> str:
        return self.workload["entry"]


def make_run(reg: Registry, workload: str, seed: int, seconds: float, trace: bool, device,
             t_start: float, window: bool = True) -> Run:
    """The run of cell ``workload``, with its configuration and family."""
    wl = reg.workload(workload)
    cfg = reg.config(wl["config"])
    family = reg.family(cfg["family"])
    if wl["entry"] not in family.STAGES:
        raise KeyError(f"family {cfg['family']!r} serves {sorted(family.STAGES)}, "
                       f"not {wl['entry']!r}")
    return Run(workload=wl, config=cfg, family=family, seed=int(seed), seconds=float(seconds),
               trace=bool(trace), device=torch.device(device), t_start=t_start, window=window)


class SpanTimer:
    """The trainer's ``StepTimer`` (``time/*`` per phase), which also keeps
    every span on the host clock while ``keep`` is set."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}
        self.spans: List[Tuple[str, float, float]] = []
        self.keep = False

    @contextlib.contextmanager
    def __call__(self, phase: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            t1 = time.perf_counter()
            self.totals[phase] = self.totals.get(phase, 0.0) + t1 - t0
            self.counts[phase] = self.counts.get(phase, 0) + 1
            if self.keep:
                self.spans.append((phase, t0, t1))

    def summary(self):
        return {f"time/{k}": self.totals[k] / max(self.counts[k], 1) for k in self.totals}

    def reset(self):
        self.totals.clear()
        self.counts.clear()


class QuietLogger:
    """The trainer's logger: keeps each epoch's record, writes nothing."""

    def __init__(self):
        self.records: List[dict] = []

    def log(self, metrics, step=None):
        self.records.append(dict(metrics))

    def log_image_grid(self, *args, **kwargs):
        return None


class DecodeProbe:
    """Wraps ``pipeline.decode``: in the window, CUDA events on the stream
    around each call (no synchronise); in set-up, a copy of each call's
    latents and images for the comparison."""

    def __init__(self, pipeline, cuda: bool):
        self.inner = pipeline.decode
        self.cuda = cuda
        self.events: List[tuple] = []
        self.capture: Optional[list] = None
        pipeline.decode = self

    def __call__(self, latents):
        if self.capture is not None:
            images = self.inner(latents)
            self.capture.append((latents.detach().float().cpu(), images.detach().float().cpu()))
            return images
        if not self.cuda:
            return self.inner(latents)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        images = self.inner(latents)
        b.record()
        self.events.append((a, b, int(latents.shape[0])))
        return images

    def read(self) -> List[Tuple[float, int]]:
        out = [(a.elapsed_time(b), n) for a, b, n in self.events]
        self.events.clear()
        return out


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _window(run: Run, step, samples_per_unit, tracer: Optional[Tracer], spans_of):
    """Run ``step(i)`` until ``run.seconds`` of untraced units have passed.
    Where ``tracer`` is given the first unit is traced, and the next one
    again (up to three) while the trace comes out incomplete; traced units
    do not count toward the length (the profiler's start and stop take
    seconds)."""
    dev = run.device
    _sync(dev)
    if dev.type == "cuda":
        run.peak_bytes = torch.cuda.max_memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    run.setup_s = t0 - run.t_start
    i, traced_s, tries = 0, 0.0, 0
    while True:
        u0 = time.perf_counter()
        traced = tracer is not None and tries < 3 and (
            run.trace_summary is None or "discarded" in run.trace_summary)
        with (tracer.unit() if traced else contextlib.nullcontext()):
            step(i)
        u1 = time.perf_counter()
        run.units.append({"t0": u0, "t1": u1, "samples": samples_per_unit, "traced": traced})
        if traced:
            tries += 1
            traced_s += u1 - u0
            run.trace_summary = tracer.summary(spans_of(u0, u1))
        i += 1
        if u1 - t0 - traced_s >= run.seconds:
            break
    run.window_s = run.units[-1]["t1"] - t0
    if dev.type == "cuda":
        run.window_peak_bytes = torch.cuda.max_memory_allocated(dev)
        run.peak_bytes = max(run.peak_bytes, run.window_peak_bytes)


# ── GRPO epochs ────────────────────────────────────────────────────────────


class GrpoCapture:
    """Set-up hooks: the first sync step's LoRA and Adam state, each
    microstep's loss, and the epoch's rollouts, rewards and advantages."""

    def __init__(self, trainer):
        from adv_grpo_torch.train import grpo_trainer

        self.mod = grpo_trainer
        self.trainer = trainer
        self.orig = (grpo_trainer.apply_microbatch_grads, grpo_trainer.grpo_loss,
                     trainer.train_phase)
        self.lora0 = {k: p.detach().float().cpu().clone() for k, p in trainer.state.lora.items()}
        self.steps: List[dict] = []
        self.losses: List[float] = []
        self.samples = None
        self.advantages = None

    def __enter__(self):
        apply, loss_fn, train_phase = self.orig

        def apply_grads(state, grads):
            before = state.global_step
            out = apply(state, grads)
            if state.global_step != before:
                self.steps.append({
                    "lora": {k: p.detach().float().cpu().clone() for k, p in state.lora.items()},
                    "mu": {k: m.detach().float().cpu().clone() for k, m in state.mu.items()},
                    "count": state.count})
            return out

        def loss(*a, **kw):
            out = loss_fn(*a, **kw)
            self.losses.append(float(out.loss.detach()))
            return out

        def phase(samples, advantages):
            self.samples = {
                "prompts": list(samples["prompts"]),
                "prompt_ids": np.asarray(samples["prompt_ids"]).copy(),
                "rollout": {k: v.detach().float().cpu().clone()
                            for k, v in samples["rollout"].items()},
                "rewards": {k: np.asarray(v).copy() for k, v in samples["rewards"].items()}}
            self.advantages = np.asarray(advantages).copy()
            return train_phase(samples, advantages)

        self.mod.apply_microbatch_grads = apply_grads
        self.mod.grpo_loss = loss
        self.trainer.train_phase = phase
        return self

    def __exit__(self, *exc):
        self.mod.apply_microbatch_grads, self.mod.grpo_loss = self.orig[:2]
        del self.trainer.train_phase  # the class's method again
        return False


def grpo_epoch(run: Run, tracer: Optional[Tracer]):
    trainer, config = run.family.build("grpo_epoch", run.workload, run.config, run.seed,
                                       run.device)
    probe = DecodeProbe(trainer.pipeline, run.device.type == "cuda")
    timer = SpanTimer()
    trainer.timer = timer
    trainer.logger = QuietLogger()
    s = config.sample
    per_epoch = int(s.num_batches_per_epoch) * int(s.train_batch_size) * int(
        s.mini_num_image_per_prompt)

    probe.capture = []
    with GrpoCapture(trainer) as cap:
        for _ in range(int(run.workload.get("warmup_epochs", 1))):
            trainer.run(max_epochs=trainer.epoch + 1)
    probe.capture, decoded = None, probe.capture
    run.captured = {"decoded": decoded, "steps": cap.steps, "losses": cap.losses,
                    "samples": cap.samples, "advantages": cap.advantages,
                    "lora0": cap.lora0, "hp": dict(trainer.state.hp),
                    "accum": trainer.state.accum_steps, "config": config,
                    "latent_hw": trainer.latent_hw, "num_batches": trainer.num_batches}
    run.captured.update(run.family.grpo_captured(trainer))
    timer.reset()
    timer.keep = True

    def step(i):
        trainer.run(max_epochs=trainer.epoch + 1)

    def spans_of(a, b):
        return [x for x in timer.spans if x[1] >= a - 1e-3 and x[2] <= b + 1e-3]

    if run.window:
        _window(run, step, per_epoch, tracer, spans_of)
    run.spans = list(timer.spans)
    run.decode_ms = probe.read() if run.device.type == "cuda" else []
    trainer.executor.shutdown(wait=True)


# ── sampling batches ───────────────────────────────────────────────────────


def prompts_of(workload: dict, seed: int, index: int) -> List[str]:
    """Batch ``index``'s prompts, drawn from the seed out of the dataset."""
    p = workload["prompts"]
    with open(f"{p['dataset']}/{p['split']}.txt") as f:
        pool = [line.strip() for line in f if line.strip()]
    rng = np.random.default_rng(batch_seed(seed, "prompts", index))
    return [pool[j] for j in rng.choice(len(pool), size=int(p["batch"]), replace=False)]


def latents_of(shape, seed: int, index: int) -> np.ndarray:
    """Batch ``index``'s starting latents, standard normal from the seed."""
    rng = np.random.default_rng(batch_seed(seed, "latents", index))
    return rng.standard_normal(shape, dtype=np.float32)


def sample_batch(run: Run, tracer: Optional[Tracer]):
    from adv_grpo_torch.cli.infer import sample_images

    pipeline, config = run.family.build("sample_batch", run.workload, run.config, run.seed,
                                        run.device)
    probe = DecodeProbe(pipeline, run.device.type == "cuda")
    encode = program.encoder_of(run.config)
    hw = int(run.workload.get("latent_hw") or int(config.resolution) // 8)
    steps, scale = int(config.sample.eval_num_steps), float(config.sample.guidance_scale)
    n = int(run.workload["prompts"]["batch"])
    shape = (n, run.config["in_channels"], hw, hw)
    dev = run.device
    ne, npld = encode([""] * n)
    neg_e, neg_p = torch.from_numpy(ne).to(dev), torch.from_numpy(npld).to(dev)
    host_images: Dict[int, np.ndarray] = {}
    final_latents: Dict[int, torch.Tensor] = {}
    spans: List[Tuple[str, float, float]] = []

    def inputs(index: int):
        """Batch ``index``'s prompt embeddings and starting latents (host)."""
        e, p = encode(prompts_of(run.workload, run.seed, index))
        return e, p, latents_of(shape, run.seed, index)

    # the inputs are made in set-up: a pool the window cycles through, and
    # the warm-up batch's own, outside the pool's index range
    pool = int(run.workload["prompts"]["pool"])
    ready = [inputs(k) for k in range(pool)]

    def one(index: int, inp, keep: bool):
        e, p, lat = inp
        t1 = time.perf_counter()
        gen = torch.Generator(device=dev).manual_seed(batch_seed(run.seed, "generator", index))
        images = sample_images(pipeline, torch.from_numpy(e).to(dev), torch.from_numpy(p).to(dev),
                               neg_e, neg_p, steps, scale, gen, hw, latents=lat)
        t2 = time.perf_counter()
        out = images.float().cpu().numpy()
        t3 = time.perf_counter()
        spans.extend((("sample_images", t1, t2), ("copy to the host", t2, t3)))
        if keep:
            host_images[index] = out

    for w in range(int(run.workload.get("warmup_batches", 1))):
        one(-1 - w, inputs(-1 - w), keep=False)

    class KeepLatents:
        def __init__(self):
            self.index = None

        def __call__(self, latents):
            final_latents[self.index] = latents.detach()
            return probe(latents)

    keeper = KeepLatents()
    pipeline.decode = keeper

    def step(i):
        keeper.index = i
        one(i, ready[i % pool], keep=True)

    def spans_of(a, b):
        return [x for x in spans if x[1] >= a - 1e-3 and x[2] <= b + 1e-3]

    _window(run, step, n, tracer, spans_of)
    run.spans = spans
    run.decode_ms = probe.read() if dev.type == "cuda" else []
    run.captured = {"images": host_images,
                    "final_latents": {k: v.float().cpu() for k, v in final_latents.items()},
                    "shape": shape, "steps": steps, "scale": scale, "latent_hw": hw,
                    "pool": pool}


ENTRIES = {"grpo_epoch": grpo_epoch, "sample_batch": sample_batch}
