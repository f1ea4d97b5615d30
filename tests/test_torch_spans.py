"""The span log of ``adv_grpo_torch.utils.metrics`` (``SPANS``, ``span``,
``StepTimer``) and the spans the port records where its work happens.

On the CPU: parent, root and cause links across a thread pool; a device span
on the CPU reads its host time; the ring keeps the newest spans and the
benchmark's span reader then reads nothing; ``StepTimer`` keeps its summary;
one tiny SD3 GRPO epoch records its root, the trainer's phases, the
rollout's ``denoise`` and ``decode``, the reward thread's ``reward`` (caused
by the epoch) and one ``optimizer`` span a microstep.

Marked ``cuda`` and skipped where no card is visible: the ``denoise`` and
``decode`` spans, placed on the host clock through the log's anchor, bracket
their kernels in a profiler trace to within 50 us, and the log's clock
meets the host's at three synchronises. Run on the card with

    python -m pytest tests/test_torch_spans.py -m cuda --noconftest
"""

import time
import types
from concurrent.futures import ThreadPoolExecutor

import pytest
import torch

from adv_grpo_torch.utils import metrics
from adv_grpo_torch.utils.metrics import SPANS, SpanLog, StepTimer, span


def _new(before):
    return [s for s in SPANS.spans() if s.id > before]


def _mark():
    return max((s.id for s in SPANS.spans()), default=0)


def test_parent_root_and_cause_links_across_a_thread_pool():
    before = _mark()

    def work(cause):
        with span("reward", rows=3, cause=cause) as r:
            with span("score"):
                pass
        return r

    with ThreadPoolExecutor(max_workers=2) as pool:
        with span("epoch") as root:
            with span("rollout") as rollout:
                assert SPANS.current() is rollout
                fut = pool.submit(work, SPANS.current())
            reward = fut.result()
        assert SPANS.current() is None
    by_name = {s.name: s for s in _new(before)}
    assert set(by_name) == {"epoch", "rollout", "reward", "score"}
    assert root.parent is None and root.root == root.id
    assert rollout.parent == root.id and rollout.root == root.id
    # the pool's thread had nothing open: no parent, the cause's root
    assert reward.parent is None and reward.cause == rollout.id and reward.root == root.id
    assert reward.thread != root.thread and reward.rows == 3
    score = by_name["score"]
    assert score.parent == reward.id and score.root == root.id and score.cause is None
    assert score.thread == reward.thread
    for s in by_name.values():
        assert s.t0 <= s.t1 and not s.device and s.dev_s is None
    assert root.t0 <= rollout.t0 <= rollout.t1 <= root.t1


def test_a_device_span_on_the_cpu_reads_its_host_time():
    x = torch.randn(64, 64)
    for device in (x.device, "cpu", True):
        with span("decode", device=device, rows=2) as s:
            time.sleep(0.002)
            x = x @ x.T
        assert s.device and not s.pending
        assert s.dev_t0 == s.t0 and s.dev_t1 == s.t1 and s.dev_s == s.t1 - s.t0 >= 0.002
    with span("reward") as h:
        pass
    assert not h.device and h.dev_s is None


def test_a_span_closes_on_an_exception():
    before = _mark()
    with pytest.raises(ValueError):
        with span("epoch"):
            with span("denoise", device="cpu"):
                raise ValueError("inside")
    assert SPANS.current() is None
    assert [s.name for s in _new(before)] == ["denoise", "epoch"]


def test_the_ring_wraps_and_the_reader_then_reads_nothing(monkeypatch):
    from portbench.harness import spans as span_readers

    log = SpanLog(size=8)
    monkeypatch.setattr(metrics, "SPANS", log)
    units = []
    for _ in range(2):
        u0 = time.perf_counter()
        with metrics.span("epoch"):
            for _ in range(2):
                with metrics.span("denoise", device="cpu", rows=4):
                    with metrics.span("denoise", device="cpu", rows=4):  # nested: not counted
                        time.sleep(0.001)
                with metrics.span("decode", device="cpu", rows=4):
                    pass
        units.append({"t0": u0, "t1": time.perf_counter(), "samples": 8, "traced": False})
    run = types.SimpleNamespace(entry="grpo_epoch", units=units)
    assert len(log.spans()) == 8 and log.lost_until > units[0]["t0"]  # the ring let go
    assert span_readers.span_sum(run, "grpo_epoch", "epoch", "denoise") is None

    log = SpanLog(size=64)
    monkeypatch.setattr(metrics, "SPANS", log)
    units[0]["traced"] = True  # the traced unit is left out
    u0 = time.perf_counter()
    with metrics.span("epoch"):
        with metrics.span("denoise", device="cpu", rows=4) as d:
            with metrics.span("denoise", device="cpu", rows=4):
                time.sleep(0.001)
        with metrics.span("reward", rows=4) as r:
            pass
    units[1] = {"t0": u0, "t1": time.perf_counter(), "samples": 8, "traced": False}
    got = span_readers.span_sum(run, "grpo_epoch", "epoch", "denoise")
    assert got == pytest.approx(d.dev_s / 8)
    assert span_readers.span_sum(run, "grpo_epoch", "epoch", "reward", per="rows") == (
        pytest.approx((r.t1 - r.t0) / 4))
    assert span_readers.span_sum(run, "grpo_epoch", "epoch", "decode") is None  # none recorded
    assert span_readers.span_sum(run, "sample_batch", "sample_images", "denoise") is None


def test_step_timer_keeps_its_summary_and_records_its_phases():
    before = _mark()
    timer = StepTimer()
    with span("epoch") as root:
        for _ in range(2):
            with timer("rollout"):
                with span("denoise", device="cpu"):
                    pass
        with timer("train"):
            pass
    assert sorted(timer.summary()) == ["time/rollout", "time/train"]
    assert timer.counts == {"rollout": 2, "train": 1}
    new = _new(before)
    rollouts = [s for s in new if s.name == "rollout"]
    assert len(rollouts) == 2 and all(s.parent == root.id for s in rollouts)
    assert [s.parent for s in new if s.name == "denoise"] == [s.id for s in rollouts]
    assert timer.totals["rollout"] <= sum(s.t1 - s.t0 for s in rollouts)
    timer.reset()
    assert timer.summary() == {}


def test_a_grpo_epoch_records_its_spans(tmp_path):
    from adv_grpo_torch.cli import train as t_train
    from adv_grpo_torch.cli.common import apply_overrides, resolve_config

    config = apply_overrides(resolve_config("smoke_sd3_fast"),
                             ["sample.train_batch_size=2", "save_dir="])
    trainer = t_train.build_trainer(config, latent_hw=8, device="cpu")
    logged = []
    trainer.logger = types.SimpleNamespace(log=lambda m, step=None: logged.append(dict(m)),
                                           log_image_grid=lambda *a, **k: None)
    before = _mark()
    trainer.run(max_epochs=1)
    new = _new(before)
    (epoch,) = [s for s in new if s.name == "epoch"]
    assert epoch.root == epoch.id and all(s.root == epoch.id for s in new)
    names = {s.name for s in new}
    assert {"encode_prompts", "rollout", "denoise", "decode", "reward", "reward_wait",
            "train", "optimizer"} <= names
    assert "reward_dispatch" not in names
    nb = trainer.num_batches
    by = {n: [s for s in new if s.name == n] for n in names}
    assert len(by["encode_prompts"]) == len(by["denoise"]) == len(by["decode"]) == nb
    # the prompts are encoded beside the rollout, the rollout holds denoise and decode
    assert all(s.parent == epoch.id for s in by["encode_prompts"] + by["rollout"])
    rollout_ids = {s.id for s in by["rollout"]}
    assert all(s.parent in rollout_ids for s in by["denoise"] + by["decode"])
    assert all(s.device and s.dev_s >= 0 for s in by["denoise"] + by["decode"])
    rows = trainer.mini * int(config.sample.train_batch_size)
    assert [s.rows for s in by["decode"]] == [rows] * nb
    # the reward ran on the executor's thread, caused by the epoch
    assert all(s.thread != epoch.thread and s.cause == epoch.id and s.parent is None
               and s.rows == rows for s in by["reward"])
    assert len(by["reward"]) == nb
    train = by["train"][0]
    assert len(by["optimizer"]) == trainer.state.micro_step
    assert all(s.parent == train.id and s.device for s in by["optimizer"])
    assert "perf/rollout_tflops_per_sec" not in logged[-1]
    assert "time/reward_dispatch" not in logged[-1]
    assert logged[-1]["time/encode_prompts"] > 0
    trainer.executor.shutdown(wait=True)


# ── on the card ──────────────────────────────────────────────────────────


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA events time the device spans)")
    return torch.device("cuda")


def _spin(dev, ms):
    """One known kernel that keeps the device busy for about ``ms``."""
    torch.cuda._sleep(int(ms * 1.98e6))


@pytest.mark.cuda
def test_denoise_and_decode_spans_bracket_their_kernels_on_the_card(dev):
    """A unit of known kernels: three 6-ms spins inside spans of the log
    (ties), each ended by a synchronise; a 2-ms spin before each span, so
    the device is busy when the span opens; the rollout's forwards behind
    10-ms spins and the SD3 VAE's 512^2 decode, so the device sets the pace
    to the end of each span. The trace goes onto the log's clock through the
    ties; the log's clock is checked against the synchronises' host times."""
    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from adv_grpo_torch.cli import train as t_train
    from adv_grpo_torch.cli.common import apply_overrides, resolve_config
    from adv_grpo_torch.models.mmdit import MMDiTConfig
    from adv_grpo_torch.models.vae import VAEConfig
    from adv_grpo_torch.rollout.sampler import denoise_with_logprob
    from adv_grpo_torch.train.pipeline import SD3Pipeline

    config = apply_overrides(resolve_config("smoke_sd3_fast"),
                             ["sample.train_batch_size=2", "save_dir="])
    trainer = t_train.build_trainer(config, latent_hw=8, device=dev)
    pipe = trainer.pipeline
    b = 4
    g = torch.Generator(device=dev).manual_seed(0)
    embeds = torch.randn(b, 6, pipe.mmdit_cfg.joint_attention_dim, device=dev, generator=g)
    pooled = torch.randn(b, pipe.mmdit_cfg.pooled_projection_dim, device=dev, generator=g)
    lat = pipe.prepare_latents(g, b, 8)
    vae_pipe = SD3Pipeline.random_init(g, MMDiTConfig.tiny(), VAEConfig.sd3(), dev)
    big = torch.randn(1, vae_pipe.vae_cfg.latent_channels, 64, 64, device=dev, generator=g)
    vfn = pipe.velocity_fn()
    neg_e, neg_p = torch.zeros_like(embeds), torch.zeros_like(pooled)
    rt = torch.zeros(b, dtype=torch.long, device=dev)  # on the device: no copy drains the stream

    def busy_vfn(*a):
        _spin(dev, 10)
        return vfn(*a)

    work = (lambda: denoise_with_logprob(busy_vfn, lat, embeds, pooled, neg_e, neg_p, g,
                                         trainer.eval_cfg, rt),
            lambda: vae_pipe.decode(big))
    synced = []

    def tie():
        with span("tie", device=dev):
            _spin(dev, 6)
        torch.cuda.synchronize(dev)
        synced.append(time.perf_counter())

    def unit():
        for w in work:
            tie()
            _spin(dev, 2)
            w()
        tie()

    unit()  # built and warm
    torch.cuda.synchronize(dev)
    SPANS.anchor(dev)
    synced.clear()
    before = _mark()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        unit()
    assert SPANS.poll() == 0
    new = _new(before)
    ev = sorted((e.start_ns(), e.duration_ns(), e.name())
                for e in prof.profiler.kineto_results.events()
                if e.device_type() == DeviceType.CUDA and e.duration_ns() > 0)
    ties = [i for i, (_, d, n) in enumerate(ev) if "spin" in n and 5e6 < d < 8e6]
    tie_spans = [s for s in new if s.name == "tie"]
    assert len(ties) == 3 == len(synced) == len(tie_spans), [
        (n[:40], d) for _, d, n in ev if "spin" in n]
    # the trace on the log's clock, fitted through the ties' ends
    ends = np.array([(ev[i][0] + ev[i][1]) * 1e-9 for i in ties])
    rate, offset = np.polyfit(ends, np.array([s.dev_t1 for s in tie_spans]), 1)

    def host(t_ns):
        return rate * t_ns * 1e-9 + offset

    residual = [host(ev[i][0] + ev[i][1]) - s.dev_t1 for i, s in zip(ties, tie_spans)]
    # the log's clock against the host's: each tie's device end against the
    # return of the synchronise that waited for it
    tie_gap = [s.dev_t1 - h for s, h in zip(tie_spans, synced)]
    spans = {s.name: s for s in new if s.name in ("denoise", "decode")}
    edges = {}
    for name, i, j in (("denoise", ties[0], ties[1]), ("decode", ties[1], ties[2])):
        inside = ev[i + 2:j]  # after the tie and the 2-ms spin
        first, last = host(inside[0][0]), max(host(s + d) for s, d, _ in inside)
        s = spans[name]
        edges[name] = (s.dev_t0 - first, s.dev_t1 - last)
        assert s.dev_s == pytest.approx(s.dev_t1 - s.dev_t0)
    why = dict(edges, tie_gap=tie_gap, residual=residual, rate=rate)
    print("span edges against the trace (s):", why)
    assert all(abs(r) <= 10e-6 for r in residual), why
    # never after the synchronise's return, and within 100 us of the nearest
    # (how long a return takes varies from call to call)
    assert all(g <= 0 for g in tie_gap) and max(tie_gap) >= -100e-6, why
    assert all(abs(e) <= 50e-6 for pair in edges.values() for e in pair), why
    trainer.executor.shutdown(wait=True)
