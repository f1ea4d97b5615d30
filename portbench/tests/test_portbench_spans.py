"""The per-layer metrics that read the program's own spans
(``portbench/harness/spans.py``, ``adv_grpo_torch.utils.metrics.SPANS``).

On the CPU: the tiny GRPO and sampling cells run with the trace on (a
stand-in for the device tracer, which needs a card, discards each trace) and
read every span metric as a finite positive number; on a copy of the
program without the span log they read nothing and do not raise.

On the card (the ``card`` fixture): the ``decode`` span's device time agrees
with CUDA events taken around the call to within 1%."""

from __future__ import annotations

import contextlib
import math

import pytest

GRPO = ("denoise_s_per_sample.grpo", "decode_device_ms_per_sample.grpo",
        "reward_s_per_sample.grpo", "optimizer_ms_per_sample.grpo",
        "prompt_encode_ms_per_sample.grpo")
SAMPLE = ("denoise_ms_per_image.sample", "decode_device_ms_per_image.sample")


class CpuTracer:
    """The device tracer's interface where there is no device to trace: every
    trace is discarded, so the window also runs untraced units."""

    def __init__(self, device, groups):
        pass

    @contextlib.contextmanager
    def unit(self):
        yield

    def summary(self, spans):
        return {"discarded": "no device trace on the CPU"}


@pytest.mark.parametrize("cell,names", [("tiny-grpo", GRPO), ("tiny-sample", SAMPLE)])
def test_span_metrics_read_in_a_traced_run_on_the_cpu(tiny_root, monkeypatch, cell, names):
    from portbench import run
    from portbench.harness import trace

    monkeypatch.setattr(trace, "Tracer", CpuTracer)
    result, checks = run.run_cell(cell, 2 ** 31 + 11, 0.01, True, device="cpu", root=tiny_root)
    assert result["correct"], checks
    metrics = result["metrics"]
    for name in names:
        assert name in metrics, (name, sorted(metrics))
        v = metrics[name]["value"]
        assert math.isfinite(v) and v > 0, (name, v)


def test_span_metrics_read_nothing_without_the_span_log(tiny_root, monkeypatch):
    """As on a program without the span log, whose ``utils.metrics`` has no
    ``SPANS``: the readers return None, and the run's other metrics are read
    as before."""
    import sys
    import types

    from adv_grpo_torch.utils import metrics as program_metrics
    from portbench import run
    from portbench.harness import trace

    monkeypatch.setattr(trace, "Tracer", CpuTracer)
    older = types.ModuleType(program_metrics.__name__)
    older.__dict__.update({k: v for k, v in vars(program_metrics).items() if k != "SPANS"})
    monkeypatch.setitem(sys.modules, program_metrics.__name__, older)
    result, checks = run.run_cell("tiny-grpo", 5, 0.01, True, device="cpu", root=tiny_root)
    assert result["correct"], checks
    assert not set(GRPO[:4]) & set(result["metrics"])
    assert "rollout_s_per_sample.grpo" in result["metrics"]


@pytest.mark.cuda
def test_the_decode_span_agrees_with_cuda_events_around_the_call(card):
    import torch

    from adv_grpo_torch.models.mmdit import MMDiTConfig
    from adv_grpo_torch.models.vae import VAEConfig
    from adv_grpo_torch.train.pipeline import SD3Pipeline
    from adv_grpo_torch.utils.metrics import SPANS

    # the SD3 VAE at its published widths, decoding two 512^2 images in fp32
    pipe = SD3Pipeline.random_init(torch.Generator(device=card).manual_seed(0),
                                   MMDiTConfig.tiny(), VAEConfig.sd3(), card)
    lat = torch.randn(2, pipe.vae_cfg.latent_channels, 64, 64, device=card)
    pipe.decode(lat)  # built and warm
    outer = []
    for _ in range(3):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(10_000_000)  # the device busy: the events queue behind it
        a.record()
        pipe.decode(lat)
        b.record()
        outer.append((a, b))
    torch.cuda.synchronize(card)
    assert SPANS.poll() == 0
    inner = [s for s in SPANS.spans() if s.name == "decode"][-3:]
    for (a, b), s in zip(outer, inner):
        ms = a.elapsed_time(b)
        assert ms > 20 and abs(s.dev_s * 1e3 - ms) <= 0.01 * ms, (s.dev_s * 1e3, ms)
