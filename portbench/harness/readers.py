"""What the metric readers share: sums over the window's units, the
trainer's spans inside them, the decode's CUDA-event times and the traced
unit's work (counted by the run's family) against the chip's peaks."""

from __future__ import annotations

from typing import Optional

from portbench.harness.work import PEAK_FLOPS, attention_min_s


def samples(run) -> int:
    return sum(u["samples"] for u in run.units)


def span_s_per_sample(run, name: str, entry: str) -> Optional[float]:
    """The trainer's ``time/<name>`` summed over the window, per sample."""
    if run.entry != entry or not run.units:
        return None
    t0, t1 = run.units[0]["t0"], run.units[-1]["t1"]
    total = sum(b - a for n, a, b in run.spans if n == name and a >= t0 - 1e-3 and b <= t1 + 1e-3)
    return total / samples(run) if total > 0 else None


def decode_ms_per_sample(run, entry: str) -> Optional[float]:
    if run.entry != entry or not run.decode_ms:
        return None
    return sum(ms for ms, _ in run.decode_ms) / sum(n for _, n in run.decode_ms)


def mfu(run, entry: str) -> Optional[float]:
    """Transformer FLOPs of the window's untraced units over their seconds,
    as a share (%) of the bf16 dense peak."""
    if run.entry != entry:
        return None
    units = [u for u in run.units if not u.get("traced")]
    secs = sum(u["t1"] - u["t0"] for u in units)
    if not units or secs <= 0:
        return None
    flops = run.family.unit_work(run)["flops"] * len(units)
    return 100.0 * flops / secs / PEAK_FLOPS["bfloat16"]


def trace(run, entry: str) -> Optional[dict]:
    t = run.trace_summary
    if run.entry != entry or not t or "discarded" in t:
        return None
    return t


def attn_roofline(run, entry: str) -> Optional[float]:
    """The least time the traced unit's attention needs, over the device
    time of the attention kernel groups in it (%)."""
    t = trace(run, entry)
    if t is None or t["group_s"].get("attention", 0.0) <= 0:
        return None
    least = attention_min_s(run.family.unit_work(run)["attention"])
    return 100.0 * least / t["group_s"]["attention"]


def idle_share(run, entry: str) -> Optional[float]:
    t = trace(run, entry)
    if t is None or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
