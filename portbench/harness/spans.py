"""What the readers of the program's own span log share.

The port records its spans in ``adv_grpo_torch.utils.metrics.SPANS``: the
roots ``epoch`` (a ``GRPOTrainer.run`` epoch) and ``sample_images`` (a
``cli.infer.sample_images`` call), and inside them ``denoise``, ``decode``,
``optimizer`` (device spans, timed by CUDA events) and ``reward`` (the reward
thread's own host time, linked to its epoch by its cause). A reader sums the
outermost spans of one name whose root lies in an untraced unit of the
window (or, with ``traced``, in any unit of it). It reads nothing (None) from a program without the log, where the
ring no longer holds the window's first unit, where no such span was
recorded, or where one of its events is still pending."""

from __future__ import annotations

from typing import Optional


def _log():
    try:
        from adv_grpo_torch.utils.metrics import SPANS
    except ImportError:  # a program without the span log
        return None
    return SPANS


def span_sum(run, entry: str, root: str, name: str, per: str = "sample",
             traced: bool = False) -> Optional[float]:
    """Seconds of the outermost ``name`` spans under the ``root`` spans of
    the window's untraced units (all its units with ``traced``): a device
    span's device time, a host span's host time; per sample of those units
    (``per="sample"``) or per row the spans themselves worked on
    (``per="rows"``)."""
    if run.entry != entry or not run.units:
        return None
    log = _log()
    if log is None:
        return None
    spans = log.spans()
    if log.lost_until >= run.units[0]["t0"]:
        return None
    units = [u for u in run.units if traced or not u.get("traced")]

    def unit_of(s):
        return next((k for k, u in enumerate(units) if u["t0"] <= s.t0 and s.t1 <= u["t1"]),
                    None)

    roots = {s.id: unit_of(s) for s in spans if s.name == root and s.root == s.id}
    roots = {r: k for r, k in roots.items() if k is not None}
    by_id = {s.id: s for s in spans}

    def outermost(s):
        p = by_id.get(s.parent)
        while p is not None:
            if p.name == s.name:
                return False
            p = by_id.get(p.parent)
        return True

    picked = [s for s in spans if s.name == name and s.root in roots and outermost(s)]
    if not picked or any(s.pending for s in picked):
        return None
    total = sum(s.dev_s if s.device else s.t1 - s.t0 for s in picked)
    if per == "rows":
        rows = sum(s.rows or 0 for s in picked)
        return total / rows if rows else None
    samples = sum(units[k]["samples"] for k in set(roots.values()))
    return total / samples if samples else None
