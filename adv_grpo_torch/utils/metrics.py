"""Metric logging, per-phase step timers and the span log.

The port's own copy of ``MetricLogger`` and ``StepTimer`` from
adv_grpo_tpu/utils/metrics.py: the logger appends one JSON record per call to
``{save_dir}/metrics.jsonl``, mirrors scalars to wandb when it is importable
and enabled, and writes image-grid strips beside the log; the timer
accumulates wall-clock per named phase.

``SPANS`` is the process's span log and ``span(name, device=..., rows=...)``
records one span into it: where the work happens (an epoch, a rollout's
denoising, a decode, the reward thread, the optimizer), with its parent, its
root and, for work handed to another thread, its cause. A device span also
times the work it enqueued with a pair of CUDA events on the current stream,
read once they have completed (never waited on) and placed on the host's
``perf_counter`` clock through an anchor event recorded right after a
synchronise. The log keeps the newest ``SPAN_RING`` spans.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import itertools
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch


def _to_scalar(v):
    if isinstance(v, (int, float, str, bool)) or v is None:
        return v
    arr = np.asarray(v)
    if arr.size == 1:
        return float(arr)
    return arr.tolist()


class MetricLogger:
    def __init__(self, save_dir: str = "", wandb_init: bool = False,
                 project: str = "adv_grpo_tpu", run_name: str = "", is_main: bool = True):
        self.is_main = is_main
        self.path = None
        self._wandb = None
        if not is_main:
            return
        if save_dir:
            os.makedirs(save_dir, exist_ok=True)
            self.path = os.path.join(save_dir, "metrics.jsonl")
        if wandb_init:
            try:
                import wandb

                wandb.init(project=project, name=run_name or None)
                self._wandb = wandb
            except Exception:  # noqa: BLE001 — logging to wandb is optional
                self._wandb = None

    def log(self, metrics: Dict[str, Any], step: Optional[int] = None):
        if not self.is_main:
            return
        record = {k: _to_scalar(v) for k, v in metrics.items()}
        if step is not None:
            record["step"] = int(step)
        record["time"] = time.time()
        if self.path:
            with open(self.path, "a") as f:
                f.write(json.dumps(record) + "\n")
        if self._wandb is not None:
            self._wandb.log({k: v for k, v in record.items() if isinstance(v, (int, float))},
                            step=step)

    def log_image_grid(self, name: str, images_u8, captions=None,
                       step: Optional[int] = None, save_dir: str = ""):
        """A horizontal JPEG strip of up to 8 images on disk and, when wandb
        is live, captioned wandb.Images; returns the strip's path or None."""
        if not self.is_main or len(images_u8) == 0:
            return None
        imgs = np.asarray(images_u8)[:8]
        path = None
        out_dir = save_dir or (os.path.dirname(self.path) if self.path else "")
        if out_dir:
            try:
                from PIL import Image

                n, h, w, _ = imgs.shape
                grid = imgs.transpose(1, 0, 2, 3).reshape(h, n * w, 3)
                os.makedirs(out_dir, exist_ok=True)
                path = os.path.join(out_dir, f"{name}_{step or 0:05d}.jpg")
                Image.fromarray(grid).save(path, quality=90)
            except Exception:  # noqa: BLE001 — the grid is best-effort observability
                path = None
        if self._wandb is not None:
            try:
                wb = [self._wandb.Image(img, caption=None if captions is None
                                        else str(captions[i]))
                      for i, img in enumerate(imgs)]
                self._wandb.log({name: wb}, step=step)
            except Exception:  # noqa: BLE001
                pass
        return path


SPAN_RING = 4096
_EVENT_POOL = 64  # timing events kept for reuse once read; also the pending
# device spans a close lets build up before it reads them


@dataclasses.dataclass(eq=False)
class Span:
    """One span of the log. ``parent`` is the innermost span open on the same
    thread when it opened, ``root`` the outermost span of that chain (or of
    its cause's), ``cause`` the span open on the thread that handed the work
    over. Host times are ``perf_counter`` seconds; a device span's
    ``dev_t0`` / ``dev_t1`` place its device work on the same clock, and
    stay None while its events are pending."""

    name: str
    id: int
    parent: Optional[int]
    root: int
    cause: Optional[int]
    thread: int
    t0: float
    t1: Optional[float] = None
    rows: Optional[int] = None
    device: bool = False
    dev_t0: Optional[float] = None
    dev_t1: Optional[float] = None
    dev_s: Optional[float] = None
    _events: Optional[tuple] = dataclasses.field(default=None, repr=False)

    @property
    def pending(self) -> bool:
        return self._events is not None


def _cuda_device(device) -> Optional[torch.device]:
    """The CUDA device whose work a device span times, or None: a host span
    (False), work on the CPU, or True before CUDA is in use."""
    if device is None or device is False:
        return None
    if device is True:
        if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
            return None
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return device if device.index is not None else torch.device(
        "cuda", torch.cuda.current_device())


class SpanLog:
    """The process's spans, in a ring of the newest ``size``; thread-safe."""

    def __init__(self, size: int = SPAN_RING):
        self.size = size
        self.lost_until = float("-inf")  # close time of the newest span let go
        self._ring: collections.deque = collections.deque()
        self._pending: collections.deque = collections.deque()
        self._anchors: Dict[int, tuple] = {}  # device index -> (event, host time)
        self._free: Dict[int, list] = {}  # device index -> read events, for reuse
        self._lock = threading.Lock()
        self._local = threading.local()
        self._ids = itertools.count(1)

    def _stack(self) -> List[Span]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def current(self) -> Optional[Span]:
        """The innermost span open on the calling thread."""
        stack = self._stack()
        return stack[-1] if stack else None

    def anchor(self, device=True) -> None:
        """Ties ``device``'s event clock to the host clock anew. Call it only
        right after a synchronise of that device: the event recorded here
        then runs at once, at the host time taken beside it."""
        dev = _cuda_device(device)
        if dev is None:
            return
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(dev))
        self._anchors[dev.index] = (ev, time.perf_counter())

    def _event(self, dev: torch.device):
        """A timing event recorded now on ``dev``'s current stream."""
        with self._lock:
            free = self._free.get(dev.index)
            ev = free.pop() if free else None
        if ev is None:
            ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(dev))
        return ev

    def open(self, name: str, device=False, rows: Optional[int] = None,
             cause: Optional[Span] = None) -> Span:
        stack = self._stack()
        parent = stack[-1] if stack else None
        sid = next(self._ids)
        root = parent.root if parent is not None else (cause.root if cause is not None
                                                       else sid)
        s = Span(name, sid, None if parent is None else parent.id, root,
                 None if cause is None else cause.id, threading.get_ident(), 0.0,
                 rows=None if rows is None else int(rows), device=device is not False)
        dev = _cuda_device(device)
        if dev is not None:
            if dev.index not in self._anchors:
                # the one synchronise the log makes: once per device, at its
                # first device span, where no anchor exists yet
                torch.cuda.synchronize(dev)
                self.anchor(dev)
            s._events = (dev, self._event(dev), self._anchors[dev.index])
        stack.append(s)
        s.t0 = time.perf_counter()
        return s

    def close(self, s: Span) -> None:
        s.t1 = time.perf_counter()
        stack = self._stack()
        if stack and stack[-1] is s:
            stack.pop()
        elif s in stack:
            stack.remove(s)
        if s._events is not None:
            dev, start, anchor = s._events
            s._events = (dev, start, self._event(dev), anchor)
        elif s.device:  # work on the CPU runs as the host calls it
            s.dev_t0, s.dev_t1, s.dev_s = s.t0, s.t1, s.t1 - s.t0
        with self._lock:
            if len(self._ring) >= self.size:
                self.lost_until = self._ring.popleft().t1
            self._ring.append(s)
            if s._events is not None:
                self._pending.append(s)
            full = len(self._pending) >= _EVENT_POOL // 2
        if full:
            self.poll()

    def poll(self) -> int:
        """Reads the device spans whose end events have completed, in the
        order they closed, and releases their events; returns the number
        still pending. Never waits."""
        with self._lock:
            while self._pending:
                s = self._pending[0]
                dev, start, end, (anchor, host) = s._events
                if not end.query():
                    break
                s.dev_s = start.elapsed_time(end) * 1e-3
                s.dev_t0 = host + anchor.elapsed_time(start) * 1e-3
                s.dev_t1 = s.dev_t0 + s.dev_s
                s._events = None
                self._pending.popleft()
                free = self._free.setdefault(dev.index, [])
                if len(free) < _EVENT_POOL:
                    free.extend((start, end))
            return len(self._pending)

    def spans(self) -> List[Span]:
        """The spans the ring keeps, oldest closed first, after a poll."""
        self.poll()
        with self._lock:
            return list(self._ring)


SPANS = SpanLog()


@contextlib.contextmanager
def span(name: str, device: Union[bool, str, torch.device] = False, rows: Optional[int] = None,
         cause: Optional[Span] = None):
    """``with span("decode", device=latents.device, rows=n): ...`` records one
    span of ``SPANS``. ``device``: False for host work; True (the current
    CUDA device, once CUDA is in use) or a device for work enqueued there,
    timed by CUDA events on a CUDA device and by the host clock on the CPU.
    ``cause``: the span that handed this work to the thread
    (``SPANS.current()`` on the submitting thread)."""
    s = SPANS.open(name, device, rows, cause)
    try:
        yield s
    finally:
        SPANS.close(s)


class StepTimer:
    """Per-phase wall-clock accumulation: ``with timer('rollout'): ...``;
    each phase is also a span of ``SPANS``."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def __call__(self, phase: str):
        with span(phase):
            t0 = time.perf_counter()
            try:
                yield
            finally:
                dt = time.perf_counter() - t0
                self.totals[phase] = self.totals.get(phase, 0.0) + dt
                self.counts[phase] = self.counts.get(phase, 0) + 1

    def summary(self) -> Dict[str, float]:
        return {f"time/{k}": self.totals[k] / max(self.counts[k], 1) for k in self.totals}

    def reset(self):
        self.totals.clear()
        self.counts.clear()
