"""Metric logging and per-phase step timers.

The port's own copy of ``MetricLogger`` and ``StepTimer`` from
adv_grpo_tpu/utils/metrics.py: the logger appends one JSON record per call to
``{save_dir}/metrics.jsonl``, mirrors scalars to wandb when it is importable
and enabled, and writes image-grid strips beside the log; the timer
accumulates wall-clock per named phase.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Any, Dict, Optional

import numpy as np


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


class StepTimer:
    """Per-phase wall-clock accumulation: ``with timer('rollout'): ...``."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def __call__(self, phase: str):
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
