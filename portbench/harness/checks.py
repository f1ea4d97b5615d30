"""The comparison that decides ``correct``: the run's family module gives,
for its entry, (plan, program, reference, numbers) — the rows drawn from the
seed, the program's outputs, the reference's (in fp32, or one precision down
for the control) and the numbers that set them side by side; ``verdict``
holds those numbers to the cell's limits, by one rule for the benchmark's
runs, the control and the planted faults."""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch

from portbench.reference import Precision
from portbench.reference.sd3 import image_rel_l2


def trainer_seed(*parts) -> int:
    """The trainer's per-batch noise seed (``train/driver.py::_seed``)."""
    return int(np.random.SeedSequence([int(p) for p in parts]).generate_state(1)[0])


def rel(a, b) -> float:
    """Worst over rows of ||a - b|| / ||b||."""
    return image_rel_l2(a, b)


def empty_cache(dev):
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def readings(run, control: bool = False) -> dict:
    """{"program": numbers} and, with ``control``, {"control": numbers}: the
    program's outputs and the control's, each against the fp32 reference."""
    plan, program, reference, numbers = run.family.STAGES[run.entry]
    p = plan(run)
    ref = reference(run, p)
    out = {"program": numbers(program(run, p), ref)}
    if control:
        ctl = reference(run, p, Precision(control=True))
        out["control"] = numbers({k: (v.cpu() if torch.is_tensor(v) else v)
                                  for k, v in ctl.items()}, ref)
    return out


def check(run) -> dict:
    return readings(run)["program"]


def verdict(values: Dict[str, float], limits: Dict[str, float]
            ) -> Tuple[bool, Dict[str, Tuple[float, float]]]:
    """(correct, {name: (value, limit)}): correct where every compared
    number is finite and at most its limit."""
    checks = {k: (float(values[k]), float(limits[k])) for k in limits}
    return all(math.isfinite(v) and v <= lim for v, lim in checks.values()), checks
