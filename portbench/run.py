"""Run one cell of the benchmark once and print its result line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with the cell's NVIDIA card. The
last line of standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics with ``--trace 0``, its
per-layer metrics with ``--trace 1``), ``device`` (with ``--trace 1`` also
``busy_s`` and ``window_s``), with ``--trace 1`` a ``breakdown``, and last
``checks``: each number compared, with its limit. Without a CUDA device, or
with JAX or the JAX package loaded once the window has closed, it prints no
result and exits non-zero.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "adv_grpo_tpu")
RATE = {"grpo_epoch": ("grpo_samples_per_s", "samples/s"),
        "sample_batch": ("sample_images_per_s", "images/s")}
CACHE = ".portbench_cache"


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".", 1)[0] for m in sys.modules} & set(FORBIDDEN))


def _env():
    """Every cache a run could write stays at a fixed path in the checkout."""
    root = os.path.abspath(CACHE)
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ.setdefault(var, os.path.join(root, sub))
    os.environ.setdefault("USE_FLAX", "0")


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device="cuda",
             root=None, t_start=None):
    """Run one cell; returns (result dict, the checks {name: (value, limit)}).
    ``device`` "cpu" and ``root`` (a copy of the benchmark's layout) serve
    the CPU tests, which skip the look for a card."""
    import torch

    from portbench.harness import checks as checks_mod
    from portbench.harness import entries, registry
    from portbench.harness.trace import Tracer

    reg = registry.Registry(root) if root else registry.Registry()
    run = entries.make_run(reg, workload, seed, seconds, trace, device,
                           T_START if t_start is None else t_start)
    wl, dev = run.workload, run.device
    tracer = Tracer(dev, reg.kernel_groups()) if trace else None
    entries.ENTRIES[wl["entry"]](run, tracer)
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    values = checks_mod.check(run)
    print(f"portbench: the comparison took {time.perf_counter() - t_check:.1f} s after a "
          f"{run.window_s:.1f}-s window of {len(run.units)} units of "
          f"{[round(u['t1'] - u['t0'], 3) for u in run.units]} s", file=sys.stderr)
    limits = wl["check"]["limits"]
    correct, checks = checks_mod.verdict(values, limits)
    for k in sorted(set(values) - set(limits)):
        print(f"portbench: {k} read {values[k]!r}, not compared (no upper reading)",
              file=sys.stderr)

    metrics = {}
    if trace:
        for name, mod in reg.metrics().items():
            v = mod.read(run)
            if v is not None:
                metrics[name] = {"value": float(v), "unit": mod.UNIT}
    else:
        rate, unit = RATE[wl["entry"]]
        n = sum(u["samples"] for u in run.units)
        metrics[rate] = {"value": n / run.window_s, "unit": unit}
        metrics["peak_mem_gib"] = {"value": run.window_peak_bytes / 2 ** 30, "unit": "GiB"}
        metrics["setup_s"] = {"value": run.setup_s, "unit": "s"}
    result = {"correct": bool(correct), "attempted": len(run.units), "failed": 0,
              "metrics": metrics, "device": device_info(dev, run)}
    t = run.trace_summary
    if trace and t and "discarded" not in t:
        result["device"].update(busy_s=t["busy_s"], window_s=t["window_s"])
        result["breakdown"] = {"device_ops": t["device_ops"], "idle_gaps": t["idle_gaps"]}
    elif trace:
        print(f"trace not read: {t}", file=sys.stderr)
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    return result, checks


def device_info(dev, run) -> dict:
    import torch

    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": int(run.peak_bytes)}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev), "count": 1,
            "memory_peak_bytes": int(run.peak_bytes), "power_limit": _power_limit()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _env()

    import torch

    from portbench.harness import registry

    chips = 1
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print("portbench: no CUDA device (the benchmark measures the card and does not fall "
              "back to the CPU)", file=sys.stderr)
        return 2
    registry.Registry().workload(args.workload)  # an unknown cell fails before any work
    result, checks = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {bad}; the benchmark measures the PyTorch port "
              "alone", file=sys.stderr)
        return 3
    for k, (v, lim) in checks.items():
        print(f"check {k}: {v!r} (limit {lim!r})", file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(result))
    sys.stdout.flush()
    return 0


def _power_limit() -> str:
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip() or "not read"
    except (OSError, subprocess.TimeoutExpired):
        return "not read"


if __name__ == "__main__":
    sys.exit(main())
