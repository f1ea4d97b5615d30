"""Readings from which a cell's limits are set: the program's numbers and
the control's, on several seeds, one build a seed, in one process.

    python3 -m portbench.control --workload <cell> --seeds 11,12,13 [--control-seeds 11,12]

For each seed it builds the cell and runs its set-up (the warm-up units the
comparison reads; a sampling cell also one window batch, which its
comparison reads), then prints one JSON line: the program's numbers against
the fp32 reference (``program``) and whether they pass the cell's limits
(``program_correct``), by the rule of the benchmark's own runs (every number
at most its limit). For the seeds of ``--control-seeds`` it also puts the
control in the program's place (the reference in the next precision down:
fp8 products in the transformer, TF32 in the VAE and the reward towers) and
prints its numbers (``control``) and its verdict (``control_correct``), which
has to be false. The benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time


def readings(workload: str, seed: int, control: bool, device="cuda", root=None) -> dict:
    import torch

    from portbench.harness import checks, entries, registry

    reg = registry.Registry(root) if root else registry.Registry()
    run = entries.make_run(reg, workload, seed, 0.0, False, device, time.perf_counter(),
                           window=False)
    entries.ENTRIES[run.entry](run, None)
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    out = {"workload": workload, "seed": int(seed)}
    limits = run.workload["check"]["limits"]
    for side, values in checks.readings(run, control).items():
        out[side] = values
        out[f"{side}_correct"] = checks.verdict(values, limits)[0]
    return out


def _seeds(text: str):
    return [int(s) for s in text.split(",") if s.strip()]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("portbench.control: no CUDA device", file=sys.stderr)
        return 2
    with_control = set(_seeds(args.control_seeds))
    seeds = _seeds(args.seeds)
    for s in seeds + sorted(with_control - set(seeds)):
        t0 = time.perf_counter()
        out = readings(args.workload, s, s in with_control)
        out["seconds"] = time.perf_counter() - t0
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
