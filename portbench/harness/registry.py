"""Find the benchmark's files by name.

Each configuration, model family, workload (cell), per-layer metric and
kernel group is a file of its own; a later change adds a cell, a
configuration, a family, a metric or a kernel name by adding a file, and
edits none:

  configs/<config>.json         sizes of one model configuration as it is run;
                                its "family" names the file below
  families/<family>.py          how a family is built, compared and counted:
                                build, grpo_captured, STAGES and unit_work
  workloads/<cell>.json         the configuration, the entry and its traffic
  metrics/<metric>.py           NAME, UNIT, LAYER, MOVES, SOURCE and read(run)
  kernel_groups/<impl>.json     {"group": ..., "patterns": [...]} kernel names
"""

from __future__ import annotations

import glob
import importlib.util
import json
import os
from typing import Dict, List

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_METRIC_KEYS = ("NAME", "UNIT", "LAYER", "MOVES", "SOURCE", "read")
_FAMILY_KEYS = ("build", "grpo_captured", "STAGES", "unit_work")


def _load(path: str, module_name: str):
    spec = importlib.util.spec_from_file_location(module_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Registry:
    """The benchmark's files under ``root`` (the ``portbench`` folder, or a
    copy of its layout, as the tests make)."""

    def __init__(self, root: str = ROOT):
        self.root = root

    def _json(self, kind: str, name: str) -> dict:
        path = os.path.join(self.root, kind, f"{name}.json")
        if not os.path.isfile(path):
            known = sorted(os.path.basename(p)[:-5]
                           for p in glob.glob(os.path.join(self.root, kind, "*.json")))
            raise KeyError(f"no {kind[:-1]} named {name!r} (known: {known})")
        with open(path) as f:
            data = json.load(f)
        if data.get("name") != name:
            raise ValueError(f"{path} names itself {data.get('name')!r}, not {name!r}")
        return data

    def workload(self, name: str) -> dict:
        return self._json("workloads", name)

    def config(self, name: str) -> dict:
        return self._json("configs", name)

    def workload_names(self) -> List[str]:
        return sorted(os.path.basename(p)[:-5]
                      for p in glob.glob(os.path.join(self.root, "workloads", "*.json")))

    def metrics(self) -> Dict[str, object]:
        """{name: module} of every reader under ``metrics/``."""
        out = {}
        for path in sorted(glob.glob(os.path.join(self.root, "metrics", "*.py"))):
            base = os.path.basename(path)[:-3]
            if base.startswith("_"):
                continue
            mod = _load(path, "portbench_metric_" + base.replace(".", "_").replace("-", "_"))
            missing = [k for k in _METRIC_KEYS if not hasattr(mod, k)]
            if missing or mod.NAME != base:
                raise ValueError(f"{path}: a metric file defines {_METRIC_KEYS} and is named "
                                 f"after NAME (missing {missing}, "
                                 f"NAME {getattr(mod, 'NAME', None)!r})")
            out[base] = mod
        return out

    def family(self, name: str):
        """The module of ``families/<name>.py``."""
        path = os.path.join(self.root, "families", f"{name}.py")
        if not os.path.isfile(path):
            known = sorted(os.path.basename(p)[:-3]
                           for p in glob.glob(os.path.join(self.root, "families", "*.py")))
            raise KeyError(f"no family named {name!r} (known: {known})")
        mod = _load(path, "portbench_family_" + name.replace(".", "_").replace("-", "_"))
        missing = [k for k in _FAMILY_KEYS if not hasattr(mod, k)]
        if missing:
            raise ValueError(f"{path}: a family file defines {_FAMILY_KEYS} (missing {missing})")
        return mod

    def kernel_groups(self) -> List[dict]:
        """Every kernel-group file: {"group", "patterns", "name"}; a kernel
        belongs to the first file, in name order, one of whose patterns is a
        substring of its name."""
        groups = []
        for path in sorted(glob.glob(os.path.join(self.root, "kernel_groups", "*.json"))):
            with open(path) as f:
                g = json.load(f)
            g["name"] = os.path.basename(path)[:-5]
            if not isinstance(g.get("group"), str) or not g.get("patterns"):
                raise ValueError(f"{path}: needs a 'group' and a list of 'patterns'")
            groups.append(g)
        return groups
