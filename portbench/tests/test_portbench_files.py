"""The benchmark finds every file by name, BENCHMARK.json agrees with the
files, and a cell, a metric or a kernel-group name added as a file is picked
up with no edit."""

from __future__ import annotations

import json
import os
import re
import shutil

from portbench.harness.registry import Registry
from portbench.tests.conftest import REPO

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def _bench():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        return json.load(f)


def test_every_file_is_found_by_name():
    reg, b = Registry(), _bench()
    for c in b["configs"]:
        cfg = reg.config(c["name"])
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        assert sorted(c["reduced"]) == sorted(cfg["reduced"])
        assert cfg["source"] == c["source"]
    for w in b["workloads"]:
        wl = reg.workload(w["name"])
        assert wl["config"] == w["config"] and w["chips"] == 1
        assert set(wl["check"]["limits"]), w["name"]
    metrics = reg.metrics()
    for m in b["per_layer"]:
        mod = metrics[m["name"]]
        assert (mod.UNIT, mod.LAYER, mod.MOVES, mod.SOURCE, mod.BETTER) == (
            m["unit"], m["layer"], m["moves"], m["source"], m["better"])
    assert {m["name"] for m in b["per_layer"]} == set(metrics)
    assert reg.kernel_groups()


def test_benchmark_json_keeps_the_contract():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert [e["name"] for e in b["end_to_end"]] == [
        "grpo_samples_per_s", "sample_images_per_s", "peak_mem_gib", "setup_s"]
    e2e = {e["name"]: e for e in b["end_to_end"]}
    cells = {w["name"]: w for w in b["workloads"]}
    for group in (b["configs"], b["workloads"], b["end_to_end"], b["per_layer"]):
        for x in group:
            assert NAME.match(x["name"]), x["name"]
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in b["per_layer"]:
        assert m["moves"] in e2e
        for w in m["workloads"]:
            assert w in cells
            assert w in e2e[m["moves"]].get("workloads", cells), (m["name"], w)
    assert e2e["setup_s"]["bound"] <= 0.25
    assert all(0.01 <= e["bound"] <= 0.25 for e in b["end_to_end"])
    for p in b["paths"]:
        assert os.path.isdir(os.path.join(REPO, p))


def test_a_cell_added_as_a_file_is_picked_up(tiny_root):
    from portbench import run

    src = os.path.join(tiny_root, "workloads", "tiny-sample.json")
    with open(src) as f:
        wl = json.load(f)
    wl["name"] = "tiny-sample-2"
    wl["prompts"]["batch"] = 2
    with open(os.path.join(tiny_root, "workloads", "tiny-sample-2.json"), "w") as f:
        json.dump(wl, f)
    assert "tiny-sample-2" in Registry(tiny_root).workload_names()
    result, _ = run.run_cell("tiny-sample-2", 7, 0.0, False, device="cpu", root=tiny_root)
    assert result["correct"] and result["metrics"]["sample_images_per_s"]["value"] > 0


def test_a_metric_and_a_kernel_group_added_as_files_are_picked_up(tiny_root):
    with open(os.path.join(tiny_root, "metrics", "units_done.py"), "w") as f:
        f.write('NAME = "units_done"\nUNIT = "units"\nLAYER = "trainer"\n'
                'MOVES = "grpo_samples_per_s"\nSOURCE = "host_clock"\nBETTER = "higher"\n\n\n'
                'def read(run):\n    return len(run.units) or None\n')
    shutil.copy(os.path.join(tiny_root, "kernel_groups", "10_attention_wgmma.json"),
                os.path.join(tiny_root, "kernel_groups", "12_attention_new.json"))
    with open(os.path.join(tiny_root, "kernel_groups", "12_attention_new.json"), "w") as f:
        json.dump({"group": "attention", "patterns": ["my_new_attention_kernel"]}, f)
    reg = Registry(tiny_root)
    assert "units_done" in reg.metrics()
    from portbench.harness.trace import Tracer

    t = Tracer("cpu", reg.kernel_groups())
    assert t.group_of("void my_new_attention_kernel<64>(Params)") == "attention"
    assert t.group_of("void attn_fwd_sm90_kernel<64, 1>(P)") == "attention"
    assert t.group_of("ampere_sgemm_128x64_nn") == "gemm"
    assert t.group_of("something_else") == "other"


def test_an_unknown_cell_is_refused():
    import pytest

    with pytest.raises(KeyError):
        Registry().workload("no-such-cell")


def _add_tiny_wan(root, config_name, cell_name, **changes):
    """A copy of the tiny WAN configuration and its cell, added as files."""
    with open(os.path.join(root, "configs", "wan-tiny.json")) as f:
        cfg = json.load(f)
    cfg.update(changes, name=config_name)
    with open(os.path.join(root, "configs", f"{config_name}.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(root, "workloads", "tiny-wan.json")) as f:
        wl = json.load(f)
    wl.update(name=cell_name, config=config_name)
    with open(os.path.join(root, "workloads", f"{cell_name}.json"), "w") as f:
        json.dump(wl, f)
    return cfg


def test_a_wan_config_of_other_widths_added_as_a_file_runs(tiny_root):
    from portbench import run

    vae = dict(_add_tiny_wan(tiny_root, "wan-other", "tiny-wan-other")["vae"], base_dim=12)
    # every width of the transformer and the VAE differs from the tiny WAN's
    _add_tiny_wan(tiny_root, "wan-other", "tiny-wan-other", num_attention_heads=4,
                  attention_head_dim=8, ffn_dim=48, num_layers=1, rope_axes_dims=[4, 2, 2],
                  vae=vae)
    result, checks = run.run_cell("tiny-wan-other", 2 ** 32 + 3, 0.0, False, device="cpu",
                                  root=tiny_root)
    assert result["correct"], checks


def test_a_family_added_as_a_file_is_picked_up(tiny_root):
    from portbench import run
    from portbench.harness import entries

    shutil.copy(os.path.join(tiny_root, "families", "wan.py"),
                os.path.join(tiny_root, "families", "wan_copy.py"))
    _add_tiny_wan(tiny_root, "wan-copy", "tiny-wan-copy", family="wan_copy")
    r = entries.make_run(Registry(tiny_root), "tiny-wan-copy", 1, 0.0, False, "cpu", 0.0)
    assert r.family.__file__.endswith(os.path.join("families", "wan_copy.py"))
    result, checks = run.run_cell("tiny-wan-copy", 9, 0.0, False, device="cpu", root=tiny_root)
    assert result["correct"], checks
