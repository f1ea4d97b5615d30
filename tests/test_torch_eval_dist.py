"""The port's batch eval over two gloo ranks on the CPU (the tiny SD3 of
``smoke_sd3_fast``, 3 steps, ``--batch 2 --rewards --latent_hw 8``).

The ranks are subprocesses of this file (``python tests/test_torch_eval_dist.py
--rank R --world N ...``; torch and the port only), joined by a file store, one
thread each. The two ranks evaluate, in one group, 5 prompts (shards of 3 and
2: rank 1's second batch is all padding) and then 1 prompt (rank 1's shard is
empty and generates from ""). A one-rank group then evaluates each shard of
the 5 alone. Checked: the shards are disjoint and cover the prompts; the
merged ``prompt2img.json`` has every prompt once and no file twice; both ranks
report the same means and counts (5; then 1), with the same reward keys;
each rank's PNGs are bitwise the one-rank run's over its shard alone.
"""

import argparse
import json
import os
import sys

import numpy as np
import pytest
from PIL import Image

from test_torch_ring import run_ranks

PROMPTS = ["a red fox", "a blue car", "a bowl of soup", "a tall tower", "two cats"]
ARGV = ["--config", "smoke_sd3_fast", "--device", "cpu", "--batch", "2", "--rewards",
        "--latent_hw", "8"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("eval_dist")
    groups = {"five": "g2", "one": "g2", "shard0": "g1", "shard1": "g1"}
    for name, prompts in (("five", PROMPTS), ("one", PROMPTS[:1]), ("shard0", PROMPTS[:3]),
                          ("shard1", PROMPTS[3:])):
        (tmp / groups[name] / name).mkdir(parents=True)
        (tmp / groups[name] / name / "test.txt").write_text("\n".join(prompts) + "\n")
    run_ranks(2, tmp / "g2", os.path.abspath(__file__), ("--cases", "five,one"))
    run_ranks(1, tmp / "g1", os.path.abspath(__file__), ("--cases", "shard0,shard1"))
    for name, group in groups.items():  # each case's directory under tmp
        os.rename(tmp / group / name, tmp / name)
        os.rename(tmp / group / f"{name}_summaries", tmp / f"{name}_summaries")

    def summary(case, rank):
        with open(tmp / f"{case}_summaries" / f"rank{rank}.json") as f:
            return json.load(f)

    return tmp, summary


def _pngs(d):
    return sorted(f for f in os.listdir(d) if f.endswith(".png"))


def test_shards_are_disjoint_and_cover_the_prompts(runs):
    tmp, summary = runs
    out = tmp / "five" / "out"
    assert _pngs(out) == [f"node0_rank0_{i:05d}_0.png" for i in range(3)] + [
        f"node0_rank1_{i:05d}_0.png" for i in (3, 4)]
    assert [summary("five", r)["n_saved"] for r in (0, 1)] == [3, 2]
    shards = [json.loads((out / f"prompt2img_rank{r}.json").read_text()) for r in (0, 1)]
    assert not set(shards[0]) & set(shards[1])
    with open(out / "prompt2img.json") as f:
        merged = json.load(f)
    assert list(merged) == PROMPTS
    files = [f for v in merged.values() for f in v]
    assert len(files) == len(set(files)) == 5 and sorted(files) == _pngs(out)


def test_both_ranks_report_the_same_means(runs):
    _, summary = runs
    for case, n in (("five", 5), ("one", 1)):
        a, b = summary(case, 0), summary(case, 1)
        assert a["reward_counts"] == b["reward_counts"] == {"avg": n, "jpeg_compressibility": n}
        assert a["reward_means"] == b["reward_means"]
        assert all(np.isfinite(v) for v in a["reward_means"].values())


def test_one_prompt_over_two_ranks_finishes(runs):
    tmp, summary = runs
    assert [summary("one", r)["n_saved"] for r in (0, 1)] == [1, 0]
    assert set(summary("one", 0)["reward_means"]) == set(summary("one", 1)["reward_means"])
    assert _pngs(tmp / "one" / "out") == ["node0_rank0_00000_0.png"]
    with open(tmp / "one" / "out" / "prompt2img.json") as f:
        assert json.load(f) == {PROMPTS[0]: ["node0_rank0_00000_0.png"]}
    assert json.loads((tmp / "one" / "out" / "prompt2img_rank1.json").read_text()) == {}


def test_each_rank_equals_a_one_rank_run_over_its_shard(runs):
    tmp, _ = runs
    pairs = [(f"node0_rank0_{i:05d}_0.png", "shard0", f"node0_rank0_{i:05d}_0.png")
             for i in range(3)]
    pairs += [(f"node0_rank1_{i:05d}_0.png", "shard1", f"node0_rank0_{i - 3:05d}_0.png")
              for i in (3, 4)]
    for name, shard, alone in pairs:
        got = np.asarray(Image.open(tmp / "five" / "out" / name))
        want = np.asarray(Image.open(tmp / shard / "out" / alone))
        np.testing.assert_array_equal(got, want, err_msg=name)


def _rank_main(args):
    from adv_grpo_torch.cli import eval as t_eval
    from adv_grpo_torch.parallel import mesh
    from test_torch_ring import RANK_TIMEOUT_S

    mesh.init_distributed("gloo", init_method=f"file://{args.store}", world_size=args.world,
                          rank=args.rank, timeout_s=RANK_TIMEOUT_S)
    for case in args.cases.split(","):
        root = os.path.join(args.dir, case)
        out = t_eval.main(ARGV + ["--out_dir", os.path.join(root, "out"),
                                  "--set", f"dataset={root}"])
        os.makedirs(os.path.join(args.dir, f"{case}_summaries"), exist_ok=True)
        with open(os.path.join(args.dir, f"{case}_summaries", f"rank{args.rank}.json"),
                  "w") as f:
            json.dump(out, f)
    import torch

    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    ap = argparse.ArgumentParser()
    for flag in ("--rank", "--world"):
        ap.add_argument(flag, type=int, required=True)
    ap.add_argument("--store", required=True)
    ap.add_argument("--dir", required=True)
    ap.add_argument("--cases", required=True)
    _rank_main(ap.parse_args())
