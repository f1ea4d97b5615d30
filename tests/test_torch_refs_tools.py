"""The port's reference-set tools and dataset tooling against the JAX package.

  * ``cli.generate_refs``: both CLIs on the tiny SD3 (``smoke_sd3_fast``,
    3 steps, random numpy weights carried by ``from_jax``), node 1 of 2 over
    5 prompts, 2 variations: the same file names and
    ``prompt2img_node1.json`` exactly; the port starts each prompt from the
    latents the JAX CLI draws (``PRNGKey(p_idx)``), and its images are
    within 1 uint8 level of the JAX ones (fp32; a value can round either
    side of a level). A second port run writes no image (the mtimes stay)
    and samples nothing.
  * ``validate_reference_set`` and ``cli.validate_refs``: the same report
    dicts (and the same JSON line and exit code) as the JAX ones on a good
    set and on sets broken in each checked way.
  * ``data.tooling``'s jsonl transforms and the counting-edit builder, run as
    the JAX package's tests/test_misc.py runs them, with the same outputs.
"""

import json
import os

import jax
import numpy as np
import pytest
from PIL import Image

from adv_grpo_torch.cli import common as t_common
from adv_grpo_torch.cli import generate_refs as t_gen
from adv_grpo_torch.cli import infer as t_infer
from adv_grpo_torch.cli import validate_refs as t_validate
from adv_grpo_torch.data import tooling as t_tooling
from adv_grpo_torch.models.mmdit import MMDiTConfig as TMMDiTConfig
from adv_grpo_torch.models.vae import VAEConfig as TVAEConfig
from adv_grpo_torch.train.pipeline import SD3Pipeline as TSD3Pipeline
from adv_grpo_tpu.cli import common as j_common
from adv_grpo_tpu.cli import generate_refs as j_gen
from adv_grpo_tpu.cli import validate_refs as j_validate
from adv_grpo_tpu.data import tooling as j_tooling
from tests.test_torch_models import jax_tiny_pipeline

PROMPTS = ["a red fox", "a blue car", "a bowl of soup", "a tall tower", "two cats"]
NV = 2


@pytest.fixture(scope="module")
def refs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("refs")
    (tmp / "prompts.txt").write_text("\n".join(PROMPTS) + "\n\n")
    jpipe = jax_tiny_pipeline(13)
    tpipe = TSD3Pipeline.from_jax(jpipe.transformer_params, jpipe.vae_params,
                                  TMMDiTConfig.tiny(lora_rank=4, lora_alpha=8.0),
                                  TVAEConfig.tiny(latent_channels=16), "cpu", text_seq_len=6)
    argv = ["--config", "smoke_sd3_fast", "--text_file", str(tmp / "prompts.txt"),
            "--num_variations", str(NV), "--node_rank", "1", "--num_nodes", "2",
            "--latent_hw", "8"]

    def latents(p_idx):
        return np.asarray(jax.random.normal(jax.random.PRNGKey(p_idx), (NV, 16, 8, 8)))

    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(j_common, "build_pipeline", lambda *a, **k: jpipe)
        mp.setattr(t_common, "build_pipeline", lambda *a, **k: tpipe)
        j_gen.main(argv + ["--output_dir", str(tmp / "jax")])
        t_gen.main(argv + ["--output_dir", str(tmp / "port"), "--device", "cpu"],
                   latents=latents)
        pngs = sorted((tmp / "port").glob("*.png"))
        before = {p.name: os.stat(p).st_mtime_ns for p in pngs}
        calls = []
        sample = t_infer.sample_images
        mp.setattr(t_infer, "sample_images", lambda *a, **k: calls.append(1) or sample(*a, **k))
        t_gen.main(argv + ["--output_dir", str(tmp / "port"), "--device", "cpu"],
                   latents=latents)
        after = {p.name: os.stat(p).st_mtime_ns for p in sorted((tmp / "port").glob("*.png"))}
    finally:
        mp.undo()
    return tmp, before, after, calls


def test_generate_refs_names_and_json_equal_jax(refs):
    tmp = refs[0]
    names = sorted(os.listdir(tmp / "port"))
    assert names == sorted(os.listdir(tmp / "jax"))
    assert names == [f"p1_{i:06d}_v{v}.png" for i in range(2) for v in range(NV)] + [
        "prompt2img_node1.json"]
    got, want = (json.loads((tmp / d / "prompt2img_node1.json").read_text())
                 for d in ("port", "jax"))
    assert got == want and list(got) == PROMPTS[3:]


def test_generate_refs_images_match_jax(refs):
    tmp = refs[0]
    for name in sorted(os.listdir(tmp / "jax")):
        if name.endswith(".png"):
            got = np.asarray(Image.open(tmp / "port" / name), np.int16)
            want = np.asarray(Image.open(tmp / "jax" / name), np.int16)
            assert got.shape == (16, 16, 3) and np.abs(got - want).max() <= 1, name


def test_generate_refs_resumes_by_existence(refs):
    _, before, after, calls = refs
    assert len(before) == 2 * NV and after == before and calls == []


def _ref_set(d, n_prompts=3, variations=2, size=40):
    p2f = {}
    for i in range(n_prompts):
        names = [f"p0_{i:06d}_v{v}.png" for v in range(variations)]
        for v, n in enumerate(names):
            Image.new("RGB", (size, size), (i * 10, v * 5, 0)).save(d / n)
        p2f[f"prompt {i}"] = names
    (d / "prompt2img_node0.json").write_text(json.dumps(p2f))
    (d / "train.txt").write_text("".join(f"prompt {i}\n" for i in range(n_prompts)))
    return p2f


def _broken(d, how):
    """A copy of the good set in ``d`` broken one way; returns the JSON shards."""
    p2f = _ref_set(d)
    shards = [str(d / "prompt2img_node0.json")]
    extra = {}
    if how == "missing_file":
        os.remove(d / p2f["prompt 1"][0])
    elif how == "empty_file":
        (d / p2f["prompt 2"][1]).write_bytes(b"")
    elif how == "truncated_file":
        data = (d / p2f["prompt 0"][0]).read_bytes()
        (d / p2f["prompt 0"][0]).write_bytes(data[: len(data) // 2])
    elif how == "duplicate_and_empty":
        extra = {"prompt 1": p2f["prompt 1"], "prompt 9": []}
    elif how == "wrong_count":
        extra = {"prompt 7": p2f["prompt 0"][0]}  # the str (one-variation) form
    elif how == "uncovered":
        (d / "train.txt").write_text("prompt 0\nprompt 5\n")
    elif how == "small":
        pass  # 40 px images under the default 256 floor
    if extra:
        (d / "prompt2img_node1.json").write_text(json.dumps(extra))
        shards.append(str(d / "prompt2img_node1.json"))
    return shards


CASES = ["good", "missing_file", "empty_file", "truncated_file", "duplicate_and_empty",
         "wrong_count", "uncovered", "small"]


@pytest.mark.parametrize("how", CASES)
def test_validate_reference_set_reports_equal_jax(tmp_path, how):
    shards = _broken(tmp_path, how)
    kw = dict(expected_variations=2, prompts_file=str(tmp_path / "train.txt"),
              decode_sample=-1,
              min_resolution=256 if how == "small" else 32)
    got = t_tooling.validate_reference_set(shards, str(tmp_path), **kw)
    want = j_tooling.validate_reference_set(shards, str(tmp_path), **kw)
    assert got == want
    assert got["ok"] == (how == "good")


@pytest.mark.parametrize("how", ["good", "truncated_file", "uncovered"])
def test_validate_refs_cli_equals_jax(tmp_path, capsys, how):
    _broken(tmp_path, how)
    argv = ["--image_dir", str(tmp_path), "--text_file", str(tmp_path / "train.txt"),
            "--num_variations", "2", "--decode_all", "--min_resolution", "32"]
    rc = [t_validate.main(argv)]
    got = capsys.readouterr()
    rc.append(j_validate.main(argv))
    want = capsys.readouterr()
    assert rc[0] == rc[1] == (0 if how == "good" else 1)
    assert got.out == want.out and json.loads(got.out.splitlines()[-1])["ok"] == (how == "good")
    assert got.err == want.err


def test_validate_refs_cli_without_a_shard(tmp_path):
    assert t_validate.main(["--image_dir", str(tmp_path)]) == j_validate.main(
        ["--image_dir", str(tmp_path)]) == 2


def test_counting_edit_builder_equals_jax(tmp_path):
    recs = [{"tag": "counting", "include": [{"class": "cat", "count": 3}],
             "exclude": [{"class": "cat", "count": 4}], "t2i_prompt": "a photo of three cats"},
            {"tag": "counting", "t2i_prompt": "no include"},
            {"tag": "counting", "include": [{"class": "dog", "count": 1}],
             "exclude": [], "t2i_prompt": "a photo of one dog"}]
    meta = tmp_path / "metadata.jsonl"
    meta.write_text("".join(json.dumps(r) + "\n" for r in recs))
    out, calls = {}, {}
    for side, mod in (("t", t_tooling), ("j", j_tooling)):
        calls[side] = []

        def gen(prompt, side=side):
            calls[side].append(prompt)
            return Image.new("RGB", (8, 8), (len(prompt), 0, 0))

        n = mod.build_counting_edit(str(meta), str(tmp_path / f"{side}.jsonl"),
                                    str(tmp_path / f"img_{side}"), gen)
        out[side] = (n, [{**r, "image": os.path.basename(r["image"])}
                         for r in mod.read_jsonl(str(tmp_path / f"{side}.jsonl"))])
    assert out["t"] == out["j"] and out["t"][0] == 6
    assert calls["t"] == calls["j"] == ["a photo of three cats", "a photo of one dog"]
    shipped = t_tooling.read_jsonl("dataset/counting_edit/train_metadata.jsonl")
    assert set(out["t"][1][0]) == set(shipped[0])


def test_split_filter_merge_equal_jax(tmp_path):
    recs = [{"prompt": f"p{i}", "tag": "counting", "ü": "é"} for i in range(20)]
    results = {}
    for side, mod in (("t", t_tooling), ("j", j_tooling)):
        d = tmp_path / side
        d.mkdir()
        src = d / "all.jsonl"
        mod.write_jsonl(str(src), recs)
        split = mod.split_train_test(str(src), str(d / "train.jsonl"), str(d / "test.jsonl"),
                                     test_size=5)
        kept = mod.filter_test_prompts(str(d / "test.jsonl"), str(src),
                                       str(d / "train_filtered.jsonl"))
        counts = mod.merge_weighted_tasks({"a": str(src), "b": str(d / "test.jsonl")},
                                          {"a": 0.5, "b": 0.5}, str(d / "merged.jsonl"),
                                          total_samples=30)
        alloc = [mod.largest_remainder_allocation(w, n) for w, n in
                 (([0.7, 0.3], 10), ([0.7, 0.3, 0.1, 0.5, 0.1], 50000), ([1, 1, 1], 10))]
        files = {name: (d / name).read_bytes() for name in
                 ("all.jsonl", "train.jsonl", "test.jsonl", "train_filtered.jsonl",
                  "merged.jsonl")}
        results[side] = (split, kept, counts, alloc, files)
    assert results["t"] == results["j"]
    assert results["t"][:3] == ((5, 15), 15, {"a": 15, "b": 15})
