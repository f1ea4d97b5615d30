"""Dataset preparation tooling, the port's copy of adv_grpo_tpu/data/tooling.py.

The reference's dataset scripts (dataset/counting_edit/process_data.py +
split_train_test.py, dataset/geneval_filter_test.py,
dataset/merge_genevaltask.py) as plain Python: the counting-edit set builder
takes any ``generate_fn(prompt) -> PIL.Image`` (the reference hardcodes a
CUDA Flux pipeline), the rest are jsonl transforms; ``validate_reference_set``
certifies a reference-image set before a co-train run
(``cli.validate_refs``).
"""

from __future__ import annotations

import json
import os
import random
from typing import Callable, Dict, List, Optional, Sequence

NUM_TO_WORD = {1: "one", 2: "two", 3: "three", 4: "four"}


def read_jsonl(path: str) -> List[dict]:
    with open(path, encoding="utf-8") as f:
        return [json.loads(line) for line in f if line.strip()]


def write_jsonl(path: str, records: Sequence[dict]):
    with open(path, "w", encoding="utf-8") as f:
        for rec in records:
            f.write(json.dumps(rec, ensure_ascii=False) + "\n")


def build_counting_edit(metadata_path: str, output_path: str, image_dir: str,
                        generate_fn: Callable, counts=(1, 2, 3, 4)) -> int:
    """Counting-edit dataset: for each source record (a t2i prompt asking for
    N objects), render one image and emit an edit record per OTHER count M —
    "Change the number of <class> in the image to <M>" with include/exclude
    count specs for the GenEval judge (reference
    dataset/counting_edit/process_data.py semantics; generation engine is
    injected rather than hardcoded). Returns the number of records written.
    """
    os.makedirs(image_dir, exist_ok=True)
    n_out = 0
    with open(output_path, "w", encoding="utf-8") as out:
        for i, rec in enumerate(read_jsonl(metadata_path)):
            try:
                original = rec["include"][0]["count"]
                cls = rec["include"][0]["class"]
            except (KeyError, IndexError):
                continue
            image = generate_fn(rec["t2i_prompt"])
            image_path = os.path.join(image_dir, f"image_{i}.jpg")
            image.save(image_path)
            for num in sorted(set(counts) - {original}):
                out.write(json.dumps({
                    "tag": rec["tag"],
                    "include": [{"class": cls, "count": num}],
                    "exclude": [{"class": cls, "count": num + 1}],
                    "t2i_prompt": rec["t2i_prompt"],
                    "prompt": f"Change the number of {cls} in the image to "
                              f"{NUM_TO_WORD[num]}.",
                    "image": image_path,
                }, ensure_ascii=False) + "\n")
                n_out += 1
    return n_out


def split_train_test(input_path: str, train_path: str, test_path: str,
                     test_size: int = 112, seed: int = 42):
    """Seeded shuffle -> first ``test_size`` records become the test split
    (reference split_train_test.py)."""
    data = read_jsonl(input_path)
    rng = random.Random(seed)
    rng.shuffle(data)
    write_jsonl(test_path, data[:test_size])
    write_jsonl(train_path, data[test_size:])
    return len(data[:test_size]), len(data[test_size:])


def filter_test_prompts(test_path: str, train_path: str, output_path: str) -> int:
    """Drop train records whose prompt appears in the test split — the
    GenEval train/test decontamination pass (reference
    geneval_filter_test.py). Returns the number of kept records."""
    test_prompts = {rec["prompt"] for rec in read_jsonl(test_path)}
    kept = [rec for rec in read_jsonl(train_path)
            if rec["prompt"] not in test_prompts]
    write_jsonl(output_path, kept)
    return len(kept)


def largest_remainder_allocation(weights: Sequence[float],
                                 total: int) -> List[int]:
    """Apportion ``total`` samples over normalized weights: integer floors,
    then +1 to the largest fractional remainders (reference
    merge_genevaltask.distribute_samples)."""
    s = float(sum(weights))
    floats = [w / s * total for w in weights]
    ints = [int(f) for f in floats]
    remainder = total - sum(ints)
    order = sorted(range(len(weights)), key=lambda i: floats[i] - ints[i],
                   reverse=True)
    for i in order[:remainder]:
        ints[i] += 1
    return ints


def merge_weighted_tasks(task_paths: Dict[str, str], weights: Dict[str, float],
                         output_path: str, total_samples: int = 50000,
                         seed: Optional[int] = 0) -> Dict[str, int]:
    """Weighted multi-task GenEval mixture: per-task sample counts by largest
    remainder, sample without replacement when possible (with replacement when
    the task is smaller than its quota), shuffle, write one jsonl (reference
    merge_genevaltask.py). Returns the per-task counts."""
    tasks = list(task_paths)
    counts = dict(zip(tasks, largest_remainder_allocation(
        [weights[t] for t in tasks], total_samples)))
    rng = random.Random(seed)
    merged: List[dict] = []
    for task in tasks:
        data = read_jsonl(task_paths[task])
        need = counts[task]
        if len(data) >= need:
            merged.extend(rng.sample(data, need))
        else:
            merged.extend(rng.choices(data, k=need))
    rng.shuffle(merged)
    write_jsonl(output_path, merged)
    return counts


def validate_reference_set(json_paths: Sequence[str], image_dir: str,
                           expected_variations: Optional[int] = None,
                           prompts_file: Optional[str] = None,
                           decode_sample: int = 16,
                           min_resolution: int = 256,
                           seed: int = 0) -> Dict:
    """Certify a reference-image set against the ``prompt2img_node{R}.json``
    contract BEFORE a cotrain run.

    The headline adversarial presets train D against references from a
    stronger external model (Qwen-Image, 8 variations/prompt, 512^2 —
    reference reference_imgs_scripts/qwen_generate_multi.py:21-24,61-68,
    122-136); the consumer opens the files mid-epoch and silently falls back
    to a default image on failure (train_sd3_fast_pickscore.py:773-799), so a
    broken set degrades the adversarial signal without any error. This
    validates up front:

      * every JSON parses and maps prompt -> filename | [filenames];
      * multi-node shards (prompt2img_node{0..R}.json) merge without
        duplicate prompts;
      * every referenced file exists in ``image_dir`` and is non-empty;
      * per-prompt counts match ``expected_variations`` (when given);
      * every prompt of ``prompts_file`` is covered (when given);
      * a seeded sample of ``decode_sample`` images actually decodes (PIL)
        at >= ``min_resolution`` px (0 = decode nothing, -1 = decode ALL).

    Returns a report dict with ``ok`` plus the offending entries (each list
    truncated to 20 examples for printability; counts are exact).
    """
    report: Dict = {"ok": True, "prompts": 0, "files_total": 0,
                    "duplicate_prompts": [], "empty_prompts": [],
                    "missing_files": [], "wrong_counts": {},
                    "uncovered_prompts": [], "undecodable": [],
                    "decoded_sample": 0}

    def _flag(key, value, limit=20):
        report["ok"] = False
        bucket = report[key]
        if isinstance(bucket, list):
            if len(bucket) < limit:
                bucket.append(value)
        else:
            bucket.update(value)

    prompt2files: Dict[str, List[str]] = {}
    for path in json_paths:
        with open(path, encoding="utf-8") as f:
            shard = json.load(f)
        if not isinstance(shard, dict):
            raise ValueError(f"{path}: expected a JSON object, "
                             f"got {type(shard).__name__}")
        for prompt, files in shard.items():
            if prompt in prompt2files:
                _flag("duplicate_prompts", prompt)
            prompt2files[prompt] = ([files] if isinstance(files, str)
                                    else list(files))
    report["prompts"] = len(prompt2files)

    all_files: List[str] = []
    for prompt, files in prompt2files.items():
        if not files:
            _flag("empty_prompts", prompt)
            continue
        if expected_variations and len(files) != expected_variations:
            if len(report["wrong_counts"]) < 20:
                _flag("wrong_counts", {prompt: len(files)})
            else:
                report["ok"] = False
        for name in files:
            full = os.path.join(image_dir, name)
            if not os.path.isfile(full) or os.path.getsize(full) == 0:
                _flag("missing_files", name)
            else:
                all_files.append(full)
    report["files_total"] = len(all_files)

    if prompts_file:
        with open(prompts_file, encoding="utf-8") as f:
            wanted = [line.strip() for line in f if line.strip()]
        for p in wanted:
            if p not in prompt2files:
                _flag("uncovered_prompts", p)

    if decode_sample and all_files:
        from PIL import Image

        rng = random.Random(seed)
        sample = (all_files if decode_sample < 0
                  else rng.sample(all_files, min(decode_sample,
                                                 len(all_files))))
        for full in sample:
            try:
                with Image.open(full) as img:
                    img.load()
                    if min(img.size) < min_resolution:
                        raise ValueError(
                            f"{img.size} below min_resolution "
                            f"{min_resolution}")
            except Exception as e:  # noqa: BLE001 — report, don't abort
                _flag("undecodable", f"{os.path.basename(full)}: {e}")
        report["decoded_sample"] = len(sample)

    return report
