"""Prompt datasets, the reference-image store and the preference pairs.

The port's own copy of adv_grpo_tpu/data/datasets.py:

  * ``TextPromptDataset``: one prompt per line of ``{split}.txt``;
  * ``GenevalPromptDataset``: ``{split}_metadata.jsonl``, one JSON object per
    line with a ``prompt`` field (the GenEval include/exclude specs ride along
    as metadata);
  * ``ReferenceImageStore``: prompt -> reference image files (a JSON map and
    an image directory), with the reference's fallback frame on a failed
    load; it decodes with PIL (the JAX package's path without its native
    loader);
  * ``PreferencePairDataset``: (prompt, good, bad) triples of the offline
    PickScore finetune (``cli.finetune_pickscore``), PIL-decoded as well;
  * the prompt functions (``get_prompt_fn``), which read their word lists
    from the JAX package's data files in ``adv_grpo_tpu/data/assets/``
    (read as files, not imported).

``limit`` keeps the first ``limit`` prompts (the reference's ``config.limit``).
"""

from __future__ import annotations

import functools
import json
import os
import random
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np


class TextPromptDataset:
    def __init__(self, dataset_dir: str, split: str = "train",
                 limit: Optional[int] = None):
        with open(os.path.join(dataset_dir, f"{split}.txt")) as f:
            self.prompts = [line.strip() for line in f]
        if limit:
            self.prompts = self.prompts[: int(limit)]
        self.metadatas = [{} for _ in self.prompts]

    def __len__(self):
        return len(self.prompts)

    def __getitem__(self, idx):
        return {"prompt": self.prompts[idx], "metadata": {}}


class GenevalPromptDataset:
    def __init__(self, dataset_dir: str, split: str = "train",
                 limit: Optional[int] = None):
        with open(os.path.join(dataset_dir, f"{split}_metadata.jsonl"),
                  encoding="utf-8") as f:
            self.metadatas = [json.loads(line) for line in f]
        if limit:
            self.metadatas = self.metadatas[: int(limit)]
        self.prompts = [m["prompt"] for m in self.metadatas]

    def __len__(self):
        return len(self.prompts)

    def __getitem__(self, idx):
        return {"prompt": self.prompts[idx], "metadata": self.metadatas[idx]}


class ReferenceImageStore:
    """prompt -> reference images, float32 (R, 3, H, W) in [-1, 1], PIL
    BICUBIC-resized to ``resolution``. A prompt without images, or a file
    that fails to load, gets the fallback image (or a mid-grey frame) unless
    ``strict``. ``num_refs`` defaults to 1, as the JAX CLI builds it."""

    def __init__(self, json_path: str, image_dir: str, resolution: int = 512,
                 num_refs: int = 1, fallback_path: Optional[str] = None,
                 strict: bool = False):
        with open(json_path) as f:
            self.prompt2files = json.load(f)
        self.image_dir = image_dir
        self.resolution = resolution
        self.num_refs = num_refs
        self.fallback_path = fallback_path
        self.strict = strict

    def _load_one(self, path: str) -> np.ndarray:
        from PIL import Image

        img = Image.open(path).convert("RGB").resize(
            (self.resolution, self.resolution), Image.BICUBIC)
        arr = np.asarray(img, dtype=np.float32) / 255.0
        return arr.transpose(2, 0, 1) * 2.0 - 1.0

    def _fallback(self) -> np.ndarray:
        if self.fallback_path:
            try:
                return self._load_one(self.fallback_path)
            except Exception:
                pass
        return np.zeros((3, self.resolution, self.resolution), np.float32)

    def _choose(self, prompt: str, rng) -> Optional[List[str]]:
        """Resolved file paths for one prompt, or None (missing prompt)."""
        files = self.prompt2files.get(prompt)
        if not files:  # missing OR an empty list (failed generation run)
            if self.strict:
                raise KeyError(f"no reference images for prompt: {prompt!r}")
            return None
        if isinstance(files, str):
            files = [files]
        rng = rng or random
        chosen = (rng.sample(files, self.num_refs) if len(files) >= self.num_refs
                  else [rng.choice(files) for _ in range(self.num_refs)])
        return [f if os.path.isabs(f) else os.path.join(self.image_dir, f)
                for f in chosen]

    def _load(self, paths: Optional[List[str]]) -> np.ndarray:
        if paths is None:
            return np.stack([self._fallback()] * self.num_refs)
        out = []
        for path in paths:
            try:
                out.append(self._load_one(path))
            except Exception:
                if self.strict:
                    raise
                out.append(self._fallback())
        return np.stack(out)

    def get(self, prompt: str, rng: Optional[random.Random] = None) -> np.ndarray:
        """(num_refs, 3, H, W) for one prompt (sampled when more are on disk)."""
        return self._load(self._choose(prompt, rng))

    def get_batch(self, prompts: Sequence[str], rng=None) -> np.ndarray:
        """(B, num_refs, 3, H, W); every prompt's files are chosen before
        any is loaded, as the JAX store does."""
        per_prompt = [self._choose(p, rng) for p in prompts]
        return np.stack([self._load(paths) for paths in per_prompt])


class PreferencePairDataset:
    """(prompt, good image, bad image) triples from a prompt2img.json shared
    by two image directories (the reference's ``QwenSD3JsonDataset``,
    adv_grpo/pick_score_training.py:228-282): good = the reference render,
    bad = the SD3 render of the same prompt, the same file name in both
    directories; a multi-variation JSON takes its first render. A pair whose
    good (or bad) file is missing degrades to (bad, bad), as the reference's
    does (:252-257). Images load as float32 (3, H, W) in [-1, 1], PIL
    BICUBIC-resized to ``resolution``."""

    def __init__(self, json_path: str, good_dir: str, bad_dir: str, resolution: int = 224):
        with open(json_path) as f:
            self.prompt2img = json.load(f)
        self.prompts = list(self.prompt2img.keys())
        self.good_dir = good_dir
        self.bad_dir = bad_dir
        self._store = ReferenceImageStore.__new__(ReferenceImageStore)
        self._store.resolution = resolution
        self._store.fallback_path = None
        self._store.strict = False

    def __len__(self):
        return len(self.prompts)

    def _resolve(self, idx: int):
        prompt = self.prompts[idx]
        fname = self.prompt2img[prompt]
        if isinstance(fname, list):  # multi-variation JSON: first render
            fname = fname[0]
        good = os.path.join(self.good_dir, fname)
        bad = os.path.join(self.bad_dir, fname)
        if not (os.path.exists(good) and os.path.exists(bad)):
            good = bad  # reference fallback :252-257
        return prompt, good, bad

    def __getitem__(self, idx: int):
        prompt, good, bad = self._resolve(idx)
        return {"prompt": prompt, "good": self._store._load_one(good),
                "bad": self._store._load_one(bad)}

    def get_batch(self, indices: Sequence[int]):
        """(prompts, good (B, 3, H, W), bad (B, 3, H, W))."""
        rows = [self[i] for i in indices]
        return ([r["prompt"] for r in rows], np.stack([r["good"] for r in rows]),
                np.stack([r["bad"] for r in rows]))


# ───────────────────────── prompt functions (adv_grpo/prompts.py) ─────────────

ASSETS_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "adv_grpo_tpu", "data", "assets")


@functools.lru_cache(maxsize=64)
def _asset_lines(name: str) -> List[str]:
    with open(os.path.join(ASSETS_DIR, name)) as f:
        return [line.strip() for line in f if line.strip()]


def _from_file(name: str, low=None, high=None):
    def _fn(**kwargs):
        lines = _asset_lines(name)[low:high]
        return random.choice(lines), {}

    return _fn


def general_ocr(**kwargs):
    """Prompt with a random quoted digit string to render: a line of
    ``general_ocr_train.txt`` where that file exists, else a template of
    ``ocr_templates.txt`` around 4-8 random digits (the OCR reward parses
    the target as ``prompt.split('"')[1]``)."""
    try:
        return _from_file("general_ocr_train.txt")()
    except FileNotFoundError:
        templates = _asset_lines("ocr_templates.txt")
        digits = "".join(random.choice("0123456789") for _ in range(random.randint(4, 8)))
        return random.choice(templates).replace("{text}", f'"{digits}"'), {}


def simple_ocr_animals(**kwargs):
    """'A {animal} holding a sign that says "66..6"', a repeated-6 digit
    string of random length 1-9 (reference prompts.py:50-56)."""
    animals = _asset_lines("simple_ocr_animals.txt")
    digits = "6" * random.randint(1, 9)
    return f'A {random.choice(animals)} holding a sign that says "{digits}"', {}


_NUMBER_WORDS = ["zero", "one", "two", "three", "four", "five", "six", "seven", "eight", "nine",
                 "ten"]


def _article(word: str) -> str:
    return ("an " if word[0].lower() in "aeiou" else "a ") + word


def _plural(word: str) -> str:
    if word.endswith(("s", "x", "ch", "sh")):
        return word + "es"
    if word.endswith("y") and word[-2:-1] not in "aeiou":
        return word[:-1] + "ies"
    return word + "s"


def nouns_activities(nouns_file: str = "simple_animals.txt",
                     activities_file: str = "activities.txt", **kwargs):
    """'a {noun} {activity}' (reference prompts.py:58-61)."""
    noun = random.choice(_asset_lines(nouns_file))
    activity = random.choice(_asset_lines(activities_file))
    return f"{_article(noun)} {activity}", {}


def counting(nouns_file: str = "simple_animals.txt", low: int = 2, high: int = 6, **kwargs):
    """'{number-word} {plural noun}' with QA metadata for VLM verification
    (reference prompts.py:64-80)."""
    noun = random.choice(_asset_lines(nouns_file))
    n = random.randint(low, high)
    number = _NUMBER_WORDS[n] if n < len(_NUMBER_WORDS) else str(n)
    plural = _plural(noun)
    metadata = {"questions": [f"How many {plural} are there in this image?",
                              "What animal is in this image?"],
                "answers": [number, noun]}
    return f"{number} {plural}", metadata


PROMPT_FNS: dict = {
    "imagenet_all": _from_file("imagenet_classes.txt"),
    "imagenet_animals": _from_file("imagenet_classes.txt", 0, 398),
    "imagenet_dogs": _from_file("imagenet_classes.txt", 151, 269),
    "simple_animals": _from_file("simple_animals.txt"),
    "general_ocr": general_ocr,
    "simple_ocr_animals": simple_ocr_animals,
    "nouns_activities": nouns_activities,
    "counting": counting,
}


def get_prompt_fn(name: str) -> Callable[..., Tuple[str, dict]]:
    return PROMPT_FNS[name]
