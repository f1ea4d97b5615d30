"""Host-side rewards, the port's copy of adv_grpo_tpu/rewards/host.py: the
JPEG scorers (reference rewards.py:13-35) and the OCR scorers (reference
adv_grpo/ocr.py).

The JPEG scorers take uint8 images (N, H, W, 3), or video clips (N, T, H, W,
3), which are scored per frame and meaned per clip. The OCR scorers read the
text in each image with an engine, a callable uint8 (H, W, 3) -> str:
PaddleOCR where it can be imported, else one the caller passes in; with
neither a call raises. The edit distance is :func:`levenshtein`, the JAX
package's ``native/lib.py`` one in Python: it counts UTF-8 bytes, not
characters, as that one does.
"""

from __future__ import annotations

import io
import logging
from typing import Callable, List, Optional

import numpy as np

from adv_grpo_torch.utils.images import images_to_uint8


def jpeg_incompressibility(images_u8: np.ndarray) -> np.ndarray:
    """JPEG (quality 95) size in kB per image (per clip: the mean over its
    frames)."""
    from PIL import Image

    if images_u8.ndim == 5:
        return np.asarray([np.mean(jpeg_incompressibility(clip)) for clip in images_u8],
                          dtype=np.float64)
    sizes = []
    for arr in images_u8:
        buf = io.BytesIO()
        Image.fromarray(arr).save(buf, format="JPEG", quality=95)
        sizes.append(buf.tell() / 1000)
    return np.asarray(sizes, dtype=np.float64)


def jpeg_compressibility(images_u8: np.ndarray) -> np.ndarray:
    """-size / 500."""
    return -jpeg_incompressibility(images_u8) / 500.0


def levenshtein(a: str, b: str) -> int:
    """The edit distance between the UTF-8 encodings of ``a`` and ``b``
    (insertions, deletions and substitutions of one byte each)."""
    ab, bb = a.encode(), b.encode()
    if not ab:
        return len(bb)
    prev = list(range(len(bb) + 1))
    for i, ca in enumerate(ab, 1):
        cur = [i]
        for j, cb in enumerate(bb, 1):
            cur.append(min(prev[j] + 1, cur[-1] + 1, prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1]


def ocr_reward_from_text(recognized: str, target: str) -> float:
    """The edit-distance reward of one (recognized, target) pair (reference
    adv_grpo/ocr.py:45-61): spaces stripped and lower-cased; a target found
    in the text is distance 0; the distance is capped at len(target) (in
    characters) and the reward is 1 - distance / len(target)."""
    recognized = recognized.replace(" ", "").lower()
    target = target.replace(" ", "").lower()
    if not target:
        return 0.0
    dist = 0 if target in recognized else levenshtein(recognized, target)
    dist = min(dist, len(target))
    return 1.0 - dist / len(target)


def _paddle_engine() -> Optional[Callable]:
    """PaddleOCR (English, no angle classifier, on the CPU) as an engine, or
    None where ``paddleocr`` cannot be imported."""
    try:
        from paddleocr import PaddleOCR
    except ImportError:
        return None
    ocr = PaddleOCR(use_angle_cls=False, lang="en", use_gpu=False, show_log=False)

    def engine(img_u8):
        result = ocr.ocr(img_u8, cls=False)
        if not result or not result[0]:
            return ""
        return "".join(r[1][0] if r[1][1] > 0 else "" for r in result[0])

    return engine


class OcrScorer:
    """The OCR reward: the target is the prompt's quoted span,
    ``prompt.split('"')[1]`` (reference ocr.py:31); a prompt without one, or
    an image the engine fails on, scores 0.0, the largest penalty."""

    def __init__(self, engine: Optional[Callable] = None):
        self.engine = engine if engine is not None else _paddle_engine()
        self._warned_unquoted = False

    def __call__(self, images, prompts: List[str]) -> np.ndarray:
        """``images`` uint8 (N, H, W, 3), or float (N, 3, H, W) in [-1, 1]."""
        if self.engine is None:
            raise RuntimeError("No OCR engine available: install paddleocr or inject engine=")
        targets = [p.split('"')[1] if p.count('"') >= 1 else None for p in prompts]
        n_missing = sum(t is None for t in targets)
        if n_missing and not self._warned_unquoted:
            self._warned_unquoted = True
            logging.getLogger(__name__).warning(
                "OCR reward: %d/%d prompts have no quoted target span — they score 0.0 "
                "(max penalty). If this persists, the prompt_fn/dataset pairing is likely "
                "misconfigured.", n_missing, len(targets))
        if images.ndim == 4 and images.shape[1] == 3:  # float CHW
            images = images_to_uint8(np.asarray(images, np.float32))
        rewards = []
        for img, target in zip(images, targets):
            if target is None:
                rewards.append(0.0)
                continue
            try:
                rewards.append(ocr_reward_from_text(self.engine(img), target))
            except Exception:  # an engine failure is the largest penalty
                rewards.append(0.0)
        return np.asarray(rewards, dtype=np.float64)


class VideoOcrScorer(OcrScorer):
    """The video OCR reward (reference adv_grpo/ocr.py:67-127): every 4th
    frame of each clip (N, T, H, W, 3) scored, the clip's reward their
    mean."""

    def __call__(self, videos, prompts: List[str]) -> np.ndarray:
        out = []
        for vid, prompt in zip(videos, prompts):
            frames = np.asarray(vid[::4])
            out.append(float(np.mean(super().__call__(frames, [prompt] * len(frames)))))
        return np.asarray(out, dtype=np.float64)
