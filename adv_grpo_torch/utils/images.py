"""float images -> uint8, the port's copy of adv_grpo_tpu/native/lib.py's
``images_to_uint8``.

The JAX package packs images in C++ (``native/levenshtein.cpp``
``chw_float_to_hwc_u8``: ``v = x*0.5f + 0.5f``, clamped to [0, 1], then
``(uint8_t)(v * 255.0f)``) and falls back to the numpy formula below. Both
compute in float32 and truncate toward zero, so they give the same bytes
(``tests/test_torch_copies.py``).
"""

from __future__ import annotations

import numpy as np


def images_to_uint8(images: np.ndarray) -> np.ndarray:
    """float32 (N, C, H, W) in [-1, 1] -> uint8 (N, H, W, C)."""
    images = np.ascontiguousarray(images, dtype=np.float32)
    x = np.clip(images * np.float32(0.5) + np.float32(0.5), 0, 1)
    return (x.transpose(0, 2, 3, 1) * np.float32(255)).astype(np.uint8)
