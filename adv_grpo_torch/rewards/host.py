"""Host-side JPEG rewards, the port's copy of the JPEG scorers of
adv_grpo_tpu/rewards/host.py (reference rewards.py:13-35).

Both take uint8 images (N, H, W, 3); the JAX package's per-frame scoring of
video clips is not copied (the port has no video family yet).
"""

from __future__ import annotations

import io

import numpy as np


def jpeg_incompressibility(images_u8: np.ndarray) -> np.ndarray:
    """JPEG (quality 95) size in kB per image."""
    from PIL import Image

    sizes = []
    for arr in images_u8:
        buf = io.BytesIO()
        Image.fromarray(arr).save(buf, format="JPEG", quality=95)
        sizes.append(buf.tell() / 1000)
    return np.asarray(sizes, dtype=np.float64)


def jpeg_compressibility(images_u8: np.ndarray) -> np.ndarray:
    """-size / 500."""
    return -jpeg_incompressibility(images_u8) / 500.0
