"""Host-side JPEG rewards, the port's copy of the JPEG scorers of
adv_grpo_tpu/rewards/host.py (reference rewards.py:13-35).

Both take uint8 images (N, H, W, 3), or video clips (N, T, H, W, 3), which
are scored per frame and meaned per clip.
"""

from __future__ import annotations

import io

import numpy as np


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
