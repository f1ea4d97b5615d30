"""The JPEG compressibility reward, plain: each frame to uint8 (x * 0.5 +
0.5, clipped to [0, 1], times 255, truncated), encoded by PIL as JPEG at
quality 95; the reward is minus the size in kB over 500, the mean over a
video's frames."""

from __future__ import annotations

import io

import numpy as np


def compressibility(videos: np.ndarray) -> np.ndarray:
    """(B, F, 3, H, W) or (B, 3, H, W) in [-1, 1] -> (B,) float64."""
    from PIL import Image

    v = np.asarray(videos, np.float32)
    if v.ndim == 4:
        v = v[:, None]
    out = []
    for clip in v:
        sizes = []
        for frame in clip:
            u8 = (np.clip(frame * np.float32(0.5) + np.float32(0.5), 0, 1).transpose(1, 2, 0)
                  * np.float32(255)).astype(np.uint8)
            buf = io.BytesIO()
            Image.fromarray(u8).save(buf, format="JPEG", quality=95)
            sizes.append(buf.tell() / 1000)
        out.append(-np.mean(sizes) / 500.0)
    return np.asarray(out, np.float64)
