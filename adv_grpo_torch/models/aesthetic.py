"""The LAION aesthetic predictor head: a CLIP-L image embedding -> a scalar.

Port of adv_grpo_tpu/models/aesthetic.py (reference
adv_grpo/aesthetic_scorer.py:13-41): the embedding L2-normalised, then
``fc0``-``fc3`` (768 -> 1024 -> 128 -> 64 -> 16) with no activation between
them (the reference's dropout acts only in training) and ``out`` (16 -> 1),
all in fp32. The published ``sac+logos+ava1-l14-linearMSE.pth`` loads
through ``models.convert.aesthetic_state_dict_from_pth``.
"""

from __future__ import annotations

import torch
from torch import nn

WIDTHS = (1024, 128, 64, 16)


class AestheticHead(nn.Module):
    def __init__(self, embed_dim: int = 768, device=None):
        super().__init__()
        dims = (embed_dim,) + WIDTHS
        for i in range(len(WIDTHS)):
            setattr(self, f"fc{i}", nn.Linear(dims[i], dims[i + 1], device=device))
        self.out = nn.Linear(WIDTHS[-1], 1, device=device)

    def forward(self, embed):
        """(B, embed_dim) -> (B,) scores."""
        x = embed.float()
        x = x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)
        for i in range(len(WIDTHS)):
            x = getattr(self, f"fc{i}")(x)
        return self.out(x).squeeze(-1)
