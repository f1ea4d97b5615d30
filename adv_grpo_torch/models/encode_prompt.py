"""SD3's prompt embeddings from its three text encoders.

Port of adv_grpo_tpu/models/encode_prompt.py (the reference ``encode_prompt``):
the PENULTIMATE hidden states of CLIP-L (B, 77, 768) and CLIP-G (B, 77, 1280)
are concatenated along the channels (B, 77, 2048), zero-padded to the T5
width (4096) and concatenated with the T5 hidden states along the sequence;
the pooled embedding is CLIP-L's pooled projection followed by CLIP-G's
(B, 2048).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F


class PromptEmbeds(NamedTuple):
    prompt_embeds: torch.Tensor  # (B, 77 + t5_len, t5_dim)
    pooled_prompt_embeds: torch.Tensor  # (B, clip_l_dim + clip_g_dim)


def compose_sd3_prompt_embeds(clip_l_hidden, clip_l_pooled, clip_g_hidden, clip_g_pooled,
                              t5_hidden) -> PromptEmbeds:
    clip_hidden = torch.cat([clip_l_hidden, clip_g_hidden], dim=-1)
    pad = t5_hidden.shape[-1] - clip_hidden.shape[-1]
    if pad < 0:
        raise ValueError("T5 width must be >= concatenated CLIP width")
    clip_hidden = F.pad(clip_hidden, (0, pad))
    prompt_embeds = torch.cat([clip_hidden, t5_hidden.to(clip_hidden.dtype)], dim=1)
    pooled = torch.cat([clip_l_pooled, clip_g_pooled], dim=-1)
    return PromptEmbeds(prompt_embeds, pooled)


class SD3TextEncoderSet:
    """The three encoders and their tokenizers behind one ``encode`` call.

    ``clip_l_fn`` / ``clip_g_fn`` map token ids to (final, penultimate,
    pooled), ``t5_fn`` ids to hidden states; ``tokenize_clip_l`` /
    ``tokenize_clip_g`` / ``tokenize_t5`` map a list of prompts to (B, 77) /
    (B, 77) / (B, t5_len) ids (HF tokenizers from a local directory, or
    callables a caller injects). Each CLIP has its own tokenizer, as SD3's
    ``tokenizer/`` and ``tokenizer_2/`` are two (bigG's pads with ``!``);
    the JAX class hands CLIP-G the ids of CLIP-L's one.
    """

    def __init__(self, clip_l_fn, clip_g_fn, t5_fn, tokenize_clip_l, tokenize_clip_g,
                 tokenize_t5):
        self.clip_l_fn, self.clip_g_fn, self.t5_fn = clip_l_fn, clip_g_fn, t5_fn
        self.tokenize_clip_l, self.tokenize_clip_g = tokenize_clip_l, tokenize_clip_g
        self.tokenize_t5 = tokenize_t5

    def encode(self, prompts) -> PromptEmbeds:
        _, l_hidden, l_pooled = self.clip_l_fn(self.tokenize_clip_l(prompts))
        _, g_hidden, g_pooled = self.clip_g_fn(self.tokenize_clip_g(prompts))
        t5_hidden = self.t5_fn(self.tokenize_t5(prompts))
        return compose_sd3_prompt_embeds(l_hidden, l_pooled, g_hidden, g_pooled, t5_hidden)
