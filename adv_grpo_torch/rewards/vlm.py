"""The VLM judge rewards: the Qwen2.5-VL aesthetic rubric and ImageReward.

Port of adv_grpo_tpu/rewards/vlm.py. ``QWENVL_RUBRIC`` and
``extract_qwenvl_score`` are copies of the JAX package's
(tests/test_torch_copies.py holds them equal). The judges run on the host
copy of the images (uint8 (N, H, W, 3)) like the reference's
(adv_grpo/qwenvl.py, adv_grpo/imagereward_scorer.py):

  * :class:`QwenVLScorer`: an injected ``generate_fn(images_u8, prompts) ->
    texts``, else ``transformers``' ``AutoModelForVision2Seq`` from a local
    checkpoint where ``transformers`` imports; without it, an error naming
    the package;
  * :class:`ImageRewardScorer`: an injected ``score_fn(prompt, pil_images)``,
    else the ``ImageReward`` pip package where it imports, else the port's
    own model (``models.blip.ImageRewardModel``) from the checkpoint
    ``IMAGEREWARD_PT`` (``models.convert.imagereward_state_dict_from_pt``)
    and the tokenizer directory ``BERT_TOKENIZER_DIR``
    (``data.tokenizers.BertTokenizer``), on the caller's device.
"""

from __future__ import annotations

import os
import re
from typing import List, Optional

import numpy as np
import torch

# The grading rubric, VERBATIM from the reference (adv_grpo/qwenvl.py:40-58):
# a pure-aesthetic 5-point scale judged from the image alone (the text prompt
# is NOT shown to the judge), answer wrapped in <Score></Score>.
QWENVL_RUBRIC = """
Your role is to evaluate the aesthetic quality score of given images.
1. Bad: Extremely blurry, underexposed with significant noise, indiscernible
subjects, and chaotic composition.
2. Poor: Noticeable blur, poor lighting, washed-out colors, and awkward
composition with cut-off subjects.
3. Fair: In focus with adequate lighting, dull colors, decent composition but
lacks creativity.
4. Good: Sharp, good exposure, vibrant colors, thoughtful composition with
a clear focal point.
5. Excellent: Exceptional clarity, perfect exposure, rich colors, masterful
composition with emotional impact.

Please first provide a detailed analysis of the evaluation process, including the criteria for judging aesthetic quality, within the <Thought> tag. Then, give a final score from 1 to 5 within the <Score> tag.
<Thought>
[Analyze the evaluation process in detail here]
</Thought>
<Score>X</Score>
"""


def extract_qwenvl_score(text: str, scale: float = 5.0) -> float:
    """<Score>X</Score> regex, normalised to [0, 1] (reference qwenvl.py:16-24,
    :91-98); malformed output -> 0."""
    m = re.search(r"<Score>\s*([0-9]+(?:\.[0-9]+)?)\s*</Score>", text)
    if not m:
        return 0.0
    return min(max(float(m.group(1)), 0.0) / scale, 1.0)


class QwenVLScorer:
    """Batched Qwen2.5-VL judge: ``generate_fn``, or a local checkpoint."""

    def __init__(self, model_dir: Optional[str] = None, generate_fn=None, device="cuda"):
        self.generate_fn = generate_fn
        if generate_fn is None:
            if not model_dir:
                raise RuntimeError(
                    "QwenVLScorer needs model_dir (local Qwen2.5-VL checkpoint) "
                    "or an injected generate_fn(images_u8, prompts) -> List[str]")
            self.generate_fn = self._make_hf_generate(model_dir, device)

    @staticmethod
    def _make_hf_generate(model_dir: str, device):
        try:
            import transformers
        except ImportError as exc:
            raise RuntimeError(
                "QwenVLScorer's checkpoint path needs the 'transformers' package, which "
                "does not import here; pass generate_fn(images_u8, prompts) instead") from exc
        processor = transformers.AutoProcessor.from_pretrained(model_dir)
        model = transformers.AutoModelForVision2Seq.from_pretrained(model_dir).to(device)

        def generate(images_u8, prompts):
            from PIL import Image

            texts = []
            for arr, prompt in zip(images_u8, prompts):
                del prompt  # the reference judge grades the image alone
                messages = [{"role": "user", "content": [
                    {"type": "image"},
                    {"type": "text", "text": QWENVL_RUBRIC},
                ]}]
                chat = processor.apply_chat_template(messages, add_generation_prompt=True)
                inputs = processor(text=[chat], images=[Image.fromarray(arr)],
                                   return_tensors="pt").to(device)
                # the rubric asks for a <Thought> analysis before <Score>
                out = model.generate(**inputs, max_new_tokens=2048)
                texts.append(processor.batch_decode(out)[0])
            return texts

        return generate

    def __call__(self, images_u8, prompts: List[str]) -> np.ndarray:
        texts = self.generate_fn(images_u8, prompts)
        return np.asarray([extract_qwenvl_score(t) for t in texts], np.float64)


def imagereward_score_fn(model, tokenizer):
    """``score_fn(prompt, pil_images) -> (N,) scores`` of the port's
    ``ImageRewardModel`` (on its own device) and ``BertTokenizer``: the
    prompt padded and cut to 35 ids, the images to [-1, 1] (the JAX
    ``_make_native``)."""

    def score_fn(prompt, pil_images):
        ids, mask = tokenizer([prompt], 35)
        imgs = np.stack([np.asarray(im, np.float32).transpose(2, 0, 1) / 255.0 * 2.0 - 1.0
                         for im in pil_images])
        n = len(pil_images)
        return model.score(imgs, np.repeat(ids, n, 0),
                           np.repeat(mask, n, 0).astype(bool)).cpu().numpy()

    return score_fn


class ImageRewardScorer:
    """BLIP-based ImageReward (reference adv_grpo/imagereward_scorer.py:12-21
    wraps the pip package's inference_rank); see the module docstring for
    the order of the paths. ``model_path`` stands in for ``IMAGEREWARD_PT``;
    ``text_cfg`` / ``vision_cfg`` are the port's model's widths
    (ImageReward-v1.0's by default)."""

    def __init__(self, model_path: Optional[str] = None, score_fn=None, device="cuda",
                 text_cfg=None, vision_cfg=None):
        self.score_fn = score_fn
        if score_fn is not None:
            return
        try:
            import ImageReward as RM
        except ImportError:
            RM = None
        if RM is not None:
            model = RM.load(model_path or "ImageReward-v1.0", device=str(device))

            def pip_score_fn(prompt, pil_images):
                _, scores = model.inference_rank(prompt, pil_images)
                return scores

            self.score_fn = pip_score_fn
            return
        pt = model_path or os.environ.get("IMAGEREWARD_PT", "")
        tok_dir = os.environ.get("BERT_TOKENIZER_DIR", "")
        if pt and os.path.exists(pt) and os.path.isdir(tok_dir):
            from adv_grpo_torch.data.tokenizers import BertTokenizer

            model = load_imagereward(pt, device, text_cfg, vision_cfg)
            self.score_fn = imagereward_score_fn(model, BertTokenizer(tok_dir))
            return
        raise RuntimeError(
            "ImageRewardScorer needs one of: an injected "
            "score_fn(prompt, pil_images), the ImageReward pip package, or "
            "IMAGEREWARD_PT (local .pt checkpoint) + BERT_TOKENIZER_DIR "
            "for the port's own model")

    def __call__(self, images_u8, prompts: List[str]) -> np.ndarray:
        from PIL import Image

        out = []
        for arr, prompt in zip(images_u8, prompts):
            scores = self.score_fn(prompt, [Image.fromarray(arr)])
            out.append(float(np.atleast_1d(scores)[0]))
        return np.asarray(out, np.float64)


def load_imagereward(pt_path: str, device, text_cfg=None, vision_cfg=None):
    """``models.blip.ImageRewardModel`` (ImageReward-v1.0's widths, or the
    given ones) on ``device`` with the weights of the checkpoint at
    ``pt_path`` (``torch.load(weights_only=True)``, strictly converted)."""
    from adv_grpo_torch.models import convert
    from adv_grpo_torch.models.blip import BlipTextConfig, ImageRewardModel, blip_vit_l16

    text_cfg = text_cfg or BlipTextConfig.med_base()
    vision_cfg = vision_cfg or blip_vit_l16()
    sd = torch.load(pt_path, map_location="cpu", weights_only=True)
    sd = convert.imagereward_state_dict_from_pt(sd, text_cfg, vision_cfg)
    model = ImageRewardModel(text_cfg, vision_cfg, device="meta")
    model = model.to_empty(device=device)
    model.load_state_dict(sd)
    return model.eval().requires_grad_(False)
