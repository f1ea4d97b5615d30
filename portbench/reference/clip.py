"""The PickScore reward, plain: CLIP-H/14 text and vision towers (OpenCLIP's
pre-LN transformer, exact-erf GELU, causal text mask, the text pooled at the
first end-of-text token or position 0 where there is none), the projections,
and score = exp(logit_scale) * <text, image> / 26 on unit features. Images
reach the tower as PickScore's processor makes them: [-1, 1] -> uint8
(rounding half up) -> PIL's bicubic resize to 224 (antialiased, each pass
rounded to uint8, as PIL's fixed-point filter does) -> CLIP's mean and std.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference import FP32, Precision

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
DIVISOR = 26.0


def spec(text: dict, vision: dict):
    """(name, shape, dtype) of the dual encoder's parameters."""
    f32 = torch.float32
    out = [("logit_scale", (), f32)]

    def lin(name, i, o, bias=True):
        out.append((f"{name}.weight", (o, i), f32))
        if bias:
            out.append((f"{name}.bias", (o,), f32))

    def ln(name, d):
        out.append((f"{name}.weight", (d,), f32))
        out.append((f"{name}.bias", (d,), f32))

    def layer(name, d, inter, n1, n2):
        ln(f"{name}.{n1}", d)
        for p in ("q_proj", "k_proj", "v_proj", "out_proj"):
            lin(f"{name}.{p}", d, d)
        ln(f"{name}.{n2}", d)
        lin(f"{name}.fc1", d, inter)
        lin(f"{name}.fc2", inter, d)

    t = "text_model"
    out.append((f"{t}.token_embedding.weight", (text["vocab_size"], text["hidden_size"]), f32))
    out.append((f"{t}.position_embedding", (text["max_position_embeddings"],
                                            text["hidden_size"]), f32))
    for i in range(text["num_layers"]):
        layer(f"{t}.layers.{i}", text["hidden_size"], text["intermediate_size"],
              "layer_norm1", "layer_norm2")
    ln(f"{t}.final_layer_norm", text["hidden_size"])
    lin(f"{t}.text_projection", text["hidden_size"], text["projection_dim"], bias=False)
    v = "vision_model"
    d, p = vision["hidden_size"], vision["patch_size"]
    n_patch = (vision["image_size"] // p) ** 2
    lin(f"{v}.patch_embed", p * p * 3, d)
    out.append((f"{v}.class_embedding", (d,), f32))
    out.append((f"{v}.position_embedding", (1 + n_patch, d), f32))
    ln(f"{v}.pre_layernorm", d)
    for i in range(vision["num_layers"]):
        layer(f"{v}.layers.{i}", d, vision["intermediate_size"], "norm1", "norm2")
    ln(f"{v}.post_layernorm", d)
    lin(f"{v}.visual_projection", d, vision["projection_dim"], bias=False)
    return out


def _act(name):
    if name == "quick_gelu":
        return lambda x: x * torch.sigmoid(1.702 * x)
    return F.gelu


def _bicubic(x, a=-0.5):
    x = np.abs(x)
    return np.where(x < 1, ((a + 2) * x - (a + 3)) * x * x + 1,
                    np.where(x < 2, (((x - 5) * x + 8) * x - 4) * a, 0.0))


def pil_bicubic_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) weights of PIL's antialiased bicubic resample, snapped to
    its 22-bit fixed point."""
    scale = n_in / n_out
    fs = max(scale, 1.0)
    W = np.zeros((n_out, n_in), np.float64)
    for i in range(n_out):
        c = (i + 0.5) * scale
        lo, hi = max(int(c - 2 * fs + 0.5), 0), min(int(c + 2 * fs + 0.5), n_in)
        xs = np.arange(lo, hi)
        w = _bicubic((xs - c + 0.5) / fs)
        w = w / w.sum()
        W[i, lo:hi] = np.round(w * (1 << 22)) / (1 << 22)
    return W.astype(np.float32)


def _u8(x):
    return torch.floor(x * 255.0 + 0.5).clamp(0.0, 255.0) / 255.0


def preprocess(images, size: int):
    """(B, 3, H, W) in [-1, 1] -> CLIP pixels (B, 3, size, size)."""
    x = _u8((images.float() * 0.5 + 0.5).clamp(0.0, 1.0))
    ww = torch.from_numpy(pil_bicubic_matrix(x.shape[3], size)).to(x.device)
    wh = torch.from_numpy(pil_bicubic_matrix(x.shape[2], size)).to(x.device)
    x = _u8(wh @ _u8(x @ ww.t())).clamp(0.0, 1.0)
    mean = torch.tensor(CLIP_MEAN, device=x.device).view(1, 3, 1, 1)
    std = torch.tensor(CLIP_STD, device=x.device).view(1, 3, 1, 1)
    return (x - mean) / std


class PickScore:
    def __init__(self, text: dict, vision: dict, weights: Dict[str, torch.Tensor],
                 prec: Precision = FP32):
        self.t, self.v, self.w, self.prec = text, vision, weights, prec

    def _lin(self, name, x):
        return F.linear(x, self.w[f"{name}.weight"], self.w.get(f"{name}.bias"))

    def _ln(self, name, x, eps):
        return F.layer_norm(x, (x.shape[-1],), self.w[f"{name}.weight"], self.w[f"{name}.bias"],
                            eps)

    def _layer(self, name, x, cfg, n1, n2, mask=None):
        B, S, D = x.shape
        H = cfg["num_heads"]
        h = self._ln(f"{name}.{n1}", x, cfg["layer_norm_eps"])
        q, k, v = (self._lin(f"{name}.{p}", h).view(B, S, H, D // H).transpose(1, 2)
                   for p in ("q_proj", "k_proj", "v_proj"))
        s = (q @ k.transpose(-1, -2)) * (D // H) ** -0.5
        if mask is not None:
            s = s.masked_fill(~mask, torch.finfo(torch.float32).min)
        o = (torch.softmax(s, -1) @ v).transpose(1, 2).reshape(B, S, D)
        x = x + self._lin(f"{name}.out_proj", o)
        h = self._ln(f"{name}.{n2}", x, cfg["layer_norm_eps"])
        return x + self._lin(f"{name}.fc2", _act(cfg["hidden_act"])(self._lin(f"{name}.fc1", h)))

    def text_features(self, ids):
        t, c = "text_model", self.t
        B, S = ids.shape
        x = F.embedding(ids, self.w[f"{t}.token_embedding.weight"]) + \
            self.w[f"{t}.position_embedding"][:S]
        mask = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
        for i in range(c["num_layers"]):
            x = self._layer(f"{t}.layers.{i}", x, c, "layer_norm1", "layer_norm2", mask)
        x = self._ln(f"{t}.final_layer_norm", x, c["layer_norm_eps"])
        eos = (ids == c["eos_token_id"]).int().argmax(dim=1)
        pooled = x[torch.arange(B, device=x.device), eos]
        f = self._lin(f"{t}.text_projection", pooled)
        return f / f.norm(dim=-1, keepdim=True)

    def image_features(self, pixels):
        v, c = "vision_model", self.v
        B, _, Hh, Ww = pixels.shape
        p = c["patch_size"]
        x = pixels.permute(0, 2, 3, 1).reshape(B, Hh // p, p, Ww // p, p, 3)
        x = x.transpose(2, 3).reshape(B, (Hh // p) * (Ww // p), p * p * 3)
        x = self._lin(f"{v}.patch_embed", x)
        x = torch.cat([self.w[f"{v}.class_embedding"].expand(B, 1, -1), x], dim=1)
        x = x + self.w[f"{v}.position_embedding"][: x.shape[1]]
        x = self._ln(f"{v}.pre_layernorm", x, c["layer_norm_eps"])
        for i in range(c["num_layers"]):
            x = self._layer(f"{v}.layers.{i}", x, c, "norm1", "norm2")
        cls = self._ln(f"{v}.post_layernorm", x, c["layer_norm_eps"])[:, 0]
        f = self._lin(f"{v}.visual_projection", cls)
        return f / f.norm(dim=-1, keepdim=True)

    @torch.no_grad()
    def score(self, images, ids):
        with self.prec.tf32_scope():
            img = self.image_features(preprocess(images, self.v["image_size"]))
            txt = self.text_features(ids)
            return torch.exp(self.w["logit_scale"]) * (txt * img).sum(-1) / DIVISOR
