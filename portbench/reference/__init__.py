"""The plain reference: fp32 PyTorch (TF32 off) written from the models'
published equations, over the same named weights the program is given.
It imports nothing of ``adv_grpo_torch``, of ``chip_smoke.py`` or of the
port's tests, and takes nothing the program made: it draws its own weights
and inputs from the seed and reads the program's outputs only to judge them.

``Precision`` selects the plain fp32 path, or the control's lower precision:
every product of the transformer on fp8 (e4m3) operands with a per-tensor
scale (the backward passes the gradient straight through the rounding),
the VAE and the reward towers in TF32."""

from __future__ import annotations

import contextlib
import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Precision:
    control: bool = False

    def operand(self, t: torch.Tensor) -> torch.Tensor:
        """A product's operand: itself in fp32, or rounded to fp8 e4m3
        after scaling its largest magnitude to the format's 448."""
        if not self.control:
            return t
        s = t.detach().abs().amax().clamp_min(1e-30) / 448.0
        q = (t.detach() / s).to(torch.float8_e4m3fn).to(torch.float32) * s
        return t + (q - t.detach())  # the rounded value; the gradient passes straight

    def linear(self, x, w, b=None):
        y = self.operand(x) @ self.operand(w).t()
        return y if b is None else y + b

    @contextlib.contextmanager
    def tf32_scope(self):
        """TF32 off for fp32 products and convolutions (on for the control)."""
        saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = self.control
        torch.backends.cudnn.allow_tf32 = self.control
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


FP32 = Precision(False)
CONTROL = Precision(True)
