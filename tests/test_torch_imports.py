"""The port stays free of JAX, and its chip smoke script has no CPU fallback.

Both checks run in a subprocess, so the test process's own imports (JAX for
the parity tests) cannot mask an import the port makes.
"""

import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_MODULES = [
    "adv_grpo_torch", "adv_grpo_torch.kernels.build", "adv_grpo_torch.ops.fused_norms",
    "adv_grpo_torch.ops.joint_attention", "adv_grpo_torch.models.lora",
    "adv_grpo_torch.models.mmdit", "adv_grpo_torch.models.vae",
    "adv_grpo_torch.models.convert", "adv_grpo_torch.core.sde",
    "adv_grpo_torch.rollout.sampler", "adv_grpo_torch.train.pipeline",
    "adv_grpo_torch.config.base", "adv_grpo_torch.config.grpo",
    "adv_grpo_torch.cli.common", "adv_grpo_torch.cli.infer", "adv_grpo_torch.ops.attention",
    "adv_grpo_torch.core.grpo", "adv_grpo_torch.core.ema", "adv_grpo_torch.rewards.registry",
    "adv_grpo_torch.train.train_state", "adv_grpo_torch.train.grpo_trainer",
    "adv_grpo_torch.train.driver", "adv_grpo_torch.cli.train",
]


def _run(args, cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=300)


def test_port_imports_no_jax_flax_or_triton():
    code = ("import importlib, sys\n"
            f"for m in {PORT_MODULES!r}: importlib.import_module(m)\n"
            "print(sorted(m for m in ('jax', 'flax', 'optax', 'triton', 'ml_collections')"
            " if m in sys.modules))\n")
    proc = _run(["-c", code], REPO)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "[]"


def test_chip_smoke_fails_without_a_gpu():
    import torch

    if torch.cuda.is_available():
        pytest.skip("checks the no-GPU behaviour; a CUDA device is visible here")
    proc = _run(["chip_smoke.py"], REPO)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_chip_smoke_fails_outside_the_repo(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    proc = _run(["chip_smoke.py"], str(tmp_path))
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
