"""The port stays free of JAX and of the JAX package, and its chip smoke
script has no CPU fallback.

The import checks run in a subprocess, so the test process's own imports (JAX
and adv_grpo_tpu for the parity tests) cannot mask an import the port makes.
Every module of the package is imported, found by walking its directory, so
a new module is covered without being listed.
"""

import os
import re
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_DIR = os.path.join(REPO, "adv_grpo_torch")


def _port_modules():
    mods = []
    for root, _, files in os.walk(PORT_DIR):
        for f in sorted(files):
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(root, f), REPO)[:-3]
                mods.append(rel.replace(os.sep, ".").removesuffix(".__init__"))
    return sorted(mods)


PORT_MODULES = _port_modules()


def _run(args, cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=300)


def test_port_imports_no_jax_flax_or_triton():
    """Nor ``transformers``, ``tokenizers``, ``regex``, ``ftfy`` or
    ``sentencepiece``: the port tokenizes in plain Python
    (``data.tokenizers``); nor ``msgpack`` (``utils.msgpack_io`` reads and
    writes flax's files) nor ``gradio`` / ``huggingface_hub``, which only
    ``cli.app`` imports, when it runs; nor ``requests`` / ``urllib3``
    (``rewards.remote`` posts through ``http.client``) nor ``ImageReward``,
    which ``rewards.vlm`` tries only when an ImageReward scorer is built."""
    code = ("import importlib, sys\n"
            f"for m in {PORT_MODULES!r}: importlib.import_module(m)\n"
            "print(sorted(m for m in ('jax', 'flax', 'optax', 'triton', 'ml_collections',"
            " 'transformers', 'tokenizers', 'regex', 'ftfy', 'sentencepiece', 'msgpack',"
            " 'gradio', 'huggingface_hub', 'requests', 'urllib3', 'ImageReward')"
            " if m in sys.modules))\n")
    proc = _run(["-c", code], REPO)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "[]"


def test_port_loads_nothing_of_the_jax_package():
    """After importing every port module, no ``adv_grpo_tpu`` module is loaded:
    the port keeps its own copies of the JAX package's jax-free modules."""
    assert len(PORT_MODULES) > 30 and "adv_grpo_torch.models.flux" in PORT_MODULES
    assert {"adv_grpo_torch.models.clip_text", "adv_grpo_torch.models.vit",
            "adv_grpo_torch.rewards.preprocess", "adv_grpo_torch.rewards.scorers",
            "adv_grpo_torch.adversarial.clip_criterion",
            "adv_grpo_torch.adversarial.dino_hinge", "adv_grpo_torch.utils.safetensors_io",
            "adv_grpo_torch.models.peft_lora",
            "adv_grpo_torch.train.checkpoint", "adv_grpo_torch.models.t5",
            "adv_grpo_torch.models.encode_prompt",
            "adv_grpo_torch.cli.precompute_embeds",
            "adv_grpo_torch.data.tokenizers", "adv_grpo_torch.cli.eval",
            "adv_grpo_torch.cli.generate_refs", "adv_grpo_torch.cli.validate_refs",
            "adv_grpo_torch.cli.finetune_pickscore", "adv_grpo_torch.cli.app",
            "adv_grpo_torch.config.sft", "adv_grpo_torch.config.dpo",
            "adv_grpo_torch.data.tooling", "adv_grpo_torch.utils.msgpack_io",
            "adv_grpo_torch.models.siglip", "adv_grpo_torch.models.blip",
            "adv_grpo_torch.models.stylegan_d", "adv_grpo_torch.rewards.remote",
            "adv_grpo_torch.rewards.vlm"} <= set(PORT_MODULES)
    code = ("import importlib, sys\n"
            f"for m in {PORT_MODULES!r}: importlib.import_module(m)\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] == 'adv_grpo_tpu'))\n")
    proc = _run(["-c", code], REPO)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "[]"


_TPU_IMPORT = re.compile(r"^\s*(from\s+adv_grpo_tpu[\s.]|import\s+adv_grpo_tpu\b)|"
                         r"import_module\(\s*[\"']adv_grpo_tpu", re.M)


@pytest.mark.parametrize("where", ["adv_grpo_torch", "chip_smoke.py"])
def test_no_source_imports_the_jax_package(where):
    """No source line of the port or of chip_smoke.py imports adv_grpo_tpu,
    at top level or inside a function (where the subprocess check above
    cannot see it unless the function runs)."""
    path = os.path.join(REPO, where)
    files = ([path] if where.endswith(".py") else
             [os.path.join(r, f) for r, _, fs in os.walk(path) for f in fs if f.endswith(".py")])
    assert files
    offenders = []
    for f in files:
        with open(f) as fh:
            for n, line in enumerate(fh.read().splitlines(), 1):
                if _TPU_IMPORT.search(line):
                    offenders.append(f"{os.path.relpath(f, REPO)}:{n}: {line.strip()}")
    assert not offenders, "\n".join(offenders)


_TOKENIZER_IMPORT = re.compile(
    r"^\s*(from|import)\s+(transformers|tokenizers|regex|ftfy|sentencepiece)\b", re.M)


@pytest.mark.parametrize("where", ["adv_grpo_torch", "chip_smoke.py"])
def test_no_source_imports_a_tokenizer_package(where):
    """No source line of the port or of chip_smoke.py imports
    ``transformers``, ``tokenizers``, ``regex``, ``ftfy`` or
    ``sentencepiece``, inside a function either: the card's machine has
    none of them. One import is allowed (``_OPTIONAL_IMPORTS``): the
    Qwen2.5-VL judge's checkpoint path, which the JAX package also runs
    through ``transformers`` and which raises naming the package where it
    does not import (tests/test_torch_remote_rewards.py); its injected
    ``generate_fn`` needs nothing."""
    path = os.path.join(REPO, where)
    files = ([path] if where.endswith(".py") else
             [os.path.join(r, f) for r, _, fs in os.walk(path) for f in fs if f.endswith(".py")])
    offenders = []
    for f in files:
        with open(f) as fh:
            offenders += [f"{os.path.relpath(f, REPO)}: {m.group(0).strip()}"
                          for m in _TOKENIZER_IMPORT.finditer(fh.read())]
    assert not set(offenders) - _OPTIONAL_IMPORTS, "\n".join(offenders)


_OPTIONAL_IMPORTS = {"adv_grpo_torch/rewards/vlm.py: import transformers"}


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
