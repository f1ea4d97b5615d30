"""Nothing a run loads is JAX or the JAX package, compared by whole
top-level name; the reference loads nothing of the port; a run with no
visible card prints no result and fails, with no fall-back to the CPU."""

from __future__ import annotations

import json
import subprocess
import sys

from portbench.tests.conftest import REPO

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "adv_grpo_tpu"}


def _python(code: str, env=None):
    return subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=600, env=env)


def test_the_top_level_name_is_compared_whole():
    import portbench.run as r

    saved = dict(sys.modules)
    try:
        sys.modules["adv_grpo_tpu_like"] = sys.modules["json"]
        assert "adv_grpo_tpu" not in r.forbidden_modules()
        sys.modules["adv_grpo_tpu.models"] = sys.modules["json"]
        assert r.forbidden_modules() == ["adv_grpo_tpu"]
    finally:
        sys.modules.clear()
        sys.modules.update(saved)


def test_a_tiny_run_loads_nothing_of_jax(tiny_root):
    code = f"""
import json, sys
from portbench import run
res, _ = run.run_cell("tiny-grpo", 1, 0.0, False, device="cpu", root={tiny_root!r})
print(json.dumps(sorted({{m.split('.', 1)[0] for m in sys.modules}})))
"""
    out = _python(code)
    assert out.returncode == 0, out.stderr[-2000:]
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "adv_grpo_torch" in loaded and not loaded & FORBIDDEN


def test_the_reference_loads_nothing_of_the_port():
    code = """
import json, sys
import portbench.reference, portbench.reference.sd3, portbench.reference.clip
import portbench.reference.grpo, portbench.reference.wan, portbench.reference.jpeg
print(json.dumps(sorted({m.split('.', 1)[0] for m in sys.modules})))
"""
    out = _python(code)
    assert out.returncode == 0, out.stderr[-2000:]
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not loaded & (FORBIDDEN | {"adv_grpo_torch", "chip_smoke"})


def test_no_card_no_result():
    import os

    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                          "sd3m-grpo-pickscore", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=REPO, capture_output=True, text=True, timeout=600, env=env)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "no CUDA device" in out.stderr
