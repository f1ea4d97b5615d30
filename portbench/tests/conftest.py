"""Fixtures of the benchmark's CPU tests: a copy of the benchmark's layout
with the CPU-sized SD3 cells of ``tiny/`` added as files, and a way to say
whether a card is visible, decided inside a fixture."""

from __future__ import annotations

import os
import shutil

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
REPO = os.path.dirname(BENCH)


@pytest.fixture
def tiny_root(tmp_path, monkeypatch):
    """A copy of ``portbench/`` (its configs, workloads, metrics and kernel
    groups) with the tiny configuration and cells added; the working
    directory is the repository's, where the prompt files are."""
    root = tmp_path / "bench"
    shutil.copytree(BENCH, root, ignore=shutil.ignore_patterns("tests", "__pycache__"))
    for kind in ("configs", "workloads"):
        for f in os.listdir(os.path.join(HERE, "tiny", kind)):
            shutil.copy(os.path.join(HERE, "tiny", kind, f), root / kind / f)
    monkeypatch.chdir(REPO)
    return str(root)


@pytest.fixture
def card():
    """Skips the test where no CUDA device is visible."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the benchmark's cells run on the card)")
    return torch.device("cuda")
