"""The port's batch-eval CLI (``adv_grpo_torch.cli.eval``) against the JAX
``cli/eval.py``.

Both CLIs run ``--limit 5 --batch 8 --rewards --latent_hw 8`` on one model:
the tiny SD3 (``smoke_sd3_fast``, with a peft ``--lora`` adapter whose B
factors are non-zero) and the tiny Flux (``flux_smoke``), random numpy
weights in the JAX trees carried to the port by ``from_jax`` (each package's
``build_pipeline`` is replaced by one that returns them). The batch is 8
because the JAX eval pads its batch to a multiple of the 8 virtual devices.
The port starts from the latents the JAX eval draws (``PRNGKey(0)`` for
every batch; Flux: its ``prepare_latents`` of the key's first split),
passed as ``main(latents=)``.

Exact: the PNG names, ``prompt2img.json`` and ``prompt2img_rank0.json``,
the reward keys and ``reward_counts`` (5: the 3 padding rows left out).
Within tolerance: the images (fp32, 3 / 4 steps of a 2-layer model;
at most 1 uint8 level apart, as a value can round either side of a level)
and the reward means (``jpeg_compressibility``, the JPEG size of those
uint8 images: 1e-4 relative). The padding rows are left out of the means:
the port's means equal those of its 5 saved images scored alone.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from adv_grpo_torch.cli import common as t_common
from adv_grpo_torch.cli import eval as t_eval
from adv_grpo_torch.models.mmdit import MMDiTConfig as TMMDiTConfig
from adv_grpo_torch.models.vae import VAEConfig as TVAEConfig
from adv_grpo_torch.rewards.host import jpeg_compressibility
from adv_grpo_torch.train.pipeline import SD3Pipeline as TSD3Pipeline
from adv_grpo_tpu.cli import common as j_common
from adv_grpo_tpu.cli import eval as j_eval
from adv_grpo_tpu.models.lora import lora_params
from adv_grpo_tpu.models.peft_lora import export_peft_lora
from tests.test_torch_flux import pipes  # noqa: F401  (the tiny Flux in both packages)
from tests.test_torch_models import jax_tiny_pipeline

RANK, ALPHA = 32, 64.0  # the base preset's train.lora_rank / lora_alpha
ARGV = ["--limit", "5", "--batch", "8", "--rewards", "--latent_hw", "8"]
MEAN_RTOL = 1e-4


def _run_both(monkeypatch, tmp, config, jpipe, make_tpipe, latents, extra=()):
    """Both CLIs on ``config`` with the given pipelines; returns ((jax dir,
    summary), (port dir, summary))."""
    monkeypatch.setattr(j_common, "build_pipeline", lambda *a, **k: jpipe)
    monkeypatch.setattr(t_common, "build_pipeline", lambda *a, **k: make_tpipe())
    jdir, tdir = str(tmp / "jax"), str(tmp / "port")
    jsum = j_eval.main(["--config", config, "--out_dir", jdir, *ARGV, *extra])
    tsum = t_eval.main(["--config", config, "--out_dir", tdir, "--device", "cpu", *ARGV, *extra],
                       latents=latents)
    return (jdir, jsum), (tdir, tsum)


@pytest.fixture(scope="module")
def sd3_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("eval_sd3")
    jpipe = jax_tiny_pipeline(11, lora_rank=RANK, lora_alpha=ALPHA)
    flat = {k: np.asarray(v) for k, v in lora_params(jpipe.transformer_params["params"]).items()}
    rng = np.random.default_rng(3)
    adapter = {k: (rng.standard_normal(v.shape).astype(np.float32) * 0.05
                   if k.endswith("lora_b") else v) for k, v in flat.items()}
    export_peft_lora(str(tmp / "adapter"), adapter, rank=RANK, alpha=ALPHA)

    def make_tpipe():
        return TSD3Pipeline.from_jax(
            jpipe.transformer_params, jpipe.vae_params,
            TMMDiTConfig.tiny(lora_rank=RANK, lora_alpha=ALPHA),
            TVAEConfig.tiny(latent_channels=16), "cpu", text_seq_len=6)

    lat = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (8, 16, 8, 8)))
    mp = pytest.MonkeyPatch()
    try:
        runs = _run_both(mp, tmp, "smoke_sd3_fast", jpipe, make_tpipe, lat,
                         ["--lora", str(tmp / "adapter")])
        # the port once more without the adapter: the same files, other images
        plain = t_eval.main(["--config", "smoke_sd3_fast", "--out_dir", str(tmp / "plain"),
                             "--device", "cpu", *ARGV], latents=lat)
    finally:
        mp.undo()
    return runs, plain


@pytest.fixture(scope="module")
def flux_runs(tmp_path_factory, pipes):  # noqa: F811
    tmp = tmp_path_factory.mktemp("eval_flux")
    jpipe, tpipe = pipes
    k_lat, _ = jax.random.split(jax.random.PRNGKey(0))
    lat = np.asarray(jpipe.prepare_latents(k_lat, 8, 8))
    mp = pytest.MonkeyPatch()
    try:
        return _run_both(mp, tmp, "flux_smoke", jpipe, lambda: tpipe, lat)
    finally:
        mp.undo()


def _pngs(d):
    return sorted(f for f in os.listdir(d) if f.endswith(".png"))


def _json(d, name):
    with open(os.path.join(d, name)) as f:
        return json.load(f)


@pytest.mark.parametrize("family", ["sd3", "flux"])
def test_files_json_and_counts_equal_jax(family, sd3_runs, flux_runs):
    (jdir, jsum), (tdir, tsum) = sd3_runs[0] if family == "sd3" else flux_runs
    assert _pngs(tdir) == _pngs(jdir) == [f"node0_rank0_{i:05d}_0.png" for i in range(5)]
    for name in ("prompt2img.json", "prompt2img_rank0.json"):
        assert _json(tdir, name) == _json(jdir, name)
    assert tsum["n_saved"] == jsum["n_saved"] == 5
    assert set(tsum["reward_means"]) == set(jsum["reward_means"]) == {
        "avg", "jpeg_compressibility"}
    assert tsum["reward_counts"] == jsum["reward_counts"] == {
        "avg": 5, "jpeg_compressibility": 5}


@pytest.mark.parametrize("family", ["sd3", "flux"])
def test_images_and_means_match_jax(family, sd3_runs, flux_runs):
    (jdir, jsum), (tdir, tsum) = sd3_runs[0] if family == "sd3" else flux_runs
    for name in _pngs(jdir):
        got = np.asarray(Image.open(os.path.join(tdir, name)), np.int16)
        want = np.asarray(Image.open(os.path.join(jdir, name)), np.int16)
        assert np.abs(got - want).max() <= 1, name
    for key, want in jsum["reward_means"].items():
        np.testing.assert_allclose(tsum["reward_means"][key], want, rtol=MEAN_RTOL)


def test_padding_is_left_out_of_the_means(sd3_runs):
    (_, _), (tdir, tsum) = sd3_runs[0]
    u8 = np.stack([np.asarray(Image.open(os.path.join(tdir, n))) for n in _pngs(tdir)])
    alone = np.asarray(jpeg_compressibility(u8), np.float64).mean()
    # the PNGs are the scored images rounded to uint8 as the reward rounds them
    np.testing.assert_allclose(tsum["reward_means"]["jpeg_compressibility"], alone, rtol=1e-12)


def test_lora_changes_the_images_not_the_files(sd3_runs):
    ((_, _), (tdir, tsum)), plain = sd3_runs
    assert _pngs(plain["out_dir"]) == _pngs(tdir)
    assert _json(plain["out_dir"], "prompt2img.json") == _json(tdir, "prompt2img.json")
    assert plain["reward_counts"] == tsum["reward_counts"]
    differ = [not np.array_equal(np.asarray(Image.open(os.path.join(tdir, n))),
                                 np.asarray(Image.open(os.path.join(plain["out_dir"], n))))
              for n in _pngs(tdir)]
    assert all(differ)


def test_eval_drops_reference_rewards_without_a_store(tmp_path, monkeypatch, capsys):
    """eval_sd3_fast scores pickscore and image_similarity; with no
    reference store the second is dropped, as in the JAX eval."""
    jpipe = jax_tiny_pipeline(2, lora_rank=RANK, lora_alpha=ALPHA)
    monkeypatch.setattr(t_common, "build_pipeline", lambda *a, **k: TSD3Pipeline.from_jax(
        jpipe.transformer_params, jpipe.vae_params,
        TMMDiTConfig.tiny(lora_rank=RANK, lora_alpha=ALPHA),
        TVAEConfig.tiny(latent_channels=16), "cpu", text_seq_len=6))
    out = t_eval.main(["--config", "eval_sd3_fast", "--out_dir", str(tmp_path), "--device", "cpu",
                       "--limit", "2", "--batch", "2", "--rewards", "--latent_hw", "8",
                       "--set", "smoke_test=True", "--set", "pretrained.model=",
                       "--set", "sample.eval_num_steps=2"])
    assert "skipping ['image_similarity']" in capsys.readouterr().out
    assert set(out["reward_counts"]) == {"avg", "pickscore"}
    assert out["reward_counts"]["pickscore"] == 2 and np.isfinite(out["reward_means"]["avg"])


def test_cuda_device_raises_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the no-GPU behaviour; a CUDA device is visible here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_eval.main(["--config", "smoke_sd3_fast", "--out_dir", str(tmp_path), "--limit", "1"])
