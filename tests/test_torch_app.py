"""The port's demo app (``adv_grpo_torch.cli.app``) against the JAX app,
driven through ``main`` with a faked ``gradio`` (the tests need no gradio), as the
JAX package's tests/test_app.py drives its own.

Both apps run on the tiny SD3 (random numpy weights carried by
``from_jax``) with a local hub layout of two peft adapters (``DINO/`` and
``PickScore/``, B factors of opposite sign). Checked: the picker's choices
exactly; the DINO adapter's image against the JAX app's from the latents
the JAX app draws for the seed (``PRNGKey(seed)``), within
1 uint8 level (fp32; a value can round either side of a level); the
adapters really swap (three different images, the same again on a repeat,
the base after an adapter equal to the base first); a hub repo id without
``huggingface_hub`` raises ``SystemExit`` in both packages.
"""

import sys
import types

import jax
import numpy as np
import pytest

from adv_grpo_torch.cli import app as t_app
from adv_grpo_torch.cli import common as t_common
from adv_grpo_torch.models.mmdit import MMDiTConfig as TMMDiTConfig
from adv_grpo_torch.models.vae import VAEConfig as TVAEConfig
from adv_grpo_torch.train.pipeline import SD3Pipeline as TSD3Pipeline
from adv_grpo_tpu.cli import app as j_app
from adv_grpo_tpu.cli import common as j_common
from adv_grpo_tpu.models.lora import lora_params
from adv_grpo_tpu.models.peft_lora import export_peft_lora
from tests.test_torch_models import jax_tiny_pipeline

RANK, ALPHA = 32, 64.0
STEPS, GUIDANCE = 2, 2.0


def _fake_gradio(captured):
    fake = types.ModuleType("gradio")

    class Interface:
        def __init__(self, fn=None, inputs=None, outputs=None, title=None):
            captured.update(fn=fn, inputs=inputs)

        def launch(self, server_port=None):
            captured["port"] = server_port

    fake.Interface = Interface
    for name in ("Textbox", "Dropdown", "Slider", "Number", "Image"):
        setattr(fake, name, lambda *a, __n=name, **k: types.SimpleNamespace(kind=__n, args=a,
                                                                            kwargs=k))
    return fake


@pytest.fixture(scope="module")
def apps(tmp_path_factory):
    hub = tmp_path_factory.mktemp("hub")
    jpipe = jax_tiny_pipeline(17, lora_rank=RANK, lora_alpha=ALPHA)
    flat = {k: np.asarray(v) for k, v in lora_params(jpipe.transformer_params["params"]).items()}
    for name, sign in (("DINO", 1.0), ("PickScore", -1.0)):
        rng = np.random.default_rng(5)
        export_peft_lora(str(hub / name), {
            k: (sign * 0.05 * rng.standard_normal(v.shape).astype(np.float32)
                if k.endswith("lora_b") else v) for k, v in flat.items()}, rank=RANK, alpha=ALPHA)
    captured = {"jax": {}, "port": {}}
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(j_common, "build_pipeline", lambda *a, **k: jpipe)
        mp.setattr(t_common, "build_pipeline", lambda *a, **k: TSD3Pipeline.from_jax(
            jpipe.transformer_params, jpipe.vae_params,
            TMMDiTConfig.tiny(lora_rank=RANK, lora_alpha=ALPHA),
            TVAEConfig.tiny(latent_channels=16), "cpu", text_seq_len=6))
        argv = ["--config", "smoke_sd3_fast", "--hub_repo", str(hub), "--latent_hw", "8"]
        for side, mod, extra in (("jax", j_app, []), ("port", t_app, ["--device", "cpu"])):
            mp.setitem(sys.modules, "gradio", _fake_gradio(captured[side]))
            mod.main(argv + extra)
    finally:
        mp.undo()
    return captured


def test_local_hub_layout_and_picker(apps):
    for side in ("jax", "port"):
        picker = next(i for i in apps[side]["inputs"] if i.kind == "Dropdown")
        assert picker.kwargs["choices"] == ["DINO", "PickScore", "base (untuned)"]
        assert apps[side]["port"] == 7860
    steps, guidance = (next(i for i in apps["port"]["inputs"] if i.kind == "Slider"
                            and i.kwargs["label"] == label).kwargs["value"]
                       for label in ("Steps", "Guidance"))
    assert (steps, guidance) == (40, 4.5)


def test_adapter_image_matches_the_jax_app(apps):
    lat = np.asarray(jax.random.normal(jax.random.PRNGKey(3), (1, 16, 8, 8)))
    got = apps["port"]["fn"]("a cat", "DINO", STEPS, GUIDANCE, 3, latents=lat)
    want = apps["jax"]["fn"]("a cat", "DINO", STEPS, GUIDANCE, 3)
    assert got.dtype == np.uint8 and got.shape == want.shape == (16, 16, 3)
    assert np.abs(got.astype(np.int16) - want.astype(np.int16)).max() <= 1


def test_adapters_swap_the_weights(apps):
    gen = apps["port"]["fn"]
    base = gen("a cat", "base (untuned)", STEPS, GUIDANCE, 0)
    dino = gen("a cat", "DINO", STEPS, GUIDANCE, 0)
    pick = gen("a cat", "PickScore", STEPS, GUIDANCE, 0)
    assert not np.array_equal(dino, base) and not np.array_equal(pick, dino)
    np.testing.assert_array_equal(gen("a cat", "DINO", STEPS, GUIDANCE, 0), dino)
    np.testing.assert_array_equal(gen("a cat", "base (untuned)", STEPS, GUIDANCE, 0), base)
    assert not np.array_equal(gen("a cat", "DINO", STEPS, GUIDANCE, 1), dino)  # the seed


def test_repo_id_without_the_hub_library_raises(monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, "huggingface_hub", None)
    for mod in (t_app, j_app):
        with pytest.raises(SystemExit, match="not a local directory"):
            mod.resolve_adapter_dir("benzweijia/Adv-GRPO", "DINO", str(tmp_path))


def test_app_without_gradio_raises(monkeypatch):
    monkeypatch.setitem(sys.modules, "gradio", None)
    with pytest.raises(SystemExit, match="gradio is not installed"):
        t_app.main(["--config", "smoke_sd3_fast", "--device", "cpu"])
