"""The port's co-trained PickScore discriminator against the JAX package, on
the CPU.

The D-step on the tiny CLIP towers (JAX params carried across by
``clip_dual_state_dict_from_jax``) against ``make_pickscore_d_step``: the
tail's gradient within 1e-4 relative (of the tail gradient's largest entry:
the exact gradient of a key bias is zero, so its entries are fp32 noise), the
loss and accuracy within 1e-5, the frozen tensors bitwise unchanged, and the
updated tail within 1e-3 * d_lr absolute. Adam's first step is about
lr * sign(g), so the update is compared where the gradient is not near zero
(at least 1e-3 of that largest entry); the other entries are held by their
gradient. The test takes d_lr = 1e-3: at the preset's 5e-6 an update
lies under the fp32 spacing of a parameter near 1, and the comparison would
see only rounding.

Then the trainer on the port's tiny SD3: the adaptive gate (ports of
tests/test_trainer_e2e.py:318-352 and :435-462), a real D-epoch leaving the
frozen 'pickscore' score bitwise unchanged, and the CLI on the co-train
preset.
"""

import json
import os
import sys
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adv_grpo_torch.cli import train as t_train
from adv_grpo_torch.cli.common import (
    apply_overrides, build_pipeline, make_hash_text_encoder, resolve_config)
from adv_grpo_torch.data.datasets import TextPromptDataset
from adv_grpo_torch.models.convert import clip_dual_state_dict_from_jax
from adv_grpo_torch.rewards.registry import multi_score
from adv_grpo_torch.train import grpo_trainer as t_trainer
from adv_grpo_torch.train.driver import DiscriminatorBundle, GRPOTrainer
from adv_grpo_tpu.adversarial import clip_criterion as j_crit
from adv_grpo_tpu.models.clip_text import CLIPTextConfig as JTextConfig
from adv_grpo_tpu.models.vit import ViTConfig as JViTConfig
from adv_grpo_tpu.rewards.scorers import PickScoreScorer as JPickScore
from adv_grpo_tpu.train import grpo_trainer as j_trainer
from tests.test_torch_clip import port_scorer

D_LR = 1e-3


def _images(seed, n=4, hw=64):
    return np.random.default_rng(seed).uniform(-1, 1, (n, 3, hw, hw)).astype(np.float32)


def _sd(tree, ts):
    return clip_dual_state_dict_from_jax(jax.device_get(tree), ts.clip.text_model.cfg,
                                         ts.clip.vision_model.cfg)


@pytest.mark.parametrize("tune_layer", [-1, 0], ids=["last_layer", "all_layers"])
def test_d_steps_match_jax(tune_layer):
    js = JPickScore(JTextConfig.tiny(projection_dim=16), JViTConfig.tiny(projection_dim=16),
                    image_size=28)
    params = js.init_params(jax.random.PRNGKey(1))
    ts = port_scorer(params)
    start = {k: v.clone() for k, v in ts.clip.state_dict().items()}
    mask = t_trainer.scorer_trainable_mask(ts.clip, tune_layer)
    j_mask = _sd(j_trainer.scorer_trainable_mask(params, tune_layer), ts)
    assert mask == {k: bool(v) for k, v in j_mask.items()}
    trained = {k for k, on in mask.items() if on}
    assert trained and all(k.startswith("vision_model.layers.") for k in trained)

    j_step, j_opt = j_trainer.make_pickscore_d_step(js, tune_layer, D_LR)(params)
    t_step, t_opt, tail = t_trainer.make_pickscore_d_step(ts, tune_layer, D_LR)
    assert sorted(n for n, p in ts.clip.named_parameters() if p.requires_grad) == sorted(trained)
    jp, big = params, {}
    for i in range(2):
        real, fake = _images(10 + i), _images(20 + i)
        ids = np.full((4, 16), 3, np.int32)
        args = (jnp.asarray(real), jnp.asarray(fake), jnp.asarray(ids))
        j_grad = _sd(jax.grad(
            lambda p: j_crit.pickscore_d_step_loss_and_acc(js, p, *args)[0])(jp), ts)
        jp, j_opt, j_loss, j_acc = j_step(jp, j_opt, *args)
        tail, t_opt, loss, acc = t_step(tail, t_opt, real, fake, ids)
        np.testing.assert_allclose(loss.item(), float(j_loss), rtol=0, atol=1e-5)
        np.testing.assert_allclose(acc.item(), float(j_acc), rtol=0, atol=1e-5)
        want_params = _sd(jp, ts)
        scale = max(np.abs(j_grad[name].numpy()).max() for name in trained)
        for name, p in ts.clip.named_parameters():
            if name not in trained:
                assert torch.equal(p.detach(), start[name]), name
                continue
            w = j_grad[name].numpy()
            np.testing.assert_allclose(p.grad.numpy(), w, rtol=1e-4, atol=1e-4 * scale,
                                       err_msg=name)
            big[name] = big.get(name, True) & (np.abs(w) >= 1e-3 * scale)
            got, want = p.detach().numpy(), want_params[name].numpy()
            np.testing.assert_allclose(got[big[name]], want[big[name]], rtol=0,
                                       atol=1e-3 * D_LR, err_msg=name)
            assert not np.array_equal(got, start[name].numpy()), name
    for name, v in ts.clip.state_dict().items():
        if name not in trained:
            assert torch.equal(v, start[name])


# ── the trainer on the tiny SD3 ───────────────────────────────────────────


def brightness_reward(images, prompts, metadata=None, ref_images=None, only_strict=True):
    """The JAX tests' reward: mean brightness plus a per-prompt offset."""
    scores = np.asarray(images, np.float32).mean(axis=(1, 2, 3))
    avg = scores + np.array([zlib.crc32(p.encode()) % 7 / 70.0 for p in prompts])
    return {"brightness": avg, "avg": avg}, {}


def tiny_config(**overrides):
    """The JAX trainer tests' ``tiny_config`` (pickscore_cotrain_sd3_fast cut
    to 3-step rollouts of 2-image groups, 2 sampling batches), on one
    process: 2 prompt slots a batch (the JAX mesh has 8 devices)."""
    cfg = apply_overrides(resolve_config("pickscore_cotrain_sd3_fast"), [
        "smoke_test=True", "sample.num_steps=3", "sample.train_num_steps=2",
        "sample.mini_num_image_per_prompt=2", "sample.num_image_per_prompt=4",
        "sample.num_batches_per_epoch=2", "train.gradient_accumulation_steps=1",
        "train.batch_size=2", "train_d=False", "save_dir=", "wandb_init=False", "json_path=",
        "sample.train_batch_size=2"])
    for k, v in overrides.items():
        cfg[k] = v
    return cfg


class _Prompts:
    def __init__(self, n=16):
        self.prompts = [f"prompt {i}" for i in range(n)]

    def __len__(self):
        return len(self.prompts)

    def __getitem__(self, i):
        return {"prompt": self.prompts[i], "metadata": {}}


class _RefStore:
    def __init__(self, value):
        self.value = value

    def get_batch(self, prompts, rng=None):
        return np.full((len(prompts), 1, 3, 16, 16), self.value, np.float32)


@pytest.fixture(scope="module")
def tiny_pipeline():
    return build_pipeline(tiny_config(), latent_hw=8, device="cpu")


def make_trainer(pipeline, cfg, **kw):
    mc = pipeline.mmdit_cfg
    encode = make_hash_text_encoder(6, mc.joint_attention_dim, mc.pooled_projection_dim)
    return GRPOTrainer(cfg, pipeline, _Prompts(), encode, brightness_reward, latent_hw=8, **kw)


def _fake_disc(calls, new_params=None):
    def step(params, opt, real, fake, ids):
        calls.append((real.shape, fake.shape, ids.shape))
        return (new_params(params) if new_params else params), opt, 0.1, 0.75

    return DiscriminatorBundle("pickscore", step, None, {"w": 0.0},
                               tokenize=lambda ps: np.zeros((len(ps), 4), np.int32))


def test_pickscore_adaptive_gate(tiny_pipeline):
    """Bright references outscore the generated images: a G epoch, no D
    call. Dark ones: a D-epoch, one D-step per sampling batch over the
    whole epoch's pairs, no policy microstep, the step counter advanced."""
    cfg = tiny_config(train_d=True)
    calls = []
    t1 = make_trainer(tiny_pipeline, cfg, discriminator=_fake_disc(calls),
                      reference_store=_RefStore(5.0))
    t1.run(max_epochs=1)
    assert calls == [] and t1.state.micro_step > 0

    t2 = make_trainer(tiny_pipeline, cfg, discriminator=_fake_disc(calls),
                      reference_store=_RefStore(-5.0))
    t2.run(max_epochs=1)
    assert len(calls) == cfg.sample.num_batches_per_epoch
    assert all(c == ((4, 3, 16, 16), (4, 3, 16, 16), (4, 4)) for c in calls)
    assert t2.state.micro_step == 0 and t2.state.global_step == 1


def test_d_step_updates_reward_context(tiny_pipeline):
    """After a D-epoch the co-trained reward scores with the new params."""
    import types

    cfg = tiny_config(train_d=True)
    disc = _fake_disc([], new_params=lambda p: {"w": p["w"] + 1.0})
    ctx = types.SimpleNamespace(pickscore_params=disc.params)
    trainer = make_trainer(tiny_pipeline, cfg, discriminator=disc,
                           reference_store=_RefStore(-5.0), reward_ctx=ctx)
    trainer.run(max_epochs=1)
    assert ctx.pickscore_params["w"] == cfg.sample.num_batches_per_epoch


@pytest.mark.parametrize("kind", ["dino", "dino_patch", "dino_multi"])
def test_dino_discriminators_still_raise_with_their_name(tiny_pipeline, kind):
    """A preset that trains a DINO discriminator, given a bundle that trains
    another kind, raises naming the preset's kind (the DINO discriminators
    themselves are ported: tests/test_torch_dino_cotrain.py)."""
    with pytest.raises(ValueError, match=kind):
        make_trainer(tiny_pipeline, tiny_config(train_d=True, discriminator=kind),
                     discriminator=_fake_disc([]))


def _refs(tmp_path, prompts, value=None):
    """PNG reference images and their prompt -> files map in ``tmp_path``."""
    from PIL import Image

    rng = np.random.default_rng(0)
    for i in range(3):
        a = rng.integers(0, 256, (24, 24, 3), dtype=np.uint8)
        Image.fromarray(a).save(tmp_path / f"ref{i}.png")
    path = tmp_path / "refs.json"
    path.write_text(json.dumps({p: [f"ref{i % 3}.png"] for i, p in enumerate(prompts)}))
    return str(path)


def test_real_d_epoch_keeps_the_frozen_score(tmp_path):
    """A D-epoch of the real D-step on the tiny towers: the live tail moved
    and is finite, every other CLIP tensor is unchanged, the frozen
    'pickscore' score of a fixed batch is bitwise unchanged while the
    'pickscore_cotrain' score moved, and d_loss / d_acc are finite."""
    prompts = TextPromptDataset("dataset/pickscore_small").prompts
    cfg = tiny_config(train_d=True, dataset="dataset/pickscore_small",
                      json_path=_refs(tmp_path, prompts), reference_image_path=str(tmp_path),
                      d_lr=1e-3)
    trainer = t_train.build_trainer(cfg, latent_hw=8, device="cpu")
    ctx, disc = trainer.reward_ctx, trainer.disc
    assert ctx.pickscore_params is disc.params
    clip = ctx.pickscore.clip
    start = {k: v.clone() for k, v in clip.state_dict().items()}
    images, batch = _images(3), ["a cat", "a dog", "a cow", "a hat"]
    frozen_fn = multi_score({"pickscore": 1.0}, ctx)
    live_fn = multi_score({"pickscore_cotrain": 1.0}, ctx)
    before = frozen_fn(images, batch)[0]["pickscore"], live_fn(images, batch)[0]["avg"]
    np.testing.assert_array_equal(*before)

    samples = trainer.sample_phase(0)
    assert samples["ref_rewards"] is not None and len(samples["epoch_images"]) == 2
    assert samples["epoch_images"][0].dtype == np.float16
    out = trainer.d_phase(samples)
    assert np.isfinite(out["d_loss"]) and 0.0 <= out["d_acc"] <= 1.0
    tail = {f"vision_model.layers.1.{k}" for k, _ in disc.params[0].named_parameters()}
    for name, v in clip.state_dict().items():
        if name in tail:
            assert not torch.equal(v, start[name]) and bool(torch.isfinite(v).all()), name
        else:
            assert torch.equal(v, start[name]), name
    np.testing.assert_array_equal(frozen_fn(images, batch)[0]["pickscore"], before[0])
    assert np.abs(live_fn(images, batch)[0]["avg"] - before[1]).max() > 1e-6


def test_cotrain_cli_runs_two_epochs_on_the_cpu(tmp_path):
    """``cli.train --config pickscore_cotrain_sd3_fast`` with the tiny
    towers and a reference store written here: every epoch logs the
    reference reward and its gate decision, a D-epoch its loss and
    accuracy, a G epoch its policy metrics."""
    prompts = TextPromptDataset("dataset/pickscore_small").prompts
    argv = ["--config", "pickscore_cotrain_sd3_fast", "--device", "cpu", "--latent_hw", "8",
            "--max_epochs", "2", "--set", "smoke_test=True",
            "--set", "dataset=dataset/pickscore_small", "--set", "sample.train_batch_size=2",
            "--set", "sample.num_batches_per_epoch=2", "--set", "wandb_init=False",
            "--set", "train.gradient_accumulation_steps=1",
            "--set", f"json_path={_refs(tmp_path, prompts)}",
            "--set", f"reference_image_path={tmp_path}", "--set", f"save_dir={tmp_path / 'run'}"]
    trainer = t_train.main(argv)
    assert trainer.disc is not None and trainer.reference_store is not None
    records = [json.loads(line) for line in (tmp_path / "run" / "metrics.jsonl").open()]
    assert len(records) == 2
    for r in records:
        assert np.isfinite(r["reward_avg"]) and np.isfinite(r["reference_reward_avg"])
        assert r["d_epoch"] == int(r["reference_reward_avg"] < r["reward_avg"])
        keys = ("d_loss", "d_acc") if r["d_epoch"] else ("loss", "approx_kl", "clipfrac")
        assert all(np.isfinite(r[k]) for k in keys), r


def test_reward_context_builds_pickscore_and_refuses_what_is_not_ported(monkeypatch, tmp_path):
    """smoke_test: the tiny towers at image 28, constant token ids 3 at the
    text tower's length; no PickScore reward: an empty context. A
    PICKSCORE_DIR with no checkpoint in it raises "missing weight" (never a
    silent random fallback); one that does not exist counts as unset (the
    same random weights). A local CLIP tokenizer is read with
    ``transformers`` blocked (its ids are held to ``transformers`` in
    tests/test_torch_tokenizers.py)."""
    from adv_grpo_torch.cli.common import build_reward_context
    from adv_grpo_torch.data.tokenizers import CLIPTokenizer
    from chip_smoke import clip_vocab, write_clip_tokenizer

    cfg = tiny_config()
    ctx = build_reward_context(cfg, {"pickscore_cotrain", "pickscore"}, device="cpu")
    assert ctx.pickscore.image_size == 28 and ctx.pickscore.clip.vision_model.cfg.hidden_size == 32
    np.testing.assert_array_equal(ctx.tokenize(["a", "b"]), np.full((2, 16), 3, np.int32))
    assert build_reward_context(cfg, {"jpeg_compressibility"}, device="cpu").pickscore is None
    (tmp_path / "empty").mkdir()
    monkeypatch.setenv("PICKSCORE_DIR", str(tmp_path / "empty"))
    with pytest.raises(KeyError, match="missing weight"):
        build_reward_context(cfg, {"pickscore"}, device="cpu")
    monkeypatch.setenv("PICKSCORE_DIR", str(tmp_path / "absent"))
    absent = build_reward_context(cfg, {"pickscore"}, device="cpu").pickscore.clip.state_dict()
    assert all(torch.equal(v, absent[k]) for k, v in ctx.pickscore.clip.state_dict().items())
    monkeypatch.delenv("PICKSCORE_DIR")
    vocab, merges = clip_vocab(["flower", "a"], 40)
    write_clip_tokenizer(str(tmp_path / "tokenizer"), vocab, merges, "<|endoftext|>")
    cfg.pretrained.model = str(tmp_path)
    monkeypatch.setitem(sys.modules, "transformers", None)
    ids = build_reward_context(cfg, {"pickscore"}, device="cpu").tokenize(["a flower", ""])
    np.testing.assert_array_equal(ids, CLIPTokenizer(str(tmp_path / "tokenizer"))(
        ["a flower", ""], 77))
    assert ids.shape == (2, 77) and ids[0, 1:3].tolist() == [vocab["a</w>"], vocab["flower</w>"]]
    assert ids[1, 0] == vocab["<|startoftext|>"] and ids[1, 1] == ids[1, 2] == vocab["<|endoftext|>"]


@pytest.mark.parametrize("extra", [["--resume", "latest"], ["--set", "weight_path=d.msgpack"],
                                   ["--set", "train.lora_path=lora"]],
                         ids=["resume", "weight_path", "lora_path"])
def test_train_cli_refuses_the_checkpoint_options(tmp_path, extra):
    """What the checkpoint options cannot take raises before anything is
    built, naming the way forward: ``--resume latest`` with no checkpoint
    under ``save_dir``; a flax ``.msgpack`` as the discriminator's
    ``weight_path`` that does not exist (an existing one is read: tests/
    test_torch_finetune_pickscore.py); a ``train.lora_path`` that is an orbax tree, as the JAX package's
    ``checkpoint-N/lora`` is (its ``export_peft_lora`` writes the peft
    directory the port reads)."""
    orbax = tmp_path / "lora"
    (orbax / "d").mkdir(parents=True)
    (orbax / "_METADATA").write_text("{}")
    extra = [a.replace("=lora", f"={orbax}") for a in extra]
    error, match = {"--resume": (FileNotFoundError, "no checkpoints under"),
                    "weight_path=d.msgpack": (FileNotFoundError, "d.msgpack"),
                    f"train.lora_path={orbax}": (ValueError, "export_peft_lora")}[
        extra[0] if extra[0] == "--resume" else extra[1]]
    with pytest.raises(error, match=match):
        t_train.main(["--config", "pickscore_cotrain_sd3_fast", "--device", "cpu",
                      "--set", f"save_dir={tmp_path / 'run'}"] + extra)


def _smoke_argv(save_dir, *extra):
    return ["--config", "smoke_sd3_fast", "--set", "sample.train_batch_size=2", "--device",
            "cpu", "--latent_hw", "8", "--set", f"save_dir={save_dir}", *extra]


@pytest.fixture(scope="module")
def saved_run(tmp_path_factory):
    """Two epochs of ``smoke_sd3_fast`` with ``save_freq=1`` and the EMA every
    optimizer step (so the saved adapter is not the starting one): the
    driver's own ``run`` writes ``checkpoint-2`` at the start of epoch 1.
    Returns the run directory, the trainer and its state at the save."""
    run = tmp_path_factory.mktemp("saved") / "run"
    from adv_grpo_torch.train import driver

    saved = {}
    save = driver.GRPOTrainer.save

    def recording_save(self):
        st = self.state
        saved.update({g: {k: v.detach().clone() for k, v in getattr(st, g).items()}
                      for g in ("lora", "mu", "nu", "ema")})
        saved.update(counters=(st.count, st.global_step, st.micro_step))
        return save(self)

    driver.GRPOTrainer.save = recording_save
    try:
        trainer = t_train.main(_smoke_argv(run, "--max_epochs", "2", "--set", "save_freq=1",
                                           "--set", "train.ema_interval=1"))
    finally:
        driver.GRPOTrainer.save = save
    return run, trainer, saved


def test_train_cli_resumes_the_latest_checkpoint(saved_run):
    """``--resume latest`` restores checkpoint-2 (the state at the save,
    bitwise) before its epoch and runs to the end; the epoch counter starts
    again at 0, as in the JAX package."""
    run, first, saved = saved_run
    assert sorted(os.listdir(run / "checkpoints")) == ["checkpoint-2"]
    assert sorted(os.listdir(run / "checkpoints" / "checkpoint-2")) == ["lora", "state.pt"]
    assert saved["counters"] == (2, 2, 4)
    from adv_grpo_torch.train import driver

    restored = {}
    run_fn = driver.GRPOTrainer.run

    def recording_run(self, **kw):
        restored.update({g: {k: v.detach().clone() for k, v in getattr(self.state, g).items()}
                         for g in ("lora", "mu", "nu", "ema")})
        restored.update(counters=(self.state.count, self.state.global_step,
                                  self.state.micro_step), epoch=self.epoch)
        return run_fn(self, **kw)

    driver.GRPOTrainer.run = recording_run
    try:
        trainer = t_train.main(_smoke_argv(run, "--max_epochs", "1", "--resume", "latest",
                                           "--set", "train.ema_interval=1"))
    finally:
        driver.GRPOTrainer.run = run_fn
    assert restored["counters"] == saved["counters"] and restored["epoch"] == 0
    for g in ("lora", "mu", "nu", "ema"):
        for k, v in saved[g].items():
            assert torch.equal(restored[g][k], v), (g, k)
    assert (trainer.state.global_step, trainer.state.micro_step) == (4, 8)
    records = [json.loads(line) for line in (run / "metrics.jsonl").open()]
    assert [r["epoch"] for r in records] == [0, 1, 0]


def test_train_cli_warm_starts_from_lora_path(saved_run, tmp_path):
    """``train.lora_path=<checkpoint>/lora`` (the saved EMA weights, a peft
    directory): the run starts from the adapter, EMA re-seeded from it, the
    optimizer fresh; it runs to the end."""
    run, _, saved = saved_run
    from adv_grpo_torch.train import driver

    seen = {}
    run_fn = driver.GRPOTrainer.run

    def recording_run(self, **kw):
        seen.update(lora={k: p.detach().clone() for k, p in self.state.lora.items()},
                    ema={k: e.clone() for k, e in self.state.ema.items()},
                    counters=(self.state.count, self.state.global_step))
        return run_fn(self, **kw)

    driver.GRPOTrainer.run = recording_run
    try:
        trainer = t_train.main(_smoke_argv(
            tmp_path, "--max_epochs", "1",
            "--set", f"train.lora_path={run / 'checkpoints' / 'checkpoint-2' / 'lora'}"))
    finally:
        driver.GRPOTrainer.run = run_fn
    assert seen["counters"] == (0, 0)
    for k, v in saved["ema"].items():
        assert torch.equal(seen["lora"][k], v) and torch.equal(seen["ema"][k], v), k
    assert trainer.state.global_step == 2


def test_infer_cli_merges_a_saved_adapter(saved_run, tmp_path):
    """``cli.infer --lora <checkpoint>/lora`` merges the saved EMA weights:
    its image equals, bitwise, the same pipeline's with those weights merged
    by ``merge_lora_params``, and differs from the image without the
    adapter (LoRA B at zero)."""
    from adv_grpo_torch.cli import infer as t_infer
    from adv_grpo_torch.cli import common
    from adv_grpo_torch.models.lora import merge_lora_params

    run, _, saved = saved_run
    built, images = [], []
    build, generate = common.build_pipeline, t_infer.generate

    def recording_build(*a, **kw):
        built.append(build(*a, **kw))
        return built[-1]

    def recording_generate(*a, **kw):
        images.append(generate(*a, **kw))
        return images[-1]

    argv = ["--prompts", "a flower", "--set", "smoke_test=True", "--latent_hw", "8",
            "--out_dir", str(tmp_path), "--device", "cpu",
            "--lora", str(run / "checkpoints" / "checkpoint-2" / "lora")]
    common.build_pipeline, t_infer.generate = recording_build, recording_generate
    try:
        paths = t_infer.main(argv)
    finally:
        common.build_pipeline, t_infer.generate = build, generate
    assert len(paths) == 1 and os.path.exists(paths[0])
    pipeline = built[0]
    config = apply_overrides(resolve_config("eval_sd3_fast"), ["smoke_test=True"])
    encode = common.build_text_encoder(config, pipeline)
    merge_lora_params(pipeline.transformer, saved["ema"])
    direct = generate(pipeline, encode, ["a flower"], config, latent_hw=8)
    assert torch.equal(images[0], direct)
    merge_lora_params(pipeline.transformer, {k: torch.zeros_like(v) if k.endswith("lora_b")
                                             else v for k, v in saved["ema"].items()})
    bare = generate(pipeline, encode, ["a flower"], config, latent_hw=8)
    assert not torch.equal(bare, direct)


def test_train_cli_warm_starts_the_discriminator_from_weight_path(tmp_path):
    """A checkpoint directory as ``weight_path``: a co-train run saves its
    CLIP tail and Adam state after a D-epoch; a new run built with
    ``weight_path`` set to that checkpoint starts from that tail (bitwise)
    and its Adam state, and runs to the end."""
    prompts = TextPromptDataset("dataset/pickscore_small").prompts
    cfg = tiny_config(train_d=True, dataset="dataset/pickscore_small",
                      json_path=_refs(tmp_path, prompts), reference_image_path=str(tmp_path),
                      d_lr=1e-3, save_dir=str(tmp_path / "first"))
    first = t_train.build_trainer(cfg, latent_hw=8, device="cpu")
    first.d_phase(first.sample_phase(0))
    path = first.save()
    tail = {k: v.clone() for k, v in first.disc.params.state_dict().items()}
    steps = [s["step"].clone() for s in first.disc.opt_state.state_dict()["state"].values()]

    argv = ["--config", "pickscore_cotrain_sd3_fast", "--device", "cpu", "--latent_hw", "8",
            "--max_epochs", "1", "--set", "smoke_test=True",
            "--set", "dataset=dataset/pickscore_small", "--set", "sample.train_batch_size=2",
            "--set", "sample.num_batches_per_epoch=2", "--set", "wandb_init=False",
            "--set", "train.gradient_accumulation_steps=1",
            "--set", f"json_path={cfg.json_path}", "--set", f"reference_image_path={tmp_path}",
            "--set", f"save_dir={tmp_path / 'second'}", "--set", f"weight_path={path}"]
    build = t_train.build_trainer
    seen = {}

    def recording_build(*a, **kw):
        trainer = build(*a, **kw)
        seen.update(tail={k: v.clone() for k, v in trainer.disc.params.state_dict().items()},
                    steps=[s["step"].clone() for s in
                           trainer.disc.opt_state.state_dict()["state"].values()])
        return trainer

    t_train.build_trainer = recording_build
    try:
        trainer = t_train.main(argv)
    finally:
        t_train.build_trainer = build
    assert set(seen["tail"]) == set(tail)
    for k, v in tail.items():
        assert torch.equal(seen["tail"][k], v), k
    assert all(torch.equal(a, b) for a, b in zip(seen["steps"], steps)) and steps
    assert trainer.reward_ctx.pickscore_params is trainer.disc.params
    assert len((tmp_path / "second" / "metrics.jsonl").read_text().splitlines()) == 1
