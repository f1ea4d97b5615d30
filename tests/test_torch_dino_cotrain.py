"""The port's co-trained DINO discriminators against the JAX package, on the
CPU.

The D-steps on the tiny DINOv2 of tests/test_torch_dino.py (JAX params
carried across by ``models.convert``) against ``make_dino_d_step`` and
``make_dino_multi_d_step``, one and two steps at the preset's d_lr 1e-4:
the loss and accuracy within 1e-5, the gradient within 1e-4 of its largest
entry, the head's parameters within 1% of d_lr, the backbone bitwise
unchanged. The JAX patch indices (``split(key)``, then ``randint``) are
passed to the port. Adam's first step moves each entry by about d_lr times
the sign of its gradient, so a wrong sign or a missing bias correction
shows; where the gradient is near zero (under 1e-3 of its largest entry,
e.g. an fc1 entry that only a few top-k patches reach) that sign is fp32
noise, so such entries are held by their gradient, as in
tests/test_torch_cotrain.py.

Then the trainer on the port's tiny SD3: the periodic gate (ports of
tests/test_trainer_e2e.py:286-316 and tests/test_rewards_adversarial.py:
279-328), a real D-epoch (the co-trained score moves, ``image_similarity``
and every backbone tensor stay bitwise unchanged), the eval phase scoring
``image_similarity`` against the reference store, and the CLI on the patch
and multi-layer presets.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adv_grpo_torch.cli import train as t_train
from adv_grpo_torch.data.datasets import TextPromptDataset
from adv_grpo_torch.models.convert import (
    dino_head_state_dict_from_jax, dino_multi_state_dict_from_jax)
from adv_grpo_torch.rewards.registry import multi_score
from adv_grpo_torch.train import grpo_trainer as t_trainer
from adv_grpo_torch.train.driver import DiscriminatorBundle
from adv_grpo_tpu.adversarial import dino_hinge as j_hinge
from adv_grpo_tpu.train import grpo_trainer as j_trainer
from tests.test_torch_cotrain import _refs, make_trainer, tiny_config
from tests.test_torch_dino import LAYERS, _images, dino  # noqa: F401 (fixture)
from tests.test_torch_dino import port_head, port_multi

D_LR = 1e-4


def _backbone_state(td):
    return {k: v.clone() for k, v in td.vision.state_dict().items()}


def _assert_backbone_unchanged(td, start):
    for k, v in td.vision.state_dict().items():
        assert torch.equal(v, start[k]), k


@pytest.mark.parametrize("kind", ["dino", "dino_multi"])
def test_d_steps_match_jax(dino, kind):  # noqa: F811
    jd, td, bp = dino["jd"], dino["td"], dino["backbone"]
    start = _backbone_state(td)
    head_apply = lambda q, x: jd.head.apply({"params": q}, x)  # noqa: E731
    if kind == "dino":
        jp, to_sd = dino["head"], dino_head_state_dict_from_jax
        j_step, j_opt = j_trainer.make_dino_d_step(jd, D_LR)(jp)
        module = port_head(jp)
        t_step, t_opt = t_trainer.make_dino_d_step(td, module, D_LR)

        def j_loss_fn(p, real, fake, key):
            return j_hinge.dino_hinge_loss(head_apply, p, jd.features(bp, real),
                                           jd.features(bp, fake), key).loss
    else:
        jm = dino["jm"]
        jp, to_sd = dino["multi"], dino_multi_state_dict_from_jax
        j_step, j_opt = j_trainer.make_dino_multi_d_step(jm, D_LR)(jp)
        module = port_multi(jp)
        t_step, t_opt = t_trainer.make_dino_multi_d_step(dino["tm"], module, D_LR)

        def j_loss_fn(p, real, fake, key):
            def toks(images):
                out = jd.vision.apply({"params": bp}, jd.preprocess(images),
                                      capture_layers=LAYERS)
                return [out["layer_tokens"][i] for i in LAYERS]

            return j_hinge.dino_multi_hinge_loss(
                head_apply, lambda q, x: jm.fusion.apply({"params": q}, x), p, toks(real),
                toks(fake)).loss
    init = {k: v.clone() for k, v in module.state_dict().items()}
    big = {}
    for i in range(2):
        real, fake = (jnp.asarray(_images(s + i, n=4)) for s in (40, 50))
        key = jax.random.fold_in(jax.random.PRNGKey(7), i)
        k1, k2 = jax.random.split(key)
        idx = tuple(torch.tensor(np.asarray(jax.random.randint(k, (4, 64), 0, 81))).long()
                    for k in (k1, k2))
        j_grad = to_sd(jax.device_get(jax.grad(j_loss_fn)(jp, real, fake, key)))
        jp, j_opt, j_loss, j_acc = j_step(jp, j_opt, bp, real, fake, key)
        module, t_opt, loss, acc = t_step(module, t_opt, np.asarray(real), np.asarray(fake),
                                          indices=idx)
        np.testing.assert_allclose(loss.item(), float(j_loss), rtol=0, atol=1e-5)
        np.testing.assert_allclose(acc.item(), float(j_acc), rtol=0, atol=1e-5)
        want = to_sd(jax.device_get(jp))
        scale = max(np.abs(g.numpy()).max() for g in j_grad.values())
        for name, p in module.named_parameters():
            w = j_grad[name].numpy()
            np.testing.assert_allclose(p.grad.numpy(), w, rtol=0, atol=1e-4 * scale,
                                       err_msg=f"step {i}: {name} gradient")
            big[name] = big.get(name, True) & (np.abs(w) >= 1e-3 * scale)
            got = p.detach().numpy()
            np.testing.assert_allclose(got[big[name]], want[name].numpy()[big[name]], rtol=0,
                                       atol=1e-2 * D_LR, err_msg=f"step {i}: {name}")
    moved = [k for k, v in module.state_dict().items() if not torch.equal(v, init[k])]
    assert len(moved) == len(init)
    _assert_backbone_unchanged(td, start)


def test_step_draws_indices_from_its_generator(dino):  # noqa: F811
    """Without ``indices`` the step draws idx_r, then idx_f, from the
    generator: equal generators give equal steps."""
    td = dino["td"]
    losses = []
    for _ in range(2):
        head = port_head(dino["head"])
        step, opt = t_trainer.make_dino_d_step(td, head, D_LR)
        _, _, loss, _ = step(head, opt, _images(60, n=2), _images(61, n=2),
                             torch.Generator().manual_seed(3))
        losses.append(loss.item())
    g = torch.Generator().manual_seed(3)
    idx = tuple(td.draw_patch_indices(2, g) for _ in range(2))
    head = port_head(dino["head"])
    step, opt = t_trainer.make_dino_d_step(td, head, D_LR)
    _, _, loss, _ = step(head, opt, _images(60, n=2), _images(61, n=2), indices=idx)
    assert losses[0] == losses[1] == loss.item()


# ── the trainer on the tiny SD3 ───────────────────────────────────────────


class _ZeroRefs:
    def get_batch(self, prompts, rng=None):
        return np.zeros((len(prompts), 1, 3, 16, 16), np.float32)


@pytest.fixture(scope="module")
def tiny_pipeline():
    from adv_grpo_torch.cli.common import build_pipeline

    return build_pipeline(tiny_config(), latent_hw=8, device="cpu")


def _recording_disc(kind, calls):
    def step(params, opt, real, fake, generator):
        calls.append((real.shape, fake.shape, generator.initial_seed()))
        return params, opt, 0.5, 0.9

    return DiscriminatorBundle(kind, step, None, {"w": 0.0}, backbone={})


@pytest.mark.parametrize("kind", ["dino_patch", "dino"])
def test_dino_periodic_gate(tiny_pipeline, kind):
    """d_times 3 over 3 epochs: epochs 0 and 1 are D-epochs ((e + 1) % 3 !=
    0), one D-step per sampling batch of the whole epoch's pairs, each with
    its own generator; epoch 2 is the one G epoch (4 microsteps); D-epochs
    advance the step counter too."""
    cfg = tiny_config(train_d=True, discriminator=kind, d_times=3)
    calls = []
    trainer = make_trainer(tiny_pipeline, cfg, discriminator=_recording_disc(kind, calls),
                           reference_store=_ZeroRefs())
    trainer.run(max_epochs=3)
    assert len(calls) == 2 * cfg.sample.num_batches_per_epoch
    assert all(c[:2] == ((4, 3, 16, 16), (4, 3, 16, 16)) for c in calls)
    assert len({c[2] for c in calls}) == len(calls)
    assert trainer.state.micro_step == 4 and trainer.state.global_step >= 2


def test_dino_multi_rides_the_periodic_gate(tiny_pipeline):
    """tests/test_rewards_adversarial.py:279-328: d_times 2 over 2 epochs,
    one D-epoch, and the reward context then points at the live params."""
    import types

    cfg = tiny_config(train_d=True, discriminator="dino_multi", d_times=2)
    calls = []
    disc = _recording_disc("dino_multi", calls)
    ctx = types.SimpleNamespace(pickscore_params=None, dino_head_params=None,
                                dino_multi_params=None)
    trainer = make_trainer(tiny_pipeline, cfg, discriminator=disc,
                           reference_store=_ZeroRefs(), reward_ctx=ctx)
    trainer.run(max_epochs=2)
    assert len(calls) == cfg.sample.num_batches_per_epoch
    assert ctx.dino_multi_params is disc.params and ctx.dino_head_params is None


def _dino_trainer(tmp_path, preset, **overrides):
    prompts = TextPromptDataset("dataset/pickscore_small").prompts
    cfg = tiny_config(**overrides)
    from adv_grpo_torch.cli.common import apply_overrides, resolve_config

    base = apply_overrides(resolve_config(preset), ["smoke_test=True"])
    for k in ("discriminator", "reward_fn", "eval_reward_fn", "d_times", "d_lr",
              "dino_multi_layer_ids", "temperature"):
        cfg[k] = base[k]
    cfg.update(train_d=True, dataset="dataset/pickscore_small",
               json_path=_refs(tmp_path, prompts), reference_image_path=str(tmp_path),
               **overrides)
    return t_train.build_trainer(cfg, latent_hw=8, device="cpu")


def test_real_d_epoch_moves_the_head_only(tmp_path):
    """A D-epoch of the real D-step on the tiny DINOv2 (patch preset): the
    head moved and is finite, every backbone tensor and the
    ``image_similarity`` score of a fixed batch are bitwise unchanged, the
    ``dino_cotrain`` score moved."""
    trainer = _dino_trainer(tmp_path, "dino_cotrain_sd3_patch_fast", d_lr=1e-3)
    ctx, disc = trainer.reward_ctx, trainer.disc
    assert disc.kind == "dino_patch" and ctx.dino_head_params is disc.params
    assert disc.backbone is ctx.dino.vision
    start = _backbone_state(ctx.dino)
    head0 = {k: v.clone() for k, v in disc.params.state_dict().items()}
    images, refs = _images(3, n=4, hw=28), _images(4, n=4, hw=28)[:, None]
    sim_fn, live_fn = (multi_score({name: 1.0}, ctx)
                       for name in ("image_similarity", "dino_cotrain"))
    before = sim_fn(images, ["a"] * 4, ref_images=refs)[0]["avg"], live_fn(images, ["a"] * 4)[0]

    samples = trainer.sample_phase(0)
    assert len(samples["epoch_images"]) == 2 and samples["epoch_images"][0].dtype == np.float16
    out = trainer.d_phase(samples)
    assert np.isfinite(out["d_loss"]) and 0.0 <= out["d_acc"] <= 1.0
    for k, v in disc.params.state_dict().items():
        assert not torch.equal(v, head0[k]) and bool(torch.isfinite(v).all()), k
    _assert_backbone_unchanged(ctx.dino, start)
    np.testing.assert_array_equal(sim_fn(images, ["a"] * 4, ref_images=refs)[0]["avg"],
                                  before[0])
    assert np.abs(live_fn(images, ["a"] * 4)[0]["avg"] - before[1]["avg"]).max() > 1e-6


def test_eval_phase_scores_image_similarity_against_refs(tmp_path):
    """The presets' eval reward: ``image_similarity`` of the eval images
    against the reference store's images, beside ``pickscore``."""
    trainer = _dino_trainer(tmp_path, "dino_cotrain_sd3_patch_fast")
    prompts = TextPromptDataset("dataset/pickscore_small").prompts[:3]
    images, metrics = trainer.eval_phase(prompts)
    refs = trainer.reference_store.get_batch(prompts)
    want = trainer.reward_ctx.dino.similarity_to_refs(images, refs).numpy()
    assert abs(metrics["eval_reward_image_similarity"]) <= 1.0 + 1e-6  # cosines, fp32
    np.testing.assert_allclose(metrics["eval_reward_image_similarity"], want.mean(), rtol=1e-6)
    assert np.isfinite(metrics["eval_reward_pickscore"])
    assert metrics["eval_count_image_similarity"] == 3


def _cli_argv(tmp_path, preset, epochs, *extra):
    prompts = TextPromptDataset("dataset/pickscore_small").prompts
    return ["--config", preset, "--device", "cpu", "--latent_hw", "8", "--max_epochs",
            str(epochs), "--set", "smoke_test=True", "--set", "dataset=dataset/pickscore_small",
            "--set", "sample.train_batch_size=2", "--set", "sample.num_batches_per_epoch=2",
            "--set", "train.gradient_accumulation_steps=1", "--set", "wandb_init=False",
            "--set", f"json_path={_refs(tmp_path, prompts)}",
            "--set", f"reference_image_path={tmp_path}",
            "--set", f"save_dir={tmp_path / 'run'}", *extra]


def test_patch_cli_runs_a_d_and_a_g_epoch(tmp_path):
    """``cli.train --config dino_cotrain_sd3_patch_fast`` with ``d_times=2``:
    epoch 0 a D-epoch (finite d_loss, d_acc in [0, 1]), epoch 1 a G epoch."""
    trainer = t_train.main(_cli_argv(tmp_path, "dino_cotrain_sd3_patch_fast", 2,
                                     "--set", "d_times=2"))
    assert trainer.disc.kind == "dino_patch"
    records = [json.loads(line) for line in (tmp_path / "run" / "metrics.jsonl").open()]
    assert [r["d_epoch"] for r in records] == [1, 0]
    assert np.isfinite(records[0]["d_loss"]) and 0.0 <= records[0]["d_acc"] <= 1.0
    assert all(np.isfinite(records[1][k]) for k in ("loss", "approx_kl", "reward_avg"))


def test_multi_cli_runs_a_d_epoch(tmp_path):
    """``cli.train --config dino_cotrain_sd3_multi_fast``: one D-epoch on the
    tiny backbone's layer 1; the heads and the fusion moved, the reward is a
    sigmoid in (0, 1)."""
    build, hold = t_train.build_trainer, {}

    def recording_build(*a, **kw):
        trainer = build(*a, **kw)
        hold["start"] = {k: v.clone() for k, v in trainer.disc.params.state_dict().items()}
        return trainer

    t_train.build_trainer = recording_build
    try:
        trainer = t_train.main(_cli_argv(tmp_path, "dino_cotrain_sd3_multi_fast", 1))
    finally:
        t_train.build_trainer = build
    assert trainer.reward_ctx.dino_multi.layer_ids == (1,)
    records = [json.loads(line) for line in (tmp_path / "run" / "metrics.jsonl").open()]
    assert [r["d_epoch"] for r in records] == [1]
    assert 0.0 < records[0]["reward_dino_multi_cotrain"] < 1.0
    moved = [k for k, v in trainer.disc.params.state_dict().items()
             if not torch.equal(v, hold["start"][k])]
    assert {k.split(".")[0] for k in moved} == {"heads", "fusion"}


def test_reward_context_builds_dino_and_refuses_a_checkpoint(monkeypatch, tmp_path):
    """smoke_test: the tiny DINOv2 at 28^2, 2 layers of 32; the patch
    generator from seed + 2. A DINOV2_DIR with no checkpoint in it raises
    "missing weight"; one that does not exist counts as unset: the same
    random backbone and head (the loads themselves are held to the JAX
    package in tests/test_torch_scorer_loaders.py)."""
    from adv_grpo_torch.cli.common import build_reward_context

    cfg = tiny_config()
    ctx = build_reward_context(cfg, {"dino_patch_cotrain", "dino_multi_cotrain"}, device="cpu")
    assert ctx.dino.image_size == 28 and ctx.dino.vision_cfg.num_layers == 2
    assert ctx.dino.vision_cfg.hidden_size == 32 and ctx.dino.vision_cfg.layer_scale_init == 1e-5
    assert ctx.rng.initial_seed() == int(cfg.seed) + 2 and ctx.dino_multi.layer_ids == (1,)
    assert ctx.pickscore is None
    (tmp_path / "empty").mkdir()
    monkeypatch.setenv("DINOV2_DIR", str(tmp_path / "empty"))
    with pytest.raises(KeyError, match="missing weight"):
        build_reward_context(cfg, {"image_similarity"}, device="cpu")
    monkeypatch.setenv("DINOV2_DIR", str(tmp_path / "absent"))
    absent = build_reward_context(cfg, {"dino_patch_cotrain"}, device="cpu")
    for got, want in ((absent.dino.vision, ctx.dino.vision),
                      (absent.dino_head_params, ctx.dino_head_params)):
        want = want.state_dict()
        assert all(torch.equal(v, want[k]) for k, v in got.state_dict().items())
