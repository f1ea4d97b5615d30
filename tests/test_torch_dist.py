"""The port's multi-process training on the CPU: two gloo ranks on the tiny
SD3 (``smoke_sd3_fast``), against one process on all the rows.

The ranks are subprocesses of this file (``python tests/test_torch_dist.py
--rank R --world 2 ...``; torch and the port only, never jax), joined by a
file store. Each rank runs, in order: the numeric gathers of
``parallel.mesh`` as tests/multihost_worker.py:38-52 runs the JAX ones; one
epoch of the training CLI with an empty ``save_dir`` (the run directory
named by rank 0's timestamp); the window starts of a ``same_latent``
(group-shared prefix) trainer, one for the whole global batch;
``train_phase`` on its share of fixed rollout rows; and the padded eval,
once with an empty shard. Bounds: the LoRA and
EMA after ``train_phase`` within 1e-5 of the one-process run on all the rows
(fp32, sums in another order).

A second launch (``--cotrain``) runs the PickScore co-training: the CLIP
criterion over the differentiably gathered batch (against the JAX
``shard_map`` with ``all_gather``, rtol 1e-5), then two epochs of
``pickscore_cotrain_sd3_fast`` on the tiny towers and one more D-epoch, after
which both ranks must have taken the same branches and hold the same
discriminator; then a checkpoint that only rank 0 writes and both ranks
restore, bitwise.

A third launch (``--dino``) runs one DINO D-step on each rank's half of a
batch (the tiny DINOv2 of tests/test_torch_dino.py, weights and patch
indices from the JAX package): both ranks must then hold the same head, and
that head must equal the JAX ``make_dino_d_step`` on the whole batch with
the whole batch's indices (the hinge is a batch mean, so the mean of the
ranks' gradients is the whole batch's gradient).
"""

import argparse
import json
import os
import sys

import numpy as np
import pytest
import torch

from test_torch_ring import RANK_TIMEOUT_S, run_ranks

WORLD = 2
ROLLOUT_KEYS = ("latents", "log_probs", "timesteps", "sigmas", "sigmas_prev")
# train_phase's minibatch i holds global rows [4i, 4i + 4) (2 minibatches of
# 8 rows); a rank holds its half of each, so the ranks' union is each global
# minibatch, as the JAX package's data axis splits it
RANK_ROWS = {0: [0, 1, 4, 5], 1: [2, 3, 6, 7]}


def _config(train_batch_size):
    from adv_grpo_torch.cli.common import apply_overrides, resolve_config

    return apply_overrides(resolve_config("smoke_sd3_fast"), [
        f"sample.train_batch_size={train_batch_size}", "train.ema_interval=1"])


def _trainer(train_batch_size):
    from adv_grpo_torch.cli import train

    return train.build_trainer(_config(train_batch_size), latent_hw=8, device="cpu")


def _state(trainer):
    return ({k: p.detach().numpy().copy() for k, p in trainer.state.lora.items()},
            {k: e.numpy().copy() for k, e in trainer.state.ema.items()})


@pytest.fixture(scope="module")
def one_process(tmp_path_factory):
    """Rows from one process's sampling phase (8 rows; log-probs of the
    policy itself), its train_phase on all of them, and the rows' file."""
    tmp = tmp_path_factory.mktemp("dist")
    trainer = _trainer(2)
    samples = trainer.sample_phase(0)
    n = samples["rollout"]["latents"].shape[0]
    assert n == 8 and sorted(sum(RANK_ROWS.values(), [])) == list(range(n))
    adv = np.random.default_rng(0).standard_normal(n).astype(np.float32)
    rows = {k: samples["rollout"][k].numpy() for k in ROLLOUT_KEYS}
    rows.update(embeds=samples["embeds"].numpy(), pooled=samples["pooled"].numpy(),
                advantages=adv)
    np.savez(tmp / "rows.npz", **rows)
    start = _state(trainer)[0]
    trainer.train_phase(samples, adv)
    return tmp, start, _state(trainer)


@pytest.fixture(scope="module")
def ranks(one_process):
    tmp = one_process[0]
    run_ranks(WORLD, tmp, os.path.abspath(__file__))
    out = []
    for r in range(WORLD):
        with open(tmp / f"rank{r}.json") as f:
            res = json.load(f)
        arrays = np.load(tmp / f"rank{r}.npz")
        res["arrays"] = {k: arrays[k] for k in arrays.files}
        out.append(res)
    return tmp, out


def test_gathers_match_the_jax_semantics(ranks):
    _, res = ranks
    want = np.concatenate([np.arange(4) + p * 100 for p in range(WORLD)]).tolist()
    for r, x in enumerate(res):
        assert x["gather"] == want and x["slice"] == [4 * r, 4 * r + 4]
        assert x["gather_str"] == x["allgather_str"] == "TypeError"
        assert x["allgather"] == [0.0, 0.0, 1.0, 1.0]
        assert x["broadcast"] == [0, 0, 0]


def test_prompt_slots_split_the_global_batch(ranks):
    """The ranks' k-repeat slots, in rank order, are the one-process batch of
    the global size: disjoint shares of one batch."""
    from adv_grpo_torch.data.krepeat import DistributedKRepeatSampler

    _, res = ranks
    one = DistributedKRepeatSampler(res[0]["dataset_size"], batch_size=WORLD, k=2,
                                    num_replicas=1, rank=0, seed=res[0]["sampler_seed"])
    for e in range(3):
        assert sum((x["slots"][e] for x in res), []) == one.batch_for_epoch(e).tolist()


def test_cli_epoch_agrees_on_one_run_dir_and_one_lora(ranks):
    """save_dir='' : both ranks take rank 0's timestamp; only rank 0 logs;
    the averaged gradients keep the two ranks' LoRA identical."""
    tmp, res = ranks
    assert res[0]["save_dir"] == res[1]["save_dir"]
    assert os.path.basename(res[0]["save_dir"]).startswith("mh_")
    runs = os.listdir(tmp / "logs")
    assert runs == [os.path.basename(res[0]["save_dir"])]
    assert os.listdir(tmp / "logs" / runs[0]).count("metrics.jsonl") == 1
    assert res[0]["rollout_noise_differs"]
    a0, a1 = res[0]["arrays"], res[1]["arrays"]
    cli = [k for k in a0 if k.startswith("cli/")]
    assert cli and all(np.array_equal(a0[k], a1[k]) for k in cli)


def test_each_rank_draws_its_own_window_start(ranks):
    """sample.random_timestep unset: rank r's window start at sampling batch
    s is the JAX driver's rts[r] with rts = default_rng(s).integers(0,
    num_steps // 2 + 1, size=world) (adv_grpo_tpu/train/driver.py:282-296),
    and its rollouts are given it; the two ranks differ at some batch."""
    _, res = ranks
    n, nb = res[0]["num_steps"], res[0]["num_batches"]
    rts = [np.random.default_rng(s).integers(0, n // 2 + 1, size=WORLD) for s in range(5)]
    assert 2 * nb <= len(rts)
    for r, x in enumerate(res):
        assert x["window_starts"] == [int(w[r]) for w in rts]
        assert x["rollout_starts"] == x["window_starts"][nb:2 * nb]  # epoch 1's batches
    assert res[0]["window_starts"] != res[1]["window_starts"]


def test_shared_prefix_ranks_take_one_window_start(ranks):
    """``sample.same_latent`` (the group-shared prefix): one window start for
    the whole global batch, every rank taking draw 0 (the JAX driver's
    ``rt_static = int(rts[0])``, adv_grpo_tpu/train/driver.py:287-291), and
    its rollouts are given that int."""
    _, res = ranks
    n, nb = res[0]["num_steps"], res[0]["num_batches"]
    rts = [np.random.default_rng(s).integers(0, n // 2 + 1, size=WORLD) for s in range(5)]
    for x in res:
        assert x["shared_prefix"]
        assert x["shared_starts"] == [int(w[0]) for w in rts]
        assert x["shared_rollout_starts"] == x["shared_starts"][nb:2 * nb]


def test_train_phase_on_two_ranks_matches_one_process(one_process, ranks):
    _, start, (lora1, ema1) = one_process
    _, res = ranks
    moved = 0
    for r in range(WORLD):
        arr = res[r]["arrays"]
        for k, want in lora1.items():
            np.testing.assert_allclose(arr[f"start/{k}"], start[k], rtol=0, atol=0)
            np.testing.assert_allclose(arr[f"lora/{k}"], want, rtol=0, atol=1e-5, err_msg=k)
            np.testing.assert_allclose(arr[f"ema/{k}"], ema1[k], rtol=0, atol=1e-5, err_msg=k)
            moved += not np.array_equal(want, start[k])
    assert moved > len(lora1)  # the LoRA moved on both ranks' comparison


def _criterion_inputs():
    rng = np.random.default_rng(1)

    def norm(x):
        return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)

    t, i0, i1 = (norm(rng.standard_normal((8, 4))) for _ in range(3))
    return dict(t=t, i0=i0, i1=i1, l0=np.ones(8, np.float32),
                l1=np.array([0, 0, 1, 0, 0.5, 0, 0, 0], np.float32))


@pytest.fixture(scope="module")
def cotrain_ranks(tmp_path_factory):
    from PIL import Image

    from adv_grpo_torch.data.datasets import TextPromptDataset

    tmp = tmp_path_factory.mktemp("cotrain")
    np.savez(tmp / "criterion.npz", **_criterion_inputs())
    rng = np.random.default_rng(0)
    for i in range(3):
        Image.fromarray(rng.integers(0, 256, (24, 24, 3), dtype=np.uint8)).save(tmp / f"r{i}.png")
    prompts = TextPromptDataset("dataset/pickscore_small").prompts
    (tmp / "refs.json").write_text(json.dumps({p: [f"r{i % 3}.png"] for i, p in
                                               enumerate(prompts)}))
    run_ranks(WORLD, tmp, os.path.abspath(__file__), extra=("--cotrain",))
    return [(json.loads((tmp / f"cotrain{r}.json").read_text()), np.load(tmp / f"cotrain{r}.npz"))
            for r in range(WORLD)]


DINO_TINY = dict(image_size=126, num_layers=3, hidden_size=32, intermediate_size=64,
                 num_heads=2)
DINO_LR = 1e-4


@pytest.fixture(scope="module")
def dino_ranks(tmp_path_factory):
    """The JAX step on the whole batch of 8, and each rank's head after its
    step on its 4 rows."""
    import jax
    import jax.numpy as jnp

    from adv_grpo_torch.models.convert import dino_head_state_dict_from_jax
    from adv_grpo_torch.models.convert import vit_state_dict_from_jax
    from adv_grpo_torch.models.vit import ViTConfig
    from adv_grpo_tpu.models.vit import ViTConfig as JViTConfig
    from adv_grpo_tpu.rewards.scorers import DINOScorer
    from adv_grpo_tpu.train.grpo_trainer import make_dino_d_step
    from test_torch_dino import _draw_layer_scale

    tmp = tmp_path_factory.mktemp("dino")
    jd = DINOScorer(JViTConfig.dinov2_base(**DINO_TINY), image_size=126)
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    backbone = _draw_layer_scale(jd.init_backbone(k1), 1)
    head = jd.init_head(k2)
    rng = np.random.default_rng(0)
    real, fake = (rng.uniform(-1, 1, (8, 3, 126, 126)).astype(np.float32) for _ in range(2))
    key = jax.random.PRNGKey(9)
    idx = [np.asarray(jax.random.randint(k, (8, 64), 0, 81)) for k in jax.random.split(key)]
    sd = {f"vision/{k}": v.numpy() for k, v in
          vit_state_dict_from_jax(backbone, ViTConfig.dinov2_base(**DINO_TINY)).items()}
    sd.update({f"head/{k}": v.numpy() for k, v in
               dino_head_state_dict_from_jax(jax.device_get(head)).items()})
    np.savez(tmp / "dino.npz", real=real, fake=fake, idx_r=idx[0], idx_f=idx[1], **sd)
    step, opt = make_dino_d_step(jd, DINO_LR)(head)
    head, _, loss, acc = step(head, opt, backbone, jnp.asarray(real), jnp.asarray(fake), key)
    want = {k: v.numpy() for k, v in dino_head_state_dict_from_jax(jax.device_get(head)).items()}
    run_ranks(WORLD, tmp, os.path.abspath(__file__), extra=("--dino",))
    got = [np.load(tmp / f"dino{r}.npz") for r in range(WORLD)]
    return want, float(loss), sd, got


def test_dino_d_step_on_two_ranks_matches_the_whole_batch(dino_ranks):
    """Both ranks hold the same moved head, equal to the JAX step on the
    whole batch within 1% of d_lr; each rank's loss is its half's."""
    want, loss, start, (a0, a1) = dino_ranks
    for name, w in want.items():
        np.testing.assert_array_equal(a0[name], a1[name], err_msg=name)
        np.testing.assert_allclose(a0[name], w, rtol=0, atol=1e-2 * DINO_LR, err_msg=name)
        assert not np.array_equal(a0[name], start[f"head/{name}"]), name
    np.testing.assert_allclose((float(a0["loss"]) + float(a1["loss"])) / 2, loss, atol=1e-5)


@pytest.mark.parametrize("in_batch", [False, True], ids=["pairwise", "in_batch"])
def test_gathered_criterion_matches_jax_shard_map(cotrain_ranks, in_batch):
    """Each rank's loss over the gathered batch equals the one-process loss
    and the JAX ``shard_map`` loss. The backward's reduce-scatter sums every
    rank's cotangent of a rank's rows, so its features' gradients are the
    world size times the one-process gradients; divided by the world size,
    as the data-parallel mean divides the parameters' gradients (the
    reference's DDP), they equal the one-process gradients and the JAX
    ``shard_map`` gradients of its rows, where the replicated loss's
    cotangent is shared out over the devices."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P

    from adv_grpo_tpu.adversarial.clip_criterion import CLIPCriterionBatch, clip_criterion_loss

    x = {k: jnp.asarray(v) for k, v in _criterion_inputs().items()}

    def loss(t, i0, i1, axis_name=None):
        batch = CLIPCriterionBatch(t, i0, i1, x["l0"], x["l1"])
        return clip_criterion_loss(batch, 10.0, in_batch_negatives=in_batch,
                                   axis_name=axis_name)

    one, one_g = jax.value_and_grad(loss, argnums=(0, 1, 2))(x["t"], x["i0"], x["i1"])
    mesh = Mesh(np.array(jax.devices()[:WORLD]), ("d",))

    def sharded(t, i0, i1, l0, l1):
        batch = CLIPCriterionBatch(t, i0, i1, l0, l1)
        return clip_criterion_loss(batch, 10.0, in_batch_negatives=in_batch, axis_name="d")

    f = jax.shard_map(sharded, mesh=mesh, in_specs=(P("d"),) * 5, out_specs=P(), check_vma=False)
    dist_loss, dist_g = jax.value_and_grad(
        lambda t, i0, i1: f(t, i0, i1, x["l0"], x["l1"]), argnums=(0, 1, 2))(
        x["t"], x["i0"], x["i1"])
    np.testing.assert_allclose(float(dist_loss), float(one), rtol=1e-5)
    mode = "in_batch" if in_batch else "pairwise"
    for r, (res, arrays) in enumerate(cotrain_ranks):
        rows = slice(r * 8 // WORLD, (r + 1) * 8 // WORLD)
        np.testing.assert_allclose(res[f"{mode}_loss"], float(one), rtol=1e-5)
        for name, g_dist, g_one in zip(("t", "i0", "i1"), dist_g, one_g):
            got = arrays[f"{mode}_grad_{name}"] / WORLD
            np.testing.assert_allclose(got, np.asarray(g_dist)[rows], rtol=1e-5, atol=1e-7)
            np.testing.assert_allclose(got, np.asarray(g_one)[rows], rtol=1e-5, atol=1e-7)


def test_cotrain_ranks_take_one_branch_and_keep_one_discriminator(cotrain_ranks):
    """The gate compares the means over both ranks' rows, so the ranks take
    the same branch in every epoch although each scores its own prompts;
    the D-step averages the tail's gradients, so after a D-epoch both ranks
    hold the same, moved discriminator."""
    (r0, a0), (r1, a1) = cotrain_ranks
    assert len(r0["d_epochs"]) == 3 and r0["d_epochs"] == r1["d_epochs"]
    assert r0["d_epochs"][-1] is True  # the forced D-epoch after the run
    assert r0["gen_means"] != r1["gen_means"]  # each rank scored its own rows
    tail = [k for k in a0.files if k.startswith("tail/")]
    assert tail
    for k in tail:
        np.testing.assert_array_equal(a0[k], a1[k], err_msg=k)
        assert not np.array_equal(a0[k], a0["start/" + k[len("tail/"):]]), k


def test_rank_0_writes_the_checkpoint_and_both_ranks_restore_it(cotrain_ranks):
    """After the co-train run every rank calls ``save``: only rank 0 writes
    (rank 1's returns None without writing); after the barrier both ranks
    restore the checkpoint into a fresh trainer and hold bitwise the same
    generator and discriminator state, rank 0's at the save."""
    (r0, a0), (r1, a1) = cotrain_ranks
    assert r0["writes"] == 1 and r0["save_returned"].endswith(
        f"checkpoint-{r0['saved_counters'][1]}")
    assert r1["writes"] == 0 and r1["save_returned"] is None
    assert r0["saved_counters"] == r1["saved_counters"]
    assert r0["restored_counters"] == r1["restored_counters"] == r0["saved_counters"]
    saved = [k for k in a0.files if k.startswith("saved/")]
    assert {k.split("/")[1] for k in saved} == {"lora", "acc", "mu", "nu", "ema", "d", "dopt"}
    for k in saved:
        want = a0[k]
        for arrays in (a0, a1):
            np.testing.assert_array_equal(arrays["restored/" + k[len("saved/"):]], want,
                                          err_msg=k)


def test_padded_eval_with_an_empty_shard_returns_on_both_ranks(ranks):
    """One prompt over two ranks: rank 1's share is padding only; both ranks
    return, with the same means over a global count of 1. Three prompts:
    shares of 2 and 1, count 3."""
    _, res = ranks
    assert [x["eval1_images"] for x in res] == [1, 0]
    assert [x["eval3_images"] for x in res] == [2, 1]
    for n in (1, 3):
        m0, m1 = res[0][f"eval{n}"], res[1][f"eval{n}"]
        assert m0 == m1 and m0["eval_count_avg"] == n and np.isfinite(m0["eval_reward_avg"])


# ── a rank (run as a script; imports torch and the port, never jax) ──────


def _rank_main(args):
    from adv_grpo_torch.cli import train
    from adv_grpo_torch.parallel import mesh

    mesh.init_distributed("gloo", init_method=f"file://{args.store}", world_size=args.world,
                          rank=args.rank, timeout_s=RANK_TIMEOUT_S)
    res, arrays = {}, {}

    # the gathers, as tests/multihost_worker.py:38-52 checks the JAX ones
    g, sl = mesh.gather_global((np.arange(4) + args.rank * 100).astype(np.float32))
    res.update(gather=g.tolist(), slice=[sl.start, sl.stop])
    for key, fn in (("gather_str", lambda: mesh.gather_global(np.asarray(["a", "b"]))),
                    ("allgather_str", lambda: mesh.process_allgather({"s": np.asarray(["x"])}))):
        try:
            fn()
            res[key] = "accepted"
        except TypeError:
            res[key] = "TypeError"
    tree = mesh.process_allgather({"r": np.full((2,), args.rank, np.float32)})
    res["allgather"] = np.asarray(tree["r"]).reshape(-1).tolist()
    res["broadcast"] = mesh.broadcast_one_to_all(np.full(3, args.rank)).tolist()

    # one epoch of the CLI, the run directory named by rank 0's timestamp
    trainer = train.main(["--config", "smoke_sd3_fast", "--max_epochs", "1", "--device", "cpu",
                          "--latent_hw", "8", "--set", "save_dir=", "--set",
                          f"logdir={os.path.join(args.dir, 'logs')}", "--set", "run_name=mh",
                          "--set", "sample.train_batch_size=1"])
    res.update(save_dir=str(trainer.config.save_dir), dataset_size=len(trainer.dataset),
               sampler_seed=trainer.prompt_sampler.seed,
               slots=[trainer.prompt_sampler.batch_for_epoch(e).tolist() for e in range(3)])
    arrays.update({f"cli/{k}": v for k, v in _state(trainer)[0].items()})
    # the window starts this rank draws (random_timestep unset), and those its
    # rollouts of epoch 1 are given
    res.update(num_steps=trainer.sampler_cfg.num_steps, num_batches=trainer.num_batches,
               window_starts=[trainer.window_start(s) for s in range(5)], rollout_starts=[])
    sample_fn = trainer.sample_fn

    def recording(*args):
        res["rollout_starts"].append(int(args[-1][0]))
        return sample_fn(*args)

    trainer.sample_fn = recording
    lat0 = trainer.sample_phase(1)["rollout"]["latents"][:, 0].contiguous()
    trainer.sample_fn = sample_fn
    others, _ = mesh.gather_global(lat0.numpy())
    res["rollout_noise_differs"] = not np.array_equal(others[:len(lat0)], others[len(lat0):])

    # the group-shared prefix: one window start for the whole global batch
    from adv_grpo_torch.cli.common import apply_overrides

    shared = train.build_trainer(apply_overrides(_config(1), ["sample.same_latent=True"]),
                                 latent_hw=8, device="cpu")
    res.update(shared_prefix=shared.shared_prefix, shared_rollout_starts=[],
               shared_starts=[shared.window_start(s) for s in range(5)])
    shared_fn = shared.sample_fn

    def recording_shared(*args):
        res["shared_rollout_starts"].append(args[-1])
        return shared_fn(*args)

    shared.sample_fn = recording_shared
    shared.sample_phase(1)

    # the padded eval: one prompt (rank 1's share is padding only), then three
    for n in (1, 3):
        images, metrics = trainer.eval_phase(["a cat", "a dog", "a cow"][:n])
        res[f"eval{n}_images"], res[f"eval{n}"] = len(images), metrics

    # train_phase on this rank's share of the fixed rows
    rows = np.load(os.path.join(args.dir, "rows.npz"))
    idx = RANK_ROWS[args.rank]
    fresh = _trainer(1)
    arrays.update({f"start/{k}": v for k, v in _state(fresh)[0].items()})
    samples = dict(rollout={k: torch.from_numpy(rows[k][idx]) for k in ROLLOUT_KEYS},
                   embeds=torch.from_numpy(rows["embeds"][idx]),
                   pooled=torch.from_numpy(rows["pooled"][idx]))
    fresh.train_phase(samples, rows["advantages"][idx])
    lora, ema = _state(fresh)
    arrays.update({f"lora/{k}": v for k, v in lora.items()})
    arrays.update({f"ema/{k}": v for k, v in ema.items()})

    with open(os.path.join(args.dir, f"rank{args.rank}.json"), "w") as f:
        json.dump(res, f)
    np.savez(os.path.join(args.dir, f"rank{args.rank}.npz"), **arrays)
    torch.distributed.destroy_process_group()


def _cotrain_main(args):
    import torch.distributed as dist

    from adv_grpo_torch.adversarial.clip_criterion import CLIPCriterionBatch, clip_criterion_loss
    from adv_grpo_torch.cli import train
    from adv_grpo_torch.parallel import mesh

    mesh.init_distributed("gloo", init_method=f"file://{args.store}", world_size=args.world,
                          rank=args.rank, timeout_s=RANK_TIMEOUT_S)
    res, arrays = {}, {}
    x = np.load(os.path.join(args.dir, "criterion.npz"))
    rows = slice(args.rank * 8 // args.world, (args.rank + 1) * 8 // args.world)
    for mode, in_batch in (("pairwise", False), ("in_batch", True)):
        feats = [torch.from_numpy(x[k][rows]).requires_grad_() for k in ("t", "i0", "i1")]
        batch = CLIPCriterionBatch(*feats, torch.from_numpy(x["l0"][rows]),
                                   torch.from_numpy(x["l1"][rows]))
        loss = clip_criterion_loss(batch, 10.0, in_batch_negatives=in_batch,
                                   group=dist.group.WORLD)
        loss.backward()
        res[f"{mode}_loss"] = loss.item()
        arrays.update({f"{mode}_grad_{k}": f.grad.numpy() for k, f in zip(("t", "i0", "i1"),
                                                                           feats)})

    # two epochs of the co-train preset on the tiny towers, then one D-epoch
    argv = ["--config", "pickscore_cotrain_sd3_fast", "--device", "cpu", "--latent_hw", "8",
            "--max_epochs", "2", "--set", "smoke_test=True", "--set", "save_dir=",
            "--set", f"logdir={os.path.join(args.dir, 'logs')}",
            "--set", "dataset=dataset/pickscore_small", "--set", "sample.train_batch_size=1",
            "--set", "sample.num_batches_per_epoch=2", "--set", "wandb_init=False",
            "--set", "train.gradient_accumulation_steps=1", "--set", "d_lr=1e-3",
            "--set", f"json_path={os.path.join(args.dir, 'refs.json')}",
            "--set", f"reference_image_path={args.dir}"]
    res.update(d_epochs=[], gen_means=[])
    build = train.build_trainer

    def recording_build(*a, **kw):
        trainer = build(*a, **kw)
        gate = trainer.should_run_d_epoch
        arrays.update({f"start/{k}": v.detach().numpy().copy()
                       for k, v in trainer.disc.params.state_dict().items()})

        def recording_gate(samples):
            res["gen_means"].append(float(np.mean(samples["rewards"]["avg"])))
            res["d_epochs"].append(gate(samples))
            return res["d_epochs"][-1]

        trainer.should_run_d_epoch = recording_gate
        return trainer

    train.build_trainer = recording_build
    try:
        trainer = train.main(argv)
    finally:
        train.build_trainer = build
    trainer.d_phase(trainer.sample_phase(2))
    res["d_epochs"].append(True)
    arrays.update({f"tail/{k}": v.detach().numpy()
                   for k, v in trainer.disc.params.state_dict().items()})

    # a checkpoint: every rank calls save, rank 0 writes; after the barrier
    # every rank restores it into a fresh trainer
    from adv_grpo_torch.train import checkpoint as ckpt_lib

    writes, save_state = [], ckpt_lib.save_state
    ckpt_lib.save_state = lambda *a, **kw: writes.append(a[1]) or save_state(*a, **kw)
    try:
        res["save_returned"] = trainer.save()
    finally:
        ckpt_lib.save_state = save_state
    res["writes"] = len(writes)
    res["saved_counters"], saved = _checkpoint_arrays(trainer)
    arrays.update({f"saved/{k}": v for k, v in saved.items()})
    dist.barrier()
    fresh = build(trainer.config, latent_hw=8, device="cpu")
    fresh.restore(ckpt_lib.latest_checkpoint(str(trainer.config.save_dir)))
    res["restored_counters"], restored = _checkpoint_arrays(fresh)
    arrays.update({f"restored/{k}": v for k, v in restored.items()})
    with open(os.path.join(args.dir, f"cotrain{args.rank}.json"), "w") as f:
        json.dump(res, f)
    np.savez(os.path.join(args.dir, f"cotrain{args.rank}.npz"), **arrays)
    torch.distributed.destroy_process_group()


def _checkpoint_arrays(trainer):
    """(count, global_step, micro_step) and every tensor a checkpoint holds:
    the generator state and the discriminator's module and Adam state."""
    st = trainer.state
    out = {f"{g}/{k}": v.detach().numpy().copy() for g in ("lora", "acc", "mu", "nu", "ema")
           for k, v in getattr(st, g).items()}
    out.update({f"d/{k}": v.detach().numpy().copy()
                for k, v in trainer.disc.params.state_dict().items()})
    out.update({f"dopt/{i}/{k}": v.numpy().copy() for i, s in
                trainer.disc.opt_state.state_dict()["state"].items() for k, v in s.items()})
    return [st.count, st.global_step, st.micro_step], out


def _dino_main(args):
    from adv_grpo_torch.models.vit import ViTConfig, VisionTransformer
    from adv_grpo_torch.parallel import mesh
    from adv_grpo_torch.rewards.scorers import DINOHead, DINOScorer
    from adv_grpo_torch.train.grpo_trainer import make_dino_d_step

    mesh.init_distributed("gloo", init_method=f"file://{args.store}", world_size=args.world,
                          rank=args.rank, timeout_s=RANK_TIMEOUT_S)
    x = np.load(os.path.join(args.dir, "dino.npz"))

    def part(prefix):
        return {k[len(prefix):]: torch.from_numpy(x[k]) for k in x.files if k.startswith(prefix)}

    vision = VisionTransformer(ViTConfig.dinov2_base(**DINO_TINY))
    vision.load_state_dict(part("vision/"))
    head = DINOHead(32)
    head.load_state_dict(part("head/"))
    step, opt = make_dino_d_step(DINOScorer(vision, image_size=126), head, DINO_LR)
    rows = slice(args.rank * 8 // args.world, (args.rank + 1) * 8 // args.world)
    idx = tuple(torch.from_numpy(x[k][rows]).long() for k in ("idx_r", "idx_f"))
    head, _, loss, _ = step(head, opt, x["real"][rows], x["fake"][rows], indices=idx)
    np.savez(os.path.join(args.dir, f"dino{args.rank}.npz"), loss=loss.numpy(),
             **{k: v.detach().numpy() for k, v in head.state_dict().items()})
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    for flag in ("--rank", "--world"):
        ap.add_argument(flag, type=int, required=True)
    ap.add_argument("--store", required=True)
    ap.add_argument("--dir", required=True)
    ap.add_argument("--cotrain", action="store_true")
    ap.add_argument("--dino", action="store_true")
    parsed = ap.parse_args()
    (_cotrain_main if parsed.cotrain else _dino_main if parsed.dino else _rank_main)(parsed)
