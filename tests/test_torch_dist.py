"""The port's multi-process training on the CPU: two gloo ranks on the tiny
SD3 (``smoke_sd3_fast``), against one process on all the rows.

The ranks are subprocesses of this file (``python tests/test_torch_dist.py
--rank R --world 2 ...``; torch and the port only, never jax), joined by a
file store. Each rank runs, in order: the numeric gathers of
``parallel.mesh`` as tests/multihost_worker.py:38-52 runs the JAX ones; one
epoch of the training CLI with an empty ``save_dir`` (the run directory
named by rank 0's timestamp); ``train_phase`` on its share of fixed rollout
rows; and the padded eval, once with an empty shard. Bounds: the LoRA and
EMA after ``train_phase`` within 1e-5 of the one-process run on all the rows
(fp32, sums in another order).
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


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    for flag in ("--rank", "--world"):
        ap.add_argument(flag, type=int, required=True)
    ap.add_argument("--store", required=True)
    ap.add_argument("--dir", required=True)
    _rank_main(ap.parse_args())
