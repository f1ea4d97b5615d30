"""The port's own copies of the JAX package's framework-free modules give the
JAX package's results on the same inputs.

The port imports nothing of ``adv_grpo_tpu`` (tests/test_torch_imports.py),
so it carries copies of the schedule, the stat tracker, the k-repeat sampler,
the datasets, the embedding store (reader and writer), the metric logger, the FLOP model, the
host JPEG rewards, the uint8 image packer, the override parser, the hash
text encoder, the peft key mapping, the checkpoint directory helpers, the
prompt functions, the remote judges' encoders and rubrics, the VLM judges'
rubric and score extraction, the SigLIP and ImageReward constants, the preference pairs and the dataset tooling (the last two
also in tests/test_torch_finetune_pickscore.py and
tests/test_torch_refs_tools.py; the SFT / RWR / DPO presets in
tests/test_torch_config.py). Each is held here against its original: exact equality
throughout, since both sides run the same numpy arithmetic.
"""

import json
import os

import numpy as np
import pytest
import torch

from adv_grpo_torch.cli import common as t_common
from adv_grpo_torch.config.base import ConfigDict
from adv_grpo_torch.core import scheduler as t_sched
from adv_grpo_torch.core import stat_tracking as t_stats
from adv_grpo_torch.data import datasets as t_data
from adv_grpo_torch.data.embed_store import EmbeddingStore as TEmbeddingStore
from adv_grpo_torch.data.embed_store import write_store as t_write_store
from adv_grpo_torch.data.krepeat import DistributedKRepeatSampler as TSampler
from adv_grpo_torch.models.flux import FluxConfig as TFluxConfig
from adv_grpo_torch.models import peft_lora as t_peft
from adv_grpo_torch.models.mmdit import MMDiTConfig as TMMDiTConfig
from adv_grpo_torch.models.wan import WanConfig as TWanConfig
from adv_grpo_torch.rewards.registry import multi_score as t_multi_score
from adv_grpo_torch.utils import flops as t_flops
from adv_grpo_torch.utils.images import images_to_uint8 as t_u8
from adv_grpo_torch.utils.metrics import MetricLogger as TLogger
from adv_grpo_torch.utils.metrics import StepTimer as TTimer
from adv_grpo_tpu.cli import common as j_common
from adv_grpo_tpu.core import scheduler as j_sched
from adv_grpo_tpu.core import stat_tracking as j_stats
from adv_grpo_tpu.data import datasets as j_data
from adv_grpo_tpu.data.embed_store import EmbeddingStore as JEmbeddingStore
from adv_grpo_tpu.data.embed_store import write_store
from adv_grpo_tpu.data.krepeat import DistributedKRepeatSampler as JSampler
from adv_grpo_tpu.models.flux import FluxConfig as JFluxConfig
from adv_grpo_tpu.models import peft_lora as j_peft
from adv_grpo_tpu.models.mmdit import MMDiTConfig as JMMDiTConfig
from adv_grpo_tpu.models.wan import WanConfig as JWanConfig
from adv_grpo_tpu.native.lib import images_to_uint8 as j_u8
from adv_grpo_tpu.rewards.registry import RewardContext
from adv_grpo_tpu.rewards.registry import multi_score as j_multi_score
from adv_grpo_tpu.utils import flops as j_flops
from adv_grpo_tpu.utils.metrics import MetricLogger as JLogger
from adv_grpo_tpu.utils.metrics import StepTimer as JTimer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_hash_text_encoder_gives_identical_embeddings():
    prompts = ["a flower", "", "a red bicycle", "a flower"]
    got = t_common.make_hash_text_encoder(seq_len=7, embed_dim=16, pooled_dim=5)(prompts)
    want = j_common.make_hash_text_encoder(seq_len=7, embed_dim=16, pooled_dim=5)(prompts)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.float32
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("n,shift", [(40, 3.0), (10, 3.0), (1, 3.0), (28, 1.0), (3, 2.5)])
def test_flow_match_schedule_is_identical(n, shift):
    got = t_sched.flow_match_schedule(n, shift=shift)
    want = j_sched.flow_match_schedule(n, shift=shift)
    np.testing.assert_array_equal(got.sigmas, want.sigmas)
    np.testing.assert_array_equal(got.timesteps, want.timesteps)
    assert got.num_steps == want.num_steps == n


@pytest.mark.parametrize("kind", ["grpo", "rwr", "sft", "dpo"])
@pytest.mark.parametrize("global_std", [False, True])
def test_stat_tracker_gives_identical_advantages(kind, global_std):
    rng = np.random.default_rng(3)
    prompts = ["a", "b", "a", "c", "b", "a", "c", "c"]
    trackers = (t_stats.PerPromptStatTracker(global_std), j_stats.PerPromptStatTracker(global_std))
    for _ in range(2):  # the second call accumulates onto the first
        rewards = rng.standard_normal(len(prompts))
        got, want = (tr.update(prompts, rewards, type=kind) for tr in trackers)
        np.testing.assert_array_equal(got, want)
        assert trackers[0].get_stats() == trackers[1].get_stats()
    for tr in trackers:
        tr.clear()
    assert trackers[0].get_stats() == trackers[1].get_stats()
    rewards = np.array([1.0, 2.0, 1.0, 0.5, 0.5, 3.0, 0.5, 0.5])
    assert (t_stats.calculate_zero_std_ratio(prompts, rewards)
            == j_stats.calculate_zero_std_ratio(prompts, rewards))


@pytest.mark.parametrize("size,batch,k,replicas", [(20, 4, 4, 1), (50, 2, 4, 4), (9, 3, 3, 2)])
def test_krepeat_sampler_draws_identical_batches(size, batch, k, replicas):
    for rank in range(replicas):
        a = TSampler(size, batch, k, replicas, rank, seed=7)
        b = JSampler(size, batch, k, replicas, rank, seed=7)
        for epoch in range(3):
            np.testing.assert_array_equal(a.batch_for_epoch(epoch), b.batch_for_epoch(epoch))
    with pytest.raises(ValueError, match="divisible"):
        TSampler(8, batch_size=1, k=2, num_replicas=1, rank=0)


def test_images_to_uint8_gives_identical_bytes():
    """The JAX package packs in C++ when its native library loads, else with
    the same numpy formula; the port's numpy copy gives the same bytes either
    way, on random values, exact uint8 boundaries and out-of-range values."""
    rng = np.random.default_rng(0)
    x = rng.uniform(-1.2, 1.2, (3, 3, 17, 19)).astype(np.float32)
    levels = (np.arange(256, dtype=np.float32) / 255.0) * 2 - 1  # bin edges
    x[0, 0, 0, :19] = levels[:19]
    x[1].flat[:256] = levels
    x[2].flat[:256] = np.nextafter(levels, np.float32(-2))
    got = t_u8(x)
    assert got.shape == (3, 17, 19, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, j_u8(x))


@pytest.mark.parametrize("weights", [{"jpeg_compressibility": 1},
                                     {"jpeg_compressibility": 0.5, "jpeg_incompressibility": 2}])
@pytest.mark.parametrize("shape", [(3, 3, 32, 32), (3, 5, 3, 16, 24)])
def test_host_rewards_give_identical_scores(weights, shape):
    """Images (B, 3, H, W), and video (B, F, 3, H, W) scored per frame and
    meaned per clip."""
    rng = np.random.default_rng(1)
    images = rng.uniform(-1, 1, shape).astype(np.float32)
    got, _ = t_multi_score(weights)(torch.from_numpy(images), ["a", "b", "c"])
    want, _ = j_multi_score(weights, RewardContext())(images, ["a", "b", "c"])
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_flop_models_are_identical():
    mm_t, mm_j = TMMDiTConfig.sd35_medium(), JMMDiTConfig.sd35_medium()
    fx_t, fx_j = TFluxConfig.dev(), JFluxConfig.dev()
    assert (t_flops.mmdit_forward_flops(mm_t, 1024, 154, 2)
            == j_flops.mmdit_forward_flops(mm_j, 1024, 154, 2))
    assert (t_flops.flux_forward_flops(fx_t, 1024, 512, 1)
            == j_flops.flux_forward_flops(fx_j, 1024, 512, 1))
    for do_cfg in (True, False):
        assert (t_flops.rollout_flops(mm_t, 1024, 154, 8, 10, do_cfg)
                == j_flops.rollout_flops(mm_j, 1024, 154, 8, 10, do_cfg))
    # a 512^2 Flux.1-dev forward at batch 1: 21.5 TFLOP (the PERF.md bound)
    assert abs(t_flops.flux_forward_flops(fx_t, 1024, 512, 1) / 1e12 - 21.5) < 0.05
    wan_t, wan_j = TWanConfig.t2v_1_3b(), JWanConfig.t2v_1_3b()
    for s_vid, s_txt, b in ((8100, 512, 1), (8100, 512, 2), (4500, 512, 1), (12, 6, 3)):
        assert (t_flops.wan_forward_flops(wan_t, s_vid, s_txt, b)
                == j_flops.wan_forward_flops(wan_j, s_vid, s_txt, b))
    # Wan2.1-T2V-1.3B at 33 frames of 480^2 (8,100 tokens), batch 1: 33.3
    # TFLOP (the PERF.md bound)
    assert abs(t_flops.wan_forward_flops(wan_t, 8100, 512, 1) / 1e12 - 33.3) < 0.05


@pytest.mark.parametrize("name", ["pickscore_small", "geneval"])
def test_prompt_datasets_are_identical(name):
    ds_dir = os.path.join(REPO, "dataset", name)
    for split in ("train", "test"):
        if os.path.exists(os.path.join(ds_dir, f"{split}.txt")):
            a = t_data.TextPromptDataset(ds_dir, split, limit=50)
            b = j_data.TextPromptDataset(ds_dir, split, limit=50)
            assert a.prompts == b.prompts
            assert [a[i] for i in range(len(a))] == [b[i] for i in range(len(b))]
    if os.path.exists(os.path.join(ds_dir, "test_metadata.jsonl")):
        a = t_data.GenevalPromptDataset(ds_dir, "test", limit=20)
        b = j_data.GenevalPromptDataset(ds_dir, "test", limit=20)
        assert len(a) == len(b) > 0
        assert [a[i] for i in range(len(a))] == [b[i] for i in range(len(b))]


@pytest.mark.parametrize("num_refs,strict", [(1, False), (2, False), (1, True)])
def test_reference_store_gives_identical_batches(tmp_path, monkeypatch, num_refs, strict):
    """The port's store against the JAX store's PIL path (its C++ loader
    switched off): the same files chosen from a seeded rng, the same BICUBIC
    resize, the fallback frame for a prompt without images and for a broken
    file, and ``strict`` raising where the JAX store raises."""
    from PIL import Image

    from adv_grpo_tpu.native import lib as j_native

    monkeypatch.setattr(j_native, "load_images_chw", lambda *a, **k: None)
    rng = np.random.default_rng(4)
    for i in range(3):
        Image.fromarray(rng.integers(0, 256, (20 + 7 * i, 30, 3), dtype=np.uint8)).save(
            tmp_path / f"r{i}.png")
    (tmp_path / "broken.png").write_bytes(b"not a png")
    mapping = {"a": ["r0.png", "r1.png", "r2.png"], "b": "r1.png", "c": [],
               "d": ["broken.png"], "e": [str(tmp_path / "r2.png")]}
    (tmp_path / "refs.json").write_text(json.dumps(mapping))
    stores = [mod.ReferenceImageStore(str(tmp_path / "refs.json"), str(tmp_path), resolution=24,
                                      num_refs=num_refs, strict=strict)
              for mod in (t_data, j_data)]
    import random

    prompts = ["a", "b", "e", "a"] if strict else ["a", "b", "c", "d", "e", "missing", "a"]
    got, want = (s.get_batch(prompts, rng=random.Random(5)) for s in stores)
    assert got.shape == (len(prompts), num_refs, 3, 24, 24) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(stores[0].get("a", random.Random(1)),
                                  stores[1].get("a", random.Random(1)))
    if strict:
        for prompt, err in (("c", KeyError), ("d", Exception)):
            for s in stores:
                with pytest.raises(err):
                    s.get_batch([prompt])


def test_embedding_store_reads_identically(tmp_path):
    encode = j_common.make_hash_text_encoder(seq_len=5, embed_dim=8, pooled_dim=3)
    prompts = ["a", "b", "c", "a", "d"]
    write_store(str(tmp_path), prompts, encode, batch_size=2)
    a, b = TEmbeddingStore(str(tmp_path)), JEmbeddingStore(str(tmp_path))
    for g, w in zip(a(["d", "a", "b"]), b(["d", "a", "b"])):
        np.testing.assert_array_equal(g, w)
    with pytest.raises(KeyError):
        a(["z"])


@pytest.mark.parametrize("batch", [1, 3, 8])
def test_write_store_writes_identical_bytes(tmp_path, batch):
    """The port's ``write_store`` (dedup in order, the fixed batch padded with
    the last prompt, fp16 memmaps) writes the JAX one's files byte for byte,
    and asks its encoder for the same batches."""
    calls = {"j": [], "t": []}
    base = j_common.make_hash_text_encoder(seq_len=5, embed_dim=8, pooled_dim=3)

    def encoder(side):
        def encode(prompts):
            calls[side].append(list(prompts))
            return base(prompts)
        return encode

    prompts = ["a", "b", "", "c", "a", "d", "e", "b", "f"]
    write_store(str(tmp_path / "j"), prompts, encoder("j"), batch_size=batch)
    t_write_store(str(tmp_path / "t"), prompts, encoder("t"), batch_size=batch)
    assert calls["t"] == calls["j"] and all(len(c) == batch for c in calls["t"])
    for name in ("prompts.json", "embeds.npy", "pooled.npy"):
        with open(tmp_path / "j" / name, "rb") as a, open(tmp_path / "t" / name, "rb") as b:
            assert a.read() == b.read(), name


def test_apply_overrides_is_identical():
    def cfg():
        c = ConfigDict(seed=1, sample=ConfigDict(num_steps=4, name="x"))
        return c

    ovs = ["seed=3", "sample.num_steps=10", "sample.name=plain text", "sample.new=[1, 2]"]
    assert t_common.apply_overrides(cfg(), ovs) == j_common.apply_overrides(cfg(), ovs)
    with pytest.raises(ValueError):
        t_common.apply_overrides(cfg(), ["seed"])


def test_metric_logger_and_timer_match(tmp_path):
    records = []
    for logger_cls, timer_cls, sub in ((TLogger, TTimer, "t"), (JLogger, JTimer, "j")):
        timer = timer_cls()
        for phase in ("rollout", "train", "rollout"):
            with timer(phase):
                pass
        logger = logger_cls(str(tmp_path / sub))
        logger.log({"a": 1, "b": np.float32(2.5), "c": np.arange(3)}, step=4)
        logger.log({"d": "x"})
        grid = logger.log_image_grid("g", np.zeros((2, 4, 4, 3), np.uint8), step=1)
        assert grid is not None and os.path.exists(grid)
        with open(tmp_path / sub / "metrics.jsonl") as f:
            lines = [json.loads(line) for line in f]
        for line in lines:
            line.pop("time")
        records.append((lines, sorted(timer.summary()), dict(timer.counts)))
    assert records[0] == records[1]


PEFT_MODULES = ["transformer_blocks.3.attn.to_out.0", "base_model.model.transformer_blocks.0.attn.to_q",
                "transformer.transformer_blocks.12.attn.add_k_proj",
                "base_model.transformer_blocks.7.attn.to_add_out", "double_3.attn.add_to_q",
                "single_0.attn.to_q", "blocks.2.to_out.0", "proj_out"]


def test_peft_key_mapping_is_identical():
    """The copied peft key mapping: every module name (each prefix peft
    writes, the ``to_out.0`` ModuleList, Flux's and WAN's paths) maps to the
    same JAX flat path and back to the same canonical name; the key pattern
    parses the same keys, ``.default.`` included."""
    for module in PEFT_MODULES:
        path = t_peft._module_to_flax_path(module)
        assert path == j_peft._module_to_flax_path(module), module
        assert t_peft._flax_path_to_module(path) == j_peft._flax_path_to_module(path), path
    assert t_peft._PREFIXES == j_peft._PREFIXES
    for key in ("base_model.model.transformer_blocks.1.attn.to_q.lora_A.weight",
                "x.attn.to_out.0.lora_B.default.weight", "x.lora_A.bias", "x.weight"):
        got, want = t_peft._LORA_KEY.match(key), j_peft._LORA_KEY.match(key)
        assert (got and got.groupdict()) == (want and want.groupdict()), key


def test_latest_and_prune_checkpoints_are_identical(tmp_path):
    """The copied ``latest_checkpoint`` / ``prune_checkpoints`` over the same
    directories: numeric order (2, 9, 10, 100), other names ignored, a keep
    of 0 prunes nothing."""
    from adv_grpo_torch.train import checkpoint as t_ckpt
    from adv_grpo_tpu.train import checkpoint as j_ckpt

    for sub in ("t", "j"):
        assert t_ckpt.latest_checkpoint(str(tmp_path / sub)) is None
        for name in ("checkpoint-2", "checkpoint-100", "checkpoint-9", "checkpoint-10", "other"):
            os.makedirs(tmp_path / sub / "checkpoints" / name)
    for keep in (0, 3, 1):
        t_ckpt.prune_checkpoints(str(tmp_path / "t"), keep)
        j_ckpt.prune_checkpoints(str(tmp_path / "j"), keep)
        got, want = (sorted(os.listdir(tmp_path / sub / "checkpoints")) for sub in "tj")
        assert got == want
        assert (os.path.basename(t_ckpt.latest_checkpoint(str(tmp_path / "t")))
                == os.path.basename(j_ckpt.latest_checkpoint(str(tmp_path / "j")))
                == "checkpoint-100")
    assert got == ["checkpoint-100", "other"]


@pytest.mark.parametrize("name", sorted(j_data.PROMPT_FNS))
def test_prompt_functions_are_identical(name):
    """Each prompt function draws the same prompts and metadata from the same
    ``random`` state (the word lists read from the JAX package's assets)."""
    import random

    assert sorted(t_data.PROMPT_FNS) == sorted(j_data.PROMPT_FNS)
    draws = {}
    for side, mod in (("t", t_data), ("j", j_data)):
        random.seed(11)
        draws[side] = [mod.get_prompt_fn(name)() for _ in range(25)]
    assert draws["t"] == draws["j"]
    assert len({p for p, _ in draws["t"]}) > 1


def test_preference_pairs_and_tooling_are_identical(tmp_path, monkeypatch):
    from PIL import Image

    from adv_grpo_torch.data import tooling as t_tooling
    from adv_grpo_tpu.data import tooling as j_tooling
    from adv_grpo_tpu.native import lib as j_native

    monkeypatch.setattr(j_native, "load_images_chw", lambda *a, **k: None)
    rng = np.random.default_rng(9)
    for d in ("good", "bad"):
        (tmp_path / d).mkdir()
        for i in range(3):
            Image.fromarray(rng.integers(0, 256, (12 + i, 17, 3), dtype=np.uint8)).save(
                tmp_path / d / f"f{i}.png")
    (tmp_path / "good" / "f2.png").unlink()  # the (bad, bad) pair
    (tmp_path / "p.json").write_text(json.dumps({"a": "f0.png", "b": ["f1.png", "f0.png"],
                                                 "c": "f2.png"}))
    args = (str(tmp_path / "p.json"), str(tmp_path / "good"), str(tmp_path / "bad"))
    got, want = (mod.PreferencePairDataset(*args, resolution=9).get_batch([2, 0, 1])
                 for mod in (t_data, j_data))
    assert got[0] == want[0] == ["c", "a", "b"]
    for g, w in zip(got[1:], want[1:]):
        assert g.dtype == np.float32
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got[1][0], got[2][0])
    for w, n in (([0.7, 0.3], 10), ([3, 1, 1, 2], 17), ([0.2] * 5, 3)):
        assert (t_tooling.largest_remainder_allocation(w, n)
                == j_tooling.largest_remainder_allocation(w, n))


def test_remote_and_vlm_copies_are_identical():
    """The jax-free parts of rewards/remote.py and rewards/vlm.py, the SigLIP
    normalisation and ImageReward's z-normalisation."""
    from adv_grpo_torch.models import blip as t_blip
    from adv_grpo_torch.rewards import preprocess as t_pp
    from adv_grpo_torch.rewards import remote as t_remote
    from adv_grpo_torch.rewards import vlm as t_vlm
    from adv_grpo_tpu.models import blip as j_blip
    from adv_grpo_tpu.rewards import preprocess as j_pp
    from adv_grpo_tpu.rewards import remote as j_remote
    from adv_grpo_tpu.rewards import vlm as j_vlm

    for name in ("GENEVAL_URL", "DEQA_URL", "UNIFIEDREWARD_SGLANG_URL", "UNIFIEDREWARD_QUESTION"):
        assert getattr(t_remote, name) == getattr(j_remote, name)
    assert t_vlm.QWENVL_RUBRIC == j_vlm.QWENVL_RUBRIC
    assert (t_pp.SIGLIP_MEAN, t_pp.SIGLIP_STD) == (j_pp.SIGLIP_MEAN, j_pp.SIGLIP_STD)
    assert (t_blip.IMAGEREWARD_MEAN, t_blip.IMAGEREWARD_STD) == (j_blip.IMAGEREWARD_MEAN,
                                                                 j_blip.IMAGEREWARD_STD)
    u8 = np.random.default_rng(0).integers(0, 256, (3, 20, 30, 3), dtype=np.uint8)
    assert t_remote.jpeg_bytes(u8) == j_remote.jpeg_bytes(u8)
    for resize in (512, 16, None):
        assert t_remote.png_base64(u8[0], resize) == j_remote.png_base64(u8[0], resize)
    texts = ["Final Score: 4", "final score: 3", "Final Score:2.75 then Final Score: 5", None,
             "", "Final Score: 6", "Final Score:\n 1.5", "Score: 3"]
    assert t_remote.extract_final_scores(texts) == j_remote.extract_final_scores(texts)
    texts = ["<Score>4</Score>", "<Score> 3.5 </Score>", "<Score>7</Score>", "<Score>x</Score>",
             "", "<Thought>a</Thought><Score>0</Score>", "<Score>2.</Score>"]
    for scale in (5.0, 10.0):
        assert ([t_vlm.extract_qwenvl_score(t, scale) for t in texts]
                == [j_vlm.extract_qwenvl_score(t, scale) for t in texts])
