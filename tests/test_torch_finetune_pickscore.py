"""The offline PickScore finetune, its ``.msgpack`` and the trainer's warm
start from it, against the JAX package.

  * ``PreferencePairDataset`` bitwise against the JAX dataset's PIL path
    (its C++ loader switched off), the (bad, bad) fallback of a missing good
    file and the first render of a multi-variation JSON included.
  * The crc32 hash ids exactly as the JAX CLI feeds them (recorded from its
    run).
  * Two epochs of ``--smoke`` (tiny towers, 8 bright / dark pairs and one
    degraded pair, lr 1e-3, batch 4) from the JAX init carried across
    (``main(state_dict=)``): the history and the final tree against the
    JAX CLI's (rtol 1e-4 / atol 2e-5 on the history; atol 2e-4 on the tree:
    AdamW's 4 steps of 1e-3 on fp32 gradients that differ in the last bits;
    the attention key biases, whose exact gradient is zero, 2 x 4 x 1e-3).
  * ``--tune_layer 1`` (batch 8: one step): the last vision layer within the
    same tolerance of JAX's, every other tensor bitwise its start. Next to
    it, the JAX CLI's masked leaves: they move by exactly their gradient
    (``optax.masked`` passes the masked updates through), here the port's
    gradient at the start within 1e-5.
  * ``utils.msgpack_io``: a port-written file restores bitwise in the JAX
    ``serialization.from_bytes``, a JAX-written one reads bitwise into the
    port, and hypothesis trees of f32 / f16 / i32 arrays and scalars make
    flax's bytes exactly and read back bitwise.
  * The warm start: ``pickscore_cotrain_sd3_fast`` (smoke) with
    ``weight_path`` the finetuned ``.msgpack``: the live scorer is the file,
    the frozen 'pickscore' score of a fixed batch is bitwise a fresh build's,
    and the live parameters are bitwise those the JAX
    ``restore_discriminator`` loads ('pickscore_cotrain' within 1e-5 of the
    JAX score with them).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st
from PIL import Image

from adv_grpo_torch.cli import finetune_pickscore as t_ft
from adv_grpo_torch.cli import train as t_train
from adv_grpo_torch.cli.common import apply_overrides, resolve_config
from adv_grpo_torch.data import datasets as t_data
from adv_grpo_torch.models.clip_text import CLIPTextConfig as TTextConfig
from adv_grpo_torch.models.convert import (
    clip_dual_state_dict_from_jax, clip_dual_state_dict_to_jax)
from adv_grpo_torch.models.vit import ViTConfig as TViTConfig
from adv_grpo_torch.rewards.registry import multi_score
from adv_grpo_torch.utils import msgpack_io
from adv_grpo_tpu.cli import finetune_pickscore as j_ft
from adv_grpo_tpu.data import datasets as j_data
from adv_grpo_tpu.models.clip_text import CLIPTextConfig as JTextConfig
from adv_grpo_tpu.models.vit import ViTConfig as JViTConfig
from adv_grpo_tpu.native import lib as j_native
from adv_grpo_tpu.rewards.scorers import PickScoreScorer as JPickScore
from adv_grpo_tpu.train.driver import GRPOTrainer as JGRPOTrainer

TCFG, VCFG = TTextConfig.tiny(projection_dim=16), TViTConfig.tiny(projection_dim=16)
SEED = 42  # the CLIs' default --seed: the JAX init and the pair order


@pytest.fixture(scope="module")
def pair_dirs(tmp_path_factory):
    """8 pairs, good bright and bad dark, and one whose good file is missing."""
    root = tmp_path_factory.mktemp("pairs")
    good, bad = root / "good", root / "bad"
    good.mkdir(), bad.mkdir()
    rng = np.random.default_rng(0)
    p2i = {}
    for i in range(8):
        fname = f"img_{i}.png"
        Image.fromarray((rng.uniform(0.7, 1.0, (32, 32, 3)) * 255).astype(np.uint8)).save(
            good / fname)
        Image.fromarray((rng.uniform(0.0, 0.3, (32, 32, 3)) * 255).astype(np.uint8)).save(
            bad / fname)
        p2i[f"prompt {i}"] = fname
    p2i["prompt missing"] = "nope.png"
    Image.fromarray(np.zeros((32, 32, 3), np.uint8)).save(bad / "nope.png")
    (root / "prompt2img.json").write_text(json.dumps(p2i))
    return str(root / "prompt2img.json"), str(good), str(bad)


@pytest.fixture(scope="module")
def jax_init():
    js = JPickScore(JTextConfig.tiny(projection_dim=16), JViTConfig.tiny(projection_dim=16),
                    image_size=28)
    return js, jax.device_get(js.init_params(jax.random.PRNGKey(SEED)))


def _argv(pair_dirs, out, *extra):
    jf, good, bad = pair_dirs
    return ["--json_file", jf, "--good_dir", good, "--bad_dir", bad, "--out", str(out),
            "--smoke", "--lr", "1e-3", "--max_eval", "9", *extra]


def _tree_atol(key, steps, lr=1e-3):
    """The tolerance of a finetuned leaf against JAX's: 2e-4, but a key
    bias's gradient is zero in exact arithmetic (the softmax is invariant to
    a score shift the same for every key), so each package's AdamW turns its
    own fp32 rounding noise into steps of up to about lr: 2 x steps x lr."""
    return 2 * steps * lr if key.endswith("k_proj/bias") else 2e-4


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree)}


@pytest.fixture(scope="module")
def runs(pair_dirs, jax_init, tmp_path_factory):
    """The JAX and the port CLI: full tree (2 epochs, batch 4) and
    ``--tune_layer 1`` (1 epoch, batch 8); the JAX hash ids recorded."""
    tmp = tmp_path_factory.mktemp("ft")
    start = clip_dual_state_dict_from_jax(jax_init[1], TCFG, VCFG)
    ids, asarray = [], jnp.asarray

    def recording(a, *args, **kw):
        if isinstance(a, np.ndarray) and a.dtype == np.int32 and a.ndim == 2:
            ids.append(a.copy())
        return asarray(a, *args, **kw)

    out = {}
    mp = pytest.MonkeyPatch()
    try:
        # the JAX dataset's PIL path (its C++ batch loader differs from PIL
        # by up to 2 uint8 levels): both CLIs see the same pixels
        mp.setattr(j_native, "load_images_chw", lambda *a, **k: None)
        mp.setattr(jnp, "asarray", recording)
        for name, extra in (("full", ["--epochs", "2", "--batch", "4"]),
                            ("tune", ["--epochs", "1", "--batch", "8", "--tune_layer", "1"])):
            j = j_ft.main(_argv(pair_dirs, tmp / f"jax_{name}", *extra))
            mp.setattr(jnp, "asarray", asarray)
            t = t_ft.main(_argv(pair_dirs, tmp / f"port_{name}", *extra, "--device", "cpu"),
                          state_dict={k: v.clone() for k, v in start.items()})
            out[name] = (j, t)
    finally:
        mp.undo()
    return out, start, ids


def test_preference_pairs_equal_jax(pair_dirs, monkeypatch, tmp_path):
    monkeypatch.setattr(j_native, "load_images_chw", lambda *a, **k: None)
    jf, good, bad = pair_dirs
    t, j = (mod.PreferencePairDataset(jf, good, bad, resolution=28) for mod in (t_data, j_data))
    assert len(t) == len(j) == 9 and t.prompts == j.prompts
    for i in range(9):
        a, b = t[i], j[i]
        assert a["prompt"] == b["prompt"]
        np.testing.assert_array_equal(a["good"], b["good"])
        np.testing.assert_array_equal(a["bad"], b["bad"])
    np.testing.assert_array_equal(t[8]["good"], t[8]["bad"])  # missing good: (bad, bad)
    assert t[0]["good"].mean() > t[0]["bad"].mean()
    for x, y in zip(t.get_batch([0, 8, 3]), j.get_batch([0, 8, 3])):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    multi = tmp_path / "multi.json"
    multi.write_text(json.dumps({"prompt 0": ["img_1.png", "img_0.png"]}))
    t, j = (mod.PreferencePairDataset(str(multi), good, bad, resolution=20)
            for mod in (t_data, j_data))
    np.testing.assert_array_equal(t[0]["good"], j[0]["good"])
    np.testing.assert_array_equal(t[0]["good"], t_data.PreferencePairDataset(
        jf, good, bad, resolution=20)[1]["good"])


def test_hash_ids_equal_jax(runs, pair_dirs):
    _, _, ids = runs
    ds = t_data.PreferencePairDataset(*pair_dirs, resolution=28)
    # the JAX CLI's first call: the eval before training, pairs 0..3
    prompts = ds.get_batch([0, 1, 2, 3])[0]
    want = ids[0]
    got = t_ft.hash_token_ids(prompts, TCFG.max_position_embeddings, TCFG.vocab_size)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_full_finetune_matches_jax(runs):
    out, start, _ = runs
    j, t = out["full"]
    assert [h["epoch"] for h in t["history"]] == [-1, 0, 1]
    for a, b in zip(t["history"], j["history"]):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_allclose(a[k], b[k], rtol=1e-4, atol=2e-5, err_msg=k)
    got, want = _flat(msgpack_io.load(t["params_path"])), _flat(msgpack_io.load(j["params_path"]))
    assert got.keys() == want.keys()
    start_flat = _flat(clip_dual_state_dict_to_jax(start, TCFG, VCFG))
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=_tree_atol(k, 4), err_msg=k)
    moved = {k for k in got if not np.array_equal(got[k], start_flat[k])}
    # the full tree trains: every leaf moves but those the JAX run leaves too
    # (zero-initialised with an exactly zero gradient, so no decay either)
    assert moved == {k for k in want if not np.array_equal(want[k], start_flat[k])}
    assert len(moved) > 0.9 * len(want)
    with open(str(t["params_path"]).replace("pickscore_finetuned.msgpack",
                                            "finetune_metrics.json")) as f:
        assert json.load(f) == t["history"]


def test_tune_layer_freezes_all_but_the_last_layer(runs):
    (j, t), start = runs[0]["tune"], runs[1]
    start_flat = _flat(clip_dual_state_dict_to_jax(start, TCFG, VCFG))
    got, want = _flat(msgpack_io.load(t["params_path"])), _flat(msgpack_io.load(j["params_path"]))
    last = f"/vision/layer_{VCFG.num_layers - 1}/"
    trained = [k for k in got if k.startswith(last)]
    assert trained
    for k in got:
        if k.startswith(last):
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=_tree_atol(k, 1),
                                       err_msg=k)
            assert not np.array_equal(got[k], start_flat[k]), k
        else:
            np.testing.assert_array_equal(got[k], start_flat[k], err_msg=k)


def test_jax_tune_layer_moves_masked_leaves_by_their_gradient(runs, pair_dirs):
    """The JAX CLI's ``optax.masked`` fault, documented: after its one step
    every masked-out leaf equals its start plus its gradient (the update
    optax.masked passes through, added at an implied learning rate of 1)."""
    (j, _), start = runs[0]["tune"], runs[1]
    scorer = t_ft.build_scorer(True, SEED, torch.device("cpu"),
                               {k: v.clone() for k, v in start.items()})
    ds = t_data.PreferencePairDataset(*pair_dirs, resolution=28)
    idx = np.random.default_rng(SEED).permutation(len(ds))[:8].tolist()
    prompts, good, bad = ds.get_batch(idx)
    from adv_grpo_torch.adversarial.clip_criterion import pickscore_d_step_loss_and_acc

    loss, _ = pickscore_d_step_loss_and_acc(
        scorer, torch.from_numpy(good), torch.from_numpy(bad),
        t_ft.hash_token_ids(prompts, TCFG.max_position_embeddings, TCFG.vocab_size))
    loss.backward()
    grad = _flat(clip_dual_state_dict_to_jax(
        {k: p.grad if p.grad is not None else torch.zeros_like(p)
         for k, p in scorer.clip.named_parameters()}, TCFG, VCFG))
    start_flat = _flat(clip_dual_state_dict_to_jax(start, TCFG, VCFG))
    jax_after = _flat(msgpack_io.load(j["params_path"]))
    last = f"/vision/layer_{VCFG.num_layers - 1}/"
    masked = [k for k in jax_after if not k.startswith(last)]
    moved = [k for k in masked if not np.array_equal(jax_after[k], start_flat[k])]
    assert len(moved) > len(masked) // 2
    for k in masked:
        np.testing.assert_allclose(jax_after[k] - start_flat[k], grad[k], rtol=1e-3, atol=1e-5,
                                   err_msg=k)


def test_port_file_restores_bitwise_in_jax(runs, jax_init):
    t = runs[0]["full"][1]
    with open(t["params_path"], "rb") as f:
        data = f.read()
    restored = serialization.from_bytes(jax_init[1], data)
    assert jax.tree_util.tree_structure(restored) == jax.tree_util.tree_structure(jax_init[1])
    ours = _flat(msgpack_io.load(t["params_path"]))
    for k, v in _flat(restored).items():
        assert v.dtype == np.float32
        np.testing.assert_array_equal(v, ours[k])


def test_jax_file_reads_bitwise_into_the_port(runs):
    j = runs[0]["full"][0]
    with open(j["params_path"], "rb") as f:
        want = serialization.msgpack_restore(f.read())
    got = msgpack_io.load(j["params_path"])
    fw, fg = _flat(want), _flat(got)
    assert fw.keys() == fg.keys()
    for k in fw:
        assert fg[k].dtype == fw[k].dtype and fg[k].shape == fw[k].shape
        np.testing.assert_array_equal(fg[k], fw[k])
    sd = clip_dual_state_dict_from_jax(got, TCFG, VCFG)
    assert set(sd) == set(runs[1])


_DTYPES = st.sampled_from([np.float32, np.float16, np.int32])
_ARRAYS = st.builds(
    lambda dt, shape, seed: (np.random.default_rng(seed).standard_normal(shape) * 100).astype(dt),
    _DTYPES, st.lists(st.integers(0, 5), max_size=3).map(tuple), st.integers(0, 2 ** 16))
_SCALARS = st.one_of(
    st.builds(lambda dt, x: dt(x), st.sampled_from([np.float32, np.float16, np.int32]),
              st.integers(-1000, 1000)),
    st.integers(-2 ** 40, 2 ** 40), st.floats(allow_nan=False), st.booleans(), st.none(),
    st.text(max_size=40))
_KEYS = st.text(min_size=1, max_size=12)
_TREES = st.recursive(st.one_of(_ARRAYS, _SCALARS),
                      lambda kids: st.dictionaries(_KEYS, kids, min_size=1, max_size=4),
                      max_leaves=12)


@settings(max_examples=60, deadline=None, derandomize=True,
          suppress_health_check=[HealthCheck.too_slow])
@given(st.dictionaries(_KEYS, _TREES, min_size=1, max_size=4))
def test_codec_round_trips_and_writes_flax_bytes(tree):
    data = msgpack_io.dumps(tree)
    assert data == serialization.msgpack_serialize(tree)
    got, want = msgpack_io.loads(data), serialization.msgpack_restore(data)

    def same(a, b):
        if isinstance(b, dict):
            return isinstance(a, dict) and a.keys() == b.keys() and all(
                same(a[k], b[k]) for k in b)
        if isinstance(b, (np.ndarray, np.generic)):
            return (type(a) is type(b) and a.dtype == b.dtype and np.shape(a) == np.shape(b)
                    and np.array_equal(a, b))
        return type(a) is type(b) and a == b

    assert same(got, want) and same(got, tree if not isinstance(tree, list) else got)


def test_codec_refuses_what_it_cannot_read(tmp_path):
    good = msgpack_io.dumps({"a": np.ones(3, np.float32)})
    with pytest.raises(ValueError, match="truncated"):
        msgpack_io.loads(good[:-2])
    with pytest.raises(ValueError, match="after the msgpack object"):
        msgpack_io.loads(good + b"\x00")
    (tmp_path / "list.msgpack").write_bytes(b"\x92\x01\x02")
    with pytest.raises(ValueError, match="not a non-empty map"):
        msgpack_io.check_map(str(tmp_path / "list.msgpack"))
    with pytest.raises(ValueError, match="empty"):
        (tmp_path / "empty.msgpack").write_bytes(b"")
        msgpack_io.check_map(str(tmp_path / "empty.msgpack"))


def _cotrain_trainer(weight_path=None):
    overrides = ["smoke_test=True", "pretrained.model=", "dataset=dataset/pickscore_small",
                 "sample.train_batch_size=2", "wandb_init=False"]
    if weight_path:
        overrides.append(f"weight_path={weight_path}")
    config = apply_overrides(resolve_config("pickscore_cotrain_sd3_fast"), overrides)
    return t_train.build_trainer(config, latent_hw=8, device="cpu")


@pytest.fixture(scope="module")
def warm(runs):
    path = runs[0]["full"][1]["params_path"]
    return path, _cotrain_trainer(path), _cotrain_trainer()


def _probe():
    rng = np.random.default_rng(7)
    return rng.uniform(-1, 1, (3, 3, 32, 32)).astype(np.float32), ["a cat", "a dog", "a cow"]


def test_warm_start_live_scorer_is_the_file(warm):
    path, trainer, _ = warm
    want = clip_dual_state_dict_from_jax(msgpack_io.load(path), TCFG, VCFG)
    live = trainer.reward_ctx.pickscore.clip.state_dict()
    assert live.keys() == want.keys()
    for k, v in want.items():
        torch.testing.assert_close(live[k], v, rtol=0, atol=0)
    # the D-step still trains only the tail; its optimizer is fresh
    assert {n for n, p in trainer.reward_ctx.pickscore.clip.named_parameters()
            if p.requires_grad} == {n for n in live if n.startswith("vision_model.layers.1.")}
    assert not trainer.disc.opt_state.state


def test_warm_start_keeps_the_frozen_reward(warm):
    _, trainer, fresh = warm
    images, prompts = _probe()
    got = multi_score({"pickscore": 1.0}, trainer.reward_ctx)(images, prompts)[0]["pickscore"]
    want = multi_score({"pickscore": 1.0}, fresh.reward_ctx)(images, prompts)[0]["pickscore"]
    np.testing.assert_array_equal(got, want)
    live = multi_score({"pickscore_cotrain": 1.0}, trainer.reward_ctx)(images, prompts)[0]
    assert not np.array_equal(live["pickscore_cotrain"], want)


def test_warm_start_matches_the_jax_restore(warm, jax_init):
    path, trainer, _ = warm
    js, init = jax_init

    class Disc:
        kind, params, opt_state = "pickscore", init, None

    jt = JGRPOTrainer.__new__(JGRPOTrainer)
    jt.disc, jt.reward_ctx = Disc(), None
    JGRPOTrainer.restore_discriminator(jt, path)
    want = clip_dual_state_dict_from_jax(jax.device_get(jt.disc.params), TCFG, VCFG)
    live = trainer.reward_ctx.pickscore.clip.state_dict()
    for k, v in want.items():
        torch.testing.assert_close(live[k], v, rtol=0, atol=0)
    images, prompts = _probe()
    ids = trainer.reward_ctx.tokenize(prompts)
    got = multi_score({"pickscore_cotrain": 1.0}, trainer.reward_ctx)(
        images, prompts)[0]["pickscore_cotrain"]
    jscore = np.asarray(js.score(jt.disc.params, jnp.asarray(images), jnp.asarray(ids)))
    np.testing.assert_allclose(got, jscore, rtol=1e-5, atol=1e-5)


def _dense_tree(linear):
    return {"kernel": linear.weight.detach().numpy().T.copy(),
            "bias": linear.bias.detach().numpy().copy()}


@pytest.mark.parametrize("kind", ["dino_patch", "dino_multi", "stylegan"])
def test_dino_heads_warm_start_from_flax_files(tmp_path, kind):
    """A ``.msgpack`` of a JAX DINO head (``{"fc1", "fc2"}``) or of the
    multi-layer heads (``{"heads": [...], "fusion": {"fuse"}}``, the list
    written as flax writes it) loads into the live module bitwise and the
    reward reads it; another discriminator kind raises naming itself."""
    from adv_grpo_torch.rewards.registry import RewardContext
    from adv_grpo_torch.rewards.scorers import DINOHead, DINOMultiHeads
    from adv_grpo_torch.train.driver import DiscriminatorBundle, GRPOTrainer

    torch.manual_seed(0)
    src = DINOMultiHeads(8, 2, hidden=6) if kind == "dino_multi" else DINOHead(8, hidden=6)
    if kind == "dino_multi":
        tree = {"heads": [{"fc1": _dense_tree(h.fc1), "fc2": _dense_tree(h.fc2)}
                          for h in src.heads], "fusion": {"fuse": _dense_tree(src.fusion)}}
    else:
        tree = {"fc1": _dense_tree(src.fc1), "fc2": _dense_tree(src.fc2)}
    path = tmp_path / "d.msgpack"
    path.write_bytes(serialization.to_bytes(tree))
    live = type(src)(8, 2, hidden=6) if kind == "dino_multi" else DINOHead(8, hidden=6)
    trainer = GRPOTrainer.__new__(GRPOTrainer)
    trainer.disc = DiscriminatorBundle(kind, None, None, live)
    trainer.reward_ctx = RewardContext()
    if kind == "stylegan":
        with pytest.raises(ValueError, match="'stylegan'"):
            trainer.restore_discriminator(str(path))
        return
    trainer.restore_discriminator(str(path))
    for k, v in src.state_dict().items():
        torch.testing.assert_close(live.state_dict()[k], v, rtol=0, atol=0)
    held = (trainer.reward_ctx.dino_multi_params if kind == "dino_multi"
            else trainer.reward_ctx.dino_head_params)
    assert held is live
