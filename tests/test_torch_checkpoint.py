"""The port's checkpoints and LoRA interchange, on the CPU.

* ``utils/safetensors_io``: the port's files are byte for byte those of the
  ``safetensors`` package, and each reads the other's tensors bitwise, for
  F32, F16, BF16 and I64 with ``__metadata__``; a truncated file and an
  unknown dtype raise.
* ``models/peft_lora``: adapters cross between the packages bitwise both
  ways (the JAX export read by the port, the port's export read by the JAX
  ``import_peft_lora`` and ``load_lora_only``, byte-identical directories),
  the port's adapter loads into a real ``peft`` model and gives the port's
  forward (3e-4, as tests/test_peft_lora.py holds the JAX export), every
  LoRA path of the tiny MMDiT, Flux and WAN round-trips, and rank / alpha
  mismatches raise.
* ``train/checkpoint.generator_state_from_jax``: a JAX generator state after
  one epoch, saved by the JAX ``save_state`` (orbax) and read back by its
  ``restore_state``, carried into the port; a second epoch on each side then
  agrees within ``test_train_epoch_matches_jax``'s tolerances.
* the trainer (ports of tests/test_trainer_e2e.py:185-275, :400-431): save
  then restore is bitwise for every state tensor and counter; the saved
  ``lora/`` holds the EMA; checkpoints order and prune by number; the LoRA
  warm start re-seeds the EMA and keeps the optimizer fresh, and refuses a
  mismatch or an orbax tree; the discriminator's state round-trips for the
  PickScore tail and a DINO head, the live reward following it and the
  frozen one staying bitwise; and a resumed run's next epoch is bitwise the
  original run's once that run's epoch counter is set back to 0, since
  neither package saves the counter.
"""

import copy
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import safetensors.numpy
import safetensors.torch
import torch

from adv_grpo_torch.cli import train as t_train
from adv_grpo_torch.cli.common import apply_overrides, resolve_config
from adv_grpo_torch.data.datasets import TextPromptDataset
from adv_grpo_torch.models import peft_lora as t_peft
from adv_grpo_torch.models.convert import mmdit_state_dict_from_jax
from adv_grpo_torch.models.flux import FluxConfig, FluxTransformer
from adv_grpo_torch.models.lora import freeze_non_lora, init_params_
from adv_grpo_torch.models.lora import lora_params as t_lora_params
from adv_grpo_torch.models.mmdit import MMDiT as TMMDiT
from adv_grpo_torch.models.mmdit import MMDiTConfig as TMMDiTConfig
from adv_grpo_torch.models.wan import WanConfig, WanTransformer
from adv_grpo_torch.rewards.registry import multi_score
from adv_grpo_torch.rollout import sampler as t_sampler
from adv_grpo_torch.train import checkpoint as t_ckpt
from adv_grpo_torch.train import grpo_trainer as t_trainer
from adv_grpo_torch.train import train_state as t_state
from adv_grpo_torch.utils import safetensors_io
from adv_grpo_tpu.models import peft_lora as j_peft
from adv_grpo_tpu.models.lora import lora_params as j_lora_params
from adv_grpo_tpu.rollout import sampler as j_sampler
from adv_grpo_tpu.train import checkpoint as j_ckpt
from adv_grpo_tpu.train import grpo_trainer as j_trainer
from adv_grpo_tpu.train import train_state as j_state
from tests.test_peft_lora import ALPHA, R, _flax_with_adapter, _inputs
from tests.test_peft_lora import peft_setup  # noqa: F401 (fixture)
from tests.test_torch_cotrain import _refs, tiny_config
from tests.test_torch_dino_cotrain import _dino_trainer
from tests.test_torch_models import jax_tiny_pipeline
from tests.test_torch_train import _port_pipeline, _t, _train_cfg, _window_record

# ── safetensors ──────────────────────────────────────────────────────────

DTYPES = {"F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
          "I64": torch.int64}
METADATA = {"format": "pt", "written_by": "a test"}


def _tensors(code, seed=0):
    g = torch.Generator().manual_seed(seed)
    dtype = DTYPES[code]

    def make(*shape):
        if dtype == torch.int64:
            return torch.randint(-2**40, 2**40, shape, generator=g)
        return torch.randn(shape, generator=g).to(dtype)

    return {"w": make(5, 3), "b": make(7), "scalar": make(), "empty": make(0, 4),
            "blocks.0.x": make(2, 3, 4)}


def _assert_same(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        g = torch.as_tensor(got[k])
        assert g.dtype == v.dtype and g.shape == v.shape and torch.equal(g, v), k


@pytest.mark.parametrize("code", list(DTYPES))
def test_port_safetensors_read_by_the_package(tmp_path, code):
    """The port's file loads bitwise with ``safetensors.torch`` (and
    ``safetensors.numpy`` where numpy has the dtype) and carries its
    metadata; with one metadata entry it is byte for byte the package's file
    of the same tensors (the package writes several entries in a hash
    map's order)."""
    tensors = _tensors(code)
    path, ref = str(tmp_path / "port.safetensors"), str(tmp_path / "package.safetensors")
    safetensors_io.save_file(tensors, path, metadata=METADATA)
    _assert_same(safetensors.torch.load_file(path), tensors)
    if code != "BF16":
        _assert_same({k: torch.from_numpy(v) for k, v in
                      safetensors.numpy.load_file(path).items()}, tensors)
    with safetensors.safe_open(path, framework="pt") as f:
        assert f.metadata() == METADATA
    for metadata in ({"format": "pt"}, None):
        safetensors_io.save_file(tensors, path, metadata=metadata)
        safetensors.torch.save_file(tensors, ref, metadata=metadata)
        with open(path, "rb") as a, open(ref, "rb") as b:
            assert a.read() == b.read(), metadata


@pytest.mark.parametrize("code", list(DTYPES))
def test_package_safetensors_read_by_the_port(tmp_path, code):
    """The package's files (``safetensors.torch``; ``safetensors.numpy`` for
    the numpy dtypes) load bitwise with the port's reader, metadata
    included; numpy arrays written by the port read back the same."""
    tensors = _tensors(code, seed=1)
    path = str(tmp_path / "t.safetensors")
    safetensors.torch.save_file(tensors, path, metadata=METADATA)
    _assert_same(safetensors_io.load_file(path), tensors)
    assert safetensors_io.read_header(path)[0]["__metadata__"] == METADATA
    if code != "BF16":
        arrays = {k: v.numpy() for k, v in tensors.items()}
        safetensors.numpy.save_file(arrays, path)
        _assert_same(safetensors_io.load_file(path), tensors)
        safetensors_io.save_file(arrays, path)
        _assert_same(safetensors_io.load_file(path), tensors)


@pytest.mark.parametrize("cut", ["length", "header", "data"])
def test_truncated_safetensors_raise(tmp_path, cut):
    path = str(tmp_path / "t.safetensors")
    safetensors.torch.save_file(_tensors("F32"), path)
    with open(path, "rb") as f:
        raw = f.read()
    n = int.from_bytes(raw[:8], "little")
    keep = {"length": 5, "header": 8 + n // 2, "data": len(raw) - 3}[cut]
    with open(path, "wb") as f:
        f.write(raw[:keep])
    with pytest.raises(ValueError, match="truncated|too short"):
        safetensors_io.load_file(path)


def test_unknown_safetensors_dtype_raises(tmp_path):
    path = str(tmp_path / "t.safetensors")
    safetensors.torch.save_file({"x": torch.zeros(3, dtype=torch.float64)}, path)
    with pytest.raises(ValueError, match="F64"):
        safetensors_io.load_file(path)
    with pytest.raises(ValueError, match="float64"):
        safetensors_io.save_file({"x": torch.zeros(3, dtype=torch.float64)}, path)


# ── peft interchange ─────────────────────────────────────────────────────


@pytest.fixture(scope="module")
def jax_lora():
    """The tiny JAX SD3's LoRA (rank 4, alpha 8; non-zero B) as numpy."""
    jpipe = jax_tiny_pipeline(3)
    return jpipe, {k: np.asarray(v) for k, v in
                   j_lora_params(jpipe.transformer_params["params"]).items()}


def test_jax_adapter_reads_in_the_port_bitwise(tmp_path, jax_lora):
    _, flat = jax_lora
    out = str(tmp_path / "jax_adapter")
    j_peft.export_peft_lora(out, flat, rank=4, alpha=8.0)
    got, cfg = t_peft.import_peft_lora(out)
    want, want_cfg = j_peft.import_peft_lora(out)
    assert cfg == want_cfg and set(got) == set(want) == set(flat)
    for k in flat:
        assert got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], want[k])
        np.testing.assert_array_equal(got[k], flat[k])


def test_port_adapter_reads_in_the_jax_package_bitwise(tmp_path, jax_lora):
    """The port model's LoRA parameters (carried from the JAX tree) exported
    by the port: the JAX ``import_peft_lora`` and ``load_lora_only`` read
    them bitwise, and the directory is byte for byte the JAX export's."""
    jpipe, flat = jax_lora
    lora = t_lora_params(_port_pipeline(jpipe).mmdit)
    out, ref = str(tmp_path / "port"), str(tmp_path / "jax")
    t_peft.export_peft_lora(out, lora, rank=4, alpha=8.0)
    j_peft.export_peft_lora(ref, flat, rank=4, alpha=8.0)
    got, _ = j_peft.import_peft_lora(out)
    via_ckpt = j_ckpt.load_lora_only(out, expect_rank=4, expect_alpha=8.0)
    assert set(got) == set(lora) == set(via_ckpt)
    for k, p in lora.items():
        np.testing.assert_array_equal(got[k], p.detach().numpy())
        np.testing.assert_array_equal(via_ckpt[k], p.detach().numpy())
    for name in ("adapter_model.safetensors", "adapter_config.json"):
        with open(os.path.join(out, name), "rb") as a, open(os.path.join(ref, name), "rb") as b:
            assert a.read() == b.read(), name


def test_port_adapter_loads_into_real_peft(tmp_path, peft_setup):  # noqa: F811
    """The reference's own peft adapter (``save_pretrained`` of the torch SD3
    mirror) read by the port into the port's MMDiT, exported again by the
    port and loaded with ``PeftModel.from_pretrained``: peft's forward equals
    the port's, 3e-4 as tests/test_peft_lora.py holds the JAX export."""
    from peft import PeftModel

    jcfg, mirror, base_sd, _, adapter_dir = peft_setup
    flat, acfg = t_peft.import_peft_lora(adapter_dir)
    assert acfg["r"] == R and float(acfg["lora_alpha"]) == ALPHA
    jcfg_l, params = _flax_with_adapter(jcfg, base_sd, flat)
    names = {f.name for f in dataclasses.fields(TMMDiTConfig)} - {"dtype"}
    tcfg = TMMDiTConfig(**{n: getattr(jcfg_l, n) for n in names}, dtype=torch.float32)
    model = TMMDiT(tcfg).eval()
    model.load_state_dict(mmdit_state_dict_from_jax(jax.device_get(params), tcfg))
    lora = t_lora_params(model)
    assert set(lora) == set(flat)
    for k, p in lora.items():
        np.testing.assert_array_equal(p.detach().numpy(), flat[k])
    out = str(tmp_path / "exported")
    t_peft.export_peft_lora(out, lora, rank=R, alpha=ALPHA)
    pm = PeftModel.from_pretrained(copy.deepcopy(mirror), out)
    inputs = [torch.tensor(a) for a in _inputs(jcfg, seed=5)]
    with torch.no_grad():
        want = pm(*inputs).numpy()
        got = model(*inputs).numpy()
    np.testing.assert_allclose(got, want, atol=3e-4, rtol=3e-4)


def _tiny_lora(family):
    g = torch.Generator().manual_seed(0)
    model = {"mmdit": lambda: TMMDiT(TMMDiTConfig.tiny(lora_rank=4)),
             "flux": lambda: FluxTransformer(FluxConfig.tiny(lora_rank=4)),
             "wan": lambda: WanTransformer(WanConfig.tiny(lora_rank=4))}[family]()
    init_params_(model, g)
    lora = t_lora_params(model)
    with torch.no_grad():  # B starts at zero: draw it, so the layout shows
        for k, p in lora.items():
            p.normal_(0.0, 0.1, generator=g)
    return lora


@pytest.mark.parametrize("family", ["mmdit", "flux", "wan"])
def test_every_lora_path_round_trips(tmp_path, family):
    """Every LoRA path of the tiny model through the port's export: the port's
    import and the JAX import give the parameters back bitwise."""
    lora = _tiny_lora(family)
    out = str(tmp_path / family)
    t_peft.export_peft_lora(out, lora, rank=4, alpha=8.0)
    for got in (t_peft.import_peft_lora(out)[0], j_peft.import_peft_lora(out)[0]):
        assert set(got) == set(lora)
        for k, p in lora.items():
            np.testing.assert_array_equal(got[k], p.detach().numpy(), err_msg=k)


def test_rank_and_alpha_mismatches_raise(tmp_path):
    out = str(tmp_path / "a")
    t_peft.export_peft_lora(out, _tiny_lora("mmdit"), rank=4, alpha=8.0)
    _, cfg = t_peft.import_peft_lora(out)
    with pytest.raises(ValueError, match="lora_rank"):
        t_peft.validate_against_model(cfg, lora_rank=32)
    with pytest.raises(ValueError, match="lora_alpha"):
        t_peft.validate_against_model(cfg, lora_rank=4, lora_alpha=64.0)
    t_peft.validate_against_model(cfg, lora_rank=4, lora_alpha=8.0)
    with pytest.raises(ValueError, match="lora_rank"):
        t_ckpt.load_lora_only(out, expect_rank=32)
    cfg["r"] = 8  # the file's factors are rank 4
    with open(os.path.join(out, "adapter_config.json"), "w") as f:
        json.dump(cfg, f)
    with pytest.raises(ValueError, match="r=8"):
        t_peft.import_peft_lora(out)


# ── resume from a JAX checkpoint ─────────────────────────────────────────

SCFG = dict(num_steps=4, train_num_steps=2, noise_level=0.8, guidance_scale=4.5)


def _old_log_probs(tpipe, rec, neg_e, neg_p, seed):
    """The replay's log-probs under the pipeline's current weights, moved by ~1e-3
    around the 1e-3 clip range so both branches of the clip are live."""
    num_mini = rec["latents"].shape[0]
    with torch.no_grad():
        lp = torch.stack([torch.stack([t_sampler.compute_log_prob(
            tpipe.velocity_fn(), _t(rec["latents"][i, :, j]), _t(rec["latents"][i, :, j + 1]),
            _t(rec["timesteps"][i, :, j]), _t(rec["sigmas"][i, :, j]),
            _t(rec["sigmas_prev"][i, :, j]), _t(rec["embeds"][i]), _t(rec["pooled"][i]),
            _t(neg_e), _t(neg_p), t_sampler.SamplerConfig(**SCFG))[0]
            for j in range(2)], dim=1) for i in range(num_mini)])
    rng = np.random.default_rng(seed)
    return (lp.numpy() + rng.standard_normal(lp.shape) * 1e-3).astype(np.float32)


@pytest.mark.parametrize("grad_accum,num_mini", [(1, 2), (2, 3)],
                         ids=["accumulation2", "accumulation4_pending"])
def test_resume_from_a_jax_checkpoint_matches_jax(tmp_path, grad_accum, num_mini):
    """One JAX epoch (``make_train_epoch_fn``), its state saved with the JAX
    ``save_state`` (orbax) and read back by its ``restore_state``; the numpy
    payload goes into a fresh port state through
    ``generator_state_from_jax``, bitwise. A second epoch on each side then
    agrees (its old log-probs the replay under the carried policy, moved by
    ~1e-3, as in test_train_epoch_matches_jax): the diagnostics within 1e-4 relative, LoRA and EMA within 1e-4
    relative + 2e-6 absolute (test_train_epoch_matches_jax's bounds). EMA
    every step. Accumulation 2 over 4 microbatches saves an empty
    accumulator; accumulation 4 over 6 saves one holding 2 microbatches, so
    the optax MultiSteps accumulator and its position carry over too."""
    jpipe = jax_tiny_pipeline(13)
    tpipe = _port_pipeline(jpipe)
    cfg = _train_cfg(gradient_accumulation_steps=grad_accum, ema=True, ema_interval=1,
                     clip_range=1e-3)
    recs = [_window_record(seed, num_mini=num_mini)[0] for seed in (4, 5)]
    _, neg_e, neg_p = _window_record(4, num_mini=num_mini)
    recs[0]["log_probs"] = _old_log_probs(tpipe, recs[0], neg_e, neg_p, 4)

    jlora0 = j_lora_params(jpipe.transformer_params["params"])
    jfn = j_trainer.make_train_epoch_fn(jpipe, j_sampler.SamplerConfig(**SCFG), cfg)
    jrun = lambda st, rec: jfn(st, jpipe.transformer_params,  # noqa: E731
                               {k: jnp.asarray(v) for k, v in rec.items()},
                               jnp.asarray(neg_e), jnp.asarray(neg_p))
    jst, _ = jrun(j_state.create_generator_state(jlora0, cfg, 2), recs[0])
    j_ckpt.save_state(str(tmp_path), int(jst.global_step), jst)
    path = j_ckpt.latest_checkpoint(str(tmp_path))
    jres = j_ckpt.restore_state(path, j_state.create_generator_state(jlora0, cfg, 2))
    payload = jax.device_get({"lora": jres.lora, "opt_state": jres.opt_state,
                              "ema": jres.ema.params, "global_step": jres.global_step,
                              "micro_step": jres.micro_step})

    tst = t_state.create_generator_state(freeze_non_lora(tpipe.mmdit), cfg, 2)
    t_ckpt.generator_state_from_jax(payload, tst)
    multi = payload["opt_state"]
    adam = multi.inner_opt_state[1][0]  # MultiSteps(chain(clip, adamw)): adamw's Adam
    pending = int(multi.mini_step)
    assert (tst.global_step, tst.micro_step, tst.count) == (
        int(jst.global_step), int(jst.micro_step), int(adam.count)) == (
        num_mini * 2 // (2 * grad_accum), num_mini * 2, num_mini * 2 // (2 * grad_accum))
    assert pending == (2 if grad_accum == 2 else 0)
    for name, want in (("lora", payload["lora"]), ("mu", adam.mu), ("nu", adam.nu),
                       ("acc", multi.acc_grads), ("ema", payload["ema"])):
        got = getattr(tst, name)
        for k, v in want.items():
            np.testing.assert_array_equal(got[k].detach().numpy(), np.asarray(v),
                                          err_msg=f"{name} {k}")
    assert any(np.abs(np.asarray(v)).max() > 0 for v in adam.nu.values())
    assert (pending > 0) == any(np.abs(np.asarray(v)).max() > 0
                                for v in multi.acc_grads.values())

    # the second epoch's samples come from the resumed policy, as a run's do
    recs[1]["log_probs"] = _old_log_probs(tpipe, recs[1], neg_e, neg_p, 5)
    jst2, jinfo = jrun(jres, recs[1])
    tfn = t_trainer.make_train_epoch_fn(tpipe, t_sampler.SamplerConfig(**SCFG), cfg)
    tst, tinfo = tfn(tst, {k: _t(v) for k, v in recs[1].items()}, _t(neg_e), _t(neg_p))
    assert (tst.global_step, tst.micro_step) == (int(jst2.global_step), int(jst2.micro_step))
    for k in ("loss", "policy_loss", "approx_kl", "clipfrac"):
        np.testing.assert_allclose(tinfo[k], float(jinfo[k]), rtol=1e-4, atol=1e-9, err_msg=k)
    for k, p in tst.lora.items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jst2.lora[k]),
                                   rtol=1e-4, atol=2e-6, err_msg=k)
        np.testing.assert_allclose(tst.ema[k].numpy(), np.asarray(jst2.ema.params[k]),
                                   rtol=1e-4, atol=2e-6, err_msg=k)


# ── the trainer's checkpoints ────────────────────────────────────────────


def _smoke_config(save_dir, *overrides):
    return apply_overrides(resolve_config("smoke_sd3_fast"), [
        "sample.train_batch_size=2", f"save_dir={save_dir}", "train.ema_interval=1",
        *overrides])


def _build(cfg):
    return t_train.build_trainer(copy.deepcopy(cfg), latent_hw=8, device="cpu")


def _state_tensors(trainer):
    st = trainer.state
    out = {f"{g}/{k}": v.detach().clone() for g in ("lora", "acc", "mu", "nu", "ema")
           for k, v in getattr(st, g).items()}
    return out, (st.count, st.global_step, st.micro_step)


def _assert_state_equal(a, b):
    (ta, ca), (tb, cb) = a, b
    assert ca == cb and set(ta) == set(tb)
    for k, v in ta.items():
        assert torch.equal(v, tb[k]), k


def test_save_then_restore_is_bitwise(tmp_path):
    """Two epochs at accumulation 6 (8 microsteps: one optimizer step, 2
    microsteps pending): every state tensor is non-trivial. ``save`` writes
    ``state.pt`` and the peft ``lora/`` (the EMA weights), no ``extra.pt``
    without a discriminator; a fresh trainer's ``restore`` gives every
    tensor and counter back bitwise, the LoRA into the model's own
    parameters."""
    cfg = _smoke_config(tmp_path, "train.gradient_accumulation_steps=3")
    a = _build(cfg)
    a.run(max_epochs=2)
    assert (a.state.count, a.state.global_step, a.state.micro_step) == (1, 1, 8)
    want = _state_tensors(a)
    for group in ("acc/", "mu/", "nu/", "ema/"):
        assert any(bool(v.any()) for k, v in want[0].items() if k.startswith(group)), group
    path = a.save()
    assert path == os.path.join(str(tmp_path), "checkpoints", "checkpoint-1")
    assert sorted(os.listdir(path)) == ["lora", "state.pt"]
    assert sorted(os.listdir(os.path.join(path, "lora"))) == [
        "adapter_config.json", "adapter_model.safetensors"]
    adapter = t_ckpt.load_lora_only(os.path.join(path, "lora"), expect_rank=32,
                                    expect_alpha=64.0)
    for k, e in a.state.ema.items():
        np.testing.assert_array_equal(adapter[k], e.numpy())

    b = _build(cfg)
    assert not all(torch.equal(m, a.state.mu[k]) for k, m in b.state.mu.items())
    params = dict(b.state.lora)
    b.restore(path)
    _assert_state_equal(_state_tensors(b), want)
    assert all(b.state.lora[k] is p for k, p in params.items())
    assert all(p is q for p, q in zip(t_lora_params(b.pipeline.transformer).values(),
                                      b.state.lora.values()))


def test_checkpoints_order_and_prune_by_number(tmp_path):
    """Saves at global steps 2, 10 and 9 with ``num_checkpoint_limit`` 2:
    ``latest_checkpoint`` orders by number (10 after 9, not after 2), and
    pruning keeps the newest two."""
    trainer = _build(_smoke_config(tmp_path, "num_checkpoint_limit=2"))
    assert t_ckpt.latest_checkpoint(str(tmp_path)) is None
    for step in (2, 10, 9):
        trainer.state.global_step = step
        trainer.save()
    root = os.path.join(str(tmp_path), "checkpoints")
    assert sorted(os.listdir(root)) == ["checkpoint-10", "checkpoint-9"]
    assert t_ckpt.latest_checkpoint(str(tmp_path)) == os.path.join(root, "checkpoint-10")


def test_warm_start_lora_reseeds_the_ema_and_keeps_a_fresh_optimizer(tmp_path):
    cfg = _smoke_config(tmp_path)
    a = _build(cfg)
    a.run(max_epochs=1)
    trained = {k: p.detach().clone() for k, p in a.state.lora.items()}
    lora_dir = t_ckpt.save_lora_only(str(tmp_path), 7, a.state.lora, rank=32, alpha=64.0)

    fresh = _build(cfg)
    assert any(not torch.equal(p, trained[k]) for k, p in fresh.state.lora.items())
    fresh.warm_start_lora(lora_dir)
    for k, v in trained.items():
        assert torch.equal(fresh.state.lora[k].detach(), v), k
        assert torch.equal(fresh.state.ema[k], v), k
        assert not fresh.state.mu[k].any() and not fresh.state.nu[k].any()
    assert (fresh.state.count, fresh.state.global_step, fresh.state.micro_step) == (0, 0, 0)
    fresh.run(max_epochs=1)  # a warm-started trainer trains
    assert fresh.state.global_step >= 1


@pytest.mark.parametrize("bad", ["shape", "keys", "orbax"])
def test_warm_start_lora_refuses_a_mismatch(tmp_path, bad):
    trainer = _build(_smoke_config(tmp_path))
    lora = {k: p.detach().numpy() for k, p in trainer.state.lora.items()}
    if bad == "shape":  # the rank agrees, the widths do not
        lora = {k: np.zeros((v.shape[0] + (k.endswith("lora_a")),
                             v.shape[1] + (k.endswith("lora_b"))), np.float32)
                for k, v in lora.items()}
    elif bad == "keys":
        lora.pop(sorted(lora)[0])
    path = str(tmp_path / "adapter")
    if bad == "orbax":  # the JAX package's checkpoint-N/lora: no safetensors
        os.makedirs(os.path.join(path, "d"))
        open(os.path.join(path, "_METADATA"), "w").close()
    else:
        t_peft.export_peft_lora(path, lora, rank=32, alpha=64.0)
    match = {"shape": "shape", "keys": "does not match", "orbax": "export_peft_lora"}[bad]
    before = {k: p.detach().clone() for k, p in trainer.state.lora.items()}
    with pytest.raises(ValueError, match=match):
        trainer.warm_start_lora(path)
    assert all(torch.equal(p, before[k]) for k, p in trainer.state.lora.items())


def _pickscore_trainer(tmp_path):
    prompts = TextPromptDataset("dataset/pickscore_small").prompts
    cfg = tiny_config(train_d=True, dataset="dataset/pickscore_small",
                      json_path=_refs(tmp_path, prompts), reference_image_path=str(tmp_path),
                      d_lr=1e-3, save_dir=str(tmp_path / "run"))
    return t_train.build_trainer(cfg, latent_hw=8, device="cpu")


def _d_state(trainer):
    d = trainer.disc
    opt = d.opt_state.state_dict()
    return ({k: v.clone() for k, v in d.params.state_dict().items()},
            {(i, k): v.clone() for i, s in opt["state"].items() for k, v in s.items()},
            opt["param_groups"])


@pytest.mark.parametrize("kind", ["pickscore", "dino_patch"])
def test_discriminator_state_round_trips(tmp_path, kind):
    """A real D-epoch moves the discriminator (the PickScore CLIP tail, a DINO
    head) and its Adam state; ``save`` writes them to ``extra.pt``; a fresh
    trainer's ``restore`` loads both bitwise into its live module, so the
    co-trained reward scores as the saved one did, while the frozen reward
    ('pickscore' of the built tail, 'image_similarity' of the backbone)
    stays bitwise that of a fresh build."""
    def build():
        if kind == "pickscore":
            return _pickscore_trainer(tmp_path)
        return _dino_trainer(tmp_path, "dino_cotrain_sd3_patch_fast", d_lr=1e-3,
                             save_dir=str(tmp_path / "run"))

    images = np.random.default_rng(3).uniform(-1, 1, (4, 3, 28, 28)).astype(np.float32)
    refs = np.random.default_rng(4).uniform(-1, 1, (4, 1, 3, 28, 28)).astype(np.float32)
    live, frozen = (("pickscore_cotrain", "pickscore") if kind == "pickscore"
                    else ("dino_patch_cotrain", "image_similarity"))

    def scores(trainer):
        ctx = trainer.reward_ctx
        if ctx.rng is not None:  # the patch draws of dino_patch_cotrain
            ctx.rng.manual_seed(0)
        return (multi_score({live: 1.0}, ctx)(images, ["a"] * 4)[0]["avg"],
                multi_score({frozen: 1.0}, ctx)(images, ["a"] * 4, ref_images=refs)[0]["avg"])

    a = build()
    a.d_phase(a.sample_phase(0))
    want, live_a = _d_state(a), scores(a)[0]
    path = a.save()
    assert sorted(os.listdir(path)) == ["extra.pt", "lora", "state.pt"]

    b = build()
    live_b, frozen_b = scores(b)
    assert not np.array_equal(live_b, live_a)
    module = b.disc.params
    b.restore(path)
    got = _d_state(b)
    assert b.disc.params is module and set(got[0]) == set(want[0]) and got[2] == want[2]
    for k, v in want[0].items():
        assert torch.equal(got[0][k], v), k
    assert set(got[1]) == set(want[1])
    for k, v in want[1].items():
        assert torch.equal(got[1][k], v), k
    live_r, frozen_r = scores(b)
    np.testing.assert_array_equal(live_r, live_a)
    np.testing.assert_array_equal(frozen_r, frozen_b)
    if kind == "pickscore":
        assert b.reward_ctx.pickscore_params is module


def test_resumed_epoch_is_the_original_run_with_its_epoch_set_back(tmp_path):
    """``dino_cotrain_sd3_fast`` at d_times 2 (a D-epoch, then a G epoch):
    trainer A runs epoch 0 and saves; B is built fresh and restores the
    checkpoint. Neither package saves the epoch counter (a resumed run starts
    again at epoch 0's prompt slots, noise, D-step patch draws and gate), the
    stat tracker or the reward generators, so the test holds them equal by
    hand: A's epoch is set back to 0; the tracker needs nothing (every
    epoch's advantages clear it); the CLS preset's reward draws from no
    generator (the patch preset's ``RewardContext.rng`` would need A's state
    at the save, and its draws' order across the reward threads is not
    fixed). Then two more epochs of each, a D-epoch and a G epoch: every
    generator tensor, counter and D tensor is bitwise equal."""
    def build():
        return _dino_trainer(tmp_path, "dino_cotrain_sd3_fast", d_times=2, d_lr=1e-3,
                             save_dir=str(tmp_path / "run"))

    a = build()
    a.run(max_epochs=1)
    path = a.save()
    b = build()
    # nothing drew from A's generator in its epoch: it is still the fresh one
    assert b.disc.kind == "dino" and torch.equal(a.reward_ctx.rng.get_state(),
                                                 b.reward_ctx.rng.get_state())
    b.restore(path)
    a.epoch = 0
    for trainer in (a, b):
        trainer.run(max_epochs=2)
    assert a.epoch == b.epoch == 2 and a.state.global_step > 1
    _assert_state_equal(_state_tensors(b), _state_tensors(a))
    da, db = _d_state(a), _d_state(b)
    for i in (0, 1):
        assert set(da[i]) == set(db[i])
        for k, v in da[i].items():
            assert torch.equal(db[i][k], v), k
