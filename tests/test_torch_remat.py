"""Per-block activation checkpointing (``models/remat.py``) on the CPU.

The JAX models remat every block (``nn.remat``; the MMDiT with a policy);
the port checkpoints each block with non-reentrant ``torch.utils.checkpoint``
in a training forward. Held here, on the tiny configs in fp32: the LoRA
gradients of the GRPO loss of one replayed window step with remat equal the
port's own without it bit for bit (the recompute runs the same CPU ops on
the same inputs) and match ``jax.grad`` of the JAX model with ``remat=True``
(the MMDiT at both ported policies; 2e-3 relative to each gradient's
largest element, the bound of tests/test_torch_flux_train.py and
tests/test_torch_wan_train.py); with remat, at either policy, the attention
forwards run twice per block and microstep (the recompute runs the whole
block), once without; a ``no_grad`` forward checkpoints nothing and is
unchanged; the policy names raise as the JAX table does, the v5e tiers by
name; remat is off by default, the port's departure from JAX.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adv_grpo_torch.core import grpo as t_grpo
from adv_grpo_torch.models import remat as t_remat
from adv_grpo_torch.models.lora import freeze_non_lora
from adv_grpo_torch.models.mmdit import MMDiT as TMMDiT
from adv_grpo_torch.models.mmdit import MMDiTConfig as TMMDiTConfig
from adv_grpo_torch.ops import attention as t_attention
from adv_grpo_torch.ops import joint_attention as t_joint
from adv_grpo_torch.rollout import flux as t_flux_rollout
from adv_grpo_torch.rollout import sampler as t_sampler
from adv_grpo_torch.rollout import wan as t_wan_rollout
from adv_grpo_tpu.core import grpo as j_grpo
from adv_grpo_tpu.models.flux import FluxTransformer as JFluxTransformer
from adv_grpo_tpu.models.lora import lora_params as j_lora_params
from adv_grpo_tpu.models.lora import merge_lora_params as j_merge_lora_params
from adv_grpo_tpu.models.mmdit import MMDiT as JMMDiT
from adv_grpo_tpu.models.mmdit import MMDiTConfig as JMMDiTConfig
from adv_grpo_tpu.models.wan import WanTransformer as JWanTransformer
from adv_grpo_tpu.rollout import flux as j_flux_rollout
from adv_grpo_tpu.rollout import sampler as j_sampler
from adv_grpo_tpu.rollout import wan as j_wan_rollout
from tests import test_torch_flux_train as flux_train
from tests import test_torch_wan_train as wan_train
from tests.test_torch_models import jax_tiny_pipeline
from tests.test_torch_train import _port_pipeline
from tests.test_torch_train import _window_record as sd3_window_record

KW = dict(clip_range=1e-3, adv_clip_max=5.0)
# (family, the MMDiT's policy): each case's port model checkpoints as the
# JAX model it is held to
CASES = [("sd3", "full"), ("sd3", "save_attn"), ("flux", None), ("wan", None)]


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _sd3(policy):
    """(port model, its log-prob of the microbatch, the JAX model's log-prob
    of params, the JAX params, the advantages): the tiny SD3 (4 blocks, dual
    attention in blocks 0 and 1, block 3 context_pre_only), CFG 4.5."""
    jpipe = jax_tiny_pipeline(11)
    jcfg = dataclasses.replace(jpipe.mmdit_cfg, remat=True, remat_policy=policy,
                               attention_backend="reference")
    jpipe = dataclasses.replace(jpipe, mmdit_cfg=jcfg, mmdit=JMMDiT(jcfg))
    tpipe = _port_pipeline(jpipe)
    rec, neg_e, neg_p = sd3_window_record(3, num_mini=1)
    mb = [rec["latents"][0, :, 0], rec["latents"][0, :, 1], rec["timesteps"][0, :, 0],
          rec["sigmas"][0, :, 0], rec["sigmas_prev"][0, :, 0], rec["embeds"][0],
          rec["pooled"][0], neg_e, neg_p]
    scfg = dict(num_steps=4, train_num_steps=2, noise_level=0.8, guidance_scale=4.5)

    def t_lp():
        return t_sampler.compute_log_prob(tpipe.velocity_fn(), *map(_t, mb),
                                          t_sampler.SamplerConfig(**scfg))[0]

    def j_lp(params):
        return j_sampler.compute_log_prob(jpipe.velocity_fn(params), *map(jnp.asarray, mb),
                                          j_sampler.SamplerConfig(**scfg))[0]

    return tpipe.mmdit, t_lp, j_lp, jpipe.transformer_params, rec["advantages"][0]


def _flux():
    jpipe, tpipe, s_txt = flux_train._pipes("tiny", 7)
    jcfg = dataclasses.replace(jpipe.flux_cfg, remat=True)
    jpipe = dataclasses.replace(jpipe, flux_cfg=jcfg, transformer=JFluxTransformer(jcfg))
    rec = flux_train._window_record(tpipe.flux_cfg, s_txt, 8, num_mini=1, grid=4)
    mb = [rec["latents"][0, :, 0], rec["latents"][0, :, 1], rec["timesteps"][0, :, 0],
          rec["sigmas"][0, :, 0], rec["sigmas_prev"][0, :, 0], rec["embeds"][0],
          rec["pooled"][0]]
    scfg = dict(num_steps=4, train_num_steps=2, noise_level=0.7, guidance_scale=1.0)

    def t_lp():
        return t_flux_rollout.compute_flux_log_prob(tpipe.velocity_fn(), *map(_t, mb), None,
                                                    None, t_sampler.SamplerConfig(**scfg))[0]

    def j_lp(params):
        return j_flux_rollout.compute_flux_log_prob(
            jpipe.velocity_fn(params), *map(jnp.asarray, mb), None, None,
            j_sampler.SamplerConfig(**scfg))[0]

    return tpipe.transformer, t_lp, j_lp, jpipe.transformer_params, rec["advantages"][0]


def _wan():
    jpipe, tpipe, s_txt = wan_train._pipes("tiny", 7)
    jcfg = dataclasses.replace(jpipe.wan_cfg, remat=True)
    jpipe = dataclasses.replace(jpipe, wan_cfg=jcfg, transformer=JWanTransformer(jcfg))
    rec = wan_train._window_record(tpipe.wan_cfg, s_txt, 8, num_mini=1)
    mb = [rec["latents"][0, :, 0], rec["latents"][0, :, 1], rec["timesteps"][0, :, 0],
          rec["sigmas"][0, :, 0], rec["sigmas_prev"][0, :, 0], rec["embeds"][0],
          rec["pooled"][0]]
    t_fn = t_wan_rollout.make_wan_log_prob_fn(t_wan_rollout.WanSamplerConfig(num_steps=4))
    j_fn = j_wan_rollout.make_wan_log_prob_fn(j_wan_rollout.WanSamplerConfig(num_steps=4))

    def t_lp():
        return t_fn(tpipe.velocity_fn(), *map(_t, mb), None, None, None)[0]

    def j_lp(params):
        return j_fn(jpipe.velocity_fn(params), *map(jnp.asarray, mb), None, None, None)[0]

    return tpipe.transformer, t_lp, j_lp, jpipe.transformer_params, rec["advantages"][0]


def _case(family, policy):
    return {"sd3": lambda: _sd3(policy), "flux": _flux, "wan": _wan}[family]()


def _set_remat(model, remat, policy):
    kw = dict(remat=remat) if policy is None else dict(remat=remat, remat_policy=policy)
    model.cfg = dataclasses.replace(model.cfg, **kw)


def _port_grads(model, t_lp, old, adv, remat, policy):
    """LoRA gradients of the GRPO loss of one microstep, remat on or off."""
    _set_remat(model, remat, policy)
    lora = freeze_non_lora(model)
    loss = t_grpo.grpo_loss(t_lp(), _t(old), _t(adv), **KW).loss
    return dict(zip(lora, torch.autograd.grad(loss, list(lora.values()))))


@pytest.mark.parametrize("family,policy", CASES)
def test_remat_grads_equal_the_plain_ones_and_match_jax_remat(family, policy):
    """With remat the LoRA gradients equal those without, bit for bit, and
    match ``jax.grad`` of the JAX model built with ``remat=True`` (and the
    policy)."""
    model, t_lp, j_lp, frozen, adv = _case(family, policy)
    with torch.no_grad():
        old = (t_lp().numpy() + 1e-4).astype(np.float32)
    plain = _port_grads(model, t_lp, old, adv, False, policy)
    got = _port_grads(model, t_lp, old, adv, True, policy)
    assert set(got) == set(plain)
    for k in plain:
        torch.testing.assert_close(got[k], plain[k], rtol=0, atol=0, msg=k)

    def jloss(lora_flat):
        params = {**frozen, "params": j_merge_lora_params(frozen["params"], lora_flat)}
        return j_grpo.grpo_loss(j_lp(params), jnp.asarray(old), jnp.asarray(adv), **KW).loss

    want = jax.jit(jax.grad(jloss))(j_lora_params(frozen["params"]))
    assert set(got) == set(want)
    for k, w in want.items():
        w = np.asarray(w)
        tol = 2e-3 * max(float(np.abs(w).max()), 1e-12)
        np.testing.assert_allclose(got[k].numpy(), w, rtol=0, atol=tol, err_msg=k)
    assert any(np.abs(np.asarray(w)).max() > 0 for k, w in want.items() if k.endswith("a"))


def _counting(monkeypatch, module, name, counts):
    fn = getattr(module, name)

    def counted(*a, **k):
        counts[name] = counts.get(name, 0) + 1
        return fn(*a, **k)

    monkeypatch.setattr(module, name, counted)


@pytest.mark.parametrize("family,policy,remat", [
    ("sd3", "save_attn", False), ("sd3", "save_attn", True), ("sd3", "full", True),
    ("flux", None, True), ("wan", None, True)])
def test_attention_forwards_per_microstep(monkeypatch, family, policy, remat):
    """The attention forwards of one microstep (forward and backward), on the
    plain path: once per block without remat, twice with it at either
    policy (``save_attn`` recomputes the whole block as ``full`` does); each
    block is checkpointed once."""
    model, t_lp, _, _, adv = _case(family, policy)
    with torch.no_grad():
        old = (t_lp().numpy() + 1e-4).astype(np.float32)
    counts = {}
    for module, name in ((t_joint, "joint_attention_fwd"), (t_joint, "mha_rms_fwd"),
                         (t_attention, "mha_bshd_fwd"), (t_remat, "checkpoint")):
        _counting(monkeypatch, module, name, counts)
    _port_grads(model, t_lp, old, adv, remat, policy)
    c = model.cfg
    twice = 2 if remat else 1
    if family == "sd3":
        # CFG 4.5: one forward over the [cond ; uncond] batch
        want = {"joint_attention_fwd": c.num_layers * twice,
                "mha_rms_fwd": len(c.dual_attention_layers) * twice}
        blocks = c.num_layers
    elif family == "flux":
        want = {"joint_attention_fwd": c.num_double_layers * twice,
                "mha_bshd_fwd": c.num_single_layers * twice}
        blocks = c.num_double_layers + c.num_single_layers
    else:  # self- and cross-attention in every block
        want = {"mha_bshd_fwd": 2 * c.num_layers * twice}
        blocks = c.num_layers
    if remat:
        want["checkpoint"] = blocks
    assert counts == want


@pytest.mark.parametrize("family,policy", CASES)
def test_no_grad_forward_is_unchanged_and_checkpoints_nothing(monkeypatch, family, policy):
    """Rollouts, eval and the LoRA-off reference replay run under
    ``no_grad``: with remat set, the forward is the plain one bit for bit and
    no block is checkpointed."""
    model, t_lp, _, _, _ = _case(family, policy)
    counts = {}
    _counting(monkeypatch, t_remat, "checkpoint", counts)
    outs = []
    for remat in (False, True):
        _set_remat(model, remat, policy)
        with torch.no_grad():
            outs.append(t_lp())
    torch.testing.assert_close(outs[1], outs[0], rtol=0, atol=0)
    assert counts == {}


def test_policy_names_raise_as_jax():
    """A name outside the JAX table raises the JAX ValueError, at
    construction with remat on (the JAX model at its first call); the three
    v5e tiers raise by name; with remat off the policy is not read."""
    bad = JMMDiTConfig.tiny(remat=True, remat_policy="save_everything")
    with pytest.raises(ValueError) as jerr:
        JMMDiT(bad).init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 8, 8)), jnp.zeros((1,)),
                         jnp.zeros((1, 6, 64)), jnp.zeros((1, 48)))
    with pytest.raises(ValueError) as terr:
        TMMDiT(TMMDiTConfig.tiny(remat=True, remat_policy="save_everything"))
    assert str(terr.value) == str(jerr.value)
    for tier in ("save_attn_ff", "save_attn_qkv", "save_big"):
        with pytest.raises(NotImplementedError, match=f"{tier}.*not ported"):
            TMMDiT(TMMDiTConfig.tiny(remat=True, remat_policy=tier))
    TMMDiT(TMMDiTConfig.tiny(remat=False, remat_policy="save_big"))
    assert set(t_remat.SAVED_NAMES) == {"full", "save_attn", "save_attn_ff", "save_attn_qkv",
                                        "save_big"}


def test_config_defaults_are_jaxs():
    """``remat_policy`` defaults as in the JAX configs (``save_attn``), and
    the tiny configs have remat off as JAX's do; ``remat`` itself is off in
    every port config, where the full-size JAX ones have it on (the port's
    recorded departure, as ``tpu.remat`` in ``config/base.py``)."""
    from adv_grpo_torch.models.flux import FluxConfig as TFluxConfig
    from adv_grpo_torch.models.wan import WanConfig as TWanConfig
    from adv_grpo_tpu.models.flux import FluxConfig as JFluxConfig
    from adv_grpo_tpu.models.wan import WanConfig as JWanConfig

    for t_cls, j_cls, full in ((TMMDiTConfig, JMMDiTConfig, "sd35_medium"),
                               (TFluxConfig, JFluxConfig, "dev"),
                               (TWanConfig, JWanConfig, "t2v_1_3b")):
        for ctor in (full, "tiny"):
            t, j = getattr(t_cls, ctor)(), getattr(j_cls, ctor)()
            assert not t.remat and j.remat == (ctor != "tiny")
            assert getattr(t, "remat_policy", None) == getattr(j, "remat_policy", None)
