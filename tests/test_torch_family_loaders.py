"""The port's Flux and WAN checkpoint loaders against the JAX package's, on
directories this file writes in the published diffusers layouts at tiny
widths (``chip_smoke.write_flux_dirs`` / ``write_wan_dirs``, which write the
card's directories too).

* The writers: ``chip_smoke.hf_flux_state_dict`` / ``hf_wan_state_dict`` /
  ``hf_wan_vae_state_dict`` of the port's models have the key sets and
  shapes of the diffusers-graph mirrors (tests/mirrors/), so a writer and a
  converter cannot agree on a wrong name.
* The converters: ``flux_state_dict_from_hf`` / ``wan_state_dict_from_hf`` /
  ``wan_vae_state_dict_from_hf`` fed a mirror's state dict equal the JAX
  ``convert_flux`` / ``convert_wan`` / ``convert_wan_vae`` trees carried
  across (``*_from_jax``) bitwise, and the forwards (Flux with and without
  guidance, non-square; WAN multi-frame, non-square; the WAN VAE's
  ``encode_raw``, ``encode`` and ``decode``) match the JAX modules and the
  mirrors within 1e-4 in fp32. A weight left over raises "not consumed", a
  missing one raises naming it.
* The loaders: ``load_flux_transformer`` / ``load_wan_transformer`` /
  ``load_wan_vae`` / ``load_vae`` from written directories (one file
  and sharded with an index, fp32 and bf16 files, fp32 and bf16 compute)
  equal the JAX loaders (``cast_tree_bf16``'s rounding, LoRA A) bitwise. The
  JAX reader cannot open a bf16 safetensors file (numpy has no bfloat16), so
  its side reads an fp32 copy of the same values. The JAX package has no
  ``convert.load_vae``, which its ``FluxPipeline.from_pretrained`` calls: the
  Flux VAE is held to ``convert_vae`` under ``VAEConfig.flux()``.
* The slice: ``cli.common.build_pipeline`` with ``FLUX_DIR`` / ``WAN_DIR``
  on the CPU, the pipelines' velocity and decode against JAX pipelines built
  from the same files, ``cli.infer`` and ``cli.wan_sde_demo`` from the
  directories, and the refusals.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from adv_grpo_torch.cli import common as t_common
from adv_grpo_torch.cli import infer as t_infer
from adv_grpo_torch.cli import wan_sde_demo as t_demo
from adv_grpo_torch.models import convert as t_convert
from adv_grpo_torch.models.flux import FluxConfig as TFluxConfig
from adv_grpo_torch.models.flux import FluxTransformer as TFluxTransformer
from adv_grpo_torch.models.vae import AutoencoderKL as TAutoencoderKL
from adv_grpo_torch.models.vae import VAEConfig as TVAEConfig
from adv_grpo_torch.models.wan import WanConfig as TWanConfig
from adv_grpo_torch.models.wan import WanTransformer as TWanTransformer
from adv_grpo_torch.models.wan_vae import WanVAEConfig as TWanVAEConfig
from adv_grpo_torch.models.wan_vae import WanVideoVAE as TWanVideoVAE
from adv_grpo_torch.train.flux_pipeline import FluxPipeline as TFluxPipeline
from adv_grpo_torch.train.wan_pipeline import WanPipeline as TWanPipeline
from adv_grpo_tpu.models import convert as j_convert
from adv_grpo_tpu.models.flux import FluxConfig as JFluxConfig
from adv_grpo_tpu.models.flux import FluxTransformer as JFluxTransformer
from adv_grpo_tpu.models.flux import make_latent_ids
from adv_grpo_tpu.models.vae import AutoencoderKL as JAutoencoderKL
from adv_grpo_tpu.models.vae import VAEConfig as JVAEConfig
from adv_grpo_tpu.models.wan import WanConfig as JWanConfig
from adv_grpo_tpu.models.wan import WanTransformer as JWanTransformer
from adv_grpo_tpu.models.wan_vae import WanVAEConfig as JWanVAEConfig
from adv_grpo_tpu.models.wan_vae import WanVideoVAE as JWanVideoVAE
from adv_grpo_tpu.train.flux_pipeline import FluxPipeline as JFluxPipeline
from adv_grpo_tpu.train.wan_pipeline import WanPipeline as JWanPipeline
from chip_smoke import (hf_flux_state_dict, hf_wan_state_dict, hf_wan_vae_state_dict,
                        write_flux_dirs, write_wan_dirs)
from tests.mirrors.flux_torch import FluxTransformerMirror
from tests.mirrors.sd3_torch import AutoencoderKLMirror
from tests.mirrors.wan_torch import WanTransformerMirror
from tests.mirrors.wan_vae_torch import AutoencoderKLWanMirror
from tests.test_mirror_parity import randomize

ATOL = RTOL = 1e-4
# the WAN VAE geometries of tests/test_mirror_parity_wan_vae.py, the second
# with attention blocks in both halves
WAN_VAE_KW = {"t3d": dict(),
              "mixed_attn": dict(dim_mult=(1, 2, 2), temperal_downsample=(False, True),
                                 attn_scales=(0.5, 1.0))}
STATS = dict(latents_mean=(0.1, -0.2, 0.0, 0.3), latents_std=(1.5, 0.5, 1.0, 2.0))
FLUX_VAE_KW = dict(block_out_channels=(32, 32), norm_num_groups=32, latent_channels=4)
WAN_MEAN = tuple(float(x) for x in np.linspace(-0.4, 0.5, 16))
WAN_STD = tuple(float(x) for x in np.linspace(0.6, 2.1, 16))


def _np(sd):
    return {k: v.detach().numpy() for k, v in sd.items()}


def _flat(tree):
    return traverse_util.flatten_dict(tree)


def _assert_same(got, want):
    """Two state dicts equal name for name, bitwise (values compared in fp32:
    a bf16 tensor widens exactly)."""
    assert set(got) == set(want), sorted(set(got) ^ set(want))[:6]
    bad = [k for k in want if not torch.equal(got[k].float(), want[k].float())]
    assert not bad, bad[:6]


def _shapes(sd):
    return {k: tuple(v.shape) for k, v in sd.items()}


def flux_mirror(guidance, seed=2):
    jcfg = JFluxConfig.tiny(guidance_embeds=guidance)
    return jcfg, randomize(FluxTransformerMirror(jcfg), seed=seed).eval()


def wan_mirror(seed=4, **kw):
    jcfg = JWanConfig.tiny(**kw)
    return jcfg, randomize(WanTransformerMirror(jcfg), seed=seed).eval()


def wan_vae_mirror(geometry, seed=7, **overrides):
    kw = dict(WAN_VAE_KW[geometry], **STATS)
    kw.update(overrides)
    jcfg = JWanVAEConfig.tiny(**kw)
    mirror = AutoencoderKLWanMirror(base_dim=jcfg.base_dim, z_dim=jcfg.z_dim,
                                    dim_mult=jcfg.dim_mult, num_res_blocks=jcfg.num_res_blocks,
                                    attn_scales=jcfg.attn_scales,
                                    temperal_downsample=jcfg.temperal_downsample)
    return jcfg, TWanVAEConfig.tiny(**kw), randomize(mirror, seed=seed).eval()


def flux_vae_mirror(seed=3):
    jcfg = JVAEConfig.flux(**FLUX_VAE_KW)
    return jcfg, TVAEConfig.flux(**FLUX_VAE_KW), randomize(AutoencoderKLMirror(jcfg), seed=seed,
                                                           std=0.05).eval()


def flux_inputs(cfg, gh=4, gw=4, s_txt=6, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((2, gh * gw, cfg.in_channels)).astype(np.float32),
            np.array([30.0, 950.0], np.float32),
            rng.standard_normal((2, s_txt, cfg.joint_attention_dim)).astype(np.float32),
            rng.standard_normal((2, cfg.pooled_projection_dim)).astype(np.float32),
            make_latent_ids(gh, gw), np.zeros((s_txt, 3), np.int32),
            np.array([1.5, 4.0], np.float32))


# ── the writers against the diffusers graphs ───────────────────────────────


def _writer_case(name):
    if name.startswith("flux"):
        jcfg, mirror = flux_mirror(name == "flux_guidance")
        model = TFluxTransformer(TFluxConfig.tiny(guidance_embeds=jcfg.guidance_embeds,
                                                  lora_rank=4), device="meta")
        return hf_flux_state_dict(model.state_dict()), mirror
    if name == "wan":
        jcfg, mirror = wan_mirror()
        return hf_wan_state_dict(TWanTransformer(TWanConfig.tiny(lora_rank=4),
                                                 device="meta").state_dict()), mirror
    _, tcfg, mirror = wan_vae_mirror(name.split("-")[1])
    return hf_wan_vae_state_dict(TWanVideoVAE(tcfg, device="meta").state_dict()), mirror


@pytest.mark.parametrize("name", ["flux_guidance", "flux_schnell", "wan", "wan_vae-t3d",
                                  "wan_vae-mixed_attn"])
def test_writers_name_what_diffusers_names(name):
    """The name writers of ``chip_smoke.py`` turn the port's state dicts
    (LoRA factors included, which a checkpoint leaves out) into the key sets
    and shapes of the diffusers-graph mirrors."""
    written, mirror = _writer_case(name)
    assert _shapes(written) == _shapes(mirror.state_dict())


# ── the converters against the JAX converters and the mirrors ──────────────


@pytest.mark.parametrize("guidance", [True, False], ids=["guidance", "schnell"])
def test_flux_converter_matches_jax_and_the_mirror(guidance):
    """``flux_state_dict_from_hf`` equals ``convert_flux`` carried across
    bitwise; the port's forward on it matches the JAX model's and the
    mirror's, on a square and a non-square grid: ``norm_out.linear``'s
    (scale, shift) halves and the text stream's names (``add_q_proj`` for
    the JAX ``add_to_q``) in their places."""
    jcfg, mirror = flux_mirror(guidance)
    tcfg = TFluxConfig.tiny(guidance_embeds=guidance)
    sd = mirror.state_dict()
    got = t_convert.flux_state_dict_from_hf(sd, tcfg)
    params = j_convert.convert_flux(_np(sd), jcfg)
    _assert_same(got, t_convert.flux_state_dict_from_jax(params, tcfg))
    model = TFluxTransformer(tcfg)
    model.load_state_dict(got)
    for gh, gw in ((4, 4), (6, 3)):
        lat, t, ctx, pooled, img_ids, txt_ids, g = flux_inputs(tcfg, gh, gw)
        g = g if guidance else None
        want = JFluxTransformer(jcfg).apply(
            {"params": params}, jnp.asarray(lat), jnp.asarray(t), jnp.asarray(ctx),
            jnp.asarray(pooled), img_ids, txt_ids,
            guidance=None if g is None else jnp.asarray(g))
        with torch.no_grad():
            out = model(torch.from_numpy(lat), torch.from_numpy(t), torch.from_numpy(ctx),
                        torch.from_numpy(pooled), img_ids, txt_ids,
                        guidance=None if g is None else torch.from_numpy(g))
            ref = mirror(torch.from_numpy(lat), torch.from_numpy(t), torch.from_numpy(ctx),
                         torch.from_numpy(pooled), torch.from_numpy(img_ids),
                         torch.from_numpy(txt_ids), None if g is None else torch.from_numpy(g))
        np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("grid", [(1, 4, 4), (5, 12, 6)], ids=["one_frame", "frames_nonsquare"])
def test_wan_converter_matches_jax_and_the_mirror(grid):
    """``wan_state_dict_from_hf`` equals ``convert_wan`` carried across
    bitwise (the patch Conv3d, the (1, 6, dim) / (1, 2, dim) tables,
    ``norm2``); the port's forward matches the JAX model's and the mirror's
    at one frame and at several frames of a non-square grid."""
    jcfg, mirror = wan_mirror()
    tcfg = TWanConfig.tiny()
    sd = mirror.state_dict()
    got = t_convert.wan_state_dict_from_hf(sd, tcfg)
    params = j_convert.convert_wan(_np(sd), jcfg)
    _assert_same(got, t_convert.wan_state_dict_from_jax(params, tcfg))
    model = TWanTransformer(tcfg)
    model.load_state_dict(got)
    rng = np.random.default_rng(1)
    lat = rng.standard_normal((2, tcfg.in_channels) + grid).astype(np.float32)
    t = np.array([80.0, 930.0], np.float32)
    txt = rng.standard_normal((2, 5, tcfg.text_dim)).astype(np.float32)
    want = JWanTransformer(jcfg).apply({"params": params}, jnp.asarray(lat), jnp.asarray(t),
                                       jnp.asarray(txt))
    with torch.no_grad():
        out = model(torch.from_numpy(lat), torch.from_numpy(t), torch.from_numpy(txt))
        ref = mirror(torch.from_numpy(lat), torch.from_numpy(t), torch.from_numpy(txt))
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("geometry", list(WAN_VAE_KW))
def test_wan_vae_converter_matches_jax_and_the_mirror(geometry):
    """``wan_vae_state_dict_from_hf`` (encoder, quant convs, decoder) equals
    ``convert_wan_vae`` carried across bitwise; ``encode_raw`` matches the
    JAX VAE and the mirror's chunked encoder ([1, 4, 4] frames) on 9 frames
    of a non-square clip, ``encode`` (normalised, no noise) and ``decode``
    of its latents match the JAX VAE."""
    jcfg, tcfg, mirror = wan_vae_mirror(geometry)
    sd = mirror.state_dict()
    got = t_convert.wan_vae_state_dict_from_hf(sd, tcfg)
    params = j_convert.convert_wan_vae(_np(sd), jcfg)
    _assert_same(got, t_convert.wan_vae_state_dict_from_jax(params, tcfg))
    vae = TWanVideoVAE(tcfg)
    vae.load_state_dict(got)
    sf = tcfg.spatial_factor
    vid = np.random.default_rng(5).uniform(-1, 1, (1, 3, 9, 2 * sf, 3 * sf)).astype(np.float32)
    jvae = JWanVideoVAE(jcfg)
    jmean, jlogvar = jvae.apply({"params": params}, jnp.asarray(vid), method=jvae.encode_raw)
    jz = jvae.apply({"params": params}, jnp.asarray(vid), method=jvae.encode)
    jdec = jvae.apply({"params": params}, jz, method=jvae.decode)
    with torch.no_grad():
        mean, logvar = vae.encode_raw(torch.from_numpy(vid))
        z = vae.encode(torch.from_numpy(vid))
        dec = vae.decode(torch.from_numpy(np.array(jz)))
        ref_mean, ref_logvar = mirror.encode(torch.from_numpy(vid))
    for a, b in ((mean, jmean), (logvar, jlogvar), (z, jz), (dec, jdec)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(mean.numpy(), ref_mean.numpy(), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(logvar.numpy(), ref_logvar.numpy(), rtol=RTOL, atol=ATOL)


def _strict_case(family):
    """(converter, the mirror's state dict, the config, a name the converter
    must take)."""
    if family == "flux":
        _, mirror = flux_mirror(True)
        return (t_convert.flux_state_dict_from_hf, mirror.state_dict(), TFluxConfig.tiny(),
                "transformer_blocks.1.attn.norm_added_k.weight")
    if family == "flux_schnell_config":  # a guidance embedder the config has no room for
        _, mirror = flux_mirror(True)
        return (t_convert.flux_state_dict_from_hf, mirror.state_dict(),
                TFluxConfig.tiny(guidance_embeds=False), None)
    if family == "wan":
        _, mirror = wan_mirror()
        return (t_convert.wan_state_dict_from_hf, mirror.state_dict(), TWanConfig.tiny(),
                "blocks.1.norm2.bias")
    if family == "wan_no_cross_norm_config":  # norm2 the config does not hold
        _, mirror = wan_mirror()
        return (t_convert.wan_state_dict_from_hf, mirror.state_dict(),
                TWanConfig.tiny(cross_attn_norm=False), None)
    _, tcfg, mirror = wan_vae_mirror("t3d")
    return (t_convert.wan_vae_state_dict_from_hf, mirror.state_dict(), tcfg,
            "encoder.down_blocks.1.time_conv.weight")


@pytest.mark.parametrize("family", ["flux", "flux_schnell_config", "wan",
                                    "wan_no_cross_norm_config", "wan_vae"])
def test_converters_refuse_leftover_and_missing_weights(family):
    """A weight left over raises "not consumed"; a missing one raises naming
    it (the guidance embedder of a Flux.1-dev file under a schnell config,
    and ``norm2`` under ``cross_attn_norm=False``, are leftovers)."""
    fn, sd, cfg, needed = _strict_case(family)
    extra = dict(sd, **{"stray.weight": torch.zeros(2)}) if needed else sd
    with pytest.raises(ValueError, match="not consumed"):
        fn(extra, cfg)
    if needed:
        with pytest.raises(KeyError, match=needed.replace(".", r"\.")):
            fn({k: v for k, v in sd.items() if k != needed}, cfg)


# ── the loaders against the JAX loaders ────────────────────────────────────


def _bf16_values(sd):
    """The state dict with every value rounded to bf16 (kept fp32): what a
    bf16 file holds, as an fp32 copy the JAX reader can open."""
    return {k: v.to(torch.bfloat16).float() for k, v in sd.items()}


def _write(tmp_path, family, jcfg, sd, file_dtype, shards):
    """(the directory the port reads, the one the JAX loader reads): the same
    values, the port's in ``file_dtype``."""
    sd = _bf16_values(sd) if file_dtype == torch.bfloat16 else sd
    roots = {}
    for side, dtype in (("port", file_dtype), ("jax", torch.float32)):
        root = str(tmp_path / side)
        t_sd = {k: v.to(dtype) for k, v in sd.items()}
        if family == "flux":
            vcfg, _, vmirror = flux_vae_mirror()
            write_flux_dirs(root, t_sd, vmirror.state_dict(), jcfg, vcfg, shards=shards)
        else:
            jvcfg, _, vmirror = wan_vae_mirror("t3d")
            write_wan_dirs(root, t_sd, vmirror.state_dict(), jcfg, jvcfg, shards=shards)
        roots[side] = os.path.join(root, "transformer")
    return roots


LOADER_CASES = {  # name: (file dtype, shards, compute dtype, LoRA rank)
    "fp32_file-bf16": (torch.float32, 1, "bf16", 4),
    "bf16_file_3_shards-bf16": (torch.bfloat16, 3, "bf16", 4),
    "fp32_file_2_shards-fp32": (torch.float32, 2, "fp32", 0),
}


@pytest.mark.parametrize("case", list(LOADER_CASES))
@pytest.mark.parametrize("family", ["flux", "wan"])
def test_transformer_loaders_match_jax(tmp_path, family, case):
    """``load_flux_transformer`` / ``load_wan_transformer`` equal the JAX
    loaders bitwise: frozen weights rounded to bf16 as ``cast_tree_bf16``
    rounds them under bf16 compute (the tables, ``norm2`` and the RMS
    weights too, which the port holds in fp32), none under fp32; LoRA A the
    numpy draws in the JAX order, B zero. The shards' index is written
    beside them; the config the loader read is the JAX loader's."""
    file_dtype, shards, compute, rank = LOADER_CASES[case]
    if family == "flux":
        jcfg, mirror = flux_mirror(True)
        load_t, load_j = t_convert.load_flux_transformer, j_convert.load_flux_transformer
        carry = t_convert.flux_state_dict_from_jax
    else:
        jcfg, mirror = wan_mirror()
        load_t, load_j = t_convert.load_wan_transformer, j_convert.load_wan_transformer
        carry = t_convert.wan_state_dict_from_jax
    dirs = _write(tmp_path, family, jcfg, mirror.state_dict(), file_dtype, shards)
    if shards > 1:
        with open(os.path.join(dirs["port"], "diffusion_pytorch_model.safetensors.index.json")) as f:
            assert len(set(json.load(f)["weight_map"].values())) == shards
    dtype = torch.bfloat16 if compute == "bf16" else torch.float32
    tcfg, model = load_t(dirs["port"], dtype=dtype, lora_rank=rank, lora_alpha=8.0,
                         device="cpu")
    jcfg_l, jparams = load_j(dirs["jax"], dtype=jnp.bfloat16 if compute == "bf16"
                             else jnp.float32, remat=False, lora_rank=rank, lora_alpha=8.0)
    for field in ("in_channels", "attention_head_dim", "num_attention_heads",
                  "rope_axes_dims", "lora_rank", "lora_alpha"):
        assert getattr(tcfg, field) == getattr(jcfg_l, field), field
    assert tcfg.dtype == dtype and next(model.parameters()).device.type == "cpu"
    want = carry(jax.device_get(jparams), tcfg)
    _assert_same(model.state_dict(), want)
    lora = {k: v for k, v in model.state_dict().items() if k.endswith(("lora_a", "lora_b"))}
    init = t_convert.flux_lora_init if family == "flux" else t_convert.wan_lora_init
    _assert_same(lora, init(tcfg) if rank else {})
    if compute == "bf16" and file_dtype == torch.float32:
        # the frozen fp32 values were rounded, and differ from the file's
        frozen = t_convert.load_torch_state_dict(dirs["jax"])
        assert any(not torch.equal(model.state_dict()[k].float(), v) for k, v in frozen.items())
        assert all(torch.equal(model.state_dict()[k].float(), v.to(torch.bfloat16).float())
                   for k, v in frozen.items())


def test_wan_vae_loader_matches_jax(tmp_path):
    """``load_wan_vae``: the config (topology and the latent statistics) and
    every tensor, encoder included, equal the JAX ``load_wan_vae``; fp32."""
    jvcfg, _, vmirror = wan_vae_mirror("mixed_attn")
    jt, mirror = wan_mirror()
    write_wan_dirs(str(tmp_path), mirror.state_dict(), vmirror.state_dict(), jt, jvcfg)
    d = str(tmp_path / "vae")
    tcfg, vae = t_convert.load_wan_vae(d, device="cpu")
    jcfg, jparams = j_convert.load_wan_vae(d)
    for field in ("z_dim", "base_dim", "dim_mult", "num_res_blocks", "attn_scales",
                  "temperal_downsample", "latents_mean", "latents_std"):
        assert getattr(tcfg, field) == getattr(jcfg, field), field
    _assert_same(vae.state_dict(), t_convert.wan_vae_state_dict_from_jax(jparams, tcfg))
    assert all(v.dtype == torch.float32 for v in vae.state_dict().values())


@pytest.mark.parametrize("factors", [True, False], ids=["factors", "no_factors"])
def test_flux_vae_loader_matches_convert_vae(tmp_path, factors):
    """``load_vae(base=VAEConfig.flux())`` reads the SD3-layout AutoencoderKL
    of a Flux directory bitwise as ``convert_vae`` under ``VAEConfig.flux()``
    maps it; a config.json without ``scaling_factor`` / ``shift_factor``
    falls back to Flux's 0.3611 / 0.1159."""
    jvcfg, tvcfg, vmirror = flux_vae_mirror()
    jt, mirror = flux_mirror(True)
    odd = TVAEConfig.flux(**FLUX_VAE_KW, scaling_factor=0.5, shift_factor=0.25)
    write_flux_dirs(str(tmp_path), mirror.state_dict(), vmirror.state_dict(), jt,
                    odd, vae_factors=factors)
    cfg, vae = t_convert.load_vae(str(tmp_path / "vae"), base=TVAEConfig.flux(),
                                  device="cpu")
    assert (cfg.scaling_factor, cfg.shift_factor) == ((0.5, 0.25) if factors else (0.3611, 0.1159))
    assert (cfg.block_out_channels, cfg.latent_channels) == (tvcfg.block_out_channels, 4)
    params = j_convert.convert_vae(_np(vmirror.state_dict()), jvcfg)
    _assert_same(vae.state_dict(), t_convert.vae_state_dict_from_jax(params, tvcfg))


# ── the slice: pipelines and CLIs from the directories ─────────────────────


@pytest.fixture(scope="module")
def family_dirs(tmp_path_factory):
    """A Flux and a WAN directory at the tiny widths, fp32 files (the JAX
    package reads them too), the Flux transformer in 2 shards."""
    root = tmp_path_factory.mktemp("families")
    jf, fmirror = flux_mirror(True)
    _, fvcfg, fvmirror = flux_vae_mirror()
    write_flux_dirs(str(root / "flux"), fmirror.state_dict(), fvmirror.state_dict(), jf, fvcfg,
                    shards=2)
    jw, wmirror = wan_mirror()
    # the VAE's latent width is the transformer's 16 channels
    jwv, _, wvmirror = wan_vae_mirror("t3d", z_dim=16, latents_mean=WAN_MEAN,
                                      latents_std=WAN_STD)
    write_wan_dirs(str(root / "wan"), wmirror.state_dict(), wvmirror.state_dict(), jw, jwv)
    return {"flux": str(root / "flux" / "transformer"), "wan": str(root / "wan" / "transformer")}


def test_flux_pipeline_from_pretrained_matches_jax(family_dirs):
    """``FluxPipeline.from_pretrained`` (fp32, LoRA r=4, its VAE from
    ``<dir>/../vae``) against a JAX ``FluxPipeline`` of the same files (the
    transformer through ``load_flux_transformer``, the VAE through
    ``convert_vae`` under ``VAEConfig.flux()``): the velocity with guidance
    3.5 and the decode of its packed output, 1e-4."""
    d = family_dirs["flux"]
    tp = TFluxPipeline.from_pretrained(d, lora_rank=4, lora_alpha=8.0, dtype=torch.float32,
                                       text_seq_len=6, guidance=3.5, latent_hw=8, device="cpu")
    jcfg, jparams = j_convert.load_flux_transformer(d, dtype=jnp.float32, remat=False,
                                                    lora_rank=4, lora_alpha=8.0)
    jvcfg = JVAEConfig.flux(**FLUX_VAE_KW)
    vparams = j_convert.convert_vae(j_convert.load_torch_state_dict(
        os.path.join(os.path.dirname(d), "vae")), jvcfg)
    jp = JFluxPipeline(jcfg, jvcfg, JFluxTransformer(jcfg), JAutoencoderKL(jvcfg),
                       {"params": jparams}, {"params": vparams}, text_seq_len=6, guidance=3.5)
    assert (tp.vae_cfg.scaling_factor, tp.vae_cfg.shift_factor) == (0.3611, 0.1159)
    lat, t, ctx, pooled, *_ = flux_inputs(tp.flux_cfg, 4, 4)
    want = jp.velocity_fn(jp.transformer_params)(jnp.asarray(lat), jnp.asarray(t),
                                                 jnp.asarray(ctx), jnp.asarray(pooled))
    with torch.no_grad():
        got = tp.velocity_fn()(torch.from_numpy(lat), torch.from_numpy(t),
                               torch.from_numpy(ctx), torch.from_numpy(pooled))
        img = tp.decode(got)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(img.numpy(), np.asarray(jp.decode(want)), rtol=RTOL, atol=ATOL)


def test_wan_pipeline_from_pretrained_matches_jax(family_dirs):
    """``WanPipeline.from_pretrained`` against the JAX one of the same
    directory (both fp32, LoRA r=4): the velocity on 3 latent frames and the
    decode of it, 1e-4."""
    d = family_dirs["wan"]
    kw = dict(lora_rank=4, lora_alpha=8.0, latent_frames=3, text_seq_len=5)
    tp = TWanPipeline.from_pretrained(d, dtype=torch.float32, device="cpu", **kw)
    jp = JWanPipeline.from_pretrained(d, dtype=jnp.float32, remat=False, **kw)
    assert (tp.vae_cfg.latents_mean, tp.vae_cfg.latents_std) == (WAN_MEAN, WAN_STD)
    rng = np.random.default_rng(2)
    lat = rng.standard_normal((1, 16, 3, 4, 6)).astype(np.float32)
    t = np.array([500.0], np.float32)
    txt = rng.standard_normal((1, 5, tp.wan_cfg.text_dim)).astype(np.float32)
    want = jp.velocity_fn(jp.transformer_params)(jnp.asarray(lat), jnp.asarray(t),
                                                 jnp.asarray(txt))
    with torch.no_grad():
        got = tp.velocity_fn()(torch.from_numpy(lat), torch.from_numpy(t), torch.from_numpy(txt))
        video = tp.decode(got)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(video.numpy(), np.asarray(jp.decode(want)), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("family", ["flux", "wan"])
def test_build_pipeline_loads_the_directory(family_dirs, monkeypatch, family):
    """``cli.common.build_pipeline`` with ``FLUX_DIR`` / ``WAN_DIR`` set builds
    the pipeline from the directory on ``--device cpu``: the loader's weights
    in ``compute_dtype(config)``, Flux's guidance from
    ``sample.guidance_scale``, WAN's 1 + (num_frames - 1) // 4 latent frames
    (and, given ``frames``, the demo's grid of that many frames)."""
    monkeypatch.setenv("FLUX_DIR" if family == "flux" else "WAN_DIR", family_dirs[family])
    config = t_common.resolve_config(f"{family}_smoke")
    config.sample.guidance_scale = 2.5
    pipe = t_common.build_pipeline(config, device="cpu")
    loader = (t_convert.load_flux_transformer if family == "flux"
              else t_convert.load_wan_transformer)
    _, want = loader(family_dirs[family], lora_rank=int(config.train.lora_rank),
                     lora_alpha=float(config.train.lora_alpha), device="cpu")
    _assert_same(pipe.transformer.state_dict(), want.state_dict())
    assert pipe.device == torch.device("cpu") and pipe.transformer.cfg.dtype == torch.bfloat16
    if family == "flux":
        assert pipe.guidance == 2.5 and pipe.flux_cfg.num_double_layers == 2
    else:
        assert pipe.latent_frames == 1 + (int(config.sample.num_frames) - 1) // 4
        demo = t_common.build_pipeline(config, device="cpu", frames=5)
        vc = demo.vae_cfg
        assert (demo.latent_frames, demo.latent_hw) == (1 + 4 // vc.temporal_factor,
                                                        int(config.resolution) // vc.spatial_factor)


@pytest.mark.parametrize("family", ["flux", "wan"])
def test_a_set_path_that_is_not_a_directory_raises(tmp_path, monkeypatch, family):
    """Without ``smoke_test`` a set path that is not a directory raises
    ``FileNotFoundError``; with it, the tiny random-init model is built (the
    JAX branches' rule)."""
    monkeypatch.setenv("FLUX_DIR" if family == "flux" else "WAN_DIR",
                       str(tmp_path / "missing"))
    config = t_common.resolve_config(f"{family}_smoke")
    config.smoke_test = False
    with pytest.raises(FileNotFoundError, match="transformer"):
        t_common.build_pipeline(config, device="cpu")
    config.smoke_test = True
    pipe = t_common.build_pipeline(config, device="cpu")
    assert pipe.transformer.cfg.dtype == torch.float32  # the tiny random model


def test_clis_run_from_the_directories(family_dirs, monkeypatch, tmp_path):
    """``cli.infer`` on ``flux_smoke`` with ``FLUX_DIR`` and
    ``cli.wan_sde_demo`` with ``WAN_DIR`` write their PNGs from the loaded
    models."""
    from PIL import Image

    monkeypatch.setenv("FLUX_DIR", family_dirs["flux"])
    paths = t_infer.main(["--config", "flux_smoke", "--prompts", "a flower", "--out_dir",
                          str(tmp_path / "flux"), "--device", "cpu"])
    img = np.asarray(Image.open(paths[0]))
    assert img.shape == (16, 16, 3) and img.min() < img.max()  # 8^2 latents, 2x VAE
    monkeypatch.setenv("WAN_DIR", family_dirs["wan"])
    path = t_demo.main(["--device", "cpu", "--out_dir", str(tmp_path / "wan")])
    strip = np.asarray(Image.open(path))
    assert strip.shape == (32, 32 * 9, 3) and strip.min() < strip.max()
