"""The WAN family: Wan2.1's text-to-video transformer with its 3D causal
VAE, the host JPEG compressibility as the GRPO reward. The registry loads
this file by the configuration's ``family``; it serves ``grpo_epoch`` with
the interface ``families/sd3.py`` describes (``build``, ``grpo_captured``,
``STAGES``, ``unit_work``).

The model is built from the configuration's file, as the port's CLI builds
one from a weights directory (``models.convert.wan_config_from_json`` and
``wan_vae_config_from_json`` over the same diffusers keys, the preset's LoRA,
remat and ``mixed_precision``), at the workload's frames and resolution (the
port's trainer takes a square latent grid), then handed to ``GRPOTrainer``
with the benchmark's weights and prompt encoder and the preset's reward.

The comparison is the SD3 family's GRPO comparison with WAN's stages: the
warm-up epoch's batch and one video of it drawn from the seed are rolled out
again (every step stochastic, the noise the seed's stream in the program's
order, the window start drawn as the trainer draws it) and its final latents
decoded again over the whole sequence; every video is scored again (JPEG
compressibility per frame, on the host); the advantages follow from the
reference's rewards; the first optimizer step is taken again from the
program's rollout records (one row a microstep, as the trainer splits it)."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from portbench.harness import work
from portbench.harness.checks import empty_cache, rel, trainer_seed
from portbench.harness.program import encoder_of, program_config, restart_ema, same_spec
from portbench.harness.weights import batch_seed, load_into, make_weights, module_spec
from portbench.reference import FP32, Precision
from portbench.reference import grpo as ref_grpo
from portbench.reference import jpeg as ref_jpeg
from portbench.reference import wan as ref_wan

# ── the system under test ──────────────────────────────────────────────────


def check_pipeline(pipeline, cfg: dict):
    """The program's WAN transformer and VAE decoder are the configuration's."""
    same_spec("transformer", module_spec(pipeline.transformer), ref_wan.transformer_spec(cfg))
    dec = [s for s in module_spec(pipeline.vae)
           if s[0].startswith(("decoder.", "post_quant_conv."))]
    same_spec("VAE decoder", dec, ref_wan.vae_decoder_spec(cfg["vae"]))
    w, v = pipeline.wan_cfg, pipeline.vae_cfg
    got = dict(rope=tuple(w.rope_axes_dims), cross=bool(w.cross_attn_norm),
               alpha=float(w.lora_alpha), mean=tuple(v.latents_mean), std=tuple(v.latents_std),
               text=pipeline.text_seq_len, vae=v.dtype, dtype=w.dtype)
    want = dict(rope=tuple(cfg["rope_axes_dims"]), cross=bool(cfg["cross_attn_norm"]),
                alpha=float(cfg["lora"]["alpha"]), mean=tuple(cfg["vae"]["latents_mean"]),
                std=tuple(cfg["vae"]["latents_std"]), text=cfg["text_encoders"]["seq_len"],
                vae=torch.float32, dtype=getattr(torch, cfg["compute_dtype"]))
    if got != want:
        raise ValueError(f"the program's WAN pipeline is not the configuration's: {got} != {want}")


@torch.no_grad()
def load_weights(pipeline, cfg: dict, seed: int):
    dev = pipeline.device
    tr = make_weights(ref_wan.transformer_spec(cfg), "diffusion", seed, "transformer", dev)
    load_into(pipeline.transformer, tr)
    del tr
    dec = make_weights(ref_wan.vae_decoder_spec(cfg["vae"]), "diffusion", seed, "vae.decoder",
                       dev)
    enc_spec = [s for s in module_spec(pipeline.vae) if s[0] not in dec]
    enc = make_weights(enc_spec, "diffusion", seed, "vae.encoder", dev)
    load_into(pipeline.vae, {**dec, **enc})


def build_trainer(workload: dict, cfg: dict, seed: int, device):
    """``GRPOTrainer`` on the configuration's WAN pipeline at the workload's
    frames and resolution, with the benchmark's weights and prompt encoder,
    and the preset's host reward."""
    from adv_grpo_torch.cli.common import compute_dtype
    from adv_grpo_torch.data.datasets import TextPromptDataset
    from adv_grpo_torch.models.convert import wan_config_from_json, wan_vae_config_from_json
    from adv_grpo_torch.rewards.registry import multi_score
    from adv_grpo_torch.train.driver import GRPOTrainer
    from adv_grpo_torch.train.wan_pipeline import WanPipeline

    config = program_config(workload, seed)
    wcfg = wan_config_from_json(cfg, lora_rank=int(config.train.lora_rank),
                                lora_alpha=float(config.train.lora_alpha),
                                remat=bool(config.tpu.remat), dtype=compute_dtype(config))
    vcfg = wan_vae_config_from_json(cfg["vae"])
    hw = int(config.resolution) // vcfg.spatial_factor
    pipeline = WanPipeline.random_init(
        torch.Generator(device=device).manual_seed(int(seed) % 2 ** 63), wcfg, vcfg, device,
        latent_hw=hw, latent_frames=vcfg.latent_frames(int(config.sample.num_frames)),
        text_seq_len=cfg["text_encoders"]["seq_len"])
    check_pipeline(pipeline, cfg)
    load_weights(pipeline, cfg, seed)
    dataset = TextPromptDataset(str(config.dataset), "train")
    trainer = GRPOTrainer(config, pipeline, dataset, encoder_of(cfg),
                          multi_score(dict(config.reward_fn)), latent_hw=hw)
    restart_ema(trainer)
    return trainer, config


def build(entry: str, workload: dict, cfg: dict, seed: int, device):
    return {"grpo_epoch": build_trainer}[entry](workload, cfg, seed, device)


def grpo_captured(trainer) -> dict:
    """The latent grid, the scheduler's shift and the video tokens a row."""
    pl = trainer.pipeline
    return {"latent_shape": (pl.wan_cfg.in_channels, pl.latent_frames, trainer.latent_hw,
                             trainer.latent_hw),
            "shift": float(pl.shift), "s_vid": int(trainer._s_img)}


# ── the work a unit asks of the chip ───────────────────────────────────────


def unit_work(run) -> dict:
    """{"flops": transformer FLOPs of one epoch (each training forward and
    backward at 3 forwards, counted once whatever remat recomputes),
    "attention": its attention calls}."""
    cfg, cap = run.config, run.captured
    config = cap["config"]
    s, tr = config.sample, config.train
    s_vid, s_txt = cap["s_vid"], cfg["text_encoders"]["seq_len"]
    B = int(s.train_batch_size) * int(s.mini_num_image_per_prompt)
    nb = cap["num_batches"]
    n_roll = nb * int(s.num_steps)
    n_micro = nb * max(int(tr.get("micro_splits", 1)), 1)
    micro = n_micro * int(s.train_num_steps) * max(int(tr.num_inner_epochs), 1)
    bs = nb * B // n_micro
    flops = (n_roll * work.wan_forward_flops(cfg, s_vid, s_txt, B)
             + micro * 3 * work.wan_forward_flops(cfg, s_vid, s_txt, bs))
    calls = [(c[0] * n_roll,) + c[1:]
             for c in work.wan_attention_calls(cfg, s_vid, s_txt, B, False)]
    for bwd in (False, True):
        calls += [(c[0] * micro,) + c[1:]
                  for c in work.wan_attention_calls(cfg, s_vid, s_txt, bs, bwd)]
    return {"flops": flops, "attention": calls}


# ── the comparison ─────────────────────────────────────────────────────────


def wan_path(name: str) -> str:
    """``blocks.3.attn2.to_k.lora_b`` -> ``block_3/cross_to_k/lora_b``, the
    trainer's names of the WAN LoRA leaves."""
    _, i, attn, rest = name.split(".", 3)
    rest = rest.replace("to_out.0.", "to_out.")
    proj, leaf = rest.rsplit(".", 1)
    return f"block_{i}/{'cross_' if attn == 'attn2' else ''}{proj}/{leaf}"


def window_start(step_idx: int, num_steps: int) -> int:
    """The trainer's draw of the window start at sampling batch
    ``step_idx`` on rank 0 (``GRPOTrainer.window_start``)."""
    return int(np.random.default_rng(step_idx).integers(0, num_steps // 2 + 1, size=1)[0])


def plan(run) -> dict:
    cap = run.captured
    s = cap["config"].sample
    B = int(s.train_batch_size) * int(s.mini_num_image_per_prompt)
    rng = np.random.default_rng(batch_seed(run.seed, "check", 0))
    b = int(rng.integers(cap["num_batches"]))
    rows = sorted(rng.choice(B, size=min(int(run.workload["check"]["batch_rows"]), B),
                             replace=False).tolist())
    rt = (int(s.random_timestep) if s.random_timestep is not None
          else window_start(b, int(s.num_steps)))
    return {"B": B, "batch": b, "rows": rows, "global": [b * B + r for r in rows], "rt": rt}


def program(run, p) -> dict:
    cap = run.captured
    smp, g = cap["samples"], p["global"]
    step, hp = cap["steps"][0], cap["hp"]
    lat, vid = cap["decoded"][p["batch"]]
    return {"window": smp["rollout"]["latents"][g][:, 1:],
            "log_probs": smp["rollout"]["log_probs"][g],
            "final": lat[p["rows"]], "videos": vid[p["rows"]],
            "rewards": np.asarray(smp["rewards"]["avg"], np.float64),
            "advantages": np.asarray(cap["advantages"], np.float64),
            "losses": list(cap["losses"][:cap["accum"]]),
            "grad": {k: m / (1 - hp["b1"]) for k, m in step["mu"].items()},
            "delta": {k: step["lora"][k] - cap["lora0"][k] for k in step["lora"]}}


def reference(run, p, prec: Precision = FP32) -> dict:
    cfg, cap, dev, seed = run.config, run.captured, run.device, run.seed
    config = cap["config"]
    s = config.sample
    B, rows, rt = p["B"], p["rows"], p["rt"]
    T, n = int(s.train_num_steps), int(s.num_steps)
    smp = cap["samples"]
    enc = encoder_of(cfg)
    out = {}
    empty_cache(dev)
    with torch.no_grad(), FP32.tf32_scope():
        w = make_weights(ref_wan.transformer_spec(cfg), "diffusion", seed, "transformer", dev)
        lora0 = {}
        for k, v in w.items():
            if k.endswith(".lora_a"):
                base = k[:-len(".lora_a")]
                lora0[base] = (v.float(), w[base + ".lora_b"].float())
        model = ref_wan.WanTransformer(cfg, w, prec)
        del w
        gen = torch.Generator(device=dev).manual_seed(trainer_seed(config.seed, p["batch"], 0))
        shape = (B,) + tuple(cap["latent_shape"])
        x = torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)[rows]
        sig, ts = ref_wan.unipc_flow_sigmas(n, float(cap["shift"]))
        s_min, s_max = float(sig[-1]), float(sig[1])
        prompts = smp["prompts"][p["batch"] * B:(p["batch"] + 1) * B]
        text = torch.from_numpy(enc([prompts[r] for r in rows])[0]).to(dev)
        win, lps = [], []
        for i in range(n):
            v = model.forward(x, torch.full((len(rows),), float(ts[i]), device=dev), text, lora0)
            noise = torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)[rows]
            x, lp, _ = ref_wan.wan_step(v, x, float(sig[i]), float(sig[i + 1]), s_min, s_max,
                                        noise=noise)
            if rt <= i < rt + T:
                win.append(x)
                lps.append(lp)
        out.update(window=torch.stack(win, 1), log_probs=torch.stack(lps, 1), final=x)
        dec = make_weights(ref_wan.vae_decoder_spec(cfg["vae"]), "diffusion", seed,
                           "vae.decoder", dev)
        prog_final = cap["decoded"][p["batch"]][0][rows].to(dev)
        out["videos"] = ref_wan.WanVAEDecoder(cfg["vae"], dec, prec)(prog_final).transpose(1, 2)
        del dec
        out["rewards"] = np.concatenate([ref_jpeg.compressibility(vid.numpy())
                                         for _, vid in cap["decoded"]])
        out["advantages"] = ref_grpo.advantages(out["rewards"], smp["prompt_ids"],
                                                bool(s.global_std))
    out.update(_first_step(run, model, lora0, out["advantages"].astype(np.float32), enc,
                           s_min, s_max))
    return out


def _first_step(run, model, lora0, adv, enc, s_min, s_max) -> dict:
    cap, dev = run.captured, run.device
    tr = cap["config"].train
    roll = cap["samples"]["rollout"]
    n = roll["latents"].shape[0]
    bs = n // (cap["num_batches"] * max(int(tr.get("micro_splits", 1)), 1))
    T, accum = int(cap["config"].sample.train_num_steps), cap["accum"]
    names = sorted(lora0)
    leaves = {nm: tuple(t.clone().requires_grad_(True) for t in lora0[nm]) for nm in names}
    keys = [(nm, i, f"{nm}.{w}") for nm in names for i, w in enumerate(("lora_a", "lora_b"))]
    acc = {key: torch.zeros_like(lora0[nm][i]) for nm, i, key in keys}
    prompts = cap["samples"]["prompts"]
    losses = []
    with FP32.tf32_scope():
        for m in range(accum):
            i, j = divmod(m, T)
            total = 0.0
            for r in range(i * bs, (i + 1) * bs):
                x = roll["latents"][r:r + 1, j].to(dev)
                text = torch.from_numpy(enc([prompts[r]])[0]).to(dev)
                v = model.forward(x, torch.full((1,), float(roll["timesteps"][r, j]), device=dev),
                                  text, leaves)
                _, lp, _ = ref_wan.wan_step(v, x, float(roll["sigmas"][r, j]),
                                            float(roll["sigmas_prev"][r, j]), s_min, s_max,
                                            prev=roll["latents"][r:r + 1, j + 1].to(dev))
                a = torch.tensor([float(adv[r])], device=dev)
                li = ref_grpo.policy_loss(lp, lp.detach(), a, float(tr.clip_range),
                                          float(tr.adv_clip_max)).sum() / bs
                li.backward()
                total += float(li.detach())
            losses.append(total)
            for nm, k, key in keys:
                leaf = leaves[nm][k]
                acc[key] += (leaf.grad - acc[key]) / (m + 1)
                leaf.grad = None
    p0 = {key: lora0[nm][k] for nm, k, key in keys}
    new, g, _, _ = ref_grpo.adamw_step(p0, acc, cap["hp"], step=1)
    return {"losses": losses, "grad": {wan_path(k): v for k, v in g.items()},
            "delta": {wan_path(k): new[k] - p0[k] for k in g}}


def numbers(prog: dict, ref: dict) -> Dict[str, float]:
    dev = ref["window"].device
    T = ref["window"].shape[1]
    ref_g = {k: float(v.norm()) for k, v in ref["grad"].items()}
    med = float(np.median(list(ref_g.values())))
    moved = {k for k, v in ref_g.items() if v >= 1e-3 * med}
    return {
        "rollout_rel": max(max(rel(prog["window"][:, j].to(dev), ref["window"][:, j])
                               for j in range(T)),
                           rel(prog["final"].to(dev), ref["final"])),
        "logprob_gap": float((prog["log_probs"].to(dev) - ref["log_probs"]).abs().max()),
        "decode_rel": rel(prog["videos"].to(dev), ref["videos"]),
        "reward_gap": float(np.abs(prog["rewards"] - ref["rewards"]).max()),
        "advantage_gap": float(np.abs(prog["advantages"] - ref["advantages"]).max()),
        "loss_gap": max(abs(a - b) for a, b in zip(prog["losses"], ref["losses"])),
        "grad_gap": ref_grpo.worst_leaf_gap({k: float(v.norm()) for k, v in prog["grad"].items()},
                                            ref_g),
        "update_gap": ref_grpo.worst_leaf_gap(
            {k: float(v.norm()) for k, v in prog["delta"].items()},
            {k: float(v.norm()) for k, v in ref["delta"].items()}, keep=moved),
    }


STAGES = {"grpo_epoch": (plan, program, reference, numbers)}
