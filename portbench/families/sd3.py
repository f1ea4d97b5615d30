"""The SD3 family: SD3.5's MMDiT-X with its VAE, PickScore as the GRPO
reward. The registry loads this file by the configuration's ``family``; it
gives the harness, for each entry it serves (``grpo_epoch``,
``sample_batch``):

  build(entry, workload, cfg, seed, device)  the system under test, built
      through the port's CLI (``cli.train.build_trainer``,
      ``cli.common.build_pipeline``), with the benchmark's weights and
      prompt encoder, checked against the configuration
  grpo_captured(trainer)                     what the GRPO comparison reads
      from the trainer beyond the harness's own capture (nothing here)
  STAGES[entry]                              (plan, program, reference,
      numbers) of the comparison that decides ``correct``
  unit_work(run)                             one unit's transformer FLOPs and
      attention calls, counted from shapes

The port's CLI builds a random-weight SD3 at SD3.5-Medium's widths (or the
CPU-sized one of ``smoke_test``), so a configuration at other widths takes a
family file of its own that builds the pipeline from its file.

The comparison runs after the window has closed and the program's state is
freed, on the device, with the plain reference (``portbench/reference``).
``reference_*`` work out each stage's outputs from the inputs both sides
share; ``program_*`` read the same outputs from what the program produced;
``*_numbers`` set them side by side. The control puts the reference's
lower-precision twin (``Precision(control=True)``) in the program's place.

grpo: the warm-up epoch that the window's trainer ran (the same object, the
window's own call). A batch and rows of it drawn from the seed are rolled
out again from the same noise (the seed's stream, drawn in the program's
order) and their final latents decoded again; every image of the epoch is
scored again; the advantages follow from the reference's rewards; the first
optimizer step is taken again, each of its microsteps at the whole
minibatch, from the program's rollout records, which the reference follows
as data (the rollout itself is checked from the seed above).

sample: a window batch and rows drawn from the seed, denoised again from
the same starting latents, and the program's final latents decoded again."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from portbench.harness import work
from portbench.harness.checks import empty_cache, rel, trainer_seed
from portbench.harness.program import encoder_of, program_config, restart_ema, same_spec
from portbench.harness.weights import batch_seed, load_into, make_weights, module_spec
from portbench.reference import FP32, Precision
from portbench.reference import clip as ref_clip
from portbench.reference import grpo as ref_grpo
from portbench.reference import sd3 as ref_sd3

# ── the system under test ──────────────────────────────────────────────────


def check_pipeline(pipeline, cfg: dict):
    """The program's MMDiT and VAE decoder are the configuration's."""
    same_spec("transformer", module_spec(pipeline.transformer), ref_sd3.transformer_spec(cfg))
    same_spec("VAE decoder", module_spec(pipeline.vae, "decoder."),
              ref_sd3.vae_decoder_spec(cfg["vae"]))
    m, v = pipeline.mmdit_cfg, pipeline.vae_cfg
    want = dict(lora_alpha=float(cfg["lora"]["alpha"]), pos_embed_base_size=None,
                qk_norm=cfg["qk_norm"] == "rms_norm")
    got = dict(lora_alpha=float(m.lora_alpha), pos_embed_base_size=m.pos_embed_base_size,
               qk_norm=bool(m.qk_norm))
    vw = cfg["vae"]
    want.update(scaling=vw["scaling_factor"], shift=vw["shift_factor"], vae=torch.float32,
                text=cfg["text_encoders"]["seq_len"])
    got.update(scaling=v.scaling_factor, shift=v.shift_factor, vae=v.dtype,
               text=pipeline.text_seq_len)
    if want != got:
        raise ValueError(f"the program's SD3 pipeline is not the configuration's: "
                         f"{got} != {want}")


@torch.no_grad()
def load_weights(pipeline, cfg: dict, seed: int):
    """Weights from the seed into the MMDiT and the VAE (decoder and
    encoder), each made on the device and copied in place."""
    dev = pipeline.device
    tr = make_weights(ref_sd3.transformer_spec(cfg), "diffusion", seed, "transformer", dev)
    load_into(pipeline.transformer, tr)
    del tr
    load_into(pipeline.vae, make_weights(ref_sd3.vae_decoder_spec(cfg["vae"]), "diffusion",
                                         seed, "vae.decoder", dev), "decoder.")
    load_into(pipeline.vae, make_weights(module_spec(pipeline.vae, "encoder."), "diffusion",
                                         seed, "vae.encoder", dev), "encoder.")


@torch.no_grad()
def load_pickscore_weights(scorer, cfg: dict, seed: int):
    rm = cfg["reward_model"]
    want = ref_clip.spec(rm["text"], rm["vision"])
    same_spec("PickScore towers", module_spec(scorer.clip), want)
    if scorer.image_size != rm["vision"]["image_size"]:
        raise ValueError(f"PickScore at {scorer.image_size}^2, the configuration says "
                         f"{rm['vision']['image_size']}")
    load_into(scorer.clip, make_weights(want, "clip", seed, "pickscore", scorer.device))


def build_trainer(workload: dict, cfg: dict, seed: int, device):
    """``GRPOTrainer`` of the workload, with the benchmark's weights and
    prompt encoder; the EMA shadow restarts from the LoRA as given."""
    from adv_grpo_torch.cli.train import build_trainer as cli_build_trainer

    config = program_config(workload, seed)
    trainer = cli_build_trainer(config, latent_hw=workload.get("latent_hw"), device=device)
    check_pipeline(trainer.pipeline, cfg)
    load_weights(trainer.pipeline, cfg, seed)
    if trainer.reward_ctx is None or trainer.reward_ctx.pickscore is None:
        raise ValueError("the workload's reward is not PickScore")
    load_pickscore_weights(trainer.reward_ctx.pickscore, cfg, seed)
    restart_ema(trainer)
    encode = encoder_of(cfg)
    trainer.text_encode_fn = encode
    ne, npld = encode([""])
    trainer.neg_embeds1, trainer.neg_pooled1 = trainer._dev(ne), trainer._dev(npld)
    return trainer, config


def build_sampler(workload: dict, cfg: dict, seed: int, device):
    """The SD3 pipeline of the workload's preset, with the benchmark's weights."""
    from adv_grpo_torch.cli.common import build_pipeline

    config = program_config(workload, seed)
    pipeline = build_pipeline(config, latent_hw=workload.get("latent_hw"), device=device)
    check_pipeline(pipeline, cfg)
    load_weights(pipeline, cfg, seed)
    return pipeline, config


def build(entry: str, workload: dict, cfg: dict, seed: int, device):
    return {"grpo_epoch": build_trainer, "sample_batch": build_sampler}[entry](
        workload, cfg, seed, device)


def grpo_captured(trainer) -> dict:
    return {}


# ── the work a unit asks of the chip ───────────────────────────────────────


def unit_work(run) -> dict:
    """{"flops": transformer FLOPs of one unit (each training forward and
    backward at 3 forwards, counted once whatever remat recomputes),
    "attention": its attention calls} for the run's entry."""
    cfg, cap = run.config, run.captured
    s_img = work.sd3_tokens(cfg, cap["latent_hw"])
    s_txt = cfg["text_encoders"]["seq_len"]
    if run.entry == "sample_batch":
        rows = 2 * cap["shape"][0]  # the CFG batch
        steps = cap["steps"]
        calls = [(c[0] * steps,) + c[1:]
                 for c in work.sd3_attention_calls(cfg, s_img, s_txt, rows, False)]
        return {"flops": steps * work.mmdit_forward_flops(cfg, s_img, s_txt, rows),
                "attention": calls}
    config = cap["config"]
    s, tr = config.sample, config.train
    B = int(s.train_batch_size) * int(s.mini_num_image_per_prompt)
    nb = cap["num_batches"]
    rows = 2 * B  # the CFG batch
    n_roll = nb * int(s.num_steps)
    n_micro = nb * max(int(tr.get("micro_splits", 1)), 1)
    micro = n_micro * int(s.train_num_steps) * max(int(tr.num_inner_epochs), 1)
    rows_mb = 2 * (nb * B // n_micro)
    flops = (n_roll * work.mmdit_forward_flops(cfg, s_img, s_txt, rows)
             + micro * 3 * work.mmdit_forward_flops(cfg, s_img, s_txt, rows_mb))
    calls = [(c[0] * n_roll,) + c[1:]
             for c in work.sd3_attention_calls(cfg, s_img, s_txt, rows, False)]
    for bwd in (False, True):
        calls += [(c[0] * micro,) + c[1:]
                  for c in work.sd3_attention_calls(cfg, s_img, s_txt, rows_mb, bwd)]
    return {"flops": flops, "attention": calls}


# ── the comparison ─────────────────────────────────────────────────────────


def jax_path(name: str) -> str:
    """``transformer_blocks.3.attn.to_out.0.lora_a`` -> ``block_3/attn/to_out/lora_a``,
    the trainer's names of the LoRA leaves."""
    if name.startswith("transformer_blocks."):
        _, i, rest = name.split(".", 2)
        name = f"block_{i}.{rest}"
    return name.replace(".to_out.0.", ".to_out.").replace(".", "/")


def _transformer(cfg, seed, dev, prec):
    w = make_weights(ref_sd3.transformer_spec(cfg), "diffusion", seed, "transformer", dev)
    lora = ref_sd3.lora_factors(w)
    return ref_sd3.MMDiT(cfg, w, prec), lora


def _decoder(cfg, seed, dev, prec):
    w = make_weights(ref_sd3.vae_decoder_spec(cfg["vae"]), "diffusion", seed, "vae.decoder", dev)
    return ref_sd3.VAEDecoder(cfg["vae"], w, prec)


def _pickscore(cfg, seed, dev, prec):
    rm = cfg["reward_model"]
    w = make_weights(ref_clip.spec(rm["text"], rm["vision"]), "clip", seed, "pickscore", dev)
    return ref_clip.PickScore(rm["text"], rm["vision"], w, prec)


def grpo_plan(run) -> dict:
    """The batch and rows the rollout check takes, drawn from the seed."""
    cap = run.captured
    s = cap["config"].sample
    B = int(s.train_batch_size) * int(s.mini_num_image_per_prompt)
    rng = np.random.default_rng(batch_seed(run.seed, "check", 0))
    b = int(rng.integers(cap["num_batches"]))
    rows = sorted(rng.choice(B, size=min(int(run.workload["check"]["batch_rows"]), B),
                             replace=False).tolist())
    return {"B": B, "batch": b, "rows": rows, "global": [b * B + r for r in rows]}


def program_grpo(run, plan) -> dict:
    cap = run.captured
    smp, g = cap["samples"], plan["global"]
    T = int(cap["config"].sample.train_num_steps)
    step, hp = cap["steps"][0], cap["hp"]
    lat, img = cap["decoded"][plan["batch"]]
    return {"window": smp["rollout"]["latents"][g][:, 1:T + 1],
            "log_probs": smp["rollout"]["log_probs"][g],
            "final": lat[plan["rows"]], "images": img[plan["rows"]],
            "rewards": np.asarray(smp["rewards"]["avg"], np.float64),
            "advantages": np.asarray(cap["advantages"], np.float64),
            "losses": list(cap["losses"][:cap["accum"]]),
            "grad": {k: m / (1 - hp["b1"]) for k, m in step["mu"].items()},
            "delta": {k: step["lora"][k] - cap["lora0"][k] for k in step["lora"]}}


def reference_grpo(run, plan, prec: Precision = FP32) -> dict:
    """The reference's outputs of every stage the GRPO comparison covers."""
    cfg, cap, dev, seed = run.config, run.captured, run.device, run.seed
    config = cap["config"]
    s = config.sample
    hw, B, rows = cap["latent_hw"], plan["B"], plan["rows"]
    T, rt = int(s.train_num_steps), int(s.random_timestep)
    nl, scale = float(s.noise_level), float(s.guidance_scale)
    smp = cap["samples"]
    enc = encoder_of(cfg)
    out = {}
    empty_cache(dev)
    with torch.no_grad(), FP32.tf32_scope():
        model, lora0 = _transformer(cfg, seed, dev, prec)
        gen = torch.Generator(device=dev).manual_seed(trainer_seed(config.seed, plan["batch"], 0))
        shape = (B, cfg["in_channels"], hw, hw)
        x = torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)[rows]
        noises = [torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)[rows]
                  for _ in range(int(s.num_steps))]
        sig, ts = ref_sd3.flow_match_sigmas(int(s.num_steps))
        prompts = smp["prompts"][plan["batch"] * B:(plan["batch"] + 1) * B]
        e, p = (torch.from_numpy(a).to(dev) for a in enc([prompts[r] for r in rows]))
        ne, npl = (torch.from_numpy(a).to(dev) for a in enc([""] * len(rows)))
        win, lps = [], []
        for i in range(int(s.num_steps)):
            level = nl if rt <= i < rt + T else 0.0
            v = ref_sd3.guided(model, x, float(ts[i]), e, p, ne, npl, scale, lora0)
            x, lp, _ = ref_sd3.cps_step(v, x, float(sig[i]), float(sig[i + 1]), level,
                                        noise=noises[i])
            if rt <= i < rt + T:
                win.append(x)
                lps.append(lp)
        out.update(window=torch.stack(win, 1), log_probs=torch.stack(lps, 1), final=x)
        del noises

        prog_final = cap["decoded"][plan["batch"]][0][rows].to(dev)
        out["images"] = _decoder(cfg, seed, dev, prec)(prog_final)

        ps = _pickscore(cfg, seed, dev, prec)
        n_pos = cfg["reward_model"]["text"]["max_position_embeddings"]
        rewards = []
        for _, img in cap["decoded"]:
            ids = torch.full((img.shape[0], n_pos), 3, dtype=torch.long, device=dev)
            rewards.append(ps.score(img.to(dev), ids).double().cpu().numpy())
        del ps
        out["rewards"] = np.concatenate(rewards)
        out["advantages"] = ref_grpo.advantages(out["rewards"], smp["prompt_ids"],
                                                bool(s.global_std))
    out.update(_first_step(run, model, lora0, out["advantages"].astype(np.float32), enc))
    return out


def _first_step(run, model, lora0, adv, enc) -> dict:
    """The first optimizer step: its microsteps in the trainer's order
    (minibatch-major, window-step-minor), each over its whole minibatch, one
    image's CFG pair at a time (the loss is a mean over images, so the
    gradients add); the averaged gradient clipped, then AdamW."""
    cap, dev = run.captured, run.device
    config = cap["config"]
    s, tr = config.sample, config.train
    smp = cap["samples"]
    roll = smp["rollout"]
    n = roll["latents"].shape[0]
    bs = n // (cap["num_batches"] * max(int(tr.get("micro_splits", 1)), 1))
    T, accum = int(s.train_num_steps), cap["accum"]
    nl, scale = float(s.noise_level), float(s.guidance_scale)
    names = sorted(lora0)
    leaves = {nm: tuple(t.clone().requires_grad_(True) for t in lora0[nm]) for nm in names}
    keys = [(nm, w, f"{nm}.{w}") for nm in names for w in ("lora_a", "lora_b")]
    acc = {key: torch.zeros_like(lora0[nm][0 if w == "lora_a" else 1]) for nm, w, key in keys}
    ne, npl = (torch.from_numpy(a).to(dev) for a in enc([""]))
    losses = []
    with FP32.tf32_scope():
        for m in range(accum):
            i, j = divmod(m, T)
            rows = list(range(i * bs, (i + 1) * bs))
            e_all, p_all = enc([smp["prompts"][r] for r in rows])
            total = 0.0
            for k, r in enumerate(rows):
                x = roll["latents"][r:r + 1, j].to(dev)
                v = ref_sd3.guided(model, x, float(roll["timesteps"][r, j]),
                                   torch.from_numpy(e_all[k:k + 1]).to(dev),
                                   torch.from_numpy(p_all[k:k + 1]).to(dev), ne, npl, scale,
                                   leaves)
                _, lp, _ = ref_sd3.cps_step(v, x, float(roll["sigmas"][r, j]),
                                            float(roll["sigmas_prev"][r, j]), nl,
                                            prev=roll["latents"][r:r + 1, j + 1].to(dev))
                a = torch.tensor([float(adv[r])], device=dev)
                li = ref_grpo.policy_loss(lp, lp.detach(), a, float(tr.clip_range),
                                          float(tr.adv_clip_max)).sum() / bs
                li.backward()
                total += float(li.detach())
            losses.append(total)
            for nm, w, key in keys:
                leaf = leaves[nm][0 if w == "lora_a" else 1]
                acc[key] += (leaf.grad - acc[key]) / (m + 1)
                leaf.grad = None
    p0 = {key: lora0[nm][0 if w == "lora_a" else 1] for nm, w, key in keys}
    new, g, _, _ = ref_grpo.adamw_step(p0, acc, cap["hp"], step=1)
    return {"losses": losses, "grad": {jax_path(k): v for k, v in g.items()},
            "delta": {jax_path(k): new[k] - p0[k] for k in g}}


def grpo_numbers(prog: dict, ref: dict) -> Dict[str, float]:
    def dev_(t):
        return t.to(ref["window"].device)

    T = ref["window"].shape[1]
    ref_g = {k: float(v.norm()) for k, v in ref["grad"].items()}
    med = float(np.median(list(ref_g.values())))
    moved = {k for k, v in ref_g.items() if v >= 1e-3 * med}
    return {
        "rollout_rel": max(max(rel(dev_(prog["window"][:, j]), ref["window"][:, j])
                               for j in range(T)),
                           rel(dev_(prog["final"]), ref["final"])),
        "logprob_gap": float((dev_(prog["log_probs"]) - ref["log_probs"]).abs().max()),
        "decode_rel": rel(dev_(prog["images"]), ref["images"]),
        "reward_gap": float(np.abs(prog["rewards"] - ref["rewards"]).max()),
        "advantage_gap": float(np.abs(prog["advantages"] - ref["advantages"]).max()),
        "loss_gap": max(abs(a - b) for a, b in zip(prog["losses"], ref["losses"])),
        "grad_gap": ref_grpo.worst_leaf_gap({k: float(v.norm()) for k, v in prog["grad"].items()},
                                            ref_g),
        "update_gap": ref_grpo.worst_leaf_gap(
            {k: float(v.norm()) for k, v in prog["delta"].items()},
            {k: float(v.norm()) for k, v in ref["delta"].items()}, keep=moved),
    }


# ── sampling ───────────────────────────────────────────────────────────────


def sample_plan(run) -> dict:
    cap = run.captured
    done = sorted(cap["images"])
    rng = np.random.default_rng(batch_seed(run.seed, "check", 0))
    k = done[int(rng.integers(len(done)))]
    n = cap["shape"][0]
    rows = sorted(rng.choice(n, size=min(int(run.workload["check"]["rows"]), n),
                             replace=False).tolist())
    return {"batch": k, "rows": rows}


def program_sample(run, plan) -> dict:
    cap = run.captured
    return {"final": cap["final_latents"][plan["batch"]][plan["rows"]],
            "images": torch.from_numpy(cap["images"][plan["batch"]][plan["rows"]])}


def reference_sample(run, plan, prec: Precision = FP32) -> dict:
    from portbench.harness.entries import latents_of, prompts_of

    cfg, cap, dev, seed = run.config, run.captured, run.device, run.seed
    k, rows = plan["batch"], plan["rows"]
    enc = encoder_of(cfg)
    prompts = prompts_of(run.workload, seed, k % cap["pool"])
    e, p = (torch.from_numpy(a).to(dev) for a in enc([prompts[r] for r in rows]))
    ne, npl = (torch.from_numpy(a).to(dev) for a in enc([""] * len(rows)))
    x = torch.from_numpy(latents_of(cap["shape"], seed, k % cap["pool"])[rows]).to(dev)
    sig, ts = ref_sd3.flow_match_sigmas(cap["steps"])
    empty_cache(dev)
    with torch.no_grad(), FP32.tf32_scope():
        model, lora0 = _transformer(cfg, seed, dev, prec)
        for i in range(cap["steps"]):
            v = ref_sd3.guided(model, x, float(ts[i]), e, p, ne, npl, cap["scale"], lora0)
            x = ref_sd3.cps_step(v, x, float(sig[i]), float(sig[i + 1]), 0.0,
                                 noise=torch.zeros_like(x))[0]
        del model
        prog_final = cap["final_latents"][k][rows].to(dev)
        images = _decoder(cfg, seed, dev, prec)(prog_final)
    return {"final": x, "images": images}


def sample_numbers(prog: dict, ref: dict) -> Dict[str, float]:
    dev = ref["final"].device
    return {"latents_rel": rel(prog["final"].to(dev), ref["final"]),
            "decode_rel": rel(prog["images"].to(dev), ref["images"])}


STAGES = {"grpo_epoch": (grpo_plan, program_grpo, reference_grpo, grpo_numbers),
          "sample_batch": (sample_plan, program_sample, reference_sample, sample_numbers)}
