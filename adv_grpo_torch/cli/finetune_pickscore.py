"""Offline PickScore preference finetune and its accuracy eval, ported from
adv_grpo_tpu/cli/finetune_pickscore.py (reference
adv_grpo/pick_score_training.py:314-373 ``finetune_pickscore_distributed``,
:19-73 ``evaluate_pickscore``).

Usage:
  python -m adv_grpo_torch.cli.finetune_pickscore --json_file prompt2img.json \\
      --good_dir refs/ --bad_dir sd3/ [--out pickscore_finetune_out] [--epochs 2] \\
      [--batch 4] [--lr 1e-6] [--tune_layer N] [--in_batch_negatives] \\
      [--tokenizer DIR] [--smoke] [--device cuda]

  * data: ``PreferencePairDataset`` over a prompt2img.json {prompt: file}
    shared by a good (reference render) and a bad (SD3 render) directory;
  * scorer: PickScore CLIP-H from the HF ``CLIPModel`` checkpoint in
    ``PICKSCORE_DIR`` (the strict ``convert.clip_model_state_dict_from_hf``),
    else random weights from ``--seed`` with a warning; ``--smoke`` the tiny
    towers at 28^2;
  * token ids: the CLIP tokenizer ``--tokenizer DIR`` (``data.tokenizers``,
    padded and cut to 77), else crc32 hash ids (the JAX package's exactly);
  * loss: the CLIP criterion over (text, good, bad) with labels (1, 0)
    (``pickscore_d_step_loss_and_acc``; ``--in_batch_negatives`` its
    in-batch mode); AdamW with optax's defaults (b1 0.9, b2 0.999, eps 1e-8
    outside the square root, weight decay 1e-4), the hand-written step of
    ``train.train_state``, on the full tree, or with ``--tune_layer N`` on
    the last N vision layers only, every other tensor frozen and unchanged
    (the JAX CLI's ``optax.masked`` lets the masked leaves move by their
    gradient; see ROADMAP);
  * eval before training and after every epoch over the first
    ``--max_eval`` pairs: preference accuracy (the share of pairs with good
    > bad), the good and bad mean scores, ``n_pairs``;
  * output: ``finetune_metrics.json`` and ``pickscore_finetuned.msgpack``,
    flax's layout of the JAX ``CLIPDualEncoder`` tree
    (``utils.msgpack_io``), which the trainer takes as ``weight_path``.
"""

from __future__ import annotations

import argparse
import json
import os
import time
import zlib

import numpy as np
import torch


def hash_token_ids(prompts, max_len: int, vocab_size: int) -> np.ndarray:
    """Deterministic ids with no tokenizer on disk (the JAX CLI's :115-128):
    prompts separate in embedding space, the values are not PickScore's.
    crc32, not ``hash()``, which is randomised per process."""
    rng = [zlib.crc32(p.encode()) for p in prompts]
    return np.stack([
        np.asarray([(h + i * 2654435761) % 1000 % max(vocab_size - 2, 2) + 1
                    for i in range(max_len)], np.int32)
        for h in rng])


def build_scorer(smoke: bool, seed: int, device, state_dict=None):
    """The PickScore scorer: ``state_dict`` when given, else
    ``PICKSCORE_DIR``'s checkpoint, else random weights from ``seed``."""
    from adv_grpo_torch.models import convert
    from adv_grpo_torch.models.clip_text import CLIPTextConfig
    from adv_grpo_torch.models.vit import ViTConfig
    from adv_grpo_torch.rewards.scorers import PickScoreScorer

    if smoke:
        towers = CLIPTextConfig.tiny(projection_dim=16), ViTConfig.tiny(projection_dim=16), 28
    else:
        towers = CLIPTextConfig.clip_h_text(), ViTConfig.clip_h(), 224
    ps_dir = os.environ.get("PICKSCORE_DIR", "")
    if state_dict is None and ps_dir and os.path.exists(ps_dir):
        state_dict = convert.clip_model_state_dict_from_hf(
            convert.load_torch_state_dict(ps_dir), *towers[:2])
    if state_dict is not None:
        return PickScoreScorer.from_state_dict(state_dict, device, *towers)
    if not smoke:
        import warnings

        warnings.warn("PickScore CLIP-H is RANDOM-INIT: set PICKSCORE_DIR to a local "
                      "checkpoint dir", stacklevel=2)
    return PickScoreScorer.random_init(torch.Generator(device=device).manual_seed(seed),
                                       device, *towers)


def main(argv=None, state_dict=None):
    """Run the finetune; returns {"params_path", "history", "step_s",
    "write_s", "bytes"}. ``state_dict``: the starting ``CLIPDualEncoder``
    state dict, in place of ``PICKSCORE_DIR`` or the random draw."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--json_file", required=True, help="prompt2img.json {prompt: filename}")
    parser.add_argument("--good_dir", required=True,
                        help="preferred renders (reference: Qwen-Image)")
    parser.add_argument("--bad_dir", required=True, help="dispreferred renders (reference: SD3)")
    parser.add_argument("--out", default="pickscore_finetune_out")
    parser.add_argument("--epochs", type=int, default=2)
    parser.add_argument("--batch", type=int, default=4)
    parser.add_argument("--lr", type=float, default=1e-6)
    parser.add_argument("--max_eval", type=int, default=100)
    parser.add_argument("--resolution", type=int, default=None,
                        help="image load size (default: scorer input size)")
    parser.add_argument("--in_batch_negatives", action="store_true",
                        help="CLIPCriterion in-batch mode (reference "
                             "CLIPCriterionConfig.in_batch_negatives)")
    parser.add_argument("--tune_layer", type=int, default=None,
                        help="restrict training to the last N vision blocks "
                             "(default: full model, like the reference loop)")
    parser.add_argument("--tokenizer", default=os.environ.get("TOKENIZER_DIR", ""),
                        help="local CLIP tokenizer dir (vocab.json + merges.txt)")
    parser.add_argument("--smoke", action="store_true",
                        help="tiny random-init scorer (CI / plumbing runs)")
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--device", default="cuda",
                        help="torch device; with no CUDA device visible, 'cuda' raises")
    args = parser.parse_args(argv)

    from adv_grpo_torch.adversarial.clip_criterion import pickscore_d_step_loss_and_acc
    from adv_grpo_torch.cli.common import resolve_device
    from adv_grpo_torch.data.datasets import PreferencePairDataset
    from adv_grpo_torch.models.convert import clip_dual_state_dict_to_jax
    from adv_grpo_torch.train.grpo_trainer import scorer_trainable_mask
    from adv_grpo_torch.train.train_state import adamw_state, adamw_update_
    from adv_grpo_torch.utils import msgpack_io

    device = resolve_device(args.device)
    scorer = build_scorer(args.smoke, args.seed, device, state_dict)
    clip = scorer.clip
    text_cfg = clip.text_model.cfg
    if args.tokenizer and os.path.isdir(args.tokenizer):
        from adv_grpo_torch.data.tokenizers import CLIPTokenizer

        tok = CLIPTokenizer(args.tokenizer)

        def tokenize(prompts):
            return tok(prompts, 77)
    else:
        def tokenize(prompts):
            return hash_token_ids(prompts, text_cfg.max_position_embeddings, text_cfg.vocab_size)

    dataset = PreferencePairDataset(args.json_file, args.good_dir, args.bad_dir,
                                    resolution=args.resolution or scorer.image_size)
    if len(dataset) == 0:
        raise ValueError(f"{args.json_file} has no prompts")

    mask = (scorer_trainable_mask(clip, -abs(args.tune_layer)) if args.tune_layer is not None
            else {name: True for name, _ in clip.named_parameters()})
    params = {}
    for name, p in clip.named_parameters():
        p.requires_grad_(mask[name])
        if mask[name]:
            params[name] = p
    # optax.adamw(lr)'s defaults
    state = adamw_state(params, lr=args.lr, b1=0.9, b2=0.999, eps=1e-8, weight_decay=1e-4)

    def batch(idx):
        prompts, good, bad = dataset.get_batch(idx)
        return (tokenize(prompts), torch.from_numpy(good).to(device),
                torch.from_numpy(bad).to(device))

    def evaluate(tag):
        """Preference accuracy and mean scores over the first max_eval pairs
        (reference evaluate_pickscore, pick_score_training.py:19-73)."""
        n = min(args.max_eval, len(dataset))
        goods, bads, correct = [], [], 0.0
        for start in range(0, n, args.batch):
            ids, good, bad = batch(list(range(start, min(start + args.batch, n))))
            sg, sb = scorer.score(good, ids).cpu().numpy(), scorer.score(bad, ids).cpu().numpy()
            goods.append(sg)
            bads.append(sb)
            correct += float((sg > sb).sum())
        m = dict(pref_accuracy=correct / max(n, 1),
                 good_score_mean=float(np.concatenate(goods).mean()),
                 bad_score_mean=float(np.concatenate(bads).mean()), n_pairs=n)
        print(f"[eval {tag}] pref_accuracy={m['pref_accuracy']:.4f} "
              f"good={m['good_score_mean']:.4f} bad={m['bad_score_mean']:.4f} ({n} pairs)")
        return m

    os.makedirs(args.out, exist_ok=True)
    history = [dict(epoch=-1, **evaluate("before"))]
    order_rng = np.random.default_rng(args.seed)
    steps_per_epoch = len(dataset) // args.batch or 1
    step_s = []
    for epoch in range(args.epochs):
        perm = order_rng.permutation(len(dataset))
        losses, accs = [], []
        for b in range(steps_per_epoch):
            idx = perm[b * args.batch:(b + 1) * args.batch].tolist()
            if not idx:
                break
            t0 = time.perf_counter()
            ids, good, bad = batch(idx)
            loss, acc = pickscore_d_step_loss_and_acc(
                scorer, good, bad, ids, in_batch_negatives=args.in_batch_negatives)
            loss.backward()
            adamw_update_(state, {k: p.grad for k, p in params.items()})
            losses.append(float(loss.detach()))
            accs.append(float(acc))
            step_s.append(time.perf_counter() - t0)
        m = evaluate(f"epoch {epoch}")
        history.append(dict(epoch=epoch, train_loss=float(np.mean(losses)),
                            train_pref_accuracy=float(np.mean(accs)), **m))
        print(f"===> epoch {epoch} | loss {np.mean(losses):.4f} | train_acc {np.mean(accs):.4f}")

    out_path = os.path.join(args.out, "pickscore_finetuned.msgpack")
    t0 = time.perf_counter()
    nbytes = msgpack_io.save(out_path, clip_dual_state_dict_to_jax(
        clip.state_dict(), text_cfg, clip.vision_model.cfg))
    write_s = time.perf_counter() - t0
    with open(os.path.join(args.out, "finetune_metrics.json"), "w") as f:
        json.dump(history, f, indent=1)
    print(f"saved finetuned PickScore to {out_path}")
    return {"params_path": out_path, "history": history, "step_s": step_s,
            "write_s": write_s, "bytes": nbytes}


if __name__ == "__main__":
    main()
