"""Certify a reference-image set before a cotrain run (the port's copy of
adv_grpo_tpu/cli/validate_refs.py; plain Python, no device).

One command that validates a (typically Qwen-Image-generated) reference
directory against the ``prompt2img_node{R}.json`` contract the trainers
consume (reference producer reference_imgs_scripts/qwen_generate_multi.py:
122-136; consumer train_sd3_fast_pickscore.py:705-707,773-799 — which
silently substitutes a fallback image for any file it cannot open, so a
broken set weakens the adversarial signal with no error at train time).

    python -m adv_grpo_torch.cli.validate_refs \
        --image_dir refs/ --json refs/prompt2img_node0.json \
        [--json refs/prompt2img_node1.json ...] \
        [--text_file dataset/pickscore/train.txt] \
        [--num_variations 8] [--decode_sample 16 | --decode_all]

Prints a human summary + one JSON report line; exits nonzero when the set
fails certification. See data/tooling.py:validate_reference_set for the
check list and README "Reference-image sets" for the generation
recipe (``cli.generate_refs`` writes such a set on the card).
"""

from __future__ import annotations

import argparse
import glob
import json
import sys


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Validate a reference-image set against the "
                    "prompt2img_node{R}.json contract")
    parser.add_argument("--image_dir", required=True,
                        help="directory holding the reference PNG/JPEG files")
    parser.add_argument("--json", action="append", default=None,
                        help="prompt2img JSON shard (repeatable); default: "
                             "every prompt2img*.json inside --image_dir")
    parser.add_argument("--text_file", default=None,
                        help="prompt list that must be fully covered")
    parser.add_argument("--num_variations", type=int, default=None,
                        help="exact per-prompt image count to enforce "
                             "(the reference set ships 8)")
    parser.add_argument("--decode_sample", type=int, default=16,
                        help="decode this many randomly sampled images "
                             "(0 = skip decoding)")
    parser.add_argument("--decode_all", action="store_true",
                        help="decode EVERY image (slow; overrides "
                             "--decode_sample)")
    parser.add_argument("--min_resolution", type=int, default=256)
    args = parser.parse_args(argv)

    from adv_grpo_torch.data.tooling import validate_reference_set

    json_paths = args.json or sorted(
        glob.glob(f"{args.image_dir}/prompt2img*.json"))
    if not json_paths:
        print(f"no prompt2img*.json found in {args.image_dir} "
              "(pass --json explicitly)", file=sys.stderr)
        return 2

    report = validate_reference_set(
        json_paths, args.image_dir,
        expected_variations=args.num_variations,
        prompts_file=args.text_file,
        decode_sample=-1 if args.decode_all else args.decode_sample,
        min_resolution=args.min_resolution)

    status = "OK" if report["ok"] else "FAILED"
    print(f"[validate_refs] {status}: {report['prompts']} prompts, "
          f"{report['files_total']} files across {len(json_paths)} shard(s), "
          f"{report['decoded_sample']} images decoded", file=sys.stderr)
    for key in ("duplicate_prompts", "empty_prompts", "missing_files",
                "wrong_counts", "uncovered_prompts", "undecodable"):
        if report[key]:
            print(f"[validate_refs]   {key}: {report[key]}", file=sys.stderr)
    print(json.dumps(report))
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
