"""Zero-shot eval CLI (port of palu_tpu/cli/run_lm_eval.py; the reference's
run_lm_eval.py): openbookqa, hellaswag, piqa, arc_easy, arc_challenge,
winogrande. Runs on the card unless --use_cpu is given; writes
<output_dir>/<model>_<lt_bits>.json."""

from __future__ import annotations

import argparse
import json
import os

from .common import add_common_args, load_for_eval, quant_config_from_args


def jsonl_loader(fixture_dir: str):
    """fn(name) -> the rows of <fixture_dir>/<name>.jsonl."""
    def load(name):
        with open(os.path.join(fixture_dir, f"{name}.jsonl")) as f:
            return [json.loads(line) for line in f if line.strip()]
    return load


def main(argv=None):
    parser = argparse.ArgumentParser()
    add_common_args(parser)
    parser.add_argument(
        "--tasks", type=str,
        default="openbookqa,hellaswag,piqa,arc_easy,arc_challenge,winogrande",
    )
    parser.add_argument("--max_samples", type=int, default=None)
    parser.add_argument("--output_dir", type=str, default="results")
    parser.add_argument(
        "--fixture_dir", type=str, default=None,
        help="offline fixtures: <dir>/<task>.jsonl rows with the task's "
             "document fields; forces the built-in harness (no downloads)")
    args = parser.parse_args(argv)

    from transformers import AutoTokenizer

    from ..evals.zero_shot import run_zero_shot

    params, cfg = load_for_eval(args)
    tokenizer = AutoTokenizer.from_pretrained(args.model_name_or_path)
    results = run_zero_shot(
        params, cfg, tokenizer,
        tasks=args.tasks.split(","),
        qcfg=quant_config_from_args(args),
        max_samples=args.max_samples,
        data_loader=jsonl_loader(args.fixture_dir) if args.fixture_dir else None,
    )
    os.makedirs(args.output_dir, exist_ok=True)
    model_name = os.path.basename(args.model_name_or_path.rstrip("/"))
    out = os.path.join(args.output_dir, f"{model_name}_{args.lt_bits}.json")
    with open(out, "w") as f:
        json.dump(results, f, indent=2)
    print(json.dumps(results, indent=2))


if __name__ == "__main__":
    main()
