"""LongBench eval CLI (port of palu_tpu/cli/run_long_bench.py; the
reference's run_long_bench.py) generating through the latent-cache Engine,
on the card unless --use_cpu is given."""

from __future__ import annotations

import argparse
import os

import torch

from .common import add_common_args, load_for_eval, quant_config_from_args
from .run_lm_eval import jsonl_loader


def main(argv=None):
    parser = argparse.ArgumentParser()
    add_common_args(parser)
    parser.add_argument(
        "--datasets", type=str,
        default="triviaqa,qasper,trec,samsum,lcc,repobench-p,qmsum,multi_news",
    )
    parser.add_argument("--max_prompt_len", type=int, default=3500)
    parser.add_argument("--s_max", type=int, default=4096)
    parser.add_argument("--max_samples", type=int, default=None)
    parser.add_argument("--chat_template", action="store_true")
    parser.add_argument("--output_path", type=str, default="results/longbench.jsonl")
    parser.add_argument(
        "--fixture_dir", type=str, default=None,
        help="offline fixtures: <dir>/<dataset>.jsonl with context/input/"
             "answers/all_classes fields instead of THUDM/LongBench downloads")
    args = parser.parse_args(argv)

    from transformers import AutoTokenizer

    from ..evals.longbench import run_longbench
    from ..evals.ppl import params_device
    from ..runtime.engine import Engine, EngineConfig

    params, cfg = load_for_eval(args)
    tokenizer = AutoTokenizer.from_pretrained(args.model_name_or_path)
    engine = Engine(
        params, cfg,
        EngineConfig(s_max=args.s_max, qcfg=quant_config_from_args(args),
                     dtype=torch.bfloat16, device=str(params_device(params))),
    )
    os.makedirs(os.path.dirname(args.output_path) or ".", exist_ok=True)
    results = run_longbench(
        engine, tokenizer,
        datasets=args.datasets.split(","),
        max_prompt_len=args.max_prompt_len,
        out_path=args.output_path,
        max_samples=args.max_samples,
        chat_template=args.chat_template,
        data_loader=jsonl_loader(args.fixture_dir) if args.fixture_dir else None,
    )
    for ds, score in results.items():
        print(f"{ds}: {score}")


if __name__ == "__main__":
    main()
