"""Perplexity eval CLI (port of palu_tpu/cli/run_ppl_eval.py; the
reference's run_ppl_eval.py). Runs on the card unless --use_cpu is given.

  python -m palu_tpu_torch.cli.run_ppl_eval --model_name_or_path <palu ckpt> \\
      --datasets wikitext2 --seqlen 2048 --lt_bits 3 --lt_hadamard
"""

from __future__ import annotations

import argparse

from .common import add_common_args, load_for_eval, quant_config_from_args


def main(argv=None):
    parser = argparse.ArgumentParser()
    add_common_args(parser)
    parser.add_argument("--datasets", type=str, default="wikitext2")
    parser.add_argument("--seqlen", type=int, default=2048)
    parser.add_argument("--local_text_path", type=str, default=None)
    args = parser.parse_args(argv)

    from transformers import AutoTokenizer

    from ..evals.ppl import eval_ppl

    params, cfg = load_for_eval(args)
    tokenizer = AutoTokenizer.from_pretrained(args.model_name_or_path)
    qcfg = quant_config_from_args(args)
    results = eval_ppl(
        params, cfg, tokenizer, args.datasets, args.seqlen, qcfg,
        local_text_path=args.local_text_path,
    )
    for ds, ppl in results.items():
        print(f"PPL [{ds}]: {ppl}")


if __name__ == "__main__":
    main()
