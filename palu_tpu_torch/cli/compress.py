"""Offline compression CLI (port of palu_tpu/cli/compress.py; the
reference's compress.py): load a dense checkpoint -> rank search ->
decompose (-> Hadamard fusion) -> write an HF-compatible Palu checkpoint.

Example:
  python -m palu_tpu_torch.cli.compress --model_name_or_path /path/to/llama \\
      --param_ratio_target 0.7 --search_method fisher_uniform \\
      --decompose_method whiten --head_group_size 4

Flags, defaults, the output directory's name and the final print are the
JAX CLI's. It runs on the GPU (the Hadamard fusion on the FWHT kernel)
unless --use_cpu is given. `transformers` is imported only when
calibration needs a tokenizer (fisher / fisher_uniform search, whiten
decomposition).
"""

from __future__ import annotations

import argparse
import os

import torch

from ..ops import build


def add_compress_args(parser: argparse.ArgumentParser):
    # flag names follow the reference (compress.py:30-130)
    parser.add_argument("--model_name_or_path", type=str, required=True)
    parser.add_argument("--output_dir", type=str, default=None)
    parser.add_argument("--param_ratio_target", type=float, default=0.7)
    parser.add_argument("--search_method", type=str, default="fisher_uniform",
                        choices=["uniform", "fisher", "fisher_uniform"])
    parser.add_argument("--decompose_method", type=str, default="whiten",
                        choices=["whiten", "svd"])
    parser.add_argument("--head_group_size", type=int, default=4)
    parser.add_argument("--calib_dataset", type=str, default="wikitext2")
    parser.add_argument("--calib_seqlen", type=int, default=1024)
    parser.add_argument("--n_fisher_calib_samples", type=int, default=32,
                        help="fisher calibration samples (the reference "
                        "hardcodes 2048 and ignores its flag, "
                        "rank_search.py:107; this one is honored)")
    parser.add_argument("--n_whiten_calib_samples", type=int, default=256)
    parser.add_argument("--hadamard", action="store_true",
                        help="bake the Hadamard rotation into VT/U at "
                        "compression time (low-rank-aware quantization)")
    parser.add_argument("--local_text_path", type=str, default=None,
                        help="offline corpus for calibration (no-egress envs)")
    parser.add_argument("--use_cpu", action="store_true")
    return parser


def main(argv=None):
    parser = argparse.ArgumentParser()
    add_compress_args(parser)
    args = parser.parse_args(argv)
    dev = build.require_cuda("cpu" if args.use_cpu else "cuda")

    from ..compression import compress_params, get_calib_batches, search_ranks
    from ..models import hf_io

    params, cfg = hf_io.load_params(args.model_name_or_path, dtype=torch.bfloat16,
                                    device=dev)
    needs_calib = (args.search_method in ("fisher", "fisher_uniform")
                   or args.decompose_method == "whiten")
    tokenizer = None
    if needs_calib:
        from transformers import AutoTokenizer

        tokenizer = AutoTokenizer.from_pretrained(args.model_name_or_path)

    fisher_batches = None
    if args.search_method in ("fisher", "fisher_uniform"):
        fisher_batches = get_calib_batches(
            args.calib_dataset, tokenizer, args.model_name_or_path,
            nsamples=args.n_fisher_calib_samples, seqlen=args.calib_seqlen,
            local_text_path=args.local_text_path)
    selection = search_ranks(params, cfg, args.param_ratio_target, args.search_method,
                             args.head_group_size, calib_batches=fisher_batches,
                             model_id=args.model_name_or_path)

    whiten_batches = None
    if args.decompose_method == "whiten":
        # the reference hardcodes wikitext2/256/2048 (decomposition.py:24-30);
        # the flags are honored, with the same sample count by default
        whiten_batches = get_calib_batches(
            args.calib_dataset, tokenizer, args.model_name_or_path,
            nsamples=args.n_whiten_calib_samples, seqlen=args.calib_seqlen,
            local_text_path=args.local_text_path)
    new_params, new_cfg = compress_params(
        params, cfg, selection, decompose_method=args.decompose_method,
        head_group_size=args.head_group_size, calib_batches=whiten_batches,
        hadamard=args.hadamard, dtype=torch.bfloat16)

    out_dir = args.output_dir
    if out_dir is None:
        base = os.path.basename(args.model_name_or_path.rstrip("/"))
        out_dir = (f"{base}_ratio-{args.param_ratio_target}_gs-{args.head_group_size}-"
                   f"{args.search_method}")
    hf_io.save_checkpoint(new_params, new_cfg, out_dir, args.model_name_or_path)
    if tokenizer is not None:
        try:
            tokenizer.save_pretrained(out_dir)
        except Exception:  # a tokenizer that cannot save: the checkpoint stands
            pass
    print(f"[compress] saved Palu checkpoint to {out_dir}")


if __name__ == "__main__":
    main()
