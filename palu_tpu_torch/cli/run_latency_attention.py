"""Attention/TPOT latency bench (port of
palu_tpu/cli/run_latency_attention.py): a random-weight model, its cache
seeded with random content at --prompt_len (runtime/profiler), timed decode
steps. --palu gives every layer low-rank k/v (the latent cache and its
decode kernels); without it every layer keeps dense roped K/V, the
dense-KV baseline. The JAX CLI's --no_pallas is not carried over: the port
has no switch to its plain versions on the card (--use_cpu runs them on the
CPU).

  python -m palu_tpu_torch.cli.run_latency_attention --palu --prompt_len 65536 \\
      --total_rank_k 1024 --total_rank_v 3072 --group_size 4 --lt_bits 3 --lt_sym \\
      --lt_container 4
"""

from __future__ import annotations

import argparse
import json

import torch


def build_model(args, device: torch.device):
    """Random bf16 weights (torch generator seed 0) at the CLI's widths."""
    from ..models import llama
    from ..models.config import ModelConfig

    hwr = None
    if args.palu:
        g = args.num_heads // args.group_size
        hwr = {}
        for i in range(args.num_layers):
            hwr[f"model.layers.{i}.self_attn.k_proj"] = [args.total_rank_k // g] * g
            hwr[f"model.layers.{i}.self_attn.v_proj"] = [args.total_rank_v // g] * g
    cfg = ModelConfig(
        vocab_size=args.vocab_size,
        hidden_size=args.num_heads * args.head_dim,
        intermediate_size=args.intermediate_size
        or int(args.num_heads * args.head_dim * 8 / 3) // 128 * 128,
        num_hidden_layers=args.num_layers,
        num_attention_heads=args.num_heads,
        num_key_value_heads=args.num_kv_heads or args.num_heads,
        max_position_embeddings=args.prompt_len + args.n_steps + 16,
        head_group_size=args.group_size,
        head_wise_ranks=hwr,
    )
    gen = torch.Generator(device=device).manual_seed(0)
    return llama.init_params(cfg, gen, dtype=torch.bfloat16), cfg


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--palu", action="store_true",
                   help="low-rank latent cache (vs dense-KV baseline)")
    p.add_argument("--prompt_len", type=int, default=65536)
    p.add_argument("--n_steps", type=int, default=100)
    p.add_argument("--num_layers", type=int, default=1,
                   help="1 = attention-module bench (reference default)")
    p.add_argument("--num_heads", type=int, default=32)
    p.add_argument("--num_kv_heads", type=int, default=None)
    p.add_argument("--head_dim", type=int, default=128)
    p.add_argument("--vocab_size", type=int, default=32000)
    p.add_argument("--intermediate_size", type=int, default=None)
    p.add_argument("--group_size", type=int, default=4)
    p.add_argument("--total_rank_k", type=int, default=1024)
    p.add_argument("--total_rank_v", type=int, default=3072)
    p.add_argument("--lt_bits", type=int, default=16)
    p.add_argument("--lt_sym", action="store_true")
    p.add_argument("--lt_container", type=int, default=0)
    p.add_argument("--decode_chunk", type=int, default=512)
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--v_byte_dot", choices=["auto", "0", "1"], default="auto",
                   help="validated as in the JAX engine; an exact reformulation of the "
                        "TPU schedule, so the port runs its default kernel either way")
    p.add_argument("--int8_dots", action="store_true",
                   help="packed decode's K reconstruct on int8 dots (per-row operand)")
    p.add_argument("--int8_rot", action="store_true",
                   help="full-int K path (int8 dots + int32 rotation on static int8 "
                        "tables; ~2e-2 attention deviation)")
    p.add_argument("--use_cpu", action="store_true",
                   help="run on the CPU: the kernels' plain versions")
    p.add_argument("--trace_dir", type=str, default=None,
                   help="write a torch.profiler chrome trace of the timed steps here")
    p.add_argument("--json", action="store_true")
    return p


def run(args):
    """-> (stats, engine): profile_tpot's record with the JAX CLI's mode and
    lt_bits keys, and the engine it timed."""
    from ..core.quant import QuantConfig
    from ..ops import build
    from ..runtime.engine import Engine, EngineConfig
    from ..runtime.profiler import profile_tpot

    dev = build.require_cuda("cpu" if args.use_cpu else "cuda")
    params, cfg = build_model(args, dev)
    s_max = ((args.prompt_len + args.n_steps + 16) // args.decode_chunk + 1) * args.decode_chunk
    qcfg = (QuantConfig(bits=args.lt_bits, sym=args.lt_sym, container=args.lt_container)
            if args.lt_bits < 16 else None)
    engine = Engine(params, cfg, EngineConfig(
        s_max=s_max, batch=args.batch, dtype=torch.bfloat16, qcfg=qcfg,
        decode_chunk=args.decode_chunk, device=str(dev),
        kernel_v_byte_dot=None if args.v_byte_dot == "auto" else args.v_byte_dot == "1",
        kernel_int8_dots=args.int8_dots, kernel_int8_rot=args.int8_rot))
    stats = profile_tpot(engine, args.prompt_len, args.n_steps, trace_dir=args.trace_dir)
    stats["mode"] = "palu" if args.palu else "dense"
    stats["lt_bits"] = args.lt_bits
    return stats, engine


def main(argv=None):
    args = parser().parse_args(argv)
    stats, _ = run(args)
    if args.json:
        print(json.dumps(stats))
    else:
        print(f"[{stats['mode']}] prompt_len={args.prompt_len} "
              f"TPOT={stats['tpot_ms']:.3f}ms "
              f"(p20 {stats['p20_ms']:.3f} / p80 {stats['p80_ms']:.3f}) "
              f"= {stats['tokens_per_s']:.1f} tok/s")
    return stats


if __name__ == "__main__":
    main()
